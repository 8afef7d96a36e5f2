"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of ``deepfake_video_detection_tpu/ops/ring_attention.py``.
Queries stay on their rank; key/value blocks travel around the ring of the
mesh's ``seq`` axis, and each rank folds every visiting block into its
output. JAX folds plain ``jnp`` blocks by running (max, sum, acc); the port
folds the flash kernel's ``(O_i, lse_i)`` of each block (``ops/attention.py``:
K2 below 512 rows a block, K3 above, on the card; the plain version on the
CPU) by their logsumexps, in f32.

The flash Function gives no gradient for lse, so autograd cannot run
through the fold: :class:`RingAttention` is its own autograd Function. Its
backward calls the flash backward (K4, or K5/K6 above 512 rows) of each
block with the FINAL output and lse, so that ``P_i = exp(S_i − lse)`` is
that block of the global softmax and ``D = rowsum(dO ⊙ O)`` comes from the
final O: dq sums on its rank, and each block's dk/dv travel the ring with
it and return to its owner.

The fold (:func:`fold_forward`, :func:`fold_backward`) is separate from
the exchange, so one process can drive it with the blocks each rank would
receive.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from deepfake_video_detection_tpu_torch.ops.attention import (
    flash_attention_bwd, flash_attention_fwd)
from deepfake_video_detection_tpu_torch.parallel.mesh import (
    axis_group, axis_rank, axis_size, group_ranks)

KV = Tuple[torch.Tensor, torch.Tensor]


def fold_forward(q: torch.Tensor, blocks: Iterable[KV]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of ``q`` against the keys/values of all ``blocks``,
    each block through the flash forward: out in q's dtype, lse f32."""
    acc = lse = None
    for k, v in blocks:
        o_i, lse_i = flash_attention_fwd(q, k, v)
        o_i = o_i.to(torch.float32)
        if acc is None:
            acc, lse = o_i, lse_i
            continue
        new = torch.logaddexp(lse, lse_i)
        acc = acc * torch.exp(lse - new)[..., None] + o_i * torch.exp(lse_i - new)[..., None]
        lse = new
    return acc.to(q.dtype), lse


def block_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's ``(dq_i, dk_i, dv_i)`` from the final ``out``/``lse``."""
    return flash_attention_bwd(q, k, v, out, lse, dout)


def fold_backward(q: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                  dout: torch.Tensor, blocks: Iterable[KV]
                  ) -> Tuple[torch.Tensor, List[KV]]:
    """``(dq, [(dk_i, dv_i) per block])``: dq summed over the blocks (in
    f32, returned in q's dtype)."""
    dq, dkv = None, []
    for k, v in blocks:
        dq_i, dk_i, dv_i = block_grads(q, k, v, out, lse, dout)
        dq = dq_i.to(torch.float32) if dq is None else dq + dq_i.to(torch.float32)
        dkv.append((dk_i, dv_i))
    return dq.to(q.dtype), dkv


def _pass_on(tensors, group, ranks, me: int):
    """Send ``tensors`` to the next rank of the ring and return those the
    previous rank sent."""
    S = len(ranks)
    recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[(me + 1) % S], group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, ranks[(me - 1) % S], group) for r in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _ring_blocks(k, v, group, ranks, me):
    """The blocks that visit this rank, in ring order, its own first."""
    yield k, v
    for _ in range(len(ranks) - 1):
        k, v = _pass_on((k, v), group, ranks, me)
        yield k, v


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, ranks, me):
        out, lse = fold_forward(q, _ring_blocks(k, v, group, ranks, me))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, ranks, me)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, ranks, me = ctx.ring
        S = len(ranks)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kb, vb = k, v
        for i in range(S):
            # dk/dv travel with their block and gather every rank's share
            dq_i, dk_i, dv_i = block_grads(q, kb, vb, out, lse, dout)
            dq += dq_i.to(torch.float32)
            dk += dk_i.to(torch.float32)
            dv += dv_i.to(torch.float32)
            if i < S - 1:
                kb, vb, dk, dv = _pass_on((kb, vb, dk, dv), group, ranks, me)
        if S > 1:   # home: block (me + 1) ends here, its owner is the next rank
            dk, dv = _pass_on((dk, dv), group, ranks, me)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_axis: str = "model", batch_axis: Optional[str] = "data"
                   ) -> torch.Tensor:
    """Exact ``softmax(QKᵀ/√d)V`` with N split over ``seq_axis``. ``q, k,
    v``: this rank's ``(B, H, N/S, d)`` blocks (its rows of the batch, split
    over ``batch_axis`` by the caller). Differentiable in q, k and v."""
    group = axis_group(mesh, seq_axis)
    ranks = group_ranks(group) if group is not None else [0]
    return RingAttention.apply(q, k, v, group, ranks, axis_rank(mesh, seq_axis))

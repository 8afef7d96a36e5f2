"""Mixture-of-experts MLP, top-1 routed, on one device.

Counterpart of ``deepfake_video_detection_tpu/nn/moe.py``: a router
(D → E, no bias) and E expert MLPs (D → H → D, exact GELU, no biases)
stacked on a leading expert axis, under the JAX tree's keys
``router.weight`` (E, D), ``w1`` (E, D, H) and ``w2`` (E, H, D), so a JAX
tree crosses with ``checkpoint.bridge`` unchanged.

:meth:`MoEMLP.apply_dense` is the JAX package's dense path: every expert
computes every token as one batched matmul over the stacked experts, and
the router's one-hot picks each token's output, scaled by its gate. The
JAX package computes it in XLA, outside any Pallas kernel, so here it is
plain torch (cuBLAS on the card). The products follow jnp's promotion: the
parameters are f32, so bf16 activations are promoted and the output is
f32, as in the JAX package (the temporal transformer's residual stream
turns f32 after its first MoE block there too). The router's gradient flows
through the gate and the load-balance loss's mean probability; the one-hot
and the fractions carry none.

:meth:`MoEMLP.apply_expert_parallel` is JAX's expert-parallel path: the
tokens of every rank holding other rows are gathered (JAX routes the
global token set), packed into an (E, cap, D) buffer by a stable sort
(``cap = ceil(N/E · capacity_factor)``, overflow tokens get zero), each
rank of the mesh's ``expert`` axis computes its E/G experts' slice of the
buffer, and an all-gather over that axis returns every expert's outputs
(JAX's in/out specs: the tokens are replicated over the expert axis, so
the dispatch is a slice and the combine a gather). Every rank keeps all the
experts' weights and uses its slice, as JAX's plan places them (``P()``:
replicated); their gradients are summed over the world by the train step.

Under ``parallel.mesh.reducing`` the load-balance loss takes its means
over the global token set (the ranks holding other frames).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.parallel.mesh import (
    tokens_count, tokens_reduced, tokens_sum)
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


def _promoted(dtype: torch.dtype) -> torch.dtype:
    """jnp's result dtype of ``x @ w`` for f32 parameters ``w`` (an int8
    weight at rest reads as f32)."""
    return torch.promote_types(dtype, torch.float32)


class MoEMLP(nn.Module):
    """Top-1-routed MoE feed-forward: router (D→E) + E experts (D→H→D)."""

    def __init__(self, d_model: int, hidden: int, num_experts: int,
                 capacity_factor: float = 2.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.d_model, self.hidden = d_model, hidden
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        D, H, E = d_model, hidden, num_experts
        kw = {"device": resolve_device(device), "dtype": torch.float32}
        self.router = skip_init(nn.Linear, D, E, bias=False, **kw)
        self.w1 = nn.Parameter(torch.empty(E, D, H, **kw))
        self.w2 = nn.Parameter(torch.empty(E, H, D, **kw))
        with torch.no_grad():   # the JAX init: trunc_normal(0.02) for all three
            for p in (self.router.weight, self.w1, self.w2):
                p.copy_(I.trunc_normal(p.shape, g, std=0.02))

    def _route(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (N, D) → (expert index (N,), gate (N,) in x's dtype, router
        probabilities (N, E) f32)."""
        dt = _promoted(x.dtype)
        logits = F.linear(x.to(dt), self.router.weight.to(dt))
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        idx = torch.argmax(probs, dim=-1)          # the first maximum, as jnp.argmax
        gate = torch.gather(probs, -1, idx[:, None])[:, 0]
        return idx, gate.to(x.dtype), probs

    def _expert_ffn(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, D) → (E, N, D), every expert on every token."""
        dt = _promoted(x.dtype)
        h = F.gelu(torch.matmul(x.to(dt), self.w1.to(dt)))
        return torch.matmul(h, self.w2.to(dt))

    def apply_dense(self, x: torch.Tensor, with_aux: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(N, D) → (N, D): the router's one-hot picks each token's expert
        output, scaled by its gate. ``with_aux=True`` also returns the
        switch load-balance loss."""
        idx, gate, probs = self._route(x)
        all_out = self._expert_ffn(x)
        one_hot = F.one_hot(idx, self.num_experts).to(all_out.dtype)
        out = torch.einsum("end,ne->nd", all_out, one_hot) * gate[:, None]
        if with_aux:
            return out, load_balance_loss(probs, idx, self.num_experts)
        return out

    def apply_expert_parallel(self, x: torch.Tensor, mesh, expert_axis: str = "expert",
                              with_aux: bool = False, batch_axis: Optional[str] = "data"):
        """(N, D) → (N, D) with the experts split over ``expert_axis``:
        ``x`` is this rank's tokens (its rows, split over ``batch_axis``)."""
        from deepfake_video_detection_tpu_torch.parallel.mesh import (
            all_gather, axis_group, axis_rank, axis_size)

        E = self.num_experts
        G = axis_size(mesh, expert_axis)
        assert E % G == 0, "num_experts must divide the expert axis"
        n_local = x.shape[0]
        data_group = axis_group(mesh, batch_axis)
        xs = all_gather(x, data_group) if data_group is not None else x
        N, D = xs.shape
        cap = max(1, math.ceil(N / E * self.capacity_factor))
        idx, gate, probs = self._route(xs)
        sort = torch.argsort(idx, stable=True)             # tokens grouped by e
        sorted_e = idx[sort]
        rank = torch.arange(N, device=x.device) - torch.searchsorted(
            sorted_e, sorted_e, side="left")
        slot = torch.where(rank < cap, sorted_e * cap + rank,
                           torch.full_like(rank, E * cap))  # E*cap = dropped
        buf = xs.new_zeros((E * cap + 1, D)).index_copy(0, slot, xs[sort])
        buf = buf[:-1].reshape(E, cap, D)
        g, per = axis_rank(mesh, expert_axis), E // G
        dt = _promoted(x.dtype)
        h = F.gelu(torch.matmul(buf[g * per:(g + 1) * per].to(dt), self.w1[g * per:(g + 1) * per].to(dt)))
        out_local = torch.matmul(h, self.w2[g * per:(g + 1) * per].to(dt))
        expert_group = axis_group(mesh, expert_axis)
        out_buf = (all_gather(out_local, expert_group)
                   if expert_group is not None else out_local)        # (E, cap, D)
        flat = torch.cat([out_buf.reshape(E * cap, D), out_buf.new_zeros((1, D))])
        # JAX scatters the outputs into a buffer of x's dtype
        y = xs.new_zeros((N, D)).index_copy(0, sort, flat[slot].to(xs.dtype))
        out = y * gate[:, None]
        lo = axis_rank(mesh, batch_axis) * n_local if data_group is not None else 0
        out = out[lo:lo + n_local]
        if with_aux:
            return out, load_balance_loss(probs, idx, E, global_tokens=True)
        return out

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        return self.apply_dense(x, with_aux)


def load_balance_loss(router_probs: torch.Tensor, expert_idx: torch.Tensor,
                      num_experts: int, global_tokens: bool = False) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E · Σ_e fraction_e · prob_e, the
    means over the global token set within ``parallel.mesh.reducing``
    (``global_tokens``: the caller's tokens are already all of them)."""
    one_hot = F.one_hot(expert_idx, num_experts).to(torch.float32)
    probs = router_probs.to(torch.float32)
    if global_tokens or not tokens_reduced():
        return num_experts * torch.sum(one_hot.mean(dim=0) * probs.mean(dim=0))
    sums = tokens_sum(torch.stack([one_hot.sum(dim=0), probs.sum(dim=0)]))
    n = tokens_count(probs.shape[0])
    return num_experts * torch.sum((sums[0] / n) * (sums[1] / n))

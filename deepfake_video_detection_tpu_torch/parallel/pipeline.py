"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis.

Counterpart of ``deepfake_video_detection_tpu/parallel/pipeline.py``. A
stack of ``L`` blocks of one shape is cut into ``S`` stages along the
mesh's ``stage`` axis, stage ``s`` applying blocks ``s·L/S … (s+1)·L/S − 1``.
The schedule is JAX's: ``M + S − 1`` ticks, and at tick ``t`` stage ``s``
runs microbatch ``t − s`` when it exists, taking it from the input (stage
0) or from stage ``s − 1``, and passing its output on; the last stage's
outputs are broadcast to every stage, as JAX's ``psum`` of the masked
outputs gives them.

JAX ``ppermute``s the activations around the ring; here each hand-over is a
``send``/``recv`` pair inside an autograd Function, so the backward runs
the reverse pipeline: :class:`_Recv`'s backward sends the cotangent back,
:class:`_Send`'s receives it. A sending stage's graph reaches the loss
through a zero-valued scalar that :class:`_Send` returns and the stage adds
to its (overwritten) broadcast input; the broadcast's backward sums every
stage's cotangent onto the last stage. Each rank runs its backward in the
reverse order of its forward (autograd's order), so the sends and receives
pair up; the microbatch index tags each message.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from deepfake_video_detection_tpu_torch.parallel.mesh import (
    axis_group, axis_rank, axis_size, broadcast, group_ranks)


class _Recv(torch.autograd.Function):
    """Receive an activation from ``src``; the backward sends its cotangent
    back. ``anchor`` (a scalar that requires grad) puts it in the graph."""

    @staticmethod
    def forward(ctx, anchor, like, src: int, tag: int):
        buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.recv(buf, src=src, tag=tag)
        ctx.src, ctx.tag = src, tag
        return buf

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), dst=ctx.src, tag=ctx.tag)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Send an activation to ``dst`` and return a zero scalar; the backward
    receives the activation's cotangent from ``dst``."""

    @staticmethod
    def forward(ctx, y, dst: int, tag: int):
        dist.send(y.detach().contiguous(), dst=dst, tag=tag)
        ctx.dst, ctx.tag = dst, tag
        ctx.save_for_backward(torch.empty(y.shape, dtype=y.dtype, device=y.device))
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        (grad,) = ctx.saved_tensors
        dist.recv(grad, src=ctx.dst, tag=ctx.tag)
        return grad, None, None


def pipeline_blocks(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    blocks: Sequence[Any], x_microbatches: torch.Tensor, mesh,
                    stage_axis: str = "stage",
                    batch_axis: Optional[str] = None) -> torch.Tensor:
    """Apply the ``L`` ``blocks`` (``block_fn(block, x) -> y``, one shape in
    and out) as an ``S``-stage pipeline. ``x_microbatches``: ``(M, mb, …)``,
    this rank's rows (split over ``batch_axis`` by the caller). Returns
    ``(M, mb, …)``, the same on every stage: the blocks applied in order
    (a pipeline is a schedule, not a numerics change). Differentiable."""
    S = axis_size(mesh, stage_axis)
    s = axis_rank(mesh, stage_axis)
    L = len(blocks)
    if L % S:
        raise ValueError(f"{L} blocks do not divide over {S} stages")
    mine = blocks[s * L // S:(s + 1) * L // S]
    M = x_microbatches.shape[0]
    group = axis_group(mesh, stage_axis) if S > 1 else None
    ranks = group_ranks(group) if group is not None else []
    anchor = x_microbatches.new_zeros((), requires_grad=True)
    outs, sent = [None] * M, []
    for t in range(M + S - 1):
        mb = t - s
        if not 0 <= mb < M:
            continue
        h = x_microbatches[mb] if s == 0 else _Recv.apply(
            anchor, x_microbatches[0], ranks[s - 1], mb)
        for blk in mine:
            h = block_fn(blk, h)
        if s < S - 1:
            sent.append(_Send.apply(h, ranks[s + 1], mb))
        else:
            outs[mb] = h
    if S == 1:
        return torch.stack(outs)
    if s == S - 1:
        y = torch.stack(outs)
    else:
        y = torch.zeros_like(x_microbatches) + torch.stack(sent).sum().to(x_microbatches.dtype)
    return broadcast(y, ranks[S - 1], group)

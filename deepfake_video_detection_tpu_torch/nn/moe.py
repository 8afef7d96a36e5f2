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

The expert-parallel path (``apply_expert_parallel``) shards the experts
over a mesh and is not ported (ROADMAP item 18(c)).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.nn import init as I
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

    def apply_expert_parallel(self, *args, **kwargs):
        raise NotImplementedError(
            "MoEMLP.apply_expert_parallel (experts sharded over a mesh) is not "
            "ported yet (ROADMAP item 18(c): sequence and expert parallelism)")

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        return self.apply_dense(x, with_aux)


def load_balance_loss(router_probs: torch.Tensor, expert_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E · Σ_e fraction_e · prob_e."""
    fraction = F.one_hot(expert_idx, num_experts).to(torch.float32).mean(dim=0)
    prob = router_probs.to(torch.float32).mean(dim=0)
    return num_experts * torch.sum(fraction * prob)

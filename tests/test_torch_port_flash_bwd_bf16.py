"""The bf16 flash backward's arithmetic and its tensor maps, on the CPU.

On the card, ``csrc/flash_bwd.cu`` runs the bf16 backward as two Hopper
passes: D = rowsum(dO * O) in f32; a dQ pass streaming 64-row K/V tiles
and a dK/dV pass streaming 64-row Q/dO tiles (``_bwd_tile``), each forming
P = exp2(S scale log2(e) - L log2(e)) and dS = P (dP - D) on f32
accumulators and rounding P and dS once to bf16 as the operands of dQ += dS
K, dV += P^T dO and dK += dS^T Q, f32 sums tile after tile; at N > 512 the
streamed tiles are cut into the splits of ``_long_splits``, whose f32
partials a reduce kernel sums in order. This file holds (a) a plain-torch
model of that arithmetic, held with numpy-seeded inputs against ``jax.vjp``
of the JAX package's ``flash_attention`` in interpret mode within
``chip_smoke.py``'s bf16 gates, and (b) the tensor maps of the backward's
operands (the fused-QKV views, dO's head-merge view, O and the gradients'
``(B, N, H, d)`` buffers): their byte strides and 64-row boxes address
exactly the views' elements. The kernels run only on a card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``,
``tools/flash_bwd_check.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL_REL, K4_TOL_FLOOR
from deepfake_video_detection_tpu.ops.attention import flash_attention
from deepfake_video_detection_tpu_torch.ops import attention as A
from test_torch_port_flash_bf16 import _box, _fused_qkv, _storage

LOG2E = 1.4426950408889634


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _runs(tiles: int, splits: int):
    """The streamed tiles of each split, as the kernels give them."""
    return [range(s * tiles // splits, (s + 1) * tiles // splits) for s in range(splits)]


def model_bwd(q, k, v, out, lse, dout, splits=1, rounding=True):
    """The kernels' backward on bf16 ``(B, H, N, d)`` inputs and the
    forward's ``out`` and f32 ``lse``: f32 ``(dq, dk, dv)`` before their one
    bf16 rounding. Streamed tiles of ``_bwd_tile(d)`` rows (keys in the dQ
    pass, query rows in the dK/dV pass); keys and query rows past N take no
    part (their P is 0); each split sums its run of tiles in order and the
    splits' partials are summed in order, then dQ and dK are scaled.
    ``rounding`` off keeps P and dS in f32 as product operands."""
    B, H, N, d = q.shape
    rows = A._bwd_tile(d)
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * LOG2E
    rnd = _bf16 if rounding else (lambda x: x)
    qf, kf, vf, of, dof = (t.to(torch.float32) for t in (q, k, v, out, dout))
    dcap = (dof * of).sum(-1, keepdim=True)             # D, (B, H, N, 1)
    l2 = lse.to(torch.float32)[..., None] * LOG2E       # L in log2 units
    tiles = -(-N // rows)
    dq_parts, dk_parts, dv_parts = [], [], []
    for run in _runs(tiles, splits):
        dq = torch.zeros_like(qf)
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        for t in run:
            n = slice(t * rows, min((t + 1) * rows, N))
            # dQ pass: keys of tile t against every query row
            p = torch.exp2(qf @ kf[:, :, n].transpose(-1, -2) * sl2 - l2)
            ds = p * (dof @ vf[:, :, n].transpose(-1, -2) - dcap)
            dq = dq + rnd(ds) @ kf[:, :, n]
            # dK/dV pass: query rows of tile t against every key
            lt, dt = (x[:, :, n].transpose(-1, -2) for x in (l2, dcap))
            pt = torch.exp2(kf @ qf[:, :, n].transpose(-1, -2) * sl2 - lt)
            dst = pt * (vf @ dof[:, :, n].transpose(-1, -2) - dt)
            dv = dv + rnd(pt) @ dof[:, :, n]
            dk = dk + rnd(dst) @ qf[:, :, n]
        dq_parts.append(dq)
        dk_parts.append(dk)
        dv_parts.append(dv)

    def in_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    return in_order(dq_parts) * scale, in_order(dk_parts) * scale, in_order(dv_parts)


def _inputs(shape, seed):
    """q, k, v and dO in bf16 from a numpy seed, with the port's plain
    forward's out (bf16) and lse (f32), as the kernels receive them."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
                  for _ in range(4))
    out, lse = A.flash_attention_plain(q, k, v)
    return q, k, v, out, lse, g


def _jax_grads(q, k, v, g):
    """jax.vjp of the JAX package's flash_attention (its Pallas backward in
    interpret mode) on the same bf16 inputs, as f32 torch tensors."""
    qj, kj, vj, gj = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, interpret=True), qj, kj, vj)
    return [torch.from_numpy(np.array(x, dtype=np.float32)) for x in vjp(gj)]


@pytest.mark.parametrize("shape", [(1, 2, 197, 64), (1, 1, 600, 64), (2, 3, 77, 36)])
def test_model_holds_the_bf16_gates_against_pallas_interpret(shape):
    """N = 197 (a partial last tile) and d = 36 reach the JAX package's short
    backward (K4), N = 600 its streaming passes (K5, K6) and, on the card,
    the split route with ``_long_splits``' S; the model's gradients rounded
    once to bf16 against JAX's, each within BF16_TOL_REL of its max |value|
    (floor K4_TOL_FLOOR)."""
    B, H, N, d = shape
    splits = A._long_splits(B, H, N, d)[1]
    assert (splits > 1) == (N > 512)
    q, k, v, out, lse, g = _inputs(shape, N + d)
    refs = _jax_grads(q, k, v, g)
    for got, ref in zip(model_bwd(q, k, v, out, lse, g, splits), refs):
        err = float((_bf16(got) - ref).abs().max())
        assert err <= max(BF16_TOL_REL * float(ref.abs().max()), K4_TOL_FLOOR)


def test_one_rounding_of_p_and_ds_stays_near_the_f32_gradient():
    """P and dS rounded once to bf16 as product operands move the gradients
    by far less than the bf16 gate: within 1e-2 of max |value| of the model
    with f32 operands (the f32 plain backward's arithmetic)."""
    q, k, v, out, lse, g = _inputs((1, 2, 197, 64), 5)
    exact = model_bwd(q, k, v, out, lse, g, rounding=False)
    plain = A.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, out)), lse, g.float())
    for got, f32, ref in zip(model_bwd(q, k, v, out, lse, g), exact, plain):
        scale = float(ref.abs().max())
        assert float((f32 - ref).abs().max()) <= 1e-5 * scale
        assert float((got - f32).abs().max()) <= 1e-2 * scale


def test_split_partials_summed_in_order_match_one_pass():
    """The split route's partials, summed in order, give the unsplit
    gradients to f32 rounding (the kernels' reruns are bit-identical either
    way)."""
    q, k, v, out, lse, g = _inputs((1, 2, 641, 64), 6)
    one = model_bwd(q, k, v, out, lse, g)
    for s in (2, A._long_splits(1, 2, 641, 64)[1]):
        for a, b in zip(model_bwd(q, k, v, out, lse, g, s), one):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_backward_shared_memory_fits_the_card():
    """Each pass's block fits an H100's 227 KB at every padded head dim,
    and at d = 64 the dQ pass fits 3 blocks an SM, the dK/dV pass 2 (the
    blocks its registers allow, _BWD_BLOCKS_PER_SM)."""
    for d in (8, 64, 80, 128, 136, 192, 256):
        assert max(A._bwd_smem(d)) <= A._SMEM_PER_SM
    dq, dkv = A._bwd_smem(64)
    assert A._SMEM_PER_SM // dq >= 3 and A._SMEM_PER_SM // dkv >= A._BWD_BLOCKS_PER_SM


# (b) the tensor maps

def _head_merge_grad(B, N, H, d):
    """dO as autograd hands it back through the head merge: the (B, H, N, d)
    view of a (B, N, H*d) gradient."""
    g = torch.arange(B * N * H * d, dtype=torch.float32).to(torch.bfloat16)
    return g.view(B, N, H * d).view(B, N, H, d).transpose(1, 2)


@pytest.mark.parametrize("case", ["fused QKV q", "fused QKV k", "fused QKV v", "dO head merge",
                                  "out and the gradients", "d = 80, dO head merge",
                                  "padded copy of d = 36"])
def test_backward_tensor_maps_address_exactly_the_view(case):
    """The backward reads q, k, v, O and dO and writes dq, dk and dv through
    one tensor map each, 64-row boxes for its own tiles and its streamed ones
    alike: dims (d, N, H, B) and the byte strides of N, H and B address each
    element of the view, and every box at the ragged edges holds the view's
    elements and zeros past N and d."""
    B, H, N = 2, 3, 197
    if case.startswith("fused QKV"):
        t = _fused_qkv(B, N, H, 64)["qkv".index(case[-1])]
    elif case == "dO head merge":
        t = _head_merge_grad(B, N, H, 64)
    elif case.startswith("d = 80"):
        t = _head_merge_grad(B, N, H, 80)
    elif case.startswith("out"):
        t = A._heads_view(B, H, N, 64, torch.empty(0, dtype=torch.bfloat16))
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).view(t.shape).to(torch.bfloat16))
    else:
        t = A._pad_head_dim(_head_merge_grad(B, N, H, 36))
        assert t.shape[-1] == 40
    d = t.shape[-1]
    rows = A._bwd_tile(d)
    assert rows == A._ROW_TILE == 64
    geo = A._tma_geometry(t, rows)
    assert geo is not None
    dims, strides, box = geo
    assert dims == (d, N, H, B) and box == (64, rows)
    es = t.element_size()
    view = torch.as_strided(_storage(t), (B, H, N, d),
                            (strides[2] // es, strides[1] // es, strides[0] // es, 1),
                            t.storage_offset())
    assert torch.equal(view, t)
    for b in range(B):
        for h in (0, H - 1):
            for r0 in (0, rows, (N - 1) // rows * rows):
                for c0 in range(0, -(-d // 64) * 64, 64):
                    want = torch.zeros((rows, 64), dtype=t.dtype)
                    part = t[b, h, r0:r0 + rows, c0:c0 + 64]
                    want[:part.shape[0], :part.shape[1]] = part
                    assert torch.equal(_box(t, geo, c0, r0, h, b), want)


def test_backward_copies_what_tma_cannot_describe():
    """dO with rows of 72 bytes (d = 36) has no tensor map; the wrapper's
    zero-padded contiguous copy has one and holds dO in its first d
    columns."""
    g = _head_merge_grad(2, 50, 3, 36)
    assert A._tma_geometry(g, A._bwd_tile(36)) is None
    copy = A._pad_head_dim(g)
    assert A._tma_geometry(copy, A._bwd_tile(36)) is not None
    assert torch.equal(copy[..., :36], g) and not copy[..., 36:].any()

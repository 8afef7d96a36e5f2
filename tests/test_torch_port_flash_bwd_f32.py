"""The f32 flash backward's arithmetic and its tensor maps, on the CPU.

On the card, ``csrc/flash_bwd.cu`` runs the f32 backward as two Hopper
passes on tf32 ``wgmma``: D = rowsum(dO * O) in f32; a dQ pass over the
query rows streaming tiles of ``_bwd_tile(d, bf16=False)`` keys and a dK/dV
pass over the keys streaming tiles of as many query rows. Each forms S (or
S^T) and dP (or dP^T) over the head dim, P = exp2(S scale log2(e) - L
log2(e)) and dS = P (dP - D) on f32 accumulators, and adds dQ += dS K,
dV += P^T dO and dK += dS^T Q tile after tile. Every product is 3xTF32, k-step
by k-step (8 of the reduction axis): each operand split into big (x
truncated to tf32) and small (x - big rounded to tf32 as cvt.rna rounds),
then small.big, big.small and big.big added in f32, in that order. This
file holds (a) a plain-torch model of that arithmetic, held with
numpy-seeded inputs against ``jax.vjp`` of the JAX package's
``flash_attention`` in interpret mode within ``K4_TOL_F32`` (the f32 gate of
``chip_smoke.py``), (b) the f32 tensor maps (32-column boxes, one 128-byte
swizzled row) of the backward's operands: the fused-QKV views, dO's
head-merge view, O and the gradients' ``(B, N, H, d)`` buffers, whose byte
strides and boxes address exactly the views' elements, (c) the f32 passes'
shared memory against an H100's, and (d) the bf16 ulp measure of the
long-clip training gate. The kernels run only on a card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``,
``tools/flash_bwd_check.py --dtype f32``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K4_TOL_F32, bf16_ulps
from deepfake_video_detection_tpu.ops.attention import flash_attention
from deepfake_video_detection_tpu_torch.ops import attention as A
from test_torch_port_flash_bf16 import _box, _storage
from test_torch_port_tf32 import tf32_rna, tf32_trunc

LOG2E = 1.4426950408889634
KSTEP = 8   # the reduction depth of one tf32 wgmma


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 kernels take it: k-step by k-step over the reduction
    axis, each k-step small(a) big(b), big(a) small(b), then big(a) big(b),
    added in f32 into the running sum."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], KSTEP):
        x, y = a[..., k0:k0 + KSTEP], b[..., k0:k0 + KSTEP, :]
        xb, yb = tf32_trunc(x), tf32_trunc(y)
        xs, ys = tf32_rna(x - xb), tf32_rna(y - yb)
        acc = acc + xs @ yb
        acc = acc + xb @ ys
        acc = acc + xb @ yb
    return acc


def model_bwd(q, k, v, out, lse, dout):
    """The f32 kernels' backward on f32 ``(B, H, N, d)`` inputs and the
    forward's ``out`` and ``lse``: ``(dq, dk, dv)``. Streamed tiles of
    ``_bwd_tile(d, bf16=False)`` rows (keys in the dQ pass, query rows in the
    dK/dV pass), each pass summing its tiles in order; rows past N take no
    part (their P is 0); dQ and dK scaled last."""
    B, H, N, d = q.shape
    rows = A._bwd_tile(d, bf16=False)
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * LOG2E
    dcap = (dout * out).sum(-1, keepdim=True)           # D, (B, H, N, 1)
    l2 = lse[..., None] * LOG2E                         # L in log2 units
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for t in range(-(-N // rows)):
        n = slice(t * rows, min((t + 1) * rows, N))
        # dQ pass: keys of tile t against every query row
        p = torch.exp2(mm3(q, k[:, :, n].transpose(-1, -2)) * sl2 - l2)
        ds = p * (mm3(dout, v[:, :, n].transpose(-1, -2)) - dcap)
        dq = dq + mm3(ds, k[:, :, n])
        # dK/dV pass: query rows of tile t against every key
        lt, dt = (x[:, :, n].transpose(-1, -2) for x in (l2, dcap))
        pt = torch.exp2(mm3(k, q[:, :, n].transpose(-1, -2)) * sl2 - lt)
        dst = pt * (mm3(v, dout[:, :, n].transpose(-1, -2)) - dt)
        dv = dv + mm3(pt, dout[:, :, n])
        dk = dk + mm3(dst, q[:, :, n])
    return dq * scale, dk * scale, dv


def _inputs(shape, seed):
    """q, k, v and dO in f32 from a numpy seed, with the port's plain
    forward's out and lse, as the kernels receive them."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(4))
    out, lse = A.flash_attention_plain(q, k, v)
    return q, k, v, out, lse, g


def _jax_grads(q, k, v, g):
    """jax.vjp of the JAX package's flash_attention (its Pallas backward in
    interpret mode) on the same f32 inputs."""
    qj, kj, vj, gj = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, interpret=True), qj, kj, vj)
    return [torch.from_numpy(np.array(x)) for x in vjp(gj)]


@pytest.mark.parametrize("shape", [(1, 2, 197, 64), (1, 1, 600, 64), (2, 3, 77, 36)])
def test_model_holds_the_f32_gate_against_pallas_interpret(shape):
    """N = 197 (a partial last tile) and d = 36 (the kernels pad it to 64 by
    TMA's zero fill) reach the JAX package's short backward (K4), N = 600 its
    streaming passes (K5, K6), which the f32 kernels serve unsplit. The
    model's gradients hold the gate against JAX's, and against the plain
    f32 backward with a tenth of it, as the 3xTF32 model did before."""
    q, k, v, out, lse, g = _inputs(shape, sum(shape))
    got = model_bwd(q, k, v, out, lse, g)
    plain = A.flash_attention_bwd_plain(q, k, v, out, lse, g)
    for a, ref, p in zip(got, _jax_grads(q, k, v, g), plain):
        assert torch.allclose(a, ref, atol=K4_TOL_F32, rtol=K4_TOL_F32)
        assert torch.allclose(a, p, atol=K4_TOL_F32 / 10, rtol=K4_TOL_F32 / 10)


def test_one_tf32_term_misses_what_three_hold():
    """Why every product takes three terms: with big alone (x truncated to
    tf32) the same tile order leaves gradients ~2^-10 off the plain f32
    backward, where 3xTF32 stays within 1e-5 of their largest |value|."""
    q, k, v, out, lse, g = _inputs((1, 2, 197, 64), 3)
    plain = A.flash_attention_bwd_plain(q, k, v, out, lse, g)
    three = model_bwd(q, k, v, out, lse, g)
    one = model_bwd(*(tf32_trunc(t) for t in (q, k, v, out)), lse, tf32_trunc(g))
    for a, b, p in zip(three, one, plain):
        top = float(p.abs().max())
        assert float((a - p).abs().max()) <= 1e-5 * top
        assert float((b - p).abs().max()) > 1e-4 * top


def test_streamed_tile_rows():
    """32-row streamed tiles (16 above d = 128, where a 64 x 256 f32 tile
    fills a quarter of a block's shared memory), each a whole number of the
    128-byte swizzle's 8-row groups; bf16 keeps its 64."""
    assert [A._bwd_tile(d, bf16=False) for d in (4, 32, 64, 128, 132, 256)] == \
        [32, 32, 32, 32, 16, 16]
    assert A._bwd_tile(64) == A._bwd_tile(256) == A._ROW_TILE
    assert all(A._bwd_tile(d, bf16=False) % 8 == 0 for d in range(4, 257, 4))


def test_f32_backward_shared_memory_fits_the_card():
    """Each f32 pass's block fits an H100's 227 KB at every padded head dim,
    and at d = 64 (every main path) two blocks of each pass fit an SM."""
    for d in (4, 32, 36, 64, 80, 128, 132, 192, 256):
        assert max(A._bwd_smem(d, bf16=False)) <= A._SMEM_PER_SM, d
    assert all(A._SMEM_PER_SM // x >= 2 for x in A._bwd_smem(64, bf16=False))


# (b) the f32 tensor maps

def _fused_qkv_f32(B, N, H, d):
    qkv = torch.arange(B * N * 3 * H * d, dtype=torch.float32)
    return qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)


def _head_merge_grad(B, N, H, d):
    """dO as autograd hands it back through the head merge: the (B, H, N, d)
    view of a (B, N, H*d) gradient."""
    g = torch.arange(B * N * H * d, dtype=torch.float32)
    return g.view(B, N, H * d).view(B, N, H, d).transpose(1, 2)


@pytest.mark.parametrize("case", ["fused QKV q", "fused QKV k", "fused QKV v", "dO head merge",
                                  "out and the gradients", "d = 80, dO head merge",
                                  "padded copy of d = 30", "d = 256, fused QKV k"])
def test_f32_tensor_maps_address_exactly_the_view(case):
    """The f32 backward reads q, k, v and dO and writes dq, dk and dv through
    one tensor map each, boxes of 32 columns (one 128-byte swizzled row) by
    ``_bwd_tile(d, bf16=False)`` rows for its own tiles and its streamed ones
    alike: dims (d, N, H, B) and the byte strides of N, H and B address each
    element of the view, and every box at the ragged edges holds the view's
    elements and zeros past N and d."""
    B, H, N = 2, 3, 197
    if case.startswith("fused QKV"):
        t = _fused_qkv_f32(B, N, H, 64)["qkv".index(case[-1])]
    elif case.startswith("d = 256"):
        t = _fused_qkv_f32(B, 40, H, 256)[1]
        N = 40
    elif case == "dO head merge":
        t = _head_merge_grad(B, N, H, 64)
    elif case.startswith("d = 80"):
        t = _head_merge_grad(B, N, H, 80)
    elif case.startswith("out"):
        t = A._heads_view(B, H, N, 64, torch.empty(0))
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).view(t.shape))
    else:
        g = _head_merge_grad(B, N, H, 30)
        assert A._tma_geometry(g, A._bwd_tile(30, bf16=False)) is None   # 120-byte rows
        t = A._pad_head_dim(g)
        assert t.shape[-1] == 32 and torch.equal(t[..., :30], g) and not t[..., 30:].any()
    d = t.shape[-1]
    rows = A._bwd_tile(d, bf16=False)
    geo = A._tma_geometry(t, rows)
    assert geo is not None
    dims, strides, box = geo
    assert dims == (d, N, H, B) and box == (32, rows)
    es = t.element_size()
    view = torch.as_strided(_storage(t), (B, H, N, d),
                            (strides[2] // es, strides[1] // es, strides[0] // es, 1),
                            t.storage_offset())
    assert torch.equal(view, t)
    for b in range(B):
        for h in (0, H - 1):
            for r0 in (0, rows, (N - 1) // rows * rows):
                for c0 in range(0, -(-d // 32) * 32, 32):
                    want = torch.zeros((rows, 32), dtype=t.dtype)
                    part = t[b, h, r0:r0 + rows, c0:c0 + 32]
                    want[:part.shape[0], :part.shape[1]] = part
                    assert torch.equal(_box(t, geo, c0, r0, h, b), want)


# (d) the long-clip training gate's measure of a logit's gap

@pytest.mark.parametrize("a,b,ulps", [
    (2.25, 2.234375, 1.0),          # the gate's flipped logit: one ulp at [2, 4)
    (-0.5, -0.5, 0.0),
    (1.0, 1.0078125, 1.0),          # one ulp above 1
    (0.75, 0.7578125, 2.0),         # two ulps at [0.5, 1)
    (100.0, 101.0, 2.0),            # 0.5 an ulp at [64, 128)
])
def test_bf16_ulps_of_a_logit_gap(a, b, ulps):
    """The gate holds each logit within LONG_TOL_LOGIT_ULPS bf16 ulps (8
    significant bits) of the plain path's, counted at the larger
    magnitude."""
    x, y = torch.tensor([a, 3.0]), torch.tensor([b, 3.0])
    assert bf16_ulps(torch, x, y) == ulps == bf16_ulps(torch, y, x)

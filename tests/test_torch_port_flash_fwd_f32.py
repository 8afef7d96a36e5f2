"""The f32 flash forward's arithmetic and its tensor maps, on the CPU.

On the card, ``csrc/flash_fwd.cu`` runs the f32 forward as one Hopper
kernel on tf32 ``wgmma``: TMA loads Q once and K/V tiles of
``_fwd_key_tile(d, bf16=False)`` keys through f32 tensor maps (32-column
boxes, 64 rows for Q and O); S = Q K^T per key tile, the online softmax on
f32 accumulators (exp2 with the scale times log2(e) folded in), and O += P V
with P split into two tf32 terms in registers and V's tile transposed into
two terms in shared memory. Every product is 3xTF32, k-step by k-step (8 of
the reduction axis): small.big, big.small, big.big added in f32. This file
holds (a) a plain-torch model of that arithmetic, held with numpy-seeded
inputs against the JAX package's ``_flash_impl`` in interpret mode within
``K2_TOL_F32`` and ``K2_TOL_LSE`` (the f32 gates of ``chip_smoke.py``),
(b) the f32 forward's tensor maps of the fused-QKV views and the ``(B, N,
H, d)`` output buffer at the f32 ViT-B/16 and vit_gcn shapes, and (c) its
shared memory against an H100's. The kernel runs only on a card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``,
``tools/flash_fwd_check.py --dtype f32``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K2_TOL_F32, K2_TOL_LSE
from deepfake_video_detection_tpu.ops.attention import _flash_impl
from deepfake_video_detection_tpu_torch.ops import attention as A
from test_torch_port_flash_bf16 import _box, _storage
from test_torch_port_flash_bwd_f32 import mm3
from test_torch_port_tf32 import mm1

LOG2E = 1.4426950408889634


def model_fwd(q, k, v, mm=mm3):
    """The f32 kernel's forward on f32 ``(B, H, N, d)`` inputs: ``(O,
    lse)``. Key tiles of ``_fwd_key_tile(d, bf16=False)``; per tile S
    through ``mm``, the running max in log2 units on the raw scores times
    scale log2(e), P = exp2(S scale log2(e) - m), O rescaled and P V added
    through ``mm``; l guarded by 1e-30; lse back in the natural log."""
    B, H, N, d = q.shape
    bn = A._fwd_key_tile(d, bf16=False)
    sl2 = LOG2E / math.sqrt(d)
    m = torch.full((B, H, N, 1), -1e30)
    l = torch.zeros((B, H, N, 1))
    acc = torch.zeros((B, H, N, d))
    for t in range(-(-N // bn)):
        keys = slice(t * bn, min((t + 1) * bn, N))    # masked keys give P = 0
        sc = mm(q, k[:, :, keys].transpose(-1, -2))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc * sl2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, v[:, :, keys])
        m = m_new
    l = l.clamp_min(1e-30)
    return acc / l, (m / LOG2E + torch.log(l))[..., 0]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 2, 197, 64), (2, 3, 77, 36)])
def test_model_holds_the_f32_gates_against_pallas_interpret(shape):
    """N = 197 (a last key tile of 5 live keys; JAX's short kernel, K2) and
    d = 36 (the kernel pads it to 64 by TMA's zero fill): the model holds
    O within K2_TOL_F32 and lse within K2_TOL_LSE of JAX's, and of the plain
    f32 forward within a tenth of each."""
    q, k, v = _inputs(shape, sum(shape))
    ref_o, ref_lse = _flash_impl(*(jnp.asarray(t.numpy()) for t in (q, k, v)), interpret=True)
    ref_o = torch.from_numpy(np.array(ref_o))
    ref_lse = torch.from_numpy(np.array(ref_lse))[..., 0]
    out, lse = model_fwd(q, k, v)
    assert float((out - ref_o).abs().max()) <= K2_TOL_F32
    assert float((lse - ref_lse).abs().max()) <= K2_TOL_LSE
    plain, plain_lse = A.flash_attention_plain(q, k, v)
    assert float((out - plain).abs().max()) <= K2_TOL_F32 / 10
    assert float((lse - plain_lse).abs().max()) <= K2_TOL_LSE / 10


def test_one_tf32_term_misses_what_three_hold():
    """Why each product takes three terms (P's two among them): one tf32
    term per operand leaves O ~2^-11 off the plain f32 forward, past the
    1e-4 gate, where 3xTF32 in the kernel's tile order stays far inside it."""
    q, k, v = _inputs((1, 2, 197, 64), 5)
    plain, _ = A.flash_attention_plain(q, k, v)
    three = float((model_fwd(q, k, v)[0] - plain).abs().max())
    one = float((model_fwd(q, k, v, mm=mm1)[0] - plain).abs().max())
    assert three <= K2_TOL_F32 / 10 < K2_TOL_F32 < one


def test_f32_forward_geometry():
    """32-key tiles (one 128-byte row of V's transposed tile, its keys in
    four 8-deep k-steps) at every d, the f32 kernels' padded head dims,
    and a block's shared memory within an H100's: three blocks an SM at
    d = 64 (every main path; the kernel's registers allow three), one at
    d = 256."""
    assert {A._fwd_key_tile(d, bf16=False) for d in range(4, 257, 4)} == {32}
    assert [A._f32_dp(d) for d in (4, 32, 36, 64, 80, 128, 132, 256)] == \
        [32, 32, 64, 64, 128, 128, 256, 256]
    for d in range(4, 257, 4):
        assert A._fwd_smem(d, bf16=False) <= A._SMEM_PER_SM, d
    assert A._SMEM_PER_SM // A._fwd_smem(64, bf16=False) >= 3
    assert A._SMEM_PER_SM // A._fwd_smem(256, bf16=False) >= 1


def _fused_qkv_f32(B, N, H, d, empty=False):
    if empty:   # not touched: only its geometry is read
        qkv = torch.empty((B, N, 3, H, d))
    else:
        qkv = torch.arange(B * N * 3 * H * d, dtype=torch.float32).view(B, N, 3, H, d)
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def _operands(B, H, N, d, empty=False):
    """q, k, v as the fused QKV projection's views and O's ``(B, N, H, d)``
    buffer, with the rows of each one's box: 64 for Q and O, the key tile
    for K and V."""
    out = A._heads_view(B, H, N, d, torch.empty(0))
    if not empty:
        out.copy_(-torch.arange(out.numel(), dtype=torch.float32).view(out.shape))
    tile = A._fwd_key_tile(d, bf16=False)
    return list(zip((*_fused_qkv_f32(B, N, H, d, empty), out),
                    (A._ROW_TILE, tile, tile, A._ROW_TILE), "qkvo"))


@pytest.mark.parametrize("H", [12, 3])
def test_f32_forward_maps_at_the_training_shapes(H):
    """At the f32 ViT-B/16 step's shape (128, 12, 197, 64) and the training
    CLI's default vit_gcn step's (128, 3, 197, 64), the wrapper takes the
    fused QKV views and O's buffer as they are (no padded copy): dims (d, N,
    H, B), 16-byte multiples for the byte strides of N, H and B, boxes of 32
    columns by 64 rows (Q, O) or 32 (K, V)."""
    B, N, d = 128, 197, 64
    ops = _operands(B, H, N, d, empty=True)
    geos = A._tma_geometries([t for t, _, _ in ops], tuple(r for _, r, _ in ops))
    assert geos is not None
    for (t, rows, name), (dims, strides, box) in zip(ops, geos):
        assert dims == (d, N, H, B) and box == (32, rows), name
        step = (3 * H * d if name in "qkv" else H * d) * 4    # bytes between tokens
        assert strides == (step, d * 4, N * step), name


@pytest.mark.parametrize("name", list("qkvo"))
@pytest.mark.parametrize("H", [12, 3])
def test_f32_forward_maps_address_exactly_the_view(H, name):
    """The same maps on two clips of the training shapes: every element of
    the view through ``torch.as_strided`` on its storage, and every box the
    kernel loads or stores at the ragged edges (rows past N and columns past
    d read as zeros)."""
    B, N, d = 2, 197, 64
    t, rows, _ = next(op for op in _operands(B, H, N, d) if op[2] == name)
    geo = A._tma_geometry(t, rows)
    (_, _, _, _), strides, (cols, _) = geo
    es = t.element_size()
    view = torch.as_strided(_storage(t), (B, H, N, d),
                            (strides[2] // es, strides[1] // es, strides[0] // es, 1),
                            t.storage_offset())
    assert torch.equal(view, t)
    for b in range(B):
        for h in (0, H - 1):
            for r0 in range(0, N, rows):
                for c0 in range(0, d, cols):
                    want = torch.zeros((rows, cols))
                    part = t[b, h, r0:r0 + rows, c0:c0 + cols]
                    want[:part.shape[0], :part.shape[1]] = part
                    assert torch.equal(_box(t, geo, c0, r0, h, b), want)

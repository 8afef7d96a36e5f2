"""The f32 flash kernels' arithmetic (3xTF32), modelled in plain PyTorch on the CPU.

On the card, ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` take every f32
product on the tensor cores as 3xTF32 (``csrc/mma_tf32.cuh``): each operand
x is split into big, x truncated to tf32, and small = x - big rounded to
tf32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero), and
a product a.b is taken as small(a).big(b) + big(a).small(b) + big(a).big(b)
with f32 sums. This file holds a model of that arithmetic (both roundings
as bit operations on the int32 view, the three-term product) and shows, with numpy-seeded inputs, that it holds the
f32 gates ``chip_smoke.py`` keeps against the plain versions where one tf32
term does not; and the layout rule of the wrapper (d a multiple of 16
bytes' worth, every tensor one a tensor map describes) on CPU tensors. The
kernels themselves run only on a card (``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chip_smoke import K2_TOL_F32, K2_TOL_LSE, K4_TOL_F32
from deepfake_video_detection_tpu.ops.attention import flash_attention as jax_flash
from deepfake_video_detection_tpu_torch.ops import attention as A


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero, as f32 (the 13 low bits zero). On the
    int32 view: add half of the dropped bits to the magnitude, truncate."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to tf32 (toward zero): the 13 low bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The kernels' split: big truncated, small = x - big rounded."""
    big = tf32_trunc(x)
    return big, tf32_rna(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32: small.big + big.small, then + big.big; each term's
    products are exact in f32 (11-bit significands) and summed in f32."""
    ab, a_s = split(a)
    bb, b_s = split(b)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with one tf32 term per operand."""
    return tf32_rna(a) @ tf32_rna(b)


def emulated_fwd(q, k, v, mm=mm3):
    """The forward kernel's arithmetic: S = Q K^T and O = P V through ``mm``,
    the softmax in f32 on the unnormalised P, l guarded by 1e-30."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return mm(p, v) / l, (m + torch.log(l)).squeeze(-1)


def emulated_bwd(q, k, v, out, lse, dout, mm=mm3):
    """The dQ and dK/dV passes' arithmetic: P from lse, D = rowsum(dO O),
    dS = P (dP - D), every product through ``mm``."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    p = torch.exp(mm(q, k.transpose(-1, -2)) * scale - lse[..., None])
    dcap = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (mm(dout, v.transpose(-1, -2)) - dcap)
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), dout))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(4)]


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor([np.uint32(bits).view(np.int32)], dtype=torch.int32).view(torch.float32)


def _bits(x: torch.Tensor) -> int:
    return int(np.int32(x.view(torch.int32)[0]).view(np.uint32))


@pytest.mark.parametrize("bits,rna,trunc", [
    (0x3F801000, 0x3F802000, 0x3F800000),   # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000, 0xBF800000),   # -(1 + 2^-11): a tie, away from zero (more negative)
    (0x3F800FFF, 0x3F800000, 0x3F800000),   # below the tie: down
    (0x3F801001, 0x3F802000, 0x3F800000),   # above the tie: up
    (0x3FFFFFFF, 0x40000000, 0x3FFFE000),   # just below 2: the carry reaches the exponent
    (0x3FC00000, 0x3FC00000, 0x3FC00000),   # 1.5 is a tf32 value: unchanged, its small part 0
])
def test_tf32_rounding_on_fixed_bit_patterns(bits, rna, trunc):
    x = _f32(bits)
    assert _bits(tf32_rna(x)) == rna and _bits(tf32_trunc(x)) == trunc
    big, small = split(x)
    assert _bits(big) == trunc
    assert abs(float(big[0]) + float(small[0]) - float(x[0])) <= 2.0 ** -21 * abs(float(x[0]))
    if bits == trunc:
        assert float(small[0]) == 0.0


def test_card_nan_stays_nan_in_big():
    """0x7fffffff, the NaN the card's arithmetic makes: rounded to nearest
    by the integer operations it would carry into the sign bit and come out
    as -0; truncated, big stays a NaN, so every product it enters is NaN."""
    x = _f32(0x7FFFFFFF)
    assert _bits(tf32_rna(x)) == 0x80000000
    big, _ = split(x)
    assert bool(big.isnan().all())
    assert bool((big @ torch.ones(1, 1)).isnan().all())


def test_two_tf32_terms_hold_f32_to_2e_21():
    """big + small carries 21 significant bits and more: with big truncated,
    |small| < 2^-10 |x|, rounded to 11 bits, so |x - big - small| ≤ 2^-21 |x|."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=100_000).astype(np.float32) * 10)
    big, small = split(x)
    assert bool((tf32_rna(big) == big).all() and (tf32_rna(small) == small).all())
    assert bool((small.abs() < 2.0 ** -10 * x.abs()).all())
    err = (x.double() - big.double() - small.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


@pytest.mark.parametrize("shape", [(2, 12, 197, 64), (1, 4, 641, 64)])
def test_3xtf32_forward_holds_the_f32_gates(shape):
    """The ViT-B/16 shape and the long-clip training shape: 3xTF32 holds O
    to K2_TOL_F32 and lse to K2_TOL_LSE against the plain f32 forward."""
    q, k, v, _ = _inputs(shape, 7)
    ref, ref_lse = A.flash_attention_plain(q, k, v)
    out, lse = emulated_fwd(q, k, v)
    assert float((out - ref).abs().max()) <= K2_TOL_F32 / 10
    assert float((lse - ref_lse).abs().max()) <= K2_TOL_LSE / 10


@pytest.mark.parametrize("shape", [(2, 12, 197, 64), (1, 4, 641, 64)])
def test_3xtf32_backward_holds_the_f32_gate(shape):
    q, k, v, dout = _inputs(shape, 8)
    out, lse = A.flash_attention_plain(q, k, v)
    ref = A.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    for g, r in zip(emulated_bwd(q, k, v, out, lse, dout), ref):
        assert torch.allclose(g, r, atol=K4_TOL_F32 / 10, rtol=K4_TOL_F32 / 10)


def test_one_tf32_term_misses_the_forward_gate():
    """Why the kernels take three products: one tf32 term per operand keeps
    2^-11 and misses the 1e-4 forward gate at the ViT-B/16 shape."""
    q, k, v, _ = _inputs((2, 12, 197, 64), 7)
    ref, _ = A.flash_attention_plain(q, k, v)
    out, _ = emulated_fwd(q, k, v, mm=mm1)
    assert float((out - ref).abs().max()) > K2_TOL_F32


def test_3xtf32_forward_matches_pallas_interpret():
    """The model against the JAX package's short-N Pallas kernel (K2) in
    interpret mode, at the tolerance of the plain version's own test."""
    q, k, v, _ = _inputs((1, 2, 197, 64), 9)
    ref = np.asarray(jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)), interpret=True))
    np.testing.assert_allclose(emulated_fwd(q, k, v)[0].numpy(), ref, atol=2e-5)


def _fused_qkv(d, dtype=torch.float32):
    qkv = torch.zeros((2, 50, 3, 4, d), dtype=dtype)
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("case,aligned", [
    ("f32 views of a fused QKV buffer", True),
    ("f32 d = 30", False),
    ("f32 N stride not a multiple of 4", False),
    ("f32 data 4 bytes off 16", False),
    ("bf16 d = 36 (needs 8)", False),
    ("bf16 views of a fused QKV buffer", True),
])
def test_layout_rule_of_the_kernels(case, aligned):
    """Both routes read their inputs through tensor maps: d a multiple of 4
    f32 (8 bf16) elements, byte strides multiples of 16 and 16-byte aligned
    data; anything else goes to the kernel as a contiguous copy zero-padded
    to that multiple in d."""
    if case.endswith("fused QKV buffer"):
        ts = _fused_qkv(64, torch.bfloat16 if case.startswith("bf16") else torch.float32)
    elif case == "f32 d = 30":
        ts = [torch.zeros((2, 4, 50, 30))]
    elif case.startswith("f32 N stride"):
        ts = [torch.zeros((2, 4, 50, 66))[..., :64]]
    elif case.startswith("f32 data"):
        ts = [torch.zeros(2 * 4 * 50 * 64 + 1)[1:].view(2, 4, 50, 64)]
    else:
        ts = [torch.zeros((2, 4, 50, 36), dtype=torch.bfloat16)]
    assert (A._tma_geometries(ts, A._ROW_TILE) is not None) == aligned
    if not aligned:
        t = ts[0]
        padded = A._pad_head_dim(t)
        multiple = 16 // t.element_size()
        assert padded.is_contiguous() and padded.shape[-1] % multiple == 0
        assert padded.shape[-1] - t.shape[-1] < multiple
        assert A._tma_geometries([padded], A._ROW_TILE) is not None
        assert torch.equal(padded[..., :t.shape[-1]], t)
        assert not padded[..., t.shape[-1]:].any()

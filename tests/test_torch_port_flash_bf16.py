"""The bf16 flash forward's arithmetic and its tensor maps, on the CPU.

On the card, ``csrc/flash_fwd.cu`` runs bf16 attention as Hopper kernels:
TMA loads Q, K and V through 4-D tensor maps into shared memory, wgmma
takes S = Q K^T per key tile in f32, the online softmax runs on the
accumulators (exp2 with the scale times log2(e) folded in), P enters P.V as
two bf16 terms (hi = bf16(P), lo = bf16(P - hi)) with f32 sums in tile
order, and at N > 512 the key tiles are cut into the splits of
``ops/attention.py::_long_splits``, whose f32 partials a combine kernel
merges in order. This file holds (a) a plain-torch model of that arithmetic
at the kernel's key tile, held with numpy-seeded inputs against the JAX
package's ``_flash_impl`` in interpret mode within ``chip_smoke.py``'s bf16
gates, and (b) the tensor-map geometry of ``_tma_geometry`` on CPU tensors:
the byte strides and boxes address exactly a view's elements, and what TMA
cannot describe is refused, so the wrapper copies it. The kernels run only
on a card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chip_smoke import BF16_TOL_REL, K2_TOL_LSE
from deepfake_video_detection_tpu.ops.attention import _flash_impl
from deepfake_video_detection_tpu_torch.ops import attention as A

LOG2E = 1.4426950408889634


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def model_fwd(q, k, v, splits=1, two_terms=True):
    """The kernels' forward on bf16 ``(B, H, N, d)`` inputs: f32 ``(O, lse)``
    with O before its one bf16 rounding. Key tiles of the kernel's width;
    split s walks tiles [s T / S, (s + 1) T / S) and ends in O_s = acc / l_s
    and lse_s; the splits are merged in order as the combine kernel does."""
    B, H, N, d = q.shape
    bn = A._fwd_key_tile(d)
    sl2 = LOG2E / math.sqrt(d)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    tiles = -(-N // bn)
    outs, lses = [], []
    for s in range(splits):
        m = torch.full((B, H, N, 1), -1e30)
        l = torch.zeros((B, H, N, 1))
        acc = torch.zeros((B, H, N, d))
        for t in range(s * tiles // splits, (s + 1) * tiles // splits):
            keys = slice(t * bn, min((t + 1) * bn, N))    # masked keys give P = 0
            sc = qf @ kf[:, :, keys].transpose(-1, -2)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True) * sl2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc * sl2 - m_new)
            hi = _bf16(p)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = hi @ vf[:, :, keys]
            if two_terms:
                pv = pv + _bf16(p - hi) @ vf[:, :, keys]
            acc = acc * alpha + pv
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append(acc / l)
        lses.append(m / LOG2E + torch.log(l))
    if splits == 1:
        return outs[0], lses[0][..., 0]
    mx = torch.stack(lses).amax(0)
    w = [torch.exp(x - mx) for x in lses]
    total = sum(w).clamp_min(1e-30)
    return sum(wi * o for wi, o in zip(w, outs)) / total, (mx + torch.log(total))[..., 0]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 3, 17, 64), (1, 2, 197, 64), (1, 1, 600, 64)])
def test_model_holds_the_bf16_gates_against_pallas_interpret(shape):
    """N = 17 and 197 reach the JAX package's short kernel (K2), N = 600 its
    streaming one (K3) and, on the card, the split route with
    ``_long_splits``' S; the model's O rounded once to bf16."""
    B, H, N, d = shape
    splits = A._long_splits(B, H, N, d)[0]
    assert (splits > 1) == (N > 512)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(shape, N))
    ref_o, ref_lse = _flash_impl(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                                   for t in (q, k, v)), interpret=True)
    ref_o = torch.from_numpy(np.array(ref_o, dtype=np.float32))
    ref_lse = torch.from_numpy(np.array(ref_lse, dtype=np.float32))[..., 0]
    out, lse = model_fwd(q, k, v, splits)
    err = float((_bf16(out) - ref_o).abs().max())
    assert err <= BF16_TOL_REL * float(ref_o.abs().max())
    assert float((lse - ref_lse).abs().max()) <= K2_TOL_LSE


def test_two_terms_of_p_keep_the_f32_product():
    """P as hi + lo keeps P.V to ~2^-17 of the f32 product: 20x closer to the
    plain f32 forward than one bf16 term of P, before O's own rounding."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs((1, 2, 197, 64), 3))
    ref, _ = A.flash_attention_plain(*(t.float() for t in (q, k, v)))
    two = float((model_fwd(q, k, v)[0] - ref).abs().max())
    one = float((model_fwd(q, k, v, two_terms=False)[0] - ref).abs().max())
    assert two < one / 20 and two < 1e-4


def test_splits_and_their_combine_match_one_pass():
    """The split route's partials, merged in order, give the unsplit result
    to f32 rounding (the kernels' reruns are bit-identical either way)."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs((1, 2, 641, 64), 4))
    one, lse1 = model_fwd(q, k, v)
    for s in (2, A._long_splits(1, 2, 641, 64)[0]):
        out, lse = model_fwd(q, k, v, s)
        assert float((out - one).abs().max()) < 1e-5
        assert float((lse - lse1).abs().max()) < 1e-5


# (b) the tensor maps

def _storage(t: torch.Tensor) -> torch.Tensor:
    """t's whole storage as a flat tensor of its dtype."""
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())


def _box(t: torch.Tensor, geo, c0: int, r0: int, h: int, b: int) -> torch.Tensor:
    """The box TMA fills at (c0, r0, h, b), read from t's storage through the
    geometry alone: elements outside dims come back 0."""
    (d, N, H, B), strides, (cols, rows) = geo
    es = t.element_size()
    sn, sh, sb = (s // es for s in strides)
    flat = _storage(t)
    c = torch.arange(c0, c0 + cols)[None, :]
    r = torch.arange(r0, r0 + rows)[:, None]
    inside = (c < d) & (r < N)
    idx = t.storage_offset() + torch.where(inside, c + r * sn + h * sh + b * sb, 0)
    return torch.where(inside, flat[idx], torch.zeros((), dtype=t.dtype))


def _fused_qkv(B, N, H, d):
    qkv = torch.arange(B * N * 3 * H * d, dtype=torch.float32).to(torch.bfloat16)
    return qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("case", ["contiguous", "fused QKV q", "fused QKV k", "fused QKV v",
                                  "d = 80, fused QKV v", "padded copy of d = 36",
                                  "d = 256, fused QKV k"])
def test_tensor_map_addresses_exactly_the_view(case):
    """dims (d, N, H, B) and the byte strides of N, H and B address each
    element of the view (``torch.as_strided`` on its storage), and every box
    the kernel loads, at the ragged edges too, holds the view's elements
    and zeros past N and d."""
    if case == "contiguous":
        t = torch.randn((2, 3, 70, 64)).to(torch.bfloat16)
    elif case.startswith("fused QKV"):
        t = _fused_qkv(2, 70, 3, 64)["qkv".index(case[-1])]
    elif case.startswith("d = 80"):
        t = _fused_qkv(2, 70, 3, 80)[2]
    elif case.startswith("padded"):
        t = A._pad_head_dim(torch.randn((2, 3, 70, 36)).to(torch.bfloat16))
        assert t.shape[-1] == 40
    else:
        t = _fused_qkv(1, 70, 2, 256)[1]
    B, H, N, d = t.shape
    rows = A._fwd_key_tile(d) if case.endswith(("k", "v")) else A._ROW_TILE
    geo = A._tma_geometry(t, rows)
    assert geo is not None
    dims, strides, box = geo
    assert dims == (d, N, H, B) and box == (64, rows)
    assert all(s % 16 == 0 for s in strides)
    es = t.element_size()
    view = torch.as_strided(_storage(t), (B, H, N, d),
                            (strides[2] // es, strides[1] // es, strides[0] // es, 1),
                            t.storage_offset())
    assert torch.equal(view, t)
    for b in range(B):
        for h in (0, H - 1):
            for r0 in (0, (N - 1) // rows * rows):
                for c0 in range(0, -(-d // 64) * 64, 64):
                    want = torch.zeros((rows, 64), dtype=t.dtype)
                    part = t[b, h, r0:r0 + rows, c0:c0 + 64]
                    want[:part.shape[0], :part.shape[1]] = part
                    assert torch.equal(_box(t, geo, c0, r0, h, b), want)


@pytest.mark.parametrize("case", ["d = 36: rows of 72 bytes", "data 2 bytes off 16",
                                  "N stride of 36 elements", "last axis strided"])
def test_tensor_map_refuses_what_tma_cannot_describe(case):
    """A byte stride that is not a multiple of 16 or data not 16-byte
    aligned has no tensor map; the wrapper's zero-padded contiguous copy has
    one, with the view's elements in its first d columns."""
    if case.startswith("d = 36"):
        t = torch.randn((2, 3, 50, 36)).to(torch.bfloat16)
    elif case.startswith("data"):
        t = torch.randn(2 * 3 * 50 * 64 + 1).to(torch.bfloat16)[1:].view(2, 3, 50, 64)
    elif case.startswith("N stride"):
        t = torch.randn((2, 3, 50, 36)).to(torch.bfloat16)[..., :32]
    else:
        t = torch.randn((2, 3, 64, 50)).to(torch.bfloat16).transpose(-1, -2)
    assert A._tma_geometry(t, 64) is None
    if t.stride(-1) == 1:
        copy = A._pad_head_dim(t)
        assert A._tma_geometry(copy, 64) is not None
        assert torch.equal(copy[..., :t.shape[-1]], t)
        assert not copy[..., t.shape[-1]:].any()

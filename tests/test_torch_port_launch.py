"""The flash wrappers' launch route, on the CPU: the launch key and the plan
block built once per key (``ops/attention.py``).

A CUDA call looks its plan up by its inputs' shapes, strides, dtypes, cards
and the low 4 bits of their addresses; the plan holds the int64 block the
kernels read (sizes, dtype, the scale's f32 bits, element strides, the
tensor maps' geometries) and the route (contiguous copies, a zero-padded
copy in d). Here the keys and plans of CPU tensors are held against what
the wrapper computed on every call before the cache (``_tma_geometries``,
the strides of each tensor, ``1 / sqrt(d)`` as ctypes passes a float). The
card's tests (``test_torch_port_cuda.py``) run the cached launches.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from deepfake_video_detection_tpu_torch.ops import attention as A


def _qkv(B, H, N, d, dtype=torch.bfloat16, offset=0, seed=0):
    """q, k, v as the views of one fused (B, N, 3, H, d) projection that
    ``multi_head_attention`` cuts, the buffer starting ``offset`` elements in."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(size=offset + B * N * 3 * H * d).astype(np.float32))
    qkv = flat.to(dtype)[offset:].view(B, N, 3, H, d)
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def _fwd_key(q, k, v):
    return A._fwd_key(q, k, v, [t.data_ptr() for t in (q, k, v)])


def _bwd_args(B, H, N, d, dtype=torch.bfloat16, seed=0):
    q, k, v = _qkv(B, H, N, d, dtype, seed=seed)
    out = A._heads_view(B, H, N, d, q).copy_(q)
    lse = torch.zeros((B, H, N))
    dout = torch.ones((B, N, H * d), dtype=dtype).view(B, N, H, d).transpose(1, 2)
    return q, k, v, out, lse, dout


def _bwd_key(q, k, v, out, lse, dout):
    return A._bwd_key(q, k, v, out, lse, dout, [t.data_ptr() for t in (q, k, v, out, dout)])


def _block_before_the_cache(ts, outs, rows):
    """The sizes, dtype, scale bits, strides and geometry that the wrapper
    handed over on every call before the launch cache."""
    B, H, N, d = ts[0].shape
    geos = A._tma_geometries(ts, rows) + [A._tma_geometry(o, r) for o, r in outs]
    scale = ctypes.c_float(1.0 / math.sqrt(d))
    bits = ctypes.c_uint32.from_buffer(scale).value
    return ([B, H, N, d, int(ts[0].dtype == torch.bfloat16), bits]
            + [s for t in ts + tuple(o for o, _ in outs) for s in t.stride()[:3]]
            + [x for g in geos for f in g for x in f])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_geometry_shares_a_key_and_a_plan(dtype):
    """Two calls on tensors of one geometry, or on views of one buffer at
    two aligned offsets, share a launch key, and their plans' blocks are
    equal: a call differs from another of its key only in its pointers."""
    a = _qkv(2, 3, 197, 64, dtype, seed=1)
    b = _qkv(2, 3, 197, 64, dtype, seed=2)
    c = _qkv(2, 3, 197, 64, dtype, offset=16 // a[0].element_size() * 4)
    assert _fwd_key(*a) == _fwd_key(*b) == _fwd_key(*c)
    blocks = [A._fwd_layout(*t).block.tolist() for t in (a, b, c)]
    assert blocks[0] == blocks[1] == blocks[2]
    assert len({t[0].data_ptr() for t in (a, b, c)}) == 3


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 128), (torch.float32, 32)])
def test_plan_block_is_what_each_call_computed_before(dtype, d):
    """The plan's block holds the sizes, dtype, the scale's f32 bits (as
    ctypes rounds ``1 / sqrt(d)``), every tensor's B/H/N strides and the
    tensor maps' geometries exactly as the wrapper computed them on every
    call before, forward and backward."""
    bf16 = dtype == torch.bfloat16
    q, k, v = _qkv(2, 3, 197, d, dtype)
    plan = A._fwd_layout(q, k, v)
    out = A._heads_view(2, 3, 197, d, q)
    rows = (A._ROW_TILE,) + (A._fwd_key_tile(d, bf16),) * 2
    assert plan.block.tolist() == _block_before_the_cache((q, k, v), [(out, A._ROW_TILE)], rows)
    assert not plan.padded and plan.copies is None
    assert (plan.out_size, plan.out_stride) == (out.shape, out.stride())
    assert plan.part_n == 2 * 3 * 197 * (d + 1)

    q, k, v, out, lse, dout = _bwd_args(2, 3, 197, d, dtype)
    plan = A._bwd_layout(q, k, v, out, lse, dout)
    grad = A._heads_view(2, 3, 197, d, q)
    rows = A._bwd_tile(d, bf16)
    assert plan.block.tolist() == _block_before_the_cache((q, k, v, out, dout),
                                                          [(grad, rows)] * 3, rows)
    assert plan.part_n == 3 * 2 * 3 * 197 * d


def test_other_strides_get_their_own_key_and_plan():
    """Contiguous q, k, v and the views of a fused projection, of one
    shape: their own keys, and blocks that differ in the strides and the
    tensor maps' byte strides."""
    fused = _qkv(2, 3, 197, 64)
    contiguous = tuple(t.contiguous() for t in fused)
    assert _fwd_key(*fused) != _fwd_key(*contiguous)
    a, b = (A._fwd_layout(*t).block.tolist() for t in (fused, contiguous))
    assert a[:6] == b[:6] and a != b


@pytest.mark.parametrize("offset,d", [(1, 64), (0, 36)])
def test_misaligned_or_odd_d_takes_the_padded_route_as_tma_geometries_decides(offset, d):
    """A view 2 bytes off 16-byte alignment, and d = 36 (not a multiple of
    8 bf16), get their own key and the padded route, exactly where
    ``_tma_geometries`` finds no tensor map; the plan then describes the
    zero-padded contiguous copies (d to a multiple of 8) and keeps the true
    d for the scale and the slice."""
    q, k, v = _qkv(2, 3, 77, d, offset=offset)
    aligned = _qkv(2, 3, 77, d)
    rows = (A._ROW_TILE, A._fwd_key_tile(d), A._fwd_key_tile(d))
    assert (_fwd_key(q, k, v) != _fwd_key(*aligned)) == bool(offset)
    plan = A._fwd_layout(q, k, v)
    assert plan.padded == (A._tma_geometries((q, k, v), rows) is None) is True
    copies = tuple(A._pad_head_dim(t) for t in (q, k, v))
    dp = copies[0].shape[-1]
    out = A._heads_view(2, 3, 77, dp, copies[0])
    want = _block_before_the_cache(copies, [(out, A._ROW_TILE)], rows)
    want[5] = ctypes.c_uint32.from_buffer(ctypes.c_float(1.0 / math.sqrt(d))).value
    assert plan.block.tolist() == want
    assert plan.d == d and plan.out_size[-1] == dp


def test_backward_key_tells_the_inputs_apart():
    """The backward's key holds every input's shape, strides, dtype and
    card and each one's alignment: dO's head-merge view and a contiguous dO
    get their own keys; a tensor whose last axis is strided goes as a
    contiguous copy (``copies``), the rest as they are."""
    q, k, v, out, lse, dout = _bwd_args(2, 3, 197, 64)
    key = _bwd_key(q, k, v, out, lse, dout)
    assert key == _bwd_key(*_bwd_args(2, 3, 197, 64, seed=3))
    assert key != _bwd_key(q, k, v, out, lse, dout.contiguous())
    strided = torch.zeros((2, 3, 197, 128), dtype=torch.bfloat16)[..., ::2]
    plan = A._bwd_layout(q, k, v, out, lse, strided)
    assert plan.copies == (False, False, False, False, True) and not plan.padded
    assert A._bwd_layout(q, k, v, out, lse, dout).copies is None
    assert not plan.lse_copy
    assert A._bwd_layout(q, k, v, out, lse.transpose(0, 1).contiguous().transpose(0, 1),
                         dout).lse_copy


def test_plans_are_bounded_and_cleared(monkeypatch):
    """At most ``_PLAN_CAP`` plans a direction (emptied when full), and
    ``_clear_launch_caches`` forgets them all; a CPU call builds none."""
    monkeypatch.setattr(A, "_FWD_PLANS", {})
    monkeypatch.setattr(A, "_BWD_PLANS", {})
    monkeypatch.setattr(A, "_PLAN_CAP", 3)
    q, k, v = _qkv(1, 2, 17, 64)
    for i in range(5):
        A._remember(A._FWD_PLANS, i, A._fwd_layout(q, k, v))
        assert len(A._FWD_PLANS) == i % 3 + 1
    A._remember(A._BWD_PLANS, 0, A._fwd_layout(q, k, v))
    A._clear_launch_caches()
    assert A._FWD_PLANS == {} and A._BWD_PLANS == {}
    A.flash_attention_fwd(q, k, v)
    A.flash_attention_bwd(*_bwd_args(1, 2, 17, 64))
    assert A._FWD_PLANS == {} and A._BWD_PLANS == {}

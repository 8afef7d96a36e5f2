"""Flash attention, forward (K2) and backward (K4), as one autograd Function.

Counterpart of ``deepfake_video_detection_tpu/ops/attention.py``. Forward:
``_flash_impl`` → ``_short_attn_kernel`` for n_pad ≤ 512, ``_attn_kernel``
above. Backward: ``_flash_bwd`` → ``_short_bwd_kernel`` for n_pad ≤ 512, the
two streaming passes ``_bwd_dq_kernel``/``_bwd_dkv_kernel`` above.

On CUDA tensors :func:`flash_attention_fwd` launches ``csrc/flash_fwd.cu``,
which streams key tiles with an online softmax, and
:func:`flash_attention_bwd` launches ``csrc/flash_bwd.cu``, a dQ pass and a
dK/dV pass (FlashAttention-2) that stream row tiles. Each kernel streams
over any N, so each covers both TPU regimes. Each source routes by dtype,
both routes on the tensor cores: bf16 as bf16 products with f32 sums, f32
as 3xTF32 (each f32 operand split into two tf32 terms, three products in
place of one, f32 sums: the error of a plain f32 product).

The bf16 kernels are built for Hopper (FlashAttention-3's shape): one
thread (of a producer warp in the forward, of the warpgroup in the
backward) loads a block's own tiles and rings of streamed tiles by TMA into
shared memory (128-byte swizzled, completing on mbarriers), and a
warpgroup takes every product as a ``wgmma``. The forward takes
S = QKᵀ and O += P·V, P from registers as two bf16 terms (hi + lo), the
next tile's S issued before the softmax of the last one finishes its P·V.
The backward's dQ pass takes S = QKᵀ, dP = dO·Vᵀ and dQ += dS·K, its dK/dV
pass Sᵀ = KQᵀ, dPᵀ = V·dOᵀ, dV += Pᵀ·dO and dK += dSᵀ·Q, P and dS from
registers rounded once to bf16. What bounds them on an H100: bytes at the
ViT shape (N = 197), the tile body's rate at the long clips' (N = 1025).
They read q, k, v (and O, dO) and the backward writes dq, dk, dv through
4-D tensor maps whose geometry :func:`_tma_geometry` computes from each
tensor's shape and strides, so the views of a fused QKV projection and dO's
head-merge view go in as they are; columns past d, up to a multiple of 64,
and rows past N come from TMA's zero fill. An input TMA cannot describe (a
byte stride not a multiple of 16, unaligned data) or with d not a multiple
of 8 goes to the kernel as a contiguous copy zero-padded to a multiple of 8
in d, with the scale of the true d, and the result is sliced back. The f32
kernels take rows of 16-byte multiples (d not a multiple of 4, a B/H/N
stride not a multiple of 4 elements, or unaligned data get the same copy).
On CPU tensors each wrapper takes its plain version, a dense f32
computation.

The split route (bf16 at N > 512, the regime of the TPU's streaming
kernels K3, K5 and K6). One block per (64-row tile, head) leaves most of
the card idle at the temporal transformer's few heads, so the streamed loop
is cut into S runs, each a block of its own writing f32 partials that a
last small kernel combines (forward: by their logsumexps) or sums (backward)
in a fixed order, so reruns are bit-identical. :func:`_long_splits` picks S
from the shape alone; S = 1 runs the unsplit kernels. The wrapper allocates
the partials.

:class:`FlashAttention` saves q, k, v, O and lse, as the JAX ``custom_vjp``
keeps them as residuals, and :func:`flash_attention` is differentiable on
both devices.

Layout is the JAX one, ``(B, H, N, d)``. The kernels take element strides
for B, H and N (the last axis must be contiguous), so the q/k/v views that
``nn.layers.multi_head_attention`` cuts from its fused QKV projection, and
the strided dO that autograd hands back through the head merge, go in
without a copy. O, dQ, dK and dV come back as ``(B, H, N, d)`` views of
``(B, N, H, d)`` buffers.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
import threading
from typing import Tuple

import torch

from deepfake_video_detection_tpu_torch.ops import _build

_FWD_SOURCE = "flash_fwd.cu"
_BWD_SOURCE = "flash_bwd.cu"
_MAX_HEAD_DIM = 256
# the JAX package's n_pad bound of its short-N kernels (K2, K4); above it
# (N > 512) it launches the streaming ones (K3; K5 and K6)
_SHORT_MAX = 512
_DTYPES = (torch.bfloat16, torch.float32)
_count_lock = threading.Lock()

# The split policy, for the bf16 kernels' tiles: 64 query (key) rows per
# block; the forward streams key tiles of 64 (32 above d = 128), the
# backward tiles of 64 rows (_bwd_tile), and runs d / 64 blocks a row tile
# above d = 64. The card runs _SMS times the blocks an SM holds at once (a
# wave): 3 of the split forward (160 threads of 122 registers at d = 64,
# ptxas), _BWD_BLOCKS_PER_SM of the backward's dK/dV pass, fewer where the
# shared memory of a larger d allows fewer. S minimises waves x
# tiles per split (the streamed tiles the slowest SM walks) + _SPLIT_COST
# x S (a split's partials, written once and read again by the combine or
# reduce kernel), the smallest S on a tie, over the counts that keep each
# split at least _SPLIT_MIN_TILES tiles (a 2-stage ring overlaps one
# tile's copy with the other's products) and the partials at most
# _SPLIT_SCRATCH_CAP bytes. Tuned on an H100 against the split sweep of
# `chip_smoke.py` (PERF.md): a fixed fill target (the smallest S that fills
# one wave) put the N = 4097 backward into 2 waves of long blocks (0.357
# against 0.304 ms at its best S), and waves x tiles alone split the short
# calls into more blocks than their partials repay. The Hopper forward kept
# these constants: at the long-clip evaluation shape the policy's S is the
# sweep's best, elsewhere within 11 % of it (PERF.md). So did the Hopper
# backward: its sweep's best S >= 2 at (2, 4, 513, 64), (2, 12, 640, 64) and
# (1, 4, 4097, 64), 13 % above it at (1, 4, 641, 64) (S = 4 against 3); S = 1
# itself read faster than any split wherever the unsplit grid nearly fills
# the card ((2, 12, 640, 64), (1, 4, 4097, 64); PERF.md).
_SMS = 132                          # streaming multiprocessors of an H100
_ROW_TILE = 64
_SMEM_PER_SM = 227 * 1024
_BLOCKS_PER_SM = 3
_BWD_BLOCKS_PER_SM = 2
_SPLIT_COST = 0.5
_SPLIT_MIN_TILES = 2
_SPLIT_SCRATCH_CAP = 256 << 20
# the bf16 kernels' TMA box: 64 columns, one 128-byte swizzled row
_TMA_BOX_COLS = 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch forward, in f32: returns ``(out, lse)``, out in
    q's dtype ``(B, H, N, d)``, lse f32 ``(B, H, N)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.to(torch.float32) * scale,
                     k.to(torch.float32).transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.to(torch.float32)) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor,
                              dout: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch backward, in f32, from the forward's ``out`` and
    ``lse``: ``P = exp(S − lse)``, ``D = rowsum(dO ⊙ O)``,
    ``dS = P ⊙ (dO Vᵀ − D)``; returns ``(dq, dk, dv)`` in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    do = dout.to(torch.float32)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse.to(torch.float32)[..., None])
    dcap = (do * out.to(torch.float32)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - dcap)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fwd_library() -> ctypes.CDLL:
    lib = _build.load(_FWD_SOURCE)
    fn = lib.dfdt_flash_fwd
    if fn.argtypes is None:     # once per loaded library
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load(_BWD_SOURCE)
    fn = lib.dfdt_flash_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fwd_key_tile(d: int) -> int:
    """Keys per K/V tile of the bf16 forward at head dim d: 64, and 32
    above d = 128 (the kernel pads d to DP, a multiple of 64)."""
    return 64 if _cdiv(d, 64) * 64 <= 128 else 32


def _fwd_smem(d: int) -> int:
    """Dynamic shared memory of a bf16 forward block at head dim d: the Q
    tile and two-stage K and V rings at d padded to a multiple of 64, nine
    8-byte barriers and 1 KB for aligning the base to 1024 bytes."""
    return 2 * _cdiv(d, 64) * 64 * (_ROW_TILE + 4 * _fwd_key_tile(d)) + 9 * 8 + 1024


def _bwd_tile(d: int) -> int:
    """Rows per streamed tile of the bf16 backward at head dim d (K/V
    tiles in the dQ pass, Q/dO tiles in the dK/dV pass): 64 at every d, as
    many as a block owns, so one tensor map a tensor serves both passes."""
    return _ROW_TILE


def _bwd_smem(d: int) -> Tuple[int, int]:
    """Dynamic shared memory of a bf16 backward block at head dim d, ``(dQ
    pass, dK/dV pass)``: 64-row bf16 tiles at d padded to a multiple of 64
    (Q, dO, O and a K/V ring; K, V and a Q/dO ring; 3 stages, 2 above
    d = 128), the f32 D rows (dQ) or each stage's lse and D rows (dK/dV),
    the 8-byte barriers and 1 KB for aligning the base to 1024 bytes."""
    dp = _cdiv(d, 64) * 64
    stages = 3 if dp <= 128 else 2
    tile = _ROW_TILE * dp * 2
    ring = stages * 2 * _bwd_tile(d) * dp * 2
    dq = 3 * tile + ring + 4 * _ROW_TILE + 8 * (2 + 2 * stages) + 1024
    dkv = 2 * tile + ring + 4 * stages * 2 * _bwd_tile(d) + 8 * (1 + 2 * stages) + 1024
    return dq, dkv


def _split_count(blocks: int, tiles: int, per_sm: int, split_bytes: int,
                 least: int = 1) -> int:
    slots = _SMS * per_sm
    most = max(1, min(tiles // _SPLIT_MIN_TILES, _SPLIT_SCRATCH_CAP // split_bytes))
    return min(range(min(least, most), most + 1),
               key=lambda s: _cdiv(blocks * s, slots) * _cdiv(tiles, s) + _SPLIT_COST * s)


@functools.lru_cache(maxsize=1024)
def _long_splits(B: int, H: int, N: int, d: int, bf16: bool = True
                 ) -> Tuple[int, int]:
    """``(s_fwd, s_bwd)``: how many runs the forward cuts its key tiles
    into, and the backward its streamed tiles (keys in the dQ pass, queries
    in the dK/dV pass), for a ``(B, H, N, d)`` call. 1 for f32 and at
    N ≤ 512 (the unsplit kernels); a pure function of the shape, so a shape
    always gets the same S."""
    if not bf16 or N <= _SHORT_MAX:
        return 1, 1
    dp = _cdiv(d, 8) * 8                    # the head dim the kernels see
    blocks = B * H * _cdiv(N, _ROW_TILE)
    s_fwd = _split_count(blocks, _cdiv(N, _fwd_key_tile(d)),
                         min(_BLOCKS_PER_SM, _SMEM_PER_SM // _fwd_smem(d)),
                         4 * B * H * N * (dp + 1))
    # the backward runs a block a 64-column block of d, and splits every
    # call at N > 512 that its scratch cap allows (S >= 2: the K5/K6 regime's
    # route), though its sweep reads S = 1 faster where the unsplit grid
    # nearly fills the card (ROADMAP)
    s_bwd = _split_count(blocks * _cdiv(d, 64), _cdiv(N, _bwd_tile(d)),
                         min(_BWD_BLOCKS_PER_SM, _SMEM_PER_SM // max(_bwd_smem(d))),
                         3 * 4 * B * H * N * dp, least=2)
    return s_fwd, s_bwd


def _partials(n: int, splits: int, like: torch.Tensor):
    """The split kernels' f32 partials, ``splits * n`` elements, and their
    address; none (a null address) when ``splits`` is 1."""
    if splits == 1:
        return None, None
    buf = torch.empty(splits * n, dtype=torch.float32, device=like.device)
    return buf, buf.data_ptr()


def _check_inputs(*ts: torch.Tensor) -> None:
    q = ts[0]
    shape, dtype, device = q.shape, q.dtype, q.device
    if len(shape) != 4 or any(t.shape != shape for t in ts[1:]):
        raise ValueError(f"flash attention takes tensors of one (B, H, N, d) "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts[1:]):
        raise ValueError(f"flash attention takes bf16 or f32 tensors of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if any(t.device != device for t in ts[1:]):
        raise ValueError("flash attention: inputs on different devices")


def _check_kernel_shape(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    B, H, N, d = q.shape
    if not 1 <= d <= _MAX_HEAD_DIM or N < 1 or B * H < 1:
        raise ValueError(f"flash attention kernel takes 1 <= d <= 256 and "
                         f"N >= 1, got {tuple(q.shape)}")


def _heads_view(B: int, H: int, N: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``(B, H, N, d)`` view of a ``(B, N, H, d)`` buffer."""
    return torch.empty((B, N, H, d), dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


def _row_elems(t: torch.Tensor) -> int:
    """Elements in 16 bytes of ``t``'s dtype: 8 bf16, 4 f32."""
    return 16 // t.element_size()


def _tc_aligned(*ts: torch.Tensor) -> bool:
    """Whether the kernels take these tensors as they are: d and the B/H/N
    strides multiples of 16 bytes' worth of elements (8 bf16, 4 f32), data
    16-byte aligned."""
    return all(t.shape[-1] % _row_elems(t) == 0 and t.data_ptr() % 16 == 0
               and all(st % _row_elems(t) == 0 for st in t.stride()[:3]) for t in ts)


def _pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t``, its last axis zero-padded to a multiple
    of 16 bytes' worth of elements."""
    return torch.nn.functional.pad(t, (0, -t.shape[-1] % _row_elems(t))).contiguous()


def _tma_geometry(t: torch.Tensor, rows: int):
    """The 4-D tensor map through which a bf16 kernel reads or writes ``t``, a
    ``(B, H, N, d)`` tensor: ``(dims, strides, box)`` with dims ``(d, N, H,
    B)`` innermost first, the byte strides of N, H and B, and the box one
    TMA load fills, ``(64, rows)`` (64 columns: one 128-byte swizzled row).
    None where TMA cannot describe ``t``: the last axis strided, data not
    16-byte aligned, or a byte stride that is not a positive multiple of 16
    below 2**40."""
    B, H, N, d = t.shape
    sb, sh, sn, sd = t.stride()
    es = t.element_size()
    strides = (sn * es, sh * es, sb * es)
    if sd != 1 or t.data_ptr() % 16 \
            or any(st <= 0 or st % 16 or st >= 1 << 40 for st in strides):
        return None
    return (d, N, H, B), strides, (_TMA_BOX_COLS, rows)


def _strides(*ts: torch.Tensor) -> array.array:
    """The B/H/N strides of ``ts`` as a C array of int64 (its address:
    ``.buffer_info()[0]``; cheaper to build than a ctypes array)."""
    return array.array("q", [s for t in ts for s in t.stride()[:3]])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q, k, v``: ``(B, H, N, d)``, bf16 or f32, d ≤ 256, any N ≥ 1.
    Returns ``(out, lse)``: out ``(B, H, N, d)`` in q's dtype, lse f32
    ``(B, H, N)``, the logsumexp of the scaled scores of each query row.
    Not differentiable through the kernel: use :func:`flash_attention`."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check_kernel_shape(q)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs the last axis of q, "
                         "k, v contiguous")
    B, H, N, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        rows = (_ROW_TILE,) + (_fwd_key_tile(d),) * 2   # the box rows of Q, K, V
        geos = [_tma_geometry(t, r) for t, r in zip((q, k, v), rows)]
        padded = d % 8 != 0 or None in geos
    else:
        padded = not _tc_aligned(q, k, v)
    if padded:
        q, k, v = (_pad_head_dim(t) for t in (q, k, v))
        if bf16:    # a contiguous copy always has a tensor map
            geos = [_tma_geometry(t, r) for t, r in zip((q, k, v), rows)]
    dp = q.shape[-1]
    splits = _long_splits(B, H, N, d, bf16)[0]
    out = _heads_view(B, H, N, dp, q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    # partial O (B*H, S, N, dp) and lse (B*H, S, N) of the split route
    part, part_ptr = _partials(B * H * N * (dp + 1), splits, q)
    strides = _strides(q, k, v, out)
    tma = None
    if bf16:        # the tensor maps of q, k, v and out
        geos.append(_tma_geometry(out, _ROW_TILE))
        tma = array.array("q", [x for g in geos for f in g for x in f])
    lib = _fwd_library()
    status = lib.dfdt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, N, dp, int(bf16), strides.buffer_info()[0],
        scale, splits, part_ptr, torch.cuda.current_stream(q.device).cuda_stream,
        None if tma is None else tma.buffer_info()[0])
    _build.check(lib, status, "flash_attention_fwd")
    with _count_lock:
        flash_attention_fwd.launches += 1
        flash_attention_fwd.launches_long += int(N > _SHORT_MAX)
        flash_attention_fwd.launches_split += int(splits > 1)
        flash_attention_fwd.launches_f32 += int(not bf16)
        by = flash_attention_fwd.launches_by_device
        by[q.device.index] = by.get(q.device.index, 0) + 1
    return (out[..., :d] if padded else out), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of ``out = flash_attention(q, k, v)`` for
    the cotangent ``dout``, from the forward's ``out`` and ``lse``. All of
    q, k, v, out, dout ``(B, H, N, d)`` in one dtype; lse f32 ``(B, H, N)``.
    A tensor whose last axis is not contiguous is copied; any other strides
    that a tensor map (bf16) or the f32 kernels describe go to the kernel as
    they are."""
    _check_inputs(q, k, v, out, dout)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash attention backward takes lse f32 "
                         f"{tuple(q.shape[:3])} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout)
    _check_kernel_shape(q)
    q, k, v, out, dout = (t if t.stride(-1) == 1 else t.contiguous()
                          for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    B, H, N, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bf16 = q.dtype == torch.bfloat16
    ins = (q, k, v, out, dout)
    # every tile of the backward, own or streamed, is 64 rows (_bwd_tile):
    # one tensor map a tensor
    rows = _bwd_tile(d)
    if bf16:
        geos = [_tma_geometry(t, rows) for t in ins]
        padded = d % 8 != 0 or None in geos
    else:
        padded = not _tc_aligned(*ins)
    if padded:
        q, k, v, out, dout = ins = tuple(_pad_head_dim(t) for t in ins)
        if bf16:    # a contiguous copy always has a tensor map
            geos = [_tma_geometry(t, rows) for t in ins]
    dp = q.shape[-1]
    splits = _long_splits(B, H, N, d, bf16)[1]
    dq, dk, dv = (_heads_view(B, H, N, dp, q) for _ in range(3))
    dcap = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    # partial dQ, dK and dV, each (B*H, S, N, dp), of the split route
    part, part_ptr = _partials(3 * B * H * N * dp, splits, q)
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    tma = None
    if bf16:        # the tensor maps of q, k, v, out, dout, dq, dk and dv
        geos += [_tma_geometry(t, rows) for t in (dq, dk, dv)]
        tma = array.array("q", [x for g in geos for f in g for x in f])
    lib = _bwd_library()
    status = lib.dfdt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, N, dp, int(bf16),
        strides.buffer_info()[0], scale, splits, part_ptr,
        torch.cuda.current_stream(q.device).cuda_stream,
        None if tma is None else tma.buffer_info()[0])
    _build.check(lib, status, "flash_attention_bwd")
    with _count_lock:
        flash_attention_bwd.launches += 1
        flash_attention_bwd.launches_long += int(N > _SHORT_MAX)
        flash_attention_bwd.launches_split += int(splits > 1)
        flash_attention_bwd.launches_f32 += int(not bf16)
        by = flash_attention_bwd.launches_by_device
        by[q.device.index] = by.get(q.device.index, 0) + 1
    if padded:
        return dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


# kernel launches since the last reset (plain integers, set to 0 by callers);
# one backward call launches its dQ and dK/dV passes and counts once.
# ``launches_long`` counts the launches at N > 512, the regime of the JAX
# package's streaming kernels (K3 forward, K5/K6 backward);
# ``launches_split`` those that took the split route (S > 1, with its
# combine or reduce kernel); ``launches_f32`` those of f32 inputs (the
# 3xTF32 kernels); ``launches`` counts them all, ``launches_by_device`` by
# card index (a dict, emptied by callers).
for _f in (flash_attention_fwd, flash_attention_bwd):
    _f.launches = _f.launches_long = _f.launches_split = _f.launches_f32 = 0
    _f.launches_by_device = {}


class FlashAttention(torch.autograd.Function):
    """``softmax(QKᵀ/√d)·V`` with the flash backward: the forward saves
    q, k, v, O and lse (the JAX residuals), the backward recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, dout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """``softmax(QKᵀ/√d)·V`` for ``(B, H, N, d)`` inputs, in q's dtype;
    differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v)

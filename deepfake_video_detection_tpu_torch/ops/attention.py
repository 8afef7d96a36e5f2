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

Every kernel is built for Hopper (FlashAttention-3's shape): one thread
(of a producer warp in the bf16 forward, of the warpgroup elsewhere) loads
a block's own tiles and rings of streamed tiles by TMA into shared memory
(128-byte swizzled, completing on mbarriers), and a warpgroup takes every
product as a ``wgmma``. The bf16 forward takes S = QKᵀ and O += P·V, P
from registers as two bf16 terms (hi + lo), the next tile's S issued
before the softmax of the last one finishes its P·V. The backward's dQ
pass takes S = QKᵀ, dP = dO·Vᵀ and dQ += dS·K, its dK/dV pass Sᵀ = KQᵀ,
dPᵀ = V·dOᵀ, dV += Pᵀ·dO and dK += dSᵀ·Q, P and dS from registers rounded
once to bf16. The f32 kernels take the same products in 3xTF32 on tf32
``wgmma``, which reads shared memory K-major only: the own side's tiles
(Q in the forward) are A operands split in registers, each streamed tile
is split in shared memory (big in place, small beside it), and where a
product's B operand lies MN-major its columns are written transposed (V in
O += P·V; K in dQ += dS·K, Q and dO in the dK/dV pass). What bounds them
on an H100: bytes at the ViT shape (N = 197), the tile body's rate at the
long clips' (N = 1025). They read q, k, v (and O, dO) and write O (and dq,
dk, dv) through 4-D tensor maps whose geometry :func:`_tma_geometry`
computes from each tensor's shape and strides, so the views of a fused QKV
projection and dO's head-merge view go in as they are; columns past d, up
to a whole 128-byte row, and rows past N come from TMA's zero fill. An
input TMA cannot describe (a byte stride not a multiple of 16, unaligned
data) or with d not a multiple of 16 bytes' worth (8 bf16, 4 f32) goes to
the kernel as a contiguous copy zero-padded to that multiple in d, with
the scale of the true d, and the result is sliced back
(:func:`_tma_geometries`). On CPU tensors each wrapper takes its plain
version, a dense f32 computation.

The launch route. What a call computes from its inputs' shapes, strides,
dtypes, card and alignment (the checks, the route, the tensor maps'
geometries, the element strides) it looks up by those: a plan
(:class:`_Plan`) built on the first call of its key. A call then allocates
its outputs and hands the library two int64 blocks by address, the plan's
and its own (pointers, stream, split count). The library encodes a tensor
map once per geometry, dtype and card and gives a cached copy each call's
address (``cuTensorMapReplaceAddress``, ``csrc/tma_map.cuh``), and sets a
kernel's shared-memory attribute once per card.

The split route (bf16 at N > 512, the regime of the TPU's streaming
kernels K3, K5 and K6). One block per (64-row tile, head) leaves most of
the card idle at the temporal transformer's few heads, so the streamed loop
is cut into S runs, each a block of its own writing f32 partials that a
last small kernel combines (forward: by their logsumexps) or sums (backward)
in a fixed order, so reruns are bit-identical. :func:`_long_splits` picks S
from the shape alone; S = 1 runs the unsplit kernels (the backward's S is 1
where its unsplit grid already fills the card). The wrapper allocates the
partials.

:class:`FlashAttention` saves q, k, v, O and lse, as the JAX ``custom_vjp``
keeps them as residuals, and :func:`flash_attention` is differentiable on
both devices.

Layout is the JAX one, ``(B, H, N, d)``. The kernels take element strides
for B, H and N (the last axis must be contiguous), so the q/k/v views that
``nn.layers.multi_head_attention`` cuts from its fused QKV projection, and
the strided dO that autograd hands back through the head merge, go in
without a copy. O, dQ, dK and dV come back as ``(B, H, N, d)`` views of
``(B, N, H, d)`` buffers.

While something records (``utils/profiling.py``), each call of
:func:`flash_attention_fwd` and :func:`flash_attention_bwd` is a span,
``ops.flash_fwd`` or ``ops.flash_bwd``, with q's shape and dtype: the
wrapper's host time, the launch included.
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
from deepfake_video_detection_tpu_torch.utils.profiling import annotate

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
# shared memory of a larger d allows fewer. Either direction's S keeps each
# split at least _SPLIT_MIN_TILES tiles (a 2-stage ring overlaps one tile's
# copy with the other's products) and its partials at most
# _SPLIT_SCRATCH_CAP bytes; the smallest S on a tie.
# The forward's S minimises waves x tiles per split (the streamed tiles the
# slowest SM walks) + _SPLIT_COST x S (a split's partials, written once and
# read again by the combine kernel). Tuned on an H100 against the split
# sweep of `chip_smoke.py` (PERF.md): a fixed fill target (the smallest S
# that fills one wave) put long calls into 2 waves of long blocks, and waves
# x tiles alone split the short calls into more blocks than their partials
# repay. The Hopper forward kept these constants: at the long-clip
# evaluation shape its S is the sweep's best, elsewhere within 11 % of it.
# The backward's S minimises its modelled device time (_bwd_us): the tiles a
# split walks, a block alone on its SM or sharing it, and for S > 1 the
# three f32 partial planes (dQ, dK, dV) written and read again by the
# reduce kernel, and a fixed term. Its constants are a least-squares fit
# (relative error) to the bf16 backward's device time at every S of 12
# long-N shapes on an H100 80GB HBM3 at 700 W (`tools/flash_bwd_check.py
# --sweep`, PERF.md): within 7 % RMS, its S within 6 % of the sweep's best
# but at (1, 4, 2049, 64), 12 %. S = 1 where the unsplit grid already fills
# the card ((2, 12, 640, 64), (1, 4, 4097, 64)): a split adds waves and
# planes there.
_SMS = 132                          # streaming multiprocessors of an H100
_ROW_TILE = 64
_SMEM_PER_SM = 227 * 1024
_BLOCKS_PER_SM = 3
_BWD_BLOCKS_PER_SM = 2
_SPLIT_COST = 0.5
_SPLIT_MIN_TILES = 2
_SPLIT_SCRATCH_CAP = 256 << 20
_BWD_TILE_US = 0.937        # a streamed tile of both passes a 64-column block, alone on an SM
_BWD_SHARED_SM = 1.91       # blocks sharing an SM: each takes this times as long
_BWD_SPLIT_US = -4.21       # the split route's fixed term against the unsplit, reduce included
                            # (fitted, negative: split blocks end sooner than their tiles say)
_BWD_PLANE_BYTES_US = 1.171 / 3.35e6   # µs a byte of the partial planes, written or read
# the TMA box of a tensor map: one 128-byte swizzled row (64 bf16 or 32 f32
# columns)
_TMA_ROW_BYTES = 128


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


def _library(source: str, entry: str) -> ctypes.CDLL:
    """The loaded library of ``source``, its entry ``entry`` taking the
    call's and the plan's int64 blocks by address."""
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:     # once per loaded library
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dfdt_clear_launch_cache.argtypes = []
        lib.dfdt_clear_launch_cache.restype = None
    return lib


def _fwd_library() -> ctypes.CDLL:
    return _library(_FWD_SOURCE, "dfdt_flash_fwd")


def _bwd_library() -> ctypes.CDLL:
    return _library(_BWD_SOURCE, "dfdt_flash_bwd")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fwd_key_tile(d: int, bf16: bool = True) -> int:
    """Keys per K/V tile of the forward at head dim d, and the rows of the
    K and V tensor maps' boxes: bf16 64, and 32 above d = 128 (the kernel
    pads d to DP, a multiple of 64); f32 32 (one 128-byte row of the
    transposed V tile)."""
    return 64 if bf16 and _cdiv(d, 64) * 64 <= 128 else 32


def _fwd_smem(d: int, bf16: bool = True) -> int:
    """Dynamic shared memory of a forward block at head dim d, with 1 KB
    for aligning the base to 1024 bytes. bf16: the Q tile and two-stage K
    and V rings at d padded to a multiple of 64 and nine 8-byte barriers.
    f32 (``flash_fwd.cu``'s ``TfFwd``): the 64-row Q tile at the padded head
    dim, a ring of K/V tiles (2 stages up to d = 128, else 1), K's small
    term, V's tile transposed as two terms (a 128-byte row for each of the
    head dim's columns) and 1 + stages barriers."""
    if not bf16:
        dp = _f32_dp(d)
        bn = _fwd_key_tile(d, False)
        stages = 2 if dp <= 128 else 1
        return _ROW_TILE * dp * 4 + (2 * stages + 1) * bn * dp * 4 + 2 * dp * 128 \
            + 8 * (1 + stages) + 1024
    return 2 * _cdiv(d, 64) * 64 * (_ROW_TILE + 4 * _fwd_key_tile(d)) + 9 * 8 + 1024


def _bwd_tile(d: int, bf16: bool = True) -> int:
    """Rows per streamed tile of the backward at head dim d (K/V tiles in
    the dQ pass, Q/dO tiles in the dK/dV pass), and the rows of every box of
    its tensor maps, so one map a tensor serves both passes: bf16 64 at
    every d, as many as a block owns; f32 32, 16 above d = 128 (a block's
    own 64 rows load as several boxes)."""
    if bf16:
        return _ROW_TILE
    return 32 if d <= 128 else 16


def _f32_dp(d: int) -> int:
    """The padded head dim of the f32 kernels (forward and backward): 32,
    64, 128 or 256."""
    return next(dp for dp in (32, 64, 128, 256) if d <= dp)


def _bwd_smem(d: int, bf16: bool = True) -> Tuple[int, int]:
    """Dynamic shared memory of a backward block at head dim d, ``(dQ
    pass, dK/dV pass)``, with 1 KB for aligning the base to 1024 bytes and
    the 8-byte barriers. bf16: 64-row bf16 tiles at d padded to a multiple
    of 64 (Q, dO, O and a K/V ring; K, V and a Q/dO ring; 3 stages, 2 above
    d = 128), the f32 D rows (dQ) or each stage's lse and D rows (dK/dV).
    f32 (``flash_bwd.cu``'s ``TfHopper``): the own 64-row f32 tiles at the
    padded head dim (Q and dO; K and V), a ring of raw streamed tiles (2
    stages in the dQ pass up to d = 128, else 1), their small terms, the
    transposed big and small tiles of the block's output columns (K; Q and
    dO), and D of the block's rows (dQ) or two tiles' lse and D rows
    (dK/dV)."""
    if not bf16:
        dp = _f32_dp(d)
        bn, oc = _bwd_tile(d, False), min(dp, 64)
        own, tile, tt = _ROW_TILE * dp * 4, bn * dp * 4, oc * 128
        st_dq, st_dkv = (2 if dp <= 128 else 1), 1
        dq = 2 * own + st_dq * 2 * tile + 2 * tile + 2 * tt + 4 * _ROW_TILE \
            + 8 * (1 + 2 * st_dq) + 1024
        dkv = 2 * own + st_dkv * 2 * tile + 2 * tile + 4 * tt + 2 * 2 * bn * 4 \
            + 8 * (1 + 2 * st_dkv) + 1024
        return dq, dkv
    dp = _cdiv(d, 64) * 64
    stages = 3 if dp <= 128 else 2
    tile = _ROW_TILE * dp * 2
    ring = stages * 2 * _bwd_tile(d) * dp * 2
    dq = 3 * tile + ring + 4 * _ROW_TILE + 8 * (2 + 2 * stages) + 1024
    dkv = 2 * tile + ring + 4 * stages * 2 * _bwd_tile(d) + 8 * (1 + 2 * stages) + 1024
    return dq, dkv


def _most_splits(tiles: int, split_bytes: int) -> int:
    return max(1, min(tiles // _SPLIT_MIN_TILES, _SPLIT_SCRATCH_CAP // split_bytes))


def _split_count(blocks: int, tiles: int, per_sm: int, split_bytes: int) -> int:
    slots = _SMS * per_sm
    return min(range(1, _most_splits(tiles, split_bytes) + 1),
               key=lambda s: _cdiv(blocks * s, slots) * _cdiv(tiles, s) + _SPLIT_COST * s)


def _bwd_us(B: int, H: int, N: int, d: int, splits: int) -> float:
    """The bf16 backward's modelled device µs at ``splits`` (both passes and,
    for S > 1, the reduce), less a term common to every S."""
    col_blocks = _cdiv(d, 64)
    blocks = B * H * _cdiv(N, _ROW_TILE) * col_blocks * splits
    resident = min(_BWD_BLOCKS_PER_SM, _SMEM_PER_SM // max(_bwd_smem(d)))
    per_sm = _cdiv(blocks, _SMS)
    load = 1.0 if per_sm == 1 else (
        per_sm if resident == 1 else _BWD_SHARED_SM * _cdiv(per_sm, resident))
    us = _BWD_TILE_US * col_blocks * _cdiv(_cdiv(N, _bwd_tile(d)), splits) * load
    if splits == 1:
        return us
    planes = 3 * 4 * B * H * N * _cdiv(d, 8) * 8 * splits     # f32 dQ, dK, dV partials
    return us + _BWD_SPLIT_US + 2 * planes * _BWD_PLANE_BYTES_US


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
    most = _most_splits(_cdiv(N, _bwd_tile(d)), 3 * 4 * B * H * N * dp)
    s_bwd = min(range(1, most + 1), key=lambda s: _bwd_us(B, H, N, d, s))
    return s_fwd, s_bwd


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


def _pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t``, its last axis zero-padded to a multiple
    of 16 bytes' worth of elements."""
    return torch.nn.functional.pad(t, (0, -t.shape[-1] % _row_elems(t))).contiguous()


def _tma_geometry(t: torch.Tensor, rows: int):
    """The 4-D tensor map through which a kernel reads or writes ``t``, a
    ``(B, H, N, d)`` bf16 or f32 tensor: ``(dims, strides, box)`` with dims
    ``(d, N, H, B)`` innermost first, the byte strides of N, H and B, and
    the box one TMA load fills, ``(cols, rows)`` with cols one 128-byte
    swizzled row (64 bf16, 32 f32).
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
    return (d, N, H, B), strides, (_TMA_ROW_BYTES // es, rows)


def _tma_geometries(ts, rows):
    """The tensor maps' geometries of ``ts`` (boxes of ``rows`` rows, one
    count or one a tensor), or None where a kernel cannot take the tensors
    as they are: d not a multiple of 16 bytes' worth of elements (8 bf16,
    4 f32), or a tensor that TMA cannot describe. The wrapper then hands
    over zero-padded contiguous copies, which always have tensor maps."""
    rows = rows if isinstance(rows, tuple) else (rows,) * len(ts)
    geos = [_tma_geometry(t, r) for t, r in zip(ts, rows)]
    if ts[0].shape[-1] % _row_elems(ts[0]) or None in geos:
        return None
    return geos


class _Plan:
    """What every call of one launch key shares, built on the key's first
    call: the library entry, the int64 plan block the kernels read (sizes,
    dtype, the scale's f32 bits, the element strides and tensor maps'
    geometries of ``tensors``, the inputs as the kernels see them and then
    an output a map, see ``dfdt_flash_fwd``/``dfdt_flash_bwd``) and its
    address, the route (``copies``: which inputs go as contiguous copies;
    ``padded``: zero-padded copies in d), the outputs' layout and the split
    route's partials a split."""

    __slots__ = ("fn", "lib", "block", "addr", "B", "H", "N", "d", "bf16", "long", "copies",
                 "lse_copy", "padded", "out_size", "out_stride", "part_n")

    def __init__(self, lib, fn, tensors, geos, d, copies, padded, part_n):
        B, H, N, dp = tensors[0].shape
        self.lib, self.fn = lib, fn
        self.B, self.H, self.N, self.d = B, H, N, d
        self.bf16 = tensors[0].dtype == torch.bfloat16
        self.long = int(N > _SHORT_MAX)
        self.copies, self.padded, self.part_n = copies, padded, part_n
        self.lse_copy = False
        self.out_size, self.out_stride = tensors[-1].shape, tensors[-1].stride()
        self.block = array.array(
            "q", [B, H, N, dp, int(self.bf16), _f32_bits(1.0 / math.sqrt(d))]
            + [s for t in tensors for s in t.stride()[:3]]
            + [x for g in geos for f in g for x in f])
        self.addr = self.block.buffer_info()[0]


# launch keys -> _Plan, at most _PLAN_CAP of each (emptied when full): a
# key is the inputs' shapes, strides, dtypes, cards and the low 4 bits of
# their addresses, everything the checks and _tma_geometries decide from
_FWD_PLANS: dict = {}
_BWD_PLANS: dict = {}
_PLAN_CAP = 1024


def _f32_bits(x: float) -> int:
    """The bits of ``x`` rounded to f32, as ctypes passes a float."""
    return int.from_bytes(array.array("f", [x]).tobytes(), "little")


def _remember(plans: dict, key, plan: _Plan) -> _Plan:
    if len(plans) >= _PLAN_CAP:
        plans.clear()
    plans[key] = plan
    return plan


def _fwd_key(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ptrs) -> tuple:
    """A forward call's launch key: its inputs' shapes, strides, dtypes and
    cards, and the low 4 bits of their addresses ``ptrs``."""
    return (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(), q.dtype, k.dtype,
            v.dtype, q.get_device(), k.get_device(), v.get_device(),
            (ptrs[0] | ptrs[1] | ptrs[2]) & 15)


def _bwd_key(q, k, v, out, lse, dout, ptrs) -> tuple:
    """A backward call's launch key, as :func:`_fwd_key` (lse's address is
    not in it: the kernels read lse as plain f32 rows)."""
    return (q.shape, k.shape, v.shape, out.shape, dout.shape, lse.shape, q.stride(), k.stride(),
            v.stride(), out.stride(), dout.stride(), lse.stride(), q.dtype, k.dtype, v.dtype,
            out.dtype, dout.dtype, lse.dtype, q.get_device(), k.get_device(), v.get_device(),
            out.get_device(), dout.get_device(), lse.get_device(), tuple(p & 15 for p in ptrs))


def _fwd_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lib=None) -> _Plan:
    """The route and plan block of a forward call on ``q, k, v`` (their
    geometry: d, strides, alignment), launching through ``lib``."""
    B, H, N, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    rows = (_ROW_TILE,) + (_fwd_key_tile(d, bf16),) * 2   # the box rows of Q, K, V
    geos = _tma_geometries((q, k, v), rows)
    padded = geos is None
    if padded:
        q, k, v = (_pad_head_dim(t) for t in (q, k, v))
        geos = _tma_geometries((q, k, v), rows)
    dp = q.shape[-1]
    out = _heads_view(B, H, N, dp, q)
    # the tensor maps of q, k, v and out
    geos.append(_tma_geometry(out, _ROW_TILE))
    # partial O (B*H, S, N, dp) and lse (B*H, S, N) of the split route
    return _Plan(lib, lib and lib.dfdt_flash_fwd, (q, k, v, out), geos, d, None, padded,
                 B * H * N * (dp + 1))


def _bwd_layout(q, k, v, out, lse, dout, lib=None) -> _Plan:
    """The route and plan block of a backward call, as :func:`_fwd_layout`:
    a tensor whose last axis is strided goes as a contiguous copy, and lse
    as a contiguous one unless it is."""
    ins = (q, k, v, out, dout)
    copies = tuple(t.stride(-1) != 1 for t in ins)
    ins = tuple(t.contiguous() if c else t for t, c in zip(ins, copies))
    B, H, N, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    # every box of the backward's maps, own tile or streamed, is _bwd_tile
    # rows: one tensor map a tensor
    rows = _bwd_tile(d, bf16)
    geos = _tma_geometries(ins, rows)
    padded = geos is None
    if padded:
        ins = tuple(_pad_head_dim(t) for t in ins)
        geos = _tma_geometries(ins, rows)
    dp = ins[0].shape[-1]
    grad = _heads_view(B, H, N, dp, ins[0])
    # the tensor maps of q, k, v, out, dout, dq, dk and dv
    geos += [_tma_geometry(grad, rows)] * 3
    # partial dQ, dK and dV, each (B*H, S, N, dp), of the split route
    plan = _Plan(lib, lib and lib.dfdt_flash_bwd, ins + (grad,) * 3, geos, d,
                 copies if any(copies) else None, padded, 3 * B * H * N * dp)
    plan.lse_copy = not lse.is_contiguous()
    return plan


def _fwd_plan(key, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> _Plan:
    """The checks and plan of a forward key, on its first call."""
    _check_inputs(q, k, v)
    _check_kernel_shape(q)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs the last axis of q, "
                         "k, v contiguous")
    return _remember(_FWD_PLANS, key, _fwd_layout(q, k, v, _fwd_library()))


def _bwd_plan(key, q, k, v, out, lse, dout) -> _Plan:
    """The checks and plan of a backward key, on its first call."""
    _check_bwd_inputs(q, k, v, out, lse, dout)
    _check_kernel_shape(q)
    return _remember(_BWD_PLANS, key, _bwd_layout(q, k, v, out, lse, dout, _bwd_library()))


def _clear_launch_caches() -> None:
    """Forget every launch plan, and the tensor maps and shared-memory
    attributes that the loaded flash libraries keep (tests: results after a
    clear equal those before)."""
    _FWD_PLANS.clear()
    _BWD_PLANS.clear()
    for source in (_FWD_SOURCE, _BWD_SOURCE):
        lib = _build._libs.get(source)
        if lib is not None:
            lib.dfdt_clear_launch_cache()


def _count(f, plan: _Plan, splits: int, device: int) -> None:
    with _count_lock:
        f.launches += 1
        f.launches_long += plan.long
        f.launches_split += splits > 1
        f.launches_f32 += not plan.bf16
        by = f.launches_by_device
        by[device] = by.get(device, 0) + 1


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q, k, v``: ``(B, H, N, d)``, bf16 or f32, d ≤ 256, any N ≥ 1.
    Returns ``(out, lse)``: out ``(B, H, N, d)`` in q's dtype, lse f32
    ``(B, H, N)``, the logsumexp of the scaled scores of each query row.
    Not differentiable through the kernel: use :func:`flash_attention`.

    A call looks its launch plan up by the inputs' shapes, strides, dtypes,
    cards and alignment (built, checks included, on the key's first call),
    then allocates the outputs and hands the kernel's library two int64
    blocks: the plan's, and one of this call's pointers, stream and split
    count."""
    with annotate("ops.flash_fwd") as span:
        if span:
            span.set(shape=q.shape, dtype=q.dtype)
        if q.is_cpu:
            _check_inputs(q, k, v)
            return flash_attention_plain(q, k, v)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        key = _fwd_key(q, k, v, ptrs)
        plan = _FWD_PLANS.get(key) or _fwd_plan(key, q, k, v)
        if plan.padded:
            q, k, v = (_pad_head_dim(t) for t in (q, k, v))
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        device = q.get_device()
        splits = _long_splits(plan.B, plan.H, plan.N, plan.d, plan.bf16)[0]
        out = q.new_empty_strided(plan.out_size, plan.out_stride)
        lse = q.new_empty((plan.B, plan.H, plan.N), dtype=torch.float32)
        part = q.new_empty(splits * plan.part_n, dtype=torch.float32) if splits > 1 else None
        call = array.array("q", (*ptrs, out.data_ptr(), lse.data_ptr(),
                                 0 if part is None else part.data_ptr(),
                                 torch._C._cuda_getCurrentRawStream(device), splits))
        status = plan.fn(call.buffer_info()[0], plan.addr)
        if status:
            _build.check(plan.lib, status, "flash_attention_fwd")
        _count(flash_attention_fwd, plan, splits, device)
        return (out[..., :plan.d] if plan.padded else out), lse


def _check_bwd_inputs(q, k, v, out, lse, dout) -> None:
    _check_inputs(q, k, v, out, dout)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash attention backward takes lse f32 "
                         f"{tuple(q.shape[:3])} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of ``out = flash_attention(q, k, v)`` for
    the cotangent ``dout``, from the forward's ``out`` and ``lse``. All of
    q, k, v, out, dout ``(B, H, N, d)`` in one dtype; lse f32 ``(B, H, N)``.
    A tensor whose last axis is not contiguous is copied; any other strides
    that a tensor map describes go to the kernel as they are. Launched as
    :func:`flash_attention_fwd` is, from a plan looked up by the inputs'
    shapes, strides, dtypes, cards and alignment."""
    with annotate("ops.flash_bwd") as span:
        if span:
            span.set(shape=q.shape, dtype=q.dtype)
        if q.is_cpu:
            _check_bwd_inputs(q, k, v, out, lse, dout)
            return flash_attention_bwd_plain(q, k, v, out, lse, dout)
        ins = (q, k, v, out, dout)
        ptrs = [t.data_ptr() for t in ins]
        key = _bwd_key(q, k, v, out, lse, dout, ptrs)
        plan = _BWD_PLANS.get(key) or _bwd_plan(key, q, k, v, out, lse, dout)
        if plan.copies:
            ins = tuple(t.contiguous() if c else t for t, c in zip(ins, plan.copies))
        if plan.padded:
            ins = tuple(_pad_head_dim(t) for t in ins)
        if plan.copies or plan.padded:
            ptrs = [t.data_ptr() for t in ins]
        if plan.lse_copy:
            lse = lse.contiguous()
        device = q.get_device()
        splits = _long_splits(plan.B, plan.H, plan.N, plan.d, plan.bf16)[1]
        q = ins[0]
        dq, dk, dv = (q.new_empty_strided(plan.out_size, plan.out_stride) for _ in range(3))
        # one f32 scratch: D of each row, then (split route) the partials from
        # a 64-element boundary, aligned for their 16-byte loads
        rows = _cdiv(plan.B * plan.H * plan.N, 64) * 64
        scratch = q.new_empty(rows + (splits * plan.part_n if splits > 1 else 0),
                              dtype=torch.float32)
        dcap = scratch.data_ptr()
        call = array.array("q", (*ptrs, lse.data_ptr(), dcap, dq.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), dcap + 4 * rows if splits > 1 else 0,
                                 torch._C._cuda_getCurrentRawStream(device), splits))
        status = plan.fn(call.buffer_info()[0], plan.addr)
        if status:
            _build.check(plan.lib, status, "flash_attention_bwd")
        _count(flash_attention_bwd, plan, splits, device)
        if plan.padded:
            d = plan.d
            return dq[..., :d], dk[..., :d], dv[..., :d]
        return dq, dk, dv


# kernel launches since the last reset (plain integers, set to 0 by callers);
# one backward call launches its dQ and dK/dV passes and counts once.
# ``launches_long`` counts the launches at N > 512, the regime of the JAX
# package's streaming kernels (K3 forward, K5/K6 backward);
# ``launches_split`` those that took the split route (S > 1, with its
# combine or reduce kernel); ``launches_f32`` those of f32 inputs (the
# 3xTF32 Hopper kernels: the forward's one kernel, the backward's two
# passes); ``launches`` counts them all, ``launches_by_device`` by card
# index (a dict, emptied by callers).
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

"""Fused preprocessing: uint8 frames → ImageNet-normalised bf16 or f32 (K1).

Counterpart of ``deepfake_video_detection_tpu/ops/preprocess.py``. On a CUDA
tensor :func:`fused_normalize` launches the hand-written kernel
``csrc/normalize.cu`` (one pass: 1 byte in, 2 or 4 bytes out per element);
on a CPU tensor it takes :func:`fused_normalize_plain`, which repeats the
kernel's arithmetic step for step. In eager PyTorch nothing fuses the
normalisation into the patch-embed conv, so the serving forward
(``serve/predict.py``) runs this on every RGB batch.

The TPU kernel fell back to plain XLA when the size was not a multiple of
its 128-lane tile. The CUDA kernel masks its own tail, so here any size of a
contiguous ``(..., 3)`` buffer takes the kernel.

:func:`fused_normalize_yuv` is the same kernel's second entry: packed
YUV420 crops (Y, then U, then V, as ``ops/yuv.py`` unpacks them) → RGB →
normalised, in one pass, for the serving forward's packed-YUV branch. Its
plain version, :func:`fused_normalize_yuv_plain`, is ``ops/yuv.py``'s
conversion followed by ``imagenet_normalize(rgb / 255, scaled=True)``, the
JAX serving forward's arithmetic.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deepfake_video_detection_tpu_torch.data.normalize import (
    IMAGENET_MEAN, IMAGENET_STD, imagenet_normalize)
from deepfake_video_detection_tpu_torch.ops import _build
from deepfake_video_detection_tpu_torch.ops.yuv import yuv420_packed_to_rgb

_SOURCE = "normalize.cu"
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_count_lock = threading.Lock()


def fused_normalize_plain(frames_u8: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version: ``(x * (1/255) - mean[c]) * (1/std[c])``
    in f32, cast to ``out_dtype``."""
    x = frames_u8.to(torch.float32) * (1.0 / 255.0)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    inv_std = torch.tensor([1.0 / s for s in IMAGENET_STD], dtype=torch.float32,
                           device=x.device)
    return ((x - mean) * inv_std).to(out_dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.dfdt_normalize_u8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dfdt_normalize_yuv420
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_normalize(frames_u8: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``frames_u8``: uint8 ``(..., 3)`` (e.g. ``(B, T, H, W, 3)``). Returns
    the same shape, normalised, in ``out_dtype`` (bf16 or f32).

    CPU tensor → the plain version. CUDA tensor → the kernel, which needs a
    contiguous input; anything the kernel does not take raises."""
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim < 1 \
            or frames_u8.shape[-1] != 3:
        raise ValueError(f"fused_normalize takes uint8 (..., 3), got "
                         f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"fused_normalize writes bf16 or f32, not {out_dtype}")
    if frames_u8.device.type == "cpu":
        return fused_normalize_plain(frames_u8, out_dtype)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"fused_normalize: no kernel for {frames_u8.device}")
    if not frames_u8.is_contiguous():
        raise ValueError("fused_normalize: the CUDA kernel takes a contiguous "
                         "input")
    out = torch.empty(frames_u8.shape, dtype=out_dtype, device=frames_u8.device)
    if out.numel() == 0:
        return out
    lib = _library()
    status = lib.dfdt_normalize_u8(
        frames_u8.data_ptr(), out.data_ptr(), frames_u8.numel(),
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(frames_u8.device).cuda_stream)
    _build.check(lib, status, "fused_normalize")
    _count(fused_normalize, frames_u8.device)
    return out


def _count(fn, device: torch.device) -> None:
    """One launch of ``fn``'s kernel on ``device``."""
    with _count_lock:
        fn.launches += 1
        fn.launches_by_device[device.index] = fn.launches_by_device.get(device.index, 0) + 1


# kernel launches since the last reset (a plain integer, set to 0 by callers),
# and by card index (a dict, emptied by callers)
fused_normalize.launches = 0
fused_normalize.launches_by_device = {}


def fused_normalize_yuv_plain(packed_u8: torch.Tensor, height: int, width: int,
                              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version: BT.601 YUV420 → RGB in f32, then
    ``imagenet_normalize(rgb / 255, scaled=True)``, cast to ``out_dtype``."""
    rgb = yuv420_packed_to_rgb(packed_u8, height, width)
    return imagenet_normalize(rgb / 255.0, scaled=True).to(out_dtype)


def fused_normalize_yuv(packed_u8: torch.Tensor, height: int, width: int,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``packed_u8``: uint8 ``(..., H*W*3//2)`` packed YUV420 frames (e.g.
    ``(B, T, H*W*3//2)``), H and W even. Returns ``(..., H, W, 3)`` RGB,
    ImageNet-normalised, in ``out_dtype`` (bf16 or f32).

    CPU tensor → the plain version. CUDA tensor → the kernel, which needs a
    contiguous input; anything the kernel does not take raises."""
    if packed_u8.dtype != torch.uint8 or packed_u8.ndim < 1:
        raise ValueError(f"fused_normalize_yuv takes uint8 (..., H*W*3/2), got "
                         f"{packed_u8.dtype} {tuple(packed_u8.shape)}")
    if height <= 0 or width <= 0 or height % 2 or width % 2:
        raise ValueError(f"fused_normalize_yuv: H and W must be even and positive, "
                         f"got {height} x {width}")
    if packed_u8.shape[-1] != height * width * 3 // 2:
        raise ValueError(f"fused_normalize_yuv: last axis {packed_u8.shape[-1]} is not "
                         f"{height} * {width} * 3 / 2")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"fused_normalize_yuv writes bf16 or f32, not {out_dtype}")
    if packed_u8.device.type == "cpu":
        return fused_normalize_yuv_plain(packed_u8, height, width, out_dtype)
    if packed_u8.device.type != "cuda":
        raise ValueError(f"fused_normalize_yuv: no kernel for {packed_u8.device}")
    if not packed_u8.is_contiguous():
        raise ValueError("fused_normalize_yuv: the CUDA kernel takes a contiguous input")
    lead = tuple(packed_u8.shape[:-1])
    out = torch.empty(lead + (height, width, 3), dtype=out_dtype,
                      device=packed_u8.device)
    if out.numel() == 0:
        return out
    lib = _library()
    status = lib.dfdt_normalize_yuv420(
        packed_u8.data_ptr(), out.data_ptr(), packed_u8.numel() // packed_u8.shape[-1],
        height, width, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(packed_u8.device).cuda_stream)
    _build.check(lib, status, "fused_normalize_yuv")
    _count(fused_normalize_yuv, packed_u8.device)
    return out


# kernel launches since the last reset, in all and by card index
fused_normalize_yuv.launches = 0
fused_normalize_yuv.launches_by_device = {}

#!/usr/bin/env python3
"""Build ``csrc/flash_bwd.cu`` alone and check, time and sweep its bf16
kernels on one CUDA card: the quick loop for work on the backward.

    python3 tools/flash_bwd_check.py [--time] [--sweep] [--trace]

Prints the ptxas lines of the backward's kernels (registers, spills) with
each kernel's HGMMA and UTMALDG counts in the built SASS and ptxas's notes
on the wgmma products (C75xx), then holds each case of ``CASES`` against
the plain version (dQ, dK, dV within ``BF16_TOL_REL`` of max |ref|, floor
``K4_TOL_FLOOR``; ``chip_smoke.py``'s gates) and a rerun bit for bit.
``--time`` adds, at ``TIMED``, the device ms of the call by kernel and of
``scaled_dot_product_attention``'s backward (autograd through it less its
forward, as ``chip_smoke.py`` reads it) and the bound; ``--sweep`` the
backward's device ms at every split count of ``SWEPT``; ``--trace`` builds
the source again with ``-DDFDT_BWD_TRACE`` (its ``BWD_MARK`` cycle marks)
and prints, at ``TRACED``, the median cycles of a block's phases in each
pass: set-up and the first loads, the first streamed tile, each further
tile, the epilogue. One JSON object a line; exits 1 at the first failure.
"""

from __future__ import annotations

import ctypes
import os
import re
import sys
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tools.flash_fwd_check import _emit, build_report, traced  # noqa: E402

# (B, H, N, d, q/k/v and dO as the views the model hands over)
CASES = [(8, 12, 197, 64, True), (128, 12, 197, 64, True), (16, 12, 1, 64, False),
         (4, 12, 256, 64, False), (2, 4, 100, 80, True), (3, 2, 17, 128, False),
         (2, 4, 130, 256, False), (2, 3, 77, 36, False), (2, 4, 130, 192, True),
         (2, 12, 640, 64, False), (2, 4, 513, 64, False), (1, 4, 641, 64, True),
         (2, 4, 1025, 64, True), (1, 4, 1025, 128, True), (1, 2, 700, 256, True),
         (1, 4, 4097, 64, True), (8, 4, 17, 64, True)]
TIMED = [(128, 12, 197, 64), (8, 12, 197, 64), (8, 4, 17, 64), (1, 4, 641, 64),
         (2, 12, 640, 64), (1, 4, 4097, 64), (4, 12, 256, 64), (2, 4, 513, 64)]
SWEPT = [(1, 4, 641, 64), (2, 12, 640, 64), (1, 4, 4097, 64), (2, 4, 513, 64)]
TRACED = [(128, 12, 197, 64), (8, 12, 197, 64), (1, 4, 641, 64)]
PHASES = ("to_first_tiles", "first_tile", "per_further_tile", "epilogue")
PASSES = ("dq", "dkv")


def _short(mangled: str) -> str:
    m = re.search(r"(flash_bwd_(?:dq|dkv)_(?:split_)?(?:bf16_wgmma|tf32)_kernel"
                  r"|flash_bwd_reduce_kernel)(?:ILi(\d+)E)?", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m and m.group(2) else (m.group(1) if m else mangled)


def _bwd(A, args):
    return lambda: A.flash_attention_bwd(*args)


def _library_ms(torch, q, k, v, dout):
    """Device ms of scaled_dot_product_attention's backward: autograd
    through it less its forward."""
    import torch.nn.functional as F

    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), dout)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(ql, kl, vl)

    fb, fo = cs._session_device_ms(torch, fwd_bwd), cs._session_device_ms(torch, fwd)
    return None if fb is None or fo is None else fb - fo


def _trace(torch, A, _build, gen) -> None:
    """Median cycles of each phase of a block (``BWD_MARK``) of both passes
    at ``TRACED``, from a build of the source with the marks compiled in."""
    with traced("flash_bwd.cu", "DFDT_BWD_TRACE") as lib:
        for B, H, N, d in TRACED:
            args = cs._bwd_inputs(torch, A, gen, B, H, N, d, torch.bfloat16, True)
            splits = A._long_splits(B, H, N, d)[1]
            for _ in range(3):
                A.flash_attention_bwd(*args)
            torch.cuda.synchronize()
            tiles = -(-N // A._bwd_tile(d))
            blocks = B * H * tiles * -(-d // 64) * splits
            per_block = tiles // splits
            for p, name in enumerate(PASSES):
                buf = (ctypes.c_longlong * (5 * blocks))()
                _build.check(lib, lib.dfdt_bwd_trace(buf, p, blocks), "dfdt_bwd_trace")
                marks = np.frombuffer(buf, dtype=np.int64).reshape(blocks, 5)
                steps = np.diff(marks, axis=1).astype(np.float64)
                steps[:, 2] /= max(per_block - 1, 1)
                _emit({"trace": [B, H, N, d], "pass": name, "splits": splits,
                       "tiles_a_block": per_block,
                       "median_cycles": dict(zip(PHASES, np.median(steps, axis=0).tolist())),
                       "median_block_cycles": float(np.median(marks[:, 4] - marks[:, 0]))})


def main(argv) -> int:
    import torch

    from deepfake_video_detection_tpu_torch.ops import _build
    from deepfake_video_detection_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("flash_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    _emit({"nvidia_smi": cs._smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "dynamic_smem_d64": A._bwd_smem(64)})
    build_report("flash_bwd.cu", _short)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, H, N, d, strided in CASES:
        args = cs._bwd_inputs(torch, A, gen, B, H, N, d, torch.bfloat16, strided)
        got = A.flash_attention_bwd(*args)
        again = A.flash_attention_bwd(*args)
        ref = A.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        rel, good = {}, True
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            err = float((g.float() - r.float()).abs().max())
            ref_max = float(r.float().abs().max())
            rel[name] = err / max(ref_max, 1e-30)
            good &= err <= max(cs.BF16_TOL_REL * ref_max, cs.K4_TOL_FLOOR)
        det = all(torch.equal(a, b) for a, b in zip(got, again))
        ok &= good and det
        _emit({"shape": [B, H, N, d], "strided": strided,
               "splits": A._long_splits(B, H, N, d)[1], "rel_err": rel,
               "deterministic": det, "ok": good and det})
    if not ok:
        return 1

    if "--time" in argv:
        for B, H, N, d in TIMED:
            args = cs._bwd_inputs(torch, A, gen, B, H, N, d, torch.bfloat16, True)
            splits = A._long_splits(B, H, N, d)[1]
            nbytes, ops = 8 * B * H * N * d * 2 + 4 * B * H * N, 10.0 * B * H * N * N * d
            bound, by = cs._bound_ms(nbytes, ops, "bf16")
            parts = {}
            kern = cs._device_ms(torch, _bwd(A, args), cs._flash_kernels("bwd", "bf16", splits),
                                 parts=parts)
            lib = _library_ms(torch, *args[:3], args[5])
            _emit({"shape": [B, H, N, d], "splits": splits, "kernel_device_ms": kern,
                   "by_kernel": parts, "library_device_ms": lib,
                   "kernel_ms": cs._time_ms(torch, _bwd(A, args)),
                   "ratio": None if not (kern and lib) else kern / lib,
                   "bound_ms": bound, "bound_by": by})
    if "--sweep" in argv:
        for B, H, N, d in SWEPT:
            args = cs._bwd_inputs(torch, A, gen, B, H, N, d, torch.bfloat16, True)
            times = {}
            for S in range(1, min(cs.SWEEP_MAX_SPLITS, -(-N // A._bwd_tile(d)) // 2) + 1):
                with mock.patch.object(A, "_long_splits", lambda *_, S=S: (S, S)):
                    times[S] = cs._device_ms(torch, _bwd(A, args),
                                             cs._flash_kernels("bwd", "bf16", S))
            _emit({"sweep": [B, H, N, d], "policy": A._long_splits(B, H, N, d)[1],
                   "device_ms": times})
    if "--trace" in argv:
        _trace(torch, A, _build, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

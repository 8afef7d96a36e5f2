#!/usr/bin/env python3
"""Build ``csrc/flash_fwd.cu`` alone and check, time and sweep its
kernels of one dtype on one CUDA card: the quick loop for work on the
forward.

    python3 tools/flash_fwd_check.py [--dtype bf16|f32] [--time] [--sweep] [--trace]

Prints the ptxas lines of the forward's kernels (registers, spills, wgmma
warnings) and each kernel's HGMMA and UTMALDG counts in the built SASS,
then holds each case of ``CASES`` in the dtype (bf16 by default) against
the plain version (bf16: O within ``BF16_TOL_REL`` of max |ref|; f32: O
within ``K2_TOL_F32``; lse within ``K2_TOL_LSE``: ``chip_smoke.py``'s
gates). ``--time`` adds, at ``TIMED`` (``F32_TIMED``), the device ms of
the kernel and of ``scaled_dot_product_attention`` (CUDA events over queued
calls held against ``torch.profiler``, as ``chip_smoke.py`` reads them) and
the bound, beside both calls' card ms and the wrapper's host time by phase
(``chip_smoke.host_record``); ``--sweep`` the bf16 forward's device ms at every split count of
the long-N shapes (f32 has no split route); ``--trace`` builds the source
again with ``-DDFDT_FWD_TRACE`` (its ``FWD_MARK`` cycle marks) and prints,
at ``TRACED``, the median cycles of a block's phases: set-up and the first
Q and K loads, the first S, each further key tile, the last P.V, the
epilogue; for f32 also each further tile's four phases (``TILE_PHASES``).
One JSON object a line; exits 1 at the first failure.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# (B, H, N, d, q/k/v as views of one fused QKV buffer)
CASES = [(8, 12, 197, 64, True), (128, 12, 197, 64, True), (16, 12, 1, 64, False),
         (4, 12, 256, 64, False), (2, 4, 100, 80, True), (3, 2, 17, 128, False),
         (2, 4, 130, 128, True), (2, 4, 130, 256, False), (2, 4, 300, 256, True),
         (2, 3, 77, 36, False), (2, 4, 130, 192, False), (2, 12, 640, 64, False),
         (2, 4, 513, 64, False), (2, 4, 1025, 64, True), (1, 4, 641, 64, True),
         (1, 4, 4097, 64, True), (8, 4, 17, 64, True), (16, 3, 197, 64, True),
         (4, 6, 197, 32, False), (2, 3, 77, 30, False), (16, 6, 197, 64, True)]
TIMED = [(128, 12, 197, 64), (8, 12, 197, 64), (16, 3, 197, 64), (8, 4, 17, 64),
         (2, 4, 1025, 64), (1, 4, 641, 64)]
# the f32 forward's shapes on the port's paths: the f32 ViT-B/16 step, the
# training CLI's default vit_gcn step, the ViT-GNN trainer, one f32 request,
# the temporal model over B0, the ring's fold at the long clip; then d = 32,
# 256 and 30 (a zero-padded copy)
F32_TIMED = [(128, 12, 197, 64), (128, 3, 197, 64), (16, 6, 197, 64), (8, 12, 197, 64),
             (8, 4, 17, 64), (1, 4, 641, 64), (4, 6, 197, 32), (2, 4, 130, 256),
             (2, 3, 77, 30)]
SWEPT = [(2, 4, 1025, 64), (1, 4, 641, 64), (1, 4, 4097, 64), (2, 4, 513, 64)]
TRACED = [(128, 12, 197, 64), (8, 12, 197, 64), (2, 4, 1025, 64)]
PHASES = ("to_first_q_and_k", "first_s", "per_further_tile", "last_pv", "epilogue")
# the f32 kernel's phases of each tile after the first (FWD_PHASE), summed
# over a block's tiles
TILE_PHASES = ("softmax_and_pv_issue", "k_wait_split_and_s_issue", "pv_wait_and_v_transpose",
               "s_wait_and_refill")
SLOTS = 10   # a block's trace record: 6 marks, 4 phase sums


def _qkv(torch, gen, B, H, N, d, strided, dtype):
    if strided:
        qkv = torch.randn((B, N, 3, H, d), device="cuda", generator=gen).to(dtype)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)
    return [torch.randn((B, H, N, d), device="cuda", generator=gen).to(dtype)
            for _ in range(3)]


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _short(mangled: str) -> str:
    m = re.search(r"(flash_fwd_(?:split_)?(?:bf16_wgmma|tf32_wgmma|combine)_kernel)(?:ILi(\d+)E)?",
                  mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m and m.group(2) else (m.group(1) if m else mangled)


def build_report(source: str, short) -> None:
    """Build ``source`` alone and print its kernels' ptxas lines (registers,
    spills, the HGMMA and UTMALDG counts of their SASS) and ptxas's notes on
    the wgmma products (C75xx), by code and kernel (``short`` names one)."""
    from deepfake_video_detection_tpu_torch.ops import _build

    secs = _build.build_all([source])
    log = _build.build_log.get(source, "")
    sass = cs.sass_counts(_build.library_path(source))
    stem = os.path.splitext(source)[0]
    for st in cs._ptxas_stats(log):
        if stem in st["function"]:
            _emit({"kernel": short(st["function"]), "registers": st["registers"],
                   "spill_stores": st["spill_stores"], "sass": sass.get(st["function"])})
    notes = collections.Counter(
        (m.group(1), short(line)) for line in log.splitlines()
        if (m := re.search(r"\((C75\d\d)\)", line)))
    _emit({"ptxas_notes": {f"{c} {k}": n for (c, k), n in sorted(notes.items())},
           "messages": sorted({re.sub(r"'.*", "", re.sub(r"line \d+", "line N", line.strip()))
                               for line in log.splitlines() if "(C75" in line}),
           "build_s": secs})


@contextlib.contextmanager
def traced(source: str, macro: str):
    """``source`` built again with ``-D<macro>`` (its cycle marks), loaded in
    place of its library while the block runs; yields the library."""
    from deepfake_video_detection_tpu_torch.ops import _build

    path = _build.BUILD_DIR / f"lib{os.path.splitext(source)[0]}-trace.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-D{macro}", "-o", str(path),
                        str(_build.CSRC_DIR / source)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"traced build failed:\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
    kept = _build.load(source)
    lib = _build._libs[source] = ctypes.CDLL(str(path))
    try:
        yield lib
    finally:
        _build._libs[source] = kept


def _trace(torch, A, _build, gen, dtype) -> None:
    """Median cycles of each phase of a block (``FWD_MARK``) at ``TRACED``,
    from a build of the source with the marks compiled in."""
    bf16 = dtype == torch.bfloat16
    with traced("flash_fwd.cu", "DFDT_FWD_TRACE") as lib:
        for B, H, N, d in TRACED:
            q, k, v = _qkv(torch, gen, B, H, N, d, True, dtype)
            splits = A._long_splits(B, H, N, d, bf16)[0]
            for _ in range(3):
                A.flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            blocks = B * H * -(-N // 64) * splits
            buf = (ctypes.c_longlong * (SLOTS * blocks))()
            _build.check(lib, lib.dfdt_fwd_trace(buf, blocks), "dfdt_fwd_trace")
            rec = np.frombuffer(buf, dtype=np.int64).reshape(blocks, SLOTS)
            marks = rec[:, :6]
            steps = np.diff(marks, axis=1).astype(np.float64)
            tiles = -(-N // A._fwd_key_tile(d, bf16)) // splits
            steps[:, 2] /= max(tiles - 1, 1)
            tile = {}
            if not bf16:    # each phase's median cycles a tile after the first
                tile = {"median_cycles_a_tile": dict(zip(TILE_PHASES, np.median(
                    rec[:, 6:] / max(tiles - 1, 1), axis=0).tolist()))}
            _emit({"trace": [B, H, N, d], "dtype": "bf16" if bf16 else "f32", "splits": splits,
                   "key_tiles_a_block": tiles,
                   "median_cycles": dict(zip(PHASES, np.median(steps, axis=0).tolist())),
                   "median_block_cycles": float(np.median(marks[:, 5] - marks[:, 0])),
                   **tile})


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    from deepfake_video_detection_tpu_torch.ops import _build
    from deepfake_video_detection_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("flash_fwd_check: no CUDA device", file=sys.stderr)
        return 2
    name = argv[argv.index("--dtype") + 1] if "--dtype" in argv else "bf16"
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[name]
    bf16 = dtype == torch.bfloat16
    _emit({"nvidia_smi": cs._smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "dtype": name, "dynamic_smem_d64": A._fwd_smem(64, bf16)})
    build_report("flash_fwd.cu", _short)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, H, N, d, strided in CASES:
        q, k, v = _qkv(torch, gen, B, H, N, d, strided, dtype)
        out, lse = A.flash_attention_fwd(q, k, v)
        ref, ref_lse = A.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ref_max = float(ref.float().abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        tol = cs.BF16_TOL_REL * ref_max if bf16 else cs.K2_TOL_F32
        good = err <= tol and err_lse <= cs.K2_TOL_LSE
        ok &= good
        _emit({"shape": [B, H, N, d], "dtype": name, "strided": strided,
               "splits": A._long_splits(B, H, N, d, bf16)[0], "max_abs_err": err,
               "rel_err": err / ref_max, "lse_err": err_lse, "ok": good})
    if not ok:
        return 1

    if "--time" in argv:
        for B, H, N, d in TIMED if bf16 else F32_TIMED:
            q, k, v = _qkv(torch, gen, B, H, N, d, True, dtype)
            splits = A._long_splits(B, H, N, d, bf16)[0]
            nbytes = 4 * B * H * N * d * q.element_size() + 4 * B * H * N
            bound, by = cs._bound_ms(nbytes, 4.0 * B * H * N * N * d, cs.FLASH_PEAK[name])
            kern = cs._device_ms(torch, lambda: A.flash_attention_fwd(q, k, v),
                                 cs._flash_kernels("fwd", name, splits))
            lib = cs._session_device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
            host = cs.host_record(torch, A, "fwd", (q, k, v),
                                  cs.library_calls(torch, "fwd", (q, k, v)))
            _emit({"shape": [B, H, N, d], "dtype": name, "splits": splits,
                   "kernel_device_ms": kern, "library_device_ms": lib,
                   "ratio": None if not (kern and lib) else kern / lib,
                   "bound_ms": bound, "bound_by": by, **host})
    if "--sweep" in argv and bf16:
        for B, H, N, d in SWEPT:
            q, k, v = _qkv(torch, gen, B, H, N, d, True, dtype)
            times = {}
            for S in range(1, min(cs.SWEEP_MAX_SPLITS, -(-N // A._fwd_key_tile(d)) // 2) + 1):
                with mock.patch.object(A, "_long_splits", lambda *_, S=S: (S, S)):
                    times[S] = cs._device_ms(torch, lambda: A.flash_attention_fwd(q, k, v),
                                             cs._flash_kernels("fwd", "bf16", S))
            _emit({"sweep": [B, H, N, d], "policy": A._long_splits(B, H, N, d)[0],
                   "device_ms": times})
    if "--trace" in argv:
        _trace(torch, A, _build, gen, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Build ``csrc/flash_fwd.cu`` alone and check, time and sweep its bf16
kernels on one CUDA card: the quick loop for work on the forward.

    python3 tools/flash_fwd_check.py [--time] [--sweep] [--trace]

Prints the ptxas lines of the forward's kernels (registers, spills, wgmma
warnings) and each kernel's HGMMA and UTMALDG counts in the built SASS,
then holds each case of ``CASES`` against the plain version (O within
``BF16_TOL_REL`` of max |ref|, lse within ``K2_TOL_LSE``; ``chip_smoke.py``'s
gates). ``--time`` adds, at ``TIMED``, the device ms of the kernel and of
``scaled_dot_product_attention`` (CUDA events over queued calls held against
``torch.profiler``, as ``chip_smoke.py`` reads them) and the bound;
``--sweep`` the forward's device ms at every split count of the long-N
shapes; ``--trace`` builds the source again with ``-DDFDT_FWD_TRACE`` (its
``FWD_MARK`` cycle marks) and prints, at ``TRACED``, the median cycles of a
block's phases: set-up and the first Q and K loads, the first S, each
further key tile, the last P.V, the epilogue. One JSON object a line;
exits 1 at the first failure.
"""

from __future__ import annotations

import collections
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
         (1, 4, 4097, 64, True), (8, 4, 17, 64, True), (16, 3, 197, 64, True)]
TIMED = [(128, 12, 197, 64), (8, 12, 197, 64), (16, 3, 197, 64), (8, 4, 17, 64),
         (2, 4, 1025, 64), (1, 4, 641, 64)]
SWEPT = [(2, 4, 1025, 64), (1, 4, 641, 64), (1, 4, 4097, 64), (2, 4, 513, 64)]
TRACED = [(128, 12, 197, 64), (8, 12, 197, 64), (2, 4, 1025, 64)]
PHASES = ("to_first_q_and_k", "first_s", "per_further_tile", "last_pv", "epilogue")


def _qkv(torch, gen, B, H, N, d, strided):
    if strided:
        qkv = torch.randn((B, N, 3, H, d), device="cuda", generator=gen).to(torch.bfloat16)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)
    return [torch.randn((B, H, N, d), device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(3)]


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _short(mangled: str) -> str:
    m = re.search(r"(flash_fwd_(?:split_)?(?:bf16_wgmma|tf32|combine)_kernel)(?:ILi(\d+)E)?",
                  mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m and m.group(2) else (m.group(1) if m else mangled)


def _trace(torch, A, _build, gen) -> None:
    """Median cycles of each phase of a block (``FWD_MARK``) at ``TRACED``,
    from a build of the source with the marks compiled in."""
    path = _build.BUILD_DIR / "libflash_fwd-trace.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DDFDT_FWD_TRACE", "-o",
                        str(path), str(_build.CSRC_DIR / "flash_fwd.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"traced build failed:\n{r.stdout[-4000:]}")
    kept = _build._libs["flash_fwd.cu"]
    lib = _build._libs["flash_fwd.cu"] = ctypes.CDLL(str(path))
    try:
        for B, H, N, d in TRACED:
            q, k, v = _qkv(torch, gen, B, H, N, d, True)
            splits = A._long_splits(B, H, N, d)[0]
            for _ in range(3):
                A.flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            blocks = B * H * -(-N // 64) * splits
            buf = (ctypes.c_longlong * (6 * blocks))()
            _build.check(lib, lib.dfdt_fwd_trace(buf, blocks), "dfdt_fwd_trace")
            marks = np.frombuffer(buf, dtype=np.int64).reshape(blocks, 6)
            steps = np.diff(marks, axis=1).astype(np.float64)
            tiles = -(-N // A._fwd_key_tile(d)) // splits
            steps[:, 2] /= max(tiles - 1, 1)
            _emit({"trace": [B, H, N, d], "splits": splits, "key_tiles_a_block": tiles,
                   "median_cycles": dict(zip(PHASES, np.median(steps, axis=0).tolist())),
                   "median_block_cycles": float(np.median(marks[:, 5] - marks[:, 0]))})
    finally:
        _build._libs["flash_fwd.cu"] = kept


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    from deepfake_video_detection_tpu_torch.ops import _build
    from deepfake_video_detection_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("flash_fwd_check: no CUDA device", file=sys.stderr)
        return 2
    _emit({"nvidia_smi": cs._smi(), "torch": torch.__version__, "cuda": torch.version.cuda})
    secs = _build.build_all(["flash_fwd.cu"])
    log = _build.build_log.get("flash_fwd.cu", "")
    sass = cs.sass_counts(_build.library_path("flash_fwd.cu"))
    for st in cs._ptxas_stats(log):
        if "flash_fwd" in st["function"]:
            _emit({"kernel": _short(st["function"]), "registers": st["registers"],
                   "spill_stores": st["spill_stores"], "sass": sass.get(st["function"])})
    # ptxas's notes on the wgmma products (C75xx), counted by code and kernel
    notes = collections.Counter(
        (m.group(1), _short(line)) for line in log.splitlines()
        if (m := re.search(r"\((C75\d\d)\)", line)))
    _emit({"ptxas_notes": {f"{c} {k}": n for (c, k), n in sorted(notes.items())},
           "examples": sorted({re.sub(r"'.*", "", line.strip())
                               for line in log.splitlines() if "(C75" in line})[:6],
           "build_s": secs})

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, H, N, d, strided in CASES:
        q, k, v = _qkv(torch, gen, B, H, N, d, strided)
        out, lse = A.flash_attention_fwd(q, k, v)
        ref, ref_lse = A.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ref_max = float(ref.float().abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        good = err <= cs.BF16_TOL_REL * ref_max and err_lse <= cs.K2_TOL_LSE
        ok &= good
        _emit({"shape": [B, H, N, d], "strided": strided,
               "splits": A._long_splits(B, H, N, d)[0], "rel_err": err / ref_max,
               "lse_err": err_lse, "ok": good})
    if not ok:
        return 1

    if "--time" in argv:
        for B, H, N, d in TIMED:
            q, k, v = _qkv(torch, gen, B, H, N, d, True)
            splits = A._long_splits(B, H, N, d)[0]
            nbytes, ops = 4 * B * H * N * d * 2 + 4 * B * H * N, 4.0 * B * H * N * N * d
            bound, by = cs._bound_ms(nbytes, ops, "bf16")
            kern = cs._device_ms(torch, lambda: A.flash_attention_fwd(q, k, v),
                                 cs._flash_kernels("fwd", "bf16", splits))
            lib = cs._session_device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
            _emit({"shape": [B, H, N, d], "splits": splits, "kernel_device_ms": kern,
                   "library_device_ms": lib,
                   "kernel_ms": cs._time_ms(torch, lambda: A.flash_attention_fwd(q, k, v)),
                   "ratio": None if not (kern and lib) else kern / lib,
                   "bound_ms": bound, "bound_by": by})
    if "--sweep" in argv:
        for B, H, N, d in SWEPT:
            q, k, v = _qkv(torch, gen, B, H, N, d, True)
            times = {}
            for S in range(1, min(cs.SWEEP_MAX_SPLITS, -(-N // A._fwd_key_tile(d)) // 2) + 1):
                with mock.patch.object(A, "_long_splits", lambda *_, S=S: (S, S)):
                    times[S] = cs._device_ms(torch, lambda: A.flash_attention_fwd(q, k, v),
                                             cs._flash_kernels("fwd", "bf16", S))
            _emit({"sweep": [B, H, N, d], "policy": A._long_splits(B, H, N, d)[0],
                   "device_ms": times})
    if "--trace" in argv:
        _trace(torch, A, _build, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

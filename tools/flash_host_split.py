#!/usr/bin/env python3
"""Where a flash call's wall time goes, on one CUDA card: the host's share
by phase beside the device's.

    python3 tools/flash_host_split.py [--root DIR] [--costs] [--json FILE]
    python3 tools/flash_host_split.py --compare PARENT_DIR [--rounds N] [--out DIR]

For each call of ``chip_smoke.HOST_SHAPES`` (the small shapes of the port's
paths, where a call's wall time is the host's) prints one JSON line: card
ms (CUDA events around 20 back-to-back calls, the median of 7 such
windows, ``chip_smoke._median_time_ms``), the
device ms of its kernels (``chip_smoke._device_ms``), the library call's
card ms, and the wrapper's host time by phase in ns a call: each phase
timed with ``time.perf_counter_ns`` over 200 calls queued behind a spin of
the card, so no phase waits on it (``chip_smoke.host_split``).

``--root DIR`` imports the port from DIR, a checkout of another commit
(``git archive`` of the parent unpacked under ``build/``): where that
module has no launch cache (the wrapper that encoded every tensor map a
call), its phases are timed as that wrapper ran them (``_phases_encoding``).
``--costs`` also builds ``tools/host_costs.cu`` and prints the host cost of
each driver or runtime call made inside the ctypes call: a tensor map's
encode, a cached map's copy with its address replaced,
``cudaFuncSetAttribute``, a launch with four and with six tensor maps,
``cudaGetDevice``. ``--json FILE`` writes every record to FILE as well
(``--dump`` adds a hash of the outputs of every ``check_k2``/``check_k4``
case). ``--compare PARENT_DIR`` runs this tool on PARENT_DIR and on this
checkout in turns (parent, change, change, parent; ``--rounds`` pairs),
one process each (their records in ``--out``, default ``build/
host_compare``), and prints each call's card ms under both with their
ratio, the device ms at the ViT training shape, and whether every
``check_k2``/``check_k4`` case's outputs are bit-identical at an unchanged
split count.
"""

from __future__ import annotations

import array
import ctypes
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port from --root (default: this checkout); chip_smoke.py from this
# checkout whatever the root
PKG_ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1]) if "--root" in sys.argv \
    else ROOT
sys.path.insert(0, PKG_ROOT)
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

ns = time.perf_counter_ns


def _phases_encoding(torch, A, direction, args):
    """One call of the wrapper that encoded every tensor map a call (16 or
    21 ctypes arguments, geometry rebuilt in Python), step by step: returns
    ``{phase: ns}``. Only for inputs that need no padded copy."""
    t = [ns()]
    if direction == "fwd":
        q, k, v = args
        A._check_inputs(q, k, v)
        A._check_kernel_shape(q)
        any(x.stride(-1) != 1 for x in (q, k, v))
    else:
        q, k, v, out, lse, dout = args
        A._check_inputs(q, k, v, out, dout)
        _ = lse.shape != q.shape[:3] or lse.dtype != torch.float32 or lse.device != q.device
        A._check_kernel_shape(q)
        q, k, v, out, dout = (x if x.stride(-1) == 1 else x.contiguous()
                              for x in (q, k, v, out, dout))
        lse = lse.contiguous()
    t.append(ns())
    B, H, N, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bf16 = q.dtype == torch.bfloat16
    if direction == "fwd":
        rows = (A._ROW_TILE,) + (A._fwd_key_tile(d, bf16),) * 2
        geos = A._tma_geometries((q, k, v), rows)
        splits = A._long_splits(B, H, N, d, bf16)[0]
    else:
        rows = A._bwd_tile(d, bf16)
        geos = A._tma_geometries((q, k, v, out, dout), rows)
        splits = A._long_splits(B, H, N, d, bf16)[1]
    t.append(ns())
    if direction == "fwd":
        o = A._heads_view(B, H, N, d, q)
        lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
        part, part_ptr = A._partials(B * H * N * (d + 1), splits, q)
        outs = (o,)
    else:
        outs = tuple(A._heads_view(B, H, N, d, q) for _ in range(3))
        dcap = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
        part, part_ptr = A._partials(3 * B * H * N * d, splits, q)
    t.append(ns())
    if direction == "fwd":
        strides = A._strides(q, k, v, o)
        geos.append(A._tma_geometry(o, A._ROW_TILE))
    else:
        strides = A._strides(q, k, v, out, dout, *outs)
        geos += [A._tma_geometry(x, rows) for x in outs]
    tma = array.array("q", [x for g in geos for f in g for x in f])
    t.append(ns())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    t.append(ns())
    if direction == "fwd":
        lib = A._fwd_library()
        status = lib.dfdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, N,
            d, int(bf16), strides.buffer_info()[0], scale, splits, part_ptr, stream,
            tma.buffer_info()[0])
    else:
        lib = A._bwd_library()
        dq, dk, dv = outs
        status = lib.dfdt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
            N, d, int(bf16), strides.buffer_info()[0], scale, splits, part_ptr, stream,
            tma.buffer_info()[0])
    t.append(ns())
    A._build.check(lib, status, "flash")
    f = A.flash_attention_fwd if direction == "fwd" else A.flash_attention_bwd
    with A._count_lock:
        f.launches += 1
        f.launches_long += int(N > A._SHORT_MAX)
        f.launches_split += int(splits > 1)
        f.launches_f32 += int(not bf16)
        by = f.launches_by_device
        by[q.device.index] = by.get(q.device.index, 0) + 1
    t.append(ns())
    names = ("checks", "geometry", "alloc", "arrays", "stream", "ctypes_call", "counters")
    return {n: b - a for n, a, b in zip(names, t, t[1:])}


def _costs(torch, A):
    """Host ns of each driver or runtime call inside the ctypes call, from
    ``tools/host_costs.cu`` built on this machine: bf16 and f32 maps at the
    (8, 12, 197, 64) ViT request's strided q."""
    from deepfake_video_detection_tpu_torch.ops import _build

    src = os.path.join(ROOT, "tools", "host_costs.cu")
    out = _build.BUILD_DIR / "libhost_costs.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-o", str(out), src], check=True)
    lib = ctypes.CDLL(str(out))
    lib.host_costs.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = ("encode", "copy_and_replace_address", "set_attribute", "launch_4_maps",
             "launch_6_maps", "get_device")
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q = cs._fwd_inputs(torch, gen, 8, 12, 197, 64, dt, True)[0]
        geo = array.array("q", [x for f in A._tma_geometry(q, 64) for x in f])
        res = (ctypes.c_double * 6)()
        smem = A._fwd_smem(64, name == "bf16")
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.host_costs(res, 2000, q.data_ptr(), geo.buffer_info()[0],
                                int(name == "f32"), smem, stream)
        torch.cuda.synchronize()
        cs._emit({"host_costs_ns": dict(zip(names, list(res))), "dtype": name,
                  "status": status})


def _hash(torch, ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _dump(torch, A):
    """A hash of the outputs of every check_k2 and check_k4 case, inputs
    made as those checks make them, with the split count of each call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = []
    for B, H, N, d, name, strided, _ in cs.K2_SPECS:
        q, k, v = cs._fwd_inputs(torch, gen, B, H, N, d, cs._dtype(torch, name), strided)
        recs.append({"case": ["fwd", B, H, N, d, name, strided],
                     "splits": A._long_splits(B, H, N, d, name == "bf16")[0],
                     "hash": _hash(torch, A.flash_attention_fwd(q, k, v))})
    for B, H, N, d, name, strided, _ in cs.K4_SPECS:
        args = cs._bwd_inputs(torch, A, gen, B, H, N, d, cs._dtype(torch, name), strided)
        recs.append({"case": ["bwd", B, H, N, d, name, strided],
                     "splits": A._long_splits(B, H, N, d, name == "bf16")[1],
                     "hash": _hash(torch, A.flash_attention_bwd(*args))})
    return recs


def run(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_host_split: no CUDA device", file=sys.stderr)
        return 2
    from deepfake_video_detection_tpu_torch.ops import attention as A

    recs = [{"nvidia_smi": cs._smi(), "torch": torch.__version__,
             "package": os.path.dirname(os.path.dirname(os.path.dirname(A.__file__))),
             "launch_cache": hasattr(A, "_clear_launch_caches")}]
    cs._emit(recs[0])
    torch.cuda.synchronize()
    phases = None if recs[0]["launch_cache"] else _phases_encoding
    recs += cs.flash_host(torch, A, phases=phases)
    recs += cs.flash_main_device(torch, A)
    if "--dump" in argv:
        recs.append({"outputs": _dump(torch, A)})
    if "--costs" in argv:
        _costs(torch, A)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(recs, f)
    return 0


def compare(parent: str, rounds: int, out: str) -> int:
    """parent, change, change, parent (``rounds`` times), one process each,
    each writing its records under ``out``; then each call's card ms under
    both, their ratio, and the outputs."""
    os.makedirs(out, exist_ok=True)
    roots = {"parent": os.path.abspath(parent), "change": ROOT}
    order = ["parent", "change", "change", "parent"] * rounds
    runs = {"parent": [], "change": []}
    for i, who in enumerate(order):
        path = os.path.join(out, f"{i}_{who}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--root", roots[who], "--json", path]
        if i < 2:
            cmd.append("--dump")
        r = subprocess.run(cmd, cwd=roots[who], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        with open(path) as f:
            runs[who].append(json.load(f))
    cs._emit({"order": order, "nvidia_smi": runs["change"][0][0]["nvidia_smi"]})

    def by_call(recs, phase):
        return {json.dumps([r["direction"], r["shape"], r["dtype"]]): r
                for r in recs if r.get("phase") == phase}

    for key in ("flash_host", "flash_main_device"):
        field = "card_ms" if key == "flash_host" else "device_ms"
        calls = by_call(runs["change"][0][1:], key)
        for call in calls:
            par = [by_call(r[1:], key)[call][field] for r in runs["parent"]]
            chg = [by_call(r[1:], key)[call][field] for r in runs["change"]]
            rec = {"compare": key, "call": json.loads(call), f"parent_{field}": par,
                   f"change_{field}": chg}
            if None not in par + chg:
                rec["ratio_of_means"] = (sum(chg) / len(chg)) / (sum(par) / len(par))
            if key == "flash_host":
                lib = [by_call(r[1:], key)[call]["library_card_ms"] for r in runs["change"]]
                rec["change_over_library_card_ms"] = sum(chg) / sum(lib)
            cs._emit(rec)
    dumps = [next(x["outputs"] for x in runs[w][0] if "outputs" in x)
             for w in ("parent", "change")]
    same, differ, resplit = 0, [], []
    for a, b in zip(*dumps):
        if a["splits"] != b["splits"]:
            resplit.append({"case": a["case"], "splits": [a["splits"], b["splits"]],
                            "identical": a["hash"] == b["hash"]})
        elif a["hash"] == b["hash"]:
            same += 1
        else:
            differ.append(a["case"])
    cs._emit({"outputs_identical_at_same_splits": same, "differ": differ,
              "split_count_changed": resplit})
    return 1 if differ else 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--compare" in argv:
        n = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 1
        out = argv[argv.index("--out") + 1] if "--out" in argv \
            else os.path.join(ROOT, "build", "host_compare")
        sys.exit(compare(argv[argv.index("--compare") + 1], n, os.path.abspath(out)))
    sys.exit(run(argv))

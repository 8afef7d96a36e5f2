"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a file builds in seconds). All missing
libraries are compiled together, one ``nvcc`` process per source, into
``build/torch_kernels/`` at the repository root. A library's file name
carries a hash of its source and of the shared headers (``csrc/*.cuh``),
so an edited kernel or header is rebuilt and a stale one is never loaded.
Nothing is built at import time: the first launch of a kernel builds it,
or a caller builds all of them up front with :func:`build_all`.

There is no fallback: without ``nvcc``, or when a build fails, this raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("normalize.cu", "flash_fwd.cu", "flash_bwd.cu")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (registers, shared memory and spills from -Xptxas -v) for
# each source built by this process
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, CUDA_PATH): the "
                           "port's CUDA kernels cannot be built")
    return path


def library_path(source: str) -> Path:
    """The library of ``source``, named by a hash of the source and of every
    header under ``csrc/``, so an edit to either rebuilds it."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source in ``sources`` whose library is missing, all
    at once. Returns the wall seconds of each build (0.0 if it existed)."""
    sources = list(sources)
    todo = [s for s in sources if not library_path(s).exists()]
    secs = {s: 0.0 for s in sources}
    if not todo:
        return secs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs.append((src, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        secs[src] = time.perf_counter() - t0
        build_log[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return secs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all([source])
            lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry of ``lib``
    (every library exports ``dfdt_error_string``)."""
    if status != 0:
        fn = lib.dfdt_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} at launch "
                           f"({fn(status).decode()})")

"""Locate, build when missing, and load the repository's native libraries.

The C++ video decoder (``native/videodec.cc``) and Haar scan
(``native/haar.cc``) are shared with the JAX package, whose builds are
committed under ``native/build/``. The port loads those read-only and never
writes under ``native/``. Only where a committed library is missing does it
compile the source with ``g++`` into ``build/native/`` at the repository
root, once: there is no rebuild on modification time, since mtimes after a
checkout are arbitrary and a rebuild needs headers that a host may lack.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Dict, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO_ROOT, "native")
COMMITTED_DIR = os.path.join(NATIVE_DIR, "build")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, BaseException] = {}


def library_path(name: str, sources: Sequence[str], link: Sequence[str] = ()) -> str:
    """The committed ``native/build/<name>`` if it exists, else
    ``build/native/<name>``, compiled from ``sources`` (file names under
    ``native/``) with ``g++`` if that is missing too."""
    committed = os.path.join(COMMITTED_DIR, name)
    if os.path.exists(committed):
        return committed
    built = os.path.join(BUILD_DIR, name)
    if not os.path.exists(built):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{built}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp,
               *(os.path.join(NATIVE_DIR, s) for s in sources), *link]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", None) or str(e)
            raise OSError(f"failed to build {built}: {detail}") from e
        os.replace(tmp, built)
    return built


def load(name: str, sources: Sequence[str], link: Sequence[str],
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Load ``name`` once per process and set its signatures with ``bind``.
    A failure (no library and no build, or a dependency the loader cannot
    find) raises ``OSError`` naming the library, and raises again at every
    later call without retrying the build."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name in _libs:
            return _libs[name]
        if name in _errors:
            raise OSError(str(_errors[name]))
        try:
            path = library_path(name, sources, link)
            lib = ctypes.CDLL(path)
        except OSError as e:
            _errors[name] = OSError(f"cannot load the native library {name}: {e}")
            raise _errors[name] from e
        bind(lib)
        _libs[name] = lib
        return lib

"""The PyTorch port stands alone: it never imports JAX or the JAX package."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "deepfake_video_detection_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import deepfake_video_detection_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
assert {port.__name__ + m for m in (
    ".nn.quant", ".serve.saliency", ".train.progressive", ".train.lr_finder",
    ".train.cli_improved", ".evals.validate_improvements",
    ".models.feature_extractors", ".data.video", ".data.haar_native", ".data.haar",
    ".data.faces", ".models.mtcnn", ".data.prepare", ".data.video_dataset",
    ".serve.app", ".serve.jobs", ".serve.auth", ".serve.auth_sqlite", ".serve.chat",
    ".serve.templates", ".serve.detector", ".agents.active_learning", ".agents.telemetry",
    ".utils.profiling", ".nn.moe", ".models.vlm_gan", ".parallel.mesh",
    ".parallel.multihost", ".parallel.strategy", ".parallel.pipeline",
    ".ops.ring_attention", ".ops.ulysses_attention")} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "deepfake_video_detection_tpu"
       or m.startswith("deepfake_video_detection_tpu.")]
print(len(names), bad)
"""


def test_port_imports_no_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15            # every module of the port was imported
    assert bad == "[]", bad


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_of_the_port_names_jax():
    """Static check, lazy imports inside functions included."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "deepfake_video_detection_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"

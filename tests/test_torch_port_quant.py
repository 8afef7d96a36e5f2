"""Int8 weights at rest (``nn/quant.py``, ``QUANTIZE=int8``, the evaluator's
``--quantize int8``) against the JAX package's, on the CPU, f32.

The port quantizes torch layouts (output channel on axis 0 of ``(out, in)``
and OIHW weights), the JAX package ``(out, in)`` and HWIO (axis 3): after
the HWIO → OIHW transpose each ``q`` and ``s`` must be byte for byte JAX's,
and the two packages must pick the same weights. Trees are JAX ``eval_shape``
trees filled by numpy (``random_variables``); the JAX loader and evaluator
build their templates from zeros (their values fill no compared key), which
spares an eager B0 ``init``. The JAX side compiles four small programs: a
ViT-Tiny forward and saliency function, and a B0 forward in the Predictor
and in the evaluator.
"""

import csv
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from deepfake_video_detection_tpu.checkpoint import store as jax_store
from deepfake_video_detection_tpu.evals import evaluate as jax_evaluate
from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.models.backbone_detector import EnsembleDetector as JaxEnsemble
from deepfake_video_detection_tpu.models.temporal_transformer import (
    TemporalTransformerDetector as JaxTemporal)
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.nn import quant as jax_quant
from deepfake_video_detection_tpu.serve import loader as jax_loader
from deepfake_video_detection_tpu.serve import predict as jax_predict
from deepfake_video_detection_tpu.serve import saliency as jax_saliency
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.evals import evaluate as port_evaluate
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector)
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector)
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.nn import quant
from deepfake_video_detection_tpu_torch.nn.init import shapes_only
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.serve import predict as port_predict
from deepfake_video_detection_tpu_torch.serve.saliency import make_saliency_fn

from test_torch_port_convnets import random_variables

SIZE, T = 32, 2
ATOL = 5e-4           # logits and prob_fake of the quantized models


@pytest.fixture(autouse=True, scope="module")
def jax_templates_without_draws():
    """The JAX loader and evaluator build templates with an eager ``init``,
    which compiles every random op on the CPU (tens of seconds for B0);
    zeros of the same shapes fill the same keys."""
    def zeros_init(orig):
        def init(self, rng):
            shapes = jax.eval_shape(functools.partial(orig, self), rng)
            return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
        return init

    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxDetector, JaxEnsemble):
            mp.setattr(cls, "init", zeros_init(cls.init))
        yield


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    for k in ("COMPUTE_DTYPE", "QUANTIZE", "FAKE_CLASS_INDEX"):
        monkeypatch.delenv(k, raising=False)


def _oihw(a: np.ndarray) -> np.ndarray:
    """A JAX leaf in the port's layout: HWIO → OIHW for 4-D."""
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _oihw_to_jax(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _jax_int8_leaves(tree, prefix=""):
    """``{dotted name: Int8Weight}`` of a quantized JAX params tree."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, jax_quant.Int8Weight):
            out[name] = v
        elif isinstance(v, dict):
            out.update(_jax_int8_leaves(v, name + "."))
    return out


def _port_int8(model):
    return {name: m for name, m in model.named_modules()
            if isinstance(m, quant.Int8Weight)}


def _assert_same_int8(port_w, jax_w, name):
    q, s = np.asarray(jax_w.q), np.asarray(jax_w.scale)
    assert port_w.q.dtype == torch.int8 and port_w.scale.dtype == torch.float32, name
    assert port_w.q.numpy().tobytes() == np.ascontiguousarray(_oihw(q)).tobytes(), name
    assert port_w.scale.numpy().tobytes() == np.ascontiguousarray(_oihw(s)).tobytes(), name


@pytest.mark.parametrize("shape", [(96, 48), (16, 8, 3, 3)], ids=["linear", "conv"])
def test_quantize_weight_is_byte_equal_to_jax(shape):
    """One weight with an all-zero output channel: the same ``q`` and ``s``
    (``s`` = 1 there) and the same dequantized values, within ``s / 2`` of
    the weight."""
    w = np.random.default_rng(0).normal(0, 0.05, shape).astype(np.float32)
    w[3] = 0.0                                     # output channel 3, port layout
    jw = jax_quant.quantize_weight(jnp.asarray(_oihw_to_jax(w)))
    qw = quant.quantize_weight(torch.from_numpy(w))
    _assert_same_int8(qw, jw, str(shape))
    assert qw.scale.shape == (shape[0],) + (1,) * (len(shape) - 1)
    assert float(qw.scale[3].reshape(())) == 1.0 and not qw.q[3].any()
    deq = qw.to(torch.float32)
    np.testing.assert_array_equal(deq.numpy(), _oihw(np.asarray(jw.astype(jnp.float32))))
    assert bool((deq - torch.from_numpy(w)).abs().le(qw.scale / 2 + 1e-8).all())
    # a bf16 read multiplies in f32 and rounds once
    assert torch.equal(qw.to(torch.bfloat16), deq.to(torch.bfloat16))


def _small_vit_pair(seed):
    jmodel = JaxDetector("vit_tiny_patch16_224")
    jmodel.backbone = JaxViT(variant="vit_tiny_patch16_224", img_size=SIZE, depth=2)
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    model.backbone = VisionTransformer("vit_tiny_patch16_224", img_size=SIZE, depth=2,
                                       device="cpu")
    variables = random_variables(jmodel, seed)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model.eval()


FAMILIES = {
    "vit_tiny": (lambda: JaxDetector("vit_tiny_patch16_224"),
                 lambda: BackboneDetector("vit_tiny_patch16_224", device="cpu")),
    "efficientnet_b0": (lambda: JaxDetector("efficientnet_b0"),
                        lambda: BackboneDetector("efficientnet_b0", device="cpu")),
    "ensemble": (JaxEnsemble, lambda: EnsembleDetector(device="cpu")),
    "temporal": (JaxTemporal, lambda: TemporalTransformerDetector(device="cpu")),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_weights_match_jax(family):
    """Full-size models at their defaults (the ensemble B0 + resnet18, the
    temporal transformer over B0): the same weights quantized, each ``q``
    and ``s`` byte-equal to JAX's, the same count and the same bytes at
    rest."""
    make_jax, make_port = FAMILIES[family]
    variables = random_variables(make_jax(), 7)
    vq, n_ref = jax_quant.quantize_variables(variables)
    model = make_port()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    before = quant.quantized_bytes(model)
    n = quant.quantize_module(model)
    ref, ours = _jax_int8_leaves(vq["params"]), _port_int8(model)
    assert n == n_ref == len(ref) > 0
    assert sorted(ours) == sorted(ref)
    for name, w in ours.items():
        _assert_same_int8(w, ref[name], name)
    assert quant.quantized_bytes(model) == jax_quant.quantized_bytes(vq["params"])
    assert before[0] == before[1] == jax_quant.quantized_bytes(variables["params"])[0]
    # the f32 weights are gone: no parameter of the quantized names is left
    params = dict(model.named_parameters())
    assert not any(name in params for name in ours)


def test_quantized_forward_and_explain_match_jax():
    """A quantized ViT-Tiny (two blocks, 32 px): logits within 5e-4 of JAX's
    quantized forward, saliency grids within 1e-4 of JAX's on the quantized
    tree; ``dequantize`` restores f32 parameters that give the same
    logits."""
    jmodel, variables, model = _small_vit_pair(3)
    vq, n_ref = jax_quant.quantize_variables(variables)
    assert quant.quantize_module(model) == n_ref
    frames = np.random.default_rng(3).integers(0, 256, (2, T, SIZE, SIZE, 3), np.uint8)
    x = (frames / 255.0 - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])
    x = x.astype(np.float32)
    (ref, _), _ = jax.jit(lambda v, x: jmodel.apply(v, x))(vq, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)

    sal_ref = jax.jit(jax_saliency.make_saliency_fn(jmodel, fake_idx=1))(vq, frames)
    sal = make_saliency_fn(model, fake_idx=1)(torch.from_numpy(frames))
    np.testing.assert_allclose(sal.numpy(), np.asarray(sal_ref), atol=1e-4, rtol=0)
    assert all(p.grad is None for p in model.parameters())

    assert quant.dequantize(model) == n_ref and not _port_int8(model)
    with torch.no_grad():
        torch.testing.assert_close(model(torch.from_numpy(x))[0], got, atol=0, rtol=0)


@pytest.fixture(scope="module")
def b0_checkpoint(tmp_path_factory):
    """A seeded B0 detector tree as the JAX package's ``.npz`` and as a
    reference ``.pt``."""
    variables = random_variables(JaxDetector("efficientnet_b0"), 11)
    root = tmp_path_factory.mktemp("b0q")
    meta = {"model_config": {"model_type": "pretrained", "backbone": "efficientnet_b0"}}
    paths = {"npz": str(root / "checkpoint_best.npz"), "pt": str(root / "b0.pt")}
    jax_store.save_checkpoint(paths["npz"], variables, meta=meta)
    jax_store.save_torch_checkpoint(paths["pt"], variables, layout="model_config", meta=meta)
    return paths


def test_loader_quantize_int8_matches_jax(b0_checkpoint, monkeypatch):
    """``QUANTIZE=int8``: the port's loader quantizes the same count as JAX's
    from the ``.npz`` and the ``.pt``, and serves JAX's quantized
    ``prob_fake``; ``none`` and an unknown value serve f32."""
    for k, v in {"SERVE_WARMUP": "0", "MIN_FACES": "1", "DETECT_ABSTAIN_CONF": "0",
                 "SERVE_DP": "0", "MAX_FRAMES": str(T), "QUANTIZE": "int8"}.items():
        monkeypatch.setenv(k, v)
    jm, jv, jstats = jax_loader.load_model(b0_checkpoint["npz"])
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    jpred = jax_predict.Predictor(jm, jv, jstats["model_type"], extractor=extractor)
    faces = np.random.default_rng(12).integers(0, 256, (T, SIZE, SIZE, 3), np.uint8)
    ref = jpred.predict_faces(faces, "clip")
    for kind in ("npz", "pt"):
        model, sd, stats = port_loader.load_model(b0_checkpoint[kind], device="cpu")
        assert stats["quantized_weights"] == jstats["quantized_weights"] > 10, kind
        assert stats["match_ratio"] == 1.0 and sorted(_port_int8(model)) == sorted(
            _jax_int8_leaves(jv["params"]))
        pred = port_predict.Predictor(model, sd, stats["model_type"], extractor=extractor,
                                      device="cpu")
        got = pred.predict_faces(faces, "clip")
        pred.close()
        assert got["prediction"] == ref["prediction"], kind
        assert got["prob_fake"] == pytest.approx(ref["prob_fake"], abs=ATOL), kind
    for mode in ("none", "int4"):
        monkeypatch.setenv("QUANTIZE", mode)
        model, _, stats = port_loader.load_model(b0_checkpoint["npz"], device="cpu")
        assert stats["quantized_weights"] == 0 and not _port_int8(model), mode


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Four clips of 3 frames at 32 px, half labelled fake."""
    d = tmp_path_factory.mktemp("qclips")
    rng = np.random.default_rng(13)
    for i in range(4):
        np.savez(d / f"clip_{i}.npz", label=np.int64(i % 2),
                 faces=rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8))
    return str(d)


def _csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_evaluator_quantize_int8_matches_jax(b0_checkpoint, clips, tmp_path, capsys):
    """``--quantize int8``: the same ``quantized_weights=N`` in the first
    line and the same CSV as the JAX evaluator, ``prob_fake`` within
    5e-4."""
    args = ["--data_dir", clips, "--checkpoint", b0_checkpoint["npz"], "--num_frames",
            str(T), "--batch_size", "2", "--quantize", "int8"]
    ref_csv, our_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    assert jax_evaluate.main(args + ["--out_csv", ref_csv]) == 0
    ref_line = capsys.readouterr().out.splitlines()[0]
    assert port_evaluate.main(args + ["--out_csv", our_csv, "--device", "cpu"]) == 0
    our_line = capsys.readouterr().out.splitlines()[0]
    assert "quantized_weights=" in ref_line
    assert our_line.split()[-1] == ref_line.split()[-1]
    ours, ref = _csv_rows(our_csv), _csv_rows(ref_csv)
    assert [os.path.basename(r["path"]) for r in ours] == \
        [os.path.basename(r["path"]) for r in ref] and len(ours) == 4
    for o, r in zip(ours, ref):
        assert o["label"] == r["label"] and o["pred"] == r["pred"]
        assert float(o["prob_fake"]) == pytest.approx(float(r["prob_fake"]), abs=ATOL)


@pytest.mark.parametrize("backbone", sorted(chip_smoke.INT8_WEIGHTS))
def test_chip_smoke_int8_counts_match_jax(backbone):
    """The counts ``chip_smoke.py`` requires of ``QUANTIZE=int8`` at full
    size (ViT-B/16, B0): the weights JAX's ``quantize_tree`` would pick in
    its ``eval_shape`` tree, and the port's on the ``meta`` device."""
    shapes = jax.eval_shape(JaxDetector(backbone).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    n_ref = sum(jax_quant._is_quantizable(str(path[-1].key), leaf, 4096)
                for path, leaf in leaves)
    with shapes_only():
        model = BackboneDetector(backbone, device="meta")
    n = sum(quant._is_quantizable(name.rsplit(".", 1)[-1], p, 4096)
            for name, p in model.named_parameters())
    assert n == n_ref == chip_smoke.INT8_WEIGHTS[backbone]

"""Saliency (``serve/saliency.py``) and the Predictor's ``explain=True``
against the JAX package's, on the CPU, f32.

Both packages explain the same seeded weights (JAX trees filled by numpy,
``random_variables``) on the same uint8 frames. Only smooth models are used,
ViT-Tiny cut to two blocks at 32 px and EfficientNet-B0 at 32 px: a
saliency map is a gradient, and ResNet's ReLU kinks can take a
pre-activation within f32 rounding of 0 to different sides in the two
packages (``test_torch_port_convtrain.py``'s docstring). The default
14 x 14 grid on 32 px frames crops the trailing 4 pixels (2 x 2 cells). The
JAX side compiles seven small programs: four saliency functions, the
Predictor's forward at batch 1 and 2 and its saliency function.
"""

import numpy as np
import pytest

import jax
import torch

from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.models.backbone_detector import EnsembleDetector as JaxEnsemble
from deepfake_video_detection_tpu.models.temporal_transformer import (
    TemporalTransformerDetector as JaxTemporal)
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.serve import predict as jax_predict
from deepfake_video_detection_tpu.serve import saliency as jax_saliency
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector)
from deepfake_video_detection_tpu_torch.models.cnn_lstm import CNNLSTMHybrid
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector)
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.serve import predict as port_predict
from deepfake_video_detection_tpu_torch.serve import saliency

from test_torch_port_convnets import random_variables

SIZE, T = 32, 2
SAL_ATOL = 1e-4       # saliency grids, port vs JAX
PROB_ATOL = 5e-4      # served prob_fake
PAYLOAD_ATOL = 2e-3   # the payload rounds to 3 decimals: a value can flip a step


def _small_vit():
    return VisionTransformer("vit_tiny_patch16_224", img_size=SIZE, depth=2, device="cpu")


def _small_jax_vit():
    return JaxViT(variant="vit_tiny_patch16_224", img_size=SIZE, depth=2)


def _pair(kind: str, seed: int):
    """A JAX model, its seeded tree, and the port model holding it."""
    if kind == "vit":
        jmodel = JaxDetector("vit_tiny_patch16_224")
        jmodel.backbone = _small_jax_vit()
        model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
        model.backbone = _small_vit()
    elif kind == "b0":
        jmodel = JaxDetector("efficientnet_b0")
        model = BackboneDetector("efficientnet_b0", device="cpu")
    elif kind == "voting":
        names = ("vit_tiny_patch16_224",) * 2
        jmodel = JaxEnsemble(names, ensemble_method="voting")
        for m in jmodel.members:
            m.backbone = _small_jax_vit()
        model = EnsembleDetector(names, ensemble_method="voting", device="cpu")
        for m in model.models:
            m.backbone = _small_vit()
    else:  # temporal
        jmodel = JaxTemporal("vit_tiny_patch16_224", d_model=64, depth=2, num_heads=2)
        jmodel.backbone = _small_jax_vit()
        model = TemporalTransformerDetector("vit_tiny_patch16_224", d_model=64, depth=2,
                                            num_heads=2, device="cpu")
        model.backbone = _small_vit()
    variables = random_variables(jmodel, seed)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model.eval()


def _frames(seed: int, n: int = T):
    return np.random.default_rng(seed).integers(0, 256, (1, n, SIZE, SIZE, 3), np.uint8)


@pytest.fixture
def serve_env(monkeypatch):
    for k, v in {"SERVE_WARMUP": "0", "MIN_FACES": "1", "DETECT_ABSTAIN_CONF": "0",
                 "SERVE_DP": "0", "MAX_FRAMES": str(T)}.items():
        monkeypatch.setenv(k, v)
    for k in ("SERVE_EXPLAIN", "SERVE_EXPLAIN_WARMUP", "FAKE_CLASS_INDEX", "SERVE_WINDOWS"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("kind,seed", [("vit", 0), ("b0", 1), ("voting", 2)])
def test_saliency_grids_match_jax(kind, seed):
    """The default grid, the class-contrastive score and, for the voting
    ensemble, the mean of the member logits (its one-hot output has no
    gradient): the port's grids are JAX's, and none is blank."""
    jmodel, variables, model = _pair(kind, seed)
    frames = _frames(seed)
    ref = np.asarray(jax.jit(jax_saliency.make_saliency_fn(jmodel, fake_idx=1))(
        variables, frames))
    got = saliency.make_saliency_fn(model, fake_idx=1)(torch.from_numpy(frames))
    assert got.shape == ref.shape == (1, T, 14, 14) and got.dtype == torch.float32
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, atol=SAL_ATOL, rtol=0)
    assert float(got.min()) >= 0.0
    np.testing.assert_allclose(got.amax(dim=(2, 3)).numpy(), 1.0, atol=1e-6)
    # the input gradient left no gradient on any parameter
    assert all(p.grad is None for p in model.parameters())


def test_both_class_indices_give_the_same_grid():
    """|grad| of the score and of its negation agree; the index is read at
    every call when not given."""
    _, _, model = _pair("vit", 0)
    frames = torch.from_numpy(_frames(0))
    g1 = saliency.make_saliency_fn(model, fake_idx=1)(frames)
    g0 = saliency.make_saliency_fn(model, fake_idx=0)(frames)
    torch.testing.assert_close(g0, g1, atol=1e-5, rtol=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FAKE_CLASS_INDEX", "0")
        torch.testing.assert_close(saliency.make_saliency_fn(model)(frames), g1,
                                   atol=1e-5, rtol=0)


def test_saliency_runs_under_inference_mode():
    """The serving forwards run under ``torch.inference_mode()``; an explain
    request inside one still gets its gradient."""
    _, _, model = _pair("vit", 0)
    frames = torch.from_numpy(_frames(3))
    plain = saliency.make_saliency_fn(model, fake_idx=1)(frames)
    with torch.inference_mode():
        inside = saliency.make_saliency_fn(model, fake_idx=1)(frames)
    torch.testing.assert_close(inside, plain, atol=0, rtol=0)


class _Quadrant(torch.nn.Module):
    """The fake logit is the pixel sum of the top-left quadrant: its input
    gradient is exactly that quadrant's indicator."""

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        fake = x[:, :, : h // 2, : w // 2].to(torch.float32).sum(dim=(1, 2, 3, 4))
        logits = torch.stack([torch.zeros_like(fake), fake], dim=1)
        return logits, torch.full(x.shape[:2], 1.0 / x.shape[1])


def test_quadrant_stub_lights_exactly_its_quadrant():
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (1, 3, 32, 32, 3), np.uint8))
    sal = saliency.make_saliency_fn(_Quadrant(), grid=(4, 4))(frames)
    assert sal.shape == (1, 3, 4, 4)
    hot = sal[0, :, :2, :2]
    assert bool((hot > 0.99).all()) and bool((sal <= 1.0 + 1e-6).all())
    assert float(sal[0].sum() - hot.sum()) == 0.0


@pytest.mark.parametrize("grids", [
    np.linspace(0, 1, 2 * 3 * 3).reshape(2, 3, 3),
    np.random.default_rng(1).uniform(0, 1, (3, 4, 5)).astype(np.float32)],
    ids=["linspace", "uniform_f32"])
def test_payload_equals_jax(grids):
    assert saliency.saliency_payload(grids) == jax_saliency.saliency_payload(grids)


@pytest.fixture(scope="module")
def vit_served():
    jmodel, variables, _ = _pair("vit", 5)
    return jmodel, variables


def _served_pair(weights, model_type="pretrained"):
    jmodel, variables = weights
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    jpred = jax_predict.Predictor(jmodel, variables, model_type, extractor=extractor)
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    model.backbone = _small_vit()
    ppred = port_predict.Predictor(model, state_dict_from_jax(variables), model_type,
                                   extractor=extractor, device="cpu")
    return jpred, ppred


def _assert_same_explained(ours, ref, plain):
    assert "error" not in ours and sorted(ours) == sorted(ref)
    for key in ("prediction", "verdict_yes_no", "pred_class", "num_faces"):
        assert ours[key] == ref[key] == plain[key], key
    assert ours["prob_fake"] == pytest.approx(ref["prob_fake"], abs=PROB_ATOL)
    assert ours["prob_fake"] == plain["prob_fake"]
    os_, rs = ours["saliency"], ref["saliency"]
    assert sorted(os_) == sorted(rs) == ["frames", "grid", "pipeline_note"]
    assert os_["grid"] == rs["grid"] == [14, 14]
    assert os_["pipeline_note"] == rs["pipeline_note"]
    np.testing.assert_allclose(os_["frames"], rs["frames"], atol=PAYLOAD_ATOL, rtol=0)


def test_predict_faces_explain_matches_jax(vit_served, serve_env):
    """``predict_faces(explain=True)``: the JAX result's keys, its
    ``prob_fake``, its saliency payload (with the RGB-pipeline note of the
    center extractor) and the verdict of the call without explain; then a
    windowed scan explains its deciding window; ``SERVE_EXPLAIN=0`` drops
    the key."""
    jpred, ppred = _served_pair(vit_served)
    faces = _frames(6)[0]
    plain = ppred.predict_faces(faces, "clip")
    assert "saliency" not in plain
    _assert_same_explained(ppred.predict_faces(faces, "clip", explain=True),
                           jpred.predict_faces(faces, "clip", explain=True), plain)

    long_clip = _frames(7, 2 * T)[0]
    ours = ppred._predict_pretrained(long_clip, "long", windows=2, explain=True)
    ref = jpred._predict_pretrained(long_clip, "long", windows=2, explain=True)
    _assert_same_explained(ours, ref, ppred._predict_pretrained(long_clip, "long",
                                                                windows=2))
    assert ours["windows"]["deciding_window"] == ref["windows"]["deciding_window"]

    # packed YUV carries no explanation, as in the JAX package
    packed = np.zeros((T, SIZE * SIZE * 3 // 2), np.uint8)
    assert "saliency" not in ppred._predict_pretrained(packed, "yuv", packed_yuv=True,
                                                       explain=True)
    serve_env.setenv("SERVE_EXPLAIN", "0")
    assert "saliency" not in ppred.predict_faces(faces, "clip", explain=True)
    assert ppred.explain_error is None
    ppred.close()


def test_temporal_model_explains_as_jax(serve_env):
    jmodel, variables, model = _pair("temporal", 8)
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    jpred = jax_predict.Predictor(jmodel, variables, "temporal", extractor=extractor)
    ppred = port_predict.Predictor(model, None, "temporal", extractor=extractor,
                                   device="cpu")
    faces = _frames(9)[0]
    ours, ref = ppred.explain_faces(faces), jpred.explain_faces(faces)
    assert ours["grid"] == ref["grid"] == [14, 14] and len(ours["frames"]) == T
    np.testing.assert_allclose(ours["frames"], ref["frames"], atol=PAYLOAD_ATOL, rtol=0)
    assert "saliency" in ppred.predict_faces(faces, "clip", explain=True)
    ppred.close()


def test_legacy_types_do_not_explain(serve_env):
    """As in the JAX package: ``explain_faces`` is None and the legacy
    result has no saliency key."""
    pred = port_predict.Predictor(CNNLSTMHybrid(device="cpu"), None, "cnn_lstm",
                                  extractor=FaceExtractor(detector="center", face_size=SIZE, device="cpu"),
                                  device="cpu")
    faces = _frames(10)[0]
    assert pred.explain_faces(faces) is None
    assert "saliency" not in pred.predict_faces(faces, "clip", explain=True)
    pred.close()


def test_explain_warmup_leaves_no_inference_tensors(vit_served, serve_env):
    """``SERVE_EXPLAIN_WARMUP=1`` explains a blank clip after the buckets'
    forwards, all under the warmup thread; the model's parameters and
    buffers are normal tensors (autograd cannot save inference tensors) and
    an explain request then succeeds."""
    serve_env.setenv("SERVE_WARMUP", "1")
    serve_env.setenv("SERVE_EXPLAIN_WARMUP", "1")
    _, ppred = _served_pair(vit_served)
    assert ppred.warmup_done.wait(timeout=120)
    assert ppred.warmup_error is None and ppred.explain_error is None
    assert not any(t.is_inference() for t in ppred.model.state_dict().values())
    assert "saliency" in ppred.predict_faces(_frames(11)[0], "clip", explain=True)
    ppred.close()


def test_explain_failure_keeps_the_verdict_and_the_error(vit_served, serve_env):
    _, ppred = _served_pair(vit_served)
    faces = _frames(12)[0]
    plain = ppred.predict_faces(faces, "clip")

    def broken(*a, **kw):
        raise RuntimeError("no gradient")

    serve_env.setattr(port_predict, "make_saliency_fn", broken)
    out = ppred.predict_faces(faces, "clip", explain=True)
    assert "saliency" not in out and out == plain
    assert isinstance(ppred.explain_error, RuntimeError)
    ppred.close()

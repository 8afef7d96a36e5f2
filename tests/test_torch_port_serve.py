"""The port's Predictor vs the JAX package's Predictor, on the CPU, f32.

Both serve the same weights: a ViT-Tiny BackboneDetector cut to two blocks
at 32 px (the backbone is swapped the same way on both sides), an
EfficientNet-B0 detector and the B0 + resnet18 ensemble with the enhanced
agent (JAX trees filled from a seeded numpy generator), with
``SERVE_WARMUP=0``, ``MIN_FACES=1`` and ``DETECT_ABSTAIN_CONF=0``. The JAX
side runs its default XLA attention, the same function as the flash kernel.
"""

import json
import threading

import numpy as np
import pytest

import jax
import torch

from deepfake_video_detection_tpu.agents.enhanced import EnhancedDecisionAgent as JaxAgent
from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.models.backbone_detector import EnsembleDetector as JaxEnsemble
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.serve import predict as jax_predict
from deepfake_video_detection_tpu_torch.agents.enhanced import EnhancedDecisionAgent
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector)
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.serve import predict as port_predict

from test_torch_port_convnets import random_variables

SIZE, T = 32, 4
PROB_ATOL = 5e-4


@pytest.fixture(scope="module")
def weights():
    model = JaxDetector("vit_tiny_patch16_224")
    model.backbone = JaxViT(variant="vit_tiny_patch16_224", img_size=SIZE, depth=2)
    return model, jax.jit(model.init)(jax.random.PRNGKey(0))


@pytest.fixture
def serve_env(monkeypatch):
    for k, v in {"SERVE_WARMUP": "0", "MIN_FACES": "1", "DETECT_ABSTAIN_CONF": "0",
                 "SERVE_DP": "0", "MAX_FRAMES": str(T)}.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _port_model(variables):
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    model.backbone = VisionTransformer(variant="vit_tiny_patch16_224",
                                       img_size=SIZE, depth=2, device="cpu")
    return model, state_dict_from_jax(variables)


def _predictors(weights, checkpoint_path=None):
    jmodel, variables = weights
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    jpred = jax_predict.Predictor(jmodel, variables, "pretrained",
                                  checkpoint_path=checkpoint_path,
                                  extractor=extractor)
    model, sd = _port_model(variables)
    ppred = port_predict.Predictor(model, sd, "pretrained",
                                   checkpoint_path=checkpoint_path,
                                   extractor=extractor, device="cpu")
    return jpred, ppred


def _assert_same(ours, ref):
    assert "error" not in ours and "error" not in ref
    assert sorted(ours) == sorted(ref)
    for key in ("prediction", "verdict_yes_no", "pred_class", "num_faces",
                "abstained", "enhanced_agent"):
        assert ours.get(key) == ref.get(key), key
    for key in ("prob_fake", "prob_real", "confidence", "threshold"):
        assert ours[key] == pytest.approx(ref[key], abs=PROB_ATOL), key
    np.testing.assert_allclose(ours["frame_scores"], ref["frame_scores"],
                               atol=PROB_ATOL)


def test_predict_faces_rgb_matches_jax(weights, serve_env):
    jpred, ppred = _predictors(weights)
    faces = np.random.default_rng(0).integers(0, 256, (T, SIZE, SIZE, 3), np.uint8)
    _assert_same(ppred.predict_faces(faces, "clip"),
                 jpred.predict_faces(faces, "clip"))
    ppred.close()


def test_packed_yuv_matches_jax(weights, serve_env):
    jpred, ppred = _predictors(weights)
    packed = np.random.default_rng(1).integers(
        0, 256, (T, SIZE * SIZE * 3 // 2), np.uint8)
    _assert_same(ppred._predict_pretrained(packed, "clip", packed_yuv=True),
                 jpred._predict_pretrained(packed, "clip", packed_yuv=True))
    ppred.close()


def test_windowed_scan_with_quantiles_matches_jax(weights, serve_env, tmp_path):
    """SERVE_WINDOWS=2: one batched forward over both windows, the verdict
    of the most suspicious one, and the threshold raised by the
    order-statistics correction from ``real_score_quantiles``."""
    serve_env.setenv("SERVE_WINDOWS", "2")
    rng = np.random.default_rng(2)
    real = np.clip(rng.normal(0.45, 0.05, 4000), 0, 1)
    ckpt = tmp_path / "best_model.npz"
    ckpt.write_bytes(b"")
    (tmp_path / "calibration_best.json").write_text(json.dumps({
        "best_thr_accuracy": float(np.quantile(real, 0.9)),
        "real_score_quantiles": np.quantile(real, np.linspace(0, 1, 101)).tolist()}))
    jpred, ppred = _predictors(weights, checkpoint_path=str(ckpt))
    faces = rng.integers(0, 256, (2 * T, SIZE, SIZE, 3), np.uint8)
    ours = ppred._predict_pretrained(faces, "long", windows=2)
    ref = jpred._predict_pretrained(faces, "long", windows=2)
    _assert_same(ours, ref)
    ow, rw = ours["windows"], ref["windows"]
    assert ow["count"] == rw["count"] == 2
    assert ow["deciding_window"] == rw["deciding_window"]
    np.testing.assert_allclose(ow["prob_fake"], rw["prob_fake"], atol=PROB_ATOL)
    oc, rc = ow["threshold_correction"], rw["threshold_correction"]
    assert oc["method"] == rc["method"] != "unavailable"
    assert oc["effective"] == pytest.approx(rc["effective"], abs=1e-6)
    assert oc["effective"] > oc["base"]
    ppred.close()


def _advice_quirk_case(weights, serve_env, tmp_path, quantiles):
    """A windowed request over 2 windows of a clip whose detections came up
    short (5 of 8 frames extracted), with ``real_score_quantiles`` as given."""
    serve_env.setenv("SERVE_WINDOWS", "2")
    ckpt = tmp_path / "best_model.npz"
    ckpt.write_bytes(b"")
    (tmp_path / "calibration_best.json").write_text(json.dumps({
        "best_thr_accuracy": 0.5, "real_score_quantiles": quantiles}))
    jpred, ppred = _predictors(weights, checkpoint_path=str(ckpt))
    faces = np.random.default_rng(7).integers(0, 256, (2 * T, SIZE, SIZE, 3), np.uint8)
    ours = ppred._predict_pretrained(faces, "short", windows=2, n_extracted=5)
    ref = jpred._predict_pretrained(faces, "short", windows=2, n_extracted=5)
    ppred.close()
    _assert_same(ours, ref)
    return ours["windows"], ref["windows"]


def test_cycled_alignment_note_matches_the_reference(weights, serve_env, tmp_path):
    """ROADMAP Queue 3 ruling: the port keeps the reference's ``cycled``
    note, which names dropped detections even where the clip was only
    short."""
    ours, ref = _advice_quirk_case(weights, serve_env, tmp_path,
                                   np.linspace(0.0, 0.6, 11).tolist())
    assert ours["temporal_alignment"] == ref["temporal_alignment"] == "cycled"
    assert ours["note"] == ref["note"] and "dropped" in ours["note"]


def test_unavailable_correction_method_matches_the_reference(weights, serve_env, tmp_path):
    """ROADMAP Queue 3 ruling: with quantiles that leave the threshold as it
    is (every real score below it), the port says ``unavailable`` as the
    reference does, though quantiles exist."""
    ours, ref = _advice_quirk_case(weights, serve_env, tmp_path,
                                   np.linspace(0.0, 0.3, 11).tolist())
    oc, rc = ours["threshold_correction"], ref["threshold_correction"]
    assert oc == rc and oc["method"] == "unavailable" and oc["effective"] == oc["base"]


@pytest.fixture(scope="module")
def convnet_weights():
    """A B0 detector tree and a B0 + resnet18 ensemble tree (32 px)."""
    b0 = JaxDetector("efficientnet_b0")
    ens = JaxEnsemble()
    return {"pretrained": (b0, random_variables(b0, 8)),
            "ensemble_pretrained": (ens, random_variables(ens, 9))}


@pytest.mark.parametrize("model_type", ["pretrained", "ensemble_pretrained"])
@pytest.mark.parametrize("packed_yuv", [False, True])
def test_convnet_predictor_matches_jax(convnet_weights, serve_env, model_type, packed_yuv):
    """B0, and the ensemble with the enhanced agent over its members'
    logits: the same result dict as the JAX Predictor on the same crops."""
    jmodel, variables = convnet_weights[model_type]
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    ensemble = model_type == "ensemble_pretrained"
    jpred = jax_predict.Predictor(jmodel, variables, model_type, extractor=extractor,
                                  enhanced_agent=JaxAgent() if ensemble else None)
    model = (EnsembleDetector(device="cpu") if ensemble
             else BackboneDetector("efficientnet_b0", device="cpu"))
    ppred = port_predict.Predictor(model, state_dict_from_jax(variables), model_type,
                                   enhanced_agent=EnhancedDecisionAgent() if ensemble
                                   else None, extractor=extractor, device="cpu")
    rng = np.random.default_rng(10)
    if packed_yuv:
        faces = rng.integers(0, 256, (T, SIZE * SIZE * 3 // 2), np.uint8)
        ours = ppred._predict_pretrained(faces, "clip", packed_yuv=True)
        ref = jpred._predict_pretrained(faces, "clip", packed_yuv=True)
    else:
        faces = rng.integers(0, 256, (T, SIZE, SIZE, 3), np.uint8)
        ours, ref = ppred.predict_faces(faces, "clip"), jpred.predict_faces(faces, "clip")
    ppred.close()
    oa, ra = ours.pop("enhanced_agent"), ref.pop("enhanced_agent")
    _assert_same(dict(ours, enhanced_agent=None), dict(ref, enhanced_agent=None))
    assert ours["description"] == ref["description"]
    if not ensemble:
        assert oa is ra is None
        return
    assert sorted(oa) == sorted(ra)
    for key in ("is_fake", "alert_level", "explanation"):
        assert oa[key] == ra[key], key
    for key in ("ensemble_prob", "confidence", "uncertainty"):
        assert oa[key] == pytest.approx(ra[key], abs=PROB_ATOL), key
    serve_env.setenv("DISABLE_ENHANCED_AGENT", "1")
    plain = ppred.predict_faces(rng.integers(0, 256, (T, SIZE, SIZE, 3), np.uint8), "c")
    assert plain["enhanced_agent"] is None


def test_agents_match_jax(tmp_path):
    """The port's copies of the numpy agents decide as the JAX package's on
    the same logits; ``InferenceAgent`` runs the port's detector from a
    checkpoint."""
    from deepfake_video_detection_tpu.agents import system as jax_system
    from deepfake_video_detection_tpu_torch.agents import system
    from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint

    rng = np.random.default_rng(11)
    for i in range(24):
        ens, fs = rng.normal(size=2) * 2, rng.uniform(size=T)
        members = [rng.normal(size=2) * 2 for _ in range(2 + i % 2)]
        kw = dict(uncertainty=float(rng.uniform(0, 0.9)),
                  decision_threshold=float(rng.uniform(0.3, 0.7)), fake_class_index=i % 2)
        ours = EnhancedDecisionAgent().process_ensemble_output(ens, members, fs, "v", **kw)
        ref = JaxAgent().process_ensemble_output(ens, members, fs, "v", **kw)
        assert (ours.is_fake, ours.alert_level.name, ours.explanation) == \
            (ref.is_fake, ref.alert_level.name, ref.explanation)
        assert ours.confidence == pytest.approx(ref.confidence, abs=1e-12)
        pred = {"video_id": "v", "probs": rng.dirichlet([1, 1]), "frame_scores": fs,
                **({"pred_class": i % 2, "confidence": 0.8} if i % 3 else {})}
        o, r = system.DecisionAgent().process(pred), jax_system.DecisionAgent().process(pred)
        assert (o.is_fake, o.alert_level.name, o.explanation) == \
            (r.is_fake, r.alert_level.name, r.explanation)

    model = BackboneDetector("efficientnet_b0", device="cpu")
    path = str(tmp_path / "b0.npz")
    save_checkpoint(path, model.state_dict())
    agent = system.InferenceAgent(path, device="cpu")
    logits, scores = agent.process(rng.integers(0, 256, (1, T, SIZE, SIZE, 3), np.uint8))
    assert logits.shape == (1, 2) and scores.shape == (1, T) and np.isfinite(logits).all()


def test_windowed_threshold_matches_jax():
    rng = np.random.default_rng(3)
    real = rng.beta(2.0, 8.0, 5000)
    q = np.quantile(real, np.linspace(0, 1, 101)).tolist()
    for thr in (0.05, 0.2, 0.35, 0.5, 0.9, 1.0):
        for windows in (1, 2, 3, 8, 64):
            for quantiles in (q, None, [], [0.3]):
                assert port_predict.windowed_threshold(thr, windows, quantiles) == \
                    jax_predict.windowed_threshold(thr, windows, quantiles)


def test_batcher_threads_give_unbatched_results(weights, serve_env):
    """Four concurrent requests through the port's micro-batcher return
    what each returns alone, unbatched."""
    serve_env.setenv("SERVE_MICROBATCH", "0")
    model, sd = _port_model(weights[1])
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    alone = port_predict.Predictor(model, sd, "pretrained", extractor=extractor,
                                   device="cpu")
    serve_env.setenv("SERVE_MICROBATCH", "1")
    serve_env.setenv("SERVE_MICROBATCH_WAIT_MS", "200")
    model2, _ = _port_model(weights[1])
    batched = port_predict.Predictor(model2, sd, "pretrained", extractor=extractor,
                                     device="cpu")
    rng = np.random.default_rng(4)
    clips = [rng.integers(0, 256, (T, SIZE, SIZE, 3), np.uint8) for _ in range(4)]
    results = [None] * 4
    barrier = threading.Barrier(4)

    def client(i):
        barrier.wait()
        results[i] = batched.predict_faces(clips[i], f"c{i}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert batched._batcher.items_run == 4
    assert batched._batcher.batches_run < 4          # they did coalesce
    for clip, res in zip(clips, results):
        ref = alone.predict_faces(clip, "ref")
        assert res["prediction"] == ref["prediction"]
        assert res["prob_fake"] == pytest.approx(ref["prob_fake"], abs=1e-5)
        np.testing.assert_allclose(res["frame_scores"], ref["frame_scores"], atol=1e-4)
    batched.close()


def test_messaging_helpers_match_jax():
    cases = [None, {"error": "boom"}, {"abstained": True},
             {"pred_class": 1, "confidence": 0.83, "prediction": "Deepfake",
              "prob_fake": 0.83, "num_faces": 8},
             {"pred_class": 0, "confidence": 0.71, "prediction": "Real",
              "prob_fake": 0.29, "num_faces": 8}]
    for res in cases:
        assert port_predict.simple_english_message(res, "a.mp4") == \
            jax_predict.simple_english_message(res, "a.mp4")
        if res:
            ours = port_predict.simple_english_justification_200_words(res, "a.mp4")
            assert ours == jax_predict.simple_english_justification_200_words(res, "a.mp4")
            assert len(ours.split()) == 200


def test_warmup_runs_every_bucket_and_records_errors(weights, serve_env):
    serve_env.setenv("SERVE_WARMUP", "1")
    serve_env.setenv("SERVE_MICROBATCH_MAX", "4")
    model, sd = _port_model(weights[1])
    calls = []
    original = model.forward

    def spy(x, *a, **kw):
        calls.append(tuple(x.shape[:2]))
        return original(x, *a, **kw)

    model.forward = spy
    pred = port_predict.Predictor(model, sd, "pretrained", device="cpu",
                                  extractor=FaceExtractor(detector="center", face_size=SIZE, device="cpu"))
    assert pred.warmup_done.wait(timeout=120)
    assert pred.warmup_error is None
    # batch 1 and the buckets 2 and 4, each through the YUV and the RGB forward
    assert calls == [(1, T), (1, T), (2, T), (2, T), (4, T), (4, T)]
    pred.close()

    def broken(x, *a, **kw):
        raise RuntimeError("no kernel")

    model.forward = broken
    pred = port_predict.Predictor(model, None, "pretrained", device="cpu",
                                  extractor=FaceExtractor(detector="center", face_size=SIZE, device="cpu"))
    assert pred.warmup_done.wait(timeout=120)
    assert isinstance(pred.warmup_error, RuntimeError)
    pred.close()


def test_serving_dtype_is_bf16_on_the_card_and_f32_on_the_cpu(monkeypatch):
    monkeypatch.delenv("COMPUTE_DTYPE", raising=False)
    assert port_predict.serving_dtype("cuda") == torch.bfloat16
    assert port_predict.serving_dtype("cpu") == torch.float32
    monkeypatch.setenv("COMPUTE_DTYPE", "float32")
    assert port_predict.serving_dtype("cuda") == torch.float32
    monkeypatch.setenv("COMPUTE_DTYPE", "bfloat_16")            # a typo: f32
    assert port_predict.serving_dtype("cuda") == torch.float32


def test_unported_paths_raise(weights, serve_env, monkeypatch):
    model, sd = _port_model(weights[1])
    # cnn_lstm and vit_gcn are served (test_torch_port_legacy.py); an
    # unknown model type raises
    with pytest.raises(ValueError, match="model_type"):
        port_predict.Predictor(model, sd, "logic_rnn", device="cpu")
    pred = port_predict.Predictor(model, sd, "pretrained", device="cpu")
    # predict_video is ported (test_torch_port_video.py holds it against
    # JAX); as there, a failing request comes back as an error dict
    res = pred.predict_video("clip.mp4")
    assert list(res) == ["error"] and "clip.mp4" in res["error"]
    # explain is ported (test_torch_port_explain.py holds it against JAX)
    assert "saliency" in pred.predict_faces(np.zeros((T, SIZE, SIZE, 3), np.uint8),
                                            explain=True)
    pred.close()
    # CUDA asked for and missing: raise, never carry on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_predict.Predictor(model, sd, "pretrained")

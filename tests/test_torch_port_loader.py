"""The port's serving loader and checkpoint readers against the JAX
package's, on the CPU, f32.

Checkpoints are written by the JAX package (its native ``.npz`` and the
reference's three ``.pt`` layouts) from JAX trees filled from a seeded numpy
generator; both loaders read the same file and must pick the same
architecture with the same match ratio, and the port's model must give the
JAX logits. The pinned timm key manifest must import at ratio 1.0 with
nothing unexpected, and a B0 checkpoint written by the port must load into
the JAX package with its batch-norm state.
"""

import functools
import http.server
import json
import os
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.checkpoint import store as jax_store
from deepfake_video_detection_tpu.models.backbone_detector import (
    BackboneDetector as JaxDetector, EnsembleDetector as JaxEnsemble)
from deepfake_video_detection_tpu.serve import loader as jax_loader
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    save_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import (
    _EFFNET_SEQ, canonicalize_detector_keys, import_into_model)
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector)
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.serve import predict as port_predict

from test_torch_port_convnets import random_variables

S = 64
ATOL = 5e-4
MANIFEST = os.path.join(os.path.dirname(__file__), "fixtures",
                        "timm_efficientnet_b0_detector_manifest.json")


@pytest.fixture(autouse=True, scope="module")
def jax_templates_without_draws():
    """The JAX loader builds each candidate's template with an eager
    ``init``, which compiles every random op on the CPU (tens of seconds
    for B0). Its values only fill keys the checkpoint lacks, and no test
    here compares those, so the templates are zeros of the same shapes."""
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
    for k in ("COMPUTE_DTYPE", "QUANTIZE", "MODEL_URL", "CHECKPOINT_URL", "MODEL_PATH",
              "CHECKPOINT_PATH", "MODEL_TYPE", "MODEL_FILENAME"):
        monkeypatch.delenv(k, raising=False)


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x))[0].numpy()


@pytest.fixture(scope="module")
def b0(tmp_path_factory):
    """A JAX B0 detector tree, its logits on one input, and that tree in the
    native store and in the reference's three layouts."""
    jmodel = JaxDetector("efficientnet_b0")
    variables = random_variables(jmodel, 4)
    x = np.random.default_rng(4).normal(size=(1, 2, S, S, 3)).astype(np.float32)
    (logits, _), _ = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    root = tmp_path_factory.mktemp("b0")
    cfg = {"model_config": {"model_type": "pretrained", "backbone": "efficientnet_b0"}}
    paths = {"npz": str(root / "checkpoint_best.npz")}
    jax_store.save_checkpoint(paths["npz"], variables, meta=cfg)
    for layout in ("rich", "model_config", "raw"):
        paths[layout] = str(root / f"b0_{layout}.pt")
        jax_store.save_torch_checkpoint(paths[layout], variables, layout=layout, meta=cfg)
    # the reference's Sequential-wrapped backbone under a DataParallel prefix,
    # with BN's num_batches_tracked
    names = {v: k for k, v in _EFFNET_SEQ.items()}
    seq = {}
    for k, v in jax_store.export_to_torch_state_dict(variables).items():
        parts = k.split(".")
        if parts[0] == "backbone":
            parts[1] = names[parts[1]]
        seq["module." + ".".join(parts)] = torch.from_numpy(np.array(v))
        if k.endswith("running_var"):
            seq["module." + ".".join(parts[:-1] + ["num_batches_tracked"])] = torch.tensor(7)
    paths["sequential"] = str(root / "checkpoint_best_effnet.pt")
    torch.save(seq, paths["sequential"])
    return variables, x, np.asarray(logits), paths


def _same_choice(ours, ref):
    for key in ("model_type", "backbones", "match_ratio", "matched", "missing",
                "unexpected", "shape_mismatch", "fake_class_index"):
        assert ours[key] == ref[key], key


@pytest.mark.parametrize("layout", ["npz", "rich", "model_config", "raw", "sequential"])
def test_load_model_matches_jax_loader(b0, layout):
    _, x, ref_logits, paths = b0
    _, _, ref_stats = jax_loader.load_model(paths[layout])
    model, sd, stats = port_loader.load_model(paths[layout], device="cpu")
    _same_choice(stats, ref_stats)
    assert stats["model_type"] == "pretrained" and stats["match_ratio"] == 1.0
    assert port_loader.LAST_LOAD_STATS == stats
    assert set(sd) == set(model.state_dict())
    np.testing.assert_allclose(_logits(model, x), ref_logits, atol=ATOL, rtol=ATOL)


def test_ensemble_pt_loads_as_in_jax_and_serves(tmp_path, monkeypatch):
    """A B0 + resnet18 ensemble in the reference's ``model_config`` layout:
    same choice as the JAX loader, the JAX logits, and the Predictor
    serves what the loader returns."""
    jmodel = JaxEnsemble()
    variables = random_variables(jmodel, 5)
    x = np.random.default_rng(5).normal(size=(1, 2, 32, 32, 3)).astype(np.float32)
    (ref_logits, _), _ = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    path = str(tmp_path / "ensemble_best.pt")
    jax_store.save_torch_checkpoint(path, variables, layout="model_config", meta={
        "model_config": {"model_type": "ensemble_pretrained",
                         "backbones": ["efficientnet_b0", "resnet18"]}})
    _, _, ref_stats = jax_loader.load_model(path)
    model, sd, stats = port_loader.load_model(path, device="cpu")
    _same_choice(stats, ref_stats)
    assert stats["model_type"] == "ensemble_pretrained"
    assert stats["backbones"] == ("efficientnet_b0", "resnet18")
    np.testing.assert_allclose(_logits(model, x), np.asarray(ref_logits), atol=ATOL, rtol=ATOL)

    for k, v in {"SERVE_WARMUP": "0", "MIN_FACES": "1", "DETECT_ABSTAIN_CONF": "0",
                 "MAX_FRAMES": "2"}.items():
        monkeypatch.setenv(k, v)
    pred = port_predict.Predictor(model, sd, stats["model_type"], checkpoint_path=path,
                                  extractor=FaceExtractor(detector="center", face_size=32, device="cpu"),
                                  device="cpu")
    faces = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3), np.uint8)
    res = pred.predict_faces(faces, "clip")
    pred.close()
    assert res["description"].startswith("Ensemble pretrained detector")
    assert 0.0 <= res["prob_fake"] <= 1.0 and len(res["frame_scores"]) == 2


def test_timm_manifest_imports_at_ratio_1(tmp_path):
    """The pinned 366-key timm B0 detector manifest (Sequential numbering,
    num_batches_tracked): every port key filled, nothing unexpected, through
    the bridge and through both loaders."""
    with open(MANIFEST) as f:
        manifest = json.load(f)
    assert len(manifest) == 366
    rng = np.random.default_rng(0)
    sd = {k: np.asarray(rng.normal(size=shape) * 0.01, np.float32)
          for k, shape in manifest.items()}
    model = BackboneDetector("efficientnet_b0", device="cpu")
    report = import_into_model(model, canonicalize_detector_keys(sd, "efficientnet_b0"))
    assert report["missing"] == [] and report["shape_mismatch"] == []
    assert report["unexpected"] == [] and report["match_ratio"] == 1.0

    path = str(tmp_path / "timm_b0.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    _, _, ref_stats = jax_loader.load_model(path)
    _, _, stats = port_loader.load_model(path, device="cpu")
    _same_choice(stats, ref_stats)
    assert stats["backbones"] == "efficientnet_b0" and stats["unexpected"] == 0


def test_port_b0_checkpoint_loads_into_jax_with_its_bn_state(b0, tmp_path):
    """``save_checkpoint`` writes the BN running stats under ``state.``, as
    the JAX store does, so the JAX package serves the port's weights."""
    variables, x, _, _ = b0
    model = BackboneDetector("efficientnet_b0", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        model.backbone.bn1.running_mean.add_(0.3)
    path = str(tmp_path / "port_b0.npz")
    save_checkpoint(path, model.state_dict(), meta={"model_config": {
        "model_type": "pretrained", "backbone": "efficientnet_b0"}})
    loaded, _ = jax_store.load_checkpoint(path)
    assert "running_mean" in loaded["state"]["backbone"]["bn1"]
    assert "running_mean" not in loaded["params"]["backbone"]["bn1"]
    jmodel = JaxDetector("efficientnet_b0")
    (logits, _), _ = jax.jit(lambda v, x: jmodel.apply(v, x))(loaded, jnp.asarray(x))
    np.testing.assert_allclose(_logits(model, x), np.asarray(logits), atol=ATOL, rtol=ATOL)


def test_ema_sibling_is_served_as_in_jax(b0, tmp_path):
    variables, x, _, _ = b0
    meta = {"metrics_scored_on": "ema", "model_config": {
        "model_type": "pretrained", "backbone": "efficientnet_b0"}}
    raw, ema = str(tmp_path / "checkpoint_best.npz"), str(tmp_path / "checkpoint_best_ema.npz")
    jax_store.save_checkpoint(raw, variables, meta=meta)
    shifted = jax.tree_util.tree_map(lambda a: a * 1.01, variables)
    jax_store.save_checkpoint(ema, shifted, meta=meta)
    _, _, ref_stats = jax_loader.load_model(raw)
    model, _, stats = port_loader.load_model(raw, device="cpu")
    assert stats["path"] == ref_stats["path"] == ema
    ref = BackboneDetector("efficientnet_b0", device="cpu")
    ref.load_state_dict(state_dict_from_jax(shifted), strict=True)
    np.testing.assert_array_equal(_logits(model, x), _logits(ref, x))


def test_autoload_ranking_matches_jax(tmp_path, monkeypatch):
    root = tmp_path / "checkpoints"
    layout = {"dfdc200_run": ["checkpoint_best.npz", "notes.pt"],
              "dfdc_run": ["checkpoint_epoch_3.npz", "checkpoint_best_b.pt"],
              "ensemble_a": ["model.pt", "z.npz"],
              "ensemble_b": ["checkpoint_best.npz"],
              "plain": ["checkpoint_best.pt", "x.npz"],
              "plain/deeper": ["b.npz", "a.npz"]}
    for folder, files in layout.items():
        (root / folder).mkdir(parents=True, exist_ok=True)
        for f in files:
            (root / folder / f).write_bytes(b"")
    (root / "ensemble_b" / "training_history.csv").write_text("epoch,f1\n0,0.5\n1,0.9\n")
    (root / "dfdc200_run" / "calibration_best.json").write_text(
        json.dumps({"best_thr_accuracy": 0.99}))
    ours = port_loader.rank_checkpoints_for_autoload(str(root))
    assert ours == jax_loader.rank_checkpoints_for_autoload(str(root))
    assert len(ours) == 7          # the best pattern class of each folder only
    assert port_loader.pick_best_checkpoint_for_autoload(str(root)) == ours[0]
    assert port_loader.calibration_penalty(str(root / "dfdc200_run")) == 5.0
    monkeypatch.setenv("MODEL_PATH", ours[-1])
    monkeypatch.setenv("MODEL_TYPE", "pretrained")
    assert port_loader.build_autoload_candidates(str(root)) == \
        jax_loader.build_autoload_candidates(str(root))
    # none of the empty files loads
    assert port_loader.attempt_autoload(str(root), device="cpu") is None


def test_download_checkpoint_from_a_loopback_server(tmp_path):
    served = tmp_path / "served"
    served.mkdir()
    (served / "model.pt").write_bytes(b"weights")
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(served))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/model.pt?token=1"
        dest = port_loader.download_checkpoint(url, str(tmp_path / "dl"))
        assert dest == str(tmp_path / "dl" / "model.pt")
        assert open(dest, "rb").read() == b"weights"
        missing = url.replace("model.pt", "absent.pt")
        assert port_loader.download_checkpoint(missing, str(tmp_path / "dl2")) is None
        assert not os.listdir(tmp_path / "dl2")
    finally:
        server.shutdown()
        server.server_close()


def test_unported_checkpoints_raise(b0, tmp_path, monkeypatch):
    paths = b0[3]
    # QUANTIZE=int8 is ported (test_torch_port_quant.py holds it against JAX)
    monkeypatch.setenv("QUANTIZE", "int8")
    _, _, stats = port_loader.load_model(paths["npz"], device="cpu")
    assert stats["quantized_weights"] > 10
    monkeypatch.delenv("QUANTIZE")
    # the cnn_lstm family is ported: a file with only its key prefix is
    # tried as one and matches nothing
    legacy = str(tmp_path / "cnn_lstm.pt")
    torch.save({"cnn.fc.weight": torch.zeros(2, 2)}, legacy)
    with pytest.raises(ValueError, match="no candidate"):
        port_loader.load_model(legacy, device="cpu")
    # the temporal transformer's MoE is ported (test_torch_port_moe.py holds
    # it against JAX): a reference .pt of one loads, its experts read from w1
    moe = str(tmp_path / "temporal_moe.pt")
    src = TemporalTransformerDetector("tinyconv", d_model=32, depth=1, mlp_hidden=64,
                                      moe_experts=4, device="cpu")
    torch.save({"model_state": src.state_dict(),
                "model_config": {"model_type": "temporal", "backbone": "tinyconv"}}, moe)
    model, _, stats = port_loader.load_model(moe, device="cpu")
    assert stats["model_type"] == "temporal" and stats["match_ratio"] == 1.0
    assert model.blocks[0].mlp.w1.shape == (4, 32, 64)

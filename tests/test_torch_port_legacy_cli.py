"""The legacy families' evaluator and CLIs against the JAX package's, on the
CPU: ``build_model_from_checkpoint`` and ``evaluate_dataset`` for the
evaluator's four families, the training CLI's default invocation (vit_gcn
over ViT-Tiny) read back by both packages' loaders, and the ViT-GNN CLIs.
Their checkpoints are at full size (224 px), as those entry points build;
the helpers and tolerances are ``test_torch_port_legacy.py``'s.
"""

import csv
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.data.dataset import VideoFacesDataset as JaxDataset
from deepfake_video_detection_tpu.evals import evaluate as jax_evaluate
from deepfake_video_detection_tpu.evals import infer_vit_gnn as jax_infer_vit_gnn
from deepfake_video_detection_tpu.models.logic_rnn import LogicRNNLSTM as JaxLogicRNN
from deepfake_video_detection_tpu.models.vit_gnn import FallbackModel as JaxFallback
from deepfake_video_detection_tpu.models.vit_gnn import ViTGNNModel as JaxViTGNN
from deepfake_video_detection_tpu.serve import loader as jax_loader
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.evals import evaluate as E
from deepfake_video_detection_tpu_torch.evals import infer_vit_gnn
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.serve import predict as port_predict
from deepfake_video_detection_tpu_torch.train import cli
from deepfake_video_detection_tpu_torch.train import cli_vit_gnn

from test_torch_port_convnets import random_variables
from test_torch_port_legacy import DETECTOR_TOL, SIZE, TINY, _close, _full_size


@pytest.fixture(scope="module")
def eval_clips(tmp_path_factory):
    """3 clips of 2 frames at 224 px, one labelled fake."""
    d = tmp_path_factory.mktemp("legacy_eval")
    rng = np.random.default_rng(13)
    for i in range(3):
        np.savez(d / f"clip_{i}.npz", label=np.int64(i % 2),
                 faces=rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8))
    return str(d)


def _rnn_checkpoint(seed):
    jm = JaxLogicRNN(input_size=96, hidden_size=16, num_layers=2)
    return jm, random_variables(jm, seed)


@pytest.mark.parametrize("family", ["vit_gcn", "cnn_lstm", "rnn", "ensemble"])
def test_evaluator_builds_the_legacy_families(family, eval_clips, tmp_path):
    """``build_model_from_checkpoint`` (model type told by the keys, no
    model_config) and ``evaluate_dataset`` against JAX's. The rnn pipeline's
    ViT extractor is fresh in both packages (drawn differently): the JAX
    pipeline's whole tree is carried over before comparing."""
    if family == "rnn":
        _, v = _rnn_checkpoint(14)
    elif family == "ensemble":
        from deepfake_video_detection_tpu.models.backbone_detector import EnsembleDetector
        v = random_variables(EnsembleDetector(["resnet18", "resnet18"]), 14)
    else:
        _, v, _ = _full_size(family, 14)
    meta = {"model_config": {"backbones": ["resnet18", "resnet18"]}} \
        if family == "ensemble" else {}
    sd = {k: t.numpy() for k, t in state_dict_from_jax(v).items()}
    jmodel, jvars, jreport, jmt = jax_evaluate.build_model_from_checkpoint(sd, meta, "")
    model, report, mt = E.build_model_from_checkpoint(sd, meta, "", device="cpu")
    assert mt == jmt == family
    assert report["match_ratio"] == pytest.approx(jreport["match_ratio"])
    assert sorted(report["matched"]) == sorted(jreport["matched"])
    if family == "rnn":
        assert report["match_ratio"] < 1.0      # the ViT extractor is not in the file
        model.load_state_dict(state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jvars)), strict=True)
    jp, jl, jprob = jax_evaluate.evaluate_dataset(
        jmodel, jvars, JaxDataset(eval_clips, num_frames=2), jmt, batch_size=2)
    p, lab, prob = E.evaluate_dataset(model, VideoFacesDataset(eval_clips, num_frames=2),
                                      batch_size=2, model_type=mt)
    assert p == jp and list(lab) == list(jl)
    np.testing.assert_allclose(prob, jprob, atol=DETECTOR_TOL)




def test_training_cli_default_trains_vit_gcn(eval_clips, tmp_path, monkeypatch):
    """``--data_dir D`` with no model flags trains the frame-graph detector
    (ViT-Tiny, f32, chain adjacency); its checkpoint is read by the port's
    loader, Predictor and evaluator and by the JAX loader."""
    monkeypatch.setenv("SERVE_WARMUP", "0")
    out = tmp_path / "run"
    assert cli.main(["--data_dir", eval_clips, "--epochs", "1", "--batch_size", "2",
                     "--num_frames", "2", "--no-augment", "--out_dir", str(out),
                     "--device", "cpu"]) == 0
    best = str(out / "checkpoint_best.npz")
    model, sd, stats = port_loader.load_model(best, device="cpu")
    assert stats["model_type"] == "vit_gcn" and stats["match_ratio"] == 1.0
    assert model.vit_variant == TINY and model.compute_dtype == torch.float32
    pred = port_predict.Predictor(model, sd, "vit_gcn", checkpoint_path=best, device="cpu")
    res = pred.predict_faces(np.load(os.path.join(eval_clips, "clip_0.npz"))["faces"])
    pred.close()
    assert 0.0 <= res["prob_fake"] <= 1.0 and res["num_faces"] == 2
    out_csv = str(tmp_path / "eval.csv")
    assert E.main(["--data_dir", eval_clips, "--checkpoint", best, "--num_frames", "2",
                   "--out_csv", out_csv, "--device", "cpu"]) == 0
    with open(out_csv) as f:
        assert len(list(csv.DictReader(f))) == 3
    _, _, jstats = jax_loader.load_model(best)
    assert jstats["model_type"] == "vit_gcn" and jstats["match_ratio"] == 1.0


@pytest.mark.parametrize("fallback", [False, True])
def test_vit_gnn_clis_match_jax(fallback, tmp_path):
    """``cli_vit_gnn`` trains and saves a checkpoint the JAX package reads;
    ``infer_vit_gnn`` classifies one face stack as the JAX CLI's model does
    on those weights."""
    ckpt = str(tmp_path / "vit_gnn.npz")
    args = ["--epochs", "2", "--samples", "4", "--img_size", str(SIZE), "--vit", TINY,
            "--out", ckpt, "--device", "cpu"] + (["--fallback"] if fallback else [])
    assert cli_vit_gnn.main(args) == 0
    jmodel, jvars = jax_infer_vit_gnn.build_from_checkpoint(ckpt)
    assert isinstance(jmodel, JaxFallback if fallback else JaxViTGNN)
    faces = np.random.default_rng(16).integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    np.savez(tmp_path / "clip.npz", faces=faces)
    probs = infer_vit_gnn.classify(str(tmp_path / "clip.npz"), ckpt, device="cpu")
    logits, _ = jmodel.apply(jvars, jnp.asarray(faces[1:2].astype(np.float32) / 255.0))
    _close(probs, jax.nn.softmax(logits, -1)[0], DETECTOR_TOL)
    assert infer_vit_gnn.main([str(tmp_path / "clip.npz"), "--checkpoint", ckpt,
                               "--device", "cpu"]) == 0

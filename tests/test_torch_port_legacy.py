"""The port's graph and recurrent detectors against the JAX package's, on
the CPU, f32: the adjacency math, the LSTM, the frame-graph detector
(ViT + GCN), the CNN+LSTM, the logic RNN, the ViT-GNN and its fallback, a
train step of each trainable family (``remat`` on and off, batch-norm
state included), the legacy Predictor path, the loader's family pick and
the port's checkpoints read back by the JAX package
(``test_torch_port_legacy_cli.py``: the evaluator's four families and the
CLIs).

Weights are JAX trees shaped as the JAX ``init``'s and filled from a seeded
numpy generator (``random_variables``), carried to the port through
``checkpoint.bridge.state_dict_from_jax`` into ``load_state_dict(strict=
True)``. Sizes are small: ViT-Tiny cut to two blocks at 32 px (4 patches),
LSTM hidden 32, a few frames; only the loader's, the evaluator's and the
CLI's checkpoints are at full size (224 px), as those entry points build.
Tolerances: 2e-4 for modules, 5e-4 for whole detectors.
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.checkpoint.store import load_checkpoint as jax_load_checkpoint
from deepfake_video_detection_tpu.checkpoint.store import save_checkpoint as jax_save_checkpoint
from deepfake_video_detection_tpu.checkpoint.store import (
    save_torch_checkpoint as jax_save_torch_checkpoint)
from deepfake_video_detection_tpu.models.cnn_lstm import CNNLSTMHybrid as JaxCNNLSTM
from deepfake_video_detection_tpu.models.gcn import FrameGraphDetector as JaxFrameGraph
from deepfake_video_detection_tpu.models.logic_rnn import LogicRNNLSTM as JaxLogicRNN
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.models.vit_gnn import FallbackModel as JaxFallback
from deepfake_video_detection_tpu.models.vit_gnn import ViTGNNModel as JaxViTGNN
from deepfake_video_detection_tpu.nn import layers as JL
from deepfake_video_detection_tpu.serve import predict as jax_predict
from deepfake_video_detection_tpu.train import losses as JLoss
from deepfake_video_detection_tpu.train import optim as JO
from deepfake_video_detection_tpu.train.state import TrainState as JaxTrainState
from deepfake_video_detection_tpu.train.steps import make_train_step as jax_make_train_step
from deepfake_video_detection_tpu.utils import graph as JG
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    save_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.models.cnn_lstm import CNNLSTMHybrid
from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
from deepfake_video_detection_tpu_torch.models.logic_rnn import LogicRNNLSTM
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.models.vit_gnn import FallbackModel, ViTGNNModel
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.serve import predict as port_predict
from deepfake_video_detection_tpu_torch.train import losses as Loss
from deepfake_video_detection_tpu_torch.train import optim as O
from deepfake_video_detection_tpu_torch.train import steps as S
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.utils import graph as G

from test_torch_port_convnets import random_variables

SIZE, T, HIDDEN = 32, 3, 32
MODULE_TOL, DETECTOR_TOL = 2e-4, 5e-4
TINY = "vit_tiny_patch16_224"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got.detach()) if isinstance(got, torch.Tensor)
                               else got, np.asarray(ref), atol=tol, rtol=tol)


def _load(model, variables):
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return model


def _frames(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _chain(n, batch):
    return np.broadcast_to(np.asarray(JG.normalize_adjacency(JG.chain_adjacency(n))),
                           (batch, n, n)).copy()


# ---------------------------------------------------------------------------
# the small models, both sides on one set of weights
# ---------------------------------------------------------------------------


def _graph_pair(vit_out, seed=0, depth=2):
    """ViT-Tiny (two blocks at 32 px) + GCN; ``vit_out`` other than 192
    adds ``vit_proj``."""
    jm = JaxFrameGraph(vit_out=vit_out, gcn_hid=48, gcn_out=24, vit_variant=TINY,
                       img_size=SIZE)
    jm.vit = JaxViT(variant=TINY, img_size=SIZE, num_classes=0, depth=depth)
    v = random_variables(jm, seed)
    pm = FrameGraphDetector(vit_out=vit_out, gcn_hid=48, gcn_out=24, vit_variant=TINY,
                            img_size=SIZE, device="cpu")
    pm.vit = VisionTransformer(TINY, img_size=SIZE, depth=depth, device="cpu")
    return jm, v, _load(pm, v)


def _cnn_lstm_pair(seed=0, dropout=0.3):
    jm = JaxCNNLSTM(hidden_size=HIDDEN, dropout=dropout)
    v = random_variables(jm, seed)
    return jm, v, _load(CNNLSTMHybrid(hidden_size=HIDDEN, dropout=dropout, device="cpu"), v)


def _gnn_pair(seed=0):
    jm = JaxViTGNN(vit_variant=TINY, gnn_hidden=24, img_size=SIZE)
    jm.encoder.vit = JaxViT(variant=TINY, img_size=SIZE, num_classes=0, depth=2)
    v = random_variables(jm, seed)
    pm = ViTGNNModel(vit_variant=TINY, gnn_hidden=24, img_size=SIZE, device="cpu")
    pm.vit = VisionTransformer(TINY, img_size=SIZE, depth=2, device="cpu")
    return jm, v, _load(pm, v)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["chain", "full", "batched", "zero_degree"])
def test_normalize_adjacency_matches_jax(case):
    rng = np.random.default_rng(1)
    if case == "chain":
        A = G.chain_adjacency(7)
        np.testing.assert_array_equal(A, JG.chain_adjacency(7))
    elif case == "full":
        A = G.fully_connected_adjacency(5)
        np.testing.assert_array_equal(A, JG.fully_connected_adjacency(5))
        np.testing.assert_array_equal(G.fully_connected_adjacency(5, True),
                                      JG.fully_connected_adjacency(5, True))
    elif case == "batched":
        A = (rng.uniform(size=(3, 6, 6)) > 0.5).astype(np.float32)
    else:  # a row whose degree, self loop included, is 0
        A = rng.uniform(size=(5, 5)).astype(np.float32)
        A[2] = 0.0
        A[2, 2] = -1.0
    got = G.normalize_adjacency(A)
    assert got.dtype == torch.float32
    _close(got, JG.normalize_adjacency(A), 1e-6)
    if case == "zero_degree":
        assert torch.all(got[2] == 0)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_lstm_matches_jax(num_layers):
    rng = np.random.default_rng(num_layers)
    F_in, H = 12, 8
    layers = []
    for k in range(num_layers):
        d = F_in if k == 0 else H
        layers.append({n: (rng.normal(size=s) / np.sqrt(H)).astype(np.float32)
                       for n, s in (("weight_ih", (4 * H, d)), ("weight_hh", (4 * H, H)),
                                    ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,)))})
    x = rng.normal(size=(3, 5, F_in)).astype(np.float32)
    ref, (h_ref, c_ref) = JL.lstm([{k: jnp.asarray(v) for k, v in p.items()} for p in layers],
                                  jnp.asarray(x))
    got, (h, c) = L.lstm(_t(x), [tuple(_t(p[n]) for n in ("weight_ih", "weight_hh",
                                                            "bias_ih", "bias_hh"))
                                 for p in layers])
    assert got.shape == (3, 5, H) and h.shape == c.shape == (num_layers, 3, H)
    _close(got, ref, MODULE_TOL)
    _close(h, h_ref, MODULE_TOL)
    _close(c, c_ref, MODULE_TOL)
    # torch's own LSTM on the same weights: the gate order is torch's
    ref_t = torch.nn.LSTM(F_in, H, num_layers, batch_first=True)
    with torch.no_grad():
        for k, p in enumerate(layers):
            for n, a in p.items():
                getattr(ref_t, f"{n}_l{k}").copy_(_t(a))
        out_t, _ = ref_t(_t(x))
    _close(got, out_t, MODULE_TOL)


def test_vit_returns_post_norm_patch_tokens():
    jm = JaxViT(variant=TINY, img_size=SIZE, num_classes=0, depth=2)
    v = random_variables(jm, 3)
    pm = _load(VisionTransformer(TINY, img_size=SIZE, depth=2, device="cpu"), v)
    x = _frames(3, (2, SIZE, SIZE, 3))
    ref, _ = jm.apply(v, jnp.asarray(x), return_tokens=True)
    got = pm(_t(x), return_tokens=True)
    assert got.shape == (2, 4, 192)
    _close(got, ref, MODULE_TOL)


@pytest.mark.parametrize("vit_out", [192, 96])
def test_frame_graph_detector_matches_jax(vit_out):
    jm, v, pm = _graph_pair(vit_out)
    assert ("vit_proj.weight" in pm.state_dict()) == (vit_out != 192)
    x, A = _frames(4, (2, T, SIZE, SIZE, 3)), _chain(T, 2)
    ref, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(A))
    got = pm(_t(x), _t(A))
    _close(got, ref, DETECTOR_TOL)
    # the clip/dinov2 flavours build the same encoder from the same draws
    timm = FrameGraphDetector(vit_variant=TINY, img_size=SIZE, device="cpu").state_dict()
    for flavor in ("clip", "dinov2"):
        other = FrameGraphDetector(vit_variant=TINY, img_size=SIZE, backbone=flavor,
                                   device="cpu")
        assert other.backbone_flavor == flavor
        got = other.state_dict()
        assert list(got) == list(timm) and all(torch.equal(got[k], timm[k]) for k in timm)


@pytest.mark.parametrize("train", [False, True])
def test_cnn_lstm_matches_jax(train):
    """Eval mode, and train mode (no dropout) with the new BN state."""
    jm, v, pm = _cnn_lstm_pair(seed=5, dropout=0.0)
    x = _frames(5, (2, T, SIZE, SIZE, 3))
    ref, new_state = jm.apply(v, jnp.asarray(x), train=train)
    got = pm(_t(x), train=train)
    _close(got, ref, DETECTOR_TOL)
    want = state_dict_from_jax({"params": {}, "state": jax.tree_util.tree_map(
        np.asarray, new_state if train else v["state"])})
    for k, t in want.items():
        _close(pm.state_dict()[k], t, MODULE_TOL)
    assert sorted(k for k in pm.state_dict() if k.endswith("running_var")) == \
        sorted(k for k in want if k.endswith("running_var"))


@pytest.mark.parametrize("with_lengths", [False, True])
def test_logic_rnn_matches_jax(with_lengths):
    jm = JaxLogicRNN(input_size=24, hidden_size=16, num_layers=2)
    v = random_variables(jm, 6)
    pm = _load(LogicRNNLSTM(input_size=24, hidden_size=16, num_layers=2, device="cpu"), v)
    x = _frames(6, (3, 5, 24))
    lengths = np.asarray([5, 2, 4]) if with_lengths else None
    ref, _ = jm.apply(v, jnp.asarray(x), None if lengths is None else jnp.asarray(lengths))
    got = pm(_t(x), None if lengths is None else _t(lengths))
    assert got.shape == (3, 1)
    _close(got, ref, MODULE_TOL)


@pytest.mark.parametrize("kind", ["vit_gnn", "fallback"])
def test_vit_gnn_and_fallback_match_jax(kind):
    if kind == "vit_gnn":
        jm, v, pm = _gnn_pair(seed=7)
        assert "A_norm" not in pm.state_dict()
        _close(pm.A_norm, jm._A, 1e-6)
    else:
        jm = JaxFallback()
        v = random_variables(jm, 7)
        pm = _load(FallbackModel(device="cpu"), v)
    x = _frames(7, (2, SIZE, SIZE, 3))
    ref, _ = jm.apply(v, jnp.asarray(x))
    _close(pm(_t(x)), ref, DETECTOR_TOL)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["vit_gcn", "cnn_lstm"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax(family, remat):
    """One SGD step (a clip that triggers; no dropout draws on either side:
    no rng, no generator): loss, grad norm, every parameter and the BN
    running stats, updated once."""
    if family == "vit_gcn":
        jm, v, pm = _graph_pair(192, seed=8)
    else:
        jm, v, pm = _cnn_lstm_pair(seed=8)
    rng = np.random.default_rng(8)
    batch = {"frames": rng.normal(size=(2, T, SIZE, SIZE, 3)).astype(np.float32),
             "labels": np.asarray([0, 1]), "valid": np.asarray([True, True])}
    if family == "vit_gcn":
        batch["adjacency"] = _chain(T, 2)
    cw = np.asarray([0.8, 1.2], np.float32)

    def jloss(logits, labels, sample_mask=None):
        return JLoss.cross_entropy_loss(logits, labels, class_weights=cw,
                                        sample_mask=sample_mask)

    tx = JO.build_optimizer("sgd", 0.5, grad_clip=0.1)
    jstep = jax_make_train_step(jm, tx, jloss, donate=False, remat=remat)
    jstate, jmet = jstep(JaxTrainState.create(v, tx),
                         {k: jnp.asarray(a) for k, a in batch.items()}, None)

    def loss(logits, labels, sample_mask=None):
        return Loss.cross_entropy_loss(logits, labels, class_weights=cw,
                                       sample_mask=sample_mask)

    opt = O.build_optimizer("sgd", 0.5, grad_clip=0.1)
    step = S.make_train_step(pm, opt, loss, remat=remat)
    state, m = step(TrainState.create(pm, opt), {k: _t(a) for k, a in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.variables))
    got = pm.state_dict()
    assert sorted(got) == sorted(ref)
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=k)
    if family == "cnn_lstm":
        # the running stats moved once: as one train forward moves them
        pm2 = _cnn_lstm_pair(seed=8)[2]
        pm2(_t(batch["frames"]), train=True)
        for k in got:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[k].numpy(), pm2.state_dict()[k].numpy(),
                                           rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture
def serve_env(monkeypatch):
    for k, v in {"SERVE_WARMUP": "0", "SERVE_DP": "0"}.items():
        monkeypatch.setenv(k, v)
    for k in ("DETECT_ABSTAIN_CONF", "DETECT_ABSTAIN_MARGIN", "DETECT_FAKE_THRESHOLD",
              "FAKE_CLASS_INDEX"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def legacy_predictors():
    """Per family: the JAX and the port Predictor on one set of weights."""
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SERVE_WARMUP", "0")
        for family in ("cnn_lstm", "vit_gcn"):
            jm, v, pm = _cnn_lstm_pair(seed=9) if family == "cnn_lstm" else _graph_pair(
                192, seed=9)
            out[family] = (jax_predict.Predictor(jm, v, family, extractor=extractor),
                           port_predict.Predictor(pm, None, family, extractor=extractor,
                                                  device="cpu"))
    yield out
    for _, p in out.values():
        p.close()


@pytest.mark.parametrize("family", ["cnn_lstm", "vit_gcn"])
@pytest.mark.parametrize("policy", ["verdict", "borderline", "low_confidence", "threshold"])
def test_predict_legacy_matches_jax(legacy_predictors, serve_env, family, policy):
    """``_predict_legacy``'s dicts against JAX's key for key, on 5 frames
    (padded to 16) and 20 (sampled to 16), through each branch."""
    env = {"verdict": {"DETECT_ABSTAIN_CONF": "0"},
           "borderline": {"DETECT_ABSTAIN_MARGIN": "0.5"},
           "low_confidence": {"DETECT_ABSTAIN_CONF": "1.0"},
           "threshold": {"DETECT_ABSTAIN_CONF": "0", "DETECT_FAKE_THRESHOLD": "0.01",
                         "FAKE_CLASS_INDEX": "0"}}[policy]
    for k, val in env.items():
        serve_env.setenv(k, val)
    jpred, ppred = legacy_predictors[family]
    rng = np.random.default_rng(10)
    for n in (5, 20):
        faces = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
        ref, got = jpred.predict_faces(faces), ppred.predict_faces(faces)
        assert sorted(got) == sorted(ref)
        for key in ref:
            if isinstance(ref[key], float):
                assert got[key] == pytest.approx(ref[key], abs=DETECTOR_TOL), key
            else:
                assert got[key] == ref[key], key
        assert got["num_faces"] == n and got.get("abstained", False) == (
            policy in ("borderline", "low_confidence"))


def test_legacy_warmup_runs_the_serving_forward(serve_env):
    serve_env.setenv("SERVE_WARMUP", "1")
    serve_env.setenv("FACE_SIZE", str(SIZE))
    _, _, pm = _cnn_lstm_pair(seed=11)
    pred = port_predict.Predictor(pm, None, "cnn_lstm", device="cpu")
    assert pred.warmup_done.wait(timeout=120)
    assert pred.warmup_error is None and pred._batcher is None
    pred.close()


# ---------------------------------------------------------------------------
# checkpoints: loader, evaluator, JAX reading the port's files
# ---------------------------------------------------------------------------


def _full_size(family, seed):
    jm = JaxCNNLSTM() if family == "cnn_lstm" else JaxFrameGraph(vit_variant=TINY)
    cfg = {"model_type": family, **({"vit_variant": TINY} if family == "vit_gcn" else {})}
    return jm, random_variables(jm, seed), cfg


@pytest.mark.parametrize("family", ["cnn_lstm", "vit_gcn"])
@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_loader_picks_the_legacy_family(family, fmt, tmp_path, monkeypatch):
    """A full-size checkpoint of each family, native ``.npz`` (with its
    model_config) or a raw reference ``.pt`` (keys only): the port's loader
    picks the family the JAX loader's key rules give, at match ratio 1.0,
    with the weights."""
    monkeypatch.delenv("QUANTIZE", raising=False)
    _, v, cfg = _full_size(family, 12)
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "npz":
        jax_save_checkpoint(path, v, meta={"model_config": cfg})
    else:
        jax_save_torch_checkpoint(path, v, layout="raw")
    model, sd, stats = port_loader.load_model(path, device="cpu")
    assert stats["model_type"] == family and stats["match_ratio"] == 1.0
    assert isinstance(model, CNNLSTMHybrid if family == "cnn_lstm" else FrameGraphDetector)
    want = state_dict_from_jax(v)
    assert sorted(sd) == sorted(want)
    for k in ("cnn.13.running_var", "lstm.weight_hh_l1") if family == "cnn_lstm" else (
            "vit.blocks.11.attn.qkv.weight", "gcn.fc2.weight"):
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy())


@pytest.mark.parametrize("family", ["vit_gcn", "cnn_lstm", "vit_gnn"])
def test_port_checkpoints_load_in_jax(family, tmp_path):
    """The port's ``save_checkpoint`` (BN state under ``state.``) read by
    the JAX package gives the port's logits."""
    if family == "vit_gcn":
        jm, _, pm = _graph_pair(192, seed=15)
        x = (_frames(15, (2, T, SIZE, SIZE, 3)), _chain(T, 2))
    elif family == "cnn_lstm":
        jm, _, pm = _cnn_lstm_pair(seed=15)
        x = (_frames(15, (2, T, SIZE, SIZE, 3)),)
    else:
        jm, _, pm = _gnn_pair(seed=15)
        x = (_frames(15, (2, SIZE, SIZE, 3)),)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, pm.state_dict(), meta={"model_config": {"model_type": family}})
    variables, meta = jax_load_checkpoint(path)
    assert meta["model_config"]["model_type"] == family
    assert bool(variables["state"]) == (family == "cnn_lstm")
    ref, _ = jm.apply(variables, *(jnp.asarray(a) for a in x))
    with torch.no_grad():
        got = pm(*(_t(a) for a in x))
    _close(got, ref, DETECTOR_TOL)

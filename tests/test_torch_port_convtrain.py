"""Training the conv-net detectors: the port against the JAX package, on the CPU.

One train step of EfficientNet-B0 and ResNet-18 ``BackboneDetector``s
(``remat`` off and on), of B0 with ``grad_accum = 2``, of the B0 +
resnet18 ensemble and of the temporal transformer over B0, each under a
gradient clip that bites: loss, grad norm, every parameter and batch
norm's running stats against the JAX step on the same weights and batch.
Then AdamW's decay set, drop-path, the calibration module, ``.pt`` warm
starts, resumes and export, and the training CLIs at their defaults.

Sizes. The single detectors and the ensemble take B = 2 clips of T = 2
frames at 48 px. ResNet's ReLUs are kinks: a pre-activation within f32
rounding of 0 takes its gate one way in JAX and the other in the port, and
moves every gradient below it by ~1 %; with 8 frames of 64 px most
batches hold one (2.4e-6 at ``layer3.1.bn1`` against a rounding error of
2.6e-5 in the first tried). B0's last stage must normalise over more than
8 values a channel: below that its gradient is too ill-conditioned to
compare (at 32 px and 2 frames JAX's own compile options move its grad
norm by 3e-4). The temporal model (T = 4) and the accumulated step (B = 4,
T = 2, microbatches of 4 frames) take 64 px. The running stats are held
to 1e-5 absolute and relative: deep in B0 the two forwards' batch
variances differ by ~1e-5 of their value (conv sums taken in another
order), above 1e-5 absolute where they exceed 1.

Weights are JAX trees filled by numpy (``random_variables``) carried across
with ``state_dict_from_jax``; dropout and drop-path are 0 on both sides
(their draws differ by design). Each JAX step is compiled once per file.
"""

import csv
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deepfake_video_detection_tpu.checkpoint import store as jax_store
from deepfake_video_detection_tpu.checkpoint.torch_bridge import import_into_variables
from deepfake_video_detection_tpu.data.dataset import VideoFacesDataset as JaxDataset
from deepfake_video_detection_tpu.evals.metrics import threshold_sweep as jax_threshold_sweep
from deepfake_video_detection_tpu.models.backbone_detector import (
    BackboneDetector as JaxDetector, EnsembleDetector as JaxEnsemble)
from deepfake_video_detection_tpu.models.temporal_transformer import (
    TemporalTransformerDetector as JaxTemporal)
from deepfake_video_detection_tpu.train import calibration as JC
from deepfake_video_detection_tpu.train import cli as jax_cli
from deepfake_video_detection_tpu.train import losses as JLoss
from deepfake_video_detection_tpu.train import optim as JO
from deepfake_video_detection_tpu.train.state import TrainState as JaxTrainState
from deepfake_video_detection_tpu.train.steps import make_accum_step as jax_make_accum_step
from deepfake_video_detection_tpu.train.steps import make_train_step as jax_make_train_step
from deepfake_video_detection_tpu.train.trainer import Trainer as JaxTrainer
from deepfake_video_detection_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from deepfake_video_detection_tpu.utils.tree import flatten_dotted as jax_flatten
from deepfake_video_detection_tpu_torch.checkpoint import store
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    save_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.models import efficientnet as EN
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector)
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector)
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.train import calibration as C
from deepfake_video_detection_tpu_torch.train import cli, cli_ensemble
from deepfake_video_detection_tpu_torch.train import losses as Loss
from deepfake_video_detection_tpu_torch.train import optim as O
from deepfake_video_detection_tpu_torch.train import steps as S
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

from test_torch_port_convnets import random_variables

SIZE, T = 48, 2
BIG = {"temporal": (64, 4), "accum": (64, 2)}     # the cases at 64 px: (size, T)
CW = np.asarray([0.8, 1.2], np.float32)
# the tolerances of test_torch_port_train.py's step test
LOSS_RTOL, NORM_RTOL, PARAM_RTOL, PARAM_ATOL, STATS_TOL = 1e-5, 1e-4, 1e-4, 1e-6, 1e-5
TEMPORAL = {"d_model": 32, "depth": 1, "num_heads": 2, "dropout_rate": 0.0}
_STATS = ("running_mean", "running_var")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several workers on the host's
    cores, and oversubscribed intra-op threads slow these small ops many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _no_drop_path(model):
    """Drop-path off in every EfficientNet of ``model`` (either package)."""
    for m in getattr(model, "members", [model]):
        if hasattr(m.backbone, "drop_path_rate"):
            m.backbone.drop_path_rate = 0.0


_JAX_PAIRS = {}


def _pair(kind, seed):
    """``(JAX model, its variables, a fresh port model on them)``, dropout
    and drop-path off on both sides; the JAX side is made once per file."""
    if (kind, seed) not in _JAX_PAIRS:
        if kind == "ensemble":
            jm = JaxEnsemble(("efficientnet_b0", "resnet18"), dropout_rate=0.0)
        elif kind == "temporal":
            jm = JaxTemporal("efficientnet_b0", **TEMPORAL)
        else:
            jm = JaxDetector(kind, dropout_rate=0.0)
        _no_drop_path(jm)
        _JAX_PAIRS[(kind, seed)] = (jm, random_variables(jm, seed))
    jm, v = _JAX_PAIRS[(kind, seed)]
    if kind == "ensemble":
        pm = EnsembleDetector(("efficientnet_b0", "resnet18"), dropout_rate=0.0,
                              device="cpu")
    elif kind == "temporal":
        pm = TemporalTransformerDetector("efficientnet_b0", device="cpu", **TEMPORAL)
    else:
        pm = BackboneDetector(kind, dropout_rate=0.0, device="cpu")
    _no_drop_path(pm)
    pm.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v)),
                       strict=True)
    return jm, v, pm


def _batch(seed, B=2, T_=T, size=SIZE):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(B, T_, size, size, 3)).astype(np.float32),
            "labels": np.arange(B) % 2, "valid": np.ones((B,), bool)}


def _case_batch(kind, seed, B=2):
    size, T_ = BIG.get(kind, (SIZE, T))
    return _batch(seed, B=B, T_=T_, size=size)


def _jloss(logits, labels, sample_mask=None):
    return JLoss.cross_entropy_loss(logits, labels, class_weights=CW, sample_mask=sample_mask)


def _loss(logits, labels, sample_mask=None):
    return Loss.cross_entropy_loss(logits, labels, class_weights=CW, sample_mask=sample_mask)


def _sgd():
    """SGD with the ensemble trainer's clip, 1.0, which every step here
    exceeds: the update is linear in the gradient (Adam's first step is
    ±lr wherever |g| ≫ eps and amplifies rounding where |g| ~ eps, as on
    B0's BN shifts that feed another BN, whose gradient is 0 up to
    rounding)."""
    return JO.build_optimizer("sgd", 0.5, grad_clip=1.0), O.build_optimizer("sgd", 0.5,
                                                                           grad_clip=1.0)


def _assert_state_matches(model, jax_variables):
    """Every parameter (rtol 1e-4, atol 1e-6) and running stat (1e-5)
    of ``model`` against a JAX variables tree; the key sets are equal."""
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_variables))
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    assert any(k.endswith(_STATS) for k in got)
    for k, t in got.items():
        if k.endswith(_STATS):
            np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)


def _assert_metrics_match(m, jm):
    assert int(m["count"]) == int(jm["count"]) and int(m["correct"]) == int(jm["correct"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)


# the step cases: the weights' seed of each (its batch is drawn from the same)
SEEDS = {"efficientnet_b0": 1, "resnet18": 1, "ensemble": 2, "temporal": 3, "accum": 4}


def _accum_batch():
    """4 clips (one masked) as two microbatches of 2: every leaf (2, 2, ...)."""
    batch = _case_batch("accum", SEEDS["accum"], B=4)
    batch["valid"][3] = False
    return {k: a.reshape((2, 2) + a.shape[1:]) for k, a in batch.items()}


def _accum_weights(labels, valid):
    """The loss's per-sample weights (class weight x validity), either package."""
    if isinstance(labels, jax.Array):
        return jnp.asarray(CW)[labels] * valid.astype(jnp.float32)
    return _t(CW)[labels] * valid.to(torch.float32)


@functools.lru_cache(maxsize=None)
def _jax_step(case):
    """JAX's SGD step of ``case`` on its batch (for ``"accum"``, B0's step
    accumulated over ``_accum_batch``), compiled and run once per file:
    ``(new variables, metrics)``."""
    tx, _ = _sgd()
    if case == "accum":
        jm, v, _ = _pair("efficientnet_b0", SEEDS["efficientnet_b0"])
        step = jax_make_accum_step(jm, tx, _jloss, 2, donate=False,
                                   sample_weight_fn=_accum_weights)
        batch, rng = _accum_batch(), jax.random.PRNGKey(0)
    else:
        jm, v, _ = _pair(case, SEEDS[case])
        step = jax_make_train_step(jm, tx, _jloss, donate=False)
        batch, rng = _case_batch(case, SEEDS[case]), None
    st, met = step(JaxTrainState.create(v, tx),
                   {k: jnp.asarray(a) for k, a in batch.items()}, rng)
    return st.variables, met


def _port_step(kind, remat):
    _, _, pm = _pair(kind, SEEDS[kind])
    _, opt = _sgd()
    step = S.make_train_step(pm, opt, _loss, remat=remat)
    batch = _case_batch(kind, SEEDS[kind])
    _, m = step(TrainState.create(pm, opt), {k: _t(a) for k, a in batch.items()})
    return pm, m


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("backbone", ["efficientnet_b0", "resnet18"])
def test_backbone_detector_step_matches_jax(backbone, remat):
    """One SGD step with a clip that bites: loss, grad norm, every parameter
    and the running stats, moved once (``remat`` recomputes the forward
    without moving them again; JAX's remat gives its step's numbers)."""
    jvars, jmet = _jax_step(backbone)
    assert float(jmet["grad_norm"]) > 2.0    # the clip at 1.0 bites
    pm, m = _port_step(backbone, remat)
    _assert_metrics_match(m, jmet)
    _assert_state_matches(pm, jvars)


def test_ensemble_step_matches_jax_with_member_bn_state(tmp_path):
    """The B0 + resnet18 ``average`` ensemble: each member's running stats
    under ``models.<i>.``; the port's checkpoint of the stepped model holds
    them under ``state.models.<i>``, and both packages read it back."""
    jvars, jmet = _jax_step("ensemble")
    pm, m = _port_step("ensemble", remat=False)
    _assert_metrics_match(m, jmet)
    _assert_state_matches(pm, jvars)
    path = str(tmp_path / "ens.npz")
    save_checkpoint(path, pm.state_dict(), meta={"model_config": {"model_type": "ensemble"}})
    jv, _ = jax_store.load_checkpoint(path)
    for i in ("0", "1"):
        assert jax_flatten(jv["state"]["models"][i]).keys() == \
            jax_flatten(jvars["state"]["models"][i]).keys()
    sd, _ = store.load_any(path)
    for k, t in pm.state_dict().items():
        np.testing.assert_array_equal(sd[k], t.numpy(), err_msg=k)


def test_temporal_step_over_b0_matches_jax(tmp_path):
    """The temporal transformer over B0 (one block): the backbone's BN state
    sits under ``backbone.``. Imported from the port's ``.pt`` the way the
    JAX evaluator imports a checkpoint, that state is kept, so the
    evaluator's read of ``state["backbone"]`` (which raises for a stateless
    backbone, ROADMAP Queue 3) finds it."""
    jvars, jmet = _jax_step("temporal")
    pm, m = _port_step("temporal", remat=True)
    _assert_metrics_match(m, jmet)
    _assert_state_matches(pm, jvars)
    path = str(tmp_path / "temporal.pt")
    store.save_torch_checkpoint(path, pm.state_dict(), layout="model_config",
                                meta={"model_config": {"model_type": "temporal"}})
    sd, _ = jax_store.load_any(path)
    imported, report = import_into_variables(sd, jvars)
    assert report["match_ratio"] == 1.0
    assert jax_flatten(imported["state"]["backbone"]).keys() == \
        jax_flatten(jvars["state"]["backbone"]).keys()


@pytest.mark.parametrize("remat", [False, True])
def test_b0_grad_accum_threads_bn_through_the_microbatches(remat):
    """``grad_accum = 2`` on B0 (4 clips as two microbatches of 2, one
    masked row): the gradient recombines by the loss weights, and the
    running stats move once per microbatch, in order, as JAX's scan threads
    them (``remat`` or not)."""
    jvars, jmet = _jax_step("accum")
    _, _, pm = _pair("efficientnet_b0", SEEDS["efficientnet_b0"])
    _, opt = _sgd()
    step = S.make_accum_step(pm, opt, _loss, 2, remat=remat, sample_weight_fn=_accum_weights)
    _, m = step(TrainState.create(pm, opt), {k: _t(a) for k, a in _accum_batch().items()})
    assert int(m["count"]) == 3
    _assert_metrics_match(m, jmet)
    _assert_state_matches(pm, jvars)


def test_adamw_decay_covers_optax_parameter_set():
    """AdamW's decoupled decay acts on the same parameters as optax's chain
    over B0's tree: with zero gradients the clip and Adam's update are 0,
    and every parameter, batch norm's weights and biases included, decays
    as in JAX, while the running stats (JAX model state, buffers here) stay.
    The clip's set is the step tests' (their clip bites)."""
    _, v, pm = _pair("efficientnet_b0", 1)
    kw = dict(weight_decay=0.5, grad_clip=1.0)
    tx = JO.build_optimizer("adamw", 1e-2, **kw)
    params = v["params"]
    decayed = jax.jit(lambda p: optax.apply_updates(
        p, tx.update(jax.tree_util.tree_map(jnp.zeros_like, p), tx.init(p), p)[0]))(params)
    opt = O.build_optimizer("adamw", 1e-2, **kw)
    st = TrainState.create(pm, opt)
    opt.step(st.params, {n: torch.zeros_like(p) for n, p in st.params.items()}, st.opt_state)
    _assert_state_matches(pm, {"params": decayed, "state": v["state"]})
    moved = state_dict_from_jax({"params": decayed, "state": v["state"]})
    before = state_dict_from_jax(v)
    for k in moved:
        assert torch.equal(moved[k], before[k]) == k.endswith(_STATS), k


# ---------------------------------------------------------------------------
# drop-path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_b0_drop_path_applies_in_train_mode_only(train, monkeypatch):
    """B0's default rate 0.2 grows linearly over the blocks as in the JAX
    model; only a training forward draws masks (from the generator it is
    given), and a kept sample is scaled by 1 / (1 - rate)."""
    calls = []
    real = EN.L.drop_path

    def spy(x, rate, train_, generator=None):
        y = real(x, rate, train_, generator)
        calls.append((rate, train_, x.detach(), y.detach()))
        return y

    monkeypatch.setattr(EN.L, "drop_path", spy)
    model = BackboneDetector("efficientnet_b0", dropout_rate=0.0, device="cpu")
    x = _t(_batch(7)["frames"])
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model(x, train=train, generator=gen)
    bb = model.backbone
    residual = [i for i, blk in enumerate(b for st in bb.blocks for b in st)
                if blk.spec.stride == 1 and blk.spec.in_ch == blk.spec.out_ch]
    assert [c[0] for c in calls] == pytest.approx(
        [0.2 * i / (bb.num_blocks - 1) for i in residual])
    dropped = 0
    for rate, tr, xin, y in calls:
        assert tr is train
        if not train:
            assert torch.equal(y, xin)
            continue
        kept = (y != 0).flatten(1).any(dim=1)
        torch.testing.assert_close(y[kept], xin[kept] / (1 - rate), rtol=0, atol=0)
        assert torch.all(y[~kept] == 0)
        dropped += int((~kept).sum())
    assert (dropped > 0) == train


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.3, 4.0])
def test_calibration_matches_jax(scale):
    """Temperature scaling (under- and over-confident logits) and the
    uncertainty estimator against the JAX module: temperature and outputs
    within 1e-5."""
    rng = np.random.default_rng(int(scale * 10))
    labels = rng.integers(0, 2, size=64)
    logits = (rng.normal(size=(64, 2)) + 1.5 * np.eye(2)[labels]).astype(np.float32) * scale
    jc, pc = JC.ConfidenceCalibrator(), C.ConfidenceCalibrator()
    t_ref, t = jc.fit(logits, labels), pc.fit(logits, labels)
    assert t != 1.0
    np.testing.assert_allclose(t, t_ref, rtol=1e-5)
    np.testing.assert_allclose(pc.calibrate(logits), jc.calibrate(logits), atol=1e-5)
    members = rng.normal(size=(3, 64, 2)).astype(np.float32) * scale
    probs = pc.calibrate(logits)
    got = C.UncertaintyEstimator().combined(members, probs, threshold=0.4)
    ref = JC.UncertaintyEstimator().combined(members, probs, threshold=0.4)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# .pt warm starts, resumes and export
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def faces_dir(tmp_path_factory):
    """10 clips of 3-5 frames at 32 px, alternately real and fake."""
    d = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    for i in range(10):
        np.savez(d / f"clip_{i}.npz",
                 faces=rng.integers(0, 256, size=(int(rng.integers(3, 6)), 32, 32, 3),
                                    dtype=np.uint8), label=np.int64(i % 2))
    return str(d)


@pytest.mark.parametrize("layout", ["rich", "model_config", "raw"])
def test_jax_pt_warm_starts_and_resumes_the_port_trainer(layout, faces_dir, tmp_path):
    """A ``.pt`` that JAX's ``save_torch_checkpoint`` wrote (B0 detector)
    resumes the port's Trainer to JAX's params, BN state, epoch and step,
    and warm-starts it to the same weights with a fresh optimizer state."""
    jm, v, _ = _pair("efficientnet_b0", 1)
    path = str(tmp_path / f"ref_{layout}.pt")
    jax_store.save_torch_checkpoint(path, v, layout=layout,
                                    meta={"epoch": 3, "model_config": {
                                        "model_type": "pretrained"}})
    jds = JaxDataset(faces_dir, num_frames=2)
    jt = JaxTrainer(jm, jds, jds, JaxTrainerConfig(out_dir=str(tmp_path / "jax")))
    template = jax.tree_util.tree_map(jnp.zeros_like, v)
    jstate = jt.resume(path, JaxTrainState.create(template, jt.tx))

    ds = VideoFacesDataset(faces_dir, num_frames=2)
    fresh = BackboneDetector("efficientnet_b0", device="cpu")
    pt = Trainer(fresh, ds, ds, TrainerConfig(out_dir=str(tmp_path / "port")), device="cpu")
    state = pt.resume(path)
    assert (pt.start_epoch, state.step) == (jt.start_epoch, int(jstate.step))
    assert pt.start_epoch == (4 if layout == "rich" else 0)
    assert pt.best_value == jt.best_value
    _assert_state_matches(fresh, jstate.variables)

    other = BackboneDetector("efficientnet_b0", device="cpu",
                             generator=torch.Generator().manual_seed(1))
    pw = Trainer(other, ds, ds, TrainerConfig(out_dir=str(tmp_path / "warm")), device="cpu")
    state = pw.warm_start(path)
    assert state.step == 0 and pw.start_epoch == 0
    assert state.opt_state["count"] == 0
    assert all(float(t.abs().max()) == 0 for t in state.opt_state["mu"].values())
    _assert_state_matches(other, jstate.variables)


def test_low_match_ratio_raises_and_leaves_the_model(faces_dir, tmp_path):
    """A resnet18 ``.pt`` matches under half of a B0 detector: ``ValueError``
    with JAX's message, the model as it was."""
    _, v, _ = _pair("resnet18", 1)
    path = str(tmp_path / "resnet.pt")
    jax_store.save_torch_checkpoint(path, v, layout="raw")
    model = BackboneDetector("efficientnet_b0", device="cpu")
    before = {k: t.clone() for k, t in model.state_dict().items()}
    ds = VideoFacesDataset(faces_dir, num_frames=2)
    trainer = Trainer(model, ds, ds, TrainerConfig(out_dir=str(tmp_path)), device="cpu")
    for load in (trainer.resume, trainer.warm_start):
        with pytest.raises(ValueError, match=r"matches only \d+% of the model"):
            load(path)
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("layout", ["rich", "model_config", "raw"])
def test_torch_export_equals_jax_and_each_loader_reads_the_other(layout, tmp_path):
    """The port's ``save_torch_checkpoint`` and JAX's, of the same ensemble
    weights: the same wrapper, the same keys (BN running stats included)
    and equal arrays; each package's ``load_any`` reads the other's
    ``.pt`` and ``.npz`` to the same tensors."""
    _, v, pm = _pair("ensemble", 2)
    meta = {"epoch": 2, "metrics": {"f1": 0.5}, "best_f1": 0.5,
            "model_config": {"model_type": "ensemble",
                             "backbones": ["efficientnet_b0", "resnet18"],
                             "ensemble_method": "average"}}
    ours, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    store.save_torch_checkpoint(ours, pm.state_dict(), layout=layout, meta=meta)
    jax_store.save_torch_checkpoint(theirs, v, layout=layout, meta=meta)
    a = torch.load(ours, map_location="cpu", weights_only=True)
    b = torch.load(theirs, map_location="cpu", weights_only=True)
    sa, sb = (x if layout == "raw" else x["model_state"] for x in (a, b))
    assert sorted(sa) == sorted(sb) and any(k.endswith(_STATS) for k in sa)
    for k in sb:
        assert sa[k].dtype == sb[k].dtype, k
        np.testing.assert_array_equal(sa[k].numpy(), sb[k].numpy(), err_msg=k)
    if layout != "raw":
        assert {k: x for k, x in a.items() if k != "model_state"} == \
            {k: x for k, x in b.items() if k != "model_state"}
    for reader, path in ((store.load_any, theirs), (jax_store.load_any, ours)):
        sd, _ = reader(path)
        assert sorted(sd) == sorted(sb)
        for k in sd:
            np.testing.assert_array_equal(np.asarray(sd[k]), sb[k].numpy(), err_msg=k)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_checkpoint(ours, pm.state_dict())
    jax_store.save_checkpoint(theirs, v)
    for reader, path in ((store.load_any, theirs), (jax_store.load_any, ours)):
        sd, _ = reader(path)
        assert sorted(sd) == sorted(sb)
        for k in sb:
            np.testing.assert_array_equal(np.asarray(sd[k]), sb[k].numpy(), err_msg=k)


def test_trainer_ema_and_torch_export_files(faces_dir, tmp_path):
    """With ``ema_decay`` and ``keep_torch_export`` the Trainer writes
    ``<name>_ema.npz`` holding the EMA params and the live BN state (as
    JAX's trainer writes it) and ``<name>.pt`` in the ``model_config``
    layout, equal to JAX's export of the ``.npz`` beside it."""
    ds = VideoFacesDataset(faces_dir, num_frames=2)
    train_ds, val_ds = ds.split(0.2)
    model = BackboneDetector("resnet18", device="cpu")
    cfg = TrainerConfig(out_dir=str(tmp_path), epochs=1, batch_size=4, num_frames=2,
                        augment=False, ema_decay=0.9, keep_torch_export=True,
                        model_config={"model_type": "pretrained", "backbone": "resnet18"})
    state = Trainer(model, train_ds, val_ds, cfg, device="cpu").train()
    ema = O.get_ema_params(state.opt_state)
    jv, meta = jax_store.load_checkpoint(str(tmp_path / "checkpoint_best_ema.npz"))
    assert meta["metrics_scored_on"] == "ema"
    got = state_dict_from_jax(jv)
    assert sorted(got) == sorted(model.state_dict())
    for k, t in model.state_dict().items():
        want = ema[k] if k in ema else t
        np.testing.assert_array_equal(got[k].numpy(), want.numpy(), err_msg=k)
    jv, _ = jax_store.load_checkpoint(str(tmp_path / "checkpoint_best.npz"))
    ref = str(tmp_path / "jax_export.pt")
    jax_store.save_torch_checkpoint(ref, jv, layout="model_config",
                                    meta={"model_config": cfg.model_config})
    a = torch.load(str(tmp_path / "checkpoint_best.pt"), weights_only=True)
    b = torch.load(ref, weights_only=True)
    assert a["model_config"] == b["model_config"] == cfg.model_config
    assert sorted(a["model_state"]) == sorted(b["model_state"])
    for k, t in b["model_state"].items():
        np.testing.assert_array_equal(a["model_state"][k].numpy(), t.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_cli_ensemble_writes_calibration_and_exports(faces_dir, tmp_path):
    """``cli_ensemble`` at its defaults (B0 + resnet18, ``average``) for one
    epoch with ``--torch-export``: ``checkpoint_best.npz``,
    ``calibration_best.json`` (whose thresholds are JAX's
    ``threshold_sweep`` of the port's validation probabilities) and
    ``checkpoint_best.pt``; JAX reads the ``.npz`` with every member's BN
    state, and the port's serving loader picks the ensemble from either file."""
    out = tmp_path / "ens"
    assert cli_ensemble.main(["--data_dir", faces_dir, "--epochs", "1", "--batch_size", "4",
                              "--num_frames", "2", "--torch-export", "--out_dir", str(out),
                              "--device", "cpu"]) == 0
    for name in ("checkpoint_best.npz", "calibration_best.json", "checkpoint_best.pt"):
        assert (out / name).exists(), name
    with open(out / "preds_epoch_0.csv") as f:
        rows = list(csv.DictReader(f))
    labels = np.asarray([int(r["label"]) for r in rows])
    prob_fake = np.asarray([float(r["prob_fake"]) for r in rows])
    ref = jax_threshold_sweep(labels, prob_fake)
    cal = json.loads((out / "calibration_best.json").read_text())
    for k in ("best_thr_accuracy", "best_thr_f1", "best_accuracy", "best_f1"):
        assert cal[k] == pytest.approx(ref[k]), k
    jv, meta = jax_store.load_checkpoint(str(out / "checkpoint_best.npz"))
    assert meta["model_config"] == {"model_type": "ensemble",
                                    "backbones": ["efficientnet_b0", "resnet18"],
                                    "ensemble_method": "average"}
    template = jax.eval_shape(JaxEnsemble(("efficientnet_b0", "resnet18")).init,
                              jax.random.PRNGKey(0))
    assert jax_flatten(jv["state"]).keys() == jax_flatten(template["state"]).keys()
    for path in ("checkpoint_best.npz", "checkpoint_best.pt"):
        model, _, stats = port_loader.load_model(str(out / path), device="cpu")
        assert stats["model_type"] == "ensemble_pretrained" and stats["match_ratio"] == 1.0
        assert model.backbone_names == ("efficientnet_b0", "resnet18")


@pytest.mark.parametrize("model", ["pretrained", "temporal"])
def test_training_cli_trains_the_default_backbone(model, faces_dir, tmp_path):
    """``--model pretrained`` and ``--model temporal`` with no ``--backbone``
    train B0 (one epoch here); the checkpoint's ``model_config`` is the JAX
    CLI's, key for key, and JAX reads its BN state."""
    out = tmp_path / model
    assert cli.main(["--data_dir", faces_dir, "--model", model, "--epochs", "1",
                     "--batch_size", "4", "--num_frames", "2", "--d_model", "32",
                     "--depth", "1", "--heads", "2", "--out_dir", str(out),
                     "--device", "cpu"]) == 0
    jv, meta = jax_store.load_checkpoint(str(out / "checkpoint_best.npz"))
    _, _, want = jax_cli.build_model(model, 2, temporal_kwargs=dict(
        d_model=32, depth=1, num_heads=2))
    assert meta["model_config"] == want
    assert want["backbone"] == "efficientnet_b0"
    assert jax_flatten(jv["state"]["backbone"])


def test_entry_points_need_the_card_without_a_device(monkeypatch, faces_dir, tmp_path):
    """Without a card and without ``--device cpu`` the ensemble CLI and the
    conv-net CLI models raise; they never carry on on the CPU. Asked for
    the CPU, the ensemble CLI trains with ``--steps_per_call 2`` (its 8
    training clips: one group of two batches)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_ensemble.main(["--data_dir", faces_dir])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--data_dir", faces_dir, "--model", "temporal"])
    assert cli_ensemble.main(["--data_dir", faces_dir, "--steps_per_call", "2", "--epochs",
                              "1", "--batch_size", "4", "--num_frames", "2", "--out_dir",
                              str(tmp_path / "k2"), "--device", "cpu"]) == 0
    assert (tmp_path / "k2" / "checkpoint_best.npz").exists()

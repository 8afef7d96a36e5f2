"""``steps_per_call > 1``: the port's multi-step call and the trainer's
multi-step epoch against the JAX package's, on the CPU.

The model is the ``tinyconv`` detector (two convs, temporal attention, the
head) in both packages, JAX's initial weights carried over with the port's
bridge. ``make_multi_step`` at k = 3 is held to JAX's ``make_multi_step``
on ``tests/test_train.py::test_multi_step_matches_sequential``'s batches,
and to three of the port's own single steps bit for bit; the ``Trainer``
with ``steps_per_call = 2`` (groups of two full batches and the tail batch
alone) to JAX's ``Trainer`` with augmentation off, and to the port's
``steps_per_call = 1`` bit for bit with augmentation and dropout on (the
port's groups draw in the single loop's order). The two ``ValueError`` s
and the CLI flag close the file.
"""

import argparse
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.data.dataset import VideoFacesDataset as JaxDataset
from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.parallel.strategy import build_plan as jax_build_plan
from deepfake_video_detection_tpu.train import losses as JLoss
from deepfake_video_detection_tpu.train import optim as JO
from deepfake_video_detection_tpu.train.state import TrainState as JaxTrainState
from deepfake_video_detection_tpu.train.steps import make_multi_step as jax_make_multi_step
from deepfake_video_detection_tpu.train.trainer import Trainer as JaxTrainer
from deepfake_video_detection_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    load_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.parallel.strategy import build_plan
from deepfake_video_detection_tpu_torch.train import cli
from deepfake_video_detection_tpu_torch.train import losses as L
from deepfake_video_detection_tpu_torch.train import optim as O
from deepfake_video_detection_tpu_torch.train import steps as S
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

SIZE = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(seed=0, dropout=0.0):
    """The tinyconv detector in JAX and in the port, on JAX's init."""
    jmodel = JaxDetector("tinyconv", dropout_rate=dropout)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = BackboneDetector("tinyconv", dropout_rate=dropout, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    """12 clips of 3-7 frames at 16 px, half labelled fake: batches of 5
    give two full batches and a tail of 2."""
    d = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    for i in range(12):
        label = i % 2
        faces = rng.integers(0, 256, size=(rng.integers(3, 8), SIZE, SIZE, 3),
                             dtype=np.uint8)
        np.savez_compressed(d / f"video_{i}_{'fake' if label else 'real'}.npz",
                            faces=faces, label=np.int64(label))
    return str(d)


def test_multi_step_matches_jax_and_three_single_steps():
    """k = 3 steps over one stacked group with one masked row: with SGD
    (momentum, clip 1.0, a learning rate halved every step, so each step
    must read its own count) the loss (the count-weighted mean), correct,
    count, grad norm (the last step's) and every parameter against JAX's
    ``make_multi_step``; with AdamW (whose bias correction reads the count)
    three single port steps give the same bits. The state and the
    optimizer's count advance by 3. (AdamW is not held to JAX here: the
    temporal attention's score bias has a zero gradient up to rounding,
    and Adam scales that rounding up to a step of lr.)"""
    jmodel, variables, model = _models(seed=1)
    rng = np.random.default_rng(0)
    k, B = 3, 4
    frames = rng.random((k, B, 2, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (k, B)).astype(np.int64)
    valid = np.ones((k, B), bool)
    valid[2, 3] = False

    tx = JO.build_optimizer("sgd", JO.step_lr_schedule(0.1, 1, 0.5), grad_clip=1.0)
    jmulti = jax_make_multi_step(jmodel, tx, functools.partial(JLoss.cross_entropy_loss), k,
                                 donate=False)
    jstate, jm = jmulti(JaxTrainState.create(variables, tx),
                        {"frames": jnp.asarray(frames), "labels": jnp.asarray(labels),
                         "valid": jnp.asarray(valid)}, jax.random.PRNGKey(7))

    batches = {"frames": _t(frames), "labels": _t(labels), "valid": _t(valid)}
    opt = O.build_optimizer("sgd", O.step_lr_schedule(0.1, 1, 0.5), grad_clip=1.0)
    multi = S.make_multi_step(model, opt, L.cross_entropy_loss, k)
    state, m = multi(TrainState.create(model, opt), batches)
    assert state.step == 3 and state.opt_state["count"] == 3
    assert int(m["count"]) == int(jm["count"]) == 11
    assert int(m["correct"]) == int(jm["correct"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.variables))
    for key, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[key].numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=key)

    _, _, model = _models(seed=1)
    opt = O.build_optimizer("adamw", 1e-2, grad_clip=1.0)
    state, m = S.make_multi_step(model, opt, L.cross_entropy_loss, k)(
        TrainState.create(model, opt), batches)
    assert state.step == 3 and state.opt_state["count"] == 3
    _, _, single = _models(seed=1)
    opt1 = O.build_optimizer("adamw", 1e-2, grad_clip=1.0)
    step = S.make_train_step(single, opt1, L.cross_entropy_loss)
    st1 = TrainState.create(single, opt1)
    for i in range(k):
        st1, m1 = step(st1, {key: v[i] for key, v in batches.items()})
    assert torch.equal(m1["grad_norm"], m["grad_norm"])
    for key, v in single.state_dict().items():
        assert torch.equal(v, model.state_dict()[key]), key
    for key, v in st1.opt_state["nu"].items():
        assert torch.equal(v, state.opt_state["nu"][key]), key


def test_multi_step_rejects_a_group_of_another_length():
    _, _, model = _models()
    opt = O.build_optimizer("sgd", 0.1)
    multi = S.make_multi_step(model, opt, L.cross_entropy_loss, 3)
    with pytest.raises(ValueError, match="a group of 2 batches for 3 steps"):
        multi(TrainState.create(model, opt),
              {"frames": torch.zeros(2, 1, 2, SIZE, SIZE, 3),
               "labels": torch.zeros(2, 1, dtype=torch.int64)})


def _trainer_cfg(cls, out, k, augment=False, epochs=2, batch_size=5, **kw):
    return cls(out_dir=out, epochs=epochs, batch_size=batch_size, num_frames=4, lr=0.1,
               optimizer="sgd", step_size=1, balance="none", augment=augment, save_every=100, steps_per_call=k,
               seed=3, **kw)


def test_trainer_steps_per_call_matches_jax(npz_dir, tmp_path):
    """Two epochs of the ``Trainer`` at ``steps_per_call = 2`` (a group of
    the two full batches, then the tail of 2 alone) against JAX's
    ``Trainer`` at ``steps_per_call = 2`` from the same initial weights,
    augmentation off, SGD with the learning rate halved each epoch: the
    epochs' losses and accuracies and every parameter."""
    jmodel, _, _ = _models()
    jtr = JaxTrainer(jmodel, JaxDataset(npz_dir, num_frames=4), JaxDataset(npz_dir, num_frames=4),
                     _trainer_cfg(JaxTrainerConfig, str(tmp_path / "jax"), 2))
    jstate = jtr.init_state()
    model = BackboneDetector("tinyconv", dropout_rate=0.0, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.variables)), strict=True)
    ds = VideoFacesDataset(npz_dir, num_frames=4)
    tr = Trainer(model, ds, ds, _trainer_cfg(TrainerConfig, str(tmp_path / "port"), 2),
                 device="cpu")
    assert tr.multi_step is not None
    state = tr.init_state()
    for ep in range(2):
        jstate, jmet = jtr.train_epoch(jstate, ep)
        state, met = tr.train_epoch(state, ep)
        np.testing.assert_allclose(met["train_loss"], jmet["train_loss"], rtol=1e-5)
        assert met["train_acc"] == jmet["train_acc"]
    assert state.step == 6 and state.opt_state["count"] == 6
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.variables))
    for key, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[key].numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=key)


def test_trainer_steps_per_call_trains_as_the_plain_loop(npz_dir, tmp_path):
    """With augmentation and dropout on, ``steps_per_call = 3`` (one group
    of 3 batches of 4, no tail) and ``= 2`` (a group, then the third batch
    alone) give the plain loop's parameters bit for bit, its accuracy, and
    its loss up to the f32 rounding of the group's mean."""
    ds = VideoFacesDataset(npz_dir, num_frames=4)
    results = []
    for k in (1, 2, 3):
        model = BackboneDetector("tinyconv", dropout_rate=0.3, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        cfg = _trainer_cfg(TrainerConfig, str(tmp_path / f"k{k}"), k, augment=True,
                           epochs=1, batch_size=4)
        tr = Trainer(model, ds, ds, cfg, device="cpu")
        state, met = tr.train_epoch(tr.init_state(), 0)
        assert state.step == 3
        results.append((met, model.state_dict()))
    (m1, p1), *rest = results
    for met, p in rest:
        np.testing.assert_allclose(met["train_loss"], m1["train_loss"], rtol=1e-6)
        assert met["train_acc"] == m1["train_acc"]
        for key, v in p.items():
            assert torch.equal(v, p1[key]), key


def _flags(**kw):
    base = dict(mesh=None, fsdp=False, seq="none", seq_par=1, pp_stages=1,
                pp_microbatches=2, moe_experts=0, expert_par=0)
    return argparse.Namespace(**dict(base, **kw))


def test_grad_accum_with_steps_per_call_raises_jax_error(npz_dir, tmp_path):
    jmodel, _, model = _models()
    jds, ds = JaxDataset(npz_dir, num_frames=4), VideoFacesDataset(npz_dir, num_frames=4)
    with pytest.raises(ValueError) as ref:
        JaxTrainer(jmodel, jds, jds, _trainer_cfg(JaxTrainerConfig, str(tmp_path), 2,
                                                  grad_accum=5))
    with pytest.raises(ValueError) as got:
        Trainer(model, ds, ds, _trainer_cfg(TrainerConfig, str(tmp_path), 2, grad_accum=5),
                device="cpu")
    assert str(got.value) == str(ref.value)
    assert "mutually exclusive" in str(got.value)


@pytest.mark.parametrize("flags", [{"seq": "ring"}, {"pp_stages": 2},
                                   {"moe_experts": 4, "expert_par": 2}])
def test_steps_per_call_under_a_scanless_plan_raises_jax_error(npz_dir, tmp_path, flags):
    """A sharded plan whose ``scan_of_steps_ok`` is false (``--seq``,
    ``--pp_stages``, expert parallelism), at 2 devices: JAX's message."""
    jplan, _ = jax_build_plan(_flags(**flags), "temporal", 4, depth=2, n_devices=2)
    plan, _ = build_plan(_flags(**flags), "temporal", 4, depth=2, n_devices=2)
    assert not plan.scan_of_steps_ok and not jplan.scan_of_steps_ok
    jmodel, _, model = _models()
    jds, ds = JaxDataset(npz_dir, num_frames=4), VideoFacesDataset(npz_dir, num_frames=4)
    with pytest.raises(ValueError) as ref:
        JaxTrainer(jmodel, jds, jds, _trainer_cfg(JaxTrainerConfig, str(tmp_path), 2),
                   plan=jplan)
    with pytest.raises(ValueError) as got:
        Trainer(model, ds, ds, _trainer_cfg(TrainerConfig, str(tmp_path), 2), plan=plan,
                device="cpu")
    assert str(got.value) == str(ref.value)
    assert "scan-of-steps" in str(got.value)


def test_cli_steps_per_call(npz_dir, tmp_path):
    """``train/cli.py --steps_per_call 2`` trains an epoch (a group and the
    tail) and writes the checkpoint the plain CLI writes, weights equal."""
    params = []
    for k in ("1", "2"):
        out = tmp_path / f"k{k}"
        assert cli.main(["--data_dir", npz_dir, "--model", "pretrained", "--backbone",
                         "tinyconv", "--epochs", "1", "--batch_size", "5",
                         "--num_frames", "4", "--steps_per_call", k, "--out_dir", str(out),
                         "--device", "cpu"]) == 0
        variables, meta = load_checkpoint(str(out / "checkpoint_best.npz"))
        params.append((meta["step"], state_dict_from_jax(variables)))
    (step1, p1), (step2, p2) = params
    assert step1 == step2 == 2          # the 9-clip training split: 5, then 4
    for key, v in p1.items():
        assert torch.equal(p2[key], v), key

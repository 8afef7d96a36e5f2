"""The port's mixture-of-experts MLP and the temporal transformer's MoE and
dense-attention modes against the JAX package's, on the CPU.

``nn/moe.py::MoEMLP.apply_dense`` on ``tests/test_moe.py``'s fixture (D 8,
H 16, E 4, N 32, f32); the temporal model over tinyconv at 16 px (``d_model``
16, depth 2, 2 heads, E = 4) in f32 and with bf16 activations, whose MoE
output the JAX package promotes to f32; ``use_flash=False``; the train steps
with the router's load-balance term (plain, ``remat``, ``grad_accum = 2``);
MoE checkpoints both ways through the loaders and the evaluator; the training
CLI's ``--moe_experts``; int8 counts. Weights come from JAX ``init`` and
cross with the port's bridge; inputs are made with numpy from a seed. The
temporal model's tolerance is the temporal tests' 2e-4.
"""

import argparse
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.checkpoint.store import save_checkpoint as jax_save_checkpoint
from deepfake_video_detection_tpu.checkpoint.store import (
    save_torch_checkpoint as jax_save_torch_checkpoint)
from deepfake_video_detection_tpu.evals import evaluate as jax_evaluate
from deepfake_video_detection_tpu.models import temporal_transformer as JT
from deepfake_video_detection_tpu.nn import moe as JM
from deepfake_video_detection_tpu.nn import quant as jax_quant
from deepfake_video_detection_tpu.parallel.strategy import build_plan as jax_build_plan
from deepfake_video_detection_tpu.serve import loader as jax_loader
from deepfake_video_detection_tpu.train import losses as JLoss
from deepfake_video_detection_tpu.train import optim as JO
from deepfake_video_detection_tpu.train.state import TrainState as JaxTrainState
from deepfake_video_detection_tpu.train.steps import make_accum_step as jax_make_accum_step
from deepfake_video_detection_tpu.train.steps import make_train_step as jax_make_train_step
from deepfake_video_detection_tpu.utils.tree import flatten_dotted as jax_flatten
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    save_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.checkpoint.store import save_torch_checkpoint
from deepfake_video_detection_tpu_torch.evals import evaluate as E
from deepfake_video_detection_tpu_torch.models import temporal_transformer as T
from deepfake_video_detection_tpu_torch.nn import moe as M
from deepfake_video_detection_tpu_torch.nn import quant
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.train import cli
from deepfake_video_detection_tpu_torch.train import losses as L
from deepfake_video_detection_tpu_torch.train import optim as O
from deepfake_video_detection_tpu_torch.train import steps as S
from deepfake_video_detection_tpu_torch.train.state import TrainState

from test_torch_port_convnets import random_variables

SIZE, FRAMES = 16, 8
SMALL = dict(d_model=16, depth=2, num_heads=2, moe_experts=4)
ATOL = 2e-4
CW = np.asarray([0.8, 1.2], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _frames(seed, B=2, T=FRAMES):
    return np.random.default_rng(seed).normal(size=(B, T, SIZE, SIZE, 3)).astype(np.float32)


def _models(seed=0, dropout=0.0, bf16=False, **kw):
    """The same tinyconv temporal model in JAX and in the port, on JAX's
    init; MoE with 4 experts unless ``kw`` says otherwise."""
    kw = {**SMALL, "dropout_rate": dropout, **kw}
    jmodel = JT.TemporalTransformerDetector(
        "tinyconv", compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = T.TemporalTransformerDetector(
        "tinyconv", device="cpu", compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _jax_forward(jmodel, variables, x):
    (logits, scores), _ = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    return np.asarray(logits), np.asarray(scores, np.float32)


# ---------------------------------------------------------------------------
# nn/moe.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_and_x():
    """``tests/test_moe.py``'s fixture: D 8, H 16, E 4, N 32, f32."""
    jmoe = JM.MoEMLP(d_model=8, hidden=16, num_experts=4, capacity_factor=4.0)
    params = jmoe.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32)
    moe = M.MoEMLP(8, 16, 4, capacity_factor=4.0, device="cpu")
    moe.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmoe, params, x, moe


def test_moe_keys_and_init_match_jax():
    """The JAX tree's keys and shapes; the port's own init draws
    trunc_normal(0.02) for all three leaves."""
    jmoe = JM.MoEMLP(8, 16, 4)
    ref = {k: v.shape for k, v in jax_flatten(jax.eval_shape(jmoe.init,
                                                             jax.random.PRNGKey(0))).items()}
    moe = M.MoEMLP(8, 16, 4, device="cpu", generator=torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in moe.state_dict().items()} == ref
    assert moe.capacity_factor == 2.0 and not list(moe.buffers())
    big = M.MoEMLP(64, 256, 8, device="cpu").w1.detach()
    assert float(big.abs().max()) <= 0.04 + 1e-7
    assert abs(float(big.std()) - 0.02 * 0.8796) < 1e-3     # the std of N(0,1) cut at ±2


def test_apply_dense_matches_jax(moe_and_x):
    """Outputs within 1e-6, the same routing, the load-balance loss within
    1e-6 and the gradients of ``router.weight``, ``w1`` and ``w2`` (through
    the gate and the aux loss's mean probability) within 1e-5."""
    jmoe, params, x, moe = moe_and_x
    ref, ref_aux = jax.jit(lambda p, x: jmoe.apply_dense(p, x, with_aux=True))(
        params, jnp.asarray(x))
    out, aux = moe.apply_dense(_t(x), with_aux=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), atol=1e-6)
    idx, gate, probs = moe._route(_t(x))
    jidx, jgate, jprobs = jmoe._route(params, jnp.asarray(x))
    assert idx.tolist() == np.asarray(jidx).tolist() and len(set(idx.tolist())) > 1
    np.testing.assert_allclose(gate.detach().numpy(), np.asarray(jgate), atol=1e-7)
    np.testing.assert_allclose(
        float(M.load_balance_loss(probs.detach(), idx, 4)),
        float(JM.load_balance_loss(jprobs, jidx, 4)), atol=1e-6)
    assert torch.equal(moe(_t(x)), moe.apply_dense(_t(x)))

    def jloss(p):
        o, a = jmoe.apply_dense(p, jnp.asarray(x), with_aux=True)
        return jnp.sum(o ** 2) + a

    jgrads = jax_flatten(jax.jit(jax.grad(jloss))(params))
    o, a = moe.apply_dense(_t(x), with_aux=True)
    names = [n for n, _ in moe.named_parameters()]
    grads = torch.autograd.grad(torch.sum(o ** 2) + a, list(moe.parameters()))
    for name, g in zip(names, grads):
        assert float(g.abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]), atol=1e-5,
                                   err_msg=name)


def test_bf16_tokens_promote_as_in_jax(moe_and_x):
    """bf16 tokens through f32 parameters: an f32 output in both packages
    (jnp promotes ``x @ w``), the gate rounded to bf16 first."""
    jmoe, params, x, moe = moe_and_x
    xb = x.astype(jnp.bfloat16)
    ref = jmoe.apply_dense(params, jnp.asarray(xb))
    out = moe.apply_dense(_t(x).to(torch.bfloat16))
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process (in-process store),
    torn down after the test."""
    import torch.distributed as dist

    from deepfake_video_detection_tpu_torch.parallel.mesh import init_world

    init_world("cpu")
    yield
    dist.destroy_process_group()


def test_expert_parallel_path_raises(moe_and_x, world_of_one):
    """The expert-parallel path (once unported) at G = 1 on a world of one,
    with ``capacity_factor`` 0.5 so tokens overflow (capacity 4 of 32):
    outputs (dropped tokens zero), the aux loss and the gradients of x and
    every leaf against JAX's ``apply_expert_parallel`` on one device."""
    from jax.sharding import Mesh
    from torch.distributed.device_mesh import init_device_mesh

    jmoe, params, x, _ = moe_and_x
    jmoe = JM.MoEMLP(d_model=8, hidden=16, num_experts=4, capacity_factor=0.5)
    moe = M.MoEMLP(8, 16, 4, capacity_factor=0.5, device="cpu")
    moe.load_state_dict(state_dict_from_jax(params), strict=True)
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("expert",))
    dout = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    (ref, ref_aux), vjp = jax.vjp(
        lambda p, x: jmoe.apply_expert_parallel(p, x, jmesh, "expert", with_aux=True),
        params, jnp.asarray(x))
    gp, gx = vjp((jnp.asarray(dout), jnp.float32(1.0)))
    assert (np.abs(np.asarray(ref)).sum(-1) == 0).sum() > 0      # dropped tokens

    xt = _t(x).requires_grad_()
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("expert",))
    out, aux = moe.apply_expert_parallel(xt, mesh, "expert", with_aux=True)
    (torch.sum(out * _t(dout)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    ref_g = state_dict_from_jax(gp)
    for n, p in moe.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_g[n].numpy(), atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# the temporal transformer's MoE and dense modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash", [True, False])
def test_temporal_moe_matches_jax(use_flash):
    """Logits and frame scores in f32 within 2e-4; the port's ``use_flash``
    takes the flash Function (its plain version on the CPU) or the dense
    attention, JAX's model its dense attention either way off a TPU."""
    jmodel, variables, model = _models(seed=1, use_flash=use_flash)
    assert model.blocks[0].mlp.num_experts == 4
    x = _frames(1)
    ref_logits, ref_scores = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        out = model(_t(x))
    assert len(out) == 2 and out[0].dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), ref_logits, atol=ATOL)
    np.testing.assert_allclose(out[1].numpy(), ref_scores, atol=ATOL)


def test_temporal_moe_bf16_promotes_the_residual_stream_as_jax_does():
    """bf16 activations: block 0's MoE takes bf16 tokens and returns f32, so
    every later block runs in f32 (JAX promotes ``x @ w1`` on f32 params).
    Logits within 2e-4 of JAX's with the dense attention on both sides
    (the same bf16 roundings in block 0)."""
    jmodel, variables, model = _models(seed=2, bf16=True, use_flash=False)
    seen = []
    for blk in model.blocks:
        blk.mlp.register_forward_hook(
            lambda mod, inp, out: seen.append((inp[0].dtype, out[0].dtype)))
    x = _frames(2)
    ref_logits, ref_scores = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        logits, scores = model(_t(x))
    assert seen == [(torch.bfloat16, torch.float32), (torch.float32, torch.float32)]
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=ATOL)


def test_dense_attention_matches_jax_and_the_flash_route():
    """``use_flash=False`` without MoE: JAX's ``use_flash=False`` within
    2e-4, and the port's flash route on the same weights within 1e-5."""
    jmodel, variables, dense = _models(seed=3, moe_experts=0, use_flash=False)
    flash = T.TemporalTransformerDetector("tinyconv", device="cpu",
                                          **{**SMALL, "moe_experts": 0, "dropout_rate": 0.0})
    flash.load_state_dict(dense.state_dict(), strict=True)
    x = _frames(3)
    ref_logits, _ = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        logits, scores = dense(_t(x))
        flash_logits, flash_scores = flash(_t(x))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), flash_logits.numpy(), atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), flash_scores.numpy(), atol=1e-5)


def test_aux_is_reported_in_training_only_and_never_stored():
    """In training the forward returns ``{"moe_load_balance": aux}`` after
    its outputs, the blocks' mean, as JAX reports it; in eval it does not,
    and no parameter, buffer or ``state_dict`` key holds it."""
    jmodel, variables, model = _models(seed=4)
    x = _frames(4)
    _, jstate = jmodel.apply(variables, jnp.asarray(x), train=True)
    logits, scores, aux = model(_t(x), train=True)
    assert sorted(aux) == ["moe_load_balance"]
    np.testing.assert_allclose(float(aux["moe_load_balance"].detach()),
                               float(jstate["aux_losses"]["moe_load_balance"]), atol=1e-6)
    assert 1.0 <= float(aux["moe_load_balance"].detach()) <= 4.0
    assert len(model(_t(x), train=False)) == 2
    assert sorted(model.state_dict()) == sorted(jax_flatten(variables["params"]))
    assert not any("aux" in k or "load_balance" in k for k in model.state_dict())
    ev = S.make_eval_step(model)({"frames": _t(x)})
    assert sorted(ev) == ["logits", "probs"]


def _loss_fns():
    return (lambda lg, lb, sample_mask=None: JLoss.cross_entropy_loss(
                lg, lb, class_weights=CW, sample_mask=sample_mask),
            lambda lg, lb, sample_mask=None: L.cross_entropy_loss(
                lg, lb, class_weights=CW, sample_mask=sample_mask))


@pytest.mark.parametrize("remat", [False, True])
def test_moe_train_step_matches_jax(remat):
    """One Adam step with the aux term (weight 0.01) against JAX's
    ``make_train_step``: loss rtol 1e-5, grad norm 1e-4; the reported loss
    is the class-weighted CE plus 0.01 × aux; under ``remat`` the aux
    comes out of the checkpointed forward."""
    jmodel, variables, model = _models(seed=5)
    x, labels, valid = _frames(5), np.asarray([0, 1]), np.asarray([True, True])
    jloss, loss = _loss_fns()
    tx = JO.build_optimizer("adam", 1e-3, grad_clip=None)
    jstep = jax_make_train_step(jmodel, tx, jloss, donate=False, remat=remat)
    _, jm = jstep(JaxTrainState.create(variables, tx),
                  {"frames": jnp.asarray(x), "labels": jnp.asarray(labels),
                   "valid": jnp.asarray(valid)}, jax.random.PRNGKey(0))
    opt = O.build_optimizer("adam", 1e-3, grad_clip=None)
    step = S.make_train_step(model, opt, loss, remat=remat)
    with torch.no_grad():
        logits, _, aux = model(_t(x), train=True)
        ce = float(loss(logits, _t(labels), sample_mask=_t(valid)))
    state, m = step(TrainState.create(model, opt),
                    {"frames": _t(x), "labels": _t(labels), "valid": _t(valid)})
    assert state.step == 1 and int(m["correct"]) == int(jm["correct"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["loss"]), ce + 0.01 * float(aux["moe_load_balance"]),
                               rtol=1e-6)


def test_moe_accum_step_matches_jax():
    """``grad_accum = 2`` against JAX's ``make_accum_step``: each microbatch
    adds 0.01 · aux / 2 to the differentiated loss, the reported loss stays
    the microbatches' weighted CE (loss rtol 1e-5, grad norm 1e-4)."""
    jmodel, variables, model = _models(seed=6)
    x = _frames(6, B=4).reshape(2, 2, FRAMES, SIZE, SIZE, 3)
    labels = np.asarray([[0, 1], [1, 1]])
    valid = np.ones((2, 2), bool)
    jloss, loss = _loss_fns()

    def jweights(lb, v):
        return jnp.asarray(CW)[lb] * v.astype(jnp.float32)

    def weights(lb, v):
        return _t(CW)[lb] * v.to(torch.float32)

    tx = JO.build_optimizer("adam", 1e-3, grad_clip=None)
    jstep = jax_make_accum_step(jmodel, tx, jloss, 2, donate=False, sample_weight_fn=jweights)
    _, jm = jstep(JaxTrainState.create(variables, tx),
                  {"frames": jnp.asarray(x), "labels": jnp.asarray(labels),
                   "valid": jnp.asarray(valid)}, jax.random.PRNGKey(0))
    opt = O.build_optimizer("adam", 1e-3, grad_clip=None)
    step = S.make_accum_step(model, opt, loss, 2, sample_weight_fn=weights)
    _, m = step(TrainState.create(model, opt),
                {"frames": _t(x), "labels": _t(labels), "valid": _t(valid)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(m["count"]) == int(jm["count"]) == 4


# ---------------------------------------------------------------------------
# checkpoints, the loaders, the evaluator and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    for k in ("COMPUTE_DTYPE", "QUANTIZE", "FAKE_CLASS_INDEX"):
        monkeypatch.delenv(k, raising=False)


def _prob_fake(logits):
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))[:, 1]


def test_jax_moe_checkpoints_load_in_the_port(tmp_path):
    """A JAX MoE ``.npz`` and its reference ``.pt`` through the port's
    ``load_model`` and evaluator rebuild: match ratio 1.0, four experts a
    block, ``prob_fake`` within 5e-4 of JAX's."""
    jmodel, variables, _ = _models(seed=7)
    cfg = {"model_type": "temporal", "backbone": "tinyconv", "d_model": 16, "depth": 2,
           "num_heads": 2, "moe_experts": 4}
    npz, pt = str(tmp_path / "moe.npz"), str(tmp_path / "moe.pt")
    jax_save_checkpoint(npz, variables, meta={"model_config": cfg})
    jax_save_torch_checkpoint(pt, variables, layout="model_config", meta={"model_config": cfg})
    x = _frames(7)
    ref = _prob_fake(_jax_forward(jmodel, variables, x)[0])
    for path in (npz, pt):
        model, _, stats = port_loader.load_model(path, device="cpu")
        assert stats["model_type"] == "temporal" and stats["match_ratio"] == 1.0, path
        assert all(blk.mlp.num_experts == 4 for blk in model.blocks)
        with torch.no_grad():
            got = torch.softmax(model(_t(x))[0], -1)[:, 1].numpy()
        np.testing.assert_allclose(got, ref, atol=5e-4)
        sd, meta = E.load_any(path)
        emodel, report, mt = E.build_model_from_checkpoint(sd, meta, "", device="cpu")
        assert mt == "temporal" and report["match_ratio"] == 1.0
        with torch.no_grad():
            np.testing.assert_allclose(torch.softmax(emodel(_t(x))[0], -1)[:, 1].numpy(),
                                       ref, atol=5e-4)


def test_port_moe_checkpoint_loads_in_jax(tmp_path):
    """The port's MoE ``.npz`` and ``.pt`` through JAX's ``load_model``: the
    same logits."""
    jmodel, _, model = _models(seed=8)
    with torch.no_grad():                      # move off the JAX init
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    cfg = {"model_type": "temporal", "backbone": "tinyconv", "d_model": 16, "depth": 2,
           "num_heads": 2, "moe_experts": 4}
    npz, pt = str(tmp_path / "port_moe.npz"), str(tmp_path / "port_moe.pt")
    save_checkpoint(npz, model.state_dict(), {"model_config": cfg})
    save_torch_checkpoint(pt, model.state_dict(), "model_config", {"model_config": cfg})
    x = _frames(8)
    with torch.no_grad():
        logits = model(_t(x))[0].numpy()
    for path in (npz, pt):
        jm, jv, jstats = jax_loader.load_model(path)
        assert jstats["match_ratio"] == 1.0 and jm.moe is not None, path
        jv = {"params": jv["params"], "state": {"backbone": {}}}
        np.testing.assert_allclose(_jax_forward(jm, jv, x)[0], logits, atol=ATOL)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Eight clips of 12 frames at 16 px, half labelled fake."""
    d = tmp_path_factory.mktemp("moe_clips")
    rng = np.random.default_rng(9)
    for i in range(8):
        label = i % 2
        np.savez(d / f"clip_{i}_{'fake' if label else 'real'}.npz", label=np.int64(label),
                 faces=rng.integers(0, 256, (12, SIZE, SIZE, 3), dtype=np.uint8))
    return str(d)


def test_cli_trains_an_moe_model_that_jax_rebuilds(clips, tmp_path, capsys):
    """``--model temporal --moe_experts 2`` on the CPU: JAX's plan line,
    ``model_config`` with ``moe_experts``, and a checkpoint JAX's evaluator
    rebuilds with the same logits (JAX's CLI names the dense plan the same
    way when ``--expert_par 1`` keeps its 8 test devices out of it)."""
    out = tmp_path / "run"
    assert cli.main(["--data_dir", clips, "--model", "temporal", "--backbone", "tinyconv",
                     "--d_model", "16", "--depth", "2", "--heads", "2", "--moe_experts", "2",
                     "--epochs", "1", "--batch_size", "2", "--num_frames", "4", "--smoke",
                     "--out_dir", str(out), "--device", "cpu"]) == 0
    assert "parallelism plan: dp=1,moe=2e(dense) over 1 devices" in capsys.readouterr().out
    jplan, jkw = jax_build_plan(argparse.Namespace(moe_experts=2, expert_par=1), "temporal",
                                4, depth=2, n_devices=1)
    assert jplan.description == "dp=1,moe=2e(dense)" and jkw == {"moe_experts": 2}
    path = str(out / "checkpoint_best.npz")
    jsd, jmeta = jax_evaluate.load_any(path)
    assert jmeta["model_config"] == {"model_type": "temporal", "backbone": "tinyconv",
                                     "d_model": 16, "depth": 2, "num_heads": 2,
                                     "moe_experts": 2}
    jm, jv, report, _ = jax_evaluate.build_model_from_checkpoint(jsd, jmeta, "")
    assert report["match_ratio"] == 1.0 and jm.moe.num_experts == 2
    sd, meta = E.load_any(path)
    model, _, _ = E.build_model_from_checkpoint(sd, meta, "", device="cpu")
    x = _frames(10, B=1, T=4)
    with torch.no_grad():
        logits = model(_t(x))[0].numpy()
    ref, _ = _jax_forward(jm, {"params": jv["params"], "state": {"backbone": {}}}, x)
    np.testing.assert_allclose(logits, ref, atol=ATOL)


def test_cli_moe_flags_stop_as_jax_does(clips, tmp_path):
    """``--expert_par 2`` on a world of one stops with JAX's ``build_plan``
    message (one device is not divisible by the expert-parallel degree 2);
    ``--moe_experts`` on another model stops with JAX's message."""
    base = ["--data_dir", clips, "--out_dir", str(tmp_path), "--device", "cpu",
            "--moe_experts", "2"]
    with pytest.raises(ValueError) as ours:
        cli.main(base + ["--model", "temporal", "--expert_par", "2"])
    with pytest.raises(ValueError) as ref:
        jax_build_plan(argparse.Namespace(moe_experts=2, expert_par=2), "temporal", 16,
                       n_devices=1)
    assert str(ours.value) == str(ref.value) == \
        "1 devices not divisible by the expert-parallel degree 2"
    with pytest.raises(ValueError) as ours:
        cli.main(base + ["--model", "pretrained"])
    with pytest.raises(ValueError) as ref:
        jax_build_plan(argparse.Namespace(moe_experts=2), "pretrained", 16, n_devices=1)
    assert str(ours.value) == str(ref.value) == "--moe_experts requires --model temporal"
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("experts", [4, 16])
def test_int8_counts_match_jax(experts):
    """``QUANTIZE=int8`` on an MoE tree (d_model 256, tinyconv): the same
    weights quantized in both packages. ``w1``/``w2`` are not named
    ``weight``; the router's E·256 elements reach ``min_elems`` (4096) only
    at E = 16."""
    kw = dict(d_model=256, depth=1, num_heads=4, moe_experts=experts)
    variables = random_variables(JT.TemporalTransformerDetector("tinyconv", **kw), 11)
    _, n_ref = jax_quant.quantize_variables(variables)
    model = T.TemporalTransformerDetector("tinyconv", device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = _frames(11, B=1, T=2)
    with torch.no_grad():
        before = model(_t(x))[0]
    n = quant.quantize_module(model)
    assert n == n_ref
    quantized = {name for name, m in model.named_modules() if isinstance(m, quant.Int8Weight)}
    assert ("blocks.0.mlp.router.weight" in quantized) == (experts == 16)
    assert not any(name.endswith(("w1", "w2")) for name in quantized)
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x))[0].numpy(), before.numpy(), atol=5e-2)

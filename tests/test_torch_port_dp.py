"""Data parallelism, FSDP and tensor parallelism: the port's gloo ranks
against the JAX package's step, on the CPU.

One world of 4 processes runs every scenario of this file once (the
module-scoped ``world`` fixture launches this file as a script, one
process per rank, over a ``FileStore`` in a temporary directory, one
thread each, no JAX in a rank); each rank writes its results and the tests
compare them with JAX. JAX's sharded step computes the global batch's step,
so each case is held to JAX's step on one device (``tests/test_fsdp.py``
shows the two equal), on the same weights and batch:

* pure DP (``data=4``): one SGD step of the two-block ViT-Tiny detector at
  32 px on 8 clips, 3 of them padding (two ranks hold none valid): loss
  1e-5, grad norm 1e-4, every parameter;
* B0 at 48 px, 4 clips of 2 frames, one padded, under ``data=4`` (batch
  norm over the global batch), ``--mesh model=2`` (TP, data=2) and
  ``--fsdp --mesh model=2`` (FSDP x TP): every parameter and running stat,
  TP's eval forward, and FSDP x TP's placement line against JAX's;
* FSDP over ``data=4`` on ``tests/test_fsdp.py``'s two-layer model
  (``min_size`` 1): AdamW step, the parameters and moments held as 1/4
  shards, the placement line against JAX's;
* the ``multihost`` feed (each rank passes its own rows through
  ``global_batch_from_local``) against the global step, and
  ``grad_accum = 2`` under data=4 against JAX's accumulated step;
* the ``Trainer`` under a world-4 DP plan for one epoch on a tiny set:
  the ranks agree, rank 0's checkpoint is read by JAX's
  ``load_checkpoint`` and resumed by the port's ``Trainer``.

Single-process tests hold ``tp_param_pspec`` and ``make_fsdp_spec_fn`` to
JAX's for every leaf of the B0 detector's and ViT-B/16's trees.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
CW = np.asarray([0.8, 1.2], np.float32)
_STATS = ("running_mean", "running_var")
# the B0 cases: mesh flags for build_plan at 4 ranks
B0_CASES = {"dp": {}, "tp": {"mesh": "model=2"}, "fsdp_tp": {"mesh": "model=2", "fsdp": True}}


def _flags(**kw):
    import argparse

    base = dict(mesh=None, fsdp=False, seq="none", seq_par=1, pp_stages=1,
                pp_microbatches=2, moe_experts=0, expert_par=0)
    return argparse.Namespace(**dict(base, **kw))


def _vit_batch():
    rng = np.random.default_rng(11)
    return {"frames": rng.normal(size=(8, 2, 32, 32, 3)).astype(np.float32),
            "labels": np.asarray([0, 1, 1, 0, 1, 0, 0, 1]),
            "valid": np.asarray([True] * 5 + [False] * 3)}


def _b0_batch():
    rng = np.random.default_rng(12)
    return {"frames": rng.normal(size=(4, 2, 48, 48, 3)).astype(np.float32),
            "labels": np.asarray([0, 1, 1, 0]),
            "valid": np.asarray([True, True, True, False])}


def _tiny_batch():
    rng = np.random.default_rng(0)             # tests/test_fsdp.py's batch
    return {"frames": rng.random((8, 2, 16, 16, 3)).astype(np.float32),
            "labels": (np.arange(8) % 2).astype(np.int64)}


def _accum_batch():
    """The tiny batch with 3 rows padded out (``valid`` False)."""
    return dict(_tiny_batch(), valid=np.asarray([True] * 5 + [False] * 3))


class TinyNet(torch.nn.Module):
    """``tests/test_fsdp.py::_Tiny`` in the port: mean-pooled frames → 8
    ReLU units → 2 logits."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 8)
        self.head = torch.nn.Linear(8, 2)

    def forward(self, x, train=False, generator=None):
        feats = x.to(torch.float32).mean(dim=(1, 2, 3))
        return self.head(torch.relu(self.proj(feats)))


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------


def _ce(cw):
    from deepfake_video_detection_tpu_torch.train import losses as Loss

    return lambda lg, lb, sample_mask=None: Loss.cross_entropy_loss(
        lg, lb, class_weights=cw, label_smoothing=0.1 if cw is not None else 0.0,
        sample_mask=sample_mask)


def _vit_model():
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer

    m = BackboneDetector("vit_tiny_patch16_224", dropout_rate=0.0, device="cpu")
    m.backbone = VisionTransformer("vit_tiny_patch16_224", img_size=32, depth=2, device="cpu")
    return m


def _b0_model():
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector

    m = BackboneDetector("efficientnet_b0", dropout_rate=0.0, device="cpu")
    m.backbone.drop_path_rate = 0.0
    return m


def _step(model, plan, batch, opt, loss_fn, feed=None):
    from deepfake_video_detection_tpu_torch.parallel.mesh import shard_batch
    from deepfake_video_detection_tpu_torch.parallel.strategy import ParallelRuntime, place_model
    from deepfake_video_detection_tpu_torch.train.state import TrainState
    from deepfake_video_detection_tpu_torch.train.steps import make_train_step

    summary = place_model(model, plan.mesh, plan.param_spec_fn)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_fn, runtime=ParallelRuntime(plan.mesh))
    local = feed if feed is not None else shard_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, plan.mesh)
    state, m = step(state, local)
    return state, m, summary


def _full_state(model):
    """Every tensor of the state dict whole (FSDP shards gathered): the
    arrays on rank 0, their SHA-1 digests on the other ranks (the ranks must
    agree bit for bit; the digests keep the world's files small)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    out = {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().numpy()
           for k, v in model.state_dict().items()}
    if dist.get_rank() == 0:
        return out
    return {k: np.asarray(_digest(a)) for k, a in out.items()}


def _digest(a):
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _metrics(m):
    return {f"m_{k}": np.asarray(v) for k, v in m.items()}


def _rank_main(rank: int, world: int, d: pathlib.Path) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from deepfake_video_detection_tpu_torch.parallel.mesh import make_mesh
    from deepfake_video_detection_tpu_torch.parallel.multihost import (
        global_batch_from_local, local_batch_size)
    from deepfake_video_detection_tpu_torch.parallel.strategy import (
        build_plan, dp_plan, make_fsdp_spec_fn, ParallelPlan)
    from deepfake_video_detection_tpu_torch.train import optim as O

    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), world),
                            rank=rank, world_size=world)
    out = {}
    dp4 = dp_plan(make_mesh(device="cpu"))

    # pure DP, ViT-Tiny, a padded batch
    model = _vit_model()
    model.load_state_dict(torch.load(d / "vit.pt"), strict=True)
    _, m, _ = _step(model, dp4, _vit_batch(), O.build_optimizer("sgd", 0.5, grad_clip=0.1),
                    _ce(torch.from_numpy(CW)))
    out["vit_dp"] = {**_metrics(m), **_full_state(model)}

    # B0: DP with batch norm, TP, FSDP x TP
    for case, flags in B0_CASES.items():
        plan = dp4 if case == "dp" else build_plan(_flags(**flags), "pretrained", 2,
                                                    device="cpu")[0]
        model = _b0_model()
        model.load_state_dict(torch.load(d / "b0.pt"), strict=True)
        if case == "tp":      # the eval forward first, on this rank's rows
            from deepfake_video_detection_tpu_torch.parallel.mesh import shard_batch
            model.tensor_parallel(plan.mesh)
            with torch.no_grad():
                logits = model(shard_batch(torch.from_numpy(_b0_batch()["frames"]),
                                           plan.mesh))[0]
            out["b0_tp_forward"] = {"logits": logits.numpy()}
            model.tp = None
            model.backbone.head_split = None
        _, m, summary = _step(model, plan, _b0_batch(),
                              O.build_optimizer("sgd", 0.5, grad_clip=1.0),
                              _ce(torch.from_numpy(CW)))
        out[f"b0_{case}"] = {**_metrics(m), **_full_state(model),
                             "summary": np.asarray(summary, np.float64),
                             "desc": np.asarray(plan.description)}

    # FSDP over data=4 on the two-layer model, min_size 1
    torch.manual_seed(0)
    model = TinyNet()
    model.load_state_dict(torch.load(d / "tiny.pt"), strict=True)
    plan = ParallelPlan(mesh=dp4.mesh, param_spec_fn=make_fsdp_spec_fn(4, min_size=1),
                        pure_dp=False, description="dp=4,fsdp", batch_multiple=4,
                        mesh_shape={"data": 4})
    opt = O.build_optimizer("adamw", 1e-2, grad_clip=1.0)
    state, m, summary = _step(model, plan, _tiny_batch(), opt, _ce(None))
    pw, mu = model.proj.weight, state.opt_state["mu"]["proj.weight"]
    out["tiny_fsdp"] = {**_metrics(m), **_full_state(model),
                        "summary": np.asarray(summary, np.float64),
                        "dtensor": np.asarray([isinstance(pw, DTensor),
                                               isinstance(mu, DTensor)]),
                        "local_shapes": np.asarray([tuple(pw.to_local().shape),
                                                    tuple(mu.to_local().shape)])}

    # the multihost feed: each rank passes its own rows
    model = TinyNet()
    model.load_state_dict(torch.load(d / "tiny.pt"), strict=True)
    n = local_batch_size(8)
    rows = {k: v[rank * n:(rank + 1) * n] for k, v in _tiny_batch().items()}
    feed = global_batch_from_local(rows, dp4.mesh)
    _, m, _ = _step(model, dp4, None, O.build_optimizer("adamw", 1e-2, grad_clip=1.0),
                    _ce(None), feed=feed)
    out["tiny_multihost"] = {**_metrics(m), **_full_state(model), "n": np.asarray(n)}

    # gradient accumulation under DP: 2 microbatches of this rank's 2 rows
    from deepfake_video_detection_tpu_torch.parallel.strategy import ParallelRuntime
    from deepfake_video_detection_tpu_torch.train.state import TrainState
    from deepfake_video_detection_tpu_torch.train.steps import make_accum_step

    model = TinyNet()
    model.load_state_dict(torch.load(d / "tiny.pt"), strict=True)
    opt = O.build_optimizer("adamw", 1e-2, grad_clip=1.0)
    step = make_accum_step(model, opt, _ce(None), 2, runtime=ParallelRuntime(dp4.mesh))
    rows = {k: torch.from_numpy(v[rank * 2:(rank + 1) * 2]) for k, v in _accum_batch().items()}
    _, m = step(TrainState.create(model, opt),
                {k: v.reshape((2, 1) + tuple(v.shape[1:])) for k, v in rows.items()})
    out["tiny_accum"] = {**_metrics(m), **_full_state(model)}

    # the Trainer under a world-4 DP plan, one epoch
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    ds = VideoFacesDataset(str(d / "faces"), num_frames=2)
    model = BackboneDetector("tinyconv", dropout_rate=0.0, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    cfg = TrainerConfig(out_dir=str(d / "ckpt"), epochs=1, batch_size=6, num_frames=2,
                        lr=1e-2, optimizer="adam", schedule="const", grad_clip=None,
                        model_config={"model_type": "pretrained", "backbone": "tinyconv"})
    trainer = Trainer(model, ds, ds, cfg, mesh=dp4.mesh, device="cpu")
    state = trainer.train(log=lambda _m: None)
    out["trainer"] = {**_full_state(model), "step": np.asarray(state.step),
                      "history": np.asarray(json.dumps(   # the metrics, not the clock
                          [{k: v for k, v in row.items() if k != "epoch_time_s"}
                           for row in trainer.history], default=str))}

    for name, arrays in out.items():
        np.savez(d / f"{name}.{rank}.npz", **arrays)
    dist.barrier()
    dist.destroy_process_group()
    assert not any(m == "jax" or m.startswith(("jax.", "deepfake_video_detection_tpu."))
                   for m in sys.modules), "a rank imported JAX"


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the parent: JAX references
# ---------------------------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


_JAX = {}


def _jax_models():
    """``{name: (JAX model, variables)}`` for the ViT, B0 and tiny cases
    (numpy-filled trees; the tiny model's is ``tests/test_fsdp.py``'s)."""
    if not _JAX:
        jax, _ = _jax()
        from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JD
        from deepfake_video_detection_tpu.models.vit import VisionTransformer as JViT
        from test_fsdp import _Tiny
        from test_torch_port_convnets import random_variables

        vit = JD("vit_tiny_patch16_224", dropout_rate=0.0)
        vit.backbone = JViT(variant="vit_tiny_patch16_224", img_size=32, depth=2)
        b0 = JD("efficientnet_b0", dropout_rate=0.0)
        b0.backbone.drop_path_rate = 0.0
        tiny = _Tiny()
        _JAX.update(vit=(vit, random_variables(vit, 31)), b0=(b0, random_variables(b0, 32)),
                    tiny=(tiny, jax.tree_util.tree_map(np.asarray,
                                                       tiny.init(jax.random.PRNGKey(0)))))
    return _JAX


def _sd(variables):
    jax, _ = _jax()
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Write the weights and a face set, run the world once; returns its
    directory of per-rank results."""
    d = tmp_path_factory.mktemp("dp_world")
    for name, (_, v) in _jax_models().items():
        torch.save(_sd(v), d / f"{name}.pt")
    faces = d / "faces"
    faces.mkdir()
    rng = np.random.default_rng(9)
    for i in range(10):
        np.savez(faces / f"clip_{i}_{'fake' if i % 2 else 'real'}.npz",
                 faces=rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
                 label=np.int64(i % 2))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(d)],
                              env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return d


def _load(d, name, rank):
    """Rank ``rank``'s results; a state kept as digests (ranks above 0) is
    checked against rank 0's arrays and replaced by them."""
    with np.load(d / f"{name}.{rank}.npz") as z:
        got = {k: z[k] for k in z.files}
    if rank:
        zero = _load(d, name, 0)
        for k, v in got.items():
            if v.dtype.kind == "U" and v.ndim == 0 and k in zero and zero[k].dtype.kind != "U":
                assert str(v) == _digest(zero[k]), f"rank {rank} differs from rank 0 at {k}"
                got[k] = zero[k]
    return got


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's one-device steps of the cases, each compiled once."""
    jax, jnp = _jax()
    from deepfake_video_detection_tpu.train import losses as JLoss
    from deepfake_video_detection_tpu.train import optim as JO
    from deepfake_video_detection_tpu.train.state import TrainState as JState
    from deepfake_video_detection_tpu.train.steps import make_train_step as jstep

    def run(name, batch, tx, cw):
        jm, v = _jax_models()[name]
        step = jstep(jm, tx, lambda lg, lb, sample_mask=None: JLoss.cross_entropy_loss(
            lg, lb, class_weights=cw, label_smoothing=0.1 if cw is not None else 0.0,
            sample_mask=sample_mask), donate=False)
        st, m = step(JState.create(v, tx), {k: jnp.asarray(a) for k, a in batch.items()},
                     None)
        return _sd(st.variables), m

    return {"vit": run("vit", _vit_batch(), JO.build_optimizer("sgd", 0.5, grad_clip=0.1), CW),
            "b0": run("b0", _b0_batch(), JO.build_optimizer("sgd", 0.5, grad_clip=1.0), CW),
            "tiny": run("tiny", _tiny_batch(), JO.build_optimizer("adamw", 1e-2, grad_clip=1.0),
                        None)}


def _assert_step(got, ref, jm, count, stats_tol=1e-5):
    assert int(got["m_count"]) == count and int(got["m_correct"]) == int(jm["correct"])
    np.testing.assert_allclose(got["m_loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["m_grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    for k, want in ref.items():
        tol = (stats_tol, stats_tol) if k.endswith(_STATS) else (1e-4, 2e-6)
        np.testing.assert_allclose(got[k], want.numpy(), rtol=tol[0], atol=tol[1], err_msg=k)


@pytest.mark.parametrize("rank", range(WORLD))
def test_dp_step_with_padded_batch_matches_jax(world, jax_steps, rank):
    """ViT-Tiny under data=4, 5 valid clips of 8 (ranks 2 and 3 hold none):
    the global masked mean, grad norm and update on every rank."""
    ref, jm = jax_steps["vit"]
    _assert_step(_load(world, "vit_dp", rank), ref, jm, count=5)


@pytest.mark.parametrize("case", list(B0_CASES))
@pytest.mark.parametrize("rank", range(WORLD))
def test_b0_step_matches_jax_under_dp_tp_and_fsdp_tp(world, jax_steps, case, rank):
    """B0 at 48 px: batch norm's running stats from the global batch, every
    parameter whole on every rank (FSDP's shards gathered)."""
    ref, jm = jax_steps["b0"]
    _assert_step(_load(world, f"b0_{case}", rank), ref, jm, count=3)


def test_tp_forward_matches_jax(world):
    """``--mesh model=2``: each data rank's logits (eval mode) against
    JAX's forward of the whole batch."""
    jax, jnp = _jax()
    jm, v = _jax_models()["b0"]
    (logits, _), _ = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(_b0_batch()["frames"]))
    for rank in range(WORLD):
        lo = (rank // 2) * 2
        np.testing.assert_allclose(_load(world, "b0_tp_forward", rank)["logits"],
                                   np.asarray(logits)[lo:lo + 2], rtol=1e-4, atol=1e-5)


def _jax_placement(name, mesh_shape, spec_fn):
    jax, _ = _jax()
    from jax.sharding import Mesh

    from deepfake_video_detection_tpu.parallel.strategy import place_variables, sharding_summary

    _, v = _jax_models()[name]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(mesh_shape),
                ("data", "model")[:len(mesh_shape)])
    return sharding_summary(place_variables(v, mesh, spec_fn)["params"])


def _line(desc, summary):
    from deepfake_video_detection_tpu_torch.parallel.strategy import ParallelPlan, placement_line

    n_sh, n_tot, frac = summary
    return placement_line(ParallelPlan(mesh=None, description=str(desc)),
                          (int(n_sh), int(n_tot), float(frac)))


def test_fsdp_tp_placement_line_equals_jax(world):
    from deepfake_video_detection_tpu.parallel import strategy as JS

    got = _load(world, "b0_fsdp_tp", 0)
    assert str(got["desc"]) == "dp=2,tp=2,fsdp"
    ref = _jax_placement("b0", (2, 2), JS.make_fsdp_spec_fn(2, base=JS.tp_param_pspec))
    assert _line(got["desc"], got["summary"]) == _line(got["desc"], ref)


@pytest.mark.parametrize("rank", range(WORLD))
def test_fsdp_step_matches_single_device(world, jax_steps, rank):
    """``tests/test_fsdp.py``'s AdamW step over data=4: the parameters, and
    ``proj.weight`` and its first moment held as (2, 3) shards."""
    ref, jm = jax_steps["tiny"]
    got = _load(world, "tiny_fsdp", rank)
    np.testing.assert_allclose(got["m_loss"], float(jm["loss"]), rtol=1e-5)
    for k, want in ref.items():
        np.testing.assert_allclose(got[k], want.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["dtensor"].all()
    assert got["local_shapes"].tolist() == [[2, 3], [2, 3]]


def test_fsdp_placement_line_equals_jax(world):
    from deepfake_video_detection_tpu.parallel import strategy as JS

    got = _load(world, "tiny_fsdp", 0)
    ref = _jax_placement("tiny", (4,), JS.make_fsdp_spec_fn(4, min_size=1))
    assert _line("dp=4,fsdp", got["summary"]) == _line("dp=4,fsdp", ref)


@pytest.mark.parametrize("rank", range(WORLD))
def test_multihost_feed_matches_global_step(world, jax_steps, rank):
    ref, jm = jax_steps["tiny"]
    got = _load(world, "tiny_multihost", rank)
    assert int(got["n"]) == 2 and int(got["m_count"]) == 8
    np.testing.assert_allclose(got["m_loss"], float(jm["loss"]), rtol=1e-5)
    for k, want in ref.items():
        np.testing.assert_allclose(got[k], want.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("rank", range(WORLD))
def test_dp_grad_accum_matches_jax(world, rank):
    """``grad_accum = 2`` under data=4 (each rank 2 microbatches of one row,
    3 rows of 8 padding): JAX's ``make_accum_step`` over the global batch
    as 2 microbatches of 4."""
    jax, jnp = _jax()
    from deepfake_video_detection_tpu.train import losses as JLoss
    from deepfake_video_detection_tpu.train import optim as JO
    from deepfake_video_detection_tpu.train.state import TrainState as JState
    from deepfake_video_detection_tpu.train.steps import make_accum_step as jaccum

    jm, v = _jax_models()["tiny"]
    tx = JO.build_optimizer("adamw", 1e-2, grad_clip=1.0)

    def weights(labels, valid):
        return valid.astype(jnp.float32)

    step = jaccum(jm, tx, lambda lg, lb, sample_mask=None: JLoss.cross_entropy_loss(
        lg, lb, sample_mask=sample_mask), 2, donate=False, sample_weight_fn=weights)
    # JAX's microbatch i holds the global rows {i, i + 2, ...}: rank r's
    # rows (2r, 2r + 1) are its microbatches 0 and 1
    batch = {k: np.stack([a[0::2], a[1::2]]) for k, a in _accum_batch().items()}
    st, jm_ = step(JState.create(v, tx), {k: jnp.asarray(a) for k, a in batch.items()},
                   jax.random.PRNGKey(0))
    got = _load(world, "tiny_accum", rank)
    assert int(got["m_count"]) == 5 and int(got["m_correct"]) == int(jm_["correct"])
    np.testing.assert_allclose(got["m_loss"], float(jm_["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["m_grad_norm"], float(jm_["grad_norm"]), rtol=1e-4)
    for k, want in _sd(st.variables).items():
        np.testing.assert_allclose(got[k], want.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_world_checkpoint_reads_in_jax_and_resumes_in_the_port(world, tmp_path):
    """The ranks end equal; rank 0's ``checkpoint_best.npz`` holds those
    weights for JAX's ``load_checkpoint``, and the port's ``Trainer`` resumes
    it on one process (step and weights)."""
    from deepfake_video_detection_tpu.checkpoint.store import load_checkpoint as jload

    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    ranks = [_load(world, "trainer", r) for r in range(WORLD)]   # digests checked
    assert int(ranks[0]["step"]) == 2           # 10 clips in batches of 6
    history = json.loads(str(ranks[0]["history"]))
    assert len(history) == 1 and history[0]["epoch"] == 0
    path = world / "ckpt" / "checkpoint_best.npz"
    assert sorted(os.listdir(world / "ckpt")) == sorted(
        ["checkpoint_best.npz", "checkpoint_best_epoch_0.npz", "checkpoint_epoch_0.npz",
         "preds_epoch_0.csv", "training_history.csv"])
    variables, meta = jload(str(path))
    jsd = state_dict_from_jax(variables)
    for k, t in jsd.items():
        np.testing.assert_array_equal(t.numpy(), ranks[0][k], err_msg=k)
    assert meta["model_config"]["backbone"] == "tinyconv"
    model = BackboneDetector("tinyconv", dropout_rate=0.0, device="cpu")
    ds = VideoFacesDataset(str(world / "faces"), num_frames=2)
    trainer = Trainer(model, ds, ds, TrainerConfig(out_dir=str(tmp_path), epochs=1,
                                                   batch_size=6, num_frames=2),
                      device="cpu")
    state = trainer.resume(str(path))
    assert state.step == 2 and trainer.start_epoch == 1
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ranks[0][k], err_msg=k)


# ---------------------------------------------------------------------------
# single process: the sharding rules on the real trees
# ---------------------------------------------------------------------------


def _tree_shapes(backbone):
    jax, _ = _jax()
    from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JD
    from deepfake_video_detection_tpu.utils.tree import flatten_dotted

    shapes = jax.eval_shape(JD(backbone).init, jax.random.PRNGKey(0))["params"]
    return {k: tuple(v.shape) for k, v in flatten_dotted(shapes).items()}


@pytest.mark.parametrize("backbone", ["efficientnet_b0", "vit_base_patch16_224"])
@pytest.mark.parametrize("data", [2, 4, 8])
def test_sharding_rules_equal_jax_on_every_leaf(backbone, data):
    """``tp_param_pspec``, ``make_fsdp_spec_fn`` alone and over TP, for
    every leaf of the detector's tree (JAX-layout shapes), and the torch dim
    each FSDP spec shards."""
    from deepfake_video_detection_tpu.parallel import strategy as JS

    from deepfake_video_detection_tpu_torch.parallel import strategy as S

    shapes = _tree_shapes(backbone)
    pairs = [(JS.tp_param_pspec, S.tp_param_pspec),
             (JS.make_fsdp_spec_fn(data), S.make_fsdp_spec_fn(data)),
             (JS.make_fsdp_spec_fn(data, base=JS.tp_param_pspec),
              S.make_fsdp_spec_fn(data, base=S.tp_param_pspec))]
    for path, shape in shapes.items():
        for jfn, fn in pairs:
            assert fn(path, shape) == tuple(jfn(path, shape)), path
        spec = S.make_fsdp_spec_fn(data)(path, shape)
        if "data" in spec and len(shape) == 4:     # HWIO dim → OIHW dim, same size
            torch_shape = (shape[3], shape[2], shape[0], shape[1])
            assert torch_shape[S.torch_dim(spec.index("data"), 4)] == \
                shape[spec.index("data")]
            assert S.jax_shape(torch_shape) == shape

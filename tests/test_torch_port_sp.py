"""Sequence, expert and pipeline parallelism: the port's gloo ranks against
the JAX package on as many host devices, on the CPU.

One world of 4 processes runs every scenario of this file once (the
module-scoped ``world`` fixture launches this file as a script, one
process per rank, over a ``FileStore`` in a temporary directory, one
thread each, no JAX in a rank); each rank writes its results, and the
tests compare them with the JAX package's functions on meshes of the same
shape over the parent's 8 host devices:

* ring and Ulysses attention, forward and gradients, at S = 2 (mesh
  data=2 x seq=2) and S = 4 (data=1 x seq=4), at N = 64 and N = 1040
  (blocks below and above 512 rows), f32 within 1e-5;
* ``MoEMLP.apply_expert_parallel`` at G = 2 (data=2 x expert=2) and G = 4
  with a router that overflows expert 0's capacity, outputs, load-balance
  loss and gradients;
* ``pipeline_blocks`` on ``tests/test_pipeline.py``'s blocks at stage=4
  and data=2 x stage=2, outputs and gradients;
* one train step of the temporal transformer (tinyconv, T = 8, a padded
  batch) under the plans ``build_plan`` gives for ``--seq ring``,
  ``--seq ulysses``, ``--moe_experts 4 --expert_par 2`` and
  ``--pp_stages 2``, against JAX's step under JAX's plan: loss, grad norm
  and every parameter (the stages' blocks gathered); under the pipeline
  each rank holds its stage's block and that block's optimizer slots
  alone;
* the training CLI for one epoch under ``--seq ring``, ``--pp_stages 2``
  and the expert-parallel flags: rank 0's checkpoint in JAX's loader and
  in the no-plan port; the ``--pp_stages 2`` checkpoint holds every block
  and its Adam moments, each rank of a ``--pp_stages 2`` ``Trainer``
  resumes its stage's share, and a no-plan ``Trainer`` resumes it whole.

Single-process tests hold Ulysses' two errors and ``build_plan`` (every
description, batch multiple, model kwarg and message over a table of
flags at 1, 2, 4 and 8 devices) to JAX's word for word.
"""

import argparse
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.models.temporal_transformer import normalize_state_dict
from deepfake_video_detection_tpu_torch.utils.tree import flatten_dotted

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
SIZE, T, B = 16, 8, 4
TEMPORAL = {"d_model": 16, "depth": 2, "num_heads": 2, "dropout_rate": 0.0}
CW = np.asarray([0.8, 1.2], np.float32)
STEP_FLAGS = {
    "ring": {"seq": "ring", "seq_par": 2},
    "ulysses": {"seq": "ulysses", "seq_par": 2},
    "ep": {"moe_experts": 4, "expert_par": 2},
    "pp": {"pp_stages": 2, "pp_microbatches": 2},
}
# (strategy, S, N): blocks of 32 and 16 rows, and at N = 1040 of 520 (above
# the 512 rows of the short-N kernels) and 260
ATTN_CASES = [(kind, s, n) for kind in ("ring", "ulysses") for s in (2, 4) for n in (64, 1040)]


def _flags(**kw):
    base = dict(mesh=None, fsdp=False, seq="none", seq_par=1, pp_stages=1,
                pp_microbatches=2, moe_experts=0, expert_par=0)
    return argparse.Namespace(**dict(base, **kw))


# ---------------------------------------------------------------------------
# inputs, written by the parent before the world starts
# ---------------------------------------------------------------------------


def _attn_inputs(s, n):
    """q, k, v and the cotangent, (2, H, N, 16) f32 with H = 2 S."""
    rng = np.random.default_rng(100 * s + n)
    return [rng.normal(size=(2, 2 * s, n, 16)).astype(np.float32) for _ in range(4)]


def _moe_inputs():
    """16 tokens of width 8, most routed to expert 0 (capacity 4 at
    capacity_factor 1): the router, the experts and a cotangent."""
    rng = np.random.default_rng(7)
    bias = rng.normal(size=(8,))
    x = (rng.normal(size=(16, 8)) * 0.5 + bias).astype(np.float32)
    router = (rng.normal(size=(4, 8)) * 0.1).astype(np.float32)
    router[0] += 2.0 * bias.astype(np.float32)
    w1 = (rng.normal(size=(4, 8, 16)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(4, 16, 8)) * 0.3).astype(np.float32)
    dout = rng.normal(size=(16, 8)).astype(np.float32)
    return x, router, w1, w2, dout


def _pipe_inputs(L=8, D=6, M=4, mb=2, seed=0):
    rng = np.random.default_rng(seed)         # tests/test_pipeline.py::_make
    w = rng.normal(0, 0.5, (L, D, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (L, D)).astype(np.float32)
    x = rng.normal(size=(M, mb, D)).astype(np.float32)
    return w, b, x


def _step_batch(seed=5):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, T, SIZE, SIZE, 3)).astype(np.float32)
    return {"frames": frames, "labels": np.asarray([0, 1, 1, 0]),
            "valid": np.asarray([True, True, True, False])}


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _rank_attention(out, mesh_cache):
    from deepfake_video_detection_tpu_torch.ops.ring_attention import ring_attention
    from deepfake_video_detection_tpu_torch.ops.ulysses_attention import ulysses_attention
    from deepfake_video_detection_tpu_torch.parallel.mesh import axis_rank, shard_batch

    for kind, s, n in ATTN_CASES:
        mesh = mesh_cache[s]
        q, k, v, dout = (torch.from_numpy(a) for a in _attn_inputs(s, n))
        spec = lambda key: ("data", None, "seq")   # noqa: E731
        loc = shard_batch({"q": q, "k": k, "v": v, "dout": dout}, mesh, specs=spec)
        qs, ks, vs = (loc[x].clone().requires_grad_() for x in "qkv")
        fn = ring_attention if kind == "ring" else ulysses_attention
        o = fn(qs, ks, vs, mesh, seq_axis="seq", batch_axis="data")
        o.backward(loc["dout"])
        out[f"attn_{kind}_{s}_{n}"] = {
            "out": o.detach().numpy(), "dq": qs.grad.numpy(), "dk": ks.grad.numpy(),
            "dv": vs.grad.numpy(), "coords": np.asarray([axis_rank(mesh, "data"),
                                                         axis_rank(mesh, "seq")])}


def _rank_moe(out, meshes):
    import torch.distributed as dist

    from deepfake_video_detection_tpu_torch.nn.moe import MoEMLP
    from deepfake_video_detection_tpu_torch.parallel.mesh import shard_batch

    x, router, w1, w2, dout = _moe_inputs()     # noqa: F841 (dout below)
    for g, mesh in meshes.items():
        moe = MoEMLP(8, 16, 4, capacity_factor=1.0, device="cpu")
        with torch.no_grad():
            moe.router.weight.copy_(torch.from_numpy(router))
            moe.w1.copy_(torch.from_numpy(w1))
            moe.w2.copy_(torch.from_numpy(w2))
        xs = shard_batch(torch.from_numpy(x), mesh).clone().requires_grad_()
        y, aux = moe.apply_expert_parallel(xs, mesh, "expert", with_aux=True)
        # each rank's share: its rows' cotangent over the expert replicas,
        # the (global) aux over the world
        (torch.sum(y * shard_batch(torch.from_numpy(dout), mesh)) / g
         + aux / dist.get_world_size()).backward()
        grads = {n: p.grad.clone() for n, p in moe.named_parameters()}
        for t in grads.values():
            dist.all_reduce(t)
        # x's gradient: the sum of its replicas' over the expert axis
        dist.all_reduce(xs.grad, group=mesh.get_group("expert"))
        out[f"moe_{g}"] = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
                           "dx": xs.grad.numpy(),
                           **{n: t.numpy() for n, t in grads.items()}}


def _rank_pipeline(out, meshes):
    import torch.distributed as dist

    from deepfake_video_detection_tpu_torch.parallel.mesh import axis_size, shard_batch
    from deepfake_video_detection_tpu_torch.parallel.pipeline import pipeline_blocks

    w, b, x = (torch.from_numpy(a) for a in _pipe_inputs())
    for name, mesh in meshes.items():
        W, Bv = w.clone().requires_grad_(), b.clone().requires_grad_()
        xs = shard_batch(x.transpose(0, 1), mesh).transpose(0, 1)    # rows of each microbatch
        blocks = [{"w": W[i], "b": Bv[i]} for i in range(W.shape[0])]
        y = pipeline_blocks(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), blocks, xs, mesh,
                            stage_axis="stage", batch_axis="data")
        (torch.sum(y ** 2) / axis_size(mesh, "stage")).backward()
        for t in (W.grad, Bv.grad):
            dist.all_reduce(t)
        out[f"pipe_{name}"] = {"y": y.detach().numpy(), "dw": W.grad.numpy(),
                               "db": Bv.grad.numpy()}


def _rank_steps(out, d):
    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)
    from deepfake_video_detection_tpu_torch.parallel.mesh import shard_batch
    from deepfake_video_detection_tpu_torch.parallel.strategy import (
        ParallelRuntime, build_plan, place_model)
    from deepfake_video_detection_tpu_torch.train import losses as Loss
    from deepfake_video_detection_tpu_torch.train import optim as O
    from deepfake_video_detection_tpu_torch.train.state import TrainState
    from deepfake_video_detection_tpu_torch.train.steps import make_train_step

    def blocks(names):
        return np.asarray(sorted({int(n.split(".")[1]) for n in names
                                  if n.startswith("blocks.")}))

    batch = {k: torch.from_numpy(v) for k, v in _step_batch().items()}
    for case, flags in STEP_FLAGS.items():
        plan, kw = build_plan(_flags(**flags), "temporal", T, depth=TEMPORAL["depth"],
                              device="cpu")
        model = TemporalTransformerDetector("tinyconv", device="cpu", **TEMPORAL, **kw)
        model.load_state_dict(torch.load(d / f"step_{case}.pt"), strict=True)
        place_model(model, plan.mesh, plan.param_spec_fn)
        opt = O.build_optimizer("sgd", 0.5, grad_clip=1.0)
        rt = ParallelRuntime(plan.mesh)
        step = make_train_step(
            model, opt, lambda lg, lb, sample_mask=None: Loss.cross_entropy_loss(
                lg, lb, class_weights=CW, sample_mask=sample_mask), runtime=rt)
        state, m = step(TrainState.create(model, opt),
                        shard_batch(batch, plan.mesh, specs=plan.batch_spec))
        out[f"step_{case}"] = {"loss": m["loss"].numpy(), "grad_norm": m["grad_norm"].numpy(),
                               "correct": m["correct"].numpy(), "count": m["count"].numpy(),
                               "desc": np.asarray(plan.description),
                               "held_blocks": blocks(state.params),
                               "slot_blocks": blocks(state.opt_state["trace"]),
                               "block_numel": np.asarray(sum(
                                   p.numel() for n, p in state.params.items()
                                   if n.startswith("blocks."))),
                               **{k: v.numpy()
                                  for k, v in rt.gather_stages(model.state_dict()).items()}}


CLI_FLAGS = {"ring": ["--seq", "ring"], "pp": ["--pp_stages", "2"],
             "ep": ["--moe_experts", "4", "--expert_par", "2"]}


def _cli_args(d, case):
    return ["--data_dir", str(d / "faces"), "--model", "temporal", "--backbone", "tinyconv",
            "--num_frames", str(T), "--batch_size", "4", "--epochs", "1", "--d_model", "16",
            "--depth", "2", "--heads", "2", "--out_dir", str(d / f"cli_{case}"),
            "--device", "cpu", *CLI_FLAGS[case]]


def _rank_cli(d):
    """The training CLI under each plan, one epoch: rank 0 writes."""
    from deepfake_video_detection_tpu_torch.train import cli

    for case in CLI_FLAGS:
        assert cli.main(_cli_args(d, case)) == 0


def _rank_resume(out, d):
    """A ``--pp_stages 2`` ``Trainer`` resumes the CLI's pipeline
    checkpoint: this rank's parameters and Adam moments."""
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)
    from deepfake_video_detection_tpu_torch.parallel.strategy import build_plan
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    plan, kw = build_plan(_flags(**STEP_FLAGS["pp"]), "temporal", T, depth=TEMPORAL["depth"],
                          device="cpu")
    model = TemporalTransformerDetector("tinyconv", device="cpu", **TEMPORAL, **kw)
    ds = VideoFacesDataset(str(d / "faces"), num_frames=T)
    trainer = Trainer(model, ds, ds, TrainerConfig(out_dir=str(d / "resume_pp"), epochs=2,
                                                   batch_size=4, num_frames=T),
                      plan=plan, device="cpu")
    state = trainer.resume(str(d / "cli_pp" / "checkpoint_epoch_0.npz"))
    out["resume_pp"] = {"step": np.asarray(state.step),
                        **{f"param.{n}": p.detach().numpy() for n, p in state.params.items()},
                        **{f"mu.{n}": t.numpy() for n, t in state.opt_state["mu"].items()},
                        **{f"nu.{n}": t.numpy() for n, t in state.opt_state["nu"].items()}}


def _rank_main(rank: int, world: int, d: pathlib.Path) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    store = dist.FileStore(str(d / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out = {}
    attn_meshes = {2: _mesh((2, 2), ("data", "seq")), 4: _mesh((1, 4), ("data", "seq"))}
    _rank_attention(out, attn_meshes)
    _rank_moe(out, {2: _mesh((2, 2), ("data", "expert")), 4: _mesh((1, 4), ("data", "expert"))})
    _rank_pipeline(out, {"stage": _mesh((1, 4), ("data", "stage")),
                         "data_stage": _mesh((2, 2), ("data", "stage"))})
    _rank_steps(out, d)
    _rank_cli(d)
    _rank_resume(out, d)
    for name, arrays in out.items():
        np.savez(d / f"{name}.{rank}.npz", **arrays)
    dist.barrier()
    dist.destroy_process_group()
    assert not any(m == "jax" or m.startswith(("jax.", "deepfake_video_detection_tpu."))
                   for m in sys.modules), "a rank imported JAX"
    (d / f"done.{rank}").write_text("ok")


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


def _jmesh(shape, names):
    jax, _ = _jax()
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


_JAX_STEPS = {}


def _jax_step_case(case):
    """``(JAX model, its plan, variables)`` for a step case, the variables
    from ``random_variables`` (cached per file)."""
    if case not in _JAX_STEPS:
        from deepfake_video_detection_tpu.models.temporal_transformer import (
            TemporalTransformerDetector as JT)
        from deepfake_video_detection_tpu.parallel.strategy import build_plan as jbp
        from test_torch_port_convnets import random_variables

        plan, kw = jbp(_flags(**STEP_FLAGS[case]), "temporal", T, depth=TEMPORAL["depth"],
                       n_devices=WORLD)
        jm = JT("tinyconv", **TEMPORAL, **kw)
        _JAX_STEPS[case] = (jm, plan, random_variables(jm, 20 + list(STEP_FLAGS).index(case)))
    return _JAX_STEPS[case]


def _port_state_dict(variables):
    """A JAX variables tree (loop or pipeline layout) as the port's
    loop-layout ``state_dict``."""
    jax, _ = _jax()
    v = jax.tree_util.tree_map(np.asarray, variables)
    return state_dict_from_jax(normalize_state_dict(
        flatten_dotted(v["params"]) | flatten_dotted(v["state"])))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world once; returns its directory of per-rank results."""
    d = tmp_path_factory.mktemp("sp_world")
    for case in STEP_FLAGS:
        _, _, v = _jax_step_case(case)
        torch.save(_port_state_dict(v), d / f"step_{case}.pt")
    faces = d / "faces"
    faces.mkdir()
    rng = np.random.default_rng(4)
    for i in range(10):
        np.savez(faces / f"clip_{i}_{'fake' if i % 2 else 'real'}.npz",
                 faces=rng.integers(0, 256, (T, SIZE, SIZE, 3), dtype=np.uint8),
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
    with np.load(d / f"{name}.{rank}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind,s,n", ATTN_CASES)
def test_sequence_parallel_attention_matches_jax(world, kind, s, n):
    """Each rank's output block and dq/dk/dv against JAX's ring or Ulysses
    attention (and its VJP) on the same mesh shape, within 1e-5."""
    jax, jnp = _jax()
    if kind == "ring":
        from deepfake_video_detection_tpu.ops.ring_attention import ring_attention as fn
    else:
        from deepfake_video_detection_tpu.ops.ulysses_attention import ulysses_attention as fn
    mesh = _jmesh((4 // s, s), ("data", "seq"))
    q, k, v, dout = _attn_inputs(s, n)

    @jax.jit
    def fwd_bwd(q, k, v, dout):
        o, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, mesh, seq_axis="seq",
                                            batch_axis="data"), q, k, v)
        return (o,) + vjp(dout)

    ref = dict(zip(("out", "dq", "dk", "dv"), fwd_bwd(*(jnp.asarray(a) for a in (q, k, v, dout)))))
    rows, blk = 2 // (4 // s), n // s
    for rank in range(WORLD):
        got = _load(world, f"attn_{kind}_{s}_{n}", rank)
        di, si = got["coords"]
        for key, r in ref.items():
            want = np.asarray(r)[di * rows:(di + 1) * rows, :, si * blk:(si + 1) * blk]
            np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("groups", [2, 4])
def test_expert_parallel_matches_jax_with_drops(world, groups):
    """``apply_expert_parallel`` at G = 2 (data=2) and G = 4: each rank's
    output rows (dropped tokens zero), the aux loss and the gradients of x,
    the router and the experts against JAX's on the same mesh."""
    jax, jnp = _jax()
    from deepfake_video_detection_tpu.nn.moe import MoEMLP as JMoE

    x, router, w1, w2, dout = _moe_inputs()
    jm = JMoE(8, 16, 4, capacity_factor=1.0)
    mesh = _jmesh((4 // groups, groups), ("data", "expert"))

    @jax.jit
    def fwd_bwd(p, x, dout):
        out, vjp = jax.vjp(lambda p, x: jm.apply_expert_parallel(
            p, x, mesh, "expert", with_aux=True), p, x)
        return out, vjp((dout, jnp.float32(1.0)))

    p = {"router": {"weight": jnp.asarray(router)}, "w1": jnp.asarray(w1),
         "w2": jnp.asarray(w2)}
    (y, aux), (gp, gx) = fwd_bwd(p, jnp.asarray(x), jnp.asarray(dout))
    y = np.asarray(y)
    assert (np.abs(y).sum(-1) == 0).sum() >= 4        # capacity 4: tokens dropped
    rows = 16 // (4 // groups)
    for rank in range(WORLD):
        got = _load(world, f"moe_{groups}", rank)
        lo = (rank // groups) * rows
        np.testing.assert_allclose(got["y"], y[lo:lo + rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dx"], np.asarray(gx)[lo:lo + rows], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)
        for name, want in (("router.weight", gp["router"]["weight"]), ("w1", gp["w1"]),
                           ("w2", gp["w2"])):
            np.testing.assert_allclose(got[name], np.asarray(want), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("layout", ["stage", "data_stage"])
def test_pipeline_blocks_match_jax(world, layout):
    """``tests/test_pipeline.py``'s stack of 8 blocks as 4 stages, and as
    2 stages x 2 data rows: outputs and the loss's gradients against
    JAX's ``pipeline_blocks`` on the same mesh."""
    jax, jnp = _jax()
    from deepfake_video_detection_tpu.parallel.pipeline import pipeline_blocks

    w, b, x = _pipe_inputs()
    shape = (1, 4) if layout == "stage" else (2, 2)
    mesh = _jmesh(shape, ("data", "stage"))

    def loss(params):
        y = pipeline_blocks(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), params,
                            jnp.asarray(x), mesh, stage_axis="stage", batch_axis="data")
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    mb = 2 // shape[0]
    for rank in range(WORLD):
        got = _load(world, f"pipe_{layout}", rank)
        lo = (rank // shape[1]) * mb
        np.testing.assert_allclose(got["y"], np.asarray(y)[:, lo:lo + mb], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["dw"], np.asarray(g["w"]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["db"], np.asarray(g["b"]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", list(STEP_FLAGS))
def test_temporal_step_matches_jax_under_the_plan(world, case):
    """One SGD step (a clip padded out, a clip that bites) of the temporal
    transformer over tinyconv under ``build_plan``'s plan for the case,
    against JAX's step under JAX's plan on 4 devices: the description,
    loss (1e-5), grad norm (1e-4), every parameter on every rank."""
    jax, jnp = _jax()
    from deepfake_video_detection_tpu.parallel.mesh import shard_batch as jshard
    from deepfake_video_detection_tpu.parallel.strategy import place_variables
    from deepfake_video_detection_tpu.train import losses as JLoss
    from deepfake_video_detection_tpu.train import optim as JO
    from deepfake_video_detection_tpu.train.state import TrainState as JState
    from deepfake_video_detection_tpu.train.steps import make_train_step as jstep

    jm, plan, v = _jax_step_case(case)
    tx = JO.build_optimizer("sgd", 0.5, grad_clip=1.0)
    step = jstep(jm, tx, lambda lg, lb, sample_mask=None: JLoss.cross_entropy_loss(
        lg, lb, class_weights=CW, sample_mask=sample_mask), mesh=None, donate=False)
    placed = place_variables(jax.tree_util.tree_map(np.asarray, v), plan.mesh,
                             plan.param_spec_fn)
    batch = jshard({k: np.asarray(a) for k, a in _step_batch().items()}, plan.mesh,
                   specs=plan.batch_spec)
    st, jmet = step(JState.create(placed, tx), batch, None)
    ref = _port_state_dict(st.variables)
    for rank in range(WORLD):
        got = _load(world, f"step_{case}", rank)
        assert str(got["desc"]) == plan.description
        assert int(got["count"]) == 3 and int(got["correct"]) == int(jmet["correct"])
        np.testing.assert_allclose(got["loss"], float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(jmet["grad_norm"]), rtol=1e-4)
        for k, want in ref.items():
            np.testing.assert_allclose(got[k], want.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} rank {rank}")


def test_pipeline_stage_holds_only_its_blocks(world):
    """Under ``--pp_stages 2`` (data=2 x stage=2, depth 2) rank r holds
    block r % 2 alone, its parameters (half the blocks') and its optimizer
    slots; under the other plans every rank holds both blocks (the dense
    ones under the sequence plans, twice the pipeline stage's)."""
    whole = int(_load(world, "step_ring", 0)["block_numel"])
    for case in STEP_FLAGS:
        for rank in range(WORLD):
            got = _load(world, f"step_{case}", rank)
            want = [rank % 2] if case == "pp" else [0, 1]
            assert got["held_blocks"].tolist() == got["slot_blocks"].tolist() == want, \
                (case, rank)
            if case != "ep":
                assert int(got["block_numel"]) == (whole // 2 if case == "pp" else whole)


def test_pipeline_checkpoint_resumes_per_stage_and_whole(world, tmp_path):
    """The ``--pp_stages 2`` CLI's checkpoint holds both blocks' weights and
    Adam moments (gathered to rank 0). A ``Trainer`` under the plan gives
    each rank its stage's share of them, and a no-plan ``Trainer`` on one
    process resumes all of them."""
    from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
        load_checkpoint, opt_state_from_leaves)
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    path = world / "cli_pp" / "checkpoint_epoch_0.npz"
    variables, meta = load_checkpoint(str(path))
    sd = state_dict_from_jax(variables)
    opt = opt_state_from_leaves(meta["opt_names"], meta["_opt_leaves"], "cpu")
    block_names = [k for k in sd if k.startswith("blocks.")]
    assert {int(k.split(".")[1]) for k in block_names} == {0, 1}
    for slot in ("mu", "nu"):
        assert set(block_names) <= set(opt[slot]), slot
    for rank in range(WORLD):
        got = _load(world, "resume_pp", rank)
        assert int(got["step"]) == int(meta["step"])
        held = {k[len("param."):] for k in got if k.startswith("param.")}
        assert {int(k.split(".")[1]) for k in held if k.startswith("blocks.")} == {rank % 2}
        assert held == set(sd) - {k for k in block_names
                                  if int(k.split(".")[1]) != rank % 2}
        for n in held:
            np.testing.assert_array_equal(got[f"param.{n}"], sd[n].numpy(), err_msg=n)
            for slot in ("mu", "nu"):
                np.testing.assert_array_equal(got[f"{slot}.{n}"], opt[slot][n].numpy(),
                                              err_msg=f"{slot} {n}")
    model = TemporalTransformerDetector("tinyconv", device="cpu", **TEMPORAL)
    ds = VideoFacesDataset(str(world / "faces"), num_frames=T)
    trainer = Trainer(model, ds, ds, TrainerConfig(out_dir=str(tmp_path), epochs=2,
                                                   batch_size=4, num_frames=T), device="cpu")
    state = trainer.resume(str(path))
    assert state.step == int(meta["step"]) and trainer.start_epoch == 1
    for n, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[n].numpy(), err_msg=n)
    for n, t in state.opt_state["mu"].items():
        np.testing.assert_array_equal(t.numpy(), opt["mu"][n].numpy(), err_msg=n)


@pytest.mark.parametrize("case", list(CLI_FLAGS))
def test_cli_trains_under_each_plan(world, case):
    """``train/cli.py`` at 4 ranks under ``--seq ring``, ``--pp_stages 2``
    and ``--moe_experts 4 --expert_par 2`` for one epoch: rank 0's
    checkpoint and history; JAX's ``load_checkpoint`` reads the checkpoint
    into the JAX model its ``model_config`` names (loop layout, the
    sequence-parallel model without its cls token), whose logits equal the
    port's on the same weights."""
    jax, jnp = _jax()
    from deepfake_video_detection_tpu.checkpoint.store import load_checkpoint as jload
    from deepfake_video_detection_tpu.models.temporal_transformer import (
        TemporalTransformerDetector as JT)

    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)

    out = world / f"cli_{case}"
    assert {"checkpoint_best.npz", "checkpoint_epoch_0.npz", "training_history.csv",
            "preds_epoch_0.csv"} <= set(os.listdir(out))
    variables, meta = jload(str(out / "checkpoint_best.npz"))
    cfg = meta["model_config"]
    assert cfg.get("use_cls", True) is (case != "ring")
    kw = {k: cfg[k] for k in ("d_model", "depth", "num_heads", "moe_experts", "use_cls")
          if k in cfg}
    jm = JT("tinyconv", dropout_rate=0.0, **kw)
    ref_keys = flatten_dotted(jax.eval_shape(jm.init, jax.random.PRNGKey(0))["params"])
    assert sorted(flatten_dotted(variables["params"])) == sorted(ref_keys)
    x = np.random.default_rng(6).normal(size=(2, T, SIZE, SIZE, 3)).astype(np.float32)
    (ref, _), _ = jm.apply({"params": variables["params"], "state": {"backbone": {}}},
                           jnp.asarray(x))
    model = TemporalTransformerDetector("tinyconv", device="cpu", dropout_rate=0.0, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        logits = model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=2e-4)


# ---------------------------------------------------------------------------
# single process: the rules and messages
# ---------------------------------------------------------------------------


class _StubMesh:
    """The two ``DeviceMesh`` methods ``ulysses_attention`` reads before any
    collective."""

    mesh_dim_names = ("data", "seq")

    def size(self, i):
        return (1, 2)[i]


@pytest.mark.parametrize("heads,n", [(3, 8), (4, 7)])
def test_ulysses_errors_equal_jax(heads, n):
    """Heads or length indivisible by the seq degree: JAX's ``ValueError``
    word for word."""
    _, jnp = _jax()
    from deepfake_video_detection_tpu.ops.ulysses_attention import ulysses_attention as jul

    from deepfake_video_detection_tpu_torch.ops.ulysses_attention import ulysses_attention

    x = jnp.zeros((1, heads, n, 4), jnp.float32)
    with pytest.raises(ValueError) as ref:
        jul(x, x, x, _jmesh((1, 2), ("data", "seq")), seq_axis="seq")
    t = torch.zeros(1, heads, n // 2 or 1, 4)
    with pytest.raises(ValueError) as ours:
        ulysses_attention(t, t, t, _StubMesh(), seq_axis="seq", seq_len=n)
    assert str(ours.value) == str(ref.value)


PLAN_CASES = [
    ("pretrained", {}), ("pretrained", {"mesh": "data=-1"}),
    ("pretrained", {"mesh": "model=2"}), ("pretrained", {"mesh": "data=2,model=2"}),
    ("pretrained", {"fsdp": True}), ("pretrained", {"fsdp": True, "mesh": "model=2"}),
    ("pretrained", {"mesh": "data=8"}), ("pretrained", {"mesh": "model=3"}),
    ("pretrained", {"mesh": "bad"}), ("temporal", {"mesh": "model=2"}),
    ("temporal", {"seq": "ring"}), ("temporal", {"seq": "ulysses", "seq_par": 4}),
    ("temporal", {"seq_par": 2}), ("temporal", {"seq": "ring", "seq_par": 3}),
    ("temporal", {"pp_stages": 2}), ("temporal", {"pp_stages": 2, "pp_microbatches": 4}),
    ("temporal", {"pp_stages": 3}), ("temporal", {"moe_experts": 4}),
    ("temporal", {"moe_experts": 4, "expert_par": 1}),
    ("temporal", {"moe_experts": 4, "expert_par": 2}),
    ("temporal", {"moe_experts": 6, "expert_par": 4}),
    ("temporal", {"moe_experts": 4, "mesh": "data=2"}),
    ("temporal", {"seq": "ring", "pp_stages": 2}),
    ("temporal", {"fsdp": True, "seq": "ring"}), ("temporal", {"fsdp": True}),
    ("pretrained", {"seq": "ring"}), ("pretrained", {"pp_stages": 2}),
    ("pretrained", {"moe_experts": 2}), ("vit_gcn", {"fsdp": True}),
]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("model,flags", PLAN_CASES)
def test_build_plan_equals_jax(model, flags, n):
    """Description, batch multiple, ``pure_dp``, scan flag, mesh shape and
    model kwargs (the mesh as its shape), or the ``ValueError`` text."""
    from deepfake_video_detection_tpu.parallel.strategy import build_plan as jbp

    from deepfake_video_detection_tpu_torch.parallel.strategy import build_plan

    def run(fn):
        try:
            return fn(_flags(**flags), model, 16, depth=4, n_devices=n), None
        except ValueError as e:
            return None, str(e)

    (ref, ref_err), (got, err) = run(jbp), run(build_plan)
    assert err == ref_err
    if ref is None:
        return
    (jplan, jkw), (plan, kw) = ref, got
    assert (jplan is None) == (plan is None)
    if jplan is None:
        assert kw == jkw == {}
        return
    assert plan.description == jplan.description
    assert plan.batch_multiple == jplan.batch_multiple
    assert plan.pure_dp == jplan.pure_dp
    assert plan.scan_of_steps_ok == jplan.scan_of_steps_ok
    assert plan.mesh_shape == dict(jplan.mesh.shape)
    assert plan.mesh is None
    assert {k: tuple(v) for k, v in jplan.batch_specs.items()} == plan.batch_specs
    assert sorted(kw) == sorted(jkw)
    assert {k: v for k, v in kw.items() if k != "mesh"} == \
        {k: v for k, v in jkw.items() if k != "mesh"}

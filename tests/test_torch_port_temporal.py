"""The port's temporal transformer (the long-clip family) vs the JAX
package's, on the CPU.

The JAX model runs its dense attention off the TPU; the port's runs the
flash Function, whose plain version serves CPU tensors. Weights come from
JAX ``init`` and cross with the port's bridge; inputs are made with numpy
from a seed. The tinyconv backbone at 16 px keeps T = 600 frames (N = 601
tokens with the cls token, past the JAX package's 512-token bound of its
short-N kernels) cheap. f32 and a tolerance of 2e-4 unless stated.
"""

import csv
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.checkpoint.store import save_checkpoint as jax_save_checkpoint
from deepfake_video_detection_tpu.checkpoint.store import (
    save_torch_checkpoint as jax_save_torch_checkpoint)
from deepfake_video_detection_tpu.data.dataset import VideoFacesDataset as JaxDataset
from deepfake_video_detection_tpu.evals import evaluate as jax_evaluate
from deepfake_video_detection_tpu.models import temporal_transformer as JT
from deepfake_video_detection_tpu.models.backbone_detector import TinyConvBackbone as JaxTinyConv
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.serve import predict as jax_predict
from deepfake_video_detection_tpu.train import losses as JLoss
from deepfake_video_detection_tpu.train import optim as JO
from deepfake_video_detection_tpu.train.state import TrainState as JaxTrainState
from deepfake_video_detection_tpu.train.steps import make_train_step as jax_make_train_step
from deepfake_video_detection_tpu.utils.tree import flatten_dotted as jax_flatten
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    load_checkpoint, save_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.evals import evaluate as E
from deepfake_video_detection_tpu_torch.models import temporal_transformer as T
from deepfake_video_detection_tpu_torch.models.backbone_detector import TinyConvBackbone
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.serve import predict as port_predict
from deepfake_video_detection_tpu_torch.train import cli
from deepfake_video_detection_tpu_torch.train import losses as L
from deepfake_video_detection_tpu_torch.train import optim as O
from deepfake_video_detection_tpu_torch.train import steps as S
from deepfake_video_detection_tpu_torch.train.state import TrainState

SIZE, LONG_T = 16, 600
SMALL = dict(d_model=64, depth=2, num_heads=2)
ATOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _frames(seed, B=2, T=LONG_T, size=SIZE):
    return np.random.default_rng(seed).normal(size=(B, T, size, size, 3)).astype(np.float32)


def _models(seed=0, dropout=0.1, compute_dtype=None, **kw):
    """The same small tinyconv temporal model in JAX and in the port, on the
    JAX init's weights."""
    kw = {**SMALL, "dropout_rate": dropout, **kw}
    jmodel = JT.TemporalTransformerDetector(
        "tinyconv", compute_dtype=compute_dtype or jnp.float32, **kw)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = T.TemporalTransformerDetector(
        "tinyconv", device="cpu",
        compute_dtype=torch.bfloat16 if compute_dtype is not None else torch.float32, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def _jax_rebuilt(path):
    """The JAX evaluator's model and variables for a checkpoint. Its
    ``import_into_variables`` drops the empty ``state.backbone`` of a
    stateless backbone (tinyconv, ViT), which the JAX temporal model then
    reads and fails on (KeyError); it is put back here."""
    jsd, jmeta = jax_evaluate.load_any(path)
    jm, jv, report, jmt = jax_evaluate.build_model_from_checkpoint(jsd, jmeta, "")
    return jm, {"params": jv["params"], "state": {"backbone": {}}}, report, jmt, jmeta


def _jax_forward(jmodel, variables, x):
    (logits, scores), _ = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    return np.asarray(logits), np.asarray(scores, np.float32)


@pytest.mark.parametrize("use_cls", [True, False])
def test_temporal_matches_jax_at_n_601(use_cls):
    """Logits and frame scores at T = 600 frames (N = 601 with the cls
    token, 600 without)."""
    jmodel, variables, model = _models(seed=1, use_cls=use_cls)
    x = _frames(1)
    ref_logits, ref_scores = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        logits, scores = model(_t(x))
    assert logits.dtype == torch.float32 and scores.shape == (2, LONG_T)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=ATOL)
    np.testing.assert_allclose(scores.sum(-1).numpy(), 1.0, atol=1e-5)


def test_temporal_bf16_activations_match_jax():
    """f32 params and bf16 activations on both sides: every temporal block
    sees bf16 (the time encoding and the cls token are cast, not promoted),
    and the outputs agree to bf16 rounding. Tolerance 2e-2: the two
    frameworks round the bf16 activations at other places (the JAX dense
    path casts P to bf16 before P·V, the plain flash keeps it in f32)."""
    jmodel, variables, model = _models(seed=2, compute_dtype=jnp.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    for blk in model.blocks:
        blk.register_forward_hook(lambda mod, inp, out: seen.append((inp[0].dtype, out.dtype)))
    x = _frames(2)
    ref_logits, ref_scores = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        logits, scores = model(_t(x))
    assert seen == [(torch.bfloat16, torch.bfloat16)] * SMALL["depth"]
    assert logits.dtype == torch.float32 and scores.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=2e-2)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=2e-2 / LONG_T)


def test_temporal_train_step_matches_jax():
    """One Adam step at T = 600 (dropout 0, f32) against the JAX
    ``make_train_step``: loss, grad norm and every updated parameter."""
    jmodel, variables, model = _models(seed=3, dropout=0.0)
    x = _frames(3)
    labels, valid = np.asarray([0, 1]), np.asarray([True, True])
    cw = np.asarray([0.8, 1.2], np.float32)
    tx = JO.build_optimizer("adam", 1e-3, grad_clip=None)
    jstep = jax_make_train_step(
        jmodel, tx, lambda lg, lb, sample_mask=None: JLoss.cross_entropy_loss(
            lg, lb, class_weights=cw, sample_mask=sample_mask), donate=False)
    jstate, jm = jstep(JaxTrainState.create(variables, tx),
                       {"frames": jnp.asarray(x), "labels": jnp.asarray(labels),
                        "valid": jnp.asarray(valid)}, jax.random.PRNGKey(0))
    opt = O.build_optimizer("adam", 1e-3, grad_clip=None)
    step = S.make_train_step(model, opt, lambda lg, lb, sample_mask=None: L.cross_entropy_loss(
        lg, lb, class_weights=cw, sample_mask=sample_mask))
    state, m = step(TrainState.create(model, opt),
                    {"frames": _t(x), "labels": _t(labels), "valid": _t(valid)})
    assert state.step == 1 and int(m["correct"]) == int(jm["correct"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.variables))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-4, err_msg=k)


def test_temporal_with_a_small_vit_backbone_matches_jax():
    """A two-block ViT-Tiny at 32 px per frame, T = 2."""
    jmodel = JT.TemporalTransformerDetector("vit_tiny_patch16_224", **SMALL)
    jmodel.backbone = JaxViT(variant="vit_tiny_patch16_224", img_size=32, depth=2)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(4))
    model = T.TemporalTransformerDetector("vit_tiny_patch16_224", device="cpu", **SMALL)
    model.backbone = VisionTransformer("vit_tiny_patch16_224", img_size=32, depth=2,
                                       device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = _frames(4, T=2, size=32)
    ref_logits, ref_scores = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        logits, scores = model(_t(x))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=ATOL)


def test_tinyconv_backbone_matches_jax():
    jbb = JaxTinyConv()
    variables = jbb.init(jax.random.PRNGKey(5))
    bb = TinyConvBackbone(device="cpu")
    bb.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = _frames(5, B=1, T=6)[0]
    ref, _ = jbb.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = bb(_t(x))
    assert got.shape == (6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the port's own init draws the JAX distribution: kaiming_normal, fan_out
    w = TinyConvBackbone(device="cpu", generator=torch.Generator().manual_seed(0)).conv2.weight.detach()
    assert abs(float(w.std()) - (2.0 / (32 * 9)) ** 0.5) < 0.01


def test_block_helpers_match_jax():
    """``stack_blocks``, ``unstack_blocks`` and ``normalize_state_dict``
    against the JAX helpers, on a depth-3 tree."""
    _, variables, _ = _models(seed=6, depth=3)
    blocks = jax.tree_util.tree_map(np.asarray, variables["params"]["blocks"])
    ref_stacked = JT.stack_blocks(blocks)
    stacked = T.stack_blocks(blocks)
    flat, ref_flat = jax_flatten(stacked), jax_flatten(ref_stacked)
    assert sorted(flat) == sorted(ref_flat)
    assert all(np.array_equal(flat[k], np.asarray(ref_flat[k])) for k in flat)
    back = jax_flatten(T.unstack_blocks(stacked))
    ref_back = jax_flatten(JT.unstack_blocks(ref_stacked))
    assert sorted(back) == sorted(ref_back)
    assert all(np.array_equal(back[k], np.asarray(ref_back[k])) for k in back)

    sd = {f"blocks.{k}": v for k, v in flat.items()}
    sd["head.weight"] = np.ones((2, 64), np.float32)
    got, ref = T.normalize_state_dict(sd), JT.normalize_state_dict(sd)
    assert sorted(got) == sorted(ref) and "blocks.2.attn.qkv.weight" in got
    assert all(np.array_equal(got[k], ref[k]) for k in got)
    assert T.normalize_state_dict(ref) is ref                       # loop layout: no-op
    assert T.infer_mlp_kwargs(ref, 64) == JT.infer_mlp_kwargs(ref, 64) == {"mlp_hidden": 256}


def test_temporal_checkpoints_cross_both_ways(tmp_path):
    """A JAX tree loads strictly (pipeline layout after
    ``normalize_state_dict``), and the port's ``.npz`` loads in JAX with
    the same logits."""
    jmodel, variables, model = _models(seed=7)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stacked = dict(params, blocks=JT.stack_blocks(params["blocks"]))
    flat = T.normalize_state_dict(jax_flatten(stacked))
    fresh = T.TemporalTransformerDetector("tinyconv", device="cpu", **SMALL)
    fresh.load_state_dict(state_dict_from_jax(flat), strict=True)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in fresh.state_dict().items())
    assert sorted(model.state_dict()) == sorted(jax_flatten(params))

    with torch.no_grad():                      # move off the JAX init
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    path = str(tmp_path / "temporal.npz")
    save_checkpoint(path, model.state_dict(), {"model_config": {"model_type": "temporal"}})
    loaded, meta = load_checkpoint(path)
    assert meta["model_config"]["model_type"] == "temporal"
    x = _frames(7, B=1, T=20)
    ref_logits, _ = _jax_forward(jmodel, {"params": loaded["params"],
                                                  "state": {"backbone": {}}}, x)
    with torch.no_grad():
        logits, _ = model(_t(x))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process (in-process store),
    torn down after the test."""
    import torch.distributed as dist

    from deepfake_video_detection_tpu_torch.parallel.mesh import init_world

    init_world("cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name,value", [("mesh", object()), ("seq_axis", "seq"),
                                        ("stage_axis", "stage"), ("expert_axis", "expert")])
def test_unported_temporal_modes_raise(world_of_one, name, value):
    """Each multi-device mode (once unported, now ported) builds on a
    world-of-one ``DeviceMesh`` and its forward matches JAX's one-device
    forward: the mesh alone, sequence parallelism (ring, ``use_cls=False``),
    the pipeline (2 microbatches) and expert parallelism (4 experts, the
    JAX model's ``apply_expert_parallel`` on one device, drops included)."""
    from jax.sharding import Mesh
    from torch.distributed.device_mesh import init_device_mesh

    axis = {"mesh": "model", "seq_axis": "seq", "stage_axis": "stage",
            "expert_axis": "expert"}[name]
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", axis))
    kw = {"mesh": mesh}
    jkw = {}
    if name != "mesh":
        kw[name] = value
    if name == "seq_axis":
        kw["use_cls"] = jkw["use_cls"] = False
    if name == "stage_axis":
        kw["pp_microbatches"] = 2
    if name == "expert_axis":
        kw["moe_experts"] = jkw["moe_experts"] = 4
        jkw.update(mesh=Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "expert")),
                   expert_axis="expert")
    jmodel, variables, _ = _models(seed=3, **jkw)
    model = T.TemporalTransformerDetector("tinyconv", device="cpu", **SMALL, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = _frames(3, B=2, T=8)
    ref_logits, ref_scores = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        logits, scores = model(_t(x))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=ATOL)


# ---------------------------------------------------------------------------
# entry points: evaluator, training CLI, Predictor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Six clips of 40 frames at 16 px, half labelled fake."""
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(8)
    for i in range(6):
        label = i % 2
        np.savez(d / f"clip_{i}_{'fake' if label else 'real'}.npz", label=np.int64(label),
                 faces=rng.integers(0, 256, (40, SIZE, SIZE, 3), dtype=np.uint8))
    return str(d)


def test_evaluator_matches_jax(clips, tmp_path):
    """A checkpoint written by the JAX package's ``save_checkpoint``: the
    port's ``build_model_from_checkpoint`` + ``evaluate_dataset`` against
    the JAX evaluator's, ``prob_fake`` within 1e-4; then ``main`` writes the
    CSV rows."""
    jmodel, variables, _ = _models(seed=9)
    path = str(tmp_path / "checkpoint_best.npz")
    cfg = {"model_type": "temporal", "backbone": "tinyconv", **SMALL}
    jax_save_checkpoint(path, variables, meta={"model_config": cfg})
    jm, jv, _, jmt, _ = _jax_rebuilt(path)
    jpaths, jlabels, jprob = jax_evaluate.evaluate_dataset(
        jm, jv, JaxDataset(clips, num_frames=30), jmt, batch_size=4)

    sd, meta = E.load_any(path)
    model, report, mt = E.build_model_from_checkpoint(sd, meta, "", device="cpu")
    assert mt == "temporal" and report["match_ratio"] == 1.0 and not report["unexpected"]
    paths, labels, prob = E.evaluate_dataset(model, VideoFacesDataset(clips, num_frames=30),
                                             batch_size=4)
    assert paths == jpaths and labels.tolist() == jlabels.tolist()
    np.testing.assert_allclose(prob, jprob, atol=1e-4)

    out = str(tmp_path / "eval.csv")
    assert E.main(["--data_dir", clips, "--checkpoint", path, "--num_frames", "30",
                   "--batch_size", "4", "--out_csv", out, "--device", "cpu"]) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert [r["path"] for r in rows] == paths
    np.testing.assert_allclose([float(r["prob_fake"]) for r in rows], prob, atol=1e-6)
    assert all(r["pred"] == str(int(float(r["prob_fake"]) >= 0.5)) for r in rows)
    # --from-videos is ported (test_torch_port_prepare.py): it reads video
    # files, and a directory of face stacks has none, as in the JAX package
    with pytest.raises(FileNotFoundError, match="no labeled video files"):
        E.main(["--data_dir", clips, "--checkpoint", path, "--device", "cpu",
                "--from-videos"])
    # --quantize int8 is ported (test_torch_port_quant.py holds it against JAX)
    assert E.main(["--data_dir", clips, "--checkpoint", path, "--device", "cpu",
                   "--quantize", "int8", "--out_csv", str(tmp_path / "q.csv")]) == 0
    # a reference .pt of the same weights reads as the native file does
    pt = str(tmp_path / "model.pt")
    jax_save_torch_checkpoint(pt, variables, layout="model_config", meta={"model_config": cfg})
    sd_pt, meta_pt = E.load_any(pt)
    assert sorted(sd_pt) == sorted(sd) and meta_pt["model_config"] == cfg
    assert all(np.array_equal(sd_pt[k], sd[k]) for k in sd)
    # the legacy families are built (test_torch_port_legacy.py): named, or
    # told by their keys
    _, report, mt = E.build_model_from_checkpoint(sd, {}, "cnn_lstm", device="cpu")
    assert mt == "cnn_lstm" and report["match_ratio"] == 0.0
    _, report, mt = E.build_model_from_checkpoint({"cnn.fc.weight": np.zeros((2, 2))},
                                                  {}, "", device="cpu")
    assert mt == "cnn_lstm" and report["match_ratio"] == 0.0


def test_cli_trains_a_temporal_model_that_jax_rebuilds(clips, tmp_path):
    """``--model temporal --backbone tinyconv --smoke`` on the CPU writes a
    checkpoint whose ``model_config`` the JAX evaluator rebuilds the model
    from, with the same logits."""
    out = tmp_path / "run"
    assert cli.main(["--data_dir", clips, "--model", "temporal", "--backbone", "tinyconv",
                     "--d_model", "32", "--depth", "2", "--heads", "2", "--epochs", "1",
                     "--batch_size", "2", "--num_frames", "8", "--smoke",
                     "--out_dir", str(out), "--device", "cpu"]) == 0
    path = str(out / "checkpoint_best.npz")
    assert os.path.exists(path) and (out / "preds_epoch_0.csv").exists()
    jm, jv, report, _, jmeta = _jax_rebuilt(path)
    assert jmeta["model_config"] == {"model_type": "temporal", "backbone": "tinyconv",
                                     "d_model": 32, "depth": 2, "num_heads": 2}
    assert report["match_ratio"] == 1.0
    sd, meta = E.load_any(path)
    model, _, _ = E.build_model_from_checkpoint(sd, meta, "", device="cpu")
    x = _frames(10, B=1, T=8)
    ref_logits, _ = _jax_forward(jm, jv, x)
    with torch.no_grad():
        logits, _ = model(_t(x))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)


def test_predictor_serves_a_temporal_model(monkeypatch):
    """``Predictor(model_type="temporal")`` against the JAX Predictor on the
    same weights: the same result dict. The port's Predictor warms up every
    bucket first."""
    for k, v in {"SERVE_WARMUP": "0", "MIN_FACES": "1", "DETECT_ABSTAIN_CONF": "0",
                 "SERVE_DP": "0", "MAX_FRAMES": "12"}.items():
        monkeypatch.setenv(k, v)
    jmodel, variables, model = _models(seed=11)
    extractor = FaceExtractor(detector="center", face_size=SIZE, device="cpu")
    jpred = jax_predict.Predictor(jmodel, variables, "temporal", extractor=extractor)
    monkeypatch.setenv("SERVE_WARMUP", "1")
    pred = port_predict.Predictor(model, None, "temporal", extractor=extractor, device="cpu")
    assert pred.warmup_done.wait(timeout=120) and pred.warmup_error is None
    faces = np.random.default_rng(11).integers(0, 256, (12, SIZE, SIZE, 3), np.uint8)
    ours, ref = pred.predict_faces(faces, "clip"), jpred.predict_faces(faces, "clip")
    pred.close()
    assert sorted(ours) == sorted(ref) and ours["prediction"] == ref["prediction"]
    assert len(ours["frame_scores"]) == 12
    assert ours["prob_fake"] == pytest.approx(ref["prob_fake"], abs=5e-4)
    np.testing.assert_allclose(ours["frame_scores"], ref["frame_scores"], atol=5e-4)

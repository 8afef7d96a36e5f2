"""The improved trainer, progressive fine-tuning, the LR finder, the
validation demo and the feature extractors: the port against the JAX
package, on the CPU, f32.

``trainable_mask`` against JAX's pytree mask at every stage; one masked
AdamW stage-1 step of a resnet18 detector against JAX's masked optax step;
the progressive training CLI end to end; the LR finder on the JAX suite's
toy model (history, report, CSV and SVG bytes); ``simulate_comparison``;
the HF key importers byte for byte and their partial load into a ViT; the
three feature-extractor flavours and the CLIP-flavoured frame graph, its
train step; ``cli_improved`` (its config key for key with JAX's, and a
``--smoke`` run whose checkpoint JAX loads); and three reference quirks the
port matches (ROADMAP Queue 3).

Weights are JAX trees filled by numpy (``random_variables``) carried across
with ``state_dict_from_jax``. Sizes: resnet18 at 48 px (2 clips x 2
frames: its ReLU kinks, ``test_torch_port_convtrain.py``), ViT-Tiny cut to
two blocks at 32 px, the CLI runs on 32 px clips (224 px, 2 frames, where
the model's own size is fixed). Tolerances: 2e-4 for modules, 5e-4 for
whole detectors, and ``test_torch_port_train.py``'s for train steps. Two
model steps are compiled in JAX, the masked resnet18 step and the CLIP
frame-graph step, besides the LR sweeps' steps of two toy models (8 and 2
parameters).
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.checkpoint.store import load_checkpoint as jax_load_checkpoint
from deepfake_video_detection_tpu.checkpoint.torch_bridge import import_into_variables
from deepfake_video_detection_tpu.data.dataset import VideoFacesDataset as JaxDataset
from deepfake_video_detection_tpu.data.normalize import clip_normalize as jax_clip_normalize
from deepfake_video_detection_tpu.evals import evaluate as jax_evaluate
from deepfake_video_detection_tpu.evals import validate_improvements as JV
from deepfake_video_detection_tpu.models import feature_extractors as JF
from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.models.gcn import FrameGraphDetector as JaxFrameGraph
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.nn import init as JI
from deepfake_video_detection_tpu.nn import layers as JL
from deepfake_video_detection_tpu.train import cli_improved as jax_cli_improved
from deepfake_video_detection_tpu.train import losses as JLoss
from deepfake_video_detection_tpu.train import optim as JO
from deepfake_video_detection_tpu.train.lr_finder import LRFinder as JaxLRFinder
from deepfake_video_detection_tpu.train.progressive import (
    ProgressiveFineTuner as JaxProgressive)
from deepfake_video_detection_tpu.train.state import TrainState as JaxTrainState
from deepfake_video_detection_tpu.train.steps import make_train_step as jax_make_train_step
from deepfake_video_detection_tpu.utils import graph as JG
from deepfake_video_detection_tpu.utils.tree import flatten_dotted as jax_flatten
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import import_into_model
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.data.normalize import clip_normalize
from deepfake_video_detection_tpu_torch.evals import evaluate as E
from deepfake_video_detection_tpu_torch.evals import validate_improvements as V
from deepfake_video_detection_tpu_torch.models import feature_extractors as F
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.train import cli, cli_improved, lr_finder
from deepfake_video_detection_tpu_torch.train import losses as Loss
from deepfake_video_detection_tpu_torch.train import optim as O
from deepfake_video_detection_tpu_torch.train import steps as S
from deepfake_video_detection_tpu_torch.train.progressive import ProgressiveFineTuner
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.utils import graph as G

from test_torch_port_convnets import random_variables

TINY = "vit_tiny_patch16_224"
SIZE = 32                                   # the ViT-Tiny modules' input
MODULE_TOL, DETECTOR_TOL = 2e-4, 5e-4
# test_torch_port_train.py's step tolerances
LOSS_RTOL, NORM_RTOL, PARAM_RTOL, PARAM_ATOL, STATS_TOL = 1e-5, 1e-4, 1e-4, 2e-6, 1e-5
CW = np.asarray([0.8, 1.2], np.float32)
_STATS = ("running_mean", "running_var")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several workers on the host's
    cores, and oversubscribed intra-op threads slow these small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got.detach()) if isinstance(got, torch.Tensor)
                               else got, np.asarray(ref), atol=tol, rtol=tol)


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


# ---------------------------------------------------------------------------
# trainable_mask and the stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["resnet18", "efficientnet_b0", TINY])
def test_trainable_mask_matches_jax_at_every_stage(backbone):
    """The port's mask by parameter name is JAX's pytree mask flattened, at
    each of the three stages (B0's stages sort as ints; ViT-Tiny's last two
    blocks are 10 and 11, which a prefix ``blocks.1`` would also catch);
    the stage configs agree and run out together."""
    jm = JaxDetector(backbone)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    pm = BackboneDetector(backbone, device="cpu")
    jft, pft = JaxProgressive(jm), ProgressiveFineTuner(pm)
    trainable = []
    while True:
        assert pft.get_stage_config() == jft.get_stage_config()
        want = {k: bool(v) for k, v in jax_flatten(jft.trainable_mask(shapes)).items()}
        got = pft.trainable_mask()
        assert list(got) == [n for n, _ in pm.named_parameters()]
        assert got == want
        trainable.append({k for k, v in got.items() if v and k.startswith("backbone.")})
        more = pft.advance_stage()
        assert more == jft.advance_stage()
        if not more:
            break
    head_only, partial, full = trainable
    assert not head_only and partial and len(full) > len(partial)
    last = {"resnet18": ("layer3", "layer4"), "efficientnet_b0": ("blocks.5", "blocks.6"),
            TINY: ("blocks.10", "blocks.11")}[backbone]
    depth = 2 if backbone == "resnet18" else 3     # backbone.layer4.… | backbone.blocks.6.…
    assert {".".join(k.split(".")[1:depth]) for k in partial} == set(last)



# ---------------------------------------------------------------------------
# one masked AdamW step (stage 1 of resnet18)
# ---------------------------------------------------------------------------


def _jloss(logits, labels, sample_mask=None):
    return JLoss.cross_entropy_loss(logits, labels, class_weights=CW, sample_mask=sample_mask)


def _loss(logits, labels, sample_mask=None):
    return Loss.cross_entropy_loss(logits, labels, class_weights=CW, sample_mask=sample_mask)


def _stage1_pair():
    jm = JaxDetector("resnet18", dropout_rate=0.0)
    v = random_variables(jm, 5)
    pm = BackboneDetector("resnet18", dropout_rate=0.0, device="cpu")
    pm.load_state_dict(state_dict_from_jax(_np_tree(v)), strict=True)
    jft, pft = JaxProgressive(jm), ProgressiveFineTuner(pm)
    assert jft.advance_stage() and pft.advance_stage()
    return jm, v, pm, jft.make_optimizer(v), pft.make_optimizer(), pft.trainable_mask()


def test_masked_adamw_stage_step_matches_jax():
    """Stage 1 (``partial_unfreeze``: layer3, layer4 and the head at lr
    1e-4) of a resnet18 detector, one step of 2 clips x 2 frames at 48 px
    against JAX's masked optax step: loss, grad norm and every running stat;
    the frozen parameters bit-identical on both sides (no Adam step, no
    decay) while the frozen layers' running stats move, and every trainable
    one moved. The trainable parameters' values are held in the next test,
    on shared gradients: after the clip (27x here) hundreds of gradient
    entries behind dead ReLUs are ~1e-8, within rounding of Adam's eps,
    where its first step g / (|g| + eps) turns rounding into up to 0.13 lr."""
    jm, v, pm, tx, opt, mask = _stage1_pair()
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    rng = np.random.default_rng(5)
    batch = {"frames": rng.normal(size=(2, 2, 48, 48, 3)).astype(np.float32),
             "labels": np.asarray([0, 1]), "valid": np.ones((2,), bool)}
    jstate, jmet = jax_make_train_step(jm, tx, _jloss, donate=False)(
        JaxTrainState.create(v, tx), {k: jnp.asarray(a) for k, a in batch.items()}, None)
    _, m = S.make_train_step(pm, opt, _loss)(TrainState.create(pm, opt),
                                             {k: _t(a) for k, a in batch.items()})
    assert float(jmet["grad_norm"]) > 1.0            # the clip at 1.0 bites
    np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=NORM_RTOL)
    ref = state_dict_from_jax(_np_tree(jstate.variables))
    got = pm.state_dict()
    assert sorted(got) == sorted(ref) and sorted(mask) == sorted(
        k for k in got if not k.endswith(_STATS))
    for k, t in got.items():
        if k.endswith(_STATS):
            np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=k)
            assert not torch.equal(t, before[k]), k
        else:
            assert torch.equal(t, before[k]) != mask[k], k
            assert torch.equal(ref[k], before[k]) != mask[k], k


def test_masked_adamw_update_matches_optax_on_shared_gradients():
    """The stage-1 optimizers of both packages on one seeded gradient for
    every parameter (a clip over the trainable ones that bites, AdamW with
    decay 1e-4): every parameter after the update at the step tests'
    tolerances, the frozen ones untouched."""
    jm, v, pm, tx, opt, mask = _stage1_pair()
    rng = np.random.default_rng(11)
    jgrads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.05, jnp.float32), v["params"])
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(v["params"]), v["params"])
    want = state_dict_from_jax(_np_tree({"params": jax.tree_util.tree_map(
        lambda p, u: p + u, v["params"], updates), "state": v["state"]}))
    grads = state_dict_from_jax(_np_tree({"params": jgrads, "state": {}}))
    state = TrainState.create(pm, opt)
    before = {k: t.clone() for k, t in state.params.items()}
    opt.step(state.params, grads, state.opt_state)
    for k, t in state.params.items():
        np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
        assert torch.equal(t, before[k]) != mask[k], k


# ---------------------------------------------------------------------------
# the progressive training CLI
# ---------------------------------------------------------------------------


def test_progressive_cli_trains_three_stages(faces_dir, tmp_path):
    """``--model pretrained --progressive --epochs_per_stage 1`` (B0): three
    stage directories, stage 0's stem equal to the init bit for bit with the
    head moved, stage 1 moving only blocks 5-6 and the head, and the last
    stage's best checkpoint copied to ``out_dir``, which JAX reads with its
    batch-norm state under ``state``."""
    out = tmp_path / "prog"
    assert cli.main(["--data_dir", faces_dir, "--model", "pretrained", "--progressive",
                     "--epochs_per_stage", "1", "--batch_size", "4", "--num_frames", "2",
                     "--out_dir", str(out), "--device", "cpu"]) == 0
    stages = sorted(d for d in os.listdir(out) if d.startswith("stage"))
    assert stages == ["stage0_head_only", "stage1_partial_unfreeze", "stage2_full_finetune"]
    init = cli.build_model("pretrained", 2, device="cpu")[0].state_dict()
    best = [state_dict_from_jax(jax_load_checkpoint(str(out / d / "checkpoint_best.npz"))[0])
            for d in stages]
    assert torch.equal(best[0]["backbone.conv_stem.weight"], init["backbone.conv_stem.weight"])
    assert not torch.equal(best[0]["fc1.weight"], init["fc1.weight"])
    moved = {k for k in best[1] if not k.endswith(_STATS)
             and not torch.equal(best[1][k], best[0][k])}
    assert moved and all(k.startswith(("backbone.blocks.5.", "backbone.blocks.6.", "fc",
                                       "temporal_attention.")) for k in moved), moved
    assert filecmp.cmp(out / "checkpoint_best.npz",
                       out / stages[-1] / "checkpoint_best.npz", shallow=False)
    jv, meta = jax_load_checkpoint(str(out / "checkpoint_best.npz"))
    assert meta["model_config"] == {"model_type": "pretrained", "backbone": "efficientnet_b0"}
    template = jax.eval_shape(JaxDetector("efficientnet_b0").init, jax.random.PRNGKey(0))
    assert jax_flatten(jv["state"]).keys() == jax_flatten(template["state"]).keys()


@pytest.mark.parametrize("flags", [["--model", "vit_gcn"], ["--model", "pretrained",
                                                            "--ema_decay", "0.99"]])
def test_progressive_cli_refuses_what_jax_refuses(flags, faces_dir, tmp_path):
    """As JAX's CLI: ``--progressive`` needs ``--model pretrained`` and no
    ``--ema_decay`` (an argparse error, exit code 2)."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--data_dir", faces_dir, "--progressive", "--out_dir", str(tmp_path),
                  "--device", "cpu", "--num_frames", "2", *flags])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# the LR finder
# ---------------------------------------------------------------------------


class _JaxToy:
    """The JAX suite's toy model (``tests/test_extended_models.py``)."""

    def init(self, rng):
        return {"params": {"w": {"weight": JI.kaiming_uniform(rng, (2, 3)),
                                 "bias": JI.zeros(2)}}, "state": {}}

    def apply(self, variables, x, train=False, rng=None):
        return JL.linear(variables["params"]["w"], jnp.mean(x, axis=(1, 2, 3))), {}


class _Toy(torch.nn.Module):
    def __init__(self, variables):
        super().__init__()
        self.w = torch.nn.Linear(3, 2)
        self.load_state_dict(state_dict_from_jax(_np_tree(variables)), strict=True)

    def forward(self, x, train=False, generator=None):
        return L.linear(x.mean(dim=(1, 2, 3)), self.w.weight, self.w.bias)


def _toy_batch():
    labels = np.arange(16) % 2
    frames = np.stack([np.full((2, 4, 4, 3), 1.0 if lab else -1.0)
                       for lab in labels]).astype(np.float32)
    return frames, labels


class _JaxBowl:
    """Logits that are the parameter ``w`` itself, under the loss
    100·mean(w²): plain SGD scales ``w`` by (1 − 100·lr) a step, so the loss
    falls while lr < 0.01 and blows up once lr > 0.02."""

    def init(self, rng):
        return {"params": {"w": {"weight": jnp.asarray([0.5, -1.0], jnp.float32)}},
                "state": {}}

    def apply(self, variables, x, train=False, rng=None):
        return jnp.broadcast_to(variables["params"]["w"]["weight"], (x.shape[0], 2)), {}


class _Bowl(torch.nn.Module):
    def __init__(self, variables):
        super().__init__()
        self.w = torch.nn.Module()
        self.w.weight = torch.nn.Parameter(torch.zeros(2))
        self.load_state_dict(state_dict_from_jax(_np_tree(variables)), strict=True)

    def forward(self, x, train=False, generator=None):
        return self.w.weight.expand(x.shape[0], 2)


def _jax_bowl_loss(logits, labels):
    return 100.0 * jnp.mean(logits ** 2)


def _bowl_loss(logits, labels):
    return 100.0 * torch.mean(logits ** 2)


@pytest.mark.parametrize("model", ["toy", "bowl"])
def test_lr_finder_matches_jax(model, tmp_path):
    """40 steps from lr 1e-4 to 10: on the JAX suite's toy problem (the
    loss keeps falling) and on a quadratic bowl (the loss blows up past lr
    0.02 and the sweep stops at 4x its best): the same history (lr exactly,
    smoothed loss within 1e-5 relative) and stop, the same report; for one
    history the CSV and the SVG are JAX's bytes."""
    num_steps = 40
    frames, labels = _toy_batch()
    jm, port_cls = (_JaxToy(), _Toy) if model == "toy" else (_JaxBowl(), _Bowl)
    jloss, loss = ((JLoss.cross_entropy_loss, Loss.cross_entropy_loss) if model == "toy"
                   else (_jax_bowl_loss, _bowl_loss))
    jv = jm.init(jax.random.PRNGKey(0))
    jf = JaxLRFinder(jm, jloss, num_steps=num_steps)
    jout = jf.find(jv, [{"frames": jnp.asarray(frames), "labels": jnp.asarray(labels)}])
    pf = lr_finder.LRFinder(port_cls(jv), loss, num_steps=num_steps)
    out = pf.find([{"frames": _t(frames), "labels": _t(labels)}])
    assert 10 < len(pf.history) == len(jf.history)
    assert (len(pf.history) < num_steps) == (model == "bowl")
    assert [h[0] for h in pf.history] == [h[0] for h in jf.history]
    np.testing.assert_allclose([h[1] for h in pf.history], [h[1] for h in jf.history],
                               rtol=1e-5)
    assert out == jout
    pf.history = list(jf.history)
    for name, finder in (("port", pf), ("jax", jf)):
        finder.save_csv(str(tmp_path / f"{name}.csv"))
        finder.save_plot(str(tmp_path / f"{name}.svg"))
    for ext in ("csv", "svg"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    assert b"steepest" in (tmp_path / "port.svg").read_bytes()


def test_lr_finder_cli_restarts_its_batches(faces_dir, tmp_path):
    """The CLI sweeps more steps than one pass of the data holds (10 clips,
    3 batches a pass, 12 steps): its batches restart. JAX's CLI hands
    ``find`` a one-shot generator, and ``find`` stops with StopIteration
    when it runs out (ROADMAP Queue 3), as any one-shot iterator shows."""
    frames, labels = _toy_batch()
    jtoy = _JaxToy()
    with pytest.raises(StopIteration):
        JaxLRFinder(jtoy, JLoss.cross_entropy_loss, num_steps=3).find(
            jtoy.init(jax.random.PRNGKey(0)),
            iter([{"frames": jnp.asarray(frames), "labels": jnp.asarray(labels)}]))
    out_csv = str(tmp_path / "lr.csv")
    assert lr_finder.main(["--data_dir", faces_dir, "--batch_size", "4", "--num_frames", "2",
                           "--num_steps", "12", "--out_csv", out_csv, "--device", "cpu"]) == 0
    rows = (tmp_path / "lr.csv").read_text().splitlines()
    assert rows[0] == "lr,smoothed_loss" and len(rows) - 1 > 3
    assert np.isfinite([float(r.split(",")[1]) for r in rows[1:]]).all()
    assert (tmp_path / "lr.svg").read_text().startswith("<svg")


# ---------------------------------------------------------------------------
# the validation demo
# ---------------------------------------------------------------------------


def test_simulate_comparison_equals_jax():
    assert V.simulate_comparison() == JV.simulate_comparison()
    assert V.simulate_comparison(64, seed=3) == JV.simulate_comparison(64, seed=3)


def test_validate_improvements_main_runs_its_forwards(capsys):
    assert V.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "simulated" in out and "2-member ensemble forwards OK" in out
    info = V.test_real_models("cpu")
    assert info["members"] == 2 and len(info["single_logits"][0]) == 2


# ---------------------------------------------------------------------------
# the HF importers
# ---------------------------------------------------------------------------


def _hf_state_dict(flavor, D=192, layers=2, n_tokens=5, seed=0):
    """A seeded HF-layout state dict (two layers, biases included), with the
    entries the importers drop: CLIP's ``pre_layrnorm``, DINOv2's layer
    scale and mask token."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    sd = {}
    if flavor == "clip":
        pre = "vision_model."
        sd[pre + "embeddings.class_embedding"] = a(D)
        sd[pre + "embeddings.position_embedding.weight"] = a(n_tokens, D)
        sd[pre + "embeddings.patch_embedding.weight"] = a(D, 3, 16, 16)
        sd[pre + "pre_layrnorm.weight"] = 1 + a(D)
        sd[pre + "pre_layrnorm.bias"] = a(D)
        for n in ("weight", "bias"):
            sd[pre + f"post_layernorm.{n}"] = a(D)
        for i in range(layers):
            lp = f"{pre}encoder.layers.{i}."
            for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[lp + f"self_attn.{m}.weight"], sd[lp + f"self_attn.{m}.bias"] = a(D, D), a(D)
            for m in ("layer_norm1", "layer_norm2"):
                sd[lp + f"{m}.weight"], sd[lp + f"{m}.bias"] = 1 + a(D), a(D)
            sd[lp + "mlp.fc1.weight"], sd[lp + "mlp.fc1.bias"] = a(4 * D, D), a(4 * D)
            sd[lp + "mlp.fc2.weight"], sd[lp + "mlp.fc2.bias"] = a(D, 4 * D), a(D)
    else:
        sd["embeddings.cls_token"] = a(1, 1, D)
        sd["embeddings.mask_token"] = a(1, D)
        sd["embeddings.position_embeddings"] = a(1, n_tokens, D)
        sd["embeddings.patch_embeddings.projection.weight"] = a(D, 3, 16, 16)
        sd["embeddings.patch_embeddings.projection.bias"] = a(D)
        sd["layernorm.weight"], sd["layernorm.bias"] = 1 + a(D), a(D)
        for i in range(layers):
            lp = f"encoder.layer.{i}."
            for m in ("query", "key", "value"):
                sd[lp + f"attention.attention.{m}.weight"] = a(D, D)
                sd[lp + f"attention.attention.{m}.bias"] = a(D)
            sd[lp + "attention.output.dense.weight"] = a(D, D)
            sd[lp + "attention.output.dense.bias"] = a(D)
            sd[lp + "layer_scale1.lambda1"] = 1 + a(D)
            sd[lp + "layer_scale2.lambda1"] = 1 + a(D)
            for m in ("norm1", "norm2"):
                sd[lp + f"{m}.weight"], sd[lp + f"{m}.bias"] = 1 + a(D), a(D)
            sd[lp + "mlp.fc1.weight"], sd[lp + "mlp.fc1.bias"] = a(4 * D, D), a(4 * D)
            sd[lp + "mlp.fc2.weight"], sd[lp + "mlp.fc2.bias"] = a(D, 4 * D), a(D)
    return sd


def _tiny_vit_pair(seed):
    jm = JaxViT(variant=TINY, img_size=SIZE, num_classes=0, depth=2)
    v = random_variables(jm, seed)
    pm = VisionTransformer(TINY, img_size=SIZE, depth=2, device="cpu")
    pm.load_state_dict(state_dict_from_jax(_np_tree(v)), strict=True)
    return jm, v, pm


@pytest.mark.parametrize("flavor", ["clip", "dinov2"])
def test_hf_importer_equals_jax_and_loads_as_jax_loads(flavor):
    """``import_hf_vision_state_dict`` gives JAX's dict key for key (in
    order) and byte for byte; applied to a ViT-Tiny (two blocks) as JAX
    applies it (shape-filtered, non-strict), both packages hold the same
    weights, report the same keys, and compute the same features. A CLIP
    dict has no patch-embedding bias, which keeps its init value; DINOv2's
    covers the whole ViT. The dropped entries (CLIP's ``pre_layrnorm``,
    DINOv2's layer scale and mask token) are reported unexpected in both."""
    sd = _hf_state_dict(flavor)
    got, want = F.import_hf_vision_state_dict(sd, flavor), JF.import_hf_vision_state_dict(sd, flavor)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    jm, v, pm = _tiny_vit_pair(6)
    init = {k: t.clone() for k, t in pm.state_dict().items()}
    jv, jreport = import_into_variables(got, v)
    report = import_into_model(pm, got)
    for key in ("matched", "missing", "unexpected", "shape_mismatch"):
        assert sorted(report[key]) == sorted(jreport[key]), key
    kept = {"clip": ["patch_embed.proj.bias"], "dinov2": []}[flavor]
    assert report["missing"] == kept and not report["shape_mismatch"]
    assert not report["unexpected"]
    ref = state_dict_from_jax(_np_tree(jv))
    for k, t in pm.state_dict().items():
        assert torch.equal(t, ref[k]), k
        assert torch.equal(t, init[k]) == (k in kept), k
    dropped = {"clip": {"vision_model.pre_layrnorm.weight", "vision_model.pre_layrnorm.bias"},
               "dinov2": {"embeddings.mask_token", "encoder.layer.0.layer_scale1.lambda1",
                          "encoder.layer.1.layer_scale2.lambda1"}}[flavor]
    assert dropped <= set(sd) and not any(
        k in want for k in dropped) and len(want) == len(got)
    x = np.random.default_rng(6).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    jfeat, _ = jm.apply(jv, jnp.asarray(x))
    with torch.no_grad():
        _close(pm(_t(x)), jfeat, MODULE_TOL)


def test_imported_vit_runs_exact_gelu_as_jax_does():
    """Reference quirk (ROADMAP Queue 3): the ViT's MLP runs exact GELU in
    both packages, where CLIP runs quick-GELU (x·σ(1.702x)), so an imported
    CLIP checkpoint does not compute HF's features."""
    jm, v, pm = _tiny_vit_pair(7)
    x = np.random.default_rng(7).normal(size=(4, 192)).astype(np.float32)
    mlp = pm.blocks[0].mlp
    with torch.no_grad():
        got = mlp(_t(x))
        exact = mlp.fc2(torch.nn.functional.gelu(mlp.fc1(_t(x))))
        h = mlp.fc1(_t(x))
        quick = mlp.fc2(h * torch.sigmoid(1.702 * h))
    _close(got, exact, 1e-6)
    assert float((got - quick).abs().max()) > 1e-4
    p = v["params"]["blocks"]["0"]["mlp"]            # the JAX block's MLP ops
    ref = JL.linear(p["fc2"], jax.nn.gelu(JL.linear(p["fc1"], jnp.asarray(x)),
                                          approximate=False))
    _close(got, ref, MODULE_TOL)


# ---------------------------------------------------------------------------
# the feature extractors and the CLIP-flavoured frame graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavor", ["timm", "clip", "dinov2"])
def test_feature_extractor_flavours_match_jax(flavor):
    """Each wrapper normalises once (CLIP's statistics or ImageNet's) and
    returns the ViT's CLS features, as JAX's does, from [0, 1] floats and
    from uint8; CLIP's features differ from timm's on the same weights."""
    jfx = JF.build_feature_extractor(flavor, TINY, SIZE)
    jfx.vit = JaxViT(variant=TINY, img_size=SIZE, num_classes=0, depth=2)
    v = random_variables(jfx.vit, 8)
    fx = F.build_feature_extractor(flavor, TINY, SIZE, device="cpu")
    assert type(fx).__name__ == type(jfx).__name__ and fx.feature_dim == jfx.feature_dim
    fx.vit = VisionTransformer(TINY, img_size=SIZE, depth=2, device="cpu")
    fx.vit.load_state_dict(state_dict_from_jax(_np_tree(v)), strict=True)
    rng = np.random.default_rng(8)
    u8 = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    for x in (u8.astype(np.float32) / 255.0, u8):
        ref, _ = jfx.apply(v, jnp.asarray(x))
        with torch.no_grad():
            got = fx(_t(x))
        assert got.shape == (2, 192)
        _close(got, ref, MODULE_TOL)
    if flavor == "clip":
        timm = F.build_feature_extractor("timm", TINY, SIZE, device="cpu")
        timm.vit = fx.vit
        with torch.no_grad():
            assert float((timm(_t(u8)) - fx(_t(u8))).abs().max()) > 1e-3


def _clip_graph_pair(seed, T):
    """FrameGraphDetector(backbone="clip") over ViT-Tiny (two blocks at
    32 px) in both packages, on one set of weights."""
    jm = JaxFrameGraph(gcn_hid=48, gcn_out=24, vit_variant=TINY, img_size=SIZE,
                       backbone="clip", vit_out=192)
    jm.vit = JaxViT(variant=TINY, img_size=SIZE, num_classes=0, depth=2)
    v = random_variables(jm, seed)
    pm = FrameGraphDetector(gcn_hid=48, gcn_out=24, vit_variant=TINY, img_size=SIZE,
                            backbone="clip", vit_out=192, device="cpu")
    assert pm.backbone_flavor == "clip" and isinstance(pm.vit, VisionTransformer)
    pm.vit = VisionTransformer(TINY, img_size=SIZE, depth=2, device="cpu")
    pm.load_state_dict(state_dict_from_jax(_np_tree(v)), strict=True)
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (2, T, SIZE, SIZE, 3), dtype=np.uint8)
    adj = np.broadcast_to(np.asarray(JG.normalize_adjacency(JG.chain_adjacency(T))),
                          (2, T, T)).copy()
    return jm, v, pm, u8, adj


def test_clip_frame_graph_forward_and_step_match_jax():
    """The CLIP-flavoured frame graph on CLIP-normalised frames: its logits
    within 5e-4, and one step with the improved trainer's loss (focal,
    label smoothing 0.1) under SGD and a clip that bites: loss, grad norm
    and every parameter at the legacy step test's tolerances."""
    T = 3
    jm, v, pm, u8, adj = _clip_graph_pair(9, T)
    jx = jax_clip_normalize(jnp.asarray(u8))
    x = clip_normalize(_t(u8))
    _close(x, jx, 1e-6)
    ref, _ = jm.apply(v, jx, jnp.asarray(adj))
    with torch.no_grad():
        _close(pm(x, _t(adj)), ref, DETECTOR_TOL)

    batch = {"labels": np.asarray([0, 1]), "valid": np.ones((2,), bool), "adjacency": adj}

    def jloss(logits, labels, sample_mask=None):
        return JLoss.focal_loss(logits, labels, label_smoothing=0.1, sample_mask=sample_mask)

    def loss(logits, labels, sample_mask=None):
        return Loss.focal_loss(logits, labels, label_smoothing=0.1, sample_mask=sample_mask)

    tx = JO.build_optimizer("sgd", 0.5, grad_clip=0.1)
    jstate, jmet = jax_make_train_step(jm, tx, jloss, donate=False)(
        JaxTrainState.create(v, tx),
        {"frames": jx, **{k: jnp.asarray(a) for k, a in batch.items()}}, None)
    opt = O.build_optimizer("sgd", 0.5, grad_clip=0.1)
    _, m = S.make_train_step(pm, opt, loss)(
        TrainState.create(pm, opt), {"frames": x, **{k: _t(a) for k, a in batch.items()}})
    assert float(jmet["grad_norm"]) > 0.1      # the clip bites
    np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=NORM_RTOL)
    want = state_dict_from_jax(_np_tree(jstate.variables))
    for k, t in pm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the improved training CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--backbone", "clip"],
                                   ["--backbone", "dinov2:vit_small_patch16_224", "--bf16",
                                    "--patience", "3", "--ema_decay", "0.99"]])
def test_cli_improved_builds_jax_model_and_config(flags, faces_dir, tmp_path, monkeypatch):
    """Both CLIs' arguments give the same model (variant, flavour,
    activations' dtype) and the same ``TrainerConfig``, field for field."""
    seen = {}

    def recorder(pkg):
        class _Model:
            def __init__(self, **kw):
                dt = kw["compute_dtype"]
                seen[pkg, "model"] = {
                    "vit_variant": kw["vit_variant"], "backbone": kw["backbone"],
                    "compute_dtype": str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
                    else np.dtype(dt).name}

        class _Trainer:
            def __init__(self, model, train_ds, val_ds, cfg, **kw):
                seen[pkg, "cfg"] = dataclasses.asdict(cfg)

            def train(self, state=None):
                return None
        return _Model, _Trainer

    for pkg, mod in (("jax", jax_cli_improved), ("port", cli_improved)):
        model_cls, trainer_cls = recorder(pkg)
        monkeypatch.setattr(mod, "FrameGraphDetector", model_cls)
        monkeypatch.setattr(mod, "Trainer", trainer_cls)
        extra = ["--device", "cpu"] if pkg == "port" else []
        assert mod.main(["--data_dir", faces_dir, "--out_dir", str(tmp_path), *flags,
                         *extra]) == 0
    assert seen["port", "model"] == seen["jax", "model"]
    assert seen["port", "cfg"] == seen["jax", "cfg"]
    assert seen["port", "cfg"]["normalize"] == ("clip" if "clip" in flags else "imagenet")


@pytest.fixture(scope="module")
def improved_run(tmp_path_factory):
    """``cli_improved --smoke`` over ViT-Tiny in the CLIP flavour, one epoch
    on 3 clips of 2 frames at 224 px (one labelled fake), batch 2."""
    root = tmp_path_factory.mktemp("improved")
    data = root / "faces"
    data.mkdir()
    rng = np.random.default_rng(10)
    for i in range(3):
        np.savez(data / f"clip_{i}.npz", label=np.int64(i % 2),
                 faces=rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8))
    out = root / "run"
    assert cli_improved.main(["--data_dir", str(data), "--backbone", f"clip:{TINY}",
                              "--epochs", "1", "--batch_size", "2", "--num_frames", "2",
                              "--smoke", "--out_dir", str(out), "--device", "cpu"]) == 0
    return str(data), out


def test_cli_improved_checkpoint_loads_in_jax(improved_run):
    """The smoke run writes ``training_metrics_improved.csv`` (a copy of
    the history) and a best checkpoint whose ``model_config`` is JAX's; JAX's
    CLIP-flavoured ``FrameGraphDetector`` on those weights computes the
    port's logits, and the port's loader serves it at match ratio 1.0."""
    data, out = improved_run
    assert filecmp.cmp(out / "training_history.csv", out / "training_metrics_improved.csv",
                       shallow=False)
    best = str(out / "checkpoint_best.npz")
    jv, meta = jax_load_checkpoint(best)
    assert meta["model_config"] == {"model_type": "vit_gcn", "vit_variant": TINY,
                                    "backbone": "clip"}
    model, _, stats = port_loader.load_model(best, device="cpu")
    assert stats["model_type"] == "vit_gcn" and stats["match_ratio"] == 1.0
    jm = JaxFrameGraph(vit_variant=TINY, backbone="clip")
    u8 = np.load(os.path.join(data, "clip_0.npz"))["faces"][None]
    adj = G.normalize_adjacency(G.chain_adjacency(2))[None]
    ref, _ = jax.jit(jm.apply)(jv, jax_clip_normalize(jnp.asarray(u8)), jnp.asarray(adj))
    with torch.no_grad():
        got = model(clip_normalize(_t(u8)), adj)
    _close(got, ref, DETECTOR_TOL)


def test_evaluators_rebuild_vit_gcn_without_its_flavour(improved_run):
    """Reference quirk (ROADMAP Queue 3): JAX's evaluator rebuilds a
    CLIP-trained vit_gcn without its flavour and scores it on ImageNet-
    normalised frames (``evals/evaluate.py:134, 184``); the port's does the
    same, to the same probabilities, which are not the CLIP-normalised
    ones."""
    data, out = improved_run
    sd, meta = E.load_any(str(out / "checkpoint_best.npz"))
    jmodel, jvars, _, jmt = jax_evaluate.build_model_from_checkpoint(sd, meta, "")
    model, report, mt = E.build_model_from_checkpoint(sd, meta, "", device="cpu")
    assert mt == jmt == "vit_gcn" and report["match_ratio"] == 1.0
    assert jmodel.backbone_flavor == model.backbone_flavor == "timm"
    jp, _, jprob = jax_evaluate.evaluate_dataset(jmodel, jvars, JaxDataset(data, num_frames=2),
                                                 jmt, batch_size=2)
    p, _, prob = E.evaluate_dataset(model, VideoFacesDataset(data, num_frames=2),
                                    batch_size=2, model_type=mt)
    assert p == jp
    _close(prob, jprob, DETECTOR_TOL)
    u8 = np.stack([np.load(path)["faces"] for path in p])
    adj = G.normalize_adjacency(G.chain_adjacency(2)).expand(len(p), 2, 2)
    with torch.no_grad():
        clip_prob = torch.softmax(model(clip_normalize(_t(u8)), adj), -1)[:, 1].numpy()
    assert np.abs(clip_prob - prob).max() > 1e-4

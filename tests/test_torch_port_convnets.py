"""The port's conv-net layers, EfficientNet, ResNet, detector and ensemble
against the JAX package's, on the CPU, f32.

Weights are JAX trees (the shapes of the JAX ``init``) filled from a seeded
numpy generator, with batch-norm statistics drawn away from the identity so
that eval-mode normalisation does work, and cross to the port through
``checkpoint.bridge.state_dict_from_jax`` into ``load_state_dict(strict=True)``.
Inputs are seeded numpy arrays. Each JAX forward is compiled once per file.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.models.backbone_detector import (
    BackboneDetector as JaxDetector, EnsembleDetector as JaxEnsemble)
from deepfake_video_detection_tpu.models.efficientnet import EfficientNet as JaxEffNet
from deepfake_video_detection_tpu.models.resnet import ResNet as JaxResNet
from deepfake_video_detection_tpu.nn import layers as JL
from deepfake_video_detection_tpu.utils.tree import flatten_dotted as jax_flatten
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector, build_backbone)
from deepfake_video_detection_tpu_torch.models.efficientnet import EfficientNet
from deepfake_video_detection_tpu_torch.models.resnet import ResNet
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L

S = 64          # input size of the model tests


def _t(a):
    return torch.from_numpy(np.array(a))


def random_variables(model, seed: int):
    """A JAX ``{"params", "state"}`` tree shaped as ``model.init``'s, filled
    from numpy: He-scaled conv and linear weights, BN scales and running
    variances in U(0.5, 1.5), BN shifts and running means N(0, 0.2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))

    def fill(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if len(shape) == 4:                                  # HWIO
            a = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif len(shape) == 2:
            a = rng.normal(size=shape) / np.sqrt(shape[1])
        elif name in ("running_var",) or (name == "weight" and len(shape) == 1):
            a = rng.uniform(0.5, 1.5, size=shape)
        else:
            a = rng.normal(size=shape) * 0.2
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, ref, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol,
                               rtol=atol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_jax(train):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(4, 5, 6, 8)).astype(np.float32)
    p = {"weight": rng.uniform(0.5, 1.5, 8), "bias": rng.normal(size=8)}
    s = {"running_mean": rng.normal(size=8), "running_var": rng.uniform(0.5, 1.5, 8)}
    p, s = ({k: v.astype(np.float32) for k, v in d.items()} for d in (p, s))
    ref, ns = JL.batch_norm(jax.tree_util.tree_map(jnp.asarray, p),
                            jax.tree_util.tree_map(jnp.asarray, s), jnp.asarray(x), train)
    y, (mean, var) = L.batch_norm(_t(x), _t(p["weight"]), _t(p["bias"]),
                                  _t(s["running_mean"]), _t(s["running_var"]), train)
    _close(y, ref, 1e-5)
    _close(mean, ns["running_mean"], 1e-5)
    _close(var, ns["running_var"], 1e-5)


@pytest.mark.parametrize("kernel,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_pools_match_jax(kernel, stride, padding):
    x = np.random.default_rng(kernel).normal(size=(2, 9, 11, 4)).astype(np.float32) - 3.0
    _close(L.max_pool2d(_t(x), kernel, stride, padding),
           JL.max_pool2d(jnp.asarray(x), kernel, stride, padding), 1e-5)
    _close(L.avg_pool2d(_t(x), kernel, stride, padding),
           JL.avg_pool2d(jnp.asarray(x), kernel, stride, padding), 1e-5)


@pytest.mark.parametrize("groups,stride", [(1, 2), (2, 1), (8, 2)])
def test_grouped_conv2d_matches_jax(groups, stride):
    rng = np.random.default_rng(groups)
    x = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8 // groups, 8)).astype(np.float32)     # HWIO
    ref = JL.conv2d({"weight": jnp.asarray(w)}, jnp.asarray(x), stride=stride,
                    padding=1, groups=groups)
    got = L.conv2d(_t(x), _t(np.transpose(w, (3, 2, 0, 1))), stride=stride,
                   padding=1, groups=groups)
    _close(got, ref, 1e-5)


def test_drop_path_is_identity_at_rate_0_and_in_eval_and_per_sample_in_train():
    x = torch.randn(64, 3, 3, 4)
    assert L.drop_path(x, 0.0, train=True) is x
    assert L.drop_path(x, 0.5, train=False) is x
    y = L.drop_path(x, 0.25, train=True, generator=torch.Generator().manual_seed(0))
    kept = (y != 0).flatten(1).any(dim=1)
    assert torch.equal(y[kept], x[kept] / 0.75) and torch.all(y[~kept] == 0)
    assert 0 < int(kept.sum()) < 64


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["efficientnet_b0", "resnet18"])
def backbone_case(request):
    name = request.param
    jmodel = JaxEffNet("b0") if name.startswith("efficientnet") else JaxResNet(name)
    variables = random_variables(jmodel, 1)
    x = np.random.default_rng(1).normal(size=(2, S, S, 3)).astype(np.float32)
    ref, _ = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    return name, jmodel, variables, x, np.asarray(ref)


def _port_backbone(name, **kw):
    if name.startswith("efficientnet"):
        return EfficientNet("b0", device="cpu", **kw)
    return ResNet(name, device="cpu", **kw)


def test_backbone_matches_jax(backbone_case):
    name, _, variables, x, ref = backbone_case
    model = _port_backbone(name)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == ref.shape and float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)


def test_backbone_train_mode_matches_jax(backbone_case):
    """Batch statistics and the running update (drop-path off: the JAX
    forward draws none without an rng)."""
    name, jmodel, variables, x, _ = backbone_case
    ref, ns = jax.jit(lambda v, x: jmodel.apply(v, x, train=True))(variables, jnp.asarray(x))
    kw = {"drop_path_rate": 0.0} if name.startswith("efficientnet") else {}
    model = _port_backbone(name, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
    sd = model.state_dict()
    for k, v in jax_flatten(ns).items():
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(v), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", ["resnet34", "resnet50", "efficientnet_b0",
                                  "efficientnet_b1", "efficientnet_b2",
                                  "efficientnet_b3", "efficientnet_b4"])
def test_backbone_state_dict_matches_jax_tree(name):
    """Keys and shapes of every variant against the JAX tree (templates on
    the meta device, JAX shapes by eval_shape)."""
    jmodel = (JaxResNet(name) if name.startswith("resnet")
              else JaxEffNet(name.split("_")[-1]))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = {k: (v.shape[3], v.shape[2], v.shape[0], v.shape[1]) if len(v.shape) == 4
            else tuple(v.shape)
            for k, v in {**jax_flatten(shapes["params"]),
                         **jax_flatten(shapes["state"])}.items()}
    with I.shapes_only():
        model = build_backbone(name, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert model.feature_dim == jmodel.feature_dim


# ---------------------------------------------------------------------------
# detector and ensemble
# ---------------------------------------------------------------------------


def test_b0_detector_logits_and_frame_scores_match_jax():
    jmodel = JaxDetector("efficientnet_b0")
    variables = random_variables(jmodel, 2)
    x = np.random.default_rng(2).normal(size=(2, 3, S, S, 3)).astype(np.float32)
    (logits, scores), _ = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    model = BackboneDetector("efficientnet_b0", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got_logits, got_scores = model(torch.from_numpy(x))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(scores), atol=5e-5, rtol=5e-4)


METHODS = ("average", "weighted", "voting")


@pytest.fixture(scope="module")
def ensemble_case():
    """One B0 + resnet18 tree (with the ``weighted`` mode's weights) and the
    JAX outputs of all three modes, compiled as one program."""
    variables = random_variables(JaxEnsemble(ensemble_method="weighted"), 3)
    x = np.random.default_rng(3).normal(size=(3, 2, 32, 32, 3)).astype(np.float32)

    def run(v, x):
        unweighted = {"params": {"models": v["params"]["models"]}, "state": v["state"]}
        return {m: JaxEnsemble(ensemble_method=m).apply(
            v if m == "weighted" else unweighted, x, return_member_logits=True)[0]
            for m in METHODS}

    return variables, x, jax.jit(run)(variables, jnp.asarray(x))


@pytest.mark.parametrize("method", METHODS)
def test_ensemble_matches_jax(ensemble_case, method):
    variables, x, ref = ensemble_case
    if method != "weighted":
        variables = {"params": {"models": variables["params"]["models"]},
                     "state": variables["state"]}
    model = EnsembleDetector(ensemble_method=method, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert [type(m.backbone).__name__ for m in model.models] == ["EfficientNet", "ResNet"]
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_member_logits=True)
        plain = model(torch.from_numpy(x))
    for g, r in zip(got, ref[method]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4)
    assert len(plain) == 2 and torch.equal(plain[0], got[0])
    assert ("weights" in model.state_dict()) == (method == "weighted")

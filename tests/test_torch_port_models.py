"""PyTorch port models vs the JAX package's models, on the CPU, f32.

Weights are initialised by the JAX package and carried across with the
port's ``checkpoint.bridge``; inputs are made with numpy from a seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.checkpoint.store import save_checkpoint
from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.nn import layers as JL
from deepfake_video_detection_tpu.utils.tree import flatten_dotted as jax_flatten
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    load_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, build_backbone)
from deepfake_video_detection_tpu_torch.models.vit import _VARIANTS, VisionTransformer
from deepfake_video_detection_tpu_torch.nn import layers as L


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_detector():
    """One JAX ViT-Tiny detector at 224 px and its outputs on one input
    (the JAX compile is paid once for the file)."""
    model = JaxDetector("vit_tiny_patch16_224")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(size=(1, 2, 224, 224, 3)).astype(np.float32)
    (logits, scores), _ = jax.jit(
        lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    return variables, x, np.asarray(logits), np.asarray(scores)


def test_vit_matches_jax():
    # four blocks at 32 px; the detector test below runs all twelve at 224 px
    jmodel = JaxViT(variant="vit_tiny_patch16_224", img_size=32, depth=4)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref, _ = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    model = VisionTransformer(variant="vit_tiny_patch16_224", img_size=32, depth=4,
                              device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_vit_variant_state_dict_matches_jax_tree(variant):
    """Every variant's widths, heads and key paths line up with the JAX
    tree (depth cut to one block to keep the test small)."""
    jmodel = JaxViT(variant=variant, img_size=32, depth=1)
    sd = state_dict_from_jax(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    model = VisionTransformer(variant=variant, img_size=32, depth=1, device="cpu")
    ours = model.state_dict()
    assert sorted(ours) == sorted(sd)
    assert all(tuple(ours[k].shape) == tuple(sd[k].shape) for k in sd)
    assert model.num_heads == jmodel.num_heads
    model.load_state_dict(sd, strict=True)


def test_multi_head_attention_matches_jax_layer():
    rng = np.random.default_rng(2)
    B, N, C, nh = 2, 13, 32, 4
    p = {"qkv": {"weight": rng.normal(size=(3 * C, C)).astype(np.float32) * 0.2,
                 "bias": rng.normal(size=(3 * C,)).astype(np.float32)},
         "proj": {"weight": rng.normal(size=(C, C)).astype(np.float32) * 0.2,
                  "bias": rng.normal(size=(C,)).astype(np.float32)}}
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    ref = JL.multi_head_attention(jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x), nh)
    got = L.multi_head_attention(_t(x), _t(p["qkv"]["weight"]), _t(p["qkv"]["bias"]),
                                 _t(p["proj"]["weight"]), _t(p["proj"]["bias"]), nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_detector_matches_jax(jax_detector):
    variables, x, ref_logits, ref_scores = jax_detector
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        logits, scores = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and scores.shape == (1, 2)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=5e-4)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=5e-4)


def test_state_dict_from_jax_loads_strict(jax_detector):
    variables = jax_detector[0]
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    # conv weights cross HWIO → OIHW
    w = variables["params"]["backbone"]["patch_embed"]["proj"]["weight"]
    assert sd["backbone.patch_embed.proj.weight"].shape == (w.shape[3], w.shape[2],
                                                            w.shape[0], w.shape[1])
    # a flat dotted map of the JAX params gives the same state_dict
    flat = state_dict_from_jax(jax_flatten(variables["params"]))
    assert sorted(flat) == sorted(sd)
    assert all(torch.equal(flat[k], sd[k]) for k in sd)
    assert "temporal_attention.0.weight" in sd and "fc1.weight" in sd


def test_jax_checkpoint_npz_gives_same_logits(jax_detector, tmp_path):
    variables, x, ref_logits, _ = jax_detector
    path = str(tmp_path / "best_model.npz")
    save_checkpoint(path, variables, meta={"backbone": "vit_tiny_patch16_224"},
                    step=7)
    loaded, meta = load_checkpoint(path)
    assert meta["backbone"] == "vit_tiny_patch16_224" and meta["step"] == 7
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    model.load_state_dict(state_dict_from_jax(loaded), strict=True)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=5e-4)


def test_seeded_init_is_reproducible_and_torch_shaped():
    a = BackboneDetector("vit_tiny_patch16_224", device="cpu",
                         generator=torch.Generator().manual_seed(5))
    b = BackboneDetector("vit_tiny_patch16_224", device="cpu",
                         generator=torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["backbone.blocks.0.attn.qkv.weight"]
    assert w.shape == (3 * 192, 192)
    assert float(w.abs().max()) <= 2 * 0.02 + 1e-6      # truncated at 2 std
    assert abs(float(w.std()) - 0.0176) < 0.002         # std of N(0,1) cut at ±2 ≈ 0.88
    assert torch.equal(sa["fc1.bias"], torch.zeros(256))


@pytest.mark.parametrize("name", ["efficientnet_b0", "resnet18", "resnet50"])
def test_unported_backbones_raise(name):
    """The conv-net families, once unported, now build (their parity with
    JAX is in test_torch_port_convnets.py); an unknown name still raises."""
    backbone = build_backbone(name, device="cpu")
    assert backbone.feature_dim == {"efficientnet_b0": 1280, "resnet18": 512,
                                    "resnet50": 2048}[name]
    with pytest.raises(ValueError):
        build_backbone("no_such_backbone")


@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1), (4, 0)])
def test_conv2d_and_layer_norm_match_jax_layers(stride, padding):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)          # HWIO
    b = rng.normal(size=(5,)).astype(np.float32)
    ref = JL.conv2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x), stride=stride, padding=padding)
    got = L.conv2d(_t(x), _t(np.transpose(w, (3, 2, 0, 1))), _t(b),
                   stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    g, beta = rng.normal(size=(3,)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)
    ref_ln = JL.layer_norm({"weight": jnp.asarray(g), "bias": jnp.asarray(beta)},
                           jnp.asarray(x))
    np.testing.assert_allclose(L.layer_norm(_t(x), _t(g), _t(beta)).numpy(),
                               np.asarray(ref_ln), atol=1e-5)


def test_dropout_is_identity_in_eval_and_inverted_in_train():
    x = torch.ones((64, 64))
    assert L.dropout(x, 0.5, train=False) is x
    assert L.dropout(x, 0.0, train=True) is x
    y = L.dropout(x, 0.25, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1.0 / 0.75)
    assert abs(float(kept.float().mean()) - 0.75) < 0.03

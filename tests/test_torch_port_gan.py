"""The port's conditional GAN (``models/vlm_gan.py``) against the JAX
package's, on the CPU, f32.

Small nets (latent 16, cond 8, base 8 channels) at 56 px, where the
upsample chain lands on the size, and 64 px, where it overshoots to 112
and the Generator resizes with ``jax.image.resize``'s antialiased linear
weights; with and without conditioning. Weights come from JAX ``init`` and
cross with the port's bridge; inputs are made with numpy from a seed.
Forwards within 1e-5.

The steps run from the same weights in both packages, at 56 px (at 64 px
JAX's own resize, an XLA einsum, is 1.7e-5 off a float64 contraction on
the CPU where the port's is 3e-7, and that gap reaches G's gradients).
After one Adam step a parameter moves by lr · g / (|g| + ε); wherever JAX's
gradient is above ~100 ε (a step of at least 0.99 lr) the step is well
conditioned and held within 1e-5 (99.99 % of D's elements, about two
thirds of G's, whose gradients are small); below, the step magnifies the
gradient's rounding, and it is held to at most lr. Every conv bias that
feeds a training-mode batch norm has a gradient of 0 up to rounding (the
batch mean cancels it). The SGD case (lr 1, one step: p − g) holds every
gradient within 2e-4 of its tensor's largest, plus the rounding of p − g
(JAX's own G gradients are up to 5.6e-5 of the largest off a float64
computation on the CPU, the port's 1e-6), and the cancelled biases'
gradients at 0 within 1e-4 of the net's largest.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.models import vlm_gan as JG
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.utils.tree import flatten_dotted as jax_flatten
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.models import vlm_gan as G
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.train.optim import Optimizer

LATENT, COND, BASE = 16, 8, 8
ATOL = 1e-5
GRAD_TOL = 2e-4      # a gradient, of its tensor's largest (the SGD case)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nets(size, cond_dim, seed=0):
    """JAX's G and D, their variables, and the port's nets on them."""
    jg = JG.Generator(latent_dim=LATENT, cond_dim=cond_dim, base_channels=BASE, img_size=size)
    jd = JG.Discriminator(cond_dim=cond_dim, base_channels=BASE)
    gv, dv = jg.init(jax.random.PRNGKey(seed)), jd.init(jax.random.PRNGKey(seed + 1))
    g = G.Generator(LATENT, cond_dim, BASE, img_size=size, device="cpu")
    d = G.Discriminator(cond_dim=cond_dim, base_channels=BASE, device="cpu")
    g.load_state_dict(state_dict_from_jax(gv), strict=True)
    d.load_state_dict(state_dict_from_jax(dv), strict=True)
    return jg, jd, gv, dv, g, d


def _inputs(seed, size, cond_dim, B=2):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, LATENT)).astype(np.float32)
    cond = rng.normal(size=(B, cond_dim)).astype(np.float32) if cond_dim else None
    real = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    return z, cond, real


def _j(a):
    return None if a is None else jnp.asarray(a)


def _p(a):
    return None if a is None else _t(a)


def _assert_state(module, variables, atol, skip=()):
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    got = module.state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        if k not in skip:
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=atol, err_msg=k)


@pytest.mark.parametrize("size,cond_dim", [(56, 0), (56, COND), (64, 0), (64, COND)])
def test_forwards_match_jax(size, cond_dim):
    """G and D in eval and in train mode: outputs within 1e-5, and the
    batch-norm running stats each training forward moves."""
    jg, jd, gv, dv, g, d = _nets(size, cond_dim)
    z, cond, _ = _inputs(1, size, cond_dim)
    for train in (False, True):
        ref, ref_gs = jg.apply(gv, jnp.asarray(z), _j(cond), train=train)
        with torch.no_grad():
            img = g(_t(z), _p(cond), train=train)
        assert img.shape == (2, size, size, 3) and float(img.abs().max()) <= 1.0
        np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=ATOL)
        logits_ref, ref_ds = jd.apply(dv, ref, _j(cond), train=train)
        with torch.no_grad():
            logits = d(_t(np.asarray(ref)), _p(cond), train=train)
        assert logits.shape == logits_ref.shape and logits.shape[-1] == 1
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=ATOL)
    _assert_state(g, {"params": gv["params"], "state": ref_gs}, ATOL)
    _assert_state(d, {"params": dv["params"], "state": ref_ds}, ATOL)


def test_keys_init_and_exports():
    """The JAX trees' keys and shapes (BN stats beside ``conv`` and ``bn``),
    N(0, 0.02) weights and zero biases from the port's generator, and the
    names ``models`` exports."""
    from deepfake_video_detection_tpu_torch import models

    jg = JG.Generator(latent_dim=LATENT, cond_dim=COND, base_channels=BASE, img_size=64)
    jd = JG.Discriminator(cond_dim=COND, base_channels=BASE)
    jp = JG.TextProjector(32, COND)
    gen = torch.Generator().manual_seed(0)
    for jnet, net in ((jg, G.Generator(LATENT, COND, BASE, img_size=64, device="cpu",
                                       generator=gen)),
                      (jd, G.Discriminator(cond_dim=COND, base_channels=BASE, device="cpu",
                                           generator=gen))):
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
        ref = {k: tuple(np.shape(v)) for k, v in state_dict_from_jax(
            jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)).items()}
        assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == ref
    ref = jax_flatten(jax.eval_shape(jp.init, jax.random.PRNGKey(0)))
    proj = G.TextProjector(32, COND, device="cpu")
    assert {k: tuple(v.shape) for k, v in proj.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    big = G.Generator(256, 128, 64, device="cpu")
    assert abs(float(big.fc.weight.detach().std()) - 0.02) < 2e-4
    assert not big.fc.bias.any()
    assert float(big.ups[0].running_var.min()) == 1.0
    assert (models.Generator, models.Discriminator, models.TextProjector) == (
        G.Generator, G.Discriminator, G.TextProjector)


@pytest.mark.parametrize("loss_type", ["hinge", "bce"])
def test_losses_match_jax(loss_type):
    rng = np.random.default_rng(2)
    lr, lf = (rng.normal(size=(4, 3, 3, 1)).astype(np.float32) * 2 for _ in range(2))
    np.testing.assert_allclose(
        float(G.adversarial_loss_d(_t(lr), _t(lf), loss_type)),
        float(JG.adversarial_loss_d(jnp.asarray(lr), jnp.asarray(lf), loss_type)), rtol=1e-6)
    np.testing.assert_allclose(float(G.adversarial_loss_g(_t(lf), loss_type)),
                               float(JG.adversarial_loss_g(jnp.asarray(lf), loss_type)),
                               rtol=1e-6)
    # a perfect D: hinge 0, and the ordering of tests/test_extended_models.py
    real, fake = torch.full((4, 3, 3, 1), 2.0), torch.full((4, 3, 3, 1), -2.0)
    assert float(G.adversarial_loss_d(real, fake, "hinge")) == 0.0
    assert float(G.adversarial_loss_d(fake, real, loss_type)) > float(
        G.adversarial_loss_d(real, fake, loss_type))
    assert float(G.adversarial_loss_g(fake, loss_type)) > float(
        G.adversarial_loss_g(real, loss_type))


def _assert_step(module, before, ref_vars, lr, adam, cancelled):
    """The running stats within 1e-5 and the parameters after one step
    against JAX's, as the module docstring says; ``cancelled``: the conv
    biases that feed a training-mode batch norm."""
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_vars))
    steps = {}
    for k, v in module.state_dict().items():
        got, want = v.numpy(), ref[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=k)
        else:
            steps[k] = (before[k].astype(np.float64) - got, before[k].astype(np.float64) - want)
    scale = max(float(np.abs(want).max()) for _, want in steps.values())
    for k, (got, want) in steps.items():
        if k in cancelled:      # gradient 0 up to rounding
            bound = lr * (1 + 1e-4) if adam else 1e-4 * scale
            assert max(float(np.abs(got).max()), float(np.abs(want).max())) <= bound, k
        elif adam:
            sure = np.abs(want) >= 0.99 * lr     # JAX's gradient above ~100 ε
            np.testing.assert_allclose(got[sure], want[sure], atol=ATOL, rtol=0, err_msg=k)
            assert np.all(np.abs(got) <= lr * (1 + 1e-4)), k
        else:                   # the gradient, lr 1, and the rounding of p - g
            tol = GRAD_TOL * float(np.abs(want).max()) + 2 * np.spacing(np.abs(before[k]))
            assert np.all(np.abs(got - want) <= tol), (k, float(np.abs(got - want).max()))


@pytest.mark.parametrize("opt,loss_type,lambda_l1", [("adam", "hinge", 0.0),
                                                     ("sgd", "bce", 0.5)])
def test_gan_steps_match_jax(opt, loss_type, lambda_l1):
    """``d_step`` and ``g_step`` against JAX's ``make_gan_steps`` from the
    same weights, 56 px with conditioning: losses within 1e-5, D's running
    stats after their two moves (real, then fake) within 1e-5, the updated
    parameters as the module docstring says. G runs in eval mode in the D
    step (its stats stay) and D in eval mode in the G step."""
    size = 56
    jg, jd, gv, dv, g, d = _nets(size, COND, seed=3)
    z, cond, real = _inputs(3, size, COND)
    if opt == "adam":
        jopt_g, jopt_d, lr = optax.adam(1e-3), optax.adam(1e-3), 1e-3
        make = lambda: Optimizer("adam", 1e-3, weight_decay=0, grad_clip=None)  # noqa: E731
    else:
        jopt_g, jopt_d, lr = optax.sgd(1.0, momentum=0.9), optax.sgd(1.0, momentum=0.9), 1.0
        make = lambda: Optimizer("sgd", 1.0, weight_decay=0, grad_clip=None)  # noqa: E731
    jd_step, jg_step = JG.make_gan_steps(jg, jd, jopt_g, jopt_d, loss_type, lambda_l1)
    dv2, _, jd_loss = jd_step(dv, jopt_d.init(dv["params"]), gv, jnp.asarray(real),
                              jnp.asarray(z), jnp.asarray(cond))
    gv2, _, jg_loss = jg_step(gv, jopt_g.init(gv["params"]), dv, jnp.asarray(z),
                              jnp.asarray(cond), jnp.asarray(real))

    opt_g, opt_d = make(), make()
    d_step, g_step = G.make_gan_steps(g, d, opt_g, opt_d, loss_type, lambda_l1)
    g_before = {k: v.numpy().copy() for k, v in g.state_dict().items()}
    d_before = {k: v.numpy().copy() for k, v in d.state_dict().items()}
    d_state = opt_d.init(dict(d.named_parameters()))
    d_state, d_loss = d_step(d_state, _t(real), _t(z), _t(cond))
    assert d_state["count"] == 1
    np.testing.assert_allclose(float(d_loss), float(jd_loss), rtol=1e-5)
    assert all(np.array_equal(v.numpy(), g_before[k]) for k, v in g.state_dict().items())
    _assert_step(d, d_before, dv2, lr, opt == "adam",
                 cancelled=[f"net.{i}.conv.bias" for i in range(1, 4)])
    # two moves: the stats differ from those of the real batch alone
    _, one_move = jd.apply(dv, jnp.asarray(real), jnp.asarray(cond), train=True)
    assert not np.allclose(d.state_dict()["net.1.running_mean"].numpy(),
                           np.asarray(one_move["net"]["1"]["running_mean"]))

    d.load_state_dict(state_dict_from_jax(dv), strict=True)     # the same D as JAX's G step
    g_state = opt_g.init(dict(g.named_parameters()))
    g_state, g_loss = g_step(g_state, _t(z), _t(cond), _t(real))
    np.testing.assert_allclose(float(g_loss), float(jg_loss), rtol=1e-5)
    assert all(np.array_equal(v.numpy(), d_before[k]) for k, v in d.state_dict().items())
    _assert_step(g, g_before, gv2, lr, opt == "adam",
                 cancelled=[f"ups.{i}.conv.bias" for i in range(len(g.ups))])


def test_image_condition_matches_jax():
    """``extract_image_condition`` on a two-block ViT-Tiny at 32 px through
    the projector (192 → 8), and without it; ``create_image_conditioned_gan``
    builds the JAX factory's nets."""
    jvit = JaxViT(variant="vit_tiny_patch16_224", img_size=32, depth=2, num_classes=0)
    jproj = JG.TextProjector(text_dim=192, cond_dim=COND)
    vv, pv = jvit.init(jax.random.PRNGKey(4)), jproj.init(jax.random.PRNGKey(5))
    vit = VisionTransformer("vit_tiny_patch16_224", img_size=32, depth=2, device="cpu")
    proj = G.TextProjector(192, COND, device="cpu")
    vit.load_state_dict(state_dict_from_jax(vv), strict=True)
    proj.load_state_dict(state_dict_from_jax(pv), strict=True)
    imgs = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        for p_port, p_jax in ((proj, jproj), (None, None)):
            got = G.extract_image_condition(vit, _t(imgs), p_port)
            ref = JG.extract_image_condition(jvit, vv, jnp.asarray(imgs), p_jax, pv)
            assert got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)

    jG, jD, jv, jp = JG.create_image_conditioned_gan(latent_dim=LATENT, base_channels=BASE,
                                                     img_size=56)
    g, d, v, p = G.create_image_conditioned_gan(latent_dim=LATENT, base_channels=BASE,
                                                img_size=56, device="cpu")
    assert (g.up_chain, g.cond_dim, d.chain, d.cond_dim) == (jG.up_chain, jG.cond_dim,
                                                             jD.chain, jD.cond_dim)
    assert (v.variant, v.num_classes, v.depth, p.text_dim, p.cond_dim) == (
        jv.variant, jv.num_classes, jv.depth, jp.text_dim, jp.cond_dim) == (
        "vit_tiny_patch16_224", 0, 12, 192, 128)
    assert isinstance(G.create_generator(device="cpu"), G.Generator)
    assert G.create_discriminator(device="cpu").cond_dim == 128


def test_gan_checkpoints_cross_both_ways(tmp_path):
    """JAX's file loads into the port's nets strictly; the port's file
    loads in JAX (``params.G``, ``state.D`` …, ``kind = "vlm_gan"``) with
    every array equal, and reads back byte-equal."""
    jg, jd, gv, dv, g, d = _nets(64, COND, seed=6)
    with torch.no_grad():                   # move off the JAX init
        for p in list(g.parameters()) + list(d.buffers()):
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    ours, ref = str(tmp_path / "port_gan.npz"), str(tmp_path / "jax_gan.npz")
    JG.save_gan_checkpoint(ref, gv, dv, extra={"step": 1})
    gsd, dsd, meta = G.load_gan_checkpoint(ref)
    assert meta == {"step": 1, "kind": "vlm_gan"}
    fresh = G.Generator(LATENT, COND, BASE, img_size=64, device="cpu")
    fresh.load_state_dict(gsd, strict=True)
    _assert_state(fresh, gv, 0.0)
    G.Discriminator(cond_dim=COND, base_channels=BASE, device="cpu").load_state_dict(
        dsd, strict=True)

    G.save_gan_checkpoint(ours, g, d.state_dict(), extra={"step": 2})
    jgv, jdv, jmeta = JG.load_gan_checkpoint(ours)
    assert jmeta == {"step": 2, "kind": "vlm_gan"}
    assert sorted(jax_flatten(jdv["state"])) == ["net.1.running_mean", "net.1.running_var",
                                                 "net.2.running_mean", "net.2.running_var",
                                                 "net.3.running_mean", "net.3.running_var"]
    for net, vars_ in ((g, jgv), (d, jdv)):
        ref_sd = state_dict_from_jax(vars_)
        assert sorted(ref_sd) == sorted(net.state_dict())
        assert all(np.array_equal(ref_sd[k].numpy(), v.numpy())
                   for k, v in net.state_dict().items())
    gsd, dsd, _ = G.load_gan_checkpoint(ours)
    for net, sd in ((g, gsd), (d, dsd)):
        assert all(sd[k].numpy().tobytes() == v.numpy().tobytes()
                   for k, v in net.state_dict().items())


def test_too_small_input_raises_as_jax_does():
    jg, jd, gv, dv, g, d = _nets(56, COND)
    x, cond = np.zeros((2, 16, 16, 3), np.float32), np.ones((2, COND), np.float32)
    with pytest.raises(ValueError) as ours:
        d(_t(x), _t(cond))
    with pytest.raises(ValueError) as ref:
        jd.apply(dv, jnp.asarray(x), jnp.asarray(cond))
    assert str(ours.value) == str(ref.value)
    assert "patch output (2, 0, 0, 1)" in str(ours.value)

"""The port's training path vs the JAX package's, on the CPU.

Losses, optimizers, one train step of a small ViT detector, the augment
``apply`` functions fed the JAX draws, the loader, the checkpoint writer,
and the trainer end to end. Inputs and weights are made with numpy from a
seed (or by JAX ``init`` and carried over with the port's bridge).
"""

import csv
import json
import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.checkpoint.store import load_checkpoint as jax_load_checkpoint
from deepfake_video_detection_tpu.data import augment as JA
from deepfake_video_detection_tpu.data.dataset import VideoFacesDataset as JaxDataset
from deepfake_video_detection_tpu.data.loader import Loader as JaxLoader
from deepfake_video_detection_tpu.evals import metrics as JM
from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.train import losses as JLoss
from deepfake_video_detection_tpu.train import optim as JO
from deepfake_video_detection_tpu.train.state import TrainState as JaxTrainState
from deepfake_video_detection_tpu.train.steps import make_train_step as jax_make_train_step
from deepfake_video_detection_tpu.utils.tree import flatten_dotted
from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    save_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.data import augment as A
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.data.loader import Loader, prefetch_to_device
from deepfake_video_detection_tpu_torch.evals import metrics as M
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.serve.predict import Predictor
from deepfake_video_detection_tpu_torch.train import cli
from deepfake_video_detection_tpu_torch.train import losses as L
from deepfake_video_detection_tpu_torch.train import optim as O
from deepfake_video_detection_tpu_torch.train import steps as S
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

SIZE = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_model(seed=0, dropout=0.0, compute_dtype=torch.float32):
    """The port's ViT-Tiny detector cut to two blocks at 32 px, weights from
    a generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    model = BackboneDetector("vit_tiny_patch16_224", dropout_rate=dropout,
                             compute_dtype=compute_dtype, device="cpu", generator=g)
    model.backbone = VisionTransformer("vit_tiny_patch16_224", img_size=SIZE, depth=2,
                                       compute_dtype=compute_dtype, device="cpu",
                                       generator=g)
    return model


def _small_models(seed=0):
    """The same detector in JAX and in the port, on the same weights (JAX
    init carried over)."""
    jmodel = JaxDetector("vit_tiny_patch16_224", dropout_rate=0.0)
    jmodel.backbone = JaxViT(variant="vit_tiny_patch16_224", img_size=SIZE, depth=2)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = _port_model(dropout=0.0)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    """12 clips of 3-7 frames at 32 px, half labelled fake."""
    d = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    for i in range(12):
        label = i % 2
        faces = rng.integers(0, 256, size=(rng.integers(3, 8), SIZE, SIZE, 3),
                             dtype=np.uint8)
        np.savez_compressed(d / f"video_{i}_{'fake' if label else 'real'}.npz",
                            faces=faces, label=np.int64(label))
    return str(d)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ce", "focal"])
@pytest.mark.parametrize("smoothing,weighted,masked", [
    (0.0, False, False), (0.1, True, False), (0.2, True, True)])
def test_losses_match_jax(kind, smoothing, weighted, masked):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(6, 2)).astype(np.float32) * 2
    labels = rng.integers(0, 2, size=(6,))
    cw = np.asarray([0.7, 1.3], np.float32) if weighted else None
    mask = np.asarray([1, 1, 0, 1, 0, 1], bool) if masked else None
    kw = dict(class_weights=cw, label_smoothing=smoothing)
    if kind == "ce":
        ref = JLoss.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                       sample_mask=None if mask is None else jnp.asarray(mask), **kw)
        got = L.cross_entropy_loss(_t(logits), _t(labels),
                                   sample_mask=None if mask is None else _t(mask), **kw)
    else:
        ref = JLoss.focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma=2.0,
                               sample_mask=None if mask is None else jnp.asarray(mask), **kw)
        got = L.focal_loss(_t(logits), _t(labels), gamma=2.0,
                           sample_mask=None if mask is None else _t(mask), **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-7)


def test_bce_and_class_weights_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(9,)).astype(np.float32) * 3
    y = rng.integers(0, 2, size=(9,)).astype(np.float32)
    np.testing.assert_allclose(
        float(L.binary_cross_entropy_with_logits(_t(x), _t(y))),
        float(JLoss.binary_cross_entropy_with_logits(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6)
    labels = np.asarray([0, 0, 0, 1, 0, 1, 0])
    np.testing.assert_array_equal(L.inverse_frequency_class_weights(labels),
                                  JLoss.inverse_frequency_class_weights(labels))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _schedules(mod, which):
    if which == "step":
        return mod.step_lr_schedule(0.05, 2, 0.5, steps_per_epoch=1)
    if which == "cosine":
        return mod.cosine_schedule(0.05, 4, steps_per_epoch=1)
    return mod.cosine_warm_restarts(0.05, 1, 2, steps_per_epoch=1)


@pytest.mark.parametrize("schedule", ["step", "cosine", "warm_restarts"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(name, schedule):
    """Five steps over a fixed gradient sequence with the clip (which
    triggers on some steps and not on others) and the params EMA."""
    rng = np.random.default_rng(11)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.1, 1.0, 0.05, 2.0, 0.3)]
    kw = dict(weight_decay=0.01, grad_clip=1.0, ema_decay=0.8)
    tx = JO.build_optimizer(name, _schedules(JO, schedule), **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt = O.build_optimizer(name, _schedules(O, schedule), **kw)
    tp = {k: _t(v) for k, v in params.items()}
    state = opt.init(tp)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        opt.step(tp, {k: _t(v) for k, v in g.items()}, state)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=2e-5, atol=1e-6)
    jema = JO.get_ema_params(jstate)
    for k in params:
        np.testing.assert_allclose(O.get_ema_params(state)[k].numpy(),
                                   np.asarray(jema[k]), rtol=2e-5, atol=1e-6)
    for step in range(8):
        assert _schedules(O, schedule)(step) == pytest.approx(
            float(_schedules(JO, schedule)(jnp.asarray(step))), rel=1e-6)


def test_plateau_and_early_stopping_match_jax():
    seq = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83]
    jp, p = JO.ReduceLROnPlateau(patience=2), O.ReduceLROnPlateau(patience=2)
    je, e = JO.EarlyStopping(3, mode="min"), O.EarlyStopping(3, mode="min")
    for v in seq:
        assert p.update(v) == jp.update(v)
        assert e.update(v) == je.update(v)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def test_train_step_matches_jax():
    """One step of a two-block ViT-Tiny detector (dropout 0, f32): loss,
    grad norm and every updated parameter. SGD with a clip that triggers,
    so the update is linear in the gradient (Adam's first step is
    ±lr wherever |g| ≫ eps, which would hide gradient errors and amplify
    rounding where |g| ~ eps; Adam is held to optax on its own above)."""
    jmodel, variables, model = _small_models(seed=3)
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(2, 3, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray([0, 1])
    valid = np.asarray([True, True])
    cw = np.asarray([0.8, 1.2], np.float32)

    def jloss(logits, labels, sample_mask=None):
        return JLoss.cross_entropy_loss(logits, labels, class_weights=cw,
                                        label_smoothing=0.1, sample_mask=sample_mask)

    tx = JO.build_optimizer("sgd", 0.5, grad_clip=0.1)
    jstep = jax_make_train_step(jmodel, tx, jloss, donate=False)
    jstate, jm = jstep(JaxTrainState.create(variables, tx),
                       {"frames": jnp.asarray(frames), "labels": jnp.asarray(labels),
                        "valid": jnp.asarray(valid)}, jax.random.PRNGKey(0))

    def loss(logits, labels, sample_mask=None):
        return L.cross_entropy_loss(logits, labels, class_weights=cw,
                                    label_smoothing=0.1, sample_mask=sample_mask)

    opt = O.build_optimizer("sgd", 0.5, grad_clip=0.1)
    step = S.make_train_step(model, opt, loss)
    state, m = step(TrainState.create(model, opt),
                    {"frames": _t(frames), "labels": _t(labels), "valid": _t(valid)})
    assert state.step == 1 and int(m["count"]) == 2
    assert int(m["correct"]) == int(jm["correct"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.variables))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=k)


def test_accum_step_matches_full_batch_and_remat():
    """``make_accum_step`` over 2 microbatches (one padded row) equals the
    full-batch step; ``remat`` changes nothing."""
    rng = np.random.default_rng(4)
    frames = _t(rng.normal(size=(4, 2, SIZE, SIZE, 3)).astype(np.float32))
    labels = _t(np.asarray([0, 1, 1, 0]))
    valid = _t(np.asarray([True, True, True, False]))
    cw = torch.tensor([0.6, 1.4])

    def loss(logits, labels, sample_mask=None):
        return L.cross_entropy_loss(logits, labels, class_weights=cw,
                                    sample_mask=sample_mask)

    def weights(lab, val):
        return cw[lab] * val.to(torch.float32)

    results = []
    for kind in ("full", "accum", "remat"):
        model = _port_model(seed=5)
        opt = O.build_optimizer("sgd", 0.5, grad_clip=None)
        st = TrainState.create(model, opt)
        if kind == "accum":
            step = S.make_accum_step(model, opt, loss, 2, sample_weight_fn=weights)
            batch = {"frames": frames.reshape(2, 2, *frames.shape[1:]),
                     "labels": labels.reshape(2, 2), "valid": valid.reshape(2, 2)}
        else:
            step = S.make_train_step(model, opt, loss, remat=kind == "remat")
            batch = {"frames": frames, "labels": labels, "valid": valid}
        _, m = step(st, batch)
        results.append((m, {k: v.clone() for k, v in model.state_dict().items()}))
    (m0, p0), (m1, p1), (m2, p2) = results
    assert int(m1["count"]) == int(m0["count"]) == 3
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m0["grad_norm"]), rtol=1e-4)
    for k in p0:
        np.testing.assert_allclose(p1[k].numpy(), p0[k].numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(p2[k].numpy(), p0[k].numpy())
    # and make_multi_step runs: two of those batches as one group of 2
    model = _port_model(seed=5)
    opt = O.build_optimizer("sgd", 0.5, grad_clip=None)
    multi = S.make_multi_step(model, opt, loss, 2)
    st, m = multi(TrainState.create(model, opt),
                  {"frames": frames.reshape(2, 2, *frames.shape[1:]),
                   "labels": labels.reshape(2, 2), "valid": valid.reshape(2, 2)})
    assert st.step == 2 and st.opt_state["count"] == 2 and int(m["count"]) == 3
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


def test_bf16_compute_keeps_f32_params_and_bf16_activations():
    """With f32 params and a bf16 compute dtype every block sees bf16
    activations: cls_token and pos_embed are cast, not promoted."""
    model = _port_model(compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    for blk in model.backbone.blocks:
        blk.register_forward_hook(lambda mod, inp, out: seen.append(
            (inp[0].dtype, out.dtype)))
    x = torch.randn(1, 2, SIZE, SIZE, 3)
    logits, _ = model(x)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * len(model.backbone.blocks)
    assert logits.dtype == torch.float32
    # and it trains: the gradients reach the f32 params
    loss = L.cross_entropy_loss(logits, torch.tensor([1]))
    loss.backward()
    assert model.backbone.blocks[0].attn.qkv.weight.grad.dtype == torch.float32


def test_detector_dropout_draws_from_the_generator():
    model = _port_model(dropout=0.5)
    x = torch.randn(3, 2, SIZE, SIZE, 3)
    with torch.no_grad():
        a = model(x, train=True, generator=torch.Generator().manual_seed(1))[0]
        b = model(x, train=True, generator=torch.Generator().manual_seed(1))[0]
        c = model(x, train=True, generator=torch.Generator().manual_seed(2))[0]
        e = model(x, train=False)[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, e)


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch, npz_dir, tmp_path):
    """Without a card, a model, a Trainer or a Predictor built without a
    device raises instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BackboneDetector("vit_tiny_patch16_224")
    with pytest.raises(RuntimeError, match="CUDA"):
        VisionTransformer("vit_tiny_patch16_224", img_size=SIZE, depth=1)
    model = _port_model()
    ds = VideoFacesDataset(npz_dir, num_frames=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, ds, ds, TrainerConfig(out_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, None, "pretrained")
    with pytest.raises(RuntimeError, match="CUDA"):   # the CLI's default model
        cli.build_model("vit_gcn", 4)
    with pytest.raises(RuntimeError, match="CUDA"):   # the pretrained model's default
        cli.build_model("pretrained", 4, backbone="efficientnet_b0")
    with pytest.raises(RuntimeError, match="CUDA"):   # progressive fine-tuning
        cli.main(["--data_dir", npz_dir, "--model", "pretrained", "--progressive"])
    videos = tmp_path / "videos"                      # --from-videos: labelled clips,
    videos.mkdir()                                    # which the dataset lists undecoded
    (videos / "clip_fake.mp4").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--data_dir", str(videos), "--from-videos"])


# ---------------------------------------------------------------------------
# augment: each apply fed the JAX draws
# ---------------------------------------------------------------------------

CFG_ON = JA.AugmentConfig(p_flip=1.0, p_jitter=1.0, p_gray=1.0, p_downscale=1.0,
                          p_jpeg=1.0, p_blur=1.0)


def _jax_draws(key, cfg, H, W):
    """The numbers ``augment_clip`` draws from ``key``, split as it splits."""
    ks = jax.random.split(key, 8)
    k1, k2, k3, k4 = jax.random.split(ks[0], 4)
    area = jax.random.uniform(k1, (), minval=cfg.crop_scale[0], maxval=cfg.crop_scale[1])
    r = jnp.exp(jax.random.uniform(k2, (), minval=math.log(cfg.crop_ratio[0]),
                                   maxval=math.log(cfg.crop_ratio[1])))
    ch = jnp.clip(jnp.sqrt(area / r) * H, 8.0, H)
    cw = jnp.clip(jnp.sqrt(area * r) * W, 8.0, W)
    kb, kc, kss = jax.random.split(ks[3], 3)
    d1, d2 = jax.random.split(ks[5])
    j1, j2 = jax.random.split(ks[6])
    b1, b2 = jax.random.split(ks[7])
    u = jax.random.uniform
    return {
        "crop_y0": u(k3, (), minval=0.0, maxval=1.0) * (H - ch),
        "crop_x0": u(k4, (), minval=0.0, maxval=1.0) * (W - cw),
        "crop_h": ch, "crop_w": cw,
        "flip": jax.random.bernoulli(ks[1], cfg.p_flip),
        "jitter": jax.random.bernoulli(ks[2], cfg.p_jitter),
        "brightness": u(kb, (), minval=1 - cfg.brightness, maxval=1 + cfg.brightness),
        "contrast": u(kc, (), minval=1 - cfg.contrast, maxval=1 + cfg.contrast),
        "saturation": u(kss, (), minval=1 - cfg.saturation, maxval=1 + cfg.saturation),
        "gray": jax.random.bernoulli(ks[4], cfg.p_gray),
        "downscale": jax.random.bernoulli(d1, cfg.p_downscale),
        "downscale_s": u(d2, (), minval=cfg.downscale_min, maxval=0.95),
        "jpeg": jax.random.bernoulli(j1, cfg.p_jpeg),
        "jpeg_q": u(j2, (), minval=float(cfg.jpeg_q_min), maxval=float(cfg.jpeg_q_max)),
        "blur": jax.random.bernoulli(b1, cfg.p_blur),
        "blur_sigma": u(b2, (), minval=0.1, maxval=cfg.blur_sigma_max),
    }


def _batch_draws(keys, cfg, H, W):
    per = [_jax_draws(k, cfg, H, W) for k in keys]
    return {n: _t(np.stack([np.asarray(d[n]) for d in per])) for n in per[0]}


def _clips(seed, B=2, T=2, H=16, W=24):
    return np.random.default_rng(seed).uniform(0, 255, size=(B, T, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("aug", ["crop", "flip", "jitter", "gray", "downscale", "jpeg", "blur"])
def test_augment_apply_matches_jax(aug):
    x = _clips(20)
    B, _, H, W, _ = x.shape
    keys = jax.random.split(jax.random.PRNGKey(21), B)
    p = _batch_draws(keys, CFG_ON, H, W)
    tx = _t(x)
    if aug == "crop":
        got = A.resized_crop(tx, p["crop_y0"], p["crop_x0"], p["crop_h"], p["crop_w"])
        ref = [JA.random_resized_crop(jax.random.split(k, 8)[0], jnp.asarray(c),
                                      CFG_ON.crop_scale, CFG_ON.crop_ratio)
               for k, c in zip(keys, x)]
    elif aug == "flip":
        got = A.hflip(tx, p["flip"])
        ref = [JA.random_hflip(jax.random.split(k, 8)[1], jnp.asarray(c), 1.0)
               for k, c in zip(keys, x)]
    elif aug == "jitter":
        got = A.color_jitter(tx, p["jitter"], p["brightness"], p["contrast"],
                             p["saturation"])
        ref = [JA.color_jitter(jax.random.split(k, 8)[3], jnp.asarray(c), 0.15, 0.15, 0.15)
               for k, c in zip(keys, x)]
    elif aug == "gray":
        got = A.grayscale(tx, p["gray"])
        ref = [JA.random_grayscale(jax.random.split(k, 8)[4], jnp.asarray(c), 1.0)
               for k, c in zip(keys, x)]
    elif aug == "downscale":
        got = A.downscale_upscale(tx, p["downscale"], p["downscale_s"])
        ref = [JA.random_downscale_upscale(jax.random.split(k, 8)[5], jnp.asarray(c),
                                           1.0, 0.5) for k, c in zip(keys, x)]
    elif aug == "jpeg":
        got = A.jpeg_recompress(tx, p["jpeg"], p["jpeg_q"])
        ref = [JA.jpeg_recompress(jax.random.split(k, 8)[6], jnp.asarray(c), 1.0, 35, 95)
               for k, c in zip(keys, x)]
    else:
        got = A.gaussian_blur(tx, p["blur"], p["blur_sigma"])
        ref = [JA.gaussian_blur(jax.random.split(k, 8)[7], jnp.asarray(c), 1.0, 1.5)
               for k, c in zip(keys, x)]
    ref = np.stack([np.asarray(r) for r in ref])
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=1e-5)


@pytest.mark.parametrize("cfg", [JA.AugmentConfig(), CFG_ON], ids=["default", "all_on"])
def test_augment_pipeline_matches_jax(cfg):
    """``apply_params`` with the JAX draws vs ``augment_batch``, every
    augmentation in order."""
    x = _clips(30, B=3, T=2, H=16, W=16)
    rng = jax.random.PRNGKey(31)
    ref = np.asarray(JA.augment_batch(rng, jnp.asarray(x), cfg))
    p = _batch_draws(jax.random.split(rng, 3), cfg, 16, 16)
    got = A.apply_params(_t(x), p)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=1e-5)
    # the port's own draws: per-clip (B,) params in range, output in range
    g = torch.Generator().manual_seed(0)
    out = A.augment_batch(g, _t(x).to(torch.uint8), A.AugmentConfig())
    assert out.shape == x.shape and 0.0 <= float(out.min()) <= float(out.max()) <= 255.0


# ---------------------------------------------------------------------------
# data, metrics, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle,weighted", [(True, False), (False, True)])
def test_loader_batches_match_jax(npz_dir, shuffle, weighted):
    jds, ds = JaxDataset(npz_dir, num_frames=4), VideoFacesDataset(npz_dir, num_frames=4)
    jl = JaxLoader(jds, 5, shuffle=shuffle, weighted=weighted, seed=3, num_workers=2)
    pl = Loader(ds, 5, shuffle=shuffle, weighted=weighted, seed=3, num_workers=2)
    jl.epoch = pl.epoch = 2
    jb, pb = list(jl), list(pl)
    assert len(jb) == len(pb) == 3
    for a, b in zip(jb, pb):
        assert a["paths"] == b["paths"]
        for k in ("frames", "labels", "valid"):
            np.testing.assert_array_equal(a[k], b[k])
    paths = [b["paths"] for b in pb]
    dev = list(prefetch_to_device(iter(pb), "cpu"))
    assert torch.equal(dev[0]["frames"], torch.from_numpy(pb[0]["frames"]))
    assert [b["paths"] for b in dev] == paths


def test_metrics_match_jax():
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, 40)
    s = rng.uniform(size=40)
    pred = (s > 0.5).astype(np.int64)
    assert M.binary_metrics(y, pred) == JM.binary_metrics(y, pred)
    assert M.roc_auc(y, s) == JM.roc_auc(y, s)
    assert M.threshold_sweep(y, s) == JM.threshold_sweep(y, s)
    assert M.real_score_quantiles(y, s) == JM.real_score_quantiles(y, s)
    np.testing.assert_array_equal(M.confusion_matrix(y, pred), JM.confusion_matrix(y, pred))


def test_port_checkpoint_loads_in_jax_with_the_same_logits(tmp_path):
    jmodel, _, model = _small_models(seed=6)
    with torch.no_grad():                     # move off the JAX init
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    opt = O.build_optimizer("adamw", 1e-3)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, model.state_dict(), {"epoch": 3},
                    opt_state=opt.init(dict(model.named_parameters())), step=9)
    variables, meta = jax_load_checkpoint(path)
    assert meta["epoch"] == 3 and meta["step"] == 9 and len(meta["_opt_leaves"]) > 0
    assert sorted(flatten_dotted(variables["params"])) == sorted(model.state_dict())
    x = np.random.default_rng(6).normal(size=(1, 2, SIZE, SIZE, 3)).astype(np.float32)
    (ref, _), _ = jmodel.apply({"params": variables["params"],
                                "state": {"backbone": {}}}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = model(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def test_trainer_runs_writes_artefacts_and_resumes(npz_dir, tmp_path):
    ds = VideoFacesDataset(npz_dir, num_frames=2)
    train_ds, val_ds = ds.split(0.25)
    out = str(tmp_path / "run")
    cfg = TrainerConfig(out_dir=out, epochs=2, batch_size=4, num_frames=2,
                        lr=1e-3, optimizer="adamw", schedule="cosine",
                        threshold_sweep=True, plateau=True, ema_decay=0.9,
                        model_config={"model_type": "pretrained"})
    logs = []
    trainer = Trainer(_port_model(), train_ds, val_ds, cfg, device="cpu")
    state = trainer.train(log=logs.append)
    assert state.step == 2 * 3 and len(logs) == 2
    for name in ("checkpoint_best.npz", "checkpoint_best_ema.npz", "checkpoint_epoch_1.npz",
                 "training_history.csv", "calibration_best.json", "preds_epoch_1.csv"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "training_history.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert all(math.isfinite(float(r["train_loss"])) for r in rows)
    with open(os.path.join(out, "calibration_best.json")) as f:
        cal = json.load(f)
    assert 0.05 <= cal["best_thr_f1"] <= 0.95

    cfg3 = TrainerConfig(**{**cfg.__dict__, "epochs": 3})
    trainer2 = Trainer(_port_model(seed=9), train_ds, val_ds, cfg3, device="cpu")
    state2 = trainer2.resume(os.path.join(out, "checkpoint_epoch_1.npz"))
    assert trainer2.start_epoch == 2 and state2.step == 6
    assert state2.opt_state["count"] == 6
    for k, v in state.model.state_dict().items():
        assert torch.equal(trainer2.model.state_dict()[k], v)
    for k, v in state.opt_state["mu"].items():
        assert torch.equal(state2.opt_state["mu"][k], v)
    state2 = trainer2.train(state2, log=logs.append)
    assert state2.step == 9 and len(logs) == 3
    assert os.path.exists(os.path.join(out, "checkpoint_epoch_2.npz"))


def test_trainer_interrupt_writes_a_resumable_checkpoint(npz_dir, tmp_path, monkeypatch):
    """KeyboardInterrupt (and SIGTERM, turned into one) mid-run writes
    ``checkpoint_interrupt.npz`` whose epoch resumes at the interrupted one."""
    ds = VideoFacesDataset(npz_dir, num_frames=2)
    cfg = TrainerConfig(out_dir=str(tmp_path), epochs=3, batch_size=6, num_frames=2,
                        augment=False)
    trainer = Trainer(_port_model(), ds, ds, cfg, device="cpu")
    calls = []

    def interrupted(state, epoch):
        calls.append(epoch)
        if epoch == 1:
            raise KeyboardInterrupt
        return Trainer.train_epoch(trainer, state, epoch)

    monkeypatch.setattr(trainer, "train_epoch", interrupted)
    with pytest.raises(KeyboardInterrupt):
        trainer.train(log=lambda _: None)
    path = str(tmp_path / "checkpoint_interrupt.npz")
    resumed = Trainer(_port_model(seed=4), ds, ds, cfg, device="cpu")
    resumed.resume(path)
    assert calls == [0, 1] and resumed.start_epoch == 1


def test_cli_trains_a_vit_detector_on_the_cpu(tmp_path):
    d = tmp_path / "faces"
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in range(4):
        np.savez(d / f"clip_{i}.npz", label=np.int64(i % 2),
                 faces=rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8))
    out = tmp_path / "run"
    assert cli.main(["--data_dir", str(d), "--model", "pretrained",
                     "--backbone", "vit_tiny_patch16_224", "--epochs", "1",
                     "--batch_size", "2", "--num_frames", "2", "--bf16",
                     "--out_dir", str(out), "--device", "cpu"]) == 0
    assert (out / "checkpoint_best.npz").exists() and (out / "preds_epoch_0.csv").exists()
    # --from-videos is ported (test_torch_port_prepare.py): it reads video
    # files, and a directory of face stacks has none, as in the JAX package
    with pytest.raises(FileNotFoundError, match="no labeled video files"):
        cli.main(["--data_dir", str(d), "--model", "pretrained", "--from-videos"])

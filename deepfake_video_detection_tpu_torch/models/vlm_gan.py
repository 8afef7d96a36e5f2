"""Conditional GAN for face synthesis experiments, on the card.

Counterpart of ``deepfake_video_detection_tpu/models/vlm_gan.py`` (the
reference's ``src/VLM_GAN.py``): the upsampling :class:`Generator` (latent
[+ conditioning] → 7 × 7 → doubling nearest-upsample conv blocks → tanh
RGB), the PatchGAN :class:`Discriminator` (conditioning as an extra input
channel), the :class:`TextProjector`, the hinge and BCE adversarial losses,
:func:`make_gan_steps`, the image-conditioned variant over a ViT feature
extractor, and the one-file checkpoint.

Parameters sit under the JAX tree's keys (``fc``, ``ups.i.conv``,
``ups.i.bn``, ``to_rgb``; ``net.i.conv``, ``net.i.bn``, ``final``,
``cond_proj``; ``fc1``, ``fc2``) and each block's batch-norm running stats
beside its ``conv`` and ``bn`` (``ups.i.running_mean``), where the JAX
model keeps them in its state tree, so ``checkpoint.bridge`` carries a JAX
tree across with ``load_state_dict(strict=True)`` and
:func:`save_gan_checkpoint` writes them under ``state.``. Activations are
NHWC, weights OIHW; N(0, 0.02) init drawn from the caller's generator.

No Pallas kernel of the JAX package runs here: convolutions and linears
are cuDNN and cuBLAS through torch. The image-conditioned variant's ViT
runs the flash kernels (``nn/layers.py::multi_head_attention``). The
Generator's overshoot resize (``img_size`` not 7·2^k) is
``jax.image.resize``'s antialiased linear resampling, as two products with
``data/augment.py::resample_weights`` (``F.interpolate`` weighs otherwise).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.data.augment import resample_weights
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.train.optim import Optimizer
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


def _conv(k: int, cin: int, cout: int, g: torch.Generator, dev) -> nn.Conv2d:
    c = skip_init(nn.Conv2d, cin, cout, k, device=dev, dtype=torch.float32)
    with torch.no_grad():
        c.weight.copy_(I.normal(c.weight.shape, g, std=0.02))
        c.bias.copy_(I.zeros(cout))
    return c


def _lin(cin: int, cout: int, g: torch.Generator, dev) -> nn.Linear:
    lin = skip_init(nn.Linear, cin, cout, device=dev, dtype=torch.float32)
    with torch.no_grad():
        lin.weight.copy_(I.normal(lin.weight.shape, g, std=0.02))
        lin.bias.copy_(I.zeros(cout))
    return lin


class _Affine(nn.Module):
    """Batch norm's ``weight`` and ``bias`` (the JAX tree's ``bn`` node)."""

    def __init__(self, ch: int, dev):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, device=dev))
        self.bias = nn.Parameter(torch.zeros(ch, device=dev))


class ConvBlock(nn.Module):
    """A conv (with bias) and, with ``bn``, batch norm whose running stats
    are this block's buffers (the JAX state tree's ``ups.i`` / ``net.i``)."""

    def __init__(self, k: int, cin: int, cout: int, bn: bool, g: torch.Generator, dev):
        super().__init__()
        self.conv = _conv(k, cin, cout, g, dev)
        if bn:
            self.bn = _Affine(cout, dev)
            self.register_buffer("running_mean", torch.zeros(cout, device=dev))
            self.register_buffer("running_var", torch.ones(cout, device=dev))

    def forward(self, x: torch.Tensor, stride: int, train: bool) -> torch.Tensor:
        x = L.conv2d(x, self.conv.weight, self.conv.bias, stride=stride, padding=1)
        if not hasattr(self, "bn"):
            return x
        y, (mean, var) = L.batch_norm(x, self.bn.weight, self.bn.bias, self.running_mean,
                                      self.running_var, train)
        if train and not L.running_stats_frozen():
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y


def _upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _resize_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, size, size, C), "linear")`` on NHWC:
    antialiased triangle weights, one product per spatial axis."""
    H, W = x.shape[1], x.shape[2]
    one = torch.zeros(1, device=x.device)
    wy = resample_weights(H, size, one + size / H, one, True)[0].to(x.dtype)   # (H, s)
    wx = resample_weights(W, size, one + size / W, one, True)[0].to(x.dtype)   # (W, s)
    y = torch.einsum("bhwc,hy->bywc", x, wy)
    return torch.einsum("bywc,wx->byxc", y, wx)


class Generator(nn.Module):
    """z (B, latent) [+ cond (B, cond_dim)] → images (B, H, W, 3) in [-1, 1]."""

    def __init__(self, latent_dim: int = 256, cond_dim: int = 0, base_channels: int = 64,
                 out_channels: int = 3, img_size: int = 224, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.latent_dim, self.cond_dim = latent_dim, cond_dim or 0
        self.base_channels, self.out_channels = base_channels, out_channels
        self.img_size = img_size
        self.start_spatial = 7
        self.start_channels = base_channels * 8
        # the upsample chain 7 → ≥ img_size, doubling
        chain = []
        ch, spatial = self.start_channels, self.start_spatial
        while spatial < img_size:
            out = max(base_channels, ch // 2)
            chain.append((ch, out))
            ch, spatial = out, spatial * 2
        self.up_chain = chain
        self.final_ch = ch
        self.fc = _lin(latent_dim + self.cond_dim, self.start_channels * 49, g, dev)
        self.ups = nn.ModuleList(ConvBlock(3, cin, cout, True, g, dev) for cin, cout in chain)
        self.to_rgb = _conv(3, ch, out_channels, g, dev)

    def forward(self, z: torch.Tensor, cond: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        x = z if (self.cond_dim == 0 or cond is None) else torch.cat([z, cond], dim=-1)
        x = torch.relu(L.linear(x, self.fc.weight, self.fc.bias))
        x = x.reshape(z.shape[0], self.start_spatial, self.start_spatial, self.start_channels)
        for blk in self.ups:
            x = torch.relu(blk(_upsample_nearest(x), 1, train))
        if x.shape[1] != self.img_size:   # the 7·2^k overshoot, resized
            x = _resize_linear(x, self.img_size)
        return torch.tanh(L.conv2d(x, self.to_rgb.weight, self.to_rgb.bias, padding=1))


class Discriminator(nn.Module):
    """PatchGAN: images (B, H, W, 3) [+ cond] → patch logits (B, h', w', 1)."""

    def __init__(self, in_channels: int = 3, cond_dim: int = 0, base_channels: int = 64,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.cond_dim = cond_dim or 0
        self.in_channels = in_channels + (1 if self.cond_dim > 0 else 0)
        self.base_channels = base_channels
        chain = [(self.in_channels, base_channels)]
        ch = base_channels
        for _ in range(3):
            out = min(ch * 2, 512)
            chain.append((ch, out))
            ch = out
        self.chain = chain
        self.final_ch = ch
        self.net = nn.ModuleList(ConvBlock(4, cin, cout, i > 0, g, dev)
                                 for i, (cin, cout) in enumerate(chain))
        self.final = _conv(4, ch, 1, g, dev)
        if self.cond_dim > 0:
            self.cond_proj = _lin(self.cond_dim, 1, g, dev)

    def _patch_shape(self, x: torch.Tensor) -> Tuple[int, int, int, int]:
        """The logits' shape: four 4×4 stride-2 convs, then a stride-1 one."""
        h, w = x.shape[1], x.shape[2]
        for _ in self.chain:
            h, w = max(0, (h - 2) // 2 + 1), max(0, (w - 2) // 2 + 1)
        return (x.shape[0], max(0, h - 1), max(0, w - 1), 1)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        shape = self._patch_shape(x)
        if 0 in shape:
            raise ValueError(
                f"Discriminator input too small: patch output {shape}; "
                f"use images ≥ 64px for this 4-stride PatchGAN")
        if self.cond_dim > 0 and cond is not None:
            proj = L.linear(cond, self.cond_proj.weight, self.cond_proj.bias)   # (B, 1)
            x = torch.cat([x, proj[:, None, None, :].expand(x.shape[:3] + (1,))], dim=-1)
        for blk in self.net:
            x = F.leaky_relu(blk(x, 2, train), 0.2)
        return L.conv2d(x, self.final.weight, self.final.bias, padding=1)


class TextProjector(nn.Module):
    """Text embedding (B, text_dim) → conditioning (B, cond_dim)."""

    def __init__(self, text_dim: int = 768, cond_dim: int = 128, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.text_dim, self.cond_dim = text_dim, cond_dim
        self.fc1 = _lin(text_dim, cond_dim * 2, g, dev)
        self.fc2 = _lin(cond_dim * 2, cond_dim, g, dev)

    def forward(self, txt: torch.Tensor) -> torch.Tensor:
        h = torch.relu(L.linear(txt, self.fc1.weight, self.fc1.bias))
        return L.linear(h, self.fc2.weight, self.fc2.bias)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def adversarial_loss_d(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                       loss_type: str = "hinge") -> torch.Tensor:
    lr, lf = logits_real.to(torch.float32), logits_fake.to(torch.float32)
    if loss_type == "hinge":
        return torch.mean(torch.relu(1.0 - lr)) + torch.mean(torch.relu(1.0 + lf))
    # BCE with logits on real = 1 / fake = 0
    return torch.mean(F.softplus(-lr)) + torch.mean(F.softplus(lf))


def adversarial_loss_g(logits_fake: torch.Tensor, loss_type: str = "hinge") -> torch.Tensor:
    lf = logits_fake.to(torch.float32)
    if loss_type == "hinge":
        return -torch.mean(lf)
    return torch.mean(F.softplus(-lf))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def make_gan_steps(G: Generator, D: Discriminator, opt_g: Optimizer, opt_d: Optimizer,
                   loss_type: str = "hinge", lambda_l1: float = 0.0
                   ) -> Tuple[Callable[..., Tuple[Dict[str, Any], torch.Tensor]],
                              Callable[..., Tuple[Dict[str, Any], torch.Tensor]]]:
    """``(d_step, g_step)``, each one full update of its network in place:

    ``d_step(d_opt_state, real_imgs, z, cond) -> (d_opt_state, loss)``: G in
    eval mode makes the fakes without a gradient; D runs in train mode on the
    real and then the fake batch, so its running stats move twice.
    ``g_step(g_opt_state, z, cond, target_imgs) -> (g_opt_state, loss)``: G
    in train mode, D in eval mode; ``lambda_l1`` > 0 adds the L1 distance to
    ``target_imgs``. The optimizer states come from ``opt_d.init`` /
    ``opt_g.init`` over the nets' named parameters."""

    def d_step(d_opt_state, real_imgs, z, cond=None):
        with torch.no_grad():
            fake_imgs = G(z, cond, train=False)
        params = dict(D.named_parameters())
        lr = D(real_imgs, cond, train=True)
        lf = D(fake_imgs, cond, train=True)
        loss = adversarial_loss_d(lr, lf, loss_type)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        opt_d.step(params, dict(zip(params, grads)), d_opt_state)
        return d_opt_state, loss.detach()

    def g_step(g_opt_state, z, cond=None, target_imgs=None):
        params = dict(G.named_parameters())
        fake_imgs = G(z, cond, train=True)
        loss = adversarial_loss_g(D(fake_imgs, cond, train=False), loss_type)
        if lambda_l1 > 0.0:
            loss = loss + lambda_l1 * torch.mean(torch.abs(fake_imgs - target_imgs))
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        opt_g.step(params, dict(zip(params, grads)), g_opt_state)
        return g_opt_state, loss.detach()

    return d_step, g_step


# ---------------------------------------------------------------------------
# the image-conditioned variant, factories and checkpoints
# ---------------------------------------------------------------------------


def extract_image_condition(feat_extractor: nn.Module, imgs: torch.Tensor,
                            projector: Optional[TextProjector] = None) -> torch.Tensor:
    """The feature extractor's features of the conditioning images (NHWC,
    normalised), through ``projector`` when given: the cond vector."""
    feats = feat_extractor(imgs, train=False)
    return projector(feats) if projector is not None else feats


def create_generator(latent_dim: int = 256, cond_dim: int = 128, base_channels: int = 64,
                     img_size: int = 224, device=None,
                     generator: Optional[torch.Generator] = None) -> Generator:
    return Generator(latent_dim, cond_dim, base_channels, img_size=img_size, device=device,
                     generator=generator)


def create_discriminator(cond_dim: int = 128, base_channels: int = 64, device=None,
                         generator: Optional[torch.Generator] = None) -> Discriminator:
    return Discriminator(cond_dim=cond_dim, base_channels=base_channels, device=device,
                         generator=generator)


def create_image_conditioned_gan(latent_dim: int = 256, cond_dim: int = 128,
                                 base_channels: int = 64, img_size: int = 224,
                                 vit_variant: str = "vit_tiny_patch16_224", device=None,
                                 generator: Optional[torch.Generator] = None):
    """``(G, D, feature extractor, projector)`` for image conditioning: a
    ``vit_variant`` ViT with ``num_classes=0`` and a ``TextProjector`` from
    its width to ``cond_dim``, all drawn from one generator."""
    from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer

    g = generator or torch.Generator().manual_seed(0)
    vit = VisionTransformer(variant=vit_variant, num_classes=0, device=device, generator=g)
    proj = TextProjector(text_dim=vit.feature_dim, cond_dim=cond_dim, device=device,
                         generator=g)
    G = Generator(latent_dim, cond_dim, base_channels, img_size=img_size, device=device,
                  generator=g)
    D = Discriminator(cond_dim=cond_dim, base_channels=base_channels, device=device,
                      generator=g)
    return G, D, vit, proj


def _state_dict(net) -> Mapping[str, torch.Tensor]:
    return net.state_dict() if isinstance(net, nn.Module) else net


def save_gan_checkpoint(path: str, g, d, extra: Optional[Mapping[str, Any]] = None) -> None:
    """Both nets (modules or their state dicts) in one native ``.npz``:
    ``params.G.*``, ``params.D.*``, their running stats under ``state.G.*``
    and ``state.D.*``, meta ``kind = "vlm_gan"``, as the JAX package writes."""
    from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint

    combined = {f"{name}.{k}": v for name, net in (("G", g), ("D", d))
                for k, v in _state_dict(net).items()}
    save_checkpoint(path, combined, meta=dict(extra or {}, kind="vlm_gan"))


def load_gan_checkpoint(path: str):
    """``(G state dict, D state dict, meta)`` of a GAN checkpoint written by
    either package; load each with ``load_state_dict(strict=True)``."""
    from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
        load_checkpoint, state_dict_from_jax)

    combined, meta = load_checkpoint(path)
    g, d = ({"params": combined["params"][name], "state": combined["state"].get(name, {})}
            for name in ("G", "D"))
    return state_dict_from_jax(g), state_dict_from_jax(d), meta

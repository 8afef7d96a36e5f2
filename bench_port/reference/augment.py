"""A frozen copy of the training augmentation of the program under test as
it stood when this benchmark was written (RandomResizedCrop, flip, colour
jitter, grayscale, downscale-upscale, JPEG in maths, blur; one draw per
clip, drawn in a fixed order from a ``torch.Generator``), so that the
training reference can work the augmented batch out again from the raw
clips and the same generator. Plain PyTorch; imports nothing of the
program. A change to the program's augmentation or to the order of its
draws has to be mirrored here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AugmentConfig:
    crop_scale: Tuple[float, float] = (0.8, 1.0)
    crop_ratio: Tuple[float, float] = (0.9, 1.1)
    p_flip: float = 0.5
    p_jitter: float = 0.8
    brightness: float = 0.15
    contrast: float = 0.15
    saturation: float = 0.15
    p_gray: float = 0.05
    p_downscale: float = 0.15
    downscale_min: float = 0.5
    p_jpeg: float = 0.30
    jpeg_q_min: int = 35
    jpeg_q_max: int = 95
    p_blur: float = 0.10
    blur_sigma_max: float = 1.5


_LUMA = (0.299, 0.587, 0.114)


def _clip_view(on: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-clip (B,) tensor shaped to broadcast over (B, T, H, W, C)."""
    return on.reshape((-1,) + (1,) * (x.ndim - 1))


# ---------------------------------------------------------------------------
# resampling (jax.image.scale_and_translate, linear kernel)
# ---------------------------------------------------------------------------


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor, antialias: bool) -> torch.Tensor:
    """Per-clip ``(B, in, out)`` f32 weights of
    ``jax.image.compute_weight_mat`` with the triangle kernel."""
    scale = scale.to(torch.float32)[:, None, None]
    translation = translation.to(torch.float32)[:, None, None]
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else 1.0
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)[None, None, :]
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    sample_f = (out_pos + 0.5) * inv_scale - translation * inv_scale - 0.5
    w = torch.clamp(1.0 - torch.abs(sample_f - in_pos) / kernel_scale, min=0.0)
    total = torch.sum(w, dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def scale_and_translate(x: torch.Tensor, scale: torch.Tensor,
                        translation: torch.Tensor, antialias: bool) -> torch.Tensor:
    """``x`` (B, T, H, W, C) resampled onto the same canvas; ``scale`` and
    ``translation`` are (B, 2) per clip, (y, x) order."""
    _, _, H, W, _ = x.shape
    wy = resample_weights(H, H, scale[:, 0], translation[:, 0], antialias)
    wx = resample_weights(W, W, scale[:, 1], translation[:, 1], antialias)
    y = torch.einsum("bthwc,bhy->btywc", x, wy)
    return torch.einsum("btywc,bwx->btyxc", y, wx)


# ---------------------------------------------------------------------------
# the augmentations, each a deterministic function of its draws
# ---------------------------------------------------------------------------


def resized_crop(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 ch: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """Crop box (y0, x0, ch, cw) per clip, bilinearly resized back to the
    input resolution."""
    H, W = x.shape[2], x.shape[3]
    scale = torch.stack([H / ch, W / cw], dim=1)
    translation = torch.stack([-y0 * scale[:, 0], -x0 * scale[:, 1]], dim=1)
    return scale_and_translate(x, scale, translation, antialias=True)


def hflip(x: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    return torch.where(_clip_view(on, x), x.flip(3), x)


def color_jitter(x: torch.Tensor, on: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=x.device)
    y = x * _clip_view(b, x)
    mean = torch.mean(y * luma, dim=(-3, -2, -1), keepdim=True) * 3.0
    y = (y - mean) * _clip_view(c, x) + mean
    gray = torch.sum(y * luma, dim=-1, keepdim=True)
    y = (y - gray) * _clip_view(s, x) + gray
    return torch.where(_clip_view(on, x), y, x)


def grayscale(x: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=x.device)
    gray = torch.sum(x * luma, dim=-1, keepdim=True).expand_as(x)
    return torch.where(_clip_view(on, x), gray, x)


def downscale_upscale(x: torch.Tensor, on: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Soften by an antialiased downsample by ``s`` onto the same canvas
    (content in the top-left s-fraction) and a linear upsample back."""
    s2 = torch.stack([s, s], dim=1).to(torch.float32)
    zero = torch.zeros_like(s2)
    down = scale_and_translate(x, s2, zero, antialias=True)
    up = scale_and_translate(down, 1.0 / s2, zero, antialias=False)
    return torch.where(_clip_view(on, x), up, x)


# ITU-T T.81 Annex K standard luminance quantisation table
_Q_LUMA = (
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 35, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99))


def _dct_matrix(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float32, device=device)
    grid = torch.cos(math.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    m = grid * math.sqrt(2.0 / n)
    m[0] = m[0] * (1.0 / math.sqrt(2.0))
    return m


def jpeg_recompress(x: torch.Tensor, on: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quality-q JPEG artefacts in maths: per-channel 8×8 DCT, quantise with
    the standard table scaled by libjpeg's quality curve, dequantise, IDCT."""
    B, T, H, W, C = x.shape
    if H % 8 or W % 8:
        raise ValueError("JPEG augmentation needs 8-aligned sizes")
    qf = q.to(torch.float32)
    scale = torch.where(qf < 50.0, 5000.0 / qf, 200.0 - 2.0 * qf)
    table = torch.tensor(_Q_LUMA, dtype=torch.float32, device=x.device)
    table = torch.clamp(torch.floor((table * scale[:, None, None] + 50.0) / 100.0),
                        1.0, 255.0)                                  # (B, 8, 8)
    tb = table[:, None, None, :, None, :, None]
    D = _dct_matrix(8, x.device)
    xb = (x - 128.0).reshape(B, T, H // 8, 8, W // 8, 8, C)
    xb = torch.einsum("ij,bthjwkc,lk->bthiwlc", D, xb, D)
    coeff = torch.round(xb / tb) * tb
    yb = torch.einsum("ji,bthjwkc,kl->bthiwlc", D, coeff, D)
    y = torch.clamp(yb.reshape(B, T, H, W, C) + 128.0, 0.0, 255.0)
    return torch.where(_clip_view(on, x), y, x)


def gaussian_blur(x: torch.Tensor, on: torch.Tensor, sigma: torch.Tensor,
                  ksize: int = 5) -> torch.Tensor:
    """Separable Gaussian of per-clip ``sigma``, zero padding."""
    half = ksize // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    g = torch.exp(-0.5 * torch.square(xs[None, :] / sigma.to(torch.float32)[:, None]))
    g = g / torch.sum(g, dim=1, keepdim=True)                         # (B, k)
    H, W = x.shape[2], x.shape[3]
    gb = g[:, :, None, None, None, None]
    xp = F.pad(x, (0, 0, 0, 0, half, half))                            # pad H
    y = sum(gb[:, i] * xp[:, :, i:i + H] for i in range(ksize))
    yp = F.pad(y, (0, 0, half, half))                                  # pad W
    y = sum(gb[:, i] * yp[:, :, :, i:i + W] for i in range(ksize))
    return torch.where(_clip_view(on, x), y, x)


# ---------------------------------------------------------------------------
# draws and the full pipeline
# ---------------------------------------------------------------------------


def draw_params(generator: Optional[torch.Generator], batch: int,
                size: Tuple[int, int], cfg: AugmentConfig = AugmentConfig(),
                device=None) -> Params:
    """Every random number of one batch's augmentation, each a (B,) tensor
    on ``device`` (the generator's device by default)."""
    device = device if device is not None else (
        generator.device if generator is not None else "cpu")

    def u(lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        r = torch.rand((batch,), generator=generator, device=device)
        return lo + (hi - lo) * r

    H, W = size
    area = u(*cfg.crop_scale)
    r = torch.exp(u(math.log(cfg.crop_ratio[0]), math.log(cfg.crop_ratio[1])))
    ch = torch.clamp(torch.sqrt(area / r) * H, 8.0, float(H))
    cw = torch.clamp(torch.sqrt(area * r) * W, 8.0, float(W))
    return {
        "crop_y0": u() * (H - ch), "crop_x0": u() * (W - cw),
        "crop_h": ch, "crop_w": cw,
        "flip": u() < cfg.p_flip,
        "jitter": u() < cfg.p_jitter,
        "brightness": u(1 - cfg.brightness, 1 + cfg.brightness),
        "contrast": u(1 - cfg.contrast, 1 + cfg.contrast),
        "saturation": u(1 - cfg.saturation, 1 + cfg.saturation),
        "gray": u() < cfg.p_gray,
        "downscale": u() < cfg.p_downscale,
        "downscale_s": u(cfg.downscale_min, 0.95),
        "jpeg": u() < cfg.p_jpeg,
        "jpeg_q": u(float(cfg.jpeg_q_min), float(cfg.jpeg_q_max)),
        "blur": u() < cfg.p_blur,
        "blur_sigma": u(0.1, cfg.blur_sigma_max),
    }


def apply_params(batch: torch.Tensor, p: Params) -> torch.Tensor:
    """The pipeline of ``augment_clip`` on (B, T, H, W, 3) with the draws
    ``p``; float32 in [0, 255] out."""
    x = batch.to(torch.float32)
    x = resized_crop(x, p["crop_y0"], p["crop_x0"], p["crop_h"], p["crop_w"])
    x = hflip(x, p["flip"])
    x = color_jitter(x, p["jitter"], p["brightness"], p["contrast"], p["saturation"])
    x = grayscale(x, p["gray"])
    x = downscale_upscale(x, p["downscale"], p["downscale_s"])
    x = jpeg_recompress(x, p["jpeg"], p["jpeg_q"])
    x = gaussian_blur(x, p["blur"], p["blur_sigma"])
    return torch.clamp(x, 0.0, 255.0)


def augment_batch(generator: Optional[torch.Generator], batch: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """(B, T, H, W, 3) uint8/float → augmented float32 in [0, 255], every
    clip with its own draws."""
    p = draw_params(generator, batch.shape[0], (batch.shape[2], batch.shape[3]),
                    cfg, device=batch.device)
    return apply_params(batch, p)

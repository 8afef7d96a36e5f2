"""YUV420 → RGB conversion on the device (plain PyTorch).

Counterpart of ``deepfake_video_detection_tpu/ops/yuv.py`` (which has no
Pallas kernel). Serving ships face crops as packed planar YUV420, half the
bytes of RGB24 on the host→device link; the colour matrix runs here.

Convention: limited-range BT.601 (what swscale emits for
``AV_PIX_FMT_YUV420P``), Y in [16, 235], U/V in [16, 240] centred at 128;
chroma upsampled 2× by repetition (nearest).
"""

from __future__ import annotations

import torch


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """(..., H, W) luma + (..., H/2, W/2) chroma → (..., H, W, 3) float32
    RGB in [0, 255]."""
    yf = y.to(torch.float32) - 16.0
    uf = u.to(torch.float32) - 128.0
    vf = v.to(torch.float32) - 128.0
    uf = uf.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
    vf = vf.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
    yl = 1.164383 * yf
    r = yl + 1.596027 * vf
    g = yl - 0.391762 * uf - 0.812968 * vf
    b = yl + 2.017232 * uf
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def unpack_yuv420(packed: torch.Tensor, height: int, width: int):
    """Split a packed (..., H*W*3//2) uint8 buffer (Y, then U, then V) into
    its (y, u, v) planes."""
    hw = height * width
    qw = (height // 2) * (width // 2)
    lead = tuple(packed.shape[:-1])
    y = packed[..., :hw].reshape(lead + (height, width))
    u = packed[..., hw:hw + qw].reshape(lead + (height // 2, width // 2))
    v = packed[..., hw + qw:hw + 2 * qw].reshape(lead + (height // 2, width // 2))
    return y, u, v


def yuv420_packed_to_rgb(packed: torch.Tensor, height: int, width: int
                         ) -> torch.Tensor:
    """Packed (..., H*W*3//2) uint8 → (..., H, W, 3) float32 RGB [0, 255]."""
    return yuv420_to_rgb(*unpack_yuv420(packed, height, width))

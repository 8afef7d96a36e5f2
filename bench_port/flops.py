"""The benchmark's yardstick arithmetic: the card's peaks, the model FLOPs of
each configuration, and the work (bytes and operations) of each kernel call
whose share of the roofline a per-layer metric reports.

Everything is worked out from a configuration's widths and a call's shapes
and dtype, never from which kernel ran, so a kernel that a later change
replaces is read against the same work. A call's bytes count each input read
once and each output written once.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense rates
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "f32": 4}


def least_time_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM bandwidth and the operations over the dtype's peak (f32 products
    are held against the TF32 tensor-core peak)."""
    peak = PEAK_FLOPS["tf32" if dtype == "f32" else dtype]
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


# ---------------------------------------------------------------------------
# kernel calls
# ---------------------------------------------------------------------------


def flash_fwd_work(B: int, H: int, N: int, d: int, dtype: str) -> Tuple[float, float]:
    """softmax(QK^T / sqrt(d)) V: q, k, v read, O written (dtype), the f32
    logsumexp written; 2 products of 2*N*N*d operations a head."""
    e = ELEMENT_BYTES[dtype]
    return 4 * B * H * N * d * e + 4 * B * H * N, 4.0 * B * H * N * N * d


def flash_bwd_work(B: int, H: int, N: int, d: int, dtype: str) -> Tuple[float, float]:
    """The backward from (q, k, v, O, dO, lse): those read, dq, dk, dv
    written; five N x N x d products (S recomputed, dV, dP, dQ, dK)."""
    e = ELEMENT_BYTES[dtype]
    return 8 * B * H * N * d * e + 4 * B * H * N, 10.0 * B * H * N * N * d


def k1_yuv_work(frames: int, height: int, width: int, dtype: str) -> Tuple[float, float]:
    """Packed YUV420 in (1.5 bytes a pixel), normalised RGB out; its
    arithmetic is negligible beside its bytes."""
    px = frames * height * width
    return px * 3 // 2 + px * 3 * ELEMENT_BYTES[dtype], 0.0


# ---------------------------------------------------------------------------
# model FLOPs (multiply-accumulates counted as two operations)
# ---------------------------------------------------------------------------


def vit_macs_per_frame(c: Dict) -> float:
    """Patch embedding, then per block the QKV, the two attention products,
    the output projection and the MLP (timm's ViT, CLS token included)."""
    D, L, F = c["hidden_size"], c["num_hidden_layers"], c["intermediate_size"]
    patches = (c["image_size"] // c["patch_size"]) ** 2
    N = patches + 1
    embed = patches * D * 3 * c["patch_size"] ** 2
    block = N * D * 3 * D + 2 * N * N * D + N * D * D + 2 * N * D * F
    return float(embed + L * block)


def efficientnet_specs(c: Dict):
    """(stem channels, [(kind, in, out, kernel, stride, expand)], head
    channels) with EfficientNet's channel rounding and depth scaling."""
    def round_ch(ch: float) -> int:
        ch *= c["width_coefficient"]
        new = max(8, int(ch + 4) // 8 * 8)
        return int(new + 8 if new < 0.9 * ch else new)

    stem = round_ch(c["stem_channels"])
    blocks, cin = [], stem
    for kind, out, repeats, stride, kernel, expand in c["stages"]:
        cout = round_ch(out)
        for j in range(int(math.ceil(repeats * c["depth_coefficient"]))):
            blocks.append((kind, cin, cout, kernel, stride if j == 0 else 1, expand))
            cin = cout
    return stem, blocks, c["head_channels"]


def efficientnet_macs_per_frame(c: Dict) -> float:
    """Every convolution (stem, the blocks' pointwise, depthwise and
    squeeze-excite convolutions, the head) at its output resolution."""
    stem, blocks, head = efficientnet_specs(c)
    hw = c["image_size"] // 2
    macs = hw * hw * stem * 3 * 9
    for kind, cin, cout, k, stride, expand in blocks:
        mid = cin * expand
        rd = max(1, int(cin * c["se_ratio"]))
        if kind == "ir":
            macs += hw * hw * cin * mid
        hw = -(-hw // stride)
        macs += hw * hw * mid * k * k + 2 * mid * rd + hw * hw * mid * cout
    return float(macs + hw * hw * blocks[-1][2] * head)


def feature_dim(c: Dict) -> int:
    return c["hidden_size"] if c["architecture"] == "vit" else c["head_channels"]


def backbone_macs_per_frame(c: Dict) -> float:
    if c["architecture"] == "vit":
        return vit_macs_per_frame(c)
    return efficientnet_macs_per_frame(c)


def model_flops_per_clip(c: Dict, frames: int) -> float:
    """The served forward of one clip: the backbone over each frame, the
    temporal attention over each frame's features, the fc head once."""
    F, h = feature_dim(c), c["head"]
    head = frames * (F * h["temporal_attention_hidden"] + h["temporal_attention_hidden"]) \
        + F * h["fc_hidden"] + h["fc_hidden"] * h["num_classes"]
    return 2.0 * (frames * backbone_macs_per_frame(c) + head)


def train_flops_per_frame(c: Dict, frames_per_clip: int) -> float:
    """A training step's FLOPs a frame: three times the forward."""
    return 3.0 * model_flops_per_clip(c, frames_per_clip) / frames_per_clip

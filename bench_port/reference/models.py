"""The plain reference of each configuration: the served clip's forward
(packed YUV420 -> RGB -> ImageNet normalisation -> backbone per frame ->
temporal-attention pooling -> fc head) in float32 PyTorch over a dict of
named tensors, written from the published descriptions (ViT-B/16:
arXiv:2010.11929 as timm's ``vit_base_patch16_224``; EfficientNet-B0:
arXiv:1905.11946 as timm's ``efficientnet_b0``) and the port's documented
head. It imports nothing of the program under test.

``quant``, when given, is applied to both operands of every matrix product
and convolution (the control's lower precision); None computes in float32.
The callers set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (``fp32_exact``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
Shapes = List[Tuple[str, Tuple[int, ...]]]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def fp32_exact() -> Iterator[None]:
    """float32 products without TF32, restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale for the tensor (its largest magnitude onto
    448), back in float32."""
    scale = 448.0 / x.abs().max().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Rounds its input to float8 in the forward and the gradient that
    reaches it in the backward, each with a scale of its own."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """The control's precision, the next below the configuration's bfloat16:
    a product's operand rounded to float8 e4m3 (and its gradient too)."""
    return _Fp8.apply(x)


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def linear(x, w, b=None, quant: Quant = None):
    return F.linear(_q(x, quant), _q(w, quant), b)


def conv(x, w, b=None, stride=1, padding=0, groups=1, quant: Quant = None):
    return F.conv2d(_q(x, quant), _q(w, quant), b, stride, padding, 1, groups)


# ---------------------------------------------------------------------------
# input
# ---------------------------------------------------------------------------


def yuv420_to_normalized(packed: torch.Tensor, size: int) -> torch.Tensor:
    """(..., size*size*3/2) uint8 packed planar YUV420 (Y, U, V) ->
    (..., size, size, 3) float32, ImageNet-normalised. Limited-range BT.601,
    chroma repeated 2x, RGB clamped to [0, 255]."""
    hw, q = size * size, (size // 2) ** 2
    lead = tuple(packed.shape[:-1])
    p = packed.to(torch.float32)
    y = p[..., :hw].reshape(lead + (size, size)) - 16.0
    u = p[..., hw:hw + q].reshape(lead + (size // 2, size // 2)) - 128.0
    v = p[..., hw + q:hw + 2 * q].reshape(lead + (size // 2, size // 2)) - 128.0
    u = u.repeat_interleave(2, -1).repeat_interleave(2, -2)
    v = v.repeat_interleave(2, -1).repeat_interleave(2, -2)
    yl = 1.164383 * y
    rgb = torch.stack([yl + 1.596027 * v, yl - 0.391762 * u - 0.812968 * v,
                       yl + 2.017232 * u], dim=-1).clamp(0.0, 255.0)
    return normalize(rgb / 255.0)


def normalize(x01: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x01.device)
    return (x01 - mean) / std


# ---------------------------------------------------------------------------
# ViT-B/16
# ---------------------------------------------------------------------------


def vit_shapes(c: Dict) -> Shapes:
    D, F_, P = c["hidden_size"], c["intermediate_size"], c["patch_size"]
    n = (c["image_size"] // P) ** 2 + 1
    out: Shapes = [("cls_token", (1, 1, D)), ("pos_embed", (1, n, D)),
                   ("patch_embed.proj.weight", (D, 3, P, P)), ("patch_embed.proj.bias", (D,))]
    for i in range(c["num_hidden_layers"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (D,)), (b + "norm1.bias", (D,)),
                (b + "attn.qkv.weight", (3 * D, D)), (b + "attn.qkv.bias", (3 * D,)),
                (b + "attn.proj.weight", (D, D)), (b + "attn.proj.bias", (D,)),
                (b + "norm2.weight", (D,)), (b + "norm2.bias", (D,)),
                (b + "mlp.fc1.weight", (F_, D)), (b + "mlp.fc1.bias", (F_,)),
                (b + "mlp.fc2.weight", (D, F_)), (b + "mlp.fc2.bias", (D,))]
    return out + [("norm.weight", (D,)), ("norm.bias", (D,))]


def vit_features(sd: Dict[str, torch.Tensor], x: torch.Tensor, c: Dict,
                 quant: Quant = None) -> torch.Tensor:
    """(N, H, W, 3) normalised frames -> (N, D) post-norm CLS features."""
    D, H, P, eps = c["hidden_size"], c["num_attention_heads"], c["patch_size"], \
        c["layer_norm_eps"]
    y = conv(x.permute(0, 3, 1, 2), sd["patch_embed.proj.weight"],
             sd["patch_embed.proj.bias"], stride=P, quant=quant)
    y = y.flatten(2).transpose(1, 2)                                  # (N, patches, D)
    y = torch.cat([sd["cls_token"].expand(y.shape[0], -1, -1), y], 1) + sd["pos_embed"]
    Nb, T, hd = y.shape[0], y.shape[1], D // H
    for i in range(c["num_hidden_layers"]):
        b = f"blocks.{i}."
        h = F.layer_norm(y, (D,), sd[b + "norm1.weight"], sd[b + "norm1.bias"], eps)
        qkv = linear(h, sd[b + "attn.qkv.weight"], sd[b + "attn.qkv.bias"], quant)
        q, k, v = qkv.reshape(Nb, T, 3, H, hd).permute(2, 0, 3, 1, 4)
        s = _q(q, quant) @ _q(k, quant).transpose(-1, -2) / math.sqrt(hd)
        a = _q(torch.softmax(s, dim=-1), quant) @ _q(v, quant)
        a = a.transpose(1, 2).reshape(Nb, T, D)
        y = y + linear(a, sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"], quant)
        h = F.layer_norm(y, (D,), sd[b + "norm2.weight"], sd[b + "norm2.bias"], eps)
        h = F.gelu(linear(h, sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"], quant))
        y = y + linear(h, sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"], quant)
    y = F.layer_norm(y, (D,), sd["norm.weight"], sd["norm.bias"], eps)
    return y[:, 0]


# ---------------------------------------------------------------------------
# EfficientNet-B0 (eval-mode batch norm)
# ---------------------------------------------------------------------------


def _round_ch(ch: float, mult: float) -> int:
    ch *= mult
    new = max(8, int(ch + 4) // 8 * 8)
    return int(new + 8 if new < 0.9 * ch else new)


def efficientnet_blocks(c: Dict):
    """[(name, kind, in, out, kernel, stride, expand)] and the stem width."""
    stem = _round_ch(c["stem_channels"], c["width_coefficient"])
    out, cin = [], stem
    for s, (kind, ch, repeats, stride, kernel, expand) in enumerate(c["stages"]):
        cout = _round_ch(ch, c["width_coefficient"])
        for j in range(int(math.ceil(repeats * c["depth_coefficient"]))):
            out.append((f"blocks.{s}.{j}.", kind, cin, cout, kernel,
                        stride if j == 0 else 1, expand))
            cin = cout
    return stem, out


def _bn(name: str, ch: int) -> Shapes:
    return [(name + "weight", (ch,)), (name + "bias", (ch,))]


def efficientnet_shapes(c: Dict) -> Shapes:
    stem, blocks = efficientnet_blocks(c)
    out: Shapes = [("conv_stem.weight", (stem, 3, 3, 3))] + _bn("bn1.", stem)
    for b, kind, cin, cout, k, _, expand in blocks:
        mid, rd = cin * expand, max(1, int(cin * c["se_ratio"]))
        se = [(b + "se.conv_reduce.weight", (rd, mid, 1, 1)), (b + "se.conv_reduce.bias", (rd,)),
              (b + "se.conv_expand.weight", (mid, rd, 1, 1)), (b + "se.conv_expand.bias", (mid,))]
        if kind == "ds":
            out += [(b + "conv_dw.weight", (cin, 1, k, k))] + _bn(b + "bn1.", cin) + se + \
                [(b + "conv_pw.weight", (cout, cin, 1, 1))] + _bn(b + "bn2.", cout)
        else:
            out += [(b + "conv_pw.weight", (mid, cin, 1, 1))] + _bn(b + "bn1.", mid) + \
                [(b + "conv_dw.weight", (mid, 1, k, k))] + _bn(b + "bn2.", mid) + se + \
                [(b + "conv_pwl.weight", (cout, mid, 1, 1))] + _bn(b + "bn3.", cout)
    head = c["head_channels"]
    return out + [("conv_head.weight", (head, blocks[-1][3], 1, 1))] + _bn("bn2.", head)


def efficientnet_buffers(c: Dict) -> Shapes:
    """Every batch norm's running mean and variance."""
    return [(n[:-len("weight")] + stat, s) for n, s in efficientnet_shapes(c)
            if n.endswith("bn1.weight") or n.endswith("bn2.weight") or n.endswith("bn3.weight")
            for stat in ("running_mean", "running_var")]


def efficientnet_features(sd: Dict[str, torch.Tensor], x: torch.Tensor, c: Dict,
                          quant: Quant = None) -> torch.Tensor:
    """(N, H, W, 3) normalised frames -> (N, head channels) pooled features."""
    eps = c["batch_norm_eps"]

    def bn(y, name):
        m, v = sd[name + "running_mean"], sd[name + "running_var"]
        w, b = sd[name + "weight"], sd[name + "bias"]
        return (y - m[:, None, None]) / torch.sqrt(v[:, None, None] + eps) \
            * w[:, None, None] + b[:, None, None]

    def se(y, b):
        s = y.mean(dim=(2, 3), keepdim=True)
        s = F.silu(conv(s, sd[b + "se.conv_reduce.weight"], sd[b + "se.conv_reduce.bias"],
                        quant=quant))
        s = conv(s, sd[b + "se.conv_expand.weight"], sd[b + "se.conv_expand.bias"], quant=quant)
        return y * torch.sigmoid(s)

    y = x.permute(0, 3, 1, 2)
    y = F.silu(bn(conv(y, sd["conv_stem.weight"], stride=2, padding=1, quant=quant), "bn1."))
    _, blocks = efficientnet_blocks(c)
    for b, kind, cin, cout, k, stride, _ in blocks:
        x_in = y
        if kind == "ds":
            y = conv(y, sd[b + "conv_dw.weight"], stride=stride, padding=k // 2, groups=cin,
                     quant=quant)
            y = se(F.silu(bn(y, b + "bn1.")), b)
            y = bn(conv(y, sd[b + "conv_pw.weight"], quant=quant), b + "bn2.")
        else:
            y = F.silu(bn(conv(y, sd[b + "conv_pw.weight"], quant=quant), b + "bn1."))
            y = conv(y, sd[b + "conv_dw.weight"], stride=stride, padding=k // 2,
                     groups=y.shape[1], quant=quant)
            y = se(F.silu(bn(y, b + "bn2.")), b)
            y = bn(conv(y, sd[b + "conv_pwl.weight"], quant=quant), b + "bn3.")
        if stride == 1 and cin == cout:
            y = y + x_in
    y = F.silu(bn(conv(y, sd["conv_head.weight"], quant=quant), "bn2."))
    return y.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# the detector: backbone per frame, temporal attention, fc head
# ---------------------------------------------------------------------------


def head_shapes(feat: int, h: Dict) -> Shapes:
    a, f, n = h["temporal_attention_hidden"], h["fc_hidden"], h["num_classes"]
    return [("temporal_attention.0.weight", (a, feat)), ("temporal_attention.0.bias", (a,)),
            ("temporal_attention.2.weight", (1, a)), ("temporal_attention.2.bias", (1,)),
            ("fc1.weight", (f, feat)), ("fc1.bias", (f,)),
            ("fc2.weight", (n, f)), ("fc2.bias", (n,))]


def detector_shapes(c: Dict) -> Tuple[Shapes, Shapes]:
    """(parameters, buffers) of the detector, under the state-dict names the
    served model takes."""
    if c["architecture"] == "vit":
        body, bufs, feat = vit_shapes(c), [], c["hidden_size"]
    else:
        body, bufs, feat = efficientnet_shapes(c), efficientnet_buffers(c), c["head_channels"]
    pre = lambda shapes: [("backbone." + n, s) for n, s in shapes]  # noqa: E731
    return pre(body) + head_shapes(feat, c["head"]), pre(bufs)


def backbone_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n[len("backbone."):]: t for n, t in sd.items() if n.startswith("backbone.")}


def detector_forward(sd: Dict[str, torch.Tensor], frames: torch.Tensor, c: Dict,
                     quant: Quant = None,
                     dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                     ) -> torch.Tensor:
    """(B, T, H, W, 3) normalised frames -> (B, classes) float32 logits.
    ``dropout`` (training) is applied to the pooled features and to the fc
    hidden layer, in that order."""
    B, T = frames.shape[:2]
    body = backbone_state(sd)
    x = frames.reshape((B * T,) + tuple(frames.shape[2:]))
    feats = (vit_features if c["architecture"] == "vit" else efficientnet_features)(
        body, x, c, quant).reshape(B, T, -1)
    a = torch.relu(linear(feats, sd["temporal_attention.0.weight"],
                          sd["temporal_attention.0.bias"], quant))
    a = torch.sigmoid(linear(a, sd["temporal_attention.2.weight"],
                             sd["temporal_attention.2.bias"], quant))[..., 0]
    attn = torch.softmax(a, dim=1)
    pooled = torch.sum(feats * attn[..., None], dim=1)
    if dropout is not None:
        pooled = dropout(pooled)
    h = torch.relu(linear(pooled, sd["fc1.weight"], sd["fc1.bias"], quant))
    if dropout is not None:
        h = dropout(h)
    return linear(h, sd["fc2.weight"], sd["fc2.bias"], quant)

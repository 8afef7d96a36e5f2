"""MTCNN face detector (the P/R/O-Net cascade) as ``nn.Module``s.

Counterpart of ``deepfake_video_detection_tpu/models/mtcnn.py``, the
fixed-buffer redesign of ``facenet_pytorch.MTCNN`` (the reference's face
detector). Every stage keeps a buffer of fixed size: P-Net's proposals are
the top ``max_proposals`` by score, NMS is the greedy scan over a K-slot
buffer in score order, and R-Net and O-Net run on the top ``max_refined``
and ``max_faces`` survivors, so a batch of frames goes through the whole
cascade at once with no per-frame shapes.

The modules use facenet-pytorch's layout and names (``conv1``, ``prelu1``,
``dense5_1`` …, ceil-mode max pooling, the ``permute(0, 3, 2, 1)`` flatten
before the dense layers), so a facenet ``state_dict`` loads with
``load_state_dict(strict=True)``: :func:`import_facenet_weights` for a
facenet file, ``checkpoint/bridge.py::state_dict_from_jax`` for the JAX
package's params (HWIO convs). The pyramid and the square crops resample with
``jax.image.scale_and_translate``'s antialiased linear weights
(``data/augment.py::resample_weights``), since ``F.interpolate`` computes
another function. Convolutions stay cuDNN and the products cuBLAS: no
kernel of the JAX package runs here (it computes all of this in XLA).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from deepfake_video_detection_tpu_torch.data.augment import resample_weights
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.utils.device import resolve_device

NETS = ("pnet", "rnet", "onet")


def _conv(cin: int, cout: int, k: int, g: torch.Generator, dev) -> nn.Conv2d:
    conv = torch.nn.utils.skip_init(nn.Conv2d, cin, cout, k, device=dev, dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(I.kaiming_uniform((cout, cin, k, k), g))
        conv.bias.copy_(I.uniform_bias((cout,), cin * k * k, g))
    return conv


def _prelu(ch: int, dev) -> nn.PReLU:
    return nn.PReLU(ch, init=0.25, device=dev, dtype=torch.float32)


def _pool(k: int, s: int) -> nn.MaxPool2d:
    return nn.MaxPool2d(k, s, ceil_mode=True)


def _facenet_flatten(x: torch.Tensor) -> torch.Tensor:
    """NCHW → (N, W·H·C): facenet's ``permute(0, 3, 2, 1)`` before ``view``,
    the order its dense weights expect."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Proposal net: a fully convolutional 12 × 12 detector, stride 2."""

    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        g, dev = generator, device
        self.conv1, self.prelu1 = _conv(3, 10, 3, g, dev), _prelu(10, dev)
        self.pool1 = _pool(2, 2)
        self.conv2, self.prelu2 = _conv(10, 16, 3, g, dev), _prelu(16, dev)
        self.conv3, self.prelu3 = _conv(16, 32, 3, g, dev), _prelu(32, dev)
        self.conv4_1 = _conv(32, 2, 1, g, dev)
        self.conv4_2 = _conv(32, 4, 1, g, dev)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x`` (N, 3, H, W) in [-1, 1] → (probs (N, 2, h, w), reg (N, 4, h, w))."""
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        return torch.softmax(self.conv4_1(x), dim=1), self.conv4_2(x)


class RNet(nn.Module):
    """Refine net on 24 × 24 crops."""

    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        g, dev = generator, device
        self.conv1, self.prelu1 = _conv(3, 28, 3, g, dev), _prelu(28, dev)
        self.pool1 = _pool(3, 2)
        self.conv2, self.prelu2 = _conv(28, 48, 3, g, dev), _prelu(48, dev)
        self.pool2 = _pool(3, 2)
        self.conv3, self.prelu3 = _conv(48, 64, 2, g, dev), _prelu(64, dev)
        self.dense4, self.prelu4 = I.default_linear(576, 128, g, dev), _prelu(128, dev)
        self.dense5_1 = I.default_linear(128, 2, g, dev)
        self.dense5_2 = I.default_linear(128, 4, g, dev)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(_facenet_flatten(x)))
        return torch.softmax(self.dense5_1(x), dim=1), self.dense5_2(x)


class ONet(nn.Module):
    """Output net on 48 × 48 crops; also regresses 5 landmarks."""

    def __init__(self, generator: torch.Generator, device=None):
        super().__init__()
        g, dev = generator, device
        self.conv1, self.prelu1 = _conv(3, 32, 3, g, dev), _prelu(32, dev)
        self.pool1 = _pool(3, 2)
        self.conv2, self.prelu2 = _conv(32, 64, 3, g, dev), _prelu(64, dev)
        self.pool2 = _pool(3, 2)
        self.conv3, self.prelu3 = _conv(64, 64, 3, g, dev), _prelu(64, dev)
        self.pool3 = _pool(2, 2)
        self.conv4, self.prelu4 = _conv(64, 128, 2, g, dev), _prelu(128, dev)
        self.dense5, self.prelu5 = I.default_linear(1152, 256, g, dev), _prelu(256, dev)
        self.dense6_1 = I.default_linear(256, 2, g, dev)
        self.dense6_2 = I.default_linear(256, 4, g, dev)
        self.dense6_3 = I.default_linear(256, 10, g, dev)

    def forward(self, x: torch.Tensor):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.pool3(self.prelu3(self.conv3(x)))
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.dense5(_facenet_flatten(x)))
        return (torch.softmax(self.dense6_1(x), dim=1), self.dense6_2(x),
                self.dense6_3(x))


# ---------------------------------------------------------------------------
# greedy NMS over a fixed K-slot buffer, batched over frames
# ---------------------------------------------------------------------------


def masked_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy NMS over a fixed buffer: ``boxes`` (..., K, 4) xyxy, ``scores``
    and ``valid`` (..., K); returns the kept mask (..., K). The leading axes
    (frames) run together.

    The greedy order is a stable descending sort of ``where(valid, scores,
    -inf)``, as the JAX package's ``jnp.argsort``, so ties keep the lower
    slot first; then one pass over the K sorted slots, each kept when valid
    and not above ``iou_threshold`` with a slot kept before it."""
    lead, K = boxes.shape[:-2], boxes.shape[-2]
    b = boxes.reshape(-1, K, 4)
    v = valid.reshape(-1, K)
    s = torch.where(v, scores.reshape(-1, K), torch.full_like(b[..., 0], -torch.inf))
    order = torch.argsort(-s, dim=-1, stable=True)
    b = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(v, 1, order)
    x1, y1, x2, y2 = b.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    iw = torch.clamp(torch.minimum(x2[:, :, None], x2[:, None, :])
                     - torch.maximum(x1[:, :, None], x1[:, None, :]), min=0)
    ih = torch.clamp(torch.minimum(y2[:, :, None], y2[:, None, :])
                     - torch.maximum(y1[:, :, None], y1[:, None, :]), min=0)
    inter = iw * ih
    union = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                      torch.zeros_like(inter))
    over = iou > iou_threshold                                     # (F, K, K)
    keep = torch.zeros_like(v)
    for i in range(K):   # slots after i are not kept yet, so only earlier ones suppress
        keep[:, i] = v[:, i] & ~(keep & over[:, i]).any(dim=-1)
    out = torch.zeros_like(keep).scatter_(1, order, keep)
    return out.reshape(*lead, K)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: descending, ties to the lower index."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def _take_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))


def _apply_reg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([boxes[..., 0] + reg[..., 0] * w, boxes[..., 1] + reg[..., 1] * h,
                        boxes[..., 2] + reg[..., 2] * w, boxes[..., 3] + reg[..., 3] * h],
                       dim=-1)


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------


class MTCNN(nn.Module):
    """The cascade over a batch of frames of one size, static shapes
    throughout. :meth:`detect` takes (N, H, W, 3) uint8 frames and returns
    (boxes (N, max_faces, 4) xyxy, scores (N, max_faces), valid
    (N, max_faces)): the JAX package's ``jax.vmap(det.detect)``, one batch.
    Weights from a generator seeded 0 unless ``generator`` is given; load
    real ones with ``load_state_dict``."""

    def __init__(self, image_size: Tuple[int, int], min_face_size: int = 20,
                 thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7),
                 factor: float = 0.709, max_proposals: int = 256,
                 max_refined: int = 64, max_faces: int = 16, device: Any = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator or torch.Generator().manual_seed(0)
        self.image_size = tuple(image_size)
        self.thresholds = thresholds
        self.max_proposals = max_proposals
        self.max_refined = max_refined
        self.max_faces = max_faces
        self.pnet, self.rnet, self.onet = PNet(g, dev), RNet(g, dev), ONet(g, dev)
        H, W = self.image_size
        m = 12.0 / min_face_size
        min_side = min(H, W) * m
        scales: List[float] = []
        while min_side >= 12:
            scales.append(m)
            m *= factor
            min_side *= factor
        self.scales = scales

    @property
    def device(self) -> torch.device:
        return self.pnet.conv1.weight.device

    # -- stage helpers --------------------------------------------------------

    def pyramid_level(self, img: torch.Tensor, scale: float) -> torch.Tensor:
        """``img`` (N, 3, H, W) f32 resized to the ``scale`` level, as
        ``jax.image.resize(img, (sh, sw, 3), "linear")`` (antialiased)."""
        N, C, H, W = img.shape
        sh, sw = max(12, int(H * scale)), max(12, int(W * scale))
        x = img
        if sw != W:
            wx = resample_weights(W, sw, torch.tensor([sw / W], device=img.device),
                                  torch.zeros(1, device=img.device), True)[0]
            x = torch.matmul(x, wx)                                    # (N, C, H, sw)
        if sh != H:
            wy = resample_weights(H, sh, torch.tensor([sh / H], device=img.device),
                                  torch.zeros(1, device=img.device), True)[0]
            x = torch.matmul(wy.t(), x)                                # (N, C, sh, sw)
        return x

    def _pnet_proposals(self, img: torch.Tensor):
        all_boxes, all_scores = [], []
        for scale in self.scales:
            probs, reg = self.pnet(self.pyramid_level(img, scale))
            score = probs[:, 1]                                        # (N, h, w)
            h, w = score.shape[1:]
            ys, xs = torch.meshgrid(torch.arange(h, device=img.device, dtype=torch.float32),
                                    torch.arange(w, device=img.device, dtype=torch.float32),
                                    indexing="ij")
            x1, y1 = (xs * 2.0 + 1) / scale, (ys * 2.0 + 1) / scale
            x2, y2 = (xs * 2.0 + 12.0) / scale, (ys * 2.0 + 12.0) / scale
            bw, bh = x2 - x1, y2 - y1
            boxes = torch.stack([x1 + reg[:, 0] * bw, y1 + reg[:, 1] * bh,
                                 x2 + reg[:, 2] * bw, y2 + reg[:, 3] * bh], dim=-1)
            all_boxes.append(boxes.reshape(img.shape[0], -1, 4))
            all_scores.append(score.reshape(img.shape[0], -1))
        boxes, scores = torch.cat(all_boxes, 1), torch.cat(all_scores, 1)
        valid = scores > self.thresholds[0]
        k = min(self.max_proposals, scores.shape[1])
        top_scores, idx = _top_k(torch.where(valid, scores, -torch.inf), k)
        top_boxes = _take_boxes(boxes, idx)
        top_valid = top_scores > self.thresholds[0]
        keep = masked_nms(top_boxes, top_scores, top_valid, 0.7)
        return top_boxes, torch.where(keep, top_scores, -torch.inf), keep

    def crop_batch(self, img: torch.Tensor, boxes: torch.Tensor, size: int):
        """Square crops of ``boxes`` (N, K, 4) from ``img`` (N, 3, H, W), each
        resized to (size, size) as ``jax.image.scale_and_translate`` with
        the box's scale (antialiased linear): (N·K, 3, size, size), and the
        squared boxes (N, K, 4)."""
        N, C, H, W = img.shape
        K = boxes.shape[1]
        side = torch.maximum(boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1])
        x1 = (boxes[..., 0] + boxes[..., 2]) / 2 - side / 2
        y1 = (boxes[..., 1] + boxes[..., 3]) / 2 - side / 2
        scale = (size / torch.clamp(side, min=1.0)).reshape(-1)
        wy = resample_weights(H, size, scale, -y1.reshape(-1) * scale, True)   # (N·K, H, s)
        wx = resample_weights(W, size, scale, -x1.reshape(-1) * scale, True)   # (N·K, W, s)
        # columns first, all of a frame's boxes in one product: (N, C·H, K·s)
        wx = wx.reshape(N, K, W, size).permute(0, 2, 1, 3).reshape(N, W, K * size)
        cols = torch.matmul(img.reshape(N, C * H, W), wx)
        cols = cols.reshape(N, C, H, K, size).permute(0, 3, 2, 1, 4).reshape(N * K, H, C * size)
        crops = torch.matmul(wy.transpose(1, 2), cols)                          # (N·K, s, C·s)
        crops = crops.reshape(N * K, size, C, size).permute(0, 2, 1, 3)
        sq = torch.stack([x1, y1, x1 + side, y1 + side], dim=-1)
        return crops, sq

    # -- the cascade ----------------------------------------------------------

    @torch.inference_mode()
    def detect(self, frames: Any):
        """(N, H, W, 3) uint8 frames (numpy or tensor) → (boxes (N, F, 4),
        scores (N, F), valid (N, F)) on the detector's device, F =
        ``max_faces``; invalid slots score 0."""
        x = frames if torch.is_tensor(frames) else torch.from_numpy(np.ascontiguousarray(frames))
        x = x.to(self.device)
        N = x.shape[0]
        img = (x.permute(0, 3, 1, 2).to(torch.float32) - 127.5) / 128.0

        boxes, scores, valid = self._pnet_proposals(img)
        # stage 2: R-Net on the top max_refined survivors
        k2 = min(self.max_refined, boxes.shape[1])
        s2, idx2 = _top_k(torch.where(valid, scores, -torch.inf), k2)
        crops, sq2 = self.crop_batch(img, _take_boxes(boxes, idx2), 24)
        probs, reg = self.rnet(crops)
        rs = probs[:, 1].reshape(N, k2)
        rvalid = (rs > self.thresholds[1]) & torch.isfinite(s2)
        rb = _apply_reg(sq2, reg.reshape(N, k2, 4))
        keep = masked_nms(rb, rs, rvalid, 0.7)

        # stage 3: O-Net on the top max_faces survivors
        k3 = min(self.max_faces, k2)
        s3, idx3 = _top_k(torch.where(keep, rs, -torch.inf), k3)
        crops3, sq3 = self.crop_batch(img, _take_boxes(rb, idx3), 48)
        probs3, reg3, _ = self.onet(crops3)
        os_ = probs3[:, 1].reshape(N, k3)
        ovalid = (os_ > self.thresholds[2]) & torch.isfinite(s3)
        ob = _apply_reg(sq3, reg3.reshape(N, k3, 4))
        okeep = masked_nms(ob, os_, ovalid, 0.7)
        return ob, torch.where(okeep, os_, torch.zeros_like(os_)), okeep


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def import_facenet_weights(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A facenet-pytorch MTCNN ``state_dict`` (keys ``pnet.conv1.weight`` …,
    tensors or arrays) → the port's ``state_dict``: the facenet layout is
    the port's, so this keeps the three nets' keys as f32 tensors."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            for k, v in sd.items() if k.split(".")[0] in NETS}

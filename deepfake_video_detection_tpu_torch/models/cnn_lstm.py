"""CNN+LSTM temporal classifier as an ``nn.Module``.

Counterpart of ``deepfake_video_detection_tpu/models/cnn_lstm.py``: a
4-block scratch CNN over the flattened ``B·T`` frames (conv → batch norm →
ReLU → max pool, NHWC, channels-last on the card), a 2-layer LSTM
(``nn.layers.lstm``, f32), additive attention over time and an MLP head.
Parameter names follow the reference's ``nn.Sequential`` indices:
``cnn.0`` … ``cnn.13`` (batch norm's running stats are buffers, which
``checkpoint.bridge.save_checkpoint`` writes under ``state.``),
``lstm.weight_ih_l0`` …, ``attention.0``/``.2``, ``classifier.0``/``.3``.

Batch norm uses the batch's statistics in training and updates its running
stats in place, once a forward; dropout draws only when ``train`` and a
generator is given, as in the JAX model with an rng.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepfake_video_detection_tpu_torch.models.efficientnet import BatchNorm
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device

# (conv index, bn index, in_ch, out_ch, kernel, stride, pad, pool_after)
_CNN_SPEC = [
    ("0", "1", 3, 64, 7, 2, 3, True),
    ("4", "5", 64, 128, 5, 1, 2, True),
    ("8", "9", 128, 256, 3, 1, 1, True),
    ("12", "13", 256, 512, 3, 1, 1, False),
]


class LSTM(nn.Module):
    """The parameters of ``torch.nn.LSTM`` under its names
    (``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
    ``bias_hh_l{k}``), initialised as torch does (U(±1/sqrt(H)));
    the recurrence is ``nn.layers.lstm``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 generator: torch.Generator, device):
        super().__init__()
        H = hidden_size
        self.num_layers = num_layers
        for k in range(num_layers):
            in_dim = input_size if k == 0 else H
            for name, shape in (("weight_ih", (4 * H, in_dim)), ("weight_hh", (4 * H, H)),
                                ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
                t = I.uniform_bias(shape, H, generator)
                self.register_parameter(f"{name}_l{k}",
                                        nn.Parameter(t.to(device=device)))

    def layers(self):
        return [tuple(getattr(self, f"{n}_l{k}")
                      for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
                for k in range(self.num_layers)]


class CNNLSTMHybrid(nn.Module):
    def __init__(self, input_channels: int = 3, hidden_size: int = 256,
                 num_layers: int = 2, num_classes: int = 2, dropout: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_classes = num_classes
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.cnn_out_features = 512
        cnn = {}
        for ci, bi, cin, cout, k, _, _, _ in _CNN_SPEC:
            conv = torch.nn.utils.skip_init(nn.Conv2d, cin, cout, k, device=dev,
                                            dtype=torch.float32)
            with torch.no_grad():
                conv.weight.copy_(I.kaiming_uniform((cout, cin, k, k), g))
                conv.bias.copy_(I.uniform_bias((cout,), cin * k * k, g))
            cnn[ci], cnn[bi] = conv, BatchNorm(cout, dev)
        self.cnn = nn.ModuleDict(cnn)
        H = hidden_size
        self.lstm = LSTM(self.cnn_out_features, H, num_layers, g, dev)
        self.attention = nn.ModuleDict({"0": I.default_linear(H, H, g, dev),
                                        "2": I.default_linear(H, 1, g, dev)})
        self.classifier = nn.ModuleDict({"0": I.default_linear(H, 128, g, dev),
                                         "3": I.default_linear(128, num_classes, g, dev)})

    def features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The CNN over frames ``x`` (N, H, W, C): (N, 512) pooled features."""
        for ci, bi, _, _, _, stride, pad, pool in _CNN_SPEC:
            conv = self.cnn[ci]
            x = L.conv2d(x, conv.weight, conv.bias, stride=stride, padding=pad)
            x = torch.relu(self.cnn[bi](x, train))
            if pool:
                x = L.max_pool2d(x, 3, 2, 1)
        return L.global_avg_pool(x)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: (B, T, H, W, C). Returns logits (B, num_classes), f32."""
        B, T = x.shape[0], x.shape[1]
        x = x.to(self.compute_dtype)
        feats = self.features(x.reshape((B * T,) + tuple(x.shape[2:])), train)
        feats = feats.reshape(B, T, self.cnn_out_features).to(torch.float32)
        rate = self.dropout if self.num_layers > 1 else 0.0
        seq, _ = L.lstm(feats, self.lstm.layers(), rate, train, generator)
        a0, a2 = self.attention["0"], self.attention["2"]
        a = L.linear(torch.tanh(L.linear(seq, a0.weight, a0.bias)), a2.weight, a2.bias)
        context = torch.sum(torch.softmax(a, dim=1) * seq, dim=1)        # (B, H)
        c0, c3 = self.classifier["0"], self.classifier["3"]
        h = torch.relu(L.linear(context, c0.weight, c0.bias))
        h = L.dropout(h, self.dropout, train and generator is not None, generator)
        return L.linear(h, c3.weight, c3.bias).to(torch.float32)

"""Logic-gated LSTM ("Logic RNN") as an ``nn.Module``.

Counterpart of ``deepfake_video_detection_tpu/models/logic_rnn.py``: an
LSTM cell mixed with AND/OR/NOT gates, stacked ``num_layers`` deep, with
the reference's carry: one ``(h, c)`` threads through the layer stack
within a step and the stack's last values carry to the next step; then
additive attention over time and a sigmoid head. Parameter names are the
JAX tree's: ``logic_cells.{i}.{and,or,not,forget,input,cell,output}_gate``,
``attention.0``/``.2``, ``classifier.0``/``.3``. Time runs as a Python loop
of small products (the JAX package's ``lax.scan``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device

_GATES = ("and_gate", "or_gate", "not_gate", "forget_gate",
          "input_gate", "cell_gate", "output_gate")


def _lin(cell: nn.ModuleDict, gate: str, x: torch.Tensor) -> torch.Tensor:
    return L.linear(x, cell[gate].weight, cell[gate].bias)


def _logic_cell(cell: nn.ModuleDict, x: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor):
    comb = torch.cat([x, h], dim=-1)
    and_out = torch.sigmoid(_lin(cell, "and_gate", comb))
    or_out = torch.sigmoid(_lin(cell, "or_gate", comb))
    not_out = torch.tanh(_lin(cell, "not_gate", h))
    forget = torch.sigmoid(_lin(cell, "forget_gate", comb))
    input_g = torch.sigmoid(_lin(cell, "input_gate", comb))
    cell_tilde = torch.tanh(_lin(cell, "cell_gate", comb))
    c_new = forget * c + input_g * cell_tilde
    c_logic = and_out * c_new + or_out * not_out
    out = torch.sigmoid(_lin(cell, "output_gate", comb))
    return out * torch.tanh(c_logic), c_logic


class LogicRNNLSTM(nn.Module):
    def __init__(self, input_size: int = 1024, hidden_size: int = 512,
                 num_layers: int = 2, dropout: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.input_size = input_size
        self.hidden_size = H = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.logic_cells = nn.ModuleList(
            nn.ModuleDict({gate: I.default_linear(
                H if gate == "not_gate" else (input_size if i == 0 else H) + H, H, g, dev)
                for gate in _GATES})
            for i in range(num_layers))
        self.attention = nn.ModuleDict({"0": I.default_linear(H, H, g, dev),
                                        "2": I.default_linear(H, 1, g, dev)})
        self.classifier = nn.ModuleDict({"0": I.default_linear(H, H, g, dev),
                                         "3": I.default_linear(H, 1, g, dev)})

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``x``: (B, T, input_size) face embeddings. Returns sigmoid
        probabilities (B, 1), f32."""
        B, T, _ = x.shape
        h = torch.zeros((B, self.hidden_size), dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        outputs = []
        for t in range(T):
            for i, cell in enumerate(self.logic_cells):
                h, c = _logic_cell(cell, x[:, t] if i == 0 else h, h, c)
            outputs.append(h)
        outputs = torch.stack(outputs, dim=1)                       # (B, T, H)
        if lengths is not None:
            mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
            outputs = outputs * mask.to(outputs.dtype)[..., None]
        a0, a2 = self.attention["0"], self.attention["2"]
        a = L.linear(torch.tanh(L.linear(outputs, a0.weight, a0.bias)), a2.weight, a2.bias)
        context = torch.sum(torch.softmax(a, dim=1) * outputs, dim=1)
        c0, c3 = self.classifier["0"], self.classifier["3"]
        h = torch.relu(L.linear(context, c0.weight, c0.bias))
        h = L.dropout(h, self.dropout, train and generator is not None, generator)
        return torch.sigmoid(L.linear(h, c3.weight, c3.bias).to(torch.float32))


def create_model(config: Optional[Dict[str, Any]] = None, device=None) -> LogicRNNLSTM:
    """Factory mirroring the reference's ``create_model``."""
    config = config or {}
    return LogicRNNLSTM(input_size=config.get("input_size", 1024),
                        hidden_size=config.get("hidden_size", 512),
                        num_layers=config.get("num_layers", 2),
                        dropout=config.get("dropout", 0.5), device=device)

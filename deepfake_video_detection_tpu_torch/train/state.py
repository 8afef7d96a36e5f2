"""Train state: the model (its parameters live in it), the optimizer state
and the step counter.

Counterpart of ``deepfake_video_detection_tpu/train/state.py``. The JAX
state is an immutable pytree of params, model state, optimizer state and
step; here the parameters are the model's own tensors, updated in place,
and the model state (batch norm's running stats) is the model's buffers,
updated in place by its training forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from deepfake_video_detection_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    opt_state: Dict[str, Any]
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Optimizer) -> "TrainState":
        return cls(model=model, opt_state=tx.init(dict(model.named_parameters())))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

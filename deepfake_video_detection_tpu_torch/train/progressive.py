"""Progressive fine-tuning schedule.

Counterpart of ``deepfake_video_detection_tpu/train/progressive.py``. Three
stages: head-only at lr 1e-3, then the last 2 backbone blocks at lr 1e-4,
then the whole network at lr 1e-5. Freezing is the optimizer's mask from
``BackboneDetector.trainable_mask``: no ``requires_grad`` flag changes, a
frozen parameter simply gets no update (no Adam step and no weight decay)
and is left out of the gradient clip's norm. Batch norm's running stats
are buffers, not parameters, so a frozen stage's training forward still
moves them, as the JAX model state moves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

from deepfake_video_detection_tpu_torch.train.optim import Optimizer, build_optimizer


@dataclass(frozen=True)
class StageConfig:
    name: str
    lr: float
    freeze_backbone: bool
    unfreeze_blocks: int   # -1 = all


_STAGES: List[StageConfig] = [
    StageConfig("head_only", 1e-3, True, 0),
    StageConfig("partial_unfreeze", 1e-4, True, 2),
    StageConfig("full_finetune", 1e-5, False, -1),
]


class ProgressiveFineTuner:
    def __init__(self, model: Any, epochs_per_stage: int = 5):
        self.model = model
        self.epochs_per_stage = epochs_per_stage
        self.stage_idx = 0

    @property
    def current_stage(self) -> StageConfig:
        return _STAGES[min(self.stage_idx, len(_STAGES) - 1)]

    def get_stage_config(self) -> Dict[str, Any]:
        s = self.current_stage
        return {"stage": self.stage_idx, "name": s.name, "lr": s.lr,
                "freeze_backbone": s.freeze_backbone,
                "unfreeze_blocks": s.unfreeze_blocks,
                "epochs": self.epochs_per_stage}

    def advance_stage(self) -> bool:
        """Move to the next stage; returns False once past the last."""
        if self.stage_idx >= len(_STAGES) - 1:
            return False
        self.stage_idx += 1
        return True

    def trainable_mask(self) -> Dict[str, bool]:
        s = self.current_stage
        return self.model.trainable_mask(freeze_backbone=s.freeze_backbone,
                                         unfreeze_blocks=s.unfreeze_blocks)

    def make_optimizer(self, weight_decay: float = 1e-4,
                       grad_clip: float = 1.0) -> Optimizer:
        """A fresh AdamW at the stage's lr under the stage's mask."""
        return build_optimizer("adamw", self.current_stage.lr, weight_decay, grad_clip,
                               trainable_mask=self.trainable_mask())

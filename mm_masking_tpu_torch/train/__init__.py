from mm_masking_tpu_torch.train.checkpoint import latest_epoch, load_checkpoint, save_checkpoint
from mm_masking_tpu_torch.train.loss import (
    LossComponents,
    bce,
    eval_training_loss,
    eval_validation_loss,
    pose_errors,
)
from mm_masking_tpu_torch.train.metrics import MetricsLogger
from mm_masking_tpu_torch.train.optim import Optimizer, make_optimizer
from mm_masking_tpu_torch.train.trainer import Trainer, TrainState

__all__ = [
    "LossComponents",
    "MetricsLogger",
    "Optimizer",
    "TrainState",
    "Trainer",
    "bce",
    "eval_training_loss",
    "eval_validation_loss",
    "latest_epoch",
    "load_checkpoint",
    "make_optimizer",
    "pose_errors",
    "save_checkpoint",
]

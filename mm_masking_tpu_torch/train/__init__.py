from mm_masking_tpu_torch.train.loss import eval_validation_loss, pose_errors
from mm_masking_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer", "eval_validation_loss", "pose_errors"]

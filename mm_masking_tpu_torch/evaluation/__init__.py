from mm_masking_tpu_torch.evaluation.localization import (
    SequenceErrors,
    frame_errors,
    summarize,
    make_constant_weight_localizer,
    make_masked_localizer,
    evaluate_sequence,
    evaluate_policy_on_sequences,
)
from mm_masking_tpu_torch.evaluation import baselines

__all__ = [
    "SequenceErrors",
    "frame_errors",
    "summarize",
    "make_constant_weight_localizer",
    "make_masked_localizer",
    "evaluate_sequence",
    "evaluate_policy_on_sequences",
    "baselines",
]

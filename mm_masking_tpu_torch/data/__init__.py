from mm_masking_tpu_torch.data.synthetic import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.data.dataset import ICPWeightDataset
from mm_masking_tpu_torch.data.loader import epoch_batches, preprocess_batch

__all__ = [
    "SyntheticSpec",
    "synthetic_batch",
    "ICPWeightDataset",
    "epoch_batches",
    "preprocess_batch",
]

from mm_masking_tpu_torch.data.synthetic import SyntheticSpec, synthetic_batch

__all__ = ["SyntheticSpec", "synthetic_batch"]

from mm_masking_tpu_torch.dicp.icp import (
    TARGET_PAD_VAL,
    ICPConfig,
    icp,
    icp_implicit,
    robust_weight,
)

__all__ = ["ICPConfig", "TARGET_PAD_VAL", "icp", "icp_implicit", "robust_weight"]

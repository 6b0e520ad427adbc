from mm_masking_tpu_torch.dicp.icp import (
    ICP,
    TARGET_PAD_VAL,
    ICPConfig,
    icp,
    icp_implicit,
    robust_weight,
)

__all__ = ["ICP", "ICPConfig", "TARGET_PAD_VAL", "icp", "icp_implicit", "robust_weight"]

from mm_masking_tpu_torch.dicp.icp import (
    ICP,
    TARGET_PAD_VAL,
    ICPConfig,
    icp,
    icp_implicit,
    robust_weight,
)
from mm_masking_tpu_torch.dicp.ct_icp import CTICPConfig, ct_icp

__all__ = ["ICP", "ICPConfig", "TARGET_PAD_VAL", "icp", "icp_implicit", "robust_weight",
           "CTICPConfig", "ct_icp"]

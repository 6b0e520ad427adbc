"""Deployment artifacts: the mask-inference and registration programs,
serialised with ``torch.export`` (counterpart of ``mm_masking_tpu.deploy``)."""
from mm_masking_tpu_torch.deploy.export import (
    export_from_run_dir,
    export_localizer,
    export_mask_policy,
    load_localizer,
    load_mask_policy,
    read_artifact,
    write_artifact,
)

__all__ = [
    "export_from_run_dir",
    "export_localizer",
    "export_mask_policy",
    "load_localizer",
    "load_mask_policy",
    "read_artifact",
    "write_artifact",
]

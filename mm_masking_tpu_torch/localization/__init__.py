from mm_masking_tpu_torch.localization.datagen import DatagenConfig, generate_pair
from mm_masking_tpu_torch.localization.odometry import OdometryConfig, TeachPass
from mm_masking_tpu_torch.localization.pipeline import (
    LocalizationConfig,
    localize_cloud_sequence,
    localize_clouds,
    localize_frame,
    localize_sequence,
    localize_sequence_to_traj,
    localize_sequence_tracked,
    project_map,
)

__all__ = [
    "DatagenConfig",
    "LocalizationConfig",
    "OdometryConfig",
    "TeachPass",
    "generate_pair",
    "localize_cloud_sequence",
    "localize_clouds",
    "localize_frame",
    "localize_sequence",
    "localize_sequence_to_traj",
    "localize_sequence_tracked",
    "project_map",
]

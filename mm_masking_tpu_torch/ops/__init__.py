from mm_masking_tpu_torch.ops.cfar import (
    cfar_mask,
    extract_pc,
    hardshrink,
    mean_peaks,
    pol_2_cart_batched,
)
from mm_masking_tpu_torch.ops.descriptors import (
    basd_descriptors,
    match_descriptors,
    orb_descriptors,
)
from mm_masking_tpu_torch.ops.detectors import DETECTORS, detect, doppler_shift, motion_undistort
from mm_masking_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_points
from mm_masking_tpu_torch.ops.preprocessing import estimate_normals, knn_indices, voxel_downsample
from mm_masking_tpu_torch.ops.radar import (
    CART_PIXEL_WIDTH,
    CART_RESOLUTION,
    ENCODER_TICKS,
    POLAR_RESOLUTION,
    POLAR_SHAPE,
    form_cart_range_angle_grid,
    form_polar_range_grid,
    load_radar,
    point_to_cart_idx,
    pol_2_cart,
    polar_mask_to_cartesian,
    radar_cartesian_to_polar,
    radar_polar_to_cartesian,
)
from mm_masking_tpu_torch.ops.weights import WeightStats, extract_bev_from_pts, extract_weights

__all__ = [
    "basd_descriptors",
    "match_descriptors",
    "orb_descriptors",
    "CART_PIXEL_WIDTH",
    "DETECTORS",
    "CART_RESOLUTION",
    "ENCODER_TICKS",
    "POLAR_RESOLUTION",
    "POLAR_SHAPE",
    "WeightStats",
    "cfar_mask",
    "detect",
    "doppler_shift",
    "estimate_normals",
    "extract_bev_from_pts",
    "extract_pc",
    "extract_weights",
    "form_cart_range_angle_grid",
    "form_polar_range_grid",
    "grid_sample_2d",
    "grid_sample_points",
    "hardshrink",
    "knn_indices",
    "load_radar",
    "mean_peaks",
    "motion_undistort",
    "pol_2_cart_batched",
    "point_to_cart_idx",
    "pol_2_cart",
    "polar_mask_to_cartesian",
    "radar_cartesian_to_polar",
    "radar_polar_to_cartesian",
    "voxel_downsample",
]

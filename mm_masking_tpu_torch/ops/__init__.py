from mm_masking_tpu_torch.ops.cfar import cfar_mask
from mm_masking_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_points
from mm_masking_tpu_torch.ops.radar import (
    CART_PIXEL_WIDTH,
    CART_RESOLUTION,
    POLAR_RESOLUTION,
    POLAR_SHAPE,
    form_cart_range_angle_grid,
    point_to_cart_idx,
    radar_polar_to_cartesian,
)
from mm_masking_tpu_torch.ops.weights import WeightStats, extract_bev_from_pts, extract_weights

__all__ = [
    "CART_PIXEL_WIDTH",
    "CART_RESOLUTION",
    "POLAR_RESOLUTION",
    "POLAR_SHAPE",
    "WeightStats",
    "cfar_mask",
    "extract_bev_from_pts",
    "extract_weights",
    "form_cart_range_angle_grid",
    "grid_sample_2d",
    "grid_sample_points",
    "point_to_cart_idx",
    "radar_polar_to_cartesian",
]

from mm_masking_tpu_torch.geom.se3 import (
    hat3,
    planar_xi_first_order,
    se3_exp,
    se3_inv,
    so3_exp,
    so3_left_jacobian,
    transform_points,
    yaw_to_se3,
)

__all__ = [
    "hat3",
    "planar_xi_first_order",
    "se3_exp",
    "se3_inv",
    "so3_exp",
    "so3_left_jacobian",
    "transform_points",
    "yaw_to_se3",
]

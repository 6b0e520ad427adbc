"""Typed configuration, the same dataclass tree as ``mm_masking_tpu.config``.

Field names and defaults are identical so that a run's ``config.json``
(``dataclasses.asdict`` of the JAX ``Config``) loads through
:meth:`Config.from_dict`. ``conv_impl``, ``s2d_convs`` and ``remat`` select
TPU lowerings of one function in the JAX package; the port keeps them only
so that configs load, and ignores them.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class LossWeights:
    icp_rot: float = 1.0
    icp_trans: float = 1.0
    fft: float = 0.0
    mask_pts: float = 1.0
    cfar: float = 0.0
    num_pts: float = 0.0
    num_pts_floor: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    icp_type: str = "pt2pt"  # "pt2pt" | "pt2pl"
    fft_input: bool = True
    cfar_input: bool = False
    range_input: bool = False
    network_input_type: str = "cartesian"  # "cartesian" | "polar"
    network_output_type: str = "cartesian"
    leaky: bool = False
    dropout: float = 0.05
    batch_norm: bool = False
    init_weights: bool = True  # Xavier-uniform convs, zero bias
    log_transform: bool = False
    normalize: str = "minmax"  # "minmax" | "standardize" | "none"
    norm_weights: bool = True  # scale mask by per-image max
    binary_inference: bool = False
    a_thresh: float = 1.0
    b_thresh: float = 0.09
    max_iter: int = 10  # differentiable ICP iterations (training)
    inference_max_iter: int = 50
    nn_refresh_dist: float = 0.0
    icp_diff_mode: str = "unroll"
    gt_eye: bool = True
    res: float = 0.0596  # polar range resolution (m/bin)
    cart_resolution: float = 0.2384
    cart_pixel_width: int = 640
    polar_shape: tuple[int, int] = (400, 3360)
    enc_channels: tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    dtype: str = "float32"  # activations dtype ("bfloat16" allowed)
    s2d_convs: bool = False  # TPU lowering; ignored by the port
    conv_impl: str = "xla"  # TPU lowering; ignored by the port
    remat: bool = False  # TPU memory knob; ignored by the port
    icp_remat: bool = False
    icp_max_step_m: float = 0.0
    icp_overrides: tuple = ()

    @property
    def in_channels(self) -> int:
        return int(self.fft_input) + int(self.cfar_input) + int(self.range_input)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    map_sensor: str = "lidar"
    loc_sensor: str = "radar"
    num_train: int = -1
    num_val: int = -1
    augment: bool = True
    random: bool = False
    use_gt: bool = False
    pos_std: float = 2.0
    rot_std: float = 0.6
    gt_eye: bool = True
    float_type: str = "float32"
    max_loc_pts: int = 4096
    max_map_pts: int = 16384
    elevation_threshold: float = 0.05
    z_normal_threshold: float = 0.9
    data_dir: str = "data"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size_train: int = 16
    batch_size_test: int = 32
    shuffle: bool = True
    num_epochs: int = 30
    learning_rate: float = 1e-4
    optimizer: str = "adam"
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0
    lr_warmup_steps: int = 0
    clip_value: float = 0.0
    icp_loss_only_iter: int = -1
    seed: int = 99
    checkpoint_dir: str = "results/checkpoints"
    checkpoint_every: int = 1
    num_devices: int = -1
    mesh_axis: str = "data"


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    loss: LossWeights = LossWeights()
    train_loc_pairs: Sequence[tuple[str, str]] = (
        ("boreas-2020-11-26-13-58", "boreas-2020-12-01-13-26"),
        ("boreas-2020-11-26-13-58", "boreas-2020-12-18-13-44"),
        ("boreas-2020-11-26-13-58", "boreas-2021-02-02-14-07"),
        ("boreas-2020-11-26-13-58", "boreas-2021-03-02-13-38"),
        ("boreas-2020-11-26-13-58", "boreas-2021-03-30-14-23"),
        ("boreas-2020-11-26-13-58", "boreas-2021-04-20-14-11"),
        ("boreas-2020-11-26-13-58", "boreas-2021-04-08-12-44"),
        ("boreas-2020-11-26-13-58", "boreas-2021-04-29-15-55"),
        ("boreas-2020-11-26-13-58", "boreas-2021-05-06-13-19"),
        ("boreas-2020-11-26-13-58", "boreas-2021-06-17-17-52"),
        ("boreas-2020-11-26-13-58", "boreas-2021-08-05-13-34"),
        ("boreas-2020-11-26-13-58", "boreas-2021-09-07-09-35"),
    )
    val_loc_pairs: Sequence[tuple[str, str]] = (
        ("boreas-2020-11-26-13-58", "boreas-2021-04-13-14-49"),
    )

    @property
    def use_icp_4_train(self) -> bool:
        return self.loss.icp_rot > 0.0 and self.loss.icp_trans > 0.0

    @staticmethod
    def from_dict(d: dict) -> "Config":
        """Inverse of ``dataclasses.asdict``: rebuild the typed tree from a
        run's ``config.json``."""

        def tup(x):
            return tuple(x) if isinstance(x, list) else x

        model = {k: tup(v) for k, v in d.get("model", {}).items()}
        pairs = lambda ps: tuple(tuple(p) for p in ps)  # noqa: E731
        return Config(
            model=ModelConfig(**model),
            data=DataConfig(**d.get("data", {})),
            train=TrainConfig(**d.get("train", {})),
            loss=LossWeights(**d.get("loss", {})),
            train_loc_pairs=pairs(d.get("train_loc_pairs", ())),
            val_loc_pairs=pairs(d.get("val_loc_pairs", ())),
        )

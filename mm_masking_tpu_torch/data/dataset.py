"""ICPWeightDataset: scan/map pairs + transforms out of converted pose graphs.

Counterpart of ``mm_masking_tpu.data.dataset``: the same items, bit for bit,
from the same tree and seed. Rebuild of `mm_masking/icp_weight_dataset.py` on top of the
ROS-free shard layout produced by :mod:`mm_masking_tpu_torch.data.convert`:

    <root>/vtr_results/<sensor_dir>/<map_seq>/<loc_seq>/shards/frame_<t>.npz
    <root>/vtr_data/<seq>/applanix/<sensor>_poses.csv
    <root>/vtr_data/<seq>/calib/T_applanix_lidar.txt
    <root>/vtr_data/<seq>/radar/<stamp>.png|.npy        (raw Navtech scans)
    <root>/cfar/<loc_seq>/polar/<a>_<b>/<stamp>.npy     (CFAR cache, on demand)

Reference behaviors reproduced: GT pose lookup + timestamp assertions
(`:206-214`), the constant ``T_map_sensor_robot`` calib chain (`:116-124`),
CFAR image caching (`:183-200`), per-sample ``T_init`` perturbations drawn ONCE
at init (train uniform / val gaussian, z-pitch-roll zeroed, seed 99 when not
random — `:250-280`; the draw *sequence* differs from torch's RNG but the
distribution and determinism switch match), map FOV + z-normal filtering in the
loc frame with the gt_eye alignment option (`:402-423`), zero-padding of scan
clouds and target_pad_val padding of map clouds to static shapes (`:377-398`),
and the rotation/roll augmentation (`:425-452` — note the reference
*right*-multiplies clouds by the rotation matrix; reproduced exactly).

All per-item work is host-side numpy (ragged filtering happens before padding);
the device only ever sees static shapes. Polar→cartesian conversion is batched
on device in :mod:`mm_masking_tpu_torch.data.loader` rather than per item in worker
processes, and the polar image planes stay uint8 (their on-disk format) until
the loader normalizes them on device — the host never touches an f32 image.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.data.boreas import (
    get_closest_index,
    get_inverse_tf,
    load_calib,
    read_traj_file_gt2,
)
from mm_masking_tpu_torch.data.convert import se3_exp_np
from mm_masking_tpu_torch.dicp import TARGET_PAD_VAL
from mm_masking_tpu_torch.ops import cfar_mask, load_radar


def _decode_radar_file(path: str):
    """Raw Navtech scan from .npy (pre-decoded) or .png (needs cv2/PIL).

    The FFT plane stays uint8 here (`load_radar(normalize=False)`): the /255
    normalization runs on device in `loader.preprocess_batch`, so the host
    pipeline stacks and ships a quarter of the bytes per batch.
    """
    if path.endswith(".npy"):
        raw = np.load(path)
    else:
        raw = _imread_gray(path)
    return load_radar(raw, normalize=False)


def _imread_gray(path: str) -> np.ndarray:
    from mm_masking_tpu_torch.data import native

    if native.available():
        return native.png_decode_gray8(open(path, "rb").read())
    try:
        import cv2  # type: ignore

        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    except ImportError:
        pass
    try:
        from PIL import Image  # type: ignore

        return np.asarray(Image.open(path).convert("L"))
    except ImportError as e:
        raise RuntimeError(
            "no PNG decoder available (build native/libfastload.so or install "
            "cv2/PIL, or pre-decode radar scans to .npy with the converter)"
        ) from e


class ICPWeightDataset:
    """Indexable dataset mirroring the reference's public surface."""

    def __init__(self, loc_pairs, config: Config, dataset_type: str = "train"):
        d = config.data
        self.config = config
        self.dataset_type = dataset_type
        self.augment = d.augment if dataset_type == "train" else False
        num_samples = d.num_train if dataset_type == "train" else d.num_val
        self.gt_eye = d.gt_eye
        self.target_pad_val = TARGET_PAD_VAL
        self.polar_res = config.model.res

        if not d.random:
            self._rng = np.random.default_rng(99)
        else:
            self._rng = np.random.default_rng()

        if d.map_sensor == "lidar" and d.loc_sensor == "radar":
            sensor_dir = "radar_lidar"
        elif d.map_sensor == "radar" and d.loc_sensor == "radar":
            sensor_dir = "radar"
        elif d.map_sensor == "lidar" and d.loc_sensor == "lidar":
            sensor_dir = "lidar"
        else:
            raise ValueError("Invalid sensor combination")
        self.radar_mode = not (d.map_sensor == "lidar" and d.loc_sensor == "lidar")

        root = d.data_dir
        dataset_dir = osp.join(root, "vtr_data")
        result_dir = osp.join(root, "vtr_results")

        self.entries = []  # (shard_path, radar_path, cfar_path, pair_idx)
        self.T_loc_gt = []
        self.T_loc_init = []
        self.T_map_sensor_robot = []
        self.max_loc_pts = 0
        self.max_map_pts = 0

        for pair_idx, (map_seq, loc_seq) in enumerate(loc_pairs):
            gt_map_poses, gt_map_times = read_traj_file_gt2(
                osp.join(dataset_dir, map_seq, "applanix",
                         d.map_sensor + "_poses.csv"), dim=2,
            )
            gt_loc_poses, gt_loc_times = read_traj_file_gt2(
                osp.join(dataset_dir, loc_seq, "applanix",
                         d.loc_sensor + "_poses.csv"), dim=2,
            )
            shard_dir = osp.join(result_dir, sensor_dir, map_seq, loc_seq, "shards")
            index = json.load(open(osp.join(shard_dir, "index.json")))
            self.max_loc_pts = max(self.max_loc_pts, index["max_loc"])
            self.max_map_pts = max(self.max_map_pts, index["max_map"])
            self.T_map_sensor_robot.append(
                load_calib(osp.join(dataset_dir, map_seq), d.map_sensor)
            )

            cfar_dir = osp.join(
                root, "cfar", loc_seq, "polar",
                f"{config.model.a_thresh}_{config.model.b_thresh}",
            )
            os.makedirs(cfar_dir, exist_ok=True)

            for frame_name in index["frames"]:
                shard_path = osp.join(shard_dir, frame_name)
                loc_stamp = int(frame_name.split("_")[1].split(".")[0])

                radar_path = None
                cfar_path = None
                if self.radar_mode:
                    for ext in (".npy", ".png"):
                        cand = osp.join(dataset_dir, loc_seq, "radar",
                                        str(loc_stamp) + ext)
                        if osp.exists(cand):
                            radar_path = cand
                            break
                    if radar_path is None:
                        continue
                    cfar_path = osp.join(cfar_dir, str(loc_stamp) + ".npy")

                # Timestamp ↔ GT matching (reference asserts equality).
                loc_t = get_closest_index(loc_stamp, gt_loc_times)
                assert gt_loc_times[loc_t] == loc_stamp, f"query: {loc_stamp}"
                map_stamp = int(np.load(shard_path)["map_stamp"])
                map_t = get_closest_index(map_stamp, gt_map_times)
                assert gt_map_times[map_t] == map_stamp, f"query: {map_stamp}"

                T_gt = get_inverse_tf(gt_loc_poses[loc_t]) @ gt_map_poses[map_t]
                T_init = self._sample_T_init(T_gt)

                self.entries.append((shard_path, radar_path, cfar_path, pair_idx))
                self.T_loc_gt.append(T_gt.astype(np.float32))
                self.T_loc_init.append(T_init.astype(np.float32))
                if num_samples > 0 and len(self.entries) >= num_samples:
                    break

        assert self.entries, "dataset is empty"

    # ------------------------------------------------------------------ init
    def _sample_T_init(self, T_gt: np.ndarray) -> np.ndarray:
        d = self.config.data
        if d.use_gt:
            return np.eye(4) if d.gt_eye else T_gt
        if self.dataset_type == "train":
            xi = 2 * self._rng.random(6) - 1
            xi[0:2] *= d.pos_std
            xi[5] *= d.rot_std
            xi[2:5] = 0.0
        else:
            xi = np.zeros(6)
            xi[0] = self._rng.normal(0.0, d.pos_std)
            xi[1] = self._rng.normal(0.0, d.pos_std)
            xi[5] = self._rng.normal(0.0, d.rot_std)
        T_rand = se3_exp_np(xi)
        return T_rand if d.gt_eye else T_rand @ T_gt

    # --------------------------------------------------------------- access
    def __len__(self) -> int:
        return len(self.entries)

    def filter_map(self, map_pts, map_norms, T_ml_gt, return_aligned=False):
        """FOV/z-normal filter in the loc frame (`icp_weight_dataset.py:402-423`)."""
        d = self.config.data
        pts_loc = map_pts @ T_ml_gt[:3, :3].T + T_ml_gt[:3, 3]
        nrm_loc = map_norms @ T_ml_gt[:3, :3].T
        if d.loc_sensor == "radar" and d.map_sensor == "lidar":
            elev = np.abs(
                np.arctan2(pts_loc[:, 2],
                           np.sqrt(pts_loc[:, 0] ** 2 + pts_loc[:, 1] ** 2))
            )
            z_norm = np.abs(nrm_loc[:, 2])
            valid = (elev <= d.elevation_threshold) & (
                z_norm <= d.z_normal_threshold
            )
        else:
            valid = np.ones(pts_loc.shape[0], dtype=bool)
        if return_aligned:
            return pts_loc[valid], nrm_loc[valid]
        return map_pts[valid], map_norms[valid]

    def _load_clouds(self, shard_path: str, pair_idx: int, T_ml_gt: np.ndarray):
        shard = np.load(shard_path)
        raw = shard["raw_pc"].astype(np.float32)
        filt = shard["filt_pc"].astype(np.float32)
        assert raw.shape == filt.shape, "Raw and filtered pointclouds dont match!"

        pad = np.zeros((self.max_loc_pts - raw.shape[0], 3), np.float32)
        raw = np.concatenate([raw, pad], axis=0)
        filt = np.concatenate([filt, pad], axis=0)

        map_pc = shard["map_pc"].astype(np.float32)
        T_msr = self.T_map_sensor_robot[pair_idx]
        pts = map_pc[:, :3] @ T_msr[:3, :3].T + T_msr[:3, 3]
        nrm = map_pc[:, 3:6] @ T_msr[:3, :3].T
        pts, nrm = self.filter_map(pts, nrm, T_ml_gt, return_aligned=self.gt_eye)

        mpad = np.full((self.max_map_pts - pts.shape[0], 3), self.target_pad_val,
                       np.float32)
        pts = np.concatenate([pts.astype(np.float32), mpad], axis=0)
        nrm = np.concatenate([nrm.astype(np.float32), mpad], axis=0)
        map_out = np.concatenate([pts, nrm], axis=1)
        return raw, filt, map_out, int(shard["loc_stamp"]), int(shard["map_stamp"])

    def augment_data(self, raw, filt, map_pc, azimuths, fft, cfar):
        if not self.gt_eye:
            raise NotImplementedError("Only gt_eye=True supports augmentation")
        angle = 2 * np.pi * self._rng.random()
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s], [s, c]], np.float32)
        # Reference right-multiplies (rotation by -angle of the points).
        raw[:, :2] = raw[:, :2] @ rot
        filt[:, :2] = filt[:, :2] @ rot
        map_pc[:, :2] = map_pc[:, :2] @ rot
        if map_pc.shape[1] == 6:
            map_pc[:, 3:5] = map_pc[:, 3:5] @ rot

        azimuths = azimuths - angle
        azimuths = np.where(azimuths < 0.0, azimuths + 2 * np.pi, azimuths)
        min_idx = int(np.argmin(azimuths))
        azimuths = np.roll(azimuths, -min_idx)
        fft = np.roll(fft, -min_idx, axis=0)
        cfar = np.roll(cfar, -min_idx, axis=0)
        return raw, filt, map_pc, azimuths, fft, cfar

    def _load_cfar(self, cfar_path: str, fft: np.ndarray) -> np.ndarray:
        """Hard CFAR mask for a scan, cached on disk as uint8 {0, 1}.

        The reference's cache is a PNG u8 round-trip of the {0, 1} mask
        (`icp_weight_dataset.py:183-200`), so u8 is lossless — and it keeps
        the host pipeline and host↔device transfer at a quarter of f32.
        Legacy f32 caches (values {0.0, 1.0}) are accepted and re-quantized.
        """
        if osp.exists(cfar_path):
            cached = np.load(cfar_path)
            if cached.dtype != np.uint8:
                # One-time re-quantization: write the u8 back so later epochs
                # read a quarter of the bytes instead of re-converting forever.
                cached = cached.astype(np.uint8)
                np.save(cfar_path, cached)
            return cached
        # Cache miss: compute hard CFAR once and store (reference `:183-200`),
        # on CPU tensors: host work of the loader, like the reference's.
        m = self.config.model
        fft_norm = np.divide(fft, 255.0, dtype=np.float32) \
            if fft.dtype == np.uint8 else fft
        cfar = cfar_mask(torch.from_numpy(np.ascontiguousarray(fft_norm))[None],
                         self.polar_res, a_thresh=m.a_thresh, b_thresh=m.b_thresh,
                         diff=False)[0].numpy().astype(np.uint8)
        np.save(cfar_path, cfar)
        return cfar

    def __getitem__(self, index: int) -> dict:
        shard_path, radar_path, cfar_path, pair_idx = self.entries[index]
        T_init = self.T_loc_init[index]
        T_ml_gt = self.T_loc_gt[index]
        raw, filt, map_pc, loc_stamp, map_stamp = self._load_clouds(
            shard_path, pair_idx, T_ml_gt
        )

        if self.radar_mode:
            # fft/cfar stay uint8 through the host pipeline (collation ships
            # 4x fewer bytes); loader.preprocess_batch normalizes on device.
            fft, azimuths, az_times = _decode_radar_file(radar_path)
            azimuths = azimuths.astype(np.float32)
            az_times = az_times.astype(np.float32)
            cfar = self._load_cfar(cfar_path, fft)
            if self.augment:
                raw, filt, map_pc, azimuths, fft, cfar = self.augment_data(
                    raw, filt, map_pc, azimuths, fft, cfar
                )
        else:
            fft = np.zeros((1, 1), np.uint8)
            cfar = np.zeros((1, 1), np.uint8)
            azimuths = np.zeros((1,), np.float32)
            az_times = np.zeros((1,), np.float32)

        return {
            "loc_data": {
                "raw_pc": raw,
                "filtered_pc": filt,
                "fft_data": fft,  # polar uint8; loader normalizes + warps
                "fft_cfar": cfar,
                "azimuths": azimuths,
                "az_times": az_times,
                "timestamp": loc_stamp,
            },
            "map_data": {"pc": map_pc, "timestamp": map_stamp},
            "transforms": {"T_ml_init": T_init, "T_ml_gt": T_ml_gt},
        }

    def get_item_from_loc_timestamp(self, loc_stamp_req: int) -> dict:
        """Lookup by localization timestamp (`icp_weight_dataset.py:454-496`)."""
        for i, (shard_path, *_) in enumerate(self.entries):
            if f"frame_{loc_stamp_req}." in osp.basename(shard_path):
                item = self[i]
                assert item["loc_data"]["timestamp"] == loc_stamp_req
                return item
        raise AssertionError("loc_stamp_req not found in dataset")

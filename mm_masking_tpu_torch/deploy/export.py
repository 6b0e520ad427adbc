"""Deployment artifacts: the mask-inference and registration programs as
self-describing files (counterpart of ``mm_masking_tpu.deploy.export``).

The reference deploys its UNet to LibTorch inside vtr3; the JAX package
serialises its forward with ``jax.export``. The port does the same with
``torch.export``:

  * :func:`export_mask_policy` traces ``LearnICPWeightPolicy.mask_for_scan``
    (raw polar power → optional CFAR channel → polar→cartesian warp → UNet →
    max normalisation → cartesian weight mask) with the trained weights as
    the exported module's parameters; :func:`export_localizer` traces the
    registration step ``localize_clouds`` (clouds → pose) with its
    configuration baked in. Its tolerance-stopped solve runs all its
    iterations under ``torch.export``, with no read of the stop test, and
    gives the same poses;
  * the batch dimension is symbolic by default (``torch.export.Dim``), so one
    artifact serves any number of scans per call;
  * one file holds the JAX package's layout: a magic, the u32 length of a
    JSON header, the header, then the payload (``torch.export.save``'s
    bytes). The magic is the port's own, so each package's reader refuses
    the other's file with a message naming it.

A ``torch.export`` program is tied to the device it was traced on. Traced
on the CPU (``platforms=["cpu"]``), it holds only ATen operators and loads
with ``torch`` alone. Traced on the card it holds the port's kernels as the
custom operators ``mm_masking::conv3x3`` (K2's forward) and
``mm_masking::nn_argmin`` / ``mm_masking::nn_stripe`` (K1 and K4); its
header lists them, and :func:`load_mask_policy` / :func:`load_localizer`
import the port's kernels to register them first, as a JAX artifact
traced on a TPU needs a TPU runtime.

CLI: ``python -m mm_masking_tpu_torch.deploy export|export-localizer|info|run``.
"""
from __future__ import annotations

import io
import json
import os.path as osp
import struct
from typing import Callable, Sequence

import numpy as np
import torch

_MAGIC = b"MMTORCHX"
_JAX_MAGIC = b"MMTPUEXP"  # the JAX package's artifacts
_VERSION = 1
_OPS_NAMESPACE = "mm_masking"


def _device(platforms: Sequence[str] | None, default: torch.device) -> torch.device:
    """The one device an artifact is traced on: ``platforms`` (["cpu"] or
    ["cuda"]) or ``default``."""
    if not platforms:
        return torch.device(default)
    if len(platforms) != 1 or platforms[0] not in ("cpu", "cuda"):
        raise ValueError(f"platforms must be ['cpu'] or ['cuda'], got {list(platforms)}: a "
                         "torch.export program runs on the device it was traced on")
    device = torch.device(platforms[0])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("platforms=['cuda']: no CUDA device is available; export with "
                           "platforms=['cpu'] to trace on the CPU")
    return device


def _custom_ops(program: torch.export.ExportedProgram) -> list[str]:
    """The port's custom operators the program calls (``namespace::name``)."""
    return sorted({node.target._schema.name for node in program.graph.nodes
                   if node.op == "call_function"
                   and getattr(node.target, "namespace", None) == _OPS_NAMESPACE})


def _export(module: torch.nn.Module, example: tuple, names: Sequence[str],
            batch: int | str) -> torch.export.ExportedProgram:
    dynamic = None
    if isinstance(batch, str):
        dim = torch.export.Dim(batch, min=1)
        dynamic = {name: {0: dim} for name in names}
    with torch.no_grad():
        return torch.export.export(module, example, dynamic_shapes=dynamic, strict=False)


def _payload(program: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class _MaskPolicy(torch.nn.Module):
    """``mask_for_scan`` with the UNet's parameters as this module's (a
    policy of its own: the parameters are loaded into its UNet). They need
    no gradient: a tensor that requires one takes another path through
    ``torch.matmul`` (the head), which sums in another order."""

    def __init__(self, policy, params: dict):
        super().__init__()
        self.policy = policy
        self.unet = policy.unet
        self.unet.load_state_dict(params)
        self.unet.requires_grad_(False)

    def forward(self, fft_polar: torch.Tensor, azimuths: torch.Tensor) -> torch.Tensor:
        params = {**dict(self.unet.named_parameters()), **dict(self.unet.named_buffers())}
        return self.policy.mask_for_scan(params, fft_polar, azimuths)


# --------------------------------------------------------------------- export
def export_mask_policy(policy, params: dict, *, batch: int | str = "b",
                       platforms: Sequence[str] | None = None) -> tuple[bytes, dict]:
    """Trace and serialise ``policy.mask_for_scan`` with ``params`` (the
    UNet's state_dict) as the program's parameters → (payload, header).

    ``batch``: an int fixes the batch dimension; a string makes it symbolic
    (any batch size; the max normalisation's statistics span whatever
    batch the caller passes, as the reference's validation batches do).
    ``platforms``: ["cpu"] or ["cuda"] (default: the policy's device).
    """
    from mm_masking_tpu_torch.models import LearnICPWeightPolicy

    device = _device(platforms, policy.device)
    policy = LearnICPWeightPolicy(policy.cfg, device)
    m = policy.cfg.model
    A, R = m.polar_shape
    b = 2 if isinstance(batch, str) else int(batch)
    example = (torch.zeros((b, A, R), device=device), torch.zeros((b, A), device=device))
    module = _MaskPolicy(policy, {k: v.to(device) for k, v in params.items()}).eval()
    program = _export(module, example, ("fft_polar", "azimuths"), batch)
    header = {
        "kind": "mask_policy",
        "polar_shape": [int(A), int(R)],
        "cart_pixel_width": int(m.cart_pixel_width),
        "cart_resolution": float(m.cart_resolution),
        "res": float(m.res),
        "batch": batch,
        "platforms": [device.type],
        "custom_ops": _custom_ops(program),
        "torch": torch.__version__,
        "inputs": "fft_polar (B, A, R) f32 in [0,1]; azimuths (B, A) f32 rad",
        "output": "cartesian weight mask (B, Wc, Wc) f32 in [0,1]",
    }
    return _payload(program), header


def export_from_run_dir(run_dir: str, *, checkpoint_name: str = "best_policy",
                        batch: int | str = "b", platforms: Sequence[str] | None = None
                        ) -> tuple[bytes, dict]:
    """Export from a Trainer run directory (``config.json`` and the
    checkpoint ``<checkpoint_name>.pt``), the inputs the localization CLI's
    ``--checkpoint`` reads. The JAX package forces its plain XLA convs here
    so that its StableHLO stays portable across backends; a ``torch.export``
    program runs only on the device it was traced on, so the port traces on
    the requested device as it runs there: on the card through K2's kernel,
    on the CPU through the plain convolution. Default: the card."""
    from mm_masking_tpu_torch.config import Config
    from mm_masking_tpu_torch.models import LearnICPWeightPolicy
    from mm_masking_tpu_torch.train.checkpoint import load_policy_variables

    cfg_path = osp.join(run_dir, "config.json")
    if not osp.exists(cfg_path):
        raise FileNotFoundError(f"{cfg_path} not found: train with the port's Trainer (it "
                                "writes the run config next to its checkpoints)")
    with open(cfg_path) as f:
        cfg = Config.from_dict(json.load(f))
    device = _device(platforms or ["cuda"], torch.device("cuda"))
    policy = LearnICPWeightPolicy(cfg, device)
    params = load_policy_variables(run_dir, checkpoint_name, map_location=device)
    payload, header = export_mask_policy(policy, params, batch=batch,
                                         platforms=[device.type])
    header["run_dir"] = osp.abspath(run_dir)
    header["checkpoint"] = checkpoint_name
    return payload, header


class _Localizer(torch.nn.Module):
    def __init__(self, cfg_loc):
        super().__init__()
        self.cfg_loc = cfg_loc

    def forward(self, pc, map_pc, T_init, weights):
        from mm_masking_tpu_torch.localization.pipeline import localize_clouds

        out = localize_clouds(pc, map_pc, T_init, self.cfg_loc, weights=weights)
        return out["T"], out["matched_ratio"], out["ok"]


def export_localizer(cfg_loc, *, n_points: int, n_map: int, batch: int | str = "b",
                     platforms: Sequence[str] | None = None) -> tuple[bytes, dict]:
    """Trace and serialise the registration step, ``localize_clouds`` with
    ``cfg_loc`` baked in: (pc (B, N, 3) zero-padded, map_pc (B, M, 6) with
    normals, T_init (B, 4, 4), weights (B, N)) → (T (B, 4, 4), matched_ratio
    (B,), ok (B,) bool). N and M are static; the batch may be symbolic.
    ``platforms``: ["cpu"] or ["cuda"] (default: the card). The association
    follows the device and the map: on the card K1 (dense) or K4 (the sorted
    stripe, M ≥ 4096), on the CPU their plain versions."""
    device = _device(platforms or ["cuda"], torch.device("cuda"))
    b = 2 if isinstance(batch, str) else int(batch)
    N, M = int(n_points), int(n_map)
    example = (torch.zeros((b, N, 3), device=device), torch.zeros((b, M, 6), device=device),
               torch.eye(4, device=device).expand(b, 4, 4).contiguous(),
               torch.ones((b, N), device=device))
    program = _export(_Localizer(cfg_loc), example, ("pc", "map_pc", "T_init", "weights"),
                      batch)
    header = {
        "kind": "localizer",
        "n_points": N,
        "n_map": M,
        "batch": batch,
        "platforms": [device.type],
        "custom_ops": _custom_ops(program),
        "torch": torch.__version__,
        "icp_type": cfg_loc.icp_type,
        "iterations": [int(cfg_loc.initial_max_iter), int(cfg_loc.refined_max_iter)],
        "min_matched_ratio": float(cfg_loc.min_matched_ratio),
        "inputs": "pc (B, N, 3) zero-padded; map_pc (B, M, 6) xyz+normals "
                  "(zero normals for pt2pt); T_init (B, 4, 4); weights (B, N)",
        "output": "(T (B, 4, 4), matched_ratio (B,), ok (B,) bool)",
    }
    return _payload(program), header


# ------------------------------------------------------------------ file I/O
def write_artifact(path: str, payload: bytes, header: dict) -> None:
    """One self-describing file: magic, u32 header length, JSON header, payload."""
    hdr = json.dumps({"version": _VERSION, **header}).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload)


def read_artifact(path: str) -> tuple[bytes, dict]:
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(f"{path}: an artifact of the JAX package (mm_masking_tpu.deploy), "
                             "not of mm_masking_tpu_torch: load it with the JAX package")
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an mm_masking_tpu_torch artifact")
        (n,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(n))
        payload = f.read()
    return payload, header


def _load(path: str, kind: str) -> tuple[torch.nn.Module, dict, torch.device]:
    payload, header = read_artifact(path)
    if header.get("kind") != kind:
        raise ValueError(f"{path}: kind={header.get('kind')!r}, expected {kind!r}")
    if header.get("custom_ops"):  # traced on the card: register the port's kernels
        import mm_masking_tpu_torch.ops.kernels  # noqa: F401
    program = torch.export.load(io.BytesIO(payload))
    return program.module(), header, torch.device(header["platforms"][0])


def _tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def load_mask_policy(path: str) -> tuple[Callable, dict]:
    """An artifact → (call (fft_polar, azimuths) → mask, header). The
    weights live in the program: no config or checkpoint is read. uint8
    scans (the repo's wire format, raw counts) are normalised to [0, 1] as
    numpy's u8 / 255 before the call, as the JAX loader does."""
    module, header, device = _load(path, "mask_policy")

    def call(fft_polar, azimuths):
        fft = fft_polar if torch.is_tensor(fft_polar) else torch.from_numpy(
            np.ascontiguousarray(fft_polar))
        if fft.dtype == torch.uint8:
            from mm_masking_tpu_torch.data.loader import _u8_to_unit

            fft = _u8_to_unit(device)[fft.to(device).int()]
        with torch.no_grad():
            return module(_tensor(fft, device), _tensor(azimuths, device))

    return call, header


def load_localizer(path: str) -> tuple[Callable, dict]:
    """A localizer artifact → (call (pc, map_pc, T_init, weights) → (T,
    matched_ratio, ok), header)."""
    module, header, device = _load(path, "localizer")

    def call(pc, map_pc, T_init, weights):
        with torch.no_grad():
            return module(*(_tensor(x, device) for x in (pc, map_pc, T_init, weights)))

    return call, header

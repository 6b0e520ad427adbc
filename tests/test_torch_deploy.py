"""The port's deployment artifacts on the CPU (``mm_masking_tpu_torch.deploy``,
``torch.export``), mirroring ``tests/test_deploy.py`` and holding each port
artifact against the JAX package's on the same numpy inputs.

A port artifact traced on the CPU gives the port's direct call bit for bit
(masks, poses, matched ratios), at batch sizes it was not traced at. Against
JAX's artifacts: masks within 1e-5 (float32 convolutions summed in another
order, the limit of ``tests/test_torch_localization.py``), poses within
1e-4 m and 1e-5 rad, matched ratios and ``ok`` equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, DataConfig as JDataConfig
from mm_masking_tpu.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from mm_masking_tpu.deploy import (
    export_localizer as jexport_localizer,
    export_mask_policy as jexport_mask_policy,
    load_localizer as jload_localizer,
    load_mask_policy as jload_mask_policy,
    read_artifact as jread_artifact,
    write_artifact as jwrite_artifact,
)
from mm_masking_tpu.localization import pipeline as jpipe
from mm_masking_tpu.models import LearnICPWeightPolicy as JPolicy
from mm_masking_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.deploy import (
    export_localizer,
    export_mask_policy,
    load_localizer,
    load_mask_policy,
    read_artifact,
    write_artifact,
)
from mm_masking_tpu_torch.deploy.__main__ import main
from mm_masking_tpu_torch.localization.pipeline import LocalizationConfig, localize_clouds
from mm_masking_tpu_torch.models import LearnICPWeightPolicy, params_from_flax

A, R, CART = 32, 128, 32
MODEL = dict(enc_channels=(4, 8), dropout=0.0, res=15.0 / R, polar_shape=(A, R),
             cart_pixel_width=CART, cart_resolution=2 * 15.0 / CART)
CPU = ["cpu"]


def make_policies(cfar_input=True):
    """The port's policy and the JAX policy with the same parameters."""
    jpolicy = JPolicy(JConfig(model=JModelConfig(**MODEL, cfar_input=cfar_input),
                              data=JDataConfig(max_loc_pts=64, max_map_pts=128),
                              train=JTrainConfig(num_devices=1)))
    variables = jpolicy.init(jax.random.PRNGKey(0))
    cfg = Config(model=ModelConfig(**MODEL, cfar_input=cfar_input),
                 data=DataConfig(max_loc_pts=64, max_map_pts=128))
    policy = LearnICPWeightPolicy(cfg, "cpu")
    return policy, params_from_flax(variables["params"]), jpolicy, variables


def scans(batch, seed=0):
    rng = np.random.default_rng(seed)
    fft = rng.random((batch, A, R), np.float32) ** 2
    az = np.tile((np.arange(A, dtype=np.float32) / A * 2 * np.pi)[None], (batch, 1))
    return fft, az


def direct(policy, params, fft, az):
    with torch.no_grad():
        return policy.mask_for_scan(params, torch.from_numpy(fft), torch.from_numpy(az))


def test_export_roundtrip_symbolic_batch(tmp_path):
    policy, params, jpolicy, variables = make_policies()
    payload, header = export_mask_policy(policy, params, batch="b")
    path = str(tmp_path / "policy.mmx")
    write_artifact(path, payload, header)
    jpayload, jheader = jexport_mask_policy(jpolicy, variables, batch="b")
    jpath = str(tmp_path / "policy_jax.mmx")
    jwrite_artifact(jpath, jpayload, jheader)
    jcall, _ = jload_mask_policy(jpath)

    call, hdr = load_mask_policy(path)
    assert hdr["polar_shape"] == [A, R] and hdr["platforms"] == ["cpu"]
    assert hdr["custom_ops"] == []  # a CPU trace: ATen operators only
    for b, seed in ((1, 0), (3, 1)):
        fft, az = scans(b, seed)
        got = call(fft, az)
        want = direct(policy, params, fft, az)
        assert got.shape == (b, CART, CART) and torch.isfinite(want).all()
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(jcall(fft, az)), rtol=0, atol=1e-5)

    # u8 wire-format planes: numpy's u8 / 255 before the program, as JAX's loader.
    fft_u8 = (scans(2, 2)[0] * 255).astype(np.uint8)
    az2 = scans(2, 2)[1]
    got_u8 = call(fft_u8, az2)
    assert torch.equal(got_u8, direct(policy, params, np.divide(fft_u8, 255.0,
                                                               dtype=np.float32), az2))
    np.testing.assert_allclose(got_u8.numpy(), np.asarray(jcall(fft_u8, az2)), rtol=0,
                               atol=1e-5)


def test_artifact_header_and_magic(tmp_path):
    path = str(tmp_path / "x.mmx")
    write_artifact(path, b"payload-bytes", {"kind": "mask_policy"})
    payload, header = read_artifact(path)
    assert payload == b"payload-bytes"
    assert header["kind"] == "mask_policy" and header["version"] == 1
    bad = str(tmp_path / "bad.mmx")
    with open(bad, "wb") as f:
        f.write(b"NOTMAGIC" + b"\x00" * 16)
    with pytest.raises(ValueError, match="not an mm_masking_tpu_torch artifact"):
        read_artifact(bad)


def test_cli_export_info_run(tmp_path, capsys):
    """Run dir → artifact → masks over raw scan files, through the CLI."""
    from mm_masking_tpu_torch.train import Trainer

    policy, _, _, _ = make_policies()
    run = tmp_path / "run"
    cfg = dataclasses.replace(policy.cfg, train=TrainConfig(checkpoint_dir=str(run)))
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state()
    trainer.save(state, "best_policy")
    with open(run / "config.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)

    art = str(tmp_path / "policy.mmx")
    assert main(["export", "--checkpoint", str(run), "--out", art,
                 "--platforms", "cpu"]) == 0
    assert main(["info", art]) == 0
    info = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert info["checkpoint"] == "best_policy" and info["payload_bytes"] > 0

    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    rng = np.random.default_rng(0)
    raws = []
    for i in range(2):
        img = np.zeros((A, 11 + R), np.uint8)
        ts = (np.arange(A, dtype=np.int64) + 1000 * i) * 400
        img[:, :8] = np.frombuffer(ts.tobytes(), np.uint8).reshape(A, 8)
        enc = (np.arange(A, dtype=np.float64) / A * 5600).astype(np.uint16)
        img[:, 8:10] = np.frombuffer(enc.tobytes(), np.uint8).reshape(A, 2)
        img[:, 11:] = rng.integers(0, 255, (A, R), dtype=np.uint8)
        np.save(scan_dir / f"{1_000_000 + i}.npy", img)
        raws.append(img)

    out = str(tmp_path / "masks.npz")
    assert main(["run", "--artifact", art, "--scans", str(scan_dir), "--out", out,
                 "--batch-size", "1"]) == 0
    z = np.load(out)
    assert z["masks"].shape == (2, CART, CART)
    assert list(z["stamps"]) == ["1000000", "1000001"]
    assert np.isfinite(z["masks"]).all()
    assert z["masks"].min() >= 0.0 and z["masks"].max() <= 1.0
    # Each chunk of one scan equals the policy's own mask of it.
    from mm_masking_tpu_torch.ops.radar import load_radar

    for img, mask in zip(raws, z["masks"]):
        fft, az, _ = load_radar(img)
        want = direct(trainer.policy, state.params, fft[None], az[None].astype(np.float32))
        np.testing.assert_array_equal(mask, want[0].numpy())


def test_export_fixed_batch_rejects_other_sizes(tmp_path):
    policy, params, _, _ = make_policies(cfar_input=False)
    payload, header = export_mask_policy(policy, params, batch=2)
    path = str(tmp_path / "fixed.mmx")
    write_artifact(path, payload, header)
    call, hdr = load_mask_policy(path)
    assert hdr["batch"] == 2
    fft, az = scans(2)
    assert torch.equal(call(fft, az), direct(policy, params, fft, az))
    fft3, az3 = scans(3)
    with pytest.raises(Exception):
        call(fft3, az3)


def localizer_scene():
    spec = SyntheticSpec(cart_pixel_width=CART, polar_shape=(A, R), res=15.0 / R,
                         cart_resolution=2 * 15.0 / CART, n_scan=64, n_map=128, pos_std=0.4,
                         rot_std=0.15)
    b = synthetic_batch(3, batch=3, spec=spec)
    pc = b["loc_data"]["filtered_pc"][..., :3].contiguous()
    w = (~((pc[..., 0] == 0.0) & (pc[..., 1] == 0.0))).float()
    return pc, b["map_data"]["pc"], b["transforms"]["T_ml_init"], w


def test_localizer_export_roundtrip(tmp_path):
    """The registration step's artifact against ``localize_clouds`` (bit for
    bit: all its iterations run, each item frozen once it stops) and JAX's
    artifact, at unseen batch sizes; the mask loader refuses it."""
    pc, map_pc, T0, w = localizer_scene()
    kw = dict(max_points=64, beta=0.0, icp_type="pt2pl", initial_max_iter=2,
              refined_max_iter=6, min_matched_ratio=0.3)
    cfg = LocalizationConfig(**kw)
    payload, header = export_localizer(cfg, n_points=pc.shape[1], n_map=map_pc.shape[1],
                                       batch="b", platforms=CPU)
    path = str(tmp_path / "localizer.mmx")
    write_artifact(path, payload, header)
    jpayload, jheader = jexport_localizer(jpipe.LocalizationConfig(**kw),
                                          n_points=pc.shape[1], n_map=map_pc.shape[1],
                                          batch="b")
    jpath = str(tmp_path / "localizer_jax.mmx")
    jwrite_artifact(jpath, jpayload, jheader)

    call, hdr = load_localizer(path)
    assert hdr["kind"] == "localizer" and hdr["iterations"] == [2, 6]
    T, ratio, ok = call(pc, map_pc, T0, w)
    ref = localize_clouds(pc, map_pc, T0, cfg, weights=w)
    assert torch.equal(T, ref["T"])
    assert torch.equal(ratio, ref["matched_ratio"]) and torch.equal(ok, ref["ok"])
    assert ratio.min() > 0.0  # the scene matches
    jT, jratio, jok = jload_localizer(jpath)[0](*(jnp.asarray(x.numpy())
                                                  for x in (pc, map_pc, T0, w)))
    jT = np.asarray(jT)
    np.testing.assert_allclose(T[:, :3, 3].numpy(), jT[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T[:, :3, :3].numpy(), jT[:, :3, :3], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ratio.numpy(), np.asarray(jratio))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))

    T1, r1, _ = call(pc[:1], map_pc[:1], T0[:1], w[:1])
    assert T1.shape == (1, 4, 4) and r1.shape == (1,)
    assert torch.equal(T1, localize_clouds(pc[:1], map_pc[:1], T0[:1], cfg, weights=w[:1])["T"])

    bad = str(tmp_path / "wrong.mmx")
    write_artifact(bad, b"x", {"kind": "mask_policy"})
    with pytest.raises(ValueError, match="expected 'localizer'"):
        load_localizer(bad)


def test_cli_export_localizer(tmp_path):
    art = str(tmp_path / "loc.mmx")
    assert main(["export-localizer", "--out", art, "--n-points", "32", "--n-map", "64",
                 "--batch", "2", "--platforms", "cpu", "--cfg", "icp_type=pt2pt",
                 "--cfg", "refined_max_iter=3", "--cfg", "min_matched_ratio=0.25"]) == 0
    assert main(["info", art]) == 0
    call, hdr = load_localizer(art)
    assert hdr["icp_type"] == "pt2pt" and hdr["iterations"][1] == 3 and hdr["batch"] == 2
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 32, 3)).astype(np.float32)
    mp = np.concatenate([pts[:, :32], rng.normal(size=(2, 32, 3)).astype(np.float32)], axis=1)
    mp = np.concatenate([mp, np.zeros((2, 64, 3), np.float32)], axis=-1)
    T0 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T, ratio, ok = call(pts, mp, T0, np.ones((2, 32), np.float32))
    assert T.shape == (2, 4, 4) and torch.isfinite(T).all()
    cfg = LocalizationConfig(icp_type="pt2pt", refined_max_iter=3, min_matched_ratio=0.25)
    ref = localize_clouds(*(torch.from_numpy(x) for x in (pts, mp, T0)), cfg,
                          weights=torch.ones(2, 32))
    assert torch.equal(T, ref["T"]) and torch.equal(ok, ref["ok"])
    with pytest.raises(SystemExit, match="unknown LocalizationConfig"):
        main(["export-localizer", "--out", art, "--cfg", "nope=1"])


_TORCH_ALONE = r"""
import json, struct, sys, io
import numpy as np, torch
with open(sys.argv[1], "rb") as f:
    assert f.read(8) == b"MMTORCHX"
    (n,) = struct.unpack("<I", f.read(4))
    header = json.loads(f.read(n))
    program = torch.export.load(io.BytesIO(f.read()))
fft, az = np.load(sys.argv[2]), np.load(sys.argv[3])
with torch.no_grad():
    mask = program.module()(torch.from_numpy(fft), torch.from_numpy(az))
np.save(sys.argv[4], mask.numpy())
assert not [m for m in sys.modules if m.startswith(("mm_masking", "jax"))], "imported more"
print(header["kind"])
"""


def test_cpu_artifact_loads_with_torch_alone(tmp_path):
    """A CPU artifact in a fresh interpreter that imports only torch and
    numpy: the file's layout read by hand, the program loaded and run."""
    policy, params, _, _ = make_policies()
    path = str(tmp_path / "policy.mmx")
    write_artifact(path, *export_mask_policy(policy, params, batch="b"))
    fft, az = scans(3, 4)
    np.save(tmp_path / "fft.npy", fft)
    np.save(tmp_path / "az.npy", az)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _TORCH_ALONE, path, str(tmp_path / "fft.npy"),
                          str(tmp_path / "az.npy"), str(tmp_path / "mask.npy")],
                         capture_output=True, text=True, cwd=str(tmp_path), env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "mask_policy"
    np.testing.assert_array_equal(np.load(tmp_path / "mask.npy"),
                                  direct(policy, params, fft, az).numpy())


def test_each_package_refuses_the_others_artifact(tmp_path):
    port = str(tmp_path / "port.mmx")
    write_artifact(port, b"x", {"kind": "mask_policy"})
    jax_file = str(tmp_path / "jax.mmx")
    jwrite_artifact(jax_file, b"x", {"kind": "mask_policy"})
    with pytest.raises(ValueError, match="artifact of the JAX package"):
        read_artifact(jax_file)
    with pytest.raises(ValueError, match="not an mm_masking_tpu artifact"):
        jread_artifact(port)
    with pytest.raises(ValueError, match="JAX package"):
        load_mask_policy(jax_file)

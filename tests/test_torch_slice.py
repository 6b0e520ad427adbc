"""The port's inference slice vs the JAX package, end to end on the CPU:
``synthetic_batch``, ``Trainer.eval_step`` (mask → weights → stripe ICP →
error triple), and the port's import hygiene."""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from mm_masking_tpu.data.synthetic import SyntheticSpec as JSpec, synthetic_batch as jbatch
from mm_masking_tpu.models.policy import LearnICPWeightPolicy as JPolicy
from mm_masking_tpu.train.loss import eval_validation_loss as jeval_loss
from mm_masking_tpu_torch.config import Config, ModelConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.models import params_from_flax
from mm_masking_tpu_torch.train import Trainer

SPEC = dict(n_scan=512, n_map=4096, polar_shape=(64, 256), cart_pixel_width=64, res=0.25,
            cart_resolution=0.5, max_range=15.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
MODEL = dict(enc_channels=(4, 8), dropout=0.05, cart_pixel_width=64, cart_resolution=0.5,
             res=0.25, polar_shape=(64, 256))


def leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("scene", ["scatter", "walls"])
def test_synthetic_batch_matches_jax(scene):
    kw = dict(SPEC, n_map=1024, scene=scene, clutter_frac=0.2, max_range=30.0)
    want = dict(leaves(jbatch(7, 2, JSpec(**kw), with_oracle=True)))
    got = dict(leaves(synthetic_batch(7, 2, SyntheticSpec(**kw), with_oracle=True)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_eval_step_matches_jax():
    """The slice: the same numpy batch and converted parameters through both.
    n_map = 4096 turns the stripe association on."""
    jcfg = JConfig(model=JModelConfig(**MODEL))
    jpol = JPolicy(jcfg)
    variables = jpol.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    variables = {"params": jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.02, a.shape).astype(np.float32), variables["params"])}
    batch = jbatch(2, 2, JSpec(**SPEC))
    j_out = jpol.apply(variables, batch["loc_data"], batch["map_data"],
                       batch["transforms"]["T_ml_init"])
    j_err = jeval_loss(j_out.T_pred, batch["transforms"]["T_ml_gt"])

    trainer = Trainer(Config(model=ModelConfig(**MODEL)), "cpu")
    tbatch = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), batch)
    params = params_from_flax(variables["params"])
    err, stats, mask = trainer.eval_step(params, tbatch)
    out = trainer.policy.apply(params, tbatch["loc_data"], tbatch["map_data"],
                               tbatch["transforms"]["T_ml_init"])

    np.testing.assert_allclose(mask.numpy(), np.asarray(j_out.weight_mask), rtol=0, atol=1e-5)
    converged = out.icp_info["delta_norm"].numpy() < 1e-5
    assert converged.all()
    T_w, T_g = np.asarray(j_out.T_pred), out.T_pred.numpy()
    np.testing.assert_allclose(T_g[:, :3, 3], T_w[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_g[:, :3, :3], T_w[:, :3, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(err.numpy(), np.asarray(j_err), rtol=0, atol=1e-4)
    for f in stats._fields:
        np.testing.assert_allclose(float(getattr(stats, f)), float(getattr(j_out.stats, f)),
                                   rtol=1e-5, atol=1e-3)
    err_v, *rest = trainer.validate(params, [tbatch, tbatch])
    np.testing.assert_allclose(err_v.numpy(), err.numpy(), rtol=1e-6)
    assert rest[0] == pytest.approx(float(stats.mean_num_non0))


def test_icp_overrides_parse_none_valued_fields():
    cfg = Config(model=ModelConfig(**MODEL, icp_overrides=(
        "nn_stripe=false", "use_pallas_nn=none", "damping_rel=0", "trim_dist=4")))
    icp_cfg = Trainer(cfg, "cpu").policy._icp_inference
    assert icp_cfg.nn_stripe is False and icp_cfg.use_pallas_nn is None
    assert icp_cfg.damping_rel == 0.0 and icp_cfg.trim_dist == 4.0


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        Trainer(Config(model=ModelConfig(**MODEL)), "cuda")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mm_masking_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                    'mm_masking_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('mm_masking_tpu_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 20

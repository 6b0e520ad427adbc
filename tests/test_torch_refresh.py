"""The motion-gated refresh (``nn_refresh_dist > 0``) where it departs from
the ungated solve: the port against the JAX package on the CPU, at a size
where the stripe association runs (its parity on small scenes, its gate
and its chunking are in ``tests/test_torch_icp.py``)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from mm_masking_tpu.dicp import ICPConfig as JICPConfig, icp as jicp
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.dicp import ICPConfig, icp
from mm_masking_tpu_torch.geom import se3_exp


def test_gated_refresh_departs_from_ungated_as_jax_does():
    """On a scene with a dense map (1024 scan, 4096 map points, the stripe
    path) the gate can stay closed while an item is still far from the
    re-associated optimum: it then converges on the correspondences of its
    last search. The gated solve is JAX's there too: the port's gated T
    equals JAX's (1e-4 m / 1e-5 rad) on every item, and where the gated and
    the ungated solve part (item 1: 0.36 m, converged in both), they part
    alike in both packages."""
    B = 4
    b = synthetic_batch(1, B, SyntheticSpec(n_scan=1024, n_map=4096, polar_shape=(64, 512),
                                            cart_pixel_width=64))
    g = torch.Generator().manual_seed(27)
    xi = torch.zeros(B, 6)
    xi[:, :2] = (torch.rand(B, 2, generator=g) * 2 - 1) * 0.4
    xi[:, 5] = (torch.rand(B, generator=g) * 2 - 1) * 0.1
    args = (b["loc_data"]["filtered_pc"], b["map_data"]["pc"],
            se3_exp(xi) @ b["transforms"]["T_ml_gt"])
    out = {}
    for d in (0.0, 0.05):
        cfg = dict(icp_type="pt2pt", max_iterations=50, tolerance=1e-5, differentiable=False,
                   nn_refresh_dist=d, dim=2)
        out[d] = (icp(*args, cfg=ICPConfig(**cfg))["T"].numpy(),
                  np.asarray(jicp(*(jnp.asarray(a.numpy()) for a in args),
                                  cfg=JICPConfig(**cfg))["T"]))
    T_g, T_w = out[0.05]
    np.testing.assert_allclose(T_g[:, :3, 3], T_w[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_g[:, :3, :3], T_w[:, :3, :3], rtol=0, atol=1e-5)
    gap = {k: np.linalg.norm(out[0.05][k][:, :2, 3] - out[0.0][k][:, :2, 3], axis=-1)
           for k in (0, 1)}
    assert gap[0][1] > 0.1 and abs(gap[0][1] - gap[1][1]) < 1e-3
    assert gap[0][2:].max() < 1e-5 and gap[1][2:].max() < 1e-5

"""One `track_frame` of the port against the JAX `track_frame` from the same
map, frame and start pose: the refined pose within 1e-4, the exposure, and
the iteration count exactly. The JAX side renders through its Pallas
kernels in interpret mode, so both sides bin at the same poses. The cases
cover the plain loop, a re-bin threshold low enough that steps cut rounds
short (fewer than `max_iters` steps in the fixed round count), and the
early exit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.geometry import se3_exp as j_se3
from fourdgs.models.gaussian_map import NewGaussians, empty_map, init_adam, insert
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.ops.rasterize import rasterize as j_rasterize
from fourdgs.slam.camera import Intrinsics as JIntrinsics
from fourdgs.slam.camera import make_frame as j_make_frame
from fourdgs.slam.tracking import TrackingConfig as JTrackingConfig
from fourdgs.slam.tracking import track_frame as j_track_frame
from fourdgs_torch.convert import gaussian_map_from_arrays, pose_from_array
from fourdgs_torch.slam.camera import Intrinsics, make_frame
from fourdgs_torch.slam.tracking import TrackingConfig, track_frame

W, H = 64, 48
J_INTR = JIntrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=W, height=H)
T_INTR = Intrinsics(*J_INTR)
# with_n_touched: the JAX runner turns it off for tracking, whose result
# then reports no visibility; the port always counts
J_RASTER = JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13)


def _jax_map(seed=0, n=96, cap=128):
    rng = np.random.default_rng(seed)
    new = NewGaussians(
        xyz=jnp.asarray(np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.1, 1.1, n),
                                  rng.uniform(2.0, 5.0, n)], -1), jnp.float32),
        rgb=jnp.asarray(rng.uniform(0.1, 0.9, (n, 3)), jnp.float32),
        scaling=jnp.asarray(np.log(rng.uniform(0.08, 0.25, (n, 3))), jnp.float32),
        rotation=jnp.zeros((n, 4)).at[:, 0].set(1.0),
        opacity=jnp.full((n, 1), np.log(0.8 / 0.2), jnp.float32),
        valid=jnp.ones(n, bool),
    )
    gmap, _, _ = insert(empty_map(cap), init_adam(cap), new, kf_id=0)
    # a few dynamic Gaussians, which tracking must not render
    return gmap._replace(dygs=jnp.arange(cap) % 7 == 0)


@pytest.mark.parametrize("case,max_iters,rebin_delta,converged", [
    ("plain", 20, 0.01, 1e-4),
    ("stale_rounds", 20, 0.003, 1e-4),
    ("early_exit", 20, 0.01, 1.0),
])
def test_track_frame_matches_jax(case, max_iters, rebin_delta, converged):
    gmap = _jax_map()
    target = j_rasterize(
        gmap.params.xyz, gmap.get_scaling, gmap.get_rotation, gmap.get_opacity,
        gmap.get_color, gmap.alive & ~gmap.dygs, jnp.eye(4), J_INTR.proj(), jnp.zeros(3),
        fx=J_INTR.fx, fy=J_INTR.fy, width=W, height=H, tan_fovx=J_INTR.tan_fovx,
        tan_fovy=J_INTR.tan_fovy, config=J_RASTER)
    image, depth = np.asarray(target.color), np.asarray(target.depth)
    motion = np.ones((H, W), bool)
    motion[10:20, 30:45] = False
    T0 = np.asarray(j_se3(jnp.asarray([0.02, -0.015, 0.01, 0.006, -0.008, 0.004])))
    exp0 = np.array([0.01, -0.02], np.float32)

    jcfg = JTrackingConfig(max_iters=max_iters, rebin_delta_threshold=rebin_delta,
                           converged_threshold=converged, alpha=0.9, raster=J_RASTER)
    jres = j_track_frame(gmap, j_make_frame(1, image, depth, np.eye(4), 0.5, motion),
                         jnp.asarray(T0), jnp.asarray(exp0), J_INTR, jcfg)
    tcfg = TrackingConfig(max_iters=max_iters, rebin_delta_threshold=rebin_delta,
                          converged_threshold=converged, alpha=0.9)
    tres = track_frame(gaussian_map_from_arrays(gmap, "cpu"),
                       make_frame(1, image, depth, np.eye(4), 0.5, motion, device="cpu"),
                       pose_from_array(T0, "cpu"), torch.tensor(exp0), T_INTR, tcfg)

    assert tres.n_iters == int(jres.n_iters)
    if case == "stale_rounds":
        assert tres.n_iters < max_iters
    if case == "early_exit":
        assert tres.n_iters == 1
    np.testing.assert_allclose(tres.T_cw.numpy(), np.asarray(jres.T_cw), atol=1e-4)
    np.testing.assert_allclose(tres.exposure.numpy(), np.asarray(jres.exposure), atol=1e-4)
    # the loss of the last step, at poses that agree within 1e-4
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-3)
    np.testing.assert_allclose(float(tres.median_depth), float(jres.median_depth), rtol=1e-4)
    np.testing.assert_array_equal(tres.visibility.numpy(), np.asarray(jres.visibility))

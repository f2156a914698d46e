"""`Training.rm_initdy` in the port against the JAX package: the
depth-reprojection mask (`reproject_mask`) on every pixel, one `map_chunk`
with those masks ANDed into the window views' loss, and `SLAM.run` with
`rm_initdy`. The runs replay the reference's draws (`JaxDraws`), and the
JAX side renders through its Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.geometry import se3_exp as j_se3
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam import keyframes as jkf
from fourdgs.slam import mapping as jm
from fourdgs.slam.runner import SLAM as JSLAM
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch import convert
from fourdgs_torch.slam import keyframes as tkf
from fourdgs_torch.slam import mapping as tm
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_mapping import J_INTR, J_RASTER, T_INTR, _jax_picks, _state
from tests.test_torch_monocular import _centre, _run_config
from tests.test_torch_slam import JaxDraws, one_torch_thread  # noqa: F401

H, W = 48, 64
FX, FY, CX, CY = 60.0, 60.0, 31.5, 23.5
# the current views relative to the anchor. Not the anchor itself: there
# every pixel projects back within rounding of its own integer coordinates,
# where truncation goes either way (the guard below refuses it)
TAUS = ([0.005, -0.003, 0.002, 0.0, 0.002, 0.001], [0.05, -0.02, 0.01, 0.01, -0.02, 0.005],
        [-0.1, 0.04, -0.03, -0.02, 0.03, 0.0])


def _anchor(seed: int):
    """Anchor depth valid on about 6% of pixels (so the reprojected,
    dilated hits leave pixels uncovered), 1-4 m, with a dynamic block."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 4.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) > 0.06] = 0.0
    static = np.ones((H, W), bool)
    static[10:25, 30:50] = False
    return depth, static


def _projections(depth, static, T_a, T_c):
    """float64 (u, v) of the anchor's valid static pixels in the current view."""
    ys, xs = np.nonzero((depth > 0) & static)
    d = depth[ys, xs].astype(np.float64)
    pts = np.stack([(xs - CX) / FX * d, (ys - CY) / FY * d, d, np.ones_like(d)])
    pc = np.asarray(T_c, np.float64) @ np.linalg.inv(np.asarray(T_a, np.float64)) @ pts
    z = pc[2] + 1e-5
    return pc[0] / z * FX + CX, pc[1] / z * FY + CY


@pytest.mark.parametrize("view", range(len(TAUS)))
def test_reproject_mask_matches_jax(view):
    depth, static = _anchor(3)
    T_a = np.asarray(j_se3(jnp.asarray([0.01, 0.0, -0.02, 0.0, 0.01, 0.0], jnp.float32)))
    T_c = np.asarray(j_se3(jnp.asarray(TAUS[view], jnp.float32))) @ T_a
    # conditioning: no projected coordinate within 1e-4 of an integer, where
    # truncation decides the pixel (float32 on either side moves them by
    # about 1e-5 here)
    u, v = _projections(depth, static, T_a, T_c)
    coords = np.concatenate([u, v])
    assert np.abs(coords - np.round(coords)).min() >= 1e-4
    want = np.asarray(jkf.reproject_mask(jnp.asarray(depth), jnp.asarray(static),
                                         jnp.asarray(T_a), jnp.asarray(T_c),
                                         fx=FX, fy=FY, cx=CX, cy=CY))
    got = tkf.reproject_mask(torch.tensor(depth), torch.tensor(static), torch.tensor(T_a),
                             torch.tensor(T_c), fx=FX, fy=FY, cx=CX, cy=CY)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95, want.mean()


def test_reproject_mask_degenerate_anchor_keeps_everything():
    depth, static = _anchor(3)
    eye = torch.eye(4)
    for d, s in ((np.zeros_like(depth), static), (depth, np.zeros_like(static))):
        got = tkf.reproject_mask(torch.tensor(d), torch.tensor(s), eye, eye,
                                 fx=FX, fy=FY, cx=CX, cy=CY)
        want = np.asarray(jkf.reproject_mask(jnp.asarray(d), jnp.asarray(s), jnp.eye(4),
                                             jnp.eye(4), fx=FX, fy=FY, cx=CX, cy=CY))
        assert got.all() and want.all()


def test_map_chunk_extra_masks_matches_jax():
    """The tolerances of tests/test_torch_mapping.py, with a reprojection
    mask per window view (the invalid third view's unused); the replay
    views take none."""
    gmap, adam, store = _state()
    slots = np.array([1, 2, 0], np.int32)
    valid = np.array([True, True, False])
    opt_pose = np.array([True, False, False])
    pool = [3, 0, 2]
    pool_arr = np.zeros(8, np.int32)
    pool_arr[:len(pool)] = pool
    iters, step_after, base = 6, 2, 40
    masks = np.stack([np.asarray(jkf.reproject_mask(
        store.depths[0], store.motion[0], store.T_cw[0], store.T_cw[s],
        fx=J_INTR.fx, fy=J_INTR.fy, cx=J_INTR.cx, cy=J_INTR.cy)) for s in slots])
    # a band of each window view stays out of the loss
    masks[:, :, 8:20] = False
    key = jax.random.key(6)
    jcfg = jm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9, raster=J_RASTER)
    jres = jm.map_chunk(gmap, adam, store, jnp.asarray(slots), jnp.asarray(valid),
                        jnp.asarray(opt_pose), jnp.asarray(pool_arr), jnp.int32(len(pool)),
                        jm.init_pose_adam(3), key, jnp.int32(iters), jnp.int32(step_after),
                        jnp.int32(base), J_INTR, jcfg, extra_masks=jnp.asarray(masks))

    def port(extra_masks):
        return tm.map_chunk(convert.gaussian_map_from_arrays(gmap, "cpu"),
                            convert.adam_from_arrays(adam, "cpu"),
                            convert.store_from_arrays(store, "cpu"), slots, valid, opt_pose,
                            pool_arr, len(pool), tm.init_pose_adam(3, "cpu"),
                            _jax_picks(key, iters, len(pool)), iters, step_after, base,
                            T_INTR, tm.MappingConfig(num_window_views=3, num_random_views=2,
                                                     alpha=0.9),
                            extra_masks=extra_masks)

    tres = port(torch.tensor(masks))
    tg, jg = convert.gaussian_map_to_arrays(tres.gmap), jres.gmap
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = tg["params"][name], np.asarray(getattr(jg.params, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
    ts = convert.store_to_arrays(tres.store)
    np.testing.assert_allclose(ts["T_cw"], np.asarray(jres.store.T_cw), atol=1e-5)
    np.testing.assert_allclose(ts["exposure"], np.asarray(jres.store.exposure), atol=1e-5)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-4)
    # the masks were applied: without them the loss differs
    assert abs(port(None).final_loss - tres.final_loss) > 1e-4


def test_rm_initdy_run_matches_jax(one_torch_thread):  # noqa: F811
    cfg = _run_config(rm_initdy=True)
    jslam = JSLAM(JConfigDict.wrap(cfg), capacity=4096, max_keyframes=8,
                  raster=JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13))
    assert jslam.rm_initdy
    jslam.run()
    tslam = SLAM(ConfigDict.wrap(cfg), capacity=4096, max_keyframes=8, device="cpu",
                 draws=JaxDraws(0))
    seen = []
    reproject = tslam._reproject_masks
    tslam._reproject_masks = lambda key_opt: seen.append(reproject(key_opt)) or seen[-1]
    tslam.run()
    assert tslam.kf_indices == jslam.kf_indices == [0, 2, 4]
    # one set of masks per keyframe mapping phase, each masking something
    assert len(seen) == 2 and all((~m[0]).any() for m in seen)
    assert tslam.gmap.num_alive == int(jslam.gmap.num_alive)
    for i in range(6):
        err = np.linalg.norm(_centre(tslam.poses_est[i]) - _centre(jslam.poses_est[i]))
        assert err < 1e-3, (i, err)

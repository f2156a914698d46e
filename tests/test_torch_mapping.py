"""One `map_chunk` of the port against the JAX `map_chunk` from the same
state, with the same replay picks (drawn from the JAX key the way
fourdgs/slam/mapping.py:331-333 draws them): map parameters within 1e-4
relative, Adam moments, densification statistics and the stored poses and
exposures. The JAX side renders through its Pallas kernels in interpret
mode, so both sides reuse window-view bins alike. Also `window_visibility`
and `refine_picks` against their JAX counterparts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.geometry import se3_exp as j_se3
from fourdgs.models.gaussian_map import candidates_from_rgbd, empty_map, init_adam, insert
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam import mapping as jm
from fourdgs.slam.camera import Intrinsics as JIntrinsics
from fourdgs.slam.camera import make_frame as j_make_frame
from fourdgs.slam.keyframes import empty_store, store_keyframe
from fourdgs_torch import convert
from fourdgs_torch.slam import mapping as tm
from fourdgs_torch.slam.camera import Intrinsics

W, H = 64, 48
J_INTR = JIntrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=W, height=H)
T_INTR = Intrinsics(*J_INTR)
J_RASTER = JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13,
                         with_n_touched=False)


def _state(depth_jitter: float = 0.0):
    """A map spawned from a textured RGB-D view, and 4 keyframes at
    perturbed poses of that view (uid 0 in slot 0). The view's depth is 3 m
    with a 2 m box, plus seeded noise of `depth_jitter` m."""
    v, u = np.mgrid[0:H, 0:W]
    img = np.stack([0.5 + 0.4 * np.sin(u / 4.0), 0.5 + 0.4 * np.cos(v / 6.0),
                    0.5 + 0.3 * np.sin((u + v) / 7.0)]).astype(np.float32)
    depth = np.full((H, W), 3.0, np.float32)
    depth[15:35, 20:45] = 2.0
    depth += depth_jitter * np.random.default_rng(5).normal(size=(H, W)).astype(np.float32)
    cap = 1024
    cands = candidates_from_rgbd(jax.random.key(1), jnp.asarray(img), jnp.asarray(depth),
                                 jnp.eye(4), J_INTR.fx, J_INTR.fy, J_INTR.cx, J_INTR.cy,
                                 downsample=4, max_new=cap)
    gmap, adam, _ = insert(empty_map(cap), init_adam(cap), cands, kf_id=0)
    # clearly anisotropic scales: spawned Gaussians are exactly isotropic,
    # where the gradients of the isotropic loss |s - mean(s)| and of the
    # rotation have a sign set by rounding noise, and Adam's first steps
    # turn any gradient's sign into a full learning-rate step
    rng = np.random.default_rng(2)
    aniso = np.array([-0.4, 0.0, 0.4], np.float32)[rng.permuted(np.tile([0, 1, 2], (cap, 1)),
                                                                axis=1)]
    gmap = gmap._replace(params=gmap.params._replace(
        scaling=gmap.params.scaling + jnp.asarray(aniso) * gmap.alive[:, None]))
    store = empty_store(6, H, W)
    motion = np.ones((H, W), bool)
    motion[5:12, 40:50] = False
    taus = [np.zeros(6), [0.03, 0, 0, 0, 0.01, 0], [-0.02, 0.01, 0, 0, -0.01, 0.005],
            [0, -0.02, 0.01, 0.005, 0, 0]]
    for slot, tau in enumerate(taus):
        T = j_se3(jnp.asarray(tau, jnp.float32))
        frame = j_make_frame(slot, img, depth, np.eye(4), slot / 4, motion)
        store = store_keyframe(store, slot, frame, T, jnp.asarray([0.01 * slot, 0.0]))
    return gmap, adam, store


def _jax_picks(key, num_iters, pool_size):
    size = max(pool_size, 1)
    out = np.zeros((num_iters, 2), np.int64)
    for i in range(num_iters):
        ki = jax.random.fold_in(key, i)
        out[i, 0] = int(jax.random.randint(ki, (), 0, size))
        out[i, 1] = int(jax.random.randint(jax.random.fold_in(ki, 1), (), 0,
                                           max(size - 1, 1)))
    return out


@pytest.mark.parametrize("step_after,pool", [(-1, [3, 0]), (2, [3, 0, 2])])
def test_map_chunk_matches_jax(step_after, pool):
    gmap, adam, store = _state()
    slots = np.array([1, 2, 0], np.int32)
    valid = np.array([True, True, False])
    opt_pose = np.array([True, False, False])
    pool_arr = np.zeros(8, np.int32)
    pool_arr[:len(pool)] = pool
    # slot 2 is both a window view and in the pool in the second case
    iters, base = 6, 40
    key = jax.random.key(3)
    jcfg = jm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9,
                            raster=J_RASTER)
    jres = jm.map_chunk(gmap, adam, store, jnp.asarray(slots), jnp.asarray(valid),
                        jnp.asarray(opt_pose), jnp.asarray(pool_arr), jnp.int32(len(pool)),
                        jm.init_pose_adam(3), key, jnp.int32(iters), jnp.int32(step_after),
                        jnp.int32(base), J_INTR, jcfg)

    tcfg = tm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9)
    tres = tm.map_chunk(convert.gaussian_map_from_arrays(gmap, "cpu"), convert.adam_from_arrays(adam, "cpu"),
                        convert.store_from_arrays(store, "cpu"), slots, valid, opt_pose,
                        pool_arr, len(pool), tm.init_pose_adam(3, "cpu"),
                        _jax_picks(key, iters, len(pool)), iters, step_after, base,
                        T_INTR, tcfg)

    tg, jg = convert.gaussian_map_to_arrays(tres.gmap), jres.gmap
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = tg["params"][name], np.asarray(getattr(jg.params, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
    ta = convert.adam_to_arrays(tres.adam)
    assert int(ta["count"]) == int(jres.adam.count) == iters - max(step_after + 1, 0)
    for name in ("xyz", "opacity"):
        b = np.asarray(getattr(jres.adam.mu, name))
        np.testing.assert_allclose(ta["mu"][name], b, atol=1e-3 * np.abs(b).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(tg["denom"], np.asarray(jg.denom))
    np.testing.assert_allclose(tg["grad_accum"], np.asarray(jg.grad_accum), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jg.grad_accum)).max())
    ts = convert.store_to_arrays(tres.store)
    np.testing.assert_allclose(ts["T_cw"], np.asarray(jres.store.T_cw), atol=1e-5)
    np.testing.assert_allclose(ts["exposure"], np.asarray(jres.store.exposure), atol=1e-5)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-4)


def test_window_visibility_matches_jax():
    gmap, _, store = _state()
    slots, valid = np.array([0, 2, 3], np.int32), np.array([True, False, True])
    jcfg = jm.MappingConfig(num_window_views=3, raster=J_RASTER)
    jv = jm.window_visibility(gmap, store, jnp.asarray(slots), jnp.asarray(valid), J_INTR,
                              jcfg)
    tv = tm.window_visibility(convert.gaussian_map_from_arrays(gmap, "cpu"),
                              convert.store_from_arrays(store, "cpu"), slots, valid, T_INTR)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv[0].any() and not tv[1].any()


def test_refine_picks_matches_jax():
    pool = np.array([4, 9, 2, 7, 0, 0, 0, 0], np.int32)
    key = jax.random.key(5)
    u = np.asarray(jax.random.uniform(key, (pool.shape[0],)))
    for size, nv in ((4, 3), (4, 6), (2, 10)):
        js, jv = jm.refine_picks(key, jnp.asarray(pool), jnp.int32(size), nv)
        ts, tv = tm.refine_picks(u, pool, size, nv)
        np.testing.assert_array_equal(ts, np.asarray(js))
        np.testing.assert_array_equal(tv, np.asarray(jv))

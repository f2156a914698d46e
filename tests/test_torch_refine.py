"""One refine-mode `map_chunk` of the port (colour refinement) against the
JAX `map_chunk` with `MappingConfig(refine=True)` from the same state, the
views picked from the same draws (`refine_picks` on JAX's per-iteration
uniforms, as tests/test_torch_slam.py's `JaxDraws` replays them): map
parameters within the tolerances of tests/test_torch_mapping.py, Adam
moments, densification statistics, the loss, and poses and exposures
untouched.

The map is spawned from a wall whose depth carries 2 cm of noise. From the
mapping tests' exactly flat wall, Gaussians of one plane share a depth to
the last bit, so after a few steps moved them, their compositing order is
decided by rounding, differently in each package; under the SSIM term the
two then part after the second iteration (f_dc 3.5e-4 apart after 5, where
the noisy wall keeps every parameter within 1e-4 of its largest value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.ops import image as jimage
from fourdgs.slam import mapping as jm
from fourdgs_torch import convert
from fourdgs_torch.slam import mapping as tm
from tests.test_torch_mapping import J_INTR, J_RASTER, T_INTR, _state
from tests.test_torch_slam import jax_refine_draws, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the reference caches its SSIM window at the first call; made here outside
# any trace, as its command line makes it in eval_rendering before refining
# (a window first made inside the jitted refinement would leak a tracer)
jimage._gaussian_window(11, 1.5)


@pytest.mark.parametrize("pool,nv", [([3, 0, 2, 1], (3, 2)), ([2, 0], (8, 2))])
def test_refine_chunk_matches_jax(pool, nv):
    gmap, adam, store = _state(depth_jitter=0.02)
    vw, vr = nv
    pool_arr = np.zeros(8, np.int32)
    pool_arr[:len(pool)] = pool
    iters = 5
    key = jax.random.key(11)
    jcfg = jm.MappingConfig(num_window_views=vw, num_random_views=vr, alpha=0.9,
                            raster=J_RASTER, refine=True)
    jres = jm.map_chunk(gmap, adam, store, jnp.zeros(vw, jnp.int32), jnp.zeros(vw, bool),
                        jnp.zeros(vw, bool), jnp.asarray(pool_arr), jnp.int32(len(pool)),
                        jm.init_pose_adam(vw), key, jnp.int32(iters), jnp.int32(-1),
                        jnp.int32(0), J_INTR, jcfg)

    tcfg = tm.MappingConfig(num_window_views=vw, num_random_views=vr, alpha=0.9, refine=True)
    tres = tm.map_chunk(convert.gaussian_map_from_arrays(gmap, "cpu"),
                        convert.adam_from_arrays(adam, "cpu"),
                        convert.store_from_arrays(store, "cpu"), np.zeros(vw, np.int64),
                        np.zeros(vw, bool), np.zeros(vw, bool), pool_arr.astype(np.int64),
                        len(pool), tm.init_pose_adam(vw, "cpu"),
                        jax_refine_draws(key, iters, len(pool_arr)), iters, -1, 0, T_INTR, tcfg)

    tg, jg = convert.gaussian_map_to_arrays(tres.gmap), jres.gmap
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = tg["params"][name], np.asarray(getattr(jg.params, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
    # the map moved: refinement stepped it
    assert np.abs(tg["params"]["f_dc"] - np.asarray(gmap.params.f_dc)).max() > 1e-4
    ta = convert.adam_to_arrays(tres.adam)
    assert int(ta["count"]) == int(jres.adam.count) == iters
    for name in ("xyz", "opacity"):
        b = np.asarray(getattr(jres.adam.mu, name))
        np.testing.assert_allclose(ta["mu"][name], b, atol=1e-3 * np.abs(b).max(), err_msg=name)
    np.testing.assert_array_equal(tg["denom"], np.asarray(jg.denom))
    np.testing.assert_allclose(tg["grad_accum"], np.asarray(jg.grad_accum), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jg.grad_accum)).max())
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-4)
    # only the map steps: poses and exposures as they were, on both sides
    ts = convert.store_to_arrays(tres.store)
    np.testing.assert_array_equal(ts["T_cw"], np.asarray(store.T_cw))
    np.testing.assert_array_equal(ts["exposure"], np.asarray(store.exposure))
    np.testing.assert_array_equal(np.asarray(jres.store.T_cw), np.asarray(store.T_cw))


def test_refine_views_per_iteration():
    # every iteration renders min(pool, num_views) distinct pool slots: the
    # denominators count one per rendered view that sees a Gaussian
    gmap, adam, store = _state()
    pool = np.array([3, 0, 2, 1, 0, 0, 0, 0], np.int64)
    draws = np.random.default_rng(0).uniform(size=(2, 8)).astype(np.float32)
    cfg = tm.MappingConfig(num_window_views=2, num_random_views=1, refine=True)
    res = tm.map_chunk(convert.gaussian_map_from_arrays(gmap, "cpu"),
                       convert.adam_from_arrays(adam, "cpu"),
                       convert.store_from_arrays(store, "cpu"), np.zeros(2, np.int64),
                       np.zeros(2, bool), np.zeros(2, bool), pool, 4,
                       tm.init_pose_adam(2, "cpu"), draws, 2, -1, 0, T_INTR, cfg)
    assert res.gmap.denom.max() <= 2 * 3
    assert res.gmap.denom.max() >= 4

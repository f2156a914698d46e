"""The forward-backward consistency masks of the port
(fourdgs_torch/perception/flow.py `warp_flow`, `compute_fwdbwd_mask`, and
`FlowCache.get`'s 4-tuple) against the JAX package's
(fourdgs/perception/flow.py) on seeded flows: both go through the same
OpenCV bicubic remap, so they are held equal."""

import numpy as np
import pytest

from fourdgs.perception import flow as jf
from fourdgs_torch.perception import flow as tf


def _flows(seed, h, w, scale):
    """A smooth flow, its approximate inverse with noise, and outliers."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fwd = np.stack([scale * np.sin(yy / 7.0 + seed), scale * np.cos(xx / 9.0)], -1)
    bwd = -fwd + rng.normal(0, 0.3, fwd.shape)
    bad = rng.uniform(size=(h, w)) < 0.05
    bwd[bad] += rng.normal(0, 10 * scale, (int(bad.sum()), 2))
    return fwd.astype(np.float32), bwd.astype(np.float32)


@pytest.mark.parametrize("seed,h,w,scale", [(0, 24, 32, 2.0), (1, 48, 64, 6.0),
                                            (2, 37, 53, 15.0)])
def test_warp_flow_matches(seed, h, w, scale):
    fwd, bwd = _flows(seed, h, w, scale)
    got = tf.warp_flow(bwd, fwd)
    np.testing.assert_array_equal(got, jf.warp_flow(bwd, fwd))
    assert got.shape == (h, w, 2) and np.abs(got).max() > 0


@pytest.mark.parametrize("seed,h,w,scale", [(0, 24, 32, 2.0), (1, 48, 64, 6.0),
                                            (2, 37, 53, 15.0)])
def test_fwdbwd_masks_match(seed, h, w, scale):
    fwd, bwd = _flows(seed, h, w, scale)
    got = tf.compute_fwdbwd_mask(fwd, bwd)
    want = jf.compute_fwdbwd_mask(fwd, bwd)
    for g, x in zip(got, want):
        assert g.dtype == bool and g.shape == (h, w)
        np.testing.assert_array_equal(g, x)
    # the data has consistent and inconsistent pixels
    assert 0.0 < got[0].mean() < 1.0 and 0.0 < got[1].mean() < 1.0


def test_flow_cache_returns_the_reference_tuple():
    fwd, bwd = _flows(3, 30, 40, 4.0)
    calls = []

    def provider(uid1, uid2, img1, img2):
        calls.append((uid1, uid2, img1, img2))
        return fwd, bwd

    got = tf.FlowCache(provider).get(5, 2, "img5", "img2")
    cache = tf.FlowCache(provider)
    cache.get(5, 2, "img5", "img2")
    cache.get(5, 2, "img5", "img2")
    want = jf.FlowCache(lambda *a: (fwd, bwd)).get(5, 2, "img5", "img2")
    assert len(got) == len(want) == 4
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert got[0].shape == (2, 30, 40)
    # each pair once per cache, the view's image first
    assert calls == [(5, 2, "img5", "img2")] * 2

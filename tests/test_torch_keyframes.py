"""Parity of the port's host-side pieces of the slice with the JAX
reference: the keyframe store and window policy (slam/keyframes.py), the
densify/reset cadence (slam/cadence.py), camera frames (slam/camera.py),
ATE (eval/ate.py) and the synthetic sequence's frames (data/synthetic.py,
rendered by each package's own rasterizer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.data.synthetic import SyntheticDataset as JSynthetic
from fourdgs.eval.ate import evaluate_ate as j_ate
from fourdgs.geometry import se3_exp as j_se3
from fourdgs.slam import keyframes as jk
from fourdgs.slam.cadence import mapping_cadence as j_cadence
from fourdgs.slam.camera import Intrinsics as JIntrinsics
from fourdgs.slam.camera import make_frame as j_make_frame
from fourdgs_torch.data.synthetic import SyntheticDataset as TSynthetic
from fourdgs_torch.eval.ate import evaluate_ate as t_ate
from fourdgs_torch.ops.rasterize.preprocess import ALPHA_MIN
from fourdgs_torch.slam import keyframes as tk
from fourdgs_torch.slam.cadence import mapping_cadence as t_cadence
from fourdgs_torch.slam.camera import make_frame as t_make_frame

H, W = 24, 32


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(j_se3(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32)), np.float64)
            for _ in range(n)]


def test_store_keyframe_and_frames_match():
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    depth = rng.uniform(0.5, 3, (H, W)).astype(np.float32)
    motion = rng.uniform(size=(H, W)) > 0.2
    jf = j_make_frame(5, image, depth, np.eye(4), 0.5, motion)
    tf = t_make_frame(5, image, depth, np.eye(4), 0.5, motion, device="cpu")
    np.testing.assert_array_equal(tf.grad_mask.numpy(), np.asarray(jf.grad_mask))
    T, exp = _poses(1)[0].astype(np.float32), np.array([0.1, -0.05], np.float32)
    js = jk.store_keyframe(jk.empty_store(3, H, W), 2, jf, jnp.asarray(T), exp)
    ts = tk.store_keyframe(tk.empty_store(3, H, W, "cpu"), 2, tf, T, exp)
    for f in jk.KeyframeStore._fields:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_window_policy_matches():
    rng = np.random.default_rng(2)
    poses = dict(enumerate(_poses(9, 3)))
    vis = {k: rng.uniform(size=200) > rng.uniform(0.2, 0.8) for k in poses}
    window = [7, 6, 5, 3, 2, 1, 0]
    for init in (True, False):
        for size in (8, 5):
            a = tk.add_to_window(8, vis[8], vis, list(window), poses, 0.3, size, init)
            b = jk.add_to_window(8, vis[8], vis, list(window), poses, 0.3, size, init)
            assert a == b
    for i in range(1, 9):
        args = (poses[i], poses[0], 2.0, vis[i], vis[0], 0.08, 0.05, 0.9)
        assert tk.is_keyframe(*args) == jk.is_keyframe(*args)
    intr = JIntrinsics(60.0, 60.0, 39.5, 29.5, 80, 60)   # room for the 20 px edge
    depth = rng.uniform(1, 3, (60, 80)).astype(np.float32)
    a = tk.keyframe_selection_overlap(depth, poses[0], intr, poses, 7, 5,
                                      np.random.default_rng(4), sample_pixels=300)
    b = jk.keyframe_selection_overlap(depth, poses[0], intr, poses, 7, 5,
                                      np.random.default_rng(4), sample_pixels=300)
    assert a == b and len(a) > 0


@pytest.mark.parametrize("total,step_after,count,every,offset,reset", [
    (200, 100, 0, 150, 50, 2001),
    (200, 100, 1990, 150, 50, 2001),
    (1050, -1, 0, 100, 0, 500),
    (15, -1, 37, 15, 0, 20001),
    (30, 5, 140, 150, 200, 50),
])
def test_mapping_cadence_matches(total, step_after, count, every, offset, reset):
    a = list(t_cadence(total, step_after, count, every, offset, reset))
    b = list(j_cadence(total, step_after, count, every, offset, reset))
    assert a == b and sum(c for c, _, _ in a) == total


def test_evaluate_ate_matches():
    gt = _poses(12, 5)
    est = [T @ np.asarray(j_se3(jnp.asarray(np.random.default_rng(i).normal(0, 0.01, 6),
                                            jnp.float32)))
           for i, T in enumerate(gt)]
    a, b = t_ate(est, gt), j_ate(est, gt)
    for k in ("rmse", "mean", "median", "std", "min", "max"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, err_msg=k)


def _close_but_for_threshold_flips(a, b, atol, scale):
    """All but a few pixels within `atol`. A pair whose alpha lies within
    float noise of the 1/255 floor is valid on one side only, which moves
    its pixel by up to alpha * T * value < 1/255 of the value's range."""
    bad = np.abs(a - b) > atol
    assert bad.mean() < 1e-3, bad.sum()
    np.testing.assert_allclose(a, b, atol=ALPHA_MIN * scale)


def test_synthetic_frames_match():
    # above 96x96 so that the JAX sequence renders through its Pallas
    # kernels, as the port renders through its compositor
    w, h = 112, 100
    cfg = {"Dataset": {"type": "synthetic", "num_frames": 5, "points_per_wall": 300,
                       "Calibration": {"fx": 90.0, "fy": 90.0, "cx": (w - 1) / 2,
                                       "cy": (h - 1) / 2, "width": w, "height": h}}}
    jd, td = JSynthetic(None, "", cfg), TSynthetic(None, "", cfg, "cpu")
    assert len(jd) == len(td) == 5
    for i in (0, 3):
        ji, jdep, jT, jm = jd[i]
        ti, tdep, tT, tm = td[i]
        np.testing.assert_allclose(tT, jT, rtol=0, atol=0)
        np.testing.assert_array_equal(tm, jm)
        _close_but_for_threshold_flips(ti, ji, 2e-5, 1.0)
        _close_but_for_threshold_flips(tdep, jdep, 2e-4, float(jdep.max()))
    assert torch.device("cpu") == td.device

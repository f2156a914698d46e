"""Parity of fourdgs_torch.geometry with fourdgs.geometry on seeded inputs
(tolerance 1e-5 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs import geometry as jg
from fourdgs.geometry import projection as jproj
from fourdgs_torch import geometry as tg
from fourdgs_torch.geometry import projection as tproj

RTOL, ATOL = 1e-5, 1e-6


def _rng():
    return np.random.default_rng(0)


def _taus():
    r = _rng()
    taus = r.normal(0, 0.3, (16, 6)).astype(np.float32)
    taus[0] = 0.0
    taus[1, 3:] = 1e-7   # the small-angle Taylor branch
    return taus


def _quats():
    return _rng().normal(size=(16, 4)).astype(np.float32)


def _rotmats():
    q = np.asarray(jg.quat_normalize(jnp.asarray(_quats())))
    return np.asarray(jg.quat_to_rotmat(jnp.asarray(q)))


CASES = {
    "skew": (lambda m: m.skew, lambda: (_rng().normal(size=(8, 3)).astype(np.float32),)),
    "so3_exp": (lambda m: m.so3_exp, lambda: (_taus()[:, 3:],)),
    "so3_log": (lambda m: m.so3_log, lambda: (_rotmats(),)),
    "se3_V": (lambda m: m.se3_V, lambda: (_taus()[:, 3:],)),
    "se3_exp": (lambda m: m.se3_exp, lambda: (_taus(),)),
    "se3_apply": (lambda m: m.se3_apply, lambda: (
        np.asarray(jg.se3_exp(jnp.asarray(_taus()[2]))),
        _rng().normal(size=(10, 3)).astype(np.float32))),
    "quat_normalize": (lambda m: m.quat_normalize, lambda: (_quats(),)),
    "quat_to_rotmat": (lambda m: m.quat_to_rotmat, lambda: (
        np.asarray(jg.quat_normalize(jnp.asarray(_quats()))),)),
    "quat_multiply": (lambda m: m.quat_multiply, lambda: (_quats(), _quats()[::-1].copy())),
    "rotmat_to_quat": (lambda m: m.rotmat_to_quat, lambda: (_rotmats(),)),
    "sh0_to_rgb": (lambda m: m.sh0_to_rgb, lambda: (_rng().normal(size=(9, 3)).astype(np.float32),)),
    "rgb_to_sh0": (lambda m: m.rgb_to_sh0, lambda: (_rng().uniform(size=(9, 3)).astype(np.float32),)),
    "backproject_depth": (lambda m: m.backproject_depth, lambda: (
        _rng().uniform(0.5, 4.0, (12, 16)).astype(np.float32), 20.0, 21.0, 7.5, 5.5,
        np.asarray(jg.se3_exp(jnp.asarray(_taus()[3]))))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_matches_jax(name):
    pick, make = CASES[name]
    args = make()
    want = np.asarray(pick(jg)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = pick(tg)(*[torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=name)


def test_update_pose_matches_jax():
    tau = _taus()[4] * 1e-3
    T0 = np.asarray(jg.se3_exp(jnp.asarray(_taus()[5])))
    want_T, want_c = jg.update_pose(jnp.asarray(tau), jnp.asarray(T0))
    got_T, got_c = tg.update_pose(torch.tensor(tau), torch.tensor(T0))
    np.testing.assert_allclose(got_T.numpy(), np.asarray(want_T), rtol=RTOL, atol=ATOL)
    assert bool(got_c) == bool(want_c)


def test_projection_matrix_and_fov_match_jax():
    args = (535.4, 539.2, 320.1, 247.6, 640, 480)
    np.testing.assert_allclose(
        tproj.projection_matrix(*args, device="cpu").numpy(),
        np.asarray(jproj.projection_matrix(*args)), rtol=RTOL, atol=ATOL,
    )
    assert tproj.focal2fov(535.4, 640) == jproj.focal2fov(535.4, 640)
    assert tproj.fov2focal(1.1, 640) == jproj.fov2focal(1.1, 640)
    T = np.asarray(jg.se3_exp(jnp.asarray(_taus()[6])))
    np.testing.assert_allclose(
        tproj.camera_center(torch.as_tensor(T)).numpy(),
        np.asarray(jproj.camera_center(jnp.asarray(T))), rtol=RTOL, atol=ATOL,
    )

"""The HexPlane field (fourdgs_torch/models/hexplane.py) against the JAX
reference on the same seeded parameters (carried by convert): features,
deform, the dynamic mask and the three plane regularizers within float32
atol 1e-5, and their gradients with respect to every parameter and the
points within 1e-4 of each field's largest magnitude, at a reduced
resolution with points on the box's faces and outside it. Then the
reference's own cases (tests/test_hexplane.py) run against the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.models import hexplane as jh
from fourdgs_torch import convert
from fourdgs_torch.models import hexplane as th
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, tol, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=err_msg)


def _pair(res=(8, 8, 8, 5), multires=(1, 2), seed=0, heads=0.0):
    """A reference field and the port's copy; `heads` adds a normal draw
    of that deviation to the output heads so that the deltas are not all
    near 0."""
    jhp = jh.init_hexplane(jax.random.key(seed), resolution=res, multires=multires,
                           out_dim=8, width=16)
    if heads:
        rng = np.random.default_rng(seed)
        jhp = jhp._replace(**{f: getattr(jhp, f) + jnp.asarray(
            rng.normal(0, heads, getattr(jhp, f).shape), jnp.float32)
            for f in ("dx_w", "ds_w", "dr_w", "dx_b")})
    return jhp, convert.hexplane_from_arrays(jhp, "cpu")


def _points(n=96, seed=1):
    """Points inside the [-2, 2] box, on its faces (uv 0 and 1) and
    outside it, and some on texel corners."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.9, 1.9, (n, 3)).astype(np.float32)
    p[:8] = [[-2, -2, -2], [2, 2, 2], [-2, 2, 0.3], [2, -2, -0.7],
             [2.5, 0.1, -3.0], [-2.6, 2.2, 1.0], [0.0, 0.0, 0.0], [1.0, -1.0, 0.5]]
    return p


def test_grid_sample_values_and_gradients_at_edges():
    # uv at 0, 1, on texel corners, inside and outside [0, 1]
    rng = np.random.default_rng(2)
    plane = rng.uniform(0.1, 0.5, (4, 5, 7)).astype(np.float32)
    uv = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0.25], [1 / 6, 0.75],
                   [-0.3, 0.4], [1.2, 0.6], [0.3, -0.1], [0.7, 1.5], [0.33, 0.61]], np.float32)
    cot = rng.normal(size=(uv.shape[0], 4)).astype(np.float32)

    def jf(p, u):
        return jnp.sum(jh._grid_sample_2d(p, u) * cot)

    jv = jh._grid_sample_2d(jnp.asarray(plane), jnp.asarray(uv))
    jgp, jgu = jax.grad(jf, argnums=(0, 1))(jnp.asarray(plane), jnp.asarray(uv))
    tp, tu = _t(plane).requires_grad_(True), _t(uv).requires_grad_(True)
    tv = th._grid_sample_2d(tp, tu)
    tgp, tgu = torch.autograd.grad(torch.sum(tv * _t(cot)), (tp, tu))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    _close(tgp.numpy(), jgp, 1e-4, "plane")
    _close(tgu.numpy(), jgu, 1e-4, "uv")
    # at the faces the reference's gradient in uv is half the inside one,
    # and 0 outside: the port's clip gives the same
    assert np.all(np.asarray(jgu)[6, 0] == 0) and np.all(tgu.numpy()[6, 0] == 0)


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_features_deform_mask_match(t):
    jhp, thp = _pair(heads=0.05)
    pts = _points()
    jf = jh.hexplane_features(jhp, jnp.asarray(pts), jnp.float32(t))
    tf = th.hexplane_features(thp, _t(pts), torch.tensor(t))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    for a, b in zip(th.hexplane_deform(thp, _t(pts), torch.tensor(t)),
                    jh.hexplane_deform(jhp, jnp.asarray(pts), jnp.float32(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for th_ in (1e-3, 0.05):
        jm = jh.get_dynamic_mask(jhp, jnp.asarray(pts), jnp.float32(t), th_, th_, th_)
        tm = th.get_dynamic_mask(thp, _t(pts), torch.tensor(t), th_, th_, th_)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _named(hp, leaves_of):
    names = [f"planes{i}" for i in range(len(hp.planes))] + list(jh.HexPlaneParams._fields[1:])
    return dict(zip(names, leaves_of(hp)))


def _jleaves(hp):
    return list(hp.planes) + [getattr(hp, f) for f in jh.HexPlaneParams._fields[1:]]


def _tleaves(hp):
    return list(hp.planes) + [getattr(hp, f) for f in th.HexPlaneParams._fields[1:]]


def _req(hp):
    return th.HexPlaneParams(*(tuple(p.clone().requires_grad_(True) for p in f)
                               if isinstance(f, tuple) else f.clone().requires_grad_(True)
                               for f in hp))


def test_deform_gradients_match():
    jhp, thp = _pair(heads=0.05, seed=3)
    pts = _points(seed=4)
    cot = [np.random.default_rng(5 + i).normal(size=(pts.shape[0], d)).astype(np.float32)
           for i, d in enumerate((3, 3, 4))]

    def jloss(hp, x):
        return sum(jnp.sum(o * c) for o, c in zip(jh.hexplane_deform(hp, x, jnp.float32(0.4)),
                                                    cot))

    jgh, jgx = jax.grad(jloss, argnums=(0, 1))(jhp, jnp.asarray(pts))
    thr, tx = _req(thp), _t(pts).requires_grad_(True)
    tl = sum(torch.sum(o * _t(c)) for o, c in zip(th.hexplane_deform(thr, tx, 0.4), cot))
    grads = torch.autograd.grad(tl, _tleaves(thr) + [tx])
    want = _named(jgh, _jleaves)
    for (name, b), a in zip(want.items(), grads[:-1]):
        _close(a.numpy(), b, 1e-4, name)
    _close(grads[-1].numpy(), jgx, 1e-4, "xyz")
    assert float(np.abs(np.asarray(jgx)).max()) > 0


@pytest.mark.parametrize("term", ["plane_tv_loss", "time_smoothness_loss",
                                  "l1_time_planes_loss"])
def test_regularizers_and_gradients_match(term):
    jhp, thp = _pair(seed=6)
    jv, jg = jax.value_and_grad(getattr(jh, term))(jhp)
    thr = _req(thp)
    tv = getattr(th, term)(thr)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=0, atol=1e-5)
    grads = torch.autograd.grad(tv, list(thr.planes), allow_unused=True)
    for i, (a, b, p) in enumerate(zip(grads, jg.planes, thr.planes)):
        a = torch.zeros_like(p) if a is None else a   # a plane the term does not read
        _close(a.numpy(), b, 1e-4, f"plane {i}")
    assert sum(float(np.abs(np.asarray(b)).max()) > 0 for b in jg.planes) == 6


def test_init_shapes_and_ranges():
    hp = th.init_hexplane(torch.Generator().manual_seed(0), resolution=(8, 8, 8, 5),
                          multires=(1, 2), out_dim=8, width=16)
    jhp = jh.init_hexplane(jax.random.key(0), resolution=(8, 8, 8, 5), multires=(1, 2),
                           out_dim=8, width=16)
    for a, b in zip(_tleaves(hp), _jleaves(jhp)):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == torch.float32
    planes = torch.cat([p.reshape(-1) for p in hp.planes])
    assert 0.1 <= float(planes.min()) and float(planes.max()) <= 0.5
    assert float(hp.dx_w.abs().max()) < 1e-4


# ---- the reference's own cases (tests/test_hexplane.py) against the port


def _hp(res=(8, 8, 8, 5), multires=(1, 2)):
    return th.init_hexplane(torch.Generator().manual_seed(0), resolution=res,
                            multires=multires, out_dim=8, width=16)


def test_grid_sample_corners_and_center():
    plane = torch.arange(12.0).reshape(1, 3, 4)
    out = th._grid_sample_2d(plane, torch.tensor([[0.0, 0.0], [1.0, 1.0], [1 / 3, 0.5]]))
    np.testing.assert_allclose(float(out[0, 0]), 0.0)
    np.testing.assert_allclose(float(out[1, 0]), 11.0)
    np.testing.assert_allclose(float(out[2, 0]), 5.0, atol=1e-5)


def test_feature_shapes_and_near_identity():
    hp = _hp()
    xyz = _t(np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32))
    assert th.hexplane_features(hp, xyz, 0.5).shape == (64, 16)
    dx, ds, dr = th.hexplane_deform(hp, xyz, 0.5)
    assert dx.shape == (64, 3) and ds.shape == (64, 3) and dr.shape == (64, 4)
    assert float(dx.abs().max()) < 1e-2


def test_dynamic_mask_thresholds():
    hp = _hp()
    xyz = torch.zeros((16, 3))
    mask = th.get_dynamic_mask(hp, xyz, 0.5)
    assert mask.shape == (16,) and not bool(mask.any())
    assert bool(th.get_dynamic_mask(hp._replace(dx_b=hp.dx_b + 1.0), xyz, 0.5).all())


def test_regularizers_zero_on_constant_planes():
    hp = _hp()
    for f in (th.plane_tv_loss, th.time_smoothness_loss, th.l1_time_planes_loss):
        assert np.isfinite(float(f(hp)))
    ident = hp._replace(planes=tuple(torch.ones_like(p) for p in hp.planes))
    assert float(th.plane_tv_loss(ident)) == 0.0
    assert float(th.time_smoothness_loss(ident)) == 0.0
    assert float(th.l1_time_planes_loss(ident)) == 0.0


def test_field_fits_motion():
    """Adam fits the field to a time-varying translation within the
    reference's 200 steps."""
    torch.manual_seed(0)
    hp = _req(_hp(res=(8, 8, 8, 8)))
    pts = _t(np.random.default_rng(1).uniform(-1, 1, (128, 3)).astype(np.float32))
    params = _tleaves(hp)[:-2]   # the box stays fixed

    def loss_fn(t):
        dx, _, _ = th.hexplane_deform(hp, pts, t)
        return torch.mean((dx - torch.tensor([0.3, 0.0, -0.2]) * t) ** 2)

    opt = torch.optim.Adam(params, lr=5e-3)
    l0 = float(loss_fn(1.0))
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        opt.zero_grad()
        loss_fn(float(torch.rand((), generator=gen))).backward()
        opt.step()
    l1 = float(loss_fn(1.0))
    assert l1 < 0.1 * l0, (l0, l1)

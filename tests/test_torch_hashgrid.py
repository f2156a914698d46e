"""The hash-grid field (fourdgs_torch/models/hashgrid.py) against the JAX
reference: `_hash3` exactly equal on int32 coordinates whose products wrap
2^32 (negative ones too), `hash_encode` and `hash_deform` within float32
atol 1e-5 and their gradients within 1e-4 of each field's largest
magnitude, at 8 levels of 2^13 entries, on points inside, on and outside
the box. Then the reference's own cases (tests/test_hashgrid.py) run
against the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.models import hashgrid as jg
from fourdgs_torch import convert
from fourdgs_torch.models import hashgrid as tg
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, tol, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=err_msg)


@pytest.mark.parametrize("table_size", [1 << 13, 1 << 17, 1000003])
def test_hash3_exact(table_size):
    rng = np.random.default_rng(table_size)
    c = rng.integers(-(1 << 31), (1 << 31) - 1, (3, 4096), dtype=np.int64).astype(np.int32)
    c[:, :4] = [[0, 953, 954, (1 << 31) - 1], [0, 1, 1 << 20, -1], [0, 7, -(1 << 31), 5]]
    want = np.asarray(jg._hash3(*(jnp.asarray(x) for x in c), table_size))
    got = tg._hash3(*(_t(x) for x in c), table_size)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < table_size


def _pair(seed=0, heads=0.0, **kw):
    jhp = jg.init_hashgrid(jax.random.key(seed), **kw)
    rng = np.random.default_rng(seed)
    # tables large enough that the features matter; heads that move
    jhp = jhp._replace(tables=tuple(jnp.asarray(rng.uniform(-0.5, 0.5, t.shape), jnp.float32)
                                    for t in jhp.tables))
    if heads:
        jhp = jhp._replace(**{f: getattr(jhp, f) + jnp.asarray(
            rng.normal(0, heads, getattr(jhp, f).shape), jnp.float32)
            for f in ("dx_w", "ds_w", "dr_w")})
    return jhp, convert.hashgrid_from_arrays(jhp, "cpu")


def _points(n=200, seed=1):
    p = np.random.default_rng(seed).uniform(-1.9, 1.9, (n, 3)).astype(np.float32)
    p[:6] = [[-2, -2, -2], [2, 2, 2], [2.5, 0.0, -3.0], [0.0, 0.0, 0.0], [-2, 1, 2],
             [0.25, -0.5, 1.0]]
    return p


def _leaves(hp, fields):
    return list(hp.tables) + [getattr(hp, f) for f in fields[1:-2]]


def test_hash_encode_and_gradients_match():
    jhp, thp = _pair(n_levels=8, log2_table=13)
    pts = _points()
    cot = np.random.default_rng(2).normal(size=(pts.shape[0], 16)).astype(np.float32)
    jf = jg.hash_encode(jhp, jnp.asarray(pts))
    tf = tg.hash_encode(thp, _t(pts))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    jgt, jgx = jax.grad(lambda hp, x: jnp.sum(jg.hash_encode(hp, x) * cot),
                        argnums=(0, 1))(jhp, jnp.asarray(pts))
    tabs = [t.clone().requires_grad_(True) for t in thp.tables]
    tx = _t(pts).requires_grad_(True)
    out = tg.hash_encode(thp._replace(tables=tuple(tabs)), tx)
    grads = torch.autograd.grad(torch.sum(out * _t(cot)), tabs + [tx])
    for i, (a, b) in enumerate(zip(grads[:-1], jgt.tables)):
        _close(a.numpy(), b, 1e-4, f"table {i}")
    _close(grads[-1].numpy(), jgx, 1e-4, "xyz")


@pytest.mark.parametrize("t", [0.0, 0.63])
def test_hash_deform_and_gradients_match(t):
    jhp, thp = _pair(seed=3, heads=0.05, n_levels=8, log2_table=13)
    pts = _points(seed=4)
    cot = [np.random.default_rng(5 + i).normal(size=(pts.shape[0], d)).astype(np.float32)
           for i, d in enumerate((3, 4, 3))]
    for a, b in zip(tg.hash_deform(thp, _t(pts), t),
                    jg.hash_deform(jhp, jnp.asarray(pts), jnp.float32(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)

    def jloss(hp, x):
        return sum(jnp.sum(o * c) for o, c in zip(jg.hash_deform(hp, x, jnp.float32(t)), cot))

    jgh, jgx = jax.grad(jloss, argnums=(0, 1))(jhp, jnp.asarray(pts))
    thr = tg.HashGridParams(*(tuple(p.clone().requires_grad_(True) for p in f)
                              if isinstance(f, tuple) else f.clone().requires_grad_(True)
                              for f in thp))
    tx = _t(pts).requires_grad_(True)
    tl = sum(torch.sum(o * _t(c)) for o, c in zip(tg.hash_deform(thr, tx, t), cot))
    fields = tg.HashGridParams._fields
    grads = torch.autograd.grad(tl, _leaves(thr, fields) + [tx])
    names = [f"table{i}" for i in range(8)] + list(fields[1:-2])
    for name, a, b in zip(names, grads[:-1], _leaves(jgh, fields)):
        _close(a.numpy(), b, 1e-4, name)
    _close(grads[-1].numpy(), jgx, 1e-4, "xyz")


def test_time_enc_and_init_match_shapes():
    np.testing.assert_allclose(tg._time_enc(0.37, 5).numpy(),
                               np.asarray(jg._time_enc(jnp.float32(0.37), 5)), rtol=0, atol=1e-6)
    hp = tg.init_hashgrid(torch.Generator().manual_seed(0), n_levels=6, log2_table=12)
    jhp = jg.init_hashgrid(jax.random.key(0), n_levels=6, log2_table=12)
    for f in tg.HashGridParams._fields:
        a, b = getattr(hp, f), getattr(jhp, f)
        if f == "tables":
            assert [tuple(x.shape) for x in a] == [tuple(x.shape) for x in b]
            assert max(float(x.abs().max()) for x in a) <= 1e-4
        else:
            assert tuple(a.shape) == tuple(b.shape), f


# ---- the reference's own cases (tests/test_hashgrid.py) against the port


def test_hash_encode_shapes_and_continuity():
    hp = tg.init_hashgrid(torch.Generator().manual_seed(0), n_levels=6, log2_table=12)
    xyz = _t(np.random.default_rng(0).uniform(-1, 1, (32, 3)).astype(np.float32))
    f = tg.hash_encode(hp, xyz)
    assert f.shape == (32, 12)
    assert float((f - tg.hash_encode(hp, xyz + 1e-4)).abs().max()) < 1e-4


def test_hash_deform_near_identity_and_fits():
    hp = tg.init_hashgrid(torch.Generator().manual_seed(1), n_levels=8, log2_table=13)
    pts = _t(np.random.default_rng(1).uniform(-1, 1, (256, 3)).astype(np.float32))
    dx, _, _ = tg.hash_deform(hp, pts, 0.5)
    assert float(dx.abs().max()) < 1e-2
    hp = tg.HashGridParams(*(tuple(p.clone().requires_grad_(True) for p in f)
                             if isinstance(f, tuple) else f.clone().requires_grad_(True)
                             for f in hp))
    params = _leaves(hp, tg.HashGridParams._fields)   # the box stays fixed

    def loss_fn(t):
        dx, _, _ = tg.hash_deform(hp, pts, t)
        return torch.mean((dx - torch.tensor([0.2, -0.1, 0.0]) * t) ** 2)

    opt = torch.optim.Adam(params, lr=5e-3)
    l0 = float(loss_fn(1.0))
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        opt.zero_grad()
        loss_fn(float(torch.rand((), generator=gen))).backward()
        opt.step()
    l1 = float(loss_fn(1.0))
    assert l1 < 0.1 * l0, (l0, l1)

"""The deformation field of the 4D path (models/deform.py and the KNN ops
it uses) against the JAX reference on the same inputs: KNN picks exactly
equal, distances within 1e-5 relative; FPS picks equal from
the same start; the MLP, blend weights and warp within 1e-5 of the
largest magnitude; ARAP and elastic values within 1e-5 relative and their
gradients with respect to the MLP, radius and node weight within 1e-5 of
the largest gradient magnitude, and within 1e-4 of each tensor's own
largest magnitude where that is not itself rounding noise (a bias whose
true gradient is 0). M = 32 nodes, N = 500 points, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.models import deform as jd
from fourdgs.ops import knn as jk
from fourdgs_torch import convert
from fourdgs_torch.models import deform as td
from fourdgs_torch.ops import knn as tk
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M, N = 32, 500


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, rtol=1e-5, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-30),
                               err_msg=err_msg)


def _field(seed=0, node_num=24):
    """A JAX control-node field on N points (the first 300 valid), its
    heads scaled up so that the nodes move visibly over time, and the
    port's copy of it."""
    rng = np.random.default_rng(seed)
    pts = jnp.asarray(rng.normal(0, 0.5, (N, 3)), jnp.float32)
    valid = jnp.arange(N) < 300
    cn = jd.init_nodes(jax.random.key(seed), M, pts, valid, node_num=node_num)
    big = [jnp.asarray(rng.normal(0, 0.05, np.shape(h[0])), jnp.float32)
           for h in (cn.mlp.head_warp, cn.mlp.head_scaling, cn.mlp.head_rotation)]
    mlp = cn.mlp._replace(head_warp=(big[0], cn.mlp.head_warp[1]),
                          head_scaling=(big[1], cn.mlp.head_scaling[1]),
                          head_rotation=(big[2], cn.mlp.head_rotation[1]))
    cn = cn._replace(mlp=mlp, radius_raw=cn.radius_raw + jnp.asarray(rng.normal(0, 0.1, M),
                                                                      jnp.float32),
                     weight_raw=jnp.asarray(rng.normal(0, 1.0, (M, 1)), jnp.float32))
    return pts, valid, cn, convert.control_nodes_from_arrays(cn, "cpu")


@pytest.mark.parametrize("k", [3, 11])
def test_knn_indices_and_weights_match(k, monkeypatch):
    # the neighbours of N queries among the control nodes (8 of 32
    # invalid), and the blend weights the warp takes from them; in chunks
    # of 128 queries, so that the port's chunks meet
    monkeypatch.setattr(tk, "CHUNK", 128)
    q = np.random.default_rng(k).normal(size=(N, 3)).astype(np.float32)
    _, _, jcn, tcn = _field(seed=k)
    jd2, ji = jk.knn_indices(jnp.asarray(q), jcn.nodes, k, ref_valid=jcn.valid)
    td2, ti = tk.knn_indices(_t(q), tcn.nodes, k, ref_valid=tcn.valid)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-6)
    jw, ji = jd.nn_weights(jcn, jnp.asarray(q), k)
    tw, ti = td.nn_weights(tcn, _t(q), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw.detach().numpy(), jw, err_msg="nn_weights")


def test_farthest_point_sample_matches():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(N, 3)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.4
    key = jax.random.key(7)
    sel = jk.farthest_point_sample(jnp.asarray(pts), jnp.asarray(valid), 64, key)
    vf = jnp.asarray(valid, jnp.float32)
    start = int(jax.random.choice(key, N, p=vf / jnp.maximum(jnp.sum(vf), 1.0)))
    tsel = tk.farthest_point_sample(_t(pts), _t(valid), 64, torch.tensor(start))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))
    assert valid[tsel.numpy()].all() and len(set(tsel.tolist())) == 64


def test_init_nodes_and_mlp_match():
    rng = np.random.default_rng(4)
    pts = jnp.asarray(rng.normal(0, 0.5, (N, 3)), jnp.float32)
    valid = jnp.asarray(rng.uniform(size=N) > 0.5)
    key = jax.random.key(2)
    jcn = jd.init_nodes(key, M, pts, valid, node_num=20)
    k1, k2 = jax.random.split(key)
    vf = valid.astype(jnp.float32)
    start = jax.random.choice(k1, N, p=vf / jnp.maximum(jnp.sum(vf), 1.0))
    jmlp = convert.control_nodes_from_arrays(jcn._replace(mlp=jd.init_mlp(k2)), "cpu").mlp
    tcn = td.init_nodes(M, _t(pts), _t(valid), 20, torch.tensor(int(start)),
                        td.init_mlp(list(jmlp.weights),
                                    [h[0] / std for h, (_, _, std) in
                                     zip((jmlp.head_warp, jmlp.head_scaling,
                                          jmlp.head_rotation), td.HEADS)]))
    got = convert.control_nodes_to_arrays(tcn)
    want = convert.control_nodes_to_arrays(convert.control_nodes_from_arrays(jcn, "cpu"))
    for name in ("nodes", "radius_raw", "weight_raw", "valid"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for a, b in zip(td.leaves(td.cn_floats(tcn)), td.leaves(convert.control_nodes_from_arrays(
            jcn, "cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)
    assert [tuple(w.shape) for w in tcn.mlp.weights] == td.mlp_dims()


def test_posenc_mlp_blend_and_warp_match():
    pts, valid, jcn, tcn = _field()
    x = np.asarray(pts)
    _close(td.posenc(_t(x), 10).numpy(), jd.posenc(pts, 10), err_msg="posenc")
    t = jnp.linspace(0.0, 1.0, M)[:, None]
    for a, b in zip(td.mlp_forward(tcn.mlp, _t(jcn.nodes), _t(t)),
                    jd.mlp_forward(jcn.mlp, jcn.nodes, t)):
        _close(a.detach().numpy(), b, err_msg="mlp_forward")
    jw, ji = jd.nn_weights(jcn, pts)
    tw, ti = td.nn_weights(tcn, _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw.detach().numpy(), jw, err_msg="nn_weights")
    dygs = jnp.arange(N) % 3 != 0
    times = [0.1, 0.45, 0.9]
    batch = td.warp(tcn, _t(x), torch.tensor(times), motion_mask=_t(dygs))
    for j, tt in enumerate(times):
        want = jd.warp(jcn, pts, jnp.float32(tt), motion_mask=dygs)
        one = td.warp(tcn, _t(x), torch.tensor(tt), motion_mask=_t(dygs))
        for a, b, c in zip(one, batch, want):
            _close(a.detach().numpy(), c, err_msg="warp")
            _close(b[j].detach().numpy(), c, err_msg="batched warp")
        assert float(np.abs(np.asarray(want[0])).max()) > 1e-3


def _jax_draws(key, n):
    k1, k2 = jax.random.split(key)
    return float(jax.random.uniform(k1, ())), np.asarray(jax.random.uniform(k2, (n,)))


@pytest.mark.parametrize("term", ["arap", "elastic"])
def test_regularizers_and_gradients_match(term):
    pts, valid, jcn, tcn = _field(seed=1)
    delta_t = 0.05
    views = [(0.2, jax.random.key(11)), (0.55, jax.random.key(12)), (0.8, jax.random.key(13))]
    n_samp = 2 if term == "arap" else 8
    j_loss = {"arap": lambda cn, key, t: jd.arap_loss(cn, key, t, delta_t, t_samp_num=2),
              "elastic": lambda cn, key, t: jd.elastic_loss(cn, key, t, delta_t)}[term]
    t_loss = {"arap": td.arap_loss, "elastic": td.elastic_loss}[term]

    def j_total(f):
        cn = jd.cn_merge(f, jcn.valid)
        return sum(w * j_loss(cn, key, jnp.float32(t)) for w, (t, key) in
                   zip((1.0, 0.5, 0.25), views))

    jval, jgrad = jax.value_and_grad(j_total)(jd.cn_floats(jcn))
    draws = [_jax_draws(key, n_samp) for _, key in views]
    like = td.cn_floats(tcn)
    flat = td.flatten(like).requires_grad_(True)
    per_view = t_loss(td.cn_merge(td.unflatten(flat, like), tcn.valid),
                      torch.tensor([u0 for u0, _ in draws]),
                      torch.tensor(np.stack([us for _, us in draws])),
                      torch.tensor([t for t, _ in views]), delta_t)
    tval = torch.sum(torch.tensor([1.0, 0.5, 0.25]) * per_view)
    (g,) = torch.autograd.grad(tval, flat)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    assert float(jval) > 0
    want = td.leaves(convert._floats_from(jgrad, "cpu"))
    names = ["nodes", "radius_raw", "weight_raw"] + [f"mlp{i}" for i in range(len(want) - 3)]
    top = max(float(b.abs().max()) for b in want)
    for name, a, b in zip(names, td.leaves(td.unflatten(g, like)), want):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * top, (name, err, top)
        if float(b.abs().max()) > 1e-3 * top:
            _close(a.numpy(), b.numpy(), rtol=1e-4, err_msg=name)
    nonzero = [name for name, b in zip(names, want) if float(b.abs().max()) > 0]
    assert "mlp0" in nonzero
    if term == "elastic":
        assert {"radius_raw", "weight_raw"} <= set(nonzero)


def _fps_start(key, valid):
    vf = jnp.asarray(valid, jnp.float32)
    return int(jax.random.choice(key, valid.shape[0], p=vf / jnp.maximum(jnp.sum(vf), 1.0)))


@pytest.mark.parametrize("n_valid,sample_number", [(24, 5), (24, 20), (32, 4), (0, 6)])
def test_extend_nodes_matches(n_valid, sample_number):
    # 8 dead slots: fewer than the samples (take limited to the free count),
    # more than them, none (every slot kept, the median a real one), and
    # all dead (no node to take a median of); the dead slots scattered
    _, _, jcn, _ = _field(seed=2, node_num=min(max(n_valid, 1), M))
    rng = np.random.default_rng(n_valid + sample_number)
    valid = np.zeros(M, bool)
    valid[rng.permutation(M)[:n_valid]] = True
    jcn = jcn._replace(valid=jnp.asarray(valid))
    tcn = convert.control_nodes_from_arrays(jcn, "cpu")
    new_pts = rng.uniform(1, 2, (200, 3)).astype(np.float32)
    pv = rng.uniform(size=200) > 0.3
    key = jax.random.key(n_valid)
    jout = jd.extend_nodes(jcn, key, jnp.asarray(new_pts), jnp.asarray(pv),
                           sample_number=sample_number)
    tout = td.extend_nodes(tcn, _t(new_pts), _t(pv), torch.tensor(_fps_start(key, pv)),
                           sample_number=sample_number)
    got, want = convert.control_nodes_to_arrays(tout), convert.control_nodes_to_arrays(
        convert.control_nodes_from_arrays(jout, "cpu"))
    for name in ("nodes", "radius_raw", "weight_raw", "valid"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert int(got["valid"].sum()) == min(M, n_valid + sample_number)


def test_extend_nodes_fills_dead_slots():
    # tests/test_deform.py::test_extend_nodes against the port: 16 of 64
    # valid, 20 new nodes from a far cloud
    rng = np.random.default_rng(0)
    pts = _t(rng.uniform(-1, 1, (256, 3)).astype(np.float32))
    ws, heads = [torch.zeros(d) for d in td.mlp_dims()], [torch.zeros((256, d))
                                                          for _, d, _ in td.HEADS]
    cn = td.init_nodes(64, pts, torch.ones(256, dtype=torch.bool), 16, 0,
                       td.init_mlp(ws, heads))
    new_pts = _t(np.random.default_rng(5).uniform(2, 3, (128, 3)).astype(np.float32))
    cn2 = td.extend_nodes(cn, new_pts, torch.ones(128, dtype=torch.bool), 0, sample_number=20)
    assert int(cn2.valid.sum()) == 36
    np.testing.assert_array_equal(cn2.nodes[cn.valid].numpy(), cn.nodes[cn.valid].numpy())
    newly = cn2.valid & ~cn.valid
    assert bool((cn2.nodes[newly] >= 1.9).all())
    assert bool((cn2.weight_raw[newly] == 0).all())


def _acc_both(jcn, tcn, views, delta_t):
    """acc_loss over `views` (time, key) weighted 1, 0.5 on both sides:
    (reference value, its gradient as the port's leaves, port value, the
    port's gradient leaves, the port's per-view values)."""
    def j_total(f):
        cn = jd.cn_merge(f, jcn.valid)
        return sum(w * jd.acc_loss(cn, key, jnp.asarray(t, jcn.nodes.dtype), delta_t)
                   for w, (t, key) in zip((1.0, 0.5), views))

    jval, jgrad = jax.value_and_grad(j_total)(jd.cn_floats(jcn))
    dt = tcn.nodes.dtype
    us = torch.tensor([float(jax.random.uniform(key, (), jcn.nodes.dtype))
                       for _, key in views], dtype=dt)
    like = td.cn_floats(tcn)
    flat = td.flatten(like).requires_grad_(True)
    cn = td.cn_merge(td.unflatten(flat, like), tcn.valid)
    per_view = td.acc_loss(cn, us, torch.tensor([t for t, _ in views], dtype=dt), delta_t)
    tval = torch.sum(torch.tensor([1.0, 0.5], dtype=dt) * per_view)
    (g,) = torch.autograd.grad(tval, flat)
    return (float(jval), td.leaves(convert._floats_from(jgrad, "cpu")), float(tval.detach()),
            td.leaves(td.unflatten(g, like)), cn, us, per_view.detach())


def test_acc_loss_and_gradient_match():
    """acc_loss's value in float32, and value and gradients in float64 on
    both sides, at the file's tolerances. Its second difference cancels
    (node positions near 0.5 against differences near 1e-3), so in float32
    either side's gradient carries rounding of about 1e-5 of the largest."""
    _, _, jcn, tcn = _field(seed=3)
    delta_t = 0.05
    views = [(0.15, jax.random.key(21)), (0.6, jax.random.key(22))]
    jval, _, tval, _, cn, us, per_view = _acc_both(jcn, tcn, views, delta_t)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    # a scalar time gives the same value as its view of the batch
    one = td.acc_loss(cn, us[1], torch.tensor(views[1][0]), delta_t)
    np.testing.assert_allclose(float(one.detach()), float(per_view[1]), rtol=1e-6)

    with jax.enable_x64(True):
        jcn64 = jax.tree.map(lambda a: a if a.dtype == jnp.bool_ else
                             jnp.asarray(np.asarray(a), jnp.float64), jcn)
        tcn64 = convert.control_nodes_from_arrays(jcn64, "cpu")
        jval, want, tval, got, _, _, _ = _acc_both(jcn64, tcn64, views, delta_t)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    top = max(float(b.abs().max()) for b in want)
    assert top > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert float((a - b).abs().max()) <= 1e-5 * top, i
        if float(b.abs().max()) > 1e-3 * top:
            _close(a.numpy(), b.numpy(), rtol=1e-4, err_msg=str(i))

"""Parity of fourdgs_torch.models.gaussian_map (and the 3-NN scale rule of
ops/knn.py) with the JAX reference, within 1e-6: the masked Adam step with
NaN gradients on dead slots, insert, prune, the opacity resets,
densify_and_prune with the same split noise, resize_map in both directions,
candidates_from_rgbd with the same downsampling draws, expon_lr, and the
convert round trip of a JAX map, its Adam state and a keyframe store."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.models import gaussian_map as jgm
from fourdgs.ops.knn import knn_mean_sq_dist as j_knn
from fourdgs.slam.camera import make_frame as j_make_frame
from fourdgs.slam.keyframes import empty_store, store_keyframe
from fourdgs_torch import convert
from fourdgs_torch.models import gaussian_map as tgm
from fourdgs_torch.ops.knn import knn_mean_sq_dist as t_knn

TOL = dict(rtol=1e-6, atol=1e-6)


def _jax_state(seed=0, n=40, cap=64):
    """A JAX map with n live Gaussians (some killed again), random moments
    and densification statistics."""
    rng = np.random.default_rng(seed)
    new = jgm.NewGaussians(
        xyz=jnp.asarray(rng.normal(0, 1, (n, 3)), jnp.float32),
        rgb=jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32),
        scaling=jnp.asarray(np.log(rng.uniform(0.002, 0.2, (n, 3))), jnp.float32),
        rotation=jnp.asarray(rng.normal(0, 1, (n, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(0, 2, (n, 1)), jnp.float32),
        valid=jnp.asarray(rng.uniform(size=n) > 0.15),
    )
    gmap, adam, _ = jgm.insert(jgm.empty_map(cap), jgm.init_adam(cap), new, kf_id=3)
    gmap, adam = jgm.prune(gmap, adam, jnp.asarray(rng.uniform(size=cap) < 0.1))
    moments = [jnp.asarray(rng.uniform(0, 1e-3, p.shape), jnp.float32) for p in gmap.params]
    adam = adam._replace(mu=jgm.GaussianParams(*moments),
                         nu=jgm.GaussianParams(*(m * m for m in moments)),
                         count=jnp.asarray(5, jnp.int32))
    gmap = gmap._replace(
        grad_accum=jnp.asarray(rng.uniform(0, 1e-3, cap), jnp.float32) * gmap.alive,
        denom=jnp.asarray(rng.integers(0, 4, cap), jnp.float32) * gmap.alive,
        max_radii2d=jnp.asarray(rng.uniform(0, 30, cap), jnp.float32) * gmap.alive,
        dygs=jnp.asarray(rng.uniform(size=cap) < 0.2) & gmap.alive,
        kf_id=jnp.asarray(rng.integers(0, 9, cap), jnp.int32),
    )
    return gmap, adam


def _check_map(t_map, j_map):
    got = convert.gaussian_map_to_arrays(t_map)
    for f in jgm.GaussianMap._fields:
        if f == "params":
            for p in jgm.GaussianParams._fields:
                np.testing.assert_allclose(got["params"][p], np.asarray(getattr(j_map.params, p)),
                                           err_msg=p, **TOL)
        else:
            np.testing.assert_allclose(got[f], np.asarray(getattr(j_map, f)), err_msg=f, **TOL)


def _check_adam(t_adam, j_adam):
    got = convert.adam_to_arrays(t_adam)
    assert int(got["count"]) == int(j_adam.count)
    for m in ("mu", "nu"):
        for p in jgm.GaussianParams._fields:
            np.testing.assert_allclose(got[m][p], np.asarray(getattr(getattr(j_adam, m), p)),
                                       err_msg=f"{m}.{p}", **TOL)


def _port(gmap, adam):
    return (convert.gaussian_map_from_arrays(gmap, "cpu"),
            convert.adam_from_arrays(adam, "cpu"))


def test_convert_round_trip_is_lossless():
    gmap, adam = _jax_state()
    t_map, t_adam = _port(gmap, adam)
    back_map = convert.gaussian_map_to_arrays(t_map)
    rebuilt = jgm.GaussianMap(
        params=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in back_map["params"].items()}),
        **{k: jnp.asarray(v) for k, v in back_map.items() if k != "params"})
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(gmap)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _check_adam(t_adam, adam)
    store = empty_store(3, 8, 10)
    frame = j_make_frame(7, np.random.default_rng(1).uniform(0, 1, (3, 8, 10)),
                         np.full((8, 10), 2.0), np.eye(4), 0.25)
    store = store_keyframe(store, 1, frame, jnp.eye(4) * 2, jnp.asarray([0.1, -0.2]))
    back = convert.store_to_arrays(convert.store_from_arrays(store, "cpu"))
    for f in store._fields:
        a = np.asarray(getattr(store, f))
        assert back[f].dtype == a.dtype
        np.testing.assert_array_equal(back[f], a)
    T = np.asarray(jnp.eye(4) * 3)
    np.testing.assert_array_equal(convert.pose_to_array(convert.pose_from_array(T, "cpu")), T)


def test_adam_step_with_nan_gradients_on_dead_slots():
    gmap, adam = _jax_state(1)
    rng = np.random.default_rng(2)
    grads = [rng.normal(0, 1e-2, p.shape).astype(np.float32) for p in gmap.params]
    dead = ~np.asarray(gmap.alive)
    for g in grads:
        g[dead] = np.nan          # autodiff through dead slots can emit NaN
    jp, ja = jgm.adam_step(gmap.params, jgm.GaussianParams(*map(jnp.asarray, grads)), adam,
                           jgm.MapLRs(), gmap.alive, xyz_lr_mult=0.37)
    t_map, t_adam = _port(gmap, adam)
    tp, ta = tgm.adam_step(t_map.params, tgm.GaussianParams(*map(torch.tensor, grads)), t_adam,
                           tgm.MapLRs(), t_map.alive, xyz_lr_mult=0.37)
    _check_map(t_map._replace(params=tp), gmap._replace(params=jp))
    _check_adam(ta, ja)
    assert all(torch.isfinite(p).all() for p in tp)
    for p, p0 in zip(tp, t_map.params):
        assert torch.equal(p[torch.tensor(dead)], p0[torch.tensor(dead)])


def test_insert_prune_and_opacity_resets():
    gmap, adam = _jax_state(3)
    rng = np.random.default_rng(4)
    m = 30   # more candidates than free slots are dropped
    cand = dict(xyz=rng.normal(0, 1, (m, 3)), rgb=rng.uniform(0, 1, (m, 3)),
                scaling=rng.normal(-3, 0.3, (m, 3)), rotation=rng.normal(0, 1, (m, 4)),
                opacity=rng.normal(0, 1, (m, 1)))
    valid = rng.uniform(size=m) > 0.3
    jnew = jgm.NewGaussians(**{k: jnp.asarray(v, jnp.float32) for k, v in cand.items()},
                            valid=jnp.asarray(valid))
    tnew = tgm.NewGaussians(**{k: torch.tensor(v, dtype=torch.float32) for k, v in cand.items()},
                            valid=torch.tensor(valid))
    jmap, jadam, jn = jgm.insert(gmap, adam, jnew, kf_id=11, dygs=True)
    t_map, t_adam = _port(gmap, adam)
    tmap, tadam, tn = tgm.insert(t_map, t_adam, tnew, kf_id=11, dygs=True)
    assert tn == int(jn)
    _check_map(tmap, jmap)
    _check_adam(tadam, jadam)

    kill = rng.uniform(size=gmap.capacity) < 0.3
    jmap, jadam = jgm.prune(jmap, jadam, jnp.asarray(kill))
    tmap, tadam = tgm.prune(tmap, tadam, torch.tensor(kill))
    _check_map(tmap, jmap)
    _check_adam(tadam, jadam)

    vis = rng.uniform(size=gmap.capacity) < 0.5
    j2 = jgm.reset_opacity_nonvisible(jmap, jadam, jnp.asarray(vis))
    t2 = tgm.reset_opacity_nonvisible(tmap, tadam, torch.tensor(vis))
    _check_map(t2[0], j2[0])
    _check_adam(t2[1], j2[1])
    j3 = jgm.reset_opacity(*j2)
    t3 = tgm.reset_opacity(*t2)
    _check_map(t3[0], j3[0])
    _check_adam(t3[1], j3[1])


@pytest.mark.parametrize("max_screen_size", [0.0, 20.0])
def test_densify_and_prune_with_the_same_noise(max_screen_size):
    gmap, adam = _jax_state(5, n=24, cap=96)
    key = jax.random.key(9)
    jmap, jadam = jgm.densify_and_prune(gmap, adam, key, 2e-4, 0.3, 1.0, max_screen_size)
    keys = jax.random.split(key, 2)
    noise = tuple(torch.tensor(np.asarray(jax.random.normal(k, gmap.params.xyz.shape)))
                  for k in keys)
    t_map, t_adam = _port(gmap, adam)
    tmap, tadam = tgm.densify_and_prune(t_map, t_adam, noise, 2e-4, 0.3, 1.0, max_screen_size)
    _check_map(tmap, jmap)
    _check_adam(tadam, jadam)
    assert tmap.num_alive != t_map.num_alive   # something was cloned, split or pruned


@pytest.mark.parametrize("new_cap", [96, 48])
def test_resize_map(new_cap):
    gmap, adam = _jax_state(6)
    jmap, jadam = jgm.resize_map(gmap, adam, new_cap)
    tmap, tadam = tgm.resize_map(*_port(gmap, adam), new_cap)
    assert tmap.capacity == new_cap
    _check_map(tmap, jmap)
    _check_adam(tadam, jadam)


def test_candidates_from_rgbd_with_the_same_draws():
    rng = np.random.default_rng(7)
    h, w = 24, 32
    image = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.2] = 0.0
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.2, 0.3]
    key = jax.random.key(3)
    kw = dict(downsample=3, point_size=0.05, exposure_a=0.1, exposure_b=-0.02)
    jc = jgm.candidates_from_rgbd(key, jnp.asarray(image), jnp.asarray(depth), jnp.asarray(T),
                                  30.0, 31.0, 15.5, 11.5, **kw)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (h * w,))))
    tc = tgm.candidates_from_rgbd(u, torch.tensor(image), torch.tensor(depth), torch.tensor(T),
                                  30.0, 31.0, 15.5, 11.5, **kw)
    ok = np.asarray(jc.valid)
    assert tc.valid.shape[0] == ok.sum() > 20
    for f in ("xyz", "rgb", "scaling", "rotation", "opacity"):
        # the JAX rotation and opacity rows run to max_new, past the H*W pixels
        ref = np.asarray(getattr(jc, f))[:ok.shape[0]][ok]
        np.testing.assert_allclose(getattr(tc, f).numpy(), ref,
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_knn_mean_sq_dist_and_expon_lr():
    rng = np.random.default_rng(8)
    pts = rng.normal(0, 1, (50, 3)).astype(np.float32)
    valid = rng.uniform(size=50) > 0.2
    for v in (None, valid):
        a = t_knn(torch.tensor(pts), None if v is None else torch.tensor(v), k=3).numpy()
        b = np.asarray(j_knn(jnp.asarray(pts), None if v is None else jnp.asarray(v), k=3))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for step in (0, 10, 2999, 30000, 40000):
        for delay in (0, 100):
            np.testing.assert_allclose(
                tgm.expon_lr(step, 1.0, 0.01, lr_delay_steps=delay, lr_delay_mult=0.1),
                float(jgm.expon_lr(step, 1.0, 0.01, lr_delay_steps=delay, lr_delay_mult=0.1)),
                rtol=1e-6)


def test_densification_stats_and_max_radii_match():
    gmap, _ = _jax_state(7)
    rng = np.random.default_rng(7)
    cap = gmap.capacity
    grad = rng.normal(0, 1e-3, (cap, 2)).astype(np.float32)
    radii = rng.integers(0, 40, cap).astype(np.int32)
    visible = rng.uniform(size=cap) > 0.4
    j_map = jgm.update_max_radii(jgm.add_densification_stats(
        gmap, jnp.asarray(grad), jnp.asarray(visible)), jnp.asarray(radii), jnp.asarray(visible))
    t_map, _ = _port(gmap, jgm.init_adam(cap))
    t_map = tgm.update_max_radii(tgm.add_densification_stats(
        t_map, torch.tensor(grad), torch.tensor(visible)), torch.tensor(radii),
        torch.tensor(visible))
    _check_map(t_map, j_map)

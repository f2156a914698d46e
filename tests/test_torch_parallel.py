"""Multi-device mapping of the port (fourdgs_torch/parallel/) against the
reference's (fourdgs/parallel/ and the `mesh=` branches of
fourdgs/slam/mapping.py and mapping_dynamic.py).

The port's meshes here are CPU processes over gloo: `make_mesh(k,
devices=["cpu"] * k)`, one per world size for the module. The JAX side
runs on the virtual 8-device CPU mesh of tests/conftest.py
(`fourdgs.parallel.make_mesh(2)`), through its Pallas kernels in interpret
mode. Both sides start from the same map, store and draws (`convert.py`).

Tolerances: one mesh chunk against the reference's mesh chunk, and the
port's mesh against its own single-device path, at
tests/test_parallel.py's (loss 1e-5 relative, map 2e-5, poses 1e-5,
`denom` exact, `grad_accum` 1e-5); several 4D iterations are bounded as
tests/test_torch_mapping_dynamic.py bounds them (the 4D Adams run at eps
1e-15, where rounding-noise gradients step by the full learning rate).
The states are tests/test_torch_mapping.py's, whose Gaussians are clearly
anisotropic: on exactly isotropic ones the isotropic loss's gradient sign
is rounding noise, which sends the two packages' first Adam steps apart.

Also held: every rank ends each call with the same state, bit for bit
(`Mesh.checksums`); a worker killed in the middle of a chunk makes rank
0 raise within the group's timeout, and leaves no process behind; a
mesh asks for a card per rank unless placed. The runner with
`Training.mesh_devices` is held in tests/test_torch_parallel_runner.py."""

import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.models.gaussian_map import GaussianParams as JParams
from fourdgs.parallel import batch_render_sharded as j_batch_render
from fourdgs.parallel import make_mesh as j_make_mesh
from fourdgs.parallel import sharded_map_step as j_sharded_step
from fourdgs.slam import mapping as jm
from fourdgs.slam import mapping_dynamic as jmd
from fourdgs_torch import convert
from fourdgs_torch.models import deform as td
from fourdgs_torch.models import gaussian_map as tgm
from fourdgs_torch.parallel import (
    MeshError,
    batch_render_sharded,
    make_mesh,
    sharded_map_step,
)
from fourdgs_torch.parallel import mesh as mesh_mod
from fourdgs_torch.parallel.comm import exercise
from fourdgs_torch.parallel.mesh import placement
from fourdgs_torch.slam import mapping as tm
from fourdgs_torch.slam import mapping_dynamic as tmd
from tests.test_torch_mapping import J_INTR, J_RASTER, T_INTR, H, W, _jax_picks, _state
from tests.test_torch_mapping_dynamic import (
    _dyn_state,
    _jax_chunk_constant_payload_camera,
    _to_port,
)
from tests.test_torch_slam import (  # noqa: F401
    jax_dynamic_draws,
    jax_refine_draws,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def meshes():
    """The module's port meshes, one per world size, made on first use."""
    made = {}

    def get(k):
        if k not in made:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(mesh_mod, "DEFAULT_TIMEOUT_S", TIMEOUT_S)
                made[k] = make_mesh(k, devices=["cpu"] * k)
        return made[k]

    yield get
    for m in made.values():
        m.close()


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(2)


def _params_close(a: tgm.GaussianMap, b, atol, what=""):
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        x = getattr(a.params, name).numpy()
        y = np.asarray(getattr(b.params, name))
        np.testing.assert_allclose(x, y, atol=atol, err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# collectives


@pytest.mark.parametrize("k", [2, 4])
def test_collectives_match_their_definitions(meshes, k):
    mesh = meshes(k)
    x = torch.tensor(np.random.default_rng(k).normal(size=(k, 2 * k, 3)), dtype=torch.float32)
    out = mesh.run(exercise, x)
    np.testing.assert_allclose(out["psum"].numpy(), x.sum(0).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out["pmax"].numpy(), x.max(0).values.numpy())
    np.testing.assert_array_equal(out["all_gather"].numpy(), x.reshape(2 * k * k, 3).numpy())
    np.testing.assert_allclose(out["psum_scatter"].numpy(), x.sum(0).numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(out["broadcast"].numpy(), x[k - 1].numpy())
    flags = torch.tensor(np.random.default_rng(k + 1).random((k, 2 * k)) > 0.7)
    np.testing.assert_array_equal(mesh.run(exercise, flags)["pmax"].numpy(),
                                  flags.any(0).numpy())
    assert len(set(mesh.checksums)) == 1 and len(mesh.checksums) == k


# ---------------------------------------------------------------------------
# map_chunk


WINDOW = dict(slots=np.array([1, 2, 0], np.int32), valid=np.array([True, True, False]),
              opt_pose=np.array([True, False, False]))


def _static_chunks(jmesh, tmesh, pool, iters, step_after, refine=False, rebin_every=4):
    """The reference's map_chunk on its mesh, and the port's on `tmesh`
    (None: one device), from tests/test_torch_mapping.py's state with the
    same draws."""
    gmap, adam, store = _state()
    pool_arr = np.zeros(8, np.int32)
    pool_arr[:len(pool)] = pool
    key = jax.random.key(3)
    jcfg = jm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9,
                            raster=J_RASTER, refine=refine)
    tcfg = tm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9,
                            refine=refine, rebin_every=rebin_every)
    picks = (jax_refine_draws(key, iters, len(pool_arr)) if refine
             else _jax_picks(key, iters, len(pool)))
    jres = None
    if jmesh is not None:
        jres = jm.map_chunk(gmap, adam, store, jnp.asarray(WINDOW["slots"]),
                            jnp.asarray(WINDOW["valid"]), jnp.asarray(WINDOW["opt_pose"]),
                            jnp.asarray(pool_arr), jnp.int32(len(pool)), jm.init_pose_adam(3),
                            key, jnp.int32(iters), jnp.int32(step_after), jnp.int32(40),
                            J_INTR, jcfg, mesh=jmesh)
    tres = tm.map_chunk(convert.gaussian_map_from_arrays(gmap, "cpu"),
                        convert.adam_from_arrays(adam, "cpu"),
                        convert.store_from_arrays(store, "cpu"), WINDOW["slots"], WINDOW["valid"],
                        WINDOW["opt_pose"], pool_arr, len(pool), tm.init_pose_adam(3, "cpu"),
                        picks, iters, step_after, 40, T_INTR, tcfg, mesh=tmesh)
    return tres, jres


def _hold_static(tres, ref, store_ref=None):
    """tests/test_parallel.py:88-101's tolerances."""
    np.testing.assert_allclose(tres.final_loss, float(ref.final_loss), rtol=1e-5)
    _params_close(tres.gmap, ref.gmap, 2e-5)
    np.testing.assert_allclose(tres.store.T_cw.numpy(), np.asarray(ref.store.T_cw), atol=1e-5)
    np.testing.assert_array_equal(tres.gmap.denom.numpy(), np.asarray(ref.gmap.denom))
    np.testing.assert_allclose(tres.gmap.grad_accum.numpy(), np.asarray(ref.gmap.grad_accum),
                               atol=1e-5)


@pytest.mark.parametrize("step_after,pool", [(-1, [3, 0]), (1, [3, 0, 2])])
def test_map_chunk_mesh_matches_reference_mesh(meshes, jmesh, step_after, pool):
    """Three iterations at 2 ranks, window views 1, 2 (3: invalid), replay
    from `pool`, against the reference's mesh branch on 2 devices."""
    tres, jres = _static_chunks(jmesh, meshes(2), pool, 3, step_after)
    _hold_static(tres, jres)
    assert tres.adam.count == int(jres.adam.count)
    np.testing.assert_allclose(tres.store.exposure.numpy(), np.asarray(jres.store.exposure),
                               atol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_map_chunk_mesh_matches_single_device(meshes, k):
    """The port's mesh branch against its own single-device path (which
    rebins every iteration here, as the mesh branch does), at 2 and 4
    ranks: 4 ranks pad the 5 views to 8, and a rank renders none."""
    tres, _ = _static_chunks(None, meshes(k), [3, 0, 2], 3, -1)
    single, _ = _static_chunks(None, None, [3, 0, 2], 3, -1, rebin_every=1)
    _hold_static(tres, single)
    np.testing.assert_allclose(tres.store.exposure.numpy(), single.store.exposure.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(tres.pose_adam.mu.numpy(), single.pose_adam.mu.numpy(),
                               atol=1e-6)
    assert (tres.overflow, tres.num_pairs) == (single.overflow, single.num_pairs)


def test_refine_mode_matches_reference_mesh(meshes, jmesh):
    """Three colour-refinement iterations (5 distinct keyframes of the
    pool per iteration, from the same refine_picks draws) at 2 ranks:
    against the reference's mesh branch at tests/test_torch_refine.py's
    tolerances (the port's refinement against the reference's on one
    device: its SSIM rounds otherwise), against the port's single device
    at tests/test_parallel.py's."""
    pool = [3, 0, 2, 1]
    tres, jres = _static_chunks(jmesh, meshes(2), pool, 3, -1, refine=True)
    single, _ = _static_chunks(None, None, pool, 3, -1, refine=True)
    _hold_static(tres, single)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-4)
    tg = convert.gaussian_map_to_arrays(tres.gmap)
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        b = np.asarray(getattr(jres.gmap.params, name))
        np.testing.assert_allclose(tg["params"][name], b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)
    np.testing.assert_array_equal(tg["denom"], np.asarray(jres.gmap.denom))


def test_production_window_across_a_densify(meshes):
    """tests/test_parallel.py:172-258 on the port: 8 window and 2 replay
    views, a chunk of 3 iterations, a densify and prune, and a chunk of 2,
    the mesh at 2 ranks against the single device. Held as there: the
    first chunk tight in bulk, the same densify decisions, the second
    chunk within a learning-rate envelope."""
    gmap, adam, store = _state()
    ts0 = convert.store_from_arrays(store, "cpu")
    from fourdgs_torch.geometry.se3 import se3_exp
    from fourdgs_torch.slam.camera import make_frame
    from fourdgs_torch.slam.keyframes import empty_store, fetch_images, store_keyframe

    ts = empty_store(10, H, W, "cpu")
    img, depth = fetch_images(ts0, 0), ts0.depths[0]
    for s in range(8):
        tau = torch.tensor([0.01 * s, -0.005 * s, 0.0, 0.0, 0.002 * s, 0.0])
        store_keyframe(ts, s, make_frame(s, img, depth, torch.eye(4), 0.1 * s, ts0.motion[0],
                                         device="cpu"), se3_exp(tau), torch.zeros(2))
    cfg = tm.MappingConfig(num_window_views=8, num_random_views=2, rebin_every=1)
    slots, valid = np.arange(8), np.ones(8, bool)
    opt_pose = np.array([False] + [True] * 7)
    pool = np.arange(8)
    normals = tuple(torch.tensor(np.random.default_rng(11 + i).normal(size=(1024, 3)),
                                 dtype=torch.float32) for i in range(2))

    def run(mesh):
        g0 = convert.gaussian_map_from_arrays(gmap, "cpu")
        a0 = convert.adam_from_arrays(adam, "cpu")
        st = tuple(x.clone() for x in ts)
        st = type(ts)(*st)
        r = tm.map_chunk(g0, a0, st, slots, valid, opt_pose, pool, 8, tm.init_pose_adam(8, "cpu"),
                         _jax_picks(jax.random.key(7), 3, 8), 3, -1, 0, T_INTR, cfg, mesh=mesh)
        g2, a2 = tgm.densify_and_prune(r.gmap, r.adam, normals, 1e-7, 0.005, 1.0, 20)
        r2 = tm.map_chunk(g2, a2, r.store, slots, valid, opt_pose, pool, 8,
                          tm.init_pose_adam(8, "cpu"), _jax_picks(jax.random.key(9), 2, 8), 2,
                          -1, 3, T_INTR, cfg, mesh=mesh)
        return r2, r, g2

    res1, r1, g1 = run(None)
    res2, r2, g2 = run(meshes(2))
    np.testing.assert_allclose(r2.final_loss, r1.final_loss, rtol=2e-4)
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        d = (getattr(r1.gmap.params, name) - getattr(r2.gmap.params, name)).abs().numpy()
        assert np.quantile(d, 0.95) < 2e-4 and np.quantile(d, 0.99) < 1e-3, name
        assert d.max() < 1e-2, name
    np.testing.assert_allclose(r1.store.T_cw.numpy(), r2.store.T_cw.numpy(), atol=5e-5)
    np.testing.assert_array_equal(g1.alive.numpy(), g2.alive.numpy())
    assert int(g1.alive.sum()) != int(r1.gmap.alive.sum())     # the densify changed the map
    np.testing.assert_allclose(res2.final_loss, res1.final_loss, rtol=2e-3)
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = getattr(res1.gmap.params, name).numpy(), getattr(res2.gmap.params, name).numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all()
        np.testing.assert_allclose(a, b, atol=3e-2)
    np.testing.assert_allclose(res1.store.T_cw.numpy(), res2.store.T_cw.numpy(), atol=2e-3)


# ---------------------------------------------------------------------------
# map_chunk_dynamic


def _dynamic_chunks(jmesh, tmesh, iters, step_after=-1, rebin_every=4):
    """The reference's map_chunk_dynamic on its mesh (payload cameras held
    constant, the port's departure) and the port's on `tmesh` (None: one
    device), from tests/test_torch_mapping_dynamic.py's state."""
    gmap, adam, store, cn = _dyn_state()
    dadam = jmd.init_deform_adam(cn)
    pair_slots = np.array([0, 1, 3], np.int32)
    rng = np.random.default_rng(5)
    fwd = rng.normal(0, 0.02, (3, 2, H, W)).astype(np.float32)
    bwd = rng.normal(0, 0.02, (3, 2, H, W)).astype(np.float32)
    pool_arr = np.zeros(8, np.int32)
    pool_arr[:3] = [3, 0, 2]
    key = jax.random.key(3)
    kw = dict(flow_weight=3.0, flow_weight_fine=2.0, time_interval=1 / 8)
    jres = None
    if jmesh is not None:
        jcfg = jm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9,
                                raster=J_RASTER)
        jres = _jax_chunk_constant_payload_camera(
            gmap, adam, store, cn, dadam, jnp.asarray(WINDOW["slots"]),
            jnp.asarray(WINDOW["valid"]), jnp.asarray(WINDOW["opt_pose"]),
            jnp.asarray(pair_slots), jnp.asarray(fwd), jnp.asarray(bwd), jnp.asarray(pool_arr),
            jnp.int32(3), jm.init_pose_adam(3), key, jnp.int32(iters), jnp.int32(step_after),
            jnp.int32(40), J_INTR, jcfg, mesh=jmesh, **kw)
    tg, ta, ts, tcn, tda = _to_port(gmap, adam, store, cn, dadam)
    tres = tmd.map_chunk_dynamic(
        tg, ta, ts, tcn, tda, WINDOW["slots"], WINDOW["valid"], WINDOW["opt_pose"], pair_slots,
        torch.tensor(fwd), torch.tensor(bwd), pool_arr, 3, tm.init_pose_adam(3, "cpu"),
        jax_dynamic_draws(key, iters, 3, 5), iters, step_after, 40, T_INTR,
        tm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9,
                         rebin_every=rebin_every), mesh=tmesh, **kw)
    return tres, jres, cn


def _field(cn):
    return torch.cat([x.reshape(-1) for x in td.leaves(td.cn_floats(cn))])


def test_map_chunk_dynamic_mesh_matches_reference_mesh(meshes, jmesh):
    """One iteration at 2 ranks: the 3 + 2 main views and the flow renders
    of the two window views with a pair (13 views, padded to 14) against
    the reference's mesh branch: loss 1e-5, the map's and the field's
    gradients (as Adam's first moments) within 1e-4 of each tensor's
    largest magnitude, poses 1e-5, `denom` exact, the field 2e-4."""
    tres, jres, _ = _dynamic_chunks(jmesh, meshes(2), 1)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-5)
    tmu = convert.adam_to_arrays(tres.adam)["mu"]
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        b = np.asarray(getattr(jres.adam.mu, name))
        np.testing.assert_allclose(tmu[name], b, atol=1e-4 * np.abs(b).max(), err_msg=name)
    _params_close(tres.gmap, jres.gmap, 2e-5)
    want = convert.control_nodes_from_arrays(jres.deform, "cpu")
    assert float((_field(tres.deform) - _field(want)).abs().max()) <= 2e-4
    np.testing.assert_allclose(tres.store.T_cw.numpy(), np.asarray(jres.store.T_cw), atol=1e-5)
    np.testing.assert_array_equal(tres.gmap.denom.numpy(), np.asarray(jres.gmap.denom))


def test_map_chunk_dynamic_mesh_bounded_over_iterations(meshes, jmesh):
    """Four iterations (the phase switch after the second, map steps from
    the third) at 2 ranks against the reference's mesh branch, bounded as
    tests/test_torch_mapping_dynamic.py bounds several 4D iterations."""
    iters = 4
    tres, jres, cn = _dynamic_chunks(jmesh, meshes(2), iters, step_after=1)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=2e-3)
    np.testing.assert_allclose(tres.store.T_cw.numpy(), np.asarray(jres.store.T_cw), atol=1e-4)
    tg = convert.gaussian_map_to_arrays(tres.gmap)
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = tg["params"][name], np.asarray(getattr(jres.gmap.params, name))
        err = np.abs(a - b) / np.abs(b).max()
        assert np.quantile(err, 0.99) <= 1e-3, (name, np.quantile(err, 0.99))
    err = (_field(tres.deform) - _field(convert.control_nodes_from_arrays(jres.deform, "cpu")))
    assert float((err.abs() > 1e-4).float().mean()) <= 0.2
    assert float(err.abs().max()) <= 2 * iters * tmd.DEFORM_LR


@pytest.mark.parametrize("k", [2, 4])
def test_map_chunk_dynamic_mesh_matches_single_device(meshes, k):
    """The port's 4D mesh branch against its own single device (binning
    every iteration), one iteration, at test_parallel.py's tolerances."""
    tres, _, _ = _dynamic_chunks(None, meshes(k), 1)
    single, _, _ = _dynamic_chunks(None, None, 1, rebin_every=1)
    _hold_static(tres, single)
    assert float((_field(tres.deform) - _field(single.deform)).abs().max()) <= 2e-4


# ---------------------------------------------------------------------------
# the sharded helpers


def test_sharded_map_step_matches_reference(meshes, jmesh):
    """One ZeRO step (parameters and moments sharded along the capacity,
    4 views along the ranks) against the reference's `sharded_map_step`."""
    gmap, _, store = _state()
    poses = jnp.asarray(np.asarray(store.T_cw[:4]))
    imgs = jnp.asarray(np.asarray(store.images_u8[:4]), jnp.float32) / 255.0
    deps = jnp.asarray(np.asarray(store.depths[:4]))
    params = gmap.params._replace(f_dc=gmap.params.f_dc * 0.5)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jstep = j_sharded_step(jmesh, J_INTR, J_RASTER)
    jp, jmu, jnu, jcount, jloss = jstep(params, zeros, zeros, gmap.alive, jnp.int32(0), imgs,
                                        deps, poses)
    tp = tgm.GaussianParams(*(torch.tensor(np.asarray(x)) for x in params))
    tz = tp.map(torch.zeros_like)
    step = sharded_map_step(meshes(2), T_INTR)
    p, mu, nu, count, loss = step(tp, tz, tz, torch.tensor(np.asarray(gmap.alive)), 0,
                                  torch.tensor(np.asarray(imgs)), torch.tensor(np.asarray(deps)),
                                  torch.tensor(np.asarray(poses)))
    assert count == int(jcount) == 1
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for name in JParams._fields:
        np.testing.assert_allclose(getattr(p, name).numpy(), np.asarray(getattr(jp, name)),
                                   atol=2e-5, err_msg=name)
        b = np.asarray(getattr(jmu, name))
        np.testing.assert_allclose(getattr(mu, name).numpy(), b, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_batch_render_sharded_matches_reference(meshes, jmesh):
    gmap, _, store = _state()
    poses = np.asarray(store.T_cw[:4])
    jc, jd, ja = j_batch_render(jmesh, J_INTR, J_RASTER)(gmap.params, gmap.alive,
                                                         jnp.asarray(poses))
    tp = tgm.GaussianParams(*(torch.tensor(np.asarray(x)) for x in gmap.params))
    c, d, a = batch_render_sharded(meshes(2), T_INTR)(tp, torch.tensor(np.asarray(gmap.alive)),
                                                      torch.tensor(poses))
    assert c.shape == (4, 3, H, W)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-4)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=2e-5)


# ---------------------------------------------------------------------------
# failure and placement


def test_killed_worker_fails_rank_0_without_a_hang(tmp_path, monkeypatch):
    """A worker killed in the middle of a chunk: rank 0 raises MeshError
    within the group's timeout, and no worker process is left."""
    monkeypatch.setattr(mesh_mod, "DEFAULT_TIMEOUT_S", TIMEOUT_S)
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    assert mesh.timeout_s == TIMEOUT_S
    pid = mesh.pids[0]
    killer = threading.Timer(1.5, os.kill, (pid, signal.SIGKILL))
    t0 = time.time()
    killer.start()
    try:
        with pytest.raises(MeshError):
            _static_chunks(None, mesh, [3, 0, 2], 400, -1)
    finally:
        killer.cancel()
    assert time.time() - t0 < TIMEOUT_S
    assert mesh.closed
    for p in mesh._procs:
        assert not p.is_alive()


def test_mesh_wants_a_card_per_rank(monkeypatch):
    """No card is shared, and nothing runs on the CPU, unless placed so:
    with one card, a mesh of 2 raises (the runner's Training.mesh_devices
    goes through the same placement)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, 1 found"):
        placement(2)
    assert [str(d) for d in placement(1)] == ["cuda:0"]
    assert [str(d) for d in placement(2, ["cuda:0", "cuda:0"])] == ["cuda:0", "cuda:0"]
    assert [str(d) for d in placement(2, ["cpu", "cpu"])] == ["cpu", "cpu"]

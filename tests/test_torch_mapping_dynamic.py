"""4D mapping (slam/mapping_dynamic.py) against the JAX reference from the
same state with the same draws: the phase switch against the reference's
literal conditions, the field's Adam step, 3 iterations of the
deformation warmup, and `map_chunk_dynamic` at 64x48 with 3 window views
(one invalid), flow pairs and replay.

The JAX side renders through its Pallas kernels in interpret mode, so both
sides bin alike (window and flow views every 4 iterations, replay views
every iteration). It projects its flow payloads through constant view
cameras, as the port does (`_payload_camera`, the port's one departure
here): its own code, with `ndc_project`'s projection held constant;
`test_map_chunk_dynamic_departs_only_through_the_payload_camera` holds
the port against the reference as it is.

Tolerances. One iteration is held tightly (loss 1e-5, gradients within
1e-4). Over several, both Adams amplify rounding: at eps
1e-15 an element whose gradient differs in sign between the two sides
(one that is rounding noise, or moved by an alpha-floor flip of a
deformed Gaussian) steps by the full learning rate the other way, and the
field feeds the map (tests/test_parallel.py meets the same between two
JAX runs; `test_warmup_diverges_in_the_reference_itself` shows it
within JAX alone). So the multi-step tests bound the share of elements
that drift, and their drift by Adam's step bound."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.models import deform as jd
from fourdgs.slam import mapping as jm
from fourdgs.slam import mapping_dynamic as jmd
from fourdgs_torch import convert
from fourdgs_torch.models import deform as td
from fourdgs_torch.slam import mapping as tm
from fourdgs_torch.slam import mapping_dynamic as tmd
from tests.test_torch_mapping import J_INTR, J_RASTER, T_INTR, H, W, _state
from tests.test_torch_slam import jax_dynamic_draws, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

def _reference_phase(i, iters, flow_loss, cfg):
    """The reference's phase switch, written out."""
    if i < iters / 2:
        return True, flow_loss
    return False, cfg.get("flow_loss_fine", flow_loss)


def test_phase_weights_match_reference():
    for iters in (1, 2, 5, 20, 199, 200):
        for fine in (None, 2.0):
            cfg = {} if fine is None else {"flow_loss_fine": fine}
            for i in range(iters):
                want = _reference_phase(i, iters, 3.0, cfg)
                got = tmd.phase_weights(i, iters, 3.0, fine)
                jdyn, jw = jmd.phase_weights(jnp.int32(i), jnp.int32(iters), 3.0, fine)
                assert got == want == (bool(jdyn), float(jw)), (i, iters, fine)


def _dyn_state():
    """The static test state, opaque, with every third Gaussian dynamic,
    control nodes on them, and a field whose heads move the nodes visibly. The
    Gaussians are jittered off the state's constant-depth planes: there,
    depths tie exactly, and a deformation's rounding decides the
    compositing order of the tied pairs differently on the two sides."""
    gmap, adam, store = _state()
    rng = np.random.default_rng(9)
    alive = np.nonzero(np.asarray(gmap.alive))[0]
    jitter = np.zeros((gmap.capacity, 3), np.float32)
    jitter[alive] = rng.normal(0, 0.02, (len(alive), 3))
    dygs = np.zeros(gmap.capacity, bool)
    dygs[alive[::3]] = True
    # opaque enough that the warmup's loss (on opacity > 0.95) sees them
    gmap = gmap._replace(dygs=jnp.asarray(dygs), params=gmap.params._replace(
        xyz=gmap.params.xyz + jnp.asarray(jitter),
        opacity=jnp.where(gmap.alive[:, None], 3.0, gmap.params.opacity)))
    cn = jd.init_nodes(jax.random.key(1), 24, gmap.params.xyz, jnp.asarray(dygs), node_num=16)
    cn = cn._replace(mlp=cn.mlp._replace(head_warp=(
        jnp.asarray(rng.normal(0, 1e-3, (256, 3)), jnp.float32), cn.mlp.head_warp[1])))
    return gmap, adam, store, cn


def _to_port(gmap, adam, store, cn, dadam):
    return (convert.gaussian_map_from_arrays(gmap, "cpu"), convert.adam_from_arrays(adam, "cpu"),
            convert.store_from_arrays(store, "cpu"), convert.control_nodes_from_arrays(cn, "cpu"),
            convert.deform_adam_from_arrays(dadam, "cpu"))


def _check_map(tg, jg, steps, rtol=1e-4):
    """Map parameters within `rtol` of each field's largest magnitude but
    for at most 0.1% of the elements, each of those within the 2 lr per
    Adam step of an element whose gradient took the other sign."""
    tg = convert.gaussian_map_to_arrays(tg)
    lrs = tm.MapLRs()._asdict()
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = tg["params"][name], np.asarray(getattr(jg.params, name))
        err = np.abs(a - b)
        assert np.mean(err > rtol * np.abs(b).max()) <= 1e-3, name
        assert err.max() <= 2 * steps * lrs[name], (name, err.max())


def _check_field(tcn, jcn, atol):
    got = td.leaves(td.cn_floats(tcn))
    want = td.leaves(td.cn_floats(convert.control_nodes_from_arrays(jcn, "cpu")))
    worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert worst <= atol, worst
    np.testing.assert_array_equal(tcn.valid.numpy(), np.asarray(jcn.valid))
    return worst


def test_deform_adam_step_matches():
    _, _, _, cn = _dyn_state()
    rng = np.random.default_rng(3)
    f = jd.cn_floats(cn)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), f)
    jstate = jmd.init_deform_adam(cn)
    tf = td.cn_floats(convert.control_nodes_from_arrays(cn, "cpu"))
    tgrads = convert._floats_from(grads, "cpu")
    tstate = tmd.init_deform_adam(convert.control_nodes_from_arrays(cn, "cpu"))
    for _ in range(3):
        f, jstate = jmd.deform_adam_step(f, grads, jstate)
        tf, tstate = tmd.deform_adam_step(tf, tgrads, tstate)
    assert tstate.count == int(jstate.count) == 3
    for a, b in zip(td.leaves(tf), td.leaves(convert._floats_from(f, "cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip(td.leaves(tstate.nu), td.leaves(convert._floats_from(jstate.nu, "cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-12)


def test_warmup_network_matches():
    gmap, adam, store, cn = _dyn_state()
    dadam = jmd.init_deform_adam(cn)
    jcfg = jm.MappingConfig(num_window_views=3, alpha=0.9, raster=J_RASTER)
    jg, ja, jcn, jda, jloss = jmd.warmup_network(gmap, adam, cn, dadam, store, jnp.int32(2),
                                                 jnp.int32(3), jax.random.key(0), J_INTR,
                                                 jcfg)
    tg, ta, ts, tcn, tda = _to_port(gmap, adam, store, cn, dadam)
    tg, ta, tcn, tda, tloss = tmd.warmup_network(tg, ta, tcn, tda, ts, 2, 3, T_INTR,
                                                 tm.MappingConfig(num_window_views=3, alpha=0.9))
    assert ta.count == int(ja.count) == 3 and tda.count == int(jda.count) == 3
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-4)
    _check_map(tg, jg, 3)
    _check_field(tcn, jcn, 2 * 3 * tmd.DEFORM_LR)


def test_warmup_diverges_in_the_reference_itself():
    """Why the multi-step tolerances are what they are: two JAX warmups of
    100 steps whose fields start 1e-7 apart (relative) end with much of
    the field and some opacities far apart; the port, started equal,
    parts from JAX by the same order."""
    gmap, adam, store, cn = _dyn_state()
    rng = np.random.default_rng(0)
    cn2 = cn._replace(mlp=jax.tree.map(
        lambda x: x * (1 + 1e-7 * jnp.asarray(rng.normal(size=x.shape), jnp.float32)), cn.mlp))
    dadam = jmd.init_deform_adam(cn)
    jcfg = jm.MappingConfig(num_window_views=3, alpha=0.9, raster=J_RASTER)
    args = (store, jnp.int32(2), jnp.int32(100), jax.random.key(0), J_INTR, jcfg)
    a = jmd.warmup_network(gmap, adam, cn, dadam, *args)
    b = jmd.warmup_network(gmap, adam, cn2, dadam, *args)
    tg, ta, ts, tcn, tda = _to_port(gmap, adam, store, cn, dadam)
    t = tmd.warmup_network(tg, ta, tcn, tda, ts, 2, 100, T_INTR,
                           tm.MappingConfig(num_window_views=3, alpha=0.9))

    def field(cn_):
        return np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(cn_.mlp)])

    ref = field(a[2])
    jax_jax = np.mean(np.abs(field(b[2]) - ref) > 1e-4)
    port_jax = np.mean(np.abs(np.concatenate(
        [x.reshape(-1).numpy() for x in td.leaves(td.cn_floats(t[2]))[3:]]) - ref) > 1e-4)
    op_jax = np.abs(np.asarray(b[0].params.opacity - a[0].params.opacity)).max()
    op_port = np.abs(t[0].params.opacity.numpy() - np.asarray(a[0].params.opacity)).max()
    assert jax_jax > 0.2 and port_jax > 0.2, (jax_jax, port_jax)
    assert port_jax < 3 * jax_jax, (jax_jax, port_jax)
    assert op_jax > 0.1 and op_port < 10 * op_jax, (op_jax, op_port)


def _constant_payload_camera(fn):
    """A copy of the reference's `fn` whose `ndc_project` holds its
    projection constant: its flow payloads then reach no camera's pose.
    A new function object, so that jit traces it apart from `fn`."""
    g = dict(fn.__globals__,
             ndc_project=lambda x, full: jmd.ndc_project(x, jax.lax.stop_gradient(full)))
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


_jax_chunk_constant_payload_camera = jax.jit(
    _constant_payload_camera(jmd.map_chunk_dynamic.__wrapped__),
    static_argnames=("intr", "cfg", "flow_weight", "flow_weight_fine", "time_interval", "mesh"))


def _chunk(step_after, pool, iters, reference_as_is=False):
    """One JAX and one port `map_chunk_dynamic` from the same state with the
    same draws: 3 window views (the third invalid), flow pairs for the
    first two, replay from `pool`; the JAX side with constant payload
    cameras unless `reference_as_is`."""
    gmap, adam, store, cn = _dyn_state()
    dadam = jmd.init_deform_adam(cn)
    slots = np.array([1, 2, 0], np.int32)
    valid = np.array([True, True, False])
    opt_pose = np.array([True, False, False])
    pair_slots = np.array([0, 1, 3], np.int32)   # view 2 is invalid: no flow either
    rng = np.random.default_rng(5)
    fwd = rng.normal(0, 0.02, (3, 2, H, W)).astype(np.float32)
    bwd = rng.normal(0, 0.02, (3, 2, H, W)).astype(np.float32)
    pool_arr = np.zeros(8, np.int32)
    pool_arr[:len(pool)] = pool
    base = 40
    key = jax.random.key(3)
    jcfg = jm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9, raster=J_RASTER)
    kw = dict(flow_weight=3.0, flow_weight_fine=2.0, time_interval=1 / 8)
    j_chunk = jmd.map_chunk_dynamic if reference_as_is else _jax_chunk_constant_payload_camera
    jres = j_chunk(
        gmap, adam, store, cn, dadam, jnp.asarray(slots), jnp.asarray(valid),
        jnp.asarray(opt_pose), jnp.asarray(pair_slots), jnp.asarray(fwd), jnp.asarray(bwd),
        jnp.asarray(pool_arr), jnp.int32(len(pool)), jm.init_pose_adam(3), key,
        jnp.int32(iters), jnp.int32(step_after), jnp.int32(base), J_INTR, jcfg, **kw)
    tg, ta, ts, tcn, tda = _to_port(gmap, adam, store, cn, dadam)
    tres = tmd.map_chunk_dynamic(
        tg, ta, ts, tcn, tda, slots, valid, opt_pose, pair_slots, torch.tensor(fwd),
        torch.tensor(bwd), pool_arr, len(pool), tm.init_pose_adam(3, "cpu"),
        jax_dynamic_draws(key, iters, len(pool), 5), iters, step_after, base, T_INTR,
        tm.MappingConfig(num_window_views=3, num_random_views=2, alpha=0.9), **kw)
    assert tres.adam.count == int(jres.adam.count) == max(iters - max(step_after + 1, 0), 0)
    assert tres.deform_adam.count == int(jres.deform_adam.count) == iters
    tst = convert.store_to_arrays(tres.store)
    np.testing.assert_array_equal(tres.gmap.denom.numpy(), np.asarray(jres.gmap.denom))
    return tres, jres, tst, cn


@pytest.mark.parametrize("pool", [[3, 0], [3, 0, 2]])
def test_map_chunk_dynamic_first_step_matches_jax(pool):
    """One iteration: the loss, and the gradients (as Adam's first moments,
    0.1 g) of the map and the field within 1e-4 of each tensor's largest
    magnitude (the field's with the noise floor of
    tests/test_torch_deform.py)."""
    tres, jres, tst, _ = _chunk(-1, pool, 1)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-5)
    tmu = convert.adam_to_arrays(tres.adam)["mu"]
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        b = np.asarray(getattr(jres.adam.mu, name))
        np.testing.assert_allclose(tmu[name], b, atol=1e-4 * np.abs(b).max(), err_msg=name)
    got = td.leaves(tres.deform_adam.mu)
    want = td.leaves(convert._floats_from(jres.deform_adam.mu, "cpu"))
    top = max(float(b.abs().max()) for b in want)
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(b.abs().max()), 1e-3 * top)
        assert float((a - b).abs().max()) <= 1e-4 * scale, i
    assert float(want[2].abs().max()) > 0        # node weights: the gradient of |w| at 0
    np.testing.assert_allclose(tst["T_cw"], np.asarray(jres.store.T_cw), atol=1e-6)
    ga = np.asarray(jres.gmap.grad_accum)
    np.testing.assert_allclose(tres.gmap.grad_accum.numpy(), ga, atol=1e-4 * np.abs(ga).max())


@pytest.mark.parametrize("step_after,pool", [(-1, [3, 0]), (2, [3, 0, 2])])
def test_map_chunk_dynamic_matches_jax(step_after, pool):
    """Five iterations: a rebin at the fifth, the phase switch after the
    third, map steps from the fourth with step_after 2. Losses within 2e-3
    relative, poses within 1e-4, exposures within a tenth of their
    learning rate (1e-3); of each map field, 99% of the elements within
    1e-3 of its largest magnitude; of the field's parameters, 80% within
    1e-4 and all within the 2 lr per step that Adam's sign-like steps
    bound."""
    iters = 5
    tres, jres, tst, cn = _chunk(step_after, pool, iters)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=2e-3)
    np.testing.assert_allclose(tst["T_cw"], np.asarray(jres.store.T_cw), atol=1e-4)
    np.testing.assert_allclose(tst["exposure"], np.asarray(jres.store.exposure), atol=1e-3)
    tg = convert.gaussian_map_to_arrays(tres.gmap)
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        a, b = tg["params"][name], np.asarray(getattr(jres.gmap.params, name))
        err = np.abs(a - b) / np.abs(b).max()
        assert np.quantile(err, 0.99) <= 1e-3, (name, np.quantile(err, 0.99))
    err = (torch.cat([x.reshape(-1) for x in td.leaves(td.cn_floats(tres.deform))])
           - torch.cat([x.reshape(-1) for x in td.leaves(td.cn_floats(
               convert.control_nodes_from_arrays(jres.deform, "cpu")))])).abs()
    assert float((err > 1e-4).float().mean()) <= 0.2
    assert float(err.max()) <= 2 * iters * tmd.DEFORM_LR
    np.testing.assert_array_equal(tres.deform.valid.numpy(), np.asarray(jres.deform.valid))
    # the field learned something: its heads moved by several learning rates
    moved = np.abs(np.asarray(jres.deform.mlp.head_warp[0]) - np.asarray(cn.mlp.head_warp[0]))
    assert moved.max() > 3 * tmd.DEFORM_LR


def test_map_chunk_dynamic_departs_only_through_the_payload_camera():
    """Against the reference as it is, one iteration: the loss, the map's
    and the field's gradients and the poses of the views it does not
    optimize agree as in the first-step test; the optimized view (slot 1,
    with a flow pair) steps otherwise, since the reference's pose gradient
    also runs through its flow payload."""
    tres, jres, tst, _ = _chunk(-1, [3, 0], 1, reference_as_is=True)
    np.testing.assert_allclose(tres.final_loss, float(jres.final_loss), rtol=1e-5)
    tmu = convert.adam_to_arrays(tres.adam)["mu"]
    for name in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
        b = np.asarray(getattr(jres.adam.mu, name))
        np.testing.assert_allclose(tmu[name], b, atol=1e-4 * np.abs(b).max(), err_msg=name)
    want = np.asarray(jres.store.T_cw)
    others = [s for s in range(want.shape[0]) if s != 1]
    np.testing.assert_allclose(tst["T_cw"][others], want[others], atol=1e-6)
    assert np.abs(tst["T_cw"][1] - want[1]).max() > 1e-4

"""RAFT of the port (fourdgs_torch/perception/raft.py) against the JAX
package's (fourdgs/perception/raft.py) on the same seeded weights and
inputs, carried over by `convert.flow_state_dict`.

The parts are held within 1e-5 of the largest magnitude (bilinear
sampling, the correlation pyramid and its lookup, convex upsampling) and
the encoders within 1e-4; the whole network at 4 iterations within the
tolerance the reference holds against the original torch RAFT (atol
5e-3, rtol 1e-3, tests/test_perception_parity.py:72). At the provider's
20 iterations it is held within 1e-3 px, on weights whose flow head is
scaled by `FLOW_HEAD_GAIN` as the port's seeded weights are: at the full
gain of `make_params` the iteration is chaotic in the reference itself,
which a witness here shows. The `.npz` route (the JAX pytree) and the
`.pth` route (a state dict in the original RAFT's names) give equal
flows, equal to the JAX package's own `.pth` route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.perception import raft as jr
from fourdgs.perception.raft import RaftFlowProvider as JRaftFlowProvider
from fourdgs.perception.weights_io import save_pytree_npz as jsave
from fourdgs_torch import convert
from fourdgs_torch.perception import raft as tr
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_params(key: int, randomize_bn: bool = True, flow_gain: float = 1.0):
    """`make_params` with the context encoder's frozen batch-norm statistics
    and affine drawn at random (fresh ones are the identity, which a lost
    conversion would pass), and the flow head scaled by `flow_gain`."""
    p = jr.make_params(jax.random.key(key))
    rng = np.random.default_rng(key)
    if randomize_bn:
        for path, leaf in list(convert._leaves(p)):
            if path[0] == "cnet" and path[-1] in ("mean", "var", "weight", "bias") and \
                    any(str(s).startswith("norm") for s in path):
                node = p
                for s in path[:-1]:
                    node = node[s]
                lo, hi = {"mean": (-0.5, 0.5), "var": (0.5, 2.0), "weight": (0.5, 1.5),
                          "bias": (-0.2, 0.2)}[path[-1]]
                node[path[-1]] = jnp.asarray(rng.uniform(lo, hi, leaf.shape), jnp.float32)
    p["update"]["flow_conv2"]["weight"] = p["update"]["flow_conv2"]["weight"] * flow_gain
    return p


def port_model(params, cls=tr.RAFT, **kw):
    return tr.load_state(cls(**kw), convert.flow_state_dict(params)).eval()


def images(rng, h=96, w=128):
    """Two frames, the second the first shifted by 3 px with noise (the
    images of tests/test_perception_parity.py)."""
    a = rng.uniform(0, 255, (1, 3, h, w)).astype(np.float32)
    b = np.roll(a, 3, axis=3) * 0.95 + rng.uniform(0, 12, (1, 3, h, w)).astype(np.float32)
    return a, b.astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


@pytest.mark.parametrize("shape,n_pts", [((2, 3, 7, 9), 50), ((5, 1, 15, 20), 81),
                                         ((3, 1, 1, 1), 20)])
def test_bilinear_sample_matches(shape, n_pts):
    rng = np.random.default_rng(sum(shape))
    img = rng.normal(size=shape).astype(np.float32)
    # inside, on the border, outside, and on integer positions
    h, w = shape[2:]
    xy = rng.uniform(-2, [w + 1, h + 1], (shape[0], n_pts, 2)).astype(np.float32)
    xy[:, :5] = np.round(xy[:, :5])
    got = tr.bilinear_sample(torch.tensor(img), torch.tensor(xy))
    want = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("h,w", [(12, 16), (15, 22), (9, 11)])
def test_corr_pyramid_matches(h, w):
    # odd sizes floor at each pool, as reduce_window VALID does (15 -> 7)
    rng = np.random.default_rng(h * w)
    f1, f2 = rng.normal(size=(2, 1, 64, h, w)).astype(np.float32)
    got = tr.corr_pyramid(torch.tensor(f1), torch.tensor(f2))
    want = jr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    assert [tuple(g.shape) for g in got] == [tuple(x.shape) for x in want]
    for g, x in zip(got, want):
        if x.size:
            assert _rel(g, x) < 1e-5


@pytest.mark.parametrize("h,w,spread", [(12, 16, 3.0), (16, 20, 12.0)])
def test_corr_lookup_matches(h, w, spread):
    rng = np.random.default_rng(int(spread))
    f1, f2 = rng.normal(size=(2, 1, 32, h, w)).astype(np.float32)
    coords = (np.asarray(jr._coords_grid(h, w))
              + rng.normal(0, spread, (1, 2, h, w)).astype(np.float32))
    got = tr.corr_lookup(tr.corr_pyramid(torch.tensor(f1), torch.tensor(f2)),
                         torch.tensor(coords))
    want = jr.corr_lookup(jr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)),
                          jnp.asarray(coords))
    assert got.shape == want.shape == (1, tr.COR_PLANES, h, w)
    assert _rel(got, want) < 1e-5


def test_corr_lookup_channel_order():
    # channel i*9+j samples offset (x + i - 4, y + j - 4): a correlation
    # volume that is the x coordinate reads back its x offsets
    h, w = 12, 16
    corr = torch.arange(w, dtype=torch.float32).expand(h * w, 1, h, w).contiguous()
    pyramid = [corr]
    for _ in range(3):
        pyramid.append(torch.nn.functional.avg_pool2d(pyramid[-1], 2, 2))
    coords = tr.coords_grid(1, h, w, "cpu")
    out = tr.corr_lookup(pyramid, coords)[0, :81, 6, 8]
    np.testing.assert_array_equal(out.numpy().reshape(9, 9),
                                  np.repeat(np.arange(4, 13, dtype=np.float32)[:, None], 9, 1))


@pytest.mark.parametrize("h,w", [(4, 5), (6, 8)])
def test_upsample_flow_matches(h, w):
    rng = np.random.default_rng(h + w)
    flow = rng.normal(0, 3, (1, 2, h, w)).astype(np.float32)
    mask = rng.normal(0, 2, (1, 64 * 9, h, w)).astype(np.float32)
    got = tr.upsample_flow(torch.tensor(flow), torch.tensor(mask))
    want = jr._upsample_flow(jnp.asarray(flow), jnp.asarray(mask))
    assert got.shape == want.shape == (1, 2, 8 * h, 8 * w)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("encoder", ["fnet", "cnet"])
def test_encoders_match(encoder):
    p = jax_params(3)
    model = port_model(p)
    x = np.random.default_rng(4).uniform(-1, 1, (1, 3, 64, 80)).astype(np.float32)
    with torch.no_grad():
        got = getattr(model, encoder)(torch.tensor(x))
    want = jr.encoder_forward(p[encoder], jnp.asarray(x))
    assert got.shape == want.shape == (1, 256, 8, 10)
    assert _rel(got, want) < 1e-4


def test_raft_forward_matches_at_4_iterations():
    p = jax_params(0)
    a, b = images(np.random.default_rng(0))
    with torch.no_grad():
        got = port_model(p)(torch.tensor(a), torch.tensor(b), iters=4).numpy()
    want = np.asarray(jr.raft_forward(p, jnp.asarray(a), jnp.asarray(b), iters=4))
    assert np.abs(want).max() > 5.0
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)


def test_raft_forward_matches_at_20_iterations():
    p = jax_params(0, flow_gain=tr.FLOW_HEAD_GAIN)
    a, b = images(np.random.default_rng(1))
    with torch.no_grad():
        got = port_model(p)(torch.tensor(a), torch.tensor(b), iters=20).numpy()
    want = np.asarray(jr.raft_forward(p, jnp.asarray(a), jnp.asarray(b), iters=20))
    assert np.median(np.abs(want)) > 1.0      # flows of a few pixels, not zero
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_full_gain_iteration_is_chaotic_in_the_reference():
    # why the 20-iteration parity uses a damped flow head: at make_params'
    # gain a 1e-7 relative change of one input moves the reference's own
    # 20-iteration flow by far more than the port's tolerance
    p = jax_params(0)
    rng = np.random.default_rng(0)
    a, b = images(rng)
    a2 = a * (1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32)
    f1, f2 = (np.asarray(jr.raft_forward(p, jnp.asarray(x), jnp.asarray(b), iters=20))
              for x in (a, a2))
    assert np.abs(f1 - f2).max() > 5e-2


def _pth_state_dict(model):
    """The port's weights as the original RAFT's DataParallel checkpoint
    holds them: `module.` prefixes, batch-norm step counts and no affine on
    the instance norms (the port's are at 1 and 0)."""
    sd = {}
    for k, v in model.state_dict().items():
        sub = model.get_submodule(k.rsplit(".", 1)[0])
        if isinstance(sub, tr.Norm2d) and not sub.batch:
            assert torch.equal(v, torch.ones_like(v) if k.endswith("weight") else
                               torch.zeros_like(v))
            continue
        sd[f"module.{k}"] = v.clone()
        if k.endswith("running_var"):
            sd[f"module.{k[:-len('running_var')]}num_batches_tracked"] = torch.tensor(7)
    return sd


def test_npz_and_pth_routes_give_equal_flows(tmp_path):
    p = jax_params(5, flow_gain=tr.FLOW_HEAD_GAIN)
    npz, pth = str(tmp_path / "raft-things.npz"), str(tmp_path / "raft-things.pth")
    jsave(npz, p)
    torch.save(_pth_state_dict(port_model(p)), pth)
    rng = np.random.default_rng(6)
    # 100 x 130: padded to 104 x 136 by edge replication, cropped back
    a, b = (rng.uniform(0, 1, (3, 100, 130)).astype(np.float32) for _ in range(2))
    flows = [tr.RaftFlowProvider(path, iters=6, device="cpu")(1, 0, a, b) for path in (npz, pth)]
    for f_npz, f_pth in zip(*flows):
        assert f_npz.shape == (100, 130, 2)
        np.testing.assert_array_equal(f_npz, f_pth)
    # the JAX package's provider on its own .pth route, same images
    want = JRaftFlowProvider(pth, iters=6)(1, 0, a, b)
    for got, w in zip(flows[1], want):
        np.testing.assert_allclose(got, w, atol=1e-3, rtol=0)


def test_weights_that_do_not_fit_raise(tmp_path):
    model = port_model(jax_params(0, randomize_bn=False))
    sd = _pth_state_dict(model)
    path = str(tmp_path / "raft-things.pth")
    torch.save({k: v for k, v in sd.items() if "convz1" not in k}, path)
    with pytest.raises(ValueError, match="missing"):
        tr.RaftFlowProvider(path, device="cpu")
    torch.save({**sd, "module.extra.weight": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="unexpected"):
        tr.RaftFlowProvider(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        tr.RaftFlowProvider(str(tmp_path / "absent.npz"), device="cpu")


def test_seeded_weights_round_trip_through_the_jax_layout():
    model = tr.init_weights(tr.RAFT(), torch.Generator().manual_seed(0))
    params = convert.flow_params(model)
    ref = jr.make_params()
    assert ({p for p, _ in convert._leaves(params)} == {p for p, _ in convert._leaves(ref)})
    for path, leaf in convert._leaves(params):
        node = ref
        for s in path:
            node = node[s]
        assert leaf.shape == node.shape, path
    again = port_model(params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_full_float32_restores_the_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tr.full_float32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before

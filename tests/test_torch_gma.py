"""GMA of the port (fourdgs_torch/perception/gma.py) against the JAX
package's (fourdgs/perception/gma.py) on the same seeded weights, with
the residual weight `gamma` at 0.7 (it initialises at 0, which would
leave the aggregation untested; tests/test_perception_parity.py:91 sets
it alike). Attention and aggregation within 1e-5 of the largest
magnitude; the network at 4 iterations within atol 5e-3, rtol 1e-3, and
at the provider's 12 iterations within 1e-3 px on the damped flow head
of tests/test_torch_raft.py; the optional `project` convolution; and the
`.npz` and `.pth` routes (the latter with the original GMA's unused
relative-position embeddings) giving equal flows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.perception import gma as jg
from fourdgs.perception.gma import GmaFlowProvider as JGmaFlowProvider
from fourdgs_torch import convert
from fourdgs_torch.perception import gma as tg
from fourdgs_torch.perception import raft as tr
from fourdgs_torch.perception.weights_io import save_pytree_npz
from tests.test_torch_raft import _pth_state_dict, _rel, images, port_model
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def gma_params(key: int, flow_gain: float = 1.0, project: bool = False):
    p = jg.make_gma_params(jax.random.key(key))
    p["att"]["gamma"] = jnp.float32(0.7)
    p["update"]["flow_conv2"]["weight"] = p["update"]["flow_conv2"]["weight"] * flow_gain
    if project:
        w = jax.random.normal(jax.random.key(key + 100), (tg.DIM_HEAD, tg.DIM_HEAD, 1, 1))
        p["att"]["project"] = {"weight": w * 0.1, "bias": jnp.zeros(tg.DIM_HEAD)}
    return p


@pytest.mark.parametrize("h,w", [(6, 8), (12, 16)])
def test_attention_and_aggregate_match(h, w):
    p = gma_params(2)
    model = port_model(p, tg.GMA)
    rng = np.random.default_rng(h)
    ctx, motion = rng.normal(size=(2, 1, 128, h, w)).astype(np.float32)
    with torch.no_grad():
        attn = model.att(torch.tensor(ctx))
        agg = model.update_block.aggregator(attn, torch.tensor(motion))
    want_attn = jg.global_attention(p["att"], jnp.asarray(ctx))
    want_agg = jg.aggregate(p["att"], want_attn, jnp.asarray(motion))
    assert attn.shape == (1, h * w, h * w)
    assert _rel(attn[0], want_attn) < 1e-5
    assert _rel(agg, want_agg) < 1e-5


@pytest.mark.parametrize("iters,gain,project", [(4, 1.0, False), (12, tr.FLOW_HEAD_GAIN, False),
                                                (4, 1.0, True)])
def test_gma_forward_matches(iters, gain, project):
    p = gma_params(1, gain, project)
    model = port_model(p, tg.GMA, project=project)
    assert (model.update_block.aggregator.project is not None) == project
    a, b = images(np.random.default_rng(iters))
    with torch.no_grad():
        got = model(torch.tensor(a), torch.tensor(b), iters=iters).numpy()
    want = np.asarray(jg.gma_forward(p, jnp.asarray(a), jnp.asarray(b), iters=iters))
    assert np.median(np.abs(want)) > 0.5
    if iters == 4:
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_npz_and_pth_routes_give_equal_flows(tmp_path):
    p = gma_params(3, tr.FLOW_HEAD_GAIN)
    npz, pth = str(tmp_path / "gma-things.npz"), str(tmp_path / "gma-things.pth")
    save_pytree_npz(npz, p)
    sd = _pth_state_dict(port_model(p, tg.GMA))
    sd["module.att.pos_emb.rel_height.weight"] = torch.zeros(319, 128)
    sd["module.att.pos_emb.rel_width.weight"] = torch.zeros(319, 128)
    torch.save(sd, pth)
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(0, 1, (3, 96, 128)).astype(np.float32) for _ in range(2))
    providers = [tg.GmaFlowProvider(path, device="cpu") for path in (npz, pth)]
    assert [pr.iters for pr in providers] == [12, 12]
    flows = [pr(2, 1, a, b) for pr in providers]
    for f_npz, f_pth in zip(*flows):
        np.testing.assert_array_equal(f_npz, f_pth)
    # the JAX package's provider on its own .pth route
    want = JGmaFlowProvider(pth)(2, 1, a, b)
    for got, w in zip(flows[1], want):
        np.testing.assert_allclose(got, w, atol=1e-3, rtol=0)


def test_nonzero_attention_bias_raises():
    p = gma_params(0)
    p["att"]["to_qk"]["bias"] = p["att"]["to_qk"]["bias"] + 1.0
    with pytest.raises(ValueError, match="to_qk/bias"):
        convert.flow_state_dict(p)


def test_raft_weights_do_not_load_as_gma(tmp_path):
    path = str(tmp_path / "raft-things.pth")
    torch.save(_pth_state_dict(tr.init_weights(tr.RAFT(), torch.Generator().manual_seed(0))),
               path)
    # RAFT's GRU takes 384 input channels, GMA's 512
    with pytest.raises(RuntimeError, match="size mismatch for update_block.gru.convz1"):
        tg.GmaFlowProvider(path, device="cpu")

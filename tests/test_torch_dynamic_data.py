"""The host-side and loss pieces of the 4D path against the JAX reference:
the dynamic synthetic sequence (frames within the rasterizer's tolerances
but for alpha-floor flips, motion masks exactly equal), the exact
synthetic flows (equal to 1e-6 px), the dynamic losses (1e-6 relative),
`merge_hparams` (the cases of tests/test_config.py), the Gaussian map's
`dygs` flag through insert and resize, and the carrying of control nodes
and their Adam state across through numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.data.synthetic import SyntheticDataset as JSynthetic
from fourdgs.models import deform as jd
from fourdgs.models import gaussian_map as jgm
from fourdgs.perception.flow import FlowCache as JFlowCache
from fourdgs.perception.flow import SyntheticFlowProvider as JFlow
from fourdgs.slam import losses as jl
from fourdgs.slam.mapping_dynamic import init_deform_adam as j_init_adam
from fourdgs_torch import convert
from fourdgs_torch.data.synthetic import SyntheticDataset as TSynthetic
from fourdgs_torch.models import gaussian_map as tgm
from fourdgs_torch.perception.flow import FlowCache, SyntheticFlowProvider
from fourdgs_torch.slam import losses as tl
from fourdgs_torch.utils.config import hidden_params_defaults, merge_hparams
from tests.test_torch_keyframes import _close_but_for_threshold_flips
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(w, h, frames=6):
    return {"Dataset": {"type": "synthetic", "num_frames": frames, "points_per_wall": 300,
                        "dynamic": True,
                        "Calibration": {"fx": 90.0, "fy": 90.0, "cx": (w - 1) / 2,
                                        "cy": (h - 1) / 2, "width": w, "height": h}}}


@pytest.fixture(scope="module")
def datasets():
    # above 96x96 so that the JAX sequence renders through its Pallas
    # kernels, as the port renders through its compositor
    cfg = _cfg(112, 100)
    return JSynthetic(None, "", cfg), TSynthetic(None, "", cfg, "cpu")


def test_dynamic_frames_and_masks_match(datasets):
    jd_, td_ = datasets
    for i in (0, 4):
        ji, jdep, jT, jm = jd_[i]
        ti, tdep, tT, tm = td_[i]
        np.testing.assert_array_equal(tT, jT)
        np.testing.assert_array_equal(tm, jm)
        assert (~tm).sum() > 50            # the blob is in view
        _close_but_for_threshold_flips(ti, ji, 2e-5, 1.0)
        _close_but_for_threshold_flips(tdep, jdep, 2e-4, float(jdep.max()))
    # the blob moves: its mask differs between frames
    assert (td_[0][3] != td_[4][3]).any()


def test_synthetic_flows_match(datasets):
    jd_, td_ = datasets
    jc, tc = JFlowCache(JFlow(jd_)), FlowCache(SyntheticFlowProvider(td_))
    for a, b in ((3, 1), (5, 0)):
        jf, jb, jfm, jbm = jc.get(a, b)
        tf, tb, tfm, tbm = tc.get(a, b)
        # both flows come from each package's own depth render
        _, jdep, _, _ = jd_[a]
        _, tdep, _, _ = td_[a]
        same = np.abs(jdep - tdep) < 1e-4
        assert same.mean() > 0.999
        np.testing.assert_allclose(tb[:, same], jb[:, same], atol=1e-6)
        assert np.abs(tb).max() > 0.01
        _, jdep2, _, _ = jd_[b]
        _, tdep2, _, _ = td_[b]
        same2 = np.abs(jdep2 - tdep2) < 1e-4
        np.testing.assert_allclose(tf[:, same2], jf[:, same2], atol=1e-6)
    # and on identical inputs, exactly: the port's provider on the JAX frames
    tc2 = FlowCache(SyntheticFlowProvider(jd_))
    np.testing.assert_array_equal(tc2.get(3, 1)[0], jc.get(3, 1)[0])
    np.testing.assert_array_equal(tc2.get(3, 1)[1], jc.get(3, 1)[1])
    # with the forward-backward consistency masks of the same flows
    np.testing.assert_array_equal(tc2.get(3, 1)[2], jc.get(3, 1)[2])
    np.testing.assert_array_equal(tc2.get(3, 1)[3], jc.get(3, 1)[3])


def test_dynamic_losses_match():
    rng = np.random.default_rng(0)
    h, w = 12, 16
    img, gt = rng.uniform(0, 1, (2, 3, h, w)).astype(np.float32)
    depth, gdepth = rng.uniform(0.5, 3, (2, h, w)).astype(np.float32)
    opac = rng.uniform(0.8, 1.0, (h, w)).astype(np.float32)
    motion = rng.uniform(size=(h, w)) > 0.3
    t = torch.tensor
    for dyn in (False, True):
        a = tl.mapping_loss_rgbd(t(img), t(depth), t(gt), t(gdepth), motion_mask=t(motion),
                                 alpha=0.9, rm_dynamic=False, dynamic=dyn)
        b = jl.mapping_loss_rgbd(img, depth, gt, gdepth, motion_mask=motion, alpha=0.9,
                                 rm_dynamic=False, dynamic=jnp.asarray(dyn))
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        a = tl.network_loss_rgbd(t(img), t(depth), t(opac), t(gt), t(gdepth),
                                 motion_mask=t(motion), dynamic=dyn)
        b = jl.network_loss_rgbd(img, depth, opac, gt, gdepth, motion_mask=motion,
                                 dynamic=dyn)
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # batched over views: one loss per view
    batch = tl.mapping_loss_rgbd(t(np.stack([img, gt])), t(np.stack([depth, gdepth])),
                                 t(np.stack([gt, img])), t(np.stack([gdepth, depth])),
                                 motion_mask=t(np.stack([motion, ~motion])), alpha=0.9,
                                 dynamic=True)
    np.testing.assert_allclose(float(batch[1]), float(jl.mapping_loss_rgbd(
        gt, gdepth, img, depth, motion_mask=~motion, alpha=0.9, dynamic=True)), rtol=1e-6)
    flows = rng.normal(0, 0.1, (4, 2, h, w)).astype(np.float32)
    masks = rng.uniform(size=(2, h, w)) > 0.5
    a = tl.masked_flow_l1(t(flows[:2]), t(flows[2:]), t(masks))
    for v in range(2):
        np.testing.assert_allclose(float(a[v]), float(jl.masked_flow_l1(
            flows[v], flows[2 + v], masks[v])), rtol=1e-6)
    assert float(tl.masked_flow_l1(t(flows[0]), t(flows[1]), t(np.zeros((h, w), bool)))) == 0.0


def test_merge_hparams_matches():
    from fourdgs.utils.config import merge_hparams as j_merge

    cfg = {"ModelHiddenParams": {"net_width": 128,
                                 "kplanes_config": {"resolution": [64, 64, 64, 345]}}}
    hp = merge_hparams(cfg)
    assert hp.net_width == 128
    assert hp.kplanes_config.resolution == [64, 64, 64, 345]
    assert hp.kplanes_config.output_coordinate_dim == 32
    assert hp.node_num == 512 and hp.K == 3
    assert hp == j_merge(cfg)
    assert merge_hparams({"ModelHiddenParams": None}) == hidden_params_defaults()
    d = hidden_params_defaults()
    assert d.deform_type == "node" and d.no_do is True and d.no_dshs is True
    np.testing.assert_allclose(d.position_lr_init, 0.00016)


def test_dygs_through_insert_and_resize():
    rng = np.random.default_rng(1)
    n = 40
    cands = dict(xyz=rng.normal(size=(n, 3)), rgb=rng.uniform(size=(n, 3)),
                 scaling=rng.normal(-3, 0.1, (n, 3)), rotation=np.tile([1.0, 0, 0, 0], (n, 1)),
                 opacity=np.zeros((n, 1)), valid=rng.uniform(size=n) > 0.2)
    jc = jgm.NewGaussians(**{k: jnp.asarray(v, jnp.float32 if k != "valid" else bool)
                             for k, v in cands.items()})
    tc = tgm.NewGaussians(**{k: torch.tensor(v, dtype=torch.float32 if k != "valid"
                                             else torch.bool) for k, v in cands.items()})
    jm, ja = jgm.empty_map(64), jgm.init_adam(64)
    tm, ta = tgm.empty_map(64, "cpu"), tgm.init_adam(64, "cpu")
    for dygs in (False, True):
        jm, ja, jn = jgm.insert(jm, ja, jc, kf_id=3, dygs=dygs)
        tm, ta, tn = tgm.insert(tm, ta, tc, kf_id=3, dygs=dygs)
        assert tn == int(jn)
    jm, ja = jgm.resize_map(jm, ja, 128)
    tm, ta = tgm.resize_map(tm, ta, 128)
    np.testing.assert_array_equal(tm.dygs.numpy(), np.asarray(jm.dygs))
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    assert 0 < int(tm.dygs.sum()) < int(tm.alive.sum())
    jm, ja = jgm.resize_map(jm, ja, 64)
    tm, ta = tgm.resize_map(tm, ta, 64)
    np.testing.assert_array_equal(tm.dygs.numpy(), np.asarray(jm.dygs))


def test_control_nodes_and_adam_round_trip():
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.normal(size=(100, 3)), jnp.float32)
    jcn = jd.init_nodes(jax.random.key(0), 16, pts, jnp.ones(100, bool), node_num=12)
    jadam = j_init_adam(jcn)
    jadam = jadam._replace(mu=jax.tree.map(lambda x: x + 0.5, jadam.mu),
                           count=jnp.int32(7))
    tcn = convert.control_nodes_from_arrays(jcn, "cpu")
    tadam = convert.deform_adam_from_arrays(jadam, "cpu")
    assert tadam.count == 7
    back = convert.control_nodes_to_arrays(tcn)
    rebuilt = jd.ControlNodes(
        nodes=back["nodes"], radius_raw=back["radius_raw"], weight_raw=back["weight_raw"],
        valid=back["valid"], mlp=jd.MLPParams(**{k: tuple(v) for k, v in back["mlp"].items()}))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(jcn)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    aback = convert.deform_adam_to_arrays(tadam)
    assert int(aback["count"]) == 7
    np.testing.assert_array_equal(aback["mu"]["mlp"]["weights"][3],
                                  np.asarray(jadam.mu.mlp.weights[3]))
    np.testing.assert_array_equal(aback["nu"]["radius_raw"], np.asarray(jadam.nu.radius_raw))

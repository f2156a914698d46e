"""`render_flow` (ops/rasterize/api.py) against the JAX reference at 64x48,
and the three behaviours `tests/test_render_flow.py` holds the reference
to, on the port.

The JAX side renders through its Pallas kernels in interpret mode, the
port through its plain compositor. Tolerances are the rasterizer's
(ROADMAP): colour and alpha within 2e-5, depth within 2e-4; gradients with
respect to d_xyz2, d_scale1 and d_rot1 within 3e-3 of the largest
magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.geometry import projection_matrix as j_proj
from fourdgs.geometry import se3_exp as j_se3
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.ops.rasterize import render_flow as j_render_flow
from fourdgs_torch.geometry import projection_matrix, se3_exp
from fourdgs_torch.ops.rasterize.api import render_flow
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 64, 48
FX = FY = 60.0
CX, CY = (W - 1) / 2.0, (H - 1) / 2.0
KW = dict(fx=FX, fy=FY, width=W, height=H, tan_fovx=W / (2 * FX), tan_fovy=H / (2 * FY))
J_CFG = JRasterConfig(use_oracle=False, tile_cap=128, max_pairs=1 << 14,
                      with_n_touched=False)
PROJ = projection_matrix(FX, FY, CX, CY, W, H, device="cpu")


def _scene(n=16, seed=0):
    """The scene of tests/test_render_flow.py, as numpy."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                    rng.uniform(2, 4, n)], -1).astype(np.float32)
    scales = np.full((n, 3), 0.15, np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    opac = np.full((n,), 0.9, np.float32)
    dygs = np.arange(n) % 2 == 0
    alive = np.ones(n, bool)
    return xyz, scales, quats, opac, dygs, alive


def _t(a):
    return torch.tensor(np.asarray(a))


def test_render_flow_matches_jax():
    xyz, scales, quats, opac, dygs, alive = _scene(24, seed=3)
    rng = np.random.default_rng(4)
    n = xyz.shape[0]
    dy = dygs[:, None].astype(np.float32)
    d_xyz1 = (rng.normal(0, 0.03, (n, 3)) * dy).astype(np.float32)
    d_xyz2 = (rng.normal(0, 0.08, (n, 3)) * dy).astype(np.float32)
    d_rot1 = (rng.normal(0, 0.05, (n, 4)) * dy).astype(np.float32)
    d_scale1 = (rng.normal(0, 0.02, (n, 3)) * dy).astype(np.float32)
    tau1 = np.array([0.02, -0.01, 0.0, 0.01, 0.0, -0.02], np.float32)
    tau2 = np.array([-0.03, 0.02, 0.01, 0.0, 0.02, 0.0], np.float32)
    weights = rng.normal(size=(3, H, W)).astype(np.float32)

    def jloss(d2, ds1, dr1):
        out = j_render_flow(
            jnp.asarray(xyz), jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(opac),
            jnp.asarray(dygs), jnp.asarray(alive), jnp.asarray(d_xyz1), d2, dr1, ds1,
            j_se3(jnp.asarray(tau1)), j_se3(jnp.asarray(tau2)),
            j_proj(FX, FY, CX, CY, W, H), **KW, config=J_CFG)
        return jnp.sum(out.color * jnp.asarray(weights)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(d_xyz2), jnp.asarray(d_scale1), jnp.asarray(d_rot1))

    leaves = [_t(a).requires_grad_(True) for a in (d_xyz2, d_scale1, d_rot1)]
    tout = render_flow(_t(xyz), _t(scales), _t(quats), _t(opac), _t(dygs), _t(alive),
                       _t(d_xyz1), leaves[0], leaves[2], leaves[1], se3_exp(_t(tau1)),
                       se3_exp(_t(tau2)), PROJ, **KW)
    tgrads = torch.autograd.grad(torch.sum(tout.color * _t(weights)), leaves)

    np.testing.assert_allclose(tout.color.detach().numpy(), np.asarray(jout.color), atol=2e-5)
    np.testing.assert_allclose(tout.alpha.detach().numpy(), np.asarray(jout.alpha), atol=2e-5)
    np.testing.assert_allclose(tout.depth.detach().numpy(), np.asarray(jout.depth), atol=2e-4)
    assert float(np.abs(np.asarray(jout.color[:2])).max()) > 0.01     # signed, non-trivial
    assert float(np.asarray(jout.color[:2]).min()) < 0
    for name, a, b in zip(("d_xyz2", "d_scale1", "d_rot1"), tgrads, jgrads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=3e-3 * np.abs(b).max(), err_msg=name)
        assert np.abs(b).max() > 0, name


def _flow(xyz, scales, quats, opac, dygs, alive, d1, d2, z4=None):
    n = xyz.shape[0]
    z4 = torch.zeros((n, 4)) if z4 is None else z4
    eye = torch.eye(4)
    return render_flow(_t(xyz), _t(scales), _t(quats), _t(opac), _t(dygs), _t(alive),
                       d1, d2, z4, torch.zeros((n, 3)), eye, eye, PROJ, **KW)


def test_flow_zero_when_static():
    xyz, scales, quats, opac, dygs, alive = _scene()
    z3 = torch.zeros(xyz.shape)
    out = _flow(xyz, scales, quats, opac, dygs, alive, z3, z3)
    np.testing.assert_allclose(out.color[:2].numpy(), 0.0, atol=1e-5)
    # the dygs channel renders the dynamic Gaussians' footprint
    assert float(out.color[2].max()) > 0.3


def test_flow_matches_projection_shift():
    """Dynamic Gaussians moved by dx render, over their footprint, the NDC
    displacement 2 fx dx / (z W), for depths z in [2, 4]."""
    xyz, scales, quats, opac, dygs, alive = _scene()
    d2 = torch.where(_t(dygs)[:, None], torch.tensor([[0.1, 0.0, 0.0]]), 0.0)
    out = _flow(xyz, scales, quats, opac, dygs, alive, torch.zeros(xyz.shape), d2)
    sel = (out.color[2].numpy() > 0.6) & (out.alpha.numpy() > 0.8)
    assert sel.sum() > 20
    vals = out.color[0].numpy()[sel]
    assert np.all(vals > 0.02), vals.min()
    assert np.all(vals < 0.12), vals.max()


def test_flow_gradients_reach_deformation():
    xyz, scales, quats, opac, dygs, alive = _scene()
    d2 = torch.zeros(xyz.shape, requires_grad=True)
    out = _flow(xyz, scales, quats, opac, dygs, alive, torch.zeros(xyz.shape), d2)
    # off the kink: torch's |x| has gradient 0 at 0, where JAX's takes 1
    (g,) = torch.autograd.grad(torch.mean(torch.abs(out.color[:2] - 0.01)), d2)
    gn = torch.linalg.norm(g, dim=-1).numpy()
    assert np.all(np.isfinite(gn))
    assert gn[dygs].max() > 0


def test_flow_payload_batches_over_views():
    """The batched payload (one per flow view, as 4D mapping builds it)
    equals the single-view one, view by view, and the NDC projection the
    reference's (1e-5 relative)."""
    from fourdgs.ops.rasterize.api import ndc_project as j_ndc
    from fourdgs_torch.ops.rasterize.api import flow_payload, ndc_project

    def jax_ndc(x, full):
        return np.asarray(j_ndc(jnp.asarray(x.numpy()), jnp.asarray(full.numpy())))

    views = 3
    rng = np.random.default_rng(5)
    x1 = _t(rng.normal(0, 0.5, (views, 20, 3)).astype(np.float32)) + torch.tensor([0, 0, 3.0])
    x2 = x1 + _t(rng.normal(0, 0.05, (views, 20, 3)).astype(np.float32))
    T1 = se3_exp(_t(rng.normal(0, 0.05, (views, 6)).astype(np.float32)))
    T2 = se3_exp(_t(rng.normal(0, 0.05, (views, 6)).astype(np.float32)))
    dygs = _t(rng.uniform(size=20) > 0.5)
    batch = flow_payload(x1, x2, PROJ @ T1, PROJ @ T2, dygs)
    for v in range(views):
        one = flow_payload(x1[v], x2[v], PROJ @ T1[v], PROJ @ T2[v], dygs)
        np.testing.assert_allclose(batch[v].numpy(), one.numpy(), rtol=1e-6, atol=1e-7)
        want = jax_ndc(x2[v], PROJ @ T2[v]) - jax_ndc(x1[v], PROJ @ T1[v])
        np.testing.assert_allclose(one[:, :2].numpy(), want[:, :2], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(one[:, 2].numpy(), dygs.numpy().astype(np.float32))
        np.testing.assert_allclose(ndc_project(x1[v], PROJ @ T1[v]).numpy(),
                                   jax_ndc(x1[v], PROJ @ T1[v]), rtol=1e-5, atol=1e-6)

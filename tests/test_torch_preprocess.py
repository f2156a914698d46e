"""Parity of fourdgs_torch.ops.rasterize.preprocess with the JAX reference:
every ScreenGaussians field (1e-5), and autograd gradients against
jax.grad for means, scales, quats, opacity and the pose tau through
se3_exp (1e-4)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.geometry import projection_matrix as j_proj, se3_exp as j_se3
from fourdgs_torch.geometry import projection_matrix as t_proj, se3_exp as t_se3

# the modules, not the functions both packages re-export under that name
jpre = importlib.import_module("fourdgs.ops.rasterize.preprocess")
tpre = importlib.import_module("fourdgs_torch.ops.rasterize.preprocess")

W, H = 64, 48
FX, FY = 60.0, 62.0
CX, CY = (W - 1) / 2.0, (H - 1) / 2.0
KW = dict(fx=FX, fy=FY, width=W, height=H, tan_fovx=W / (2 * FX), tan_fovy=H / (2 * FY))


def _scene(seed=0, n=64):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(-0.5, 6.0, n)], -1).astype(np.float32)  # some behind the camera
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.6), (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    tau = np.array([0.05, -0.03, 0.1, 0.02, -0.04, 0.03], np.float32)
    return means, scales, quats, opac, colors, alive, tau


def _both(seed, max_radius=24, scale_mod=1.0):
    means, scales, quats, opac, colors, alive, tau = _scene(seed)
    jsg = jpre.preprocess(*map(jnp.asarray, (means, scales, quats, opac, colors, alive)),
                          j_se3(jnp.asarray(tau)), j_proj(FX, FY, CX, CY, W, H),
                          scale_mod=scale_mod, max_radius=max_radius, **KW)
    tsg = tpre.preprocess(*map(torch.tensor, (means, scales, quats, opac, colors, alive)),
                          t_se3(torch.tensor(tau)), t_proj(FX, FY, CX, CY, W, H, device="cpu"),
                          scale_mod=scale_mod, max_radius=max_radius, **KW)
    return jsg, tsg


@pytest.mark.parametrize("seed,max_radius,scale_mod", [(0, 24, 1.0), (1, None, 1.0), (2, 8, 1.3)])
def test_screen_gaussians_match(seed, max_radius, scale_mod):
    jsg, tsg = _both(seed, max_radius, scale_mod)
    vis = np.asarray(jsg.visible)
    np.testing.assert_array_equal(tsg.visible.numpy(), vis)
    np.testing.assert_array_equal(tsg.radius.numpy(), np.asarray(jsg.radius))
    for name in ("mean2d", "depth", "conic", "opacity", "color", "sigma3"):
        a, b = getattr(tsg, name).numpy(), np.asarray(getattr(jsg, name))
        # culled Gaussians carry guarded placeholder values; compare all,
        # with an absolute floor scaled to each field's magnitude
        np.testing.assert_allclose(a[vis], b[vis], rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_cov3d_and_ewa_match():
    means, scales, quats, *_ , tau = _scene(3)
    jc = jpre.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    tc = tpre.compute_cov3d(torch.tensor(scales), torch.tensor(quats))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)
    args = (KW["fx"], KW["fy"], KW["tan_fovx"], KW["tan_fovy"])
    je = jpre.ewa_cov2d(jnp.asarray(means), jc, j_se3(jnp.asarray(tau)), *args)
    te = tpre.ewa_cov2d(torch.tensor(means), tc, t_se3(torch.tensor(tau)), *args)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-4)


def test_preprocess_gradients_match_jax():
    means, scales, quats, opac, colors, alive, tau = _scene(4)
    rng = np.random.default_rng(9)
    n = means.shape[0]
    w_m, w_c, w_d, w_o = (rng.normal(size=s).astype(np.float32)
                          for s in ((n, 2), (n, 3), (n,), (n,)))

    def objective(lib, m, s, q, o, t):
        if lib is jnp:
            sg = jpre.preprocess(m, s, q, o, jnp.asarray(colors), jnp.asarray(alive),
                                 j_se3(t), j_proj(FX, FY, CX, CY, W, H), max_radius=24, **KW)
            vis = sg.visible.astype(jnp.float32)
        else:
            sg = tpre.preprocess(m, s, q, o, torch.tensor(colors), torch.tensor(alive),
                                 t_se3(t), t_proj(FX, FY, CX, CY, W, H, device="cpu"), max_radius=24, **KW)
            vis = sg.visible.to(torch.float32)
        wm, wc, wd, wo = (lib.asarray(x) if lib is jnp else torch.tensor(x)
                          for x in (w_m, w_c, w_d, w_o))
        return (lib.sum(vis[:, None] * sg.mean2d * wm) * 1e-2
                + lib.sum(vis[:, None] * sg.conic * wc)
                + lib.sum(vis * sg.depth * wd) + lib.sum(sg.opacity * wo))

    inputs = (means, scales, quats, opac, np.zeros(6, np.float32))
    jg = jax.grad(lambda *a: objective(jnp, *a), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, inputs))
    tin = [torch.tensor(a, requires_grad=True) for a in inputs]
    tg = torch.autograd.grad(objective(torch, *tin), tin)
    for name, a, b in zip(("means", "scales", "quats", "opacity", "tau"), tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)

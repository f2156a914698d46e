"""Parity of the port's rasterizer (preprocess -> bin -> tile compositor)
with the JAX `rasterize` / `rasterize_multi`, whose Pallas kernels run in
interpret mode on the CPU, on the scenes of tests/test_rasterizer.py.
Tolerances are the reference's own (tests/test_rasterizer.py:140-143,
:199-202): color and alpha 2e-5, depth 2e-4, n_touched exact, gradients
3e-3 max|g|. On the CPU the port runs the plain versions of the CUDA
kernels; tests/test_torch_kernels_cuda.py holds the kernels against them
on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.geometry import projection_matrix as j_proj, se3_exp as j_se3
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.ops.rasterize import rasterize as j_rasterize
from fourdgs.ops.rasterize.api import rasterize_multi as j_rasterize_multi
from fourdgs.ops.rasterize.oracle import composite_oracle as j_oracle
from fourdgs.ops.rasterize.preprocess import preprocess as j_preprocess
from fourdgs_torch.geometry import projection_matrix as t_proj, se3_exp as t_se3
from fourdgs_torch.ops.rasterize import composite_oracle as t_oracle, preprocess as t_preprocess
from fourdgs_torch.ops.rasterize.api import _assemble_image, rasterize as t_rasterize
from fourdgs_torch.ops.rasterize.api import rasterize_multi as t_rasterize_multi

W, H = 64, 48
FX = FY = 60.0
CX, CY = (W - 1) / 2.0, (H - 1) / 2.0
KW = dict(fx=FX, fy=FY, width=W, height=H, tan_fovx=W / (2 * FX), tan_fovy=H / (2 * FY))
J_PALLAS = JRasterConfig(tile_cap=128, max_pairs=1 << 14)
J_PROJ = j_proj(FX, FY, CX, CY, W, H)
T_PROJ = t_proj(FX, FY, CX, CY, W, H, device="cpu")


def make_scene(seed=0, n=48):
    """tests/test_rasterizer.py:make_scene, as numpy."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                      rng.uniform(2.0, 6.0, n)], axis=-1).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.05), np.log(0.3), (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors, np.ones(n, bool)


def dense_scene():
    """Many overlapping Gaussians on one tile: exercises termination."""
    rng = np.random.default_rng(4)
    n = 96
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return (
        np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n), rng.uniform(2, 4, n)],
                 -1).astype(np.float32),
        np.full((n, 3), 0.2, np.float32), quats,
        rng.uniform(0.7, 0.99, n).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32), np.ones(n, bool),
    )


def capped_scene():
    """One wide, faint Gaussian whose radius is capped by max_rect."""
    return (np.array([[0.0, 0.0, 3.0]], np.float32), np.full((1, 3), 0.8, np.float32),
            np.array([[1.0, 0, 0, 0]], np.float32), np.array([0.05], np.float32),
            np.array([[1.0, 0.5, 0.25]], np.float32), np.ones(1, bool))


SCENES = {"scene3": lambda: make_scene(3, 48), "dense": dense_scene, "capped": capped_scene}
TAU = np.array([0.02, -0.01, 0.015, 0.004, -0.006, 0.005], np.float32)


def _j_render(scene, tau, bg):
    return j_rasterize(*map(jnp.asarray, scene), j_se3(jnp.asarray(tau)), J_PROJ,
                       jnp.asarray(bg), config=J_PALLAS, **KW)


def _t_render(scene, tau, bg):
    return t_rasterize(*map(torch.tensor, scene), t_se3(torch.tensor(tau)), T_PROJ,
                       torch.tensor(bg), **KW)


def _check_outputs(t, j):
    t = type(t)(*(x.detach() for x in t))
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color), atol=2e-5)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), atol=2e-5)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth), atol=2e-4)
    np.testing.assert_array_equal(t.n_touched.numpy(), np.asarray(j.n_touched))
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    assert bool(t.overflow) == bool(j.overflow)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_rasterize_matches_jax_pallas(name):
    scene = SCENES[name]()
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    _check_outputs(_t_render(scene, TAU, bg), _j_render(scene, TAU, bg))


def test_oracle_matches_jax_oracle_and_tile_compositor():
    scene = make_scene(1, 32)
    jsg = j_preprocess(*map(jnp.asarray, scene), jnp.eye(4), J_PROJ, max_radius=24, **KW)
    tsg = t_preprocess(*map(torch.tensor, scene), torch.eye(4), T_PROJ, max_radius=24, **KW)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    jo = j_oracle(jsg, jnp.asarray(bg), W, H)
    to = t_oracle(tsg, torch.tensor(bg), W, H)
    _check_outputs(to, jo)
    _check_outputs(_t_render(scene, np.zeros(6, np.float32), bg), jo)


def _loss(lib, out):
    return (lib.mean((out.color - 0.3) ** 2) + 0.3 * lib.mean((out.depth - 2.5) ** 2)
            + 0.1 * lib.mean(out.alpha))


@pytest.mark.parametrize("name", ["scene3", "dense"])
def test_gradients_match_jax_pallas(name):
    means, scales, quats, opac, colors, alive = SCENES[name]()
    args = (means, scales, quats, opac, colors, np.zeros(6, np.float32))

    def jloss(m, s, q, o, c, tau):
        out = j_rasterize(m, s, q, o, c, jnp.asarray(alive), j_se3(tau), J_PROJ,
                          jnp.zeros(3), config=J_PALLAS, **KW)
        return _loss(jnp, out)

    g_ref = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = t_rasterize(*targs[:5], torch.tensor(alive), t_se3(targs[5]), T_PROJ,
                      torch.zeros(3), **KW)
    g_out = torch.autograd.grad(_loss(torch, out), targs)
    for label, a, b in zip(["means", "scales", "quats", "opac", "colors", "tau"], g_ref, g_out):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=3e-3 * max(np.abs(a).max(), 1e-4),
                                   err_msg=label)


def test_rasterize_multi_matches_jax_pallas():
    scene = make_scene(5, 40)
    taus = np.stack([TAU, -TAU, np.zeros(6, np.float32)])
    rng = np.random.default_rng(6)
    offsets = np.zeros((3, 40, 2), np.float32)
    bg = np.array([0.0, 0.1, 0.2], np.float32)
    w_img = rng.normal(size=(3, 3, H, W)).astype(np.float32)

    def jfn(m, off):
        out = j_rasterize_multi(m, *map(jnp.asarray, scene[1:]),
                                jax.vmap(j_se3)(jnp.asarray(taus)), J_PROJ, jnp.asarray(bg),
                                mean2d_offsets=off, config=J_PALLAS, **KW)
        return jnp.sum(out.color * w_img) + jnp.sum(out.depth), out

    (_, jo), (jg_m, jg_off) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(scene[0]), jnp.asarray(offsets))
    m = torch.tensor(scene[0], requires_grad=True)
    off = torch.tensor(offsets, requires_grad=True)
    to = t_rasterize_multi(m, *map(torch.tensor, scene[1:]), t_se3(torch.tensor(taus)),
                           T_PROJ, torch.tensor(bg), mean2d_offsets=off, **KW)
    tg_m, tg_off = torch.autograd.grad(
        torch.sum(to.color * torch.tensor(w_img)) + torch.sum(to.depth), [m, off])
    _check_outputs(to, jo)
    for label, a, b in (("means", jg_m, tg_m), ("mean2d taps", jg_off, tg_off)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=3e-3 * np.abs(a).max(), err_msg=label)


def test_assemble_image_layout():
    tx_n, ty_n, tile = 3, 2, 4
    img = np.arange(2 * ty_n * tile * tx_n * tile, dtype=np.float32).reshape(2, 8, 12)
    tiles = img.reshape(2, ty_n, tile, tx_n, tile).transpose(1, 3, 0, 2, 4)
    tiles = tiles.reshape(ty_n * tx_n, 2, tile * tile)
    out = _assemble_image(torch.tensor(tiles), tx_n, ty_n, tile, 10, 7)
    np.testing.assert_array_equal(out.numpy(), img[:, :7, :10])

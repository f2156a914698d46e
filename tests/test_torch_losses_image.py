"""Parity of fourdgs_torch.ops.image and the static losses of
fourdgs_torch.slam.losses with the JAX reference on seeded inputs, within
1e-5 (losses and their gradients with respect to the rendered image, depth
and opacity; image ops exactly where they are masks)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jimg = importlib.import_module("fourdgs.ops.image")
timg = importlib.import_module("fourdgs_torch.ops.image")
jls = importlib.import_module("fourdgs.slam.losses")
tls = importlib.import_module("fourdgs_torch.slam.losses")

H, W = 24, 32
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W]
    gt = np.stack([0.5 + 0.4 * np.sin(u / 3.0), 0.5 + 0.4 * np.cos(v / 4.0),
                   0.5 + 0.3 * np.sin((u + v) / 5.0)]).astype(np.float32)
    gt[:, :3, :5] = 0.0                              # dark corner: rgb mask off
    img = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    gt_depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    gt_depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    depth = (gt_depth + rng.normal(0, 0.2, (H, W))).astype(np.float32)
    opacity = rng.uniform(0.8, 1.0, (H, W)).astype(np.float32)
    motion = rng.uniform(size=(H, W)) > 0.1
    return img, gt, depth, gt_depth, opacity, motion


def test_image_ops_match():
    img, gt, *_ = _inputs(1)
    for a, b in zip(timg.image_gradient(torch.tensor(img)), jimg.image_gradient(jnp.asarray(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    sparse = np.where(img > 0.5, img, 0.0).astype(np.float32)
    for a, b in zip(timg.image_gradient_mask(torch.tensor(sparse)),
                    jimg.image_gradient_mask(jnp.asarray(sparse))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(timg.grad_intensity_mask(torch.tensor(img), 1.1).numpy(),
                                  np.asarray(jimg.grad_intensity_mask(jnp.asarray(img), 1.1)))
    mask = np.zeros((H, W), bool)
    mask[[3, 10, 20], [4, 31, 0]] = True
    for it in (1, 3):
        np.testing.assert_array_equal(timg.dilate3x3(torch.tensor(mask), it).numpy(),
                                      np.asarray(jimg.dilate3x3(jnp.asarray(mask), it)))
    np.testing.assert_allclose(float(timg.ssim(torch.tensor(img), torch.tensor(gt))),
                               float(jimg.ssim(jnp.asarray(img), jnp.asarray(gt))), **TOL)
    for m in (None, mask | (gt.sum(0) > 1.5)):
        np.testing.assert_allclose(
            float(timg.psnr(torch.tensor(img), torch.tensor(gt),
                            None if m is None else torch.tensor(m))),
            float(jimg.psnr(jnp.asarray(img), jnp.asarray(gt),
                            None if m is None else jnp.asarray(m))), **TOL)


@pytest.mark.parametrize("with_motion", [False, True])
def test_tracking_loss_and_gradients_match(with_motion):
    img, gt, depth, gt_depth, opacity, motion = _inputs(2)
    grad_mask = np.asarray(jimg.grad_intensity_mask(jnp.asarray(gt), 1.1))[0]
    mm = motion if with_motion else None

    def jl(i, d, o, a, b):
        return jls.tracking_loss_rgbd(jls.apply_exposure(i, a, b), d, o, jnp.asarray(gt),
                                      jnp.asarray(gt_depth), jnp.asarray(grad_mask),
                                      None if mm is None else jnp.asarray(mm), alpha=0.9)

    args = (img, depth, opacity, np.float32(0.05), np.float32(-0.01))
    jv, jg = jax.value_and_grad(jl, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tv = tls.tracking_loss_rgbd(tls.apply_exposure(targs[0], targs[3], targs[4]), targs[1],
                                targs[2], torch.tensor(gt), torch.tensor(gt_depth),
                                torch.tensor(grad_mask),
                                None if mm is None else torch.tensor(mm), alpha=0.9)
    tg = torch.autograd.grad(tv, targs)
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


def test_mapping_isotropic_and_median_depth_match():
    img, gt, depth, gt_depth, opacity, motion = _inputs(3)
    for rm in (False, True):
        jv = jls.mapping_loss_rgbd(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(gt),
                                   jnp.asarray(gt_depth), jnp.asarray(motion), alpha=0.9,
                                   rm_dynamic=rm)
        # the port batches over a leading view axis
        tv = tls.mapping_loss_rgbd(torch.tensor(img)[None].repeat(2, 1, 1, 1),
                                   torch.tensor(depth)[None].repeat(2, 1, 1),
                                   torch.tensor(gt)[None].repeat(2, 1, 1, 1),
                                   torch.tensor(gt_depth)[None].repeat(2, 1, 1),
                                   torch.tensor(motion)[None].repeat(2, 1, 1), alpha=0.9,
                                   rm_dynamic=rm)
        np.testing.assert_allclose(tv.numpy(), [float(jv)] * 2, **TOL)
    rng = np.random.default_rng(4)
    scaling = rng.uniform(0.01, 0.3, (40, 3)).astype(np.float32)
    alive = rng.uniform(size=40) > 0.3
    jg = jax.grad(lambda s: jls.isotropic_loss(s, jnp.asarray(alive)))(jnp.asarray(scaling))
    ts = torch.tensor(scaling, requires_grad=True)
    tv = tls.isotropic_loss(ts, torch.tensor(alive))
    (tg,) = torch.autograd.grad(tv, ts)
    np.testing.assert_allclose(float(tv), float(jls.isotropic_loss(jnp.asarray(scaling),
                                                                   jnp.asarray(alive))), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    for op, m in ((None, None), (opacity, None), (opacity, motion)):
        jm = jls.median_depth(jnp.asarray(depth), None if op is None else jnp.asarray(op),
                              None if m is None else jnp.asarray(m))
        tm = tls.median_depth(torch.tensor(depth), None if op is None else torch.tensor(op),
                              None if m is None else torch.tensor(m))
        for a, b in zip(tm, jm):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)

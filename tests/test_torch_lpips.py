"""LPIPS of the port (fourdgs_torch/eval/lpips.py) against the JAX
package's (fourdgs/eval/lpips.py) on the same seeded weights
(`convert.lpips_from_arrays`): `lpips_pair` within rtol 1e-5; weights
read from either package's `.npz`, through $FOURDGS_LPIPS_WEIGHTS, and
from a torchmetrics-style `.pth`; and `eval_rendering`'s `mean_lpips`, a
number (the mean of the reference's `lpips_pair` over the frames) with
weights and None without."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs.eval import lpips as jl
from fourdgs_torch import convert
from fourdgs_torch.eval import lpips as tl
from fourdgs_torch.eval.rendering import eval_rendering
from tests.test_torch_slam import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def no_weights(tmp_path, monkeypatch):
    """A working directory without pretrained/ and no weights variable."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("FOURDGS_LPIPS_WEIGHTS", raising=False)
    return tmp_path


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed,h,w", [(0, 64, 64), (1, 96, 128), (2, 67, 91)])
def test_lpips_pair_matches(seed, h, w):
    jw = jl.random_weights(jax.random.key(seed))
    a, b = _pair(seed, h, w)
    got = float(tl.lpips_pair(convert.lpips_from_arrays(jw, "cpu"), torch.tensor(a),
                              torch.tensor(b)))
    want = float(jl.lpips_pair(jw, jnp.asarray(a), jnp.asarray(b)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_load_weights_npz_and_env(no_weights, monkeypatch):
    assert tl.load_weights(device="cpu") is None
    jw = jl.random_weights(jax.random.key(3))
    path = str(no_weights / "alex.npz")
    jl.save_weights(path, jw)
    a, b = _pair(3, 64, 64)
    want = float(jl.lpips_pair(jw, jnp.asarray(a), jnp.asarray(b)))
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS", path)
    for w in (tl.load_weights(path, device="cpu"), tl.load_weights(device="cpu")):
        np.testing.assert_allclose(float(tl.lpips_pair(w, torch.tensor(a), torch.tensor(b))),
                                   want, rtol=1e-5)
    # the port's file reads in the reference
    port_path = str(no_weights / "port.npz")
    tl.save_weights(port_path, tl.load_weights(device="cpu"))
    np.testing.assert_allclose(
        float(jl.lpips_pair(jl.load_weights(port_path), jnp.asarray(a), jnp.asarray(b))),
        want, rtol=1e-6)


def test_load_weights_pth(no_weights):
    jw = jl.random_weights(jax.random.key(4))
    sd = {}
    for i, fi in enumerate([0, 3, 6, 8, 10]):
        sd[f"net.features.{fi}.weight"] = torch.tensor(np.asarray(jw.conv_w[i]))
        sd[f"net.features.{fi}.bias"] = torch.tensor(np.asarray(jw.conv_b[i]))
        sd[f"lins.{i}.model.1.weight"] = torch.tensor(np.asarray(jw.lin_w[i]))
    path = str(no_weights / "lpips_alex.pth")
    torch.save(sd, path)
    a, b = _pair(4, 64, 64)
    got = float(tl.lpips_pair(tl.load_weights(path, device="cpu"), torch.tensor(a),
                              torch.tensor(b)))
    want = float(jl.lpips_pair(jl.load_weights(path), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a file that is found but does not load raises
    torch.save({"unrelated": torch.zeros(1)}, path)
    with pytest.raises(KeyError, match="none of"):
        tl.load_weights(path, device="cpu")


class _Frames:
    """Ground-truth frames of `eval_rendering`: (image, depth, pose, mask)."""

    def __init__(self, n, h, w):
        rng = np.random.default_rng(5)
        self.images = rng.uniform(0, 1, (n, 3, h, w)).astype(np.float32)
        self.depth = np.ones((h, w), np.float32)

    def __getitem__(self, idx):
        return self.images[idx], self.depth, np.eye(4), np.ones(self.depth.shape, bool)


@pytest.mark.parametrize("with_weights", [True, False])
def test_mean_lpips(no_weights, monkeypatch, with_weights):
    frames = _Frames(3, 64, 64)
    rng = np.random.default_rng(6)
    renders = np.clip(frames.images + rng.normal(0, 0.1, frames.images.shape), 0, 1.2)
    render = lambda i: (torch.tensor(renders[i], dtype=torch.float32),  # noqa: E731
                        torch.ones(64, 64))
    jw = jl.random_weights(jax.random.key(7))
    if with_weights:
        path = str(no_weights / "lpips.npz")
        jl.save_weights(path, jw)
        monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS", path)
    out = eval_rendering(render, frames, [0, 1, 2])
    if not with_weights:
        assert out["mean_lpips"] is None
        return
    want = np.mean([float(jl.lpips_pair(jw, jnp.clip(jnp.asarray(renders[i], jnp.float32), 0, 1),
                                        jnp.asarray(frames.images[i]))) for i in range(3)])
    np.testing.assert_allclose(out["mean_lpips"], want, rtol=1e-5)

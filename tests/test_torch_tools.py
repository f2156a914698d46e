"""The port's tools against the reference's: `python -m
fourdgs_torch.batch_eval --synthetic 1 --frames 4 --device cpu` (the
reference's row keys, the row equal to the port's SLAM run directly on
the same configuration, `summary.json` under --out); `python -m
fourdgs_torch.view_ply` on a PLY written by the port's writer from a map
carried from the reference (orbit frame 0 within the rasterizer tolerance
of tests/test_rasterizer.py, colour 2e-5, of the reference's `rasterize`
at the same pose and arguments as scripts/view_ply.py, 64x48, and its PNGs
within one 8-bit level of that script's); and `voxel_downsample_mask`
exactly equal to fourdgs.native's. The synthetic configuration is the
reference's end-to-end one, and the row keys are those the reference's
scripts/batch_eval.py writes."""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fourdgs import native
from fourdgs.geometry import projection_matrix as j_projection_matrix
from fourdgs.geometry import se3_exp as j_se3_exp
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.ops.rasterize import rasterize as j_rasterize
from fourdgs_torch import batch_eval, convert, view_ply
from fourdgs_torch.io.ply import load_gaussians_ply, save_gaussians_ply
from fourdgs_torch.ops.knn import voxel_downsample_mask
from tests.test_end_to_end import _synthetic_config
from tests.test_torch_gui import _jax_map
from tests.test_torch_slam import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _StubSLAM:
    """Stands in for the reference's runner: what scripts/batch_eval.py's
    run_one reads from it, without a run."""

    def __init__(self, config, **kw):
        pass

    def run(self, warmup_frames=0):
        return {"fps": 1.0, "n_gaussians": 1}

    def eval_ate(self, tag):
        return {"rmse": 0.1}

    def eval_rendering(self, tag, interval):
        return {"mean_psnr": 1.0, "mean_ssim": 1.0, "mean_l1_depth": 1.0}


def _reference_row_keys(monkeypatch, tmp_path) -> list:
    """The keys, in order, of a row of the reference's scripts/batch_eval.py."""
    import fourdgs.slam.runner as j_runner

    spec = importlib.util.spec_from_file_location(
        "_reference_batch_eval", os.path.join(ROOT, "scripts", "batch_eval.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(j_runner, "SLAM", _StubSLAM)
    args = script.argparse.Namespace(out=str(tmp_path / "ref"), interval=5, dynamic=False,
                                     frames=4)
    return list(script.run_one(_synthetic_config(4), "synthetic_0", args))


@pytest.mark.parametrize("n", [4, 15, 20])
def test_batch_eval_config_is_the_reference_end_to_end_config(n):
    assert batch_eval.synthetic_config(n).to_plain() == _synthetic_config(n).to_plain()


def test_batch_eval_synthetic_row(tmp_path, monkeypatch):
    from fourdgs_torch.slam.runner import SLAM

    keys = _reference_row_keys(monkeypatch, tmp_path)
    from fourdgs_torch.slam.runner import SLAM

    out = str(tmp_path / "batch")
    rows = batch_eval.main(["--synthetic", "1", "--frames", "4", "--out", out,
                            "--device", "cpu"])
    (row,) = rows
    assert list(row) == keys and row["sequence"] == "synthetic_0"
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == rows
    assert os.path.exists(os.path.join(out, "synthetic_0", "plot", "stats_batch.json"))
    # the same configuration run directly
    cfg = batch_eval.synthetic_config(num_frames=4)
    cfg["Dataset"]["seed"] = 0
    slam = SLAM(cfg, save_dir=str(tmp_path / "direct"), save_interval=5, max_frames=4,
                device="cpu")
    metrics = slam.run()
    rend = slam.eval_rendering("batch", interval=5)
    want = {"ate_rmse": round(slam.eval_ate("batch")["rmse"], 5), "psnr": rend["mean_psnr"],
            "ssim": rend["mean_ssim"], "l1_depth": rend["mean_l1_depth"],
            "n_gaussians": metrics["n_gaussians"]}
    assert {k: row[k] for k in want} == want
    assert row["fps"] > 0 and all(np.isfinite(row[k]) for k in want)


def test_batch_eval_without_card_exits_nonzero(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        batch_eval.main(["--synthetic", "1", "--out", str(tmp_path / "b")])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        view_ply.main([str(tmp_path / "none.ply"), "--out", str(tmp_path / "o")])
    assert e.value.code not in (0, None)


W, H, FX, FRAMES = 64, 48, 60.0, 3


@pytest.fixture(scope="module")
def ply(tmp_path_factory, one_torch_thread):  # noqa: F811
    path = str(tmp_path_factory.mktemp("ply") / "point_cloud.ply")
    gmap = convert.gaussian_map_from_arrays(_jax_map(), "cpu")
    assert save_gaussians_ply(gmap, path) == int(gmap.alive.sum()) > 0
    return path


def test_view_ply_frame_matches_reference_rasterize(ply):
    data = load_gaussians_ply(ply)
    (i, color), = [next(view_ply.render_orbit(data, FRAMES, W, H, FX, "cpu"))]
    assert i == 0
    # scripts/view_ply.py's call, at frame 0
    T = j_se3_exp(jnp.asarray(view_ply.orbit_tau(0, FRAMES)))
    want = j_rasterize(
        jnp.asarray(data["xyz"]), jnp.exp(jnp.asarray(data["scaling"])),
        jnp.asarray(data["rotation"]), jax.nn.sigmoid(jnp.asarray(data["opacity"]))[:, 0],
        jnp.maximum(0.28209479177387814 * jnp.asarray(data["f_dc"]) + 0.5, 0),
        jnp.ones(data["xyz"].shape[0], bool), T,
        j_projection_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2, W, H), jnp.zeros(3),
        fx=FX, fy=FX, width=W, height=H, tan_fovx=W / (2 * FX), tan_fovy=H / (2 * FX),
        config=JRasterConfig(with_n_touched=False)).color
    np.testing.assert_allclose(color.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    assert float(color.std()) > 0.05


def test_view_ply_pngs_match_the_reference_script(ply, tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    import view_ply as j_view_ply

    args = ["--frames", str(FRAMES), "--width", str(W), "--height", str(H), "--fx", str(FX)]
    paths = view_ply.main([ply, "--out", str(tmp_path / "port"), "--device", "cpu"] + args)
    monkeypatch.setattr(sys, "argv", ["view_ply.py", ply, "--out", str(tmp_path / "ref")] + args)
    j_view_ply.main()
    assert [os.path.basename(p) for p in paths] == [f"orbit_{i:03d}.png" for i in range(FRAMES)]
    for p in paths:
        a = np.asarray(Image.open(p)).astype(int)
        b = np.asarray(Image.open(tmp_path / "ref" / os.path.basename(p))).astype(int)
        assert a.shape == b.shape == (H, W, 3)
        assert np.abs(a - b).max() <= 1 and (a == b).mean() > 0.99
    # the orbit moves the camera
    first, last = (np.asarray(Image.open(p)).astype(int) for p in (paths[0], paths[-1]))
    assert np.abs(first - last).max() > 20


@pytest.mark.parametrize("voxel", [0.05, 0.2, 1.0])
def test_voxel_downsample_mask_matches_native(voxel):
    rng = np.random.default_rng(int(voxel * 100))
    pts = rng.normal(0, 1, (3000, 3)).astype(np.float32)
    pts[1000:1500] = pts[:500] + rng.uniform(-1e-3, 1e-3, (500, 3)).astype(np.float32)
    keep = voxel_downsample_mask(pts, voxel)
    np.testing.assert_array_equal(keep, native.voxel_downsample_mask(pts, voxel))
    assert 0 < keep.sum() < len(pts) and keep[0]

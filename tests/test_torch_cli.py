"""The port's command line, `fourdgs_torch.cli.main`, on a recorded-layout
sequence: a 64x48 dynamic synthetic sequence written in TUM layout, with
the configuration of tests/test_cli_tum.py. The run with `--eval` leaves
the artifact tree of slam.py and meets that test's ATE; with
`model_params.dynamic_model: false` (where neither package segments) and
the iteration counts of tests/test_torch_slam.py's parity run, its
trajectory and keyframes equal the JAX `slam.main`'s on the same
sequence within that test's tolerances (the port replays JAX's draws
through `JaxDraws`), and checkpoints of either command line resume in
the other with the same map; `--dynamic` finishes; without a card and
without `--device cpu` it exits non-zero."""

import copy
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam import runner as jrunner
from fourdgs_torch import cli
from fourdgs_torch.data.synthetic import SyntheticDataset, write_tum_format
from fourdgs_torch.slam import runner as trunner
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import JaxDraws, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 64, 48, 10

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def sequence(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The dynamic synthetic sequence of tests/test_cli_tum.py in TUM
    layout, written by the port."""
    syn = ConfigDict.wrap({"Dataset": {
        "type": "synthetic", "sensor_type": "depth", "num_frames": N, "dynamic": True,
        "points_per_wall": 1500,
        "Calibration": {"fx": 80.0, "fy": 80.0, "cx": (W - 1) / 2, "cy": (H - 1) / 2,
                        "width": W, "height": H, "depth_scale": 1.0, "distorted": False}}})
    path = str(tmp_path_factory.mktemp("tum_seq"))
    write_tum_format(SyntheticDataset(None, "", syn, device="cpu"), path, depth_scale=5000.0)
    return path


def _config(seq_dir, results, dynamic_model=True):
    """tests/test_cli_tum.py's configuration."""
    return {
        "Results": {"save_results": True, "save_dir": results, "save_trj": True,
                    "save_trj_kf_intv": 5, "use_gui": False, "eval_rendering": True,
                    "use_wandb": False},
        "Dataset": {"type": "tum", "sensor_type": "depth", "dataset_path": seq_dir,
                    "pcd_downsample": 16, "pcd_downsample_init": 8,
                    "adaptive_pointsize": True, "point_size": 0.05,
                    "Calibration": {"fx": 80.0, "fy": 80.0, "cx": (W - 1) / 2,
                                    "cy": (H - 1) / 2, "width": W, "height": H,
                                    "depth_scale": 5000.0, "distorted": False}},
        "Training": {
            "init_itr_num": 30, "init_gaussian_update": 40, "init_gaussian_reset": 2000,
            "init_gaussian_th": 0.005, "init_gaussian_extent": 30, "tracking_itr_num": 20,
            "mapping_itr_num": 10, "keyframe_mapping_iters": 10,
            "gaussian_update_every": 10000, "gaussian_update_offset": 50,
            "gaussian_th": 0.7, "gaussian_extent": 1.0, "gaussian_reset": 20001,
            "size_threshold": 20, "kf_interval": 5, "window_size": 3, "pose_window": 2,
            "edge_threshold": 1.1, "rgb_boundary_threshold": 0.01, "alpha": 0.9,
            "kf_translation": 0.08, "kf_min_translation": 0.05, "kf_overlap": 0.9,
            "kf_cutoff": 0.3, "single_thread": True, "monocular": False, "dystart": 100,
            "refinement_iters": 50, "lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001},
        },
        "opt_params": {"densify_grad_threshold": 0.0002},
        "model_params": {"sh_degree": 0, "dynamic_model": dynamic_model},
    }


def _write(tmp_path, cfg, name="tum_dyn.yaml"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _run_dir(results):
    runs = [os.path.join(results, d) for d in sorted(os.listdir(results))]
    assert len(runs) == 1, runs
    return runs[0]


def test_cli_eval_artifacts_and_ate(sequence, tmp_path):
    results = str(tmp_path / "results")
    metrics = cli.main(["--config", _write(tmp_path, _config(sequence, results)), "--eval",
                        "--interval", "5", "--capacity", "4096", "--device", "cpu"])
    assert metrics["n_frames"] == N
    assert metrics["ate_rmse"] < 0.2, metrics           # tests/test_cli_tum.py's bound
    assert np.isfinite(metrics["psnr_before"]) and np.isfinite(metrics["psnr_after"])
    run = _run_dir(results)
    for rel in ("config.yml", "pose.txt", "final_result.json", "plot/stats_final.json",
                "plot/trj_final.json", "plot/ATE_final.json",
                "psnr/before_opt/final_result.json", "psnr/after_opt/final_result.json",
                "point_cloud/final/point_cloud.ply",
                "point_cloud/final_before_opt/point_cloud.ply",
                "renders/after_opt/00004_novel.png"):
        assert os.path.exists(os.path.join(run, rel)), rel
    with open(os.path.join(run, "config.yml")) as f:
        assert yaml.safe_load(f)["Dataset"]["dataset_path"] == sequence
    with open(os.path.join(run, "plot", "trj_final.json")) as f:
        trj = json.load(f)
    assert len(trj["trj_est"]) == len(trj["trj_gt"]) == len(trj["trj_id"]) == N
    with open(os.path.join(run, "psnr", "after_opt", "final_result.json")) as f:
        after = json.load(f)
    assert after["frames"] == N and after["mean_lpips"] is None
    assert np.loadtxt(os.path.join(run, "pose.txt")).shape == (N, 8)
    # refinement went through: the refined map differs from the one before
    before_ply = open(os.path.join(run, "point_cloud/final_before_opt/point_cloud.ply"),
                      "rb").read()
    assert open(os.path.join(run, "point_cloud/final/point_cloud.ply"), "rb").read() != before_ply


def _recording(module, monkeypatch, **extra):
    """Record the SLAM instances a command line makes (made with `extra`
    keyword arguments)."""
    made = []
    base = module.SLAM

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k, **extra)
            made.append(self)

    monkeypatch.setattr(module, "SLAM", Recorded)
    return made


def _centre(T):
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def wandb_stub(fail_init=False):
    """A `wandb` module that records its calls (`init` raising with
    `fail_init`)."""
    stub = types.ModuleType("wandb")
    stub.inits, stub.logs = [], []

    def init(**kw):
        if fail_init:
            raise RuntimeError("no wandb service")
        stub.inits.append(kw)

    stub.init, stub.log = init, stub.logs.append
    return stub


def test_cli_trajectory_matches_jax_and_checkpoints_cross(sequence, tmp_path, monkeypatch):
    sys.path.insert(0, ROOT)
    import slam as jslam_cli

    monkeypatch.setenv("FOURDGS_NO_COMPILE_CACHE", "1")
    monkeypatch.chdir(tmp_path)
    # both runners log the periodic ATE to a stub wandb
    wandb = wandb_stub()
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    # 4 frames at the iteration counts of tests/test_torch_slam.py's parity
    # run: initialisation with one densify, a keyframe at frame 2 with its
    # mapping phase, and tracked frames around it
    cfg = _config(sequence, str(tmp_path / "jax"), dynamic_model=False)
    cfg["Training"].update(init_itr_num=5, init_gaussian_update=3, tracking_itr_num=6,
                           keyframe_mapping_iters=4, mapping_itr_num=4, kf_interval=2,
                           kf_overlap=1.01)
    # no evaluation: each run's final map is the one it checkpoints; the
    # periodic ATE at every keyframe, into wandb
    cfg["Results"].update(eval_rendering=False, use_wandb=True, save_trj_kf_intv=1)
    common = ["--max-frames", "4", "--capacity", "4096"]
    # the JAX runner renders through its Pallas kernels in interpret mode,
    # as in tests/test_torch_slam.py, so both sides bin and composite alike
    j_made = _recording(jrunner, monkeypatch, raster=JRasterConfig(
        use_oracle=False, tile_cap=256, max_pairs=1 << 13))
    jslam_cli.main(["--config", _write(tmp_path, cfg, "jax.yaml"), "--checkpoint",
                    str(tmp_path / "jax_ck.npz")] + common)
    j_logs = list(wandb.logs)
    wandb.logs.clear()
    monkeypatch.setattr(trunner, "TorchDraws", lambda seed, device: JaxDraws(seed))
    t_made = _recording(trunner, monkeypatch)
    tcfg = copy.deepcopy(cfg)
    tcfg["Results"]["save_dir"] = str(tmp_path / "port")
    cli.main(["--config", _write(tmp_path, tcfg, "port.yaml"), "--device", "cpu",
              "--checkpoint", str(tmp_path / "port_ck.npz")] + common)
    (jslam,), (tslam,) = j_made, t_made
    t_logs = list(wandb.logs)
    assert [e["frame"] for e in t_logs] == [e["frame"] for e in j_logs] == [2]
    for te, je in zip(t_logs, j_logs):
        assert abs(te["ate"] - je["ate"]) < 1e-3, (te, je)
    assert [kw["project"] for kw in wandb.inits] == ["fourdgs-slam"] * 2
    assert type(wandb.inits[1]["config"]) is dict
    assert wandb.inits[1]["config"]["Dataset"] == dict(wandb.inits[0]["config"]["Dataset"])

    assert tslam.dataset.mask_fn is None and jslam.dataset.mask_fn is None
    assert sorted(tslam.poses_est) == sorted(jslam.poses_est) == list(range(4))
    assert tslam.kf_indices == jslam.kf_indices == [0, 2]
    for i in range(4):
        c_t, c_j = _centre(tslam.poses_est[i]), _centre(jslam.poses_est[i])
        assert np.linalg.norm(c_t - c_j) < 1e-3, (i, c_t, c_j)
        np.testing.assert_allclose(tslam.poses_est[i][:3, :3], jslam.poses_est[i][:3, :3],
                                   atol=1e-3)

    # each command line resumes the other's checkpoint (no frames run) and
    # saves the map it loaded, byte for byte
    def ply(results):
        with open(os.path.join(_run_dir(results), "point_cloud/final/point_cloud.ply"),
                  "rb") as f:
            return f.read()

    jax_ply, port_ply = ply(tmp_path / "jax"), ply(tmp_path / "port")
    tcfg["Results"]["save_dir"] = str(tmp_path / "port_resumed")
    cli.main(["--config", _write(tmp_path, tcfg, "port.yaml"), "--device", "cpu",
              "--resume", str(tmp_path / "jax_ck.npz"), "--max-frames", "0",
              "--capacity", "4096"])
    assert ply(tmp_path / "port_resumed") == jax_ply
    cfg["Results"]["save_dir"] = str(tmp_path / "jax_resumed")
    jslam_cli.main(["--config", _write(tmp_path, cfg, "jax.yaml"), "--resume",
                    str(tmp_path / "port_ck.npz"), "--max-frames", "0", "--capacity", "4096"])
    assert ply(tmp_path / "jax_resumed") == port_ply
    resumed = t_made[-1]
    assert resumed.kf_indices == jslam.kf_indices and resumed.window == jslam.window


def test_wandb_unavailable_logs_and_runs_on(sequence, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", wandb_stub(fail_init=True))
    cfg = _config(sequence, str(tmp_path / "results"), dynamic_model=False)
    cfg["Results"].update(eval_rendering=False, use_wandb=True, save_trj_kf_intv=1)
    cfg["Training"].update(init_itr_num=5, tracking_itr_num=4, keyframe_mapping_iters=2,
                           mapping_itr_num=2, kf_interval=2, kf_overlap=1.01)
    metrics = cli.main(["--config", _write(tmp_path, cfg), "--max-frames", "3",
                        "--capacity", "4096", "--device", "cpu"])
    assert metrics["n_frames"] == 3
    assert "wandb unavailable; logging disabled" in capsys.readouterr().err


@pytest.mark.parametrize("dystart", [100, 0])
def test_cli_dynamic_finishes(sequence, tmp_path, dystart):
    # dystart 100: past the sequence (tests/test_cli_tum.py's); 0: the TUM
    # configs', where the deformation starts at the first keyframe whose
    # segmented pixels spawn a dynamic Gaussian, and defers until then (at
    # this size keyframe 5 spawns none: the deferral)
    results = str(tmp_path / "results")
    cfg = _config(sequence, results)
    cfg["Training"].update(refinement_iters=10, dystart=dystart)
    with pytest.MonkeyPatch.context() as mp:
        made = _recording(trunner, mp)
        metrics = cli.main(["--config", _write(tmp_path, cfg), "--eval", "--dynamic",
                            "--max-frames", "6", "--capacity", "4096", "--device", "cpu"])
    assert np.isfinite(metrics["ate_rmse"]) and np.isfinite(metrics["psnr_after"])
    (slam,) = made
    assert slam.kf_indices == [0, 5]
    assert slam.deform_init == (dystart == 0 and metrics.get("dygs_spawned", 0) > 0)


def test_cli_without_card_exits_nonzero(sequence, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(tmp_path, _config(sequence, str(tmp_path / "results")))
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", path, "--eval"])
    assert e.value.code not in (0, None)
    assert not os.path.exists(tmp_path / "results")


@pytest.mark.parametrize("warmup", [0, 1])
def test_wandb_metrics_table(sequence, tmp_path, monkeypatch, warmup):
    # with --eval the final table of slam.py:100-121: a row before and one
    # after refinement, its FPS the run's fps_steady where it has one (the
    # run made with warmup_frames), else fps
    wandb = wandb_stub()

    class Table:
        def __init__(self, columns):
            self.columns, self.rows = columns, []

        def add_data(self, *row):
            self.rows.append(row)

    wandb.Table = Table
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    run = trunner.SLAM.run
    monkeypatch.setattr(trunner.SLAM, "run", lambda self: run(self, warmup_frames=warmup))
    cfg = _config(sequence, str(tmp_path / "results"), dynamic_model=False)
    cfg["Results"].update(use_wandb=True)
    cfg["Training"].update(init_itr_num=5, tracking_itr_num=4, keyframe_mapping_iters=2,
                           mapping_itr_num=2, kf_interval=2, kf_overlap=1.01,
                           refinement_iters=2)
    metrics = cli.main(["--config", _write(tmp_path, cfg), "--eval", "--max-frames", "3",
                        "--capacity", "4096", "--device", "cpu"])
    (table,) = [e["Metrics"] for e in wandb.logs if "Metrics" in e]
    assert table.columns == ["tag", "psnr", "ssim", "lpips", "RMSE ATE", "FPS"]
    assert [r[0] for r in table.rows] == ["Before", "After"]
    assert ("fps_steady" in metrics) == (warmup == 1)
    assert table.rows[1] == ("After", metrics["psnr_after"], metrics["ssim_after"],
                             metrics["lpips_after"], metrics["ate_rmse"],
                             metrics["fps_steady"] if warmup else metrics["fps"])

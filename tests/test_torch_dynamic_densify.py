"""The 4D path past its first densify, and its rendering evaluation, against
the JAX reference on a truncated run (4 of a 5-frame sequence).

After the dynamic mapping phase the densify prunes every Gaussian whose
opacity is below `gaussian_th` (0.7), the dynamic ones too, which spawn at
0.5. The reference's own run prunes dynamic Gaussians there, and the
port's densify, given the reference's state and draws, keeps exactly the
Gaussians the reference keeps. The two whole runs keep similar but not
equal numbers: the deformation warmup's 100 Adam steps at eps 1e-15 are
chaotic in the reference itself (tests/test_torch_mapping_dynamic.py
`test_warmup_diverges_in_the_reference_itself`), so the opacities that the
threshold reads have parted by then.

Every frame carries the time idx / (len(dataset) - 1) on both sides. The
port's evaluation renders each frame at that time; the reference's
renders at idx / (n_frames - 1), which is the same only when the run is
not truncated. So with the reference's state loaded, the port's evaluation
equals the reference's at full length, and the reference's at the
truncated times renders the moving blob where the frames do not show it.
"""

import jax
import numpy as np
import pytest
import torch

import fourdgs.models.gaussian_map as jgm
import fourdgs_torch.models.gaussian_map as tgm
from fourdgs.ops.rasterize import RasterConfig as JRasterConfig
from fourdgs.slam.runner import SLAM as JSLAM
from fourdgs.utils.config import ConfigDict as JConfigDict
from fourdgs_torch import convert
from fourdgs_torch.slam.runner import SLAM
from fourdgs_torch.utils.config import ConfigDict
from tests.test_torch_slam import JaxDraws, _config, one_torch_thread  # noqa: F401
from tests.test_torch_slam_dynamic import _dynamic

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FRAMES, MAX_FRAMES = 5, 4


def _cfg():
    # init (5 iterations, a densify at 3), the forced keyframe at dystart 2
    # with the deformation's init and warmup and 4 dynamic mapping
    # iterations, then the densify at gaussian_th 0.7 (iteration 9 of
    # gaussian_update_every 9), then frame 3 tracked
    return _dynamic(_config(N_FRAMES, 64, 48, 60.0, init_itr_num=5, init_gaussian_update=3,
                            tracking_itr_num=6, keyframe_mapping_iters=4, mapping_itr_num=4,
                            kf_interval=3, kf_overlap=1.01, gaussian_update_every=9), 2, 16)


def _capture(module, calls):
    """Wrap `module.densify_and_prune` to record its inputs and outputs."""
    orig = module.densify_and_prune

    def wrapped(gmap, adam, draw, *args):
        out = orig(gmap, adam, draw, *args)
        calls.append({"gmap": gmap, "adam": adam, "draw": draw, "args": args, "out": out})
        return out

    return wrapped


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg()
    j_calls, t_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgm, "densify_and_prune", _capture(jgm, j_calls))
        mp.setattr(tgm, "densify_and_prune", _capture(tgm, t_calls))
        jslam = JSLAM(JConfigDict.wrap(cfg), dynamic=True, max_frames=MAX_FRAMES,
                      capacity=4096, max_keyframes=8,
                      raster=JRasterConfig(use_oracle=False, tile_cap=256, max_pairs=1 << 13))
        jslam.run()
        tslam = SLAM(ConfigDict.wrap(cfg), dynamic=True, max_frames=MAX_FRAMES, capacity=4096,
                     max_keyframes=8, device="cpu", draws=JaxDraws(0))
        tslam.run()
    return cfg, jslam, tslam, j_calls, t_calls


def _centre_err(slam, i) -> float:
    """Frame i's camera-centre error against the ground truth, unaligned."""
    def centre(T):
        T = np.asarray(T, np.float64)
        return -T[:3, :3].T @ T[:3, 3]

    return float(np.linalg.norm(centre(slam.poses_est[i]) - centre(slam.dataset.poses[i])))


def _alive_dygs(gmap) -> int:
    return int(np.sum(np.asarray(gmap.dygs) & np.asarray(gmap.alive)))


def test_dynamic_densify_prunes_as_the_reference(runs):
    _, jslam, tslam, j_calls, t_calls = runs
    assert tslam.kf_indices == jslam.kf_indices == [0, 2]
    assert tslam.deform_init and jslam.deform_init
    # the init's densify, then the one after the dynamic phase, on both sides
    assert len(j_calls) == len(t_calls) == 2
    j, t = j_calls[-1], t_calls[-1]
    assert j["args"][1] == t["args"][1] == 0.7
    spawned = _alive_dygs(j["gmap"])
    assert _alive_dygs(t["gmap"]) == spawned > 0

    # the reference's densify prunes dynamic Gaussians at gaussian_th 0.7
    j_kept = _alive_dygs(j["out"][0])
    assert 0 < j_kept < spawned, (j_kept, spawned)

    # the port's densify on the reference's state and noise keeps exactly
    # the Gaussians the reference keeps, flagged alike
    noise = tuple(torch.tensor(np.asarray(jax.random.normal(k, j["gmap"].params.xyz.shape)))
                  for k in jax.random.split(j["draw"], 2))
    got, _ = tgm.densify_and_prune(convert.gaussian_map_from_arrays(j["gmap"], "cpu"),
                                   convert.adam_from_arrays(j["adam"], "cpu"), noise, *j["args"])
    want = j["out"][0]
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_array_equal((got.dygs & got.alive).numpy(),
                                  np.asarray(want.dygs & want.alive))

    # the whole runs: the port prunes dynamic Gaussians there too, keeping
    # a number near the reference's (within a third of those spawned: the
    # opacities the threshold reads went through the chaotic warmup)
    t_kept = _alive_dygs(t["out"][0])
    assert 0 < t_kept < spawned, (t_kept, spawned)
    assert abs(t_kept - j_kept) <= spawned / 3, (t_kept, j_kept, spawned)
    assert _alive_dygs(tslam.gmap) == t_kept and _alive_dygs(jslam.gmap) == j_kept
    print(f"dynamic Gaussians spawned {spawned}, alive after the densify: "
          f"reference {j_kept}, port {t_kept}")


def test_dynamic_run_quality_beside_the_reference(runs, tmp_path):
    cfg, jslam, tslam, _, _ = runs
    t_ate, j_ate = tslam.eval_ate()["rmse"], jslam.eval_ate()["rmse"]
    t_ev = tslam.eval_rendering()
    jslam.save_dir, jslam.n_frames = str(tmp_path), N_FRAMES   # at the frames' times
    j_ev = jslam.eval_rendering("quality")
    jslam.save_dir, jslam.n_frames = None, MAX_FRAMES
    print(f"ATE: port {t_ate * 1e3:.4f} mm, reference {j_ate * 1e3:.4f} mm; PSNR: port "
          f"{t_ev['mean_psnr']:.4f}, reference {j_ev['mean_psnr']:.4f} dB")
    for name, s in (("port", tslam), ("reference", jslam)):
        print(f"{name}: each frame's camera-centre error, mm: "
              + " ".join(f"{_centre_err(s, i) * 1e3:.2f}" for i in sorted(s.poses_est)))
    # after the chaotic warmup: the cameras within the 5e-3 m that
    # tests/test_torch_slam_dynamic.py holds them to from dystart on, the
    # renders within 1 dB
    assert t_ate == pytest.approx(j_ate, abs=5e-3)
    assert t_ev["mean_psnr"] == pytest.approx(j_ev["mean_psnr"], abs=1.0)


def test_dynamic_eval_renders_at_the_frames_times(runs, tmp_path):
    cfg, jslam, tslam, _, _ = runs
    # both sides store each keyframe at idx / (len(dataset) - 1)
    for kf in (0, 2):
        want = kf / (N_FRAMES - 1)
        assert float(tslam.store.times[tslam.kf_slot[kf]]) == pytest.approx(want, abs=1e-7)
        assert float(jslam.store.times[jslam.kf_slot[kf]]) == pytest.approx(want, abs=1e-7)

    # the port's evaluation of the reference's final state
    ev = SLAM(ConfigDict.wrap(cfg), dynamic=True, max_frames=MAX_FRAMES, capacity=4096,
              max_keyframes=8, device="cpu")
    ev.gmap = convert.gaussian_map_from_arrays(jslam.gmap, "cpu")
    ev.deform = convert.control_nodes_from_arrays(jslam.deform, "cpu")
    ev.deform_init = True
    ev.poses_est = {i: np.array(T) for i, T in jslam.poses_est.items()}
    got = ev.eval_rendering()

    # the reference's, once at full length (n_frames = len(dataset): its
    # render times are the frames' times), once as truncated
    jslam.save_dir = str(tmp_path)
    jslam.n_frames = N_FRAMES
    full = jslam.eval_rendering("full")
    jslam.n_frames = MAX_FRAMES
    truncated = jslam.eval_rendering("truncated")

    assert got["frames"] == full["frames"] == MAX_FRAMES
    # plain compositor against the interpret-mode kernels: renders agree to
    # float32 rounding, so the means to 1e-3 dB and 1e-5
    assert got["mean_psnr"] == pytest.approx(full["mean_psnr"], abs=1e-3)
    assert got["mean_ssim"] == pytest.approx(full["mean_ssim"], abs=1e-5)
    assert got["mean_l1_depth"] == pytest.approx(full["mean_l1_depth"], abs=1e-5)
    # at the truncated times the blob is rendered away from where the
    # frames show it
    assert truncated["mean_psnr"] < full["mean_psnr"] - 0.05, (truncated, full)
    print(f"PSNR: port {got['mean_psnr']:.4f}, reference at the frames' times "
          f"{full['mean_psnr']:.4f}, at the truncated times {truncated['mean_psnr']:.4f} dB")

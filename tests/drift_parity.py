"""The moving-blob drift of the command line, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.drift_parity SIDE BLOB OUT.json \
        [--scale S] [--strides P] [--iters F] [--frames N] [--capacity C] \
        [--init CHECKPOINT] [--fx-ulps K] [--threads T]

runs one command line on cli_runs.py's `no_segmenter` variant (BLOB 1:
chip_smoke.py's 44-frame dynamic synthetic sequence in TUM layout, with
`--dynamic` and `model_params.dynamic_model: false`, so nothing segments
and every pixel is static) or its `no_segmenter_scene` (BLOB 0: the same
frames without the blob), reduced as cli_runs.py reduces it (its first N
frames, S times the resolution, P times the point strides, the per-frame
iterations divided by F, a start capacity C), and writes the run's
record to OUT.json, and after each keyframe phase the record so far to
OUT.json.partial. SIDE `port` runs
`fourdgs_torch.cli.main --device cpu` with the reference's draws
(tests/test_torch_slam.py `JaxDraws`); SIDE `jax` runs the reference's
`slam.main`, its Pallas kernels in interpret mode as in
tests/test_torch_cli.py, so both sides bin and composite alike. Run from
the repository's root. tests/test_torch_drift_parity.py (`slow`) runs the
four and holds them to each other.

A record: the keyframes, the ATE, each frame's estimated and true camera
centre and its error, and, for every keyframe's mapping phase, the
window's camera errors before and after it (cli_runs.py's trace) and
every frame's estimated centre after it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_SEGMENTER = "model_params:\n  dynamic_model: false\n"


def write_sequence(tmp: str, blob: bool, scale: float, strides: float, iters: int,
                   frames: int, fx_ulps: int = 0) -> str:
    """The variant's sequence and config under `tmp` (results under
    `tmp`/results), the config's fx moved by `fx_ulps` float32 ulps (a
    run's own sensitivity to rounding); returns the config's path."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    cfg = CS.write_cli_sequence(tmp, NO_SEGMENTER + f"Results:\n  save_dir: {tmp}/results\n",
                                blob, frames=frames, scale=scale, strides=strides, iters=iters,
                                device="cpu")
    with open(cfg) as f:
        text = f.read()
    text = text.replace("inherit_from: configs/",
                        f"inherit_from: {os.path.join(ROOT, 'configs')}/", 1)
    if fx_ulps:
        import numpy as np

        line = next(ln for ln in text.splitlines() if ln.strip().startswith("fx:"))
        fx = np.float32(line.split(":")[1])
        for _ in range(fx_ulps):
            fx = np.nextafter(fx, np.float32(np.inf))
        text = text.replace(line, f"    fx: {float(fx)!r}", 1)
    with open(cfg, "w") as f:   # the base config from any working directory
        f.write(text)
    return cfg


def _centre(T):
    import numpy as np

    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def _record(slam, side: str, phases: list) -> dict:
    """The run's record so far."""
    import numpy as np

    ids = sorted(slam.poses_est)
    est = {i: _centre(slam.poses_est[i]) for i in ids}
    gt = {i: _centre(slam.dataset.poses[i]) for i in ids}
    return {"side": side, "keyframes": [int(k) for k in slam.kf_indices],
            "ate_rmse_m": float(slam.eval_ate()["rmse"]),
            "centre_est": {i: est[i].tolist() for i in ids},
            "centre_gt": {i: gt[i].tolist() for i in ids},
            "centre_err_mm": {i: float(np.linalg.norm(est[i] - gt[i]) * 1e3) for i in ids},
            "mapping_phases": list(phases)}


def snapshot(record: dict, keyframe: int) -> dict:
    """Each frame's estimated camera centre as it stood right after
    `keyframe`'s mapping phase (later phases move the window's keyframes)."""
    return next(p["centre_est"] for p in record["mapping_phases"] if p["keyframe"] == keyframe)


def _trace(slam_cls, side: str, phases: list, partial: str | None) -> dict:
    """Record, for every keyframe mapping phase of `slam_cls`'s runs, the
    window's camera errors before and after it, and write the record so far
    to `partial` after each; returns the originals."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    originals = {n: getattr(slam_cls, n) for n in ("_run_mapping", "_run_mapping_dynamic")}
    for name, original in originals.items():
        def traced(self, *a, _original=original, _name=name, **k):
            window = list(self.window)
            before = CS.centre_errors_mm(self, window)
            out = _original(self, *a, **k)
            phases.append({"phase": _name, "keyframe": int(window[0]),
                           "centre_err_mm_before": before,
                           "centre_err_mm_after": CS.centre_errors_mm(self, window),
                           "centre_est": {i: _centre(T).tolist()
                                          for i, T in sorted(self.poses_est.items())}})
            if partial:
                with open(partial, "w") as f:
                    json.dump(_record(self, side, phases), f)
            return out

        setattr(slam_cls, name, traced)
    return originals


def _start_from(path: str):
    """An `_initialize` that takes the state after frame 0's initialisation
    from the checkpoint at `path`, on either side. The reference's
    `load_checkpoint` leaves numpy arrays, which its runner cannot update
    (`.at`): they become jax arrays; and it sizes its pair budget from a
    render of that state, as its own initialisation ends."""
    def initialize(self, frame):
        self.load_checkpoint(path)
        if hasattr(self, "_rebucket_pairs"):
            import jax
            import jax.numpy as jnp
            from fourdgs.slam.mapping import render_keyframe

            self.gmap, self.adam, self.store = jax.tree.map(
                jnp.asarray, (self.gmap, self.adam, self.store))
            out = render_keyframe(self.gmap, self.store, jnp.int32(0), self.intr, self.map_cfg)
            self._note_pairs(out.num_pairs, out.overflow)
            self._rebucket_pairs()

    return initialize


def _cli(side: str):
    """(main, runner module, extra SLAM arguments, extra command-line
    arguments) of `side`."""
    if side == "jax":
        sys.path.insert(0, ROOT)
        import slam as jcli
        from fourdgs.ops.rasterize import RasterConfig
        from fourdgs.slam import runner as module

        os.environ["FOURDGS_NO_COMPILE_CACHE"] = "1"
        return jcli.main, module, {"raster": RasterConfig(use_oracle=False,
                                                          max_pairs=1 << 13)}, []
    from fourdgs_torch import cli
    from fourdgs_torch.slam import runner as module
    from tests.test_torch_slam import JaxDraws

    return cli.main, module, {"draws": JaxDraws(0)}, ["--device", "cpu"]


def init_checkpoint(cfg: str, path: str, capacity: int = 4096):
    """Frame 0's initialisation on `cfg` by the port's command line (with
    the reference's draws), saved as a checkpoint at `path` that either
    side starts from (`run(init=path)`)."""
    main, module, extra, argv = _cli("port")
    base = module.SLAM

    class Seeded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k, **extra)

    module.SLAM = Seeded
    try:
        main(["--config", cfg, "--dynamic", "--capacity", str(capacity), "--max-frames", "1",
              "--checkpoint", path] + argv)
    finally:
        module.SLAM = base


def run(side: str, cfg: str, capacity: int = 4096, init: str | None = None,
        partial: str | None = None) -> dict:
    """One command line on `cfg` (without `--eval`) at map capacity
    `capacity` (it grows as the map fills, alike on both sides); returns
    its record, and writes it to `partial` after each keyframe phase. With
    `init`, frame 0's initialisation is the checkpoint at that path
    (`init_checkpoint`), so both sides start frame 1 from one state: the
    reference's initialisation renders the whole window's static shape on
    every one of its 1,050 iterations, about an hour in interpret mode.
    The reference's pair budget starts from the capacity, and its
    interpret-mode kernels take time in proportion to it: a small capacity
    keeps them fast."""
    main, module, extra, argv = _cli(side)
    made, phases = [], []
    base = module.SLAM

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k, **extra)
            made.append(self)

    originals = _trace(base, side, phases, partial)
    if init:
        originals["_initialize"] = base._initialize
        base._initialize = _start_from(init)
    module.SLAM = Recorded
    try:
        main(["--config", cfg, "--dynamic", "--capacity", str(capacity)] + argv)
    finally:
        module.SLAM = base
        for name, fn in originals.items():
            setattr(base, name, fn)
    (slam,) = made
    return _record(slam, side, phases)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("side", choices=("port", "jax"))
    ap.add_argument("blob", type=int, choices=(0, 1))
    ap.add_argument("out")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--strides", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--frames", type=int, default=44)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--init", help="start frame 1 from this checkpoint (written first if absent)")
    ap.add_argument("--fx-ulps", type=int, default=0, help="move fx by this many float32 ulps")
    ap.add_argument("--threads", type=int, default=0, help="torch threads (0: torch's own)")
    args = ap.parse_args()
    import tests.conftest  # noqa: F401  (JAX on the CPU, as the tests run it)

    if args.threads:
        import torch

        torch.set_num_threads(args.threads)
    tmp = os.path.abspath(args.out) + ".d"
    os.makedirs(tmp, exist_ok=True)
    cfg = write_sequence(tmp, bool(args.blob), args.scale, args.strides, args.iters, args.frames,
                         args.fx_ulps)
    if args.init and not os.path.exists(args.init):
        init_checkpoint(cfg, args.init, args.capacity)
    record = run(args.side, cfg, args.capacity, args.init, args.out + ".partial")
    record.update(blob=bool(args.blob), scale=args.scale, strides=args.strides,
                  iters=args.iters, frames=args.frames, capacity=args.capacity,
                  fx_ulps=args.fx_ulps)
    with open(args.out, "w") as f:
        json.dump(record, f)
    print(f"{args.side} blob={args.blob}: ATE {record['ate_rmse_m'] * 1e3:.2f} mm, "
          f"keyframes {record['keyframes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

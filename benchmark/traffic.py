"""The one general generator: turns a traffic mix (`traffic/<name>.json`)
and a seed into the sequence a cell's configuration reads.

A mix's keys:
  frames            frames in the sequence
  points_per_wall   Gaussians per wall of the synthetic room
  blob              whether the moving blob (400 Gaussians) is in it
  frames_per_orbit  frames of one camera orbit (the TUM layout only; the
                    sequence repeats it)
  rate_hz           timestamps per second of the TUM layout
  depth_scale       depth units per metre of the TUM layout's 16-bit PNGs

The route is the configuration's `Dataset.type`:
  tum        the benchmark renders one orbit with its frozen generator and
             plain renderer on the device and writes it in TUM RGB-D
             layout under `benchmark/cache/<cell>-<seed>-<key>/` (once
             per cell, seed and sizes: `key` hashes the mix and the
             calibration); the program reads it through its TUM loader,
             PNG decode included;
  synthetic  the program's own synthetic dataset renders the frames (its
             only offline 4D route with exact flow); the mix sets its
             size and seed, and the check holds its poses and first
             frames against the frozen generator.
The room is drawn from the seed, the blob from the seed + 1.

A configuration may also name seeded weights (`weights`: a dotted key of
its config -> a writer, `weights/<writer>.py`); `write_weights` writes
each file once per cell, seed and writer, as the TUM layout's sequence
is written, and sets the key to the file's path.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import zlib
from pathlib import Path

import numpy as np

from benchmark.reference import generator as G

CACHE = Path(__file__).resolve().parent / "cache"


def load(name: str) -> dict:
    return json.loads((Path(__file__).resolve().parent / "traffic" / f"{name}.json").read_text())


def tum_poses(mix: dict) -> list[np.ndarray]:
    per = int(mix["frames_per_orbit"])
    return [G.orbit_pose((i % per) / per) for i in range(int(mix["frames"]))]


def synthetic_poses(n: int) -> list[np.ndarray]:
    """The poses of the port's synthetic sequence of n frames: one orbit
    over the whole sequence."""
    return [G.orbit_pose(i / max(n - 1, 1)) for i in range(n)]


def prepare(cell: str, mix: dict, config: dict, seed: int, device) -> list[np.ndarray]:
    """Fills the configuration's dataset keys for this mix and seed,
    writing the sequence first where the route reads files. Returns the
    ground-truth world-to-camera poses, one per frame."""
    ds = config["Dataset"]
    if ds["type"] == "synthetic":
        ds.update(num_frames=int(mix["frames"]), points_per_wall=int(mix["points_per_wall"]),
                  dynamic=bool(mix["blob"]), seed=int(seed))
        return synthetic_poses(int(mix["frames"]))
    if ds["type"] != "tum":
        raise ValueError(f"no route for Dataset.type {ds['type']!r}")
    poses = tum_poses(mix)
    key = hashlib.sha1(json.dumps([mix, ds["Calibration"]], sort_keys=True).encode())
    out = CACHE / f"{cell}-{seed}-{key.hexdigest()[:8]}"
    done = out / "complete"
    if not done.exists():
        if out.exists():
            shutil.rmtree(out)
        room = G.make_room_scene(seed, int(mix["points_per_wall"]))
        blob = G.make_dynamic_blob(seed + 1) if mix["blob"] else None
        per = int(mix["frames_per_orbit"])
        if blob is not None:
            per = int(mix["frames"])   # a moving blob makes every frame its own
        frames = [G.render_frame(G.scene_at(room, blob, i / max(int(mix["frames"]) - 1, 1)),
                                 poses[i], ds["Calibration"], device) for i in range(per)]
        G.write_tum_format(frames, poses, str(out), float(mix["depth_scale"]),
                           float(mix["rate_hz"]))
        done.write_text(json.dumps({"seed": seed, "mix": mix}))
    ds["dataset_path"] = str(out)
    ds["Calibration"]["depth_scale"] = float(mix["depth_scale"])
    return poses


def writer_seed(seed: int, writer: str) -> int:
    """The seed a weights writer draws from: derived from the run's seed
    and the writer's name, so the weights change with the seed and two
    writers of one run draw apart."""
    state = np.random.SeedSequence((seed, zlib.crc32(writer.encode()))).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def write_weights(cell: str, writers: dict, config: dict, seed: int) -> None:
    """For each `config` key -> (writer's name, module) of `writers`, calls
    the module's `write(path, seed)` once per cell, seed and writer, into
    `benchmark/cache/<cell>-<seed>-weights-<writer>/<module.FILE>` (done
    when its `complete` marker is there), and sets the key to the path."""
    for key, (name, mod) in writers.items():
        out = CACHE / f"{cell}-{seed}-weights-{name}"
        path = out / mod.FILE
        done = out / "complete"
        if not done.exists():
            if out.exists():
                shutil.rmtree(out)
            out.mkdir(parents=True)
            mod.write(path, writer_seed(seed, name))
            done.write_text(json.dumps({"seed": seed, "writer": name}))
        *groups, leaf = key.split(".")
        node = config
        for g in groups:
            node = node[g]
        node[leaf] = str(path)

"""The generator: the same frames and poses for the same seed, and a
written TUM sequence read back through the port's TUM loader."""

import numpy as np

from benchmark import traffic
from benchmark.reference import generator as G

CAL = {"fx": 535.4 / 4, "fy": 539.2 / 4, "cx": 320.1 / 4, "cy": 247.6 / 4,
       "width": 160, "height": 120, "depth_scale": 5000.0}


def frames(seed, n=3, blob=False):
    room = G.make_room_scene(seed, 200)
    b = G.make_dynamic_blob(seed + 1) if blob else None
    return [G.render_frame(G.scene_at(room, b, i / 10), G.orbit_pose(i / 40), CAL, "cpu")
            for i in range(n)]


def test_same_seed_same_frames_and_poses():
    a, b = frames(2**31 + 17), frames(2**31 + 17)
    for (ia, da), (ib, db) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(da, db)
    assert not np.array_equal(frames(5)[0][0], a[0][0])
    mix = {"frames": 90, "frames_per_orbit": 40}
    p1, p2 = traffic.tum_poses(mix), traffic.tum_poses(mix)
    assert all(np.array_equal(x, y) for x, y in zip(p1, p2))
    assert np.array_equal(p1[3], p1[43])          # one orbit, repeated


def test_blob_moves_with_time():
    a = frames(7, n=2, blob=True)
    assert not np.array_equal(a[0][0], a[1][0])


def test_tum_layout_reads_back_through_the_port(tmp_path):
    from fourdgs_torch.data.tum import TUMDataset

    seq = frames(11, n=4)
    poses = [G.orbit_pose((i % 4) / 40) for i in range(10)]
    G.write_tum_format(seq, poses, str(tmp_path), 5000.0, 30.0)
    config = {"Dataset": {"type": "tum", "sensor_type": "depth", "Calibration": dict(CAL)}}
    ds = TUMDataset(None, str(tmp_path), config)
    assert len(ds) == 10
    assert (ds.fx, ds.fy, ds.cx, ds.cy, ds.width, ds.height) == (
        CAL["fx"], CAL["fy"], CAL["cx"], CAL["cy"], 160, 120)
    for i in (0, 5, 9):
        image, depth, pose, motion = ds[i]
        img, dep = seq[i % 4]
        assert np.abs(image - np.floor(img * 255) / 255).max() < 1e-6
        assert np.abs(depth - np.clip(dep * 5000, 0, 65535).astype(np.uint16) / 5000).max() < 1e-6
        assert np.abs(pose - poses[i]).max() < 1e-5       # 6-decimal text round trip
        assert motion.all()

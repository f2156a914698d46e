"""The roofline and mfu arithmetic against counts worked by hand."""

import torch

from benchmark import roofline
from benchmark.harness import Readings, load_reader
from benchmark.reference.ops.rasterize import compositor as C


def one_pair_tile(op=0.5):
    """One 16x16 view, one tile, one pair: a Gaussian with a zero conic
    (power 0 everywhere) of opacity op, so alpha = op at every pixel."""
    fields = torch.zeros((1, 2, 10))
    fields[0, 0, C.F_OP] = op
    fields[0, 0, C.F_R:C.F_B + 1] = 1.0
    fields[0, 0, C.F_DEPTH] = 2.0
    pair_gid = torch.zeros(1, dtype=torch.int32)
    tile_start = torch.zeros(1, dtype=torch.int32)
    tile_count = torch.ones(1, dtype=torch.int32)
    return fields, pair_gid, tile_start, tile_count


def test_one_pair_counts_by_hand():
    fields, gid, start, count = one_pair_tile()
    grid = C.TileGrid(1, 1, 16, 16)
    out, n_contrib, _ = C.composite_forward_plain(
        fields, roofline.Bins(gid, start, count), grid)
    assert int(n_contrib.sum()) == 256          # every pixel applies its one pair
    w = roofline.call_work(fields, gid, start, count, n_contrib, tiles_per_view=1, tx_n=1,
                           width=16, height=16)
    # visited = applied = 256 pixel-pairs
    assert w.fwd_ops == 16 * 256 + 18 * 256
    assert w.bwd_ops == 16 * 0 + 65 * 256
    # one field row (40 B), one pair id, one tile range (8 B), 256 pixels
    # of 5 outputs and a count, the (1, 2) n_touched table
    assert w.fwd_bytes == 40 + 4 + 8 + 256 * 24 + 2 * 4
    assert w.bwd_bytes == 40 + 4 + 8 + 256 * 28 + 40


def test_invisible_pair_does_no_work():
    fields, gid, start, count = one_pair_tile(op=1e-4)   # alpha below 1/255
    grid = C.TileGrid(1, 1, 16, 16)
    _, n_contrib, _ = C.composite_forward_plain(fields, roofline.Bins(gid, start, count), grid)
    assert roofline.work_counts(fields, roofline.Bins(gid, start, count), grid,
                                n_contrib) == (0, 0)


def test_bound_is_the_larger_of_the_two():
    assert roofline.bound_s(67e12, 0.0) == 1.0
    assert roofline.bound_s(0.0, 3.35e12 * 2) == 2.0


def test_mlp_ops():
    w = [torch.zeros(3, 4), torch.zeros(4, 2)]
    assert roofline.mlp_ops(w, 10, backward=False) == 2 * 10 * (12 + 8)
    assert roofline.mlp_ops(w, 10, backward=True) == 3 * 2 * 10 * (12 + 8)


def readings(**kw):
    base = dict(spans=[], trace=None, roofline={}, ops=None, ops_s=0.0)
    base.update(kw)
    return Readings(**base)


def test_roofline_and_mfu_readers():
    fwd = load_reader("composite_fwd_roofline")
    assert fwd.read(readings(roofline={"fwd": (1.0, 4.0)})) == 25.0
    assert fwd.read(readings()) is None               # no kernel found: silent
    mfu = load_reader("mfu")
    assert mfu.read(readings(ops=67e12 * 2.0, ops_s=400.0)) == 0.5
    assert mfu.read(readings(ops=None, ops_s=1.0)) is None

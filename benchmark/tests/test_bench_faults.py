"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives a whole run of
a cell, cut to a size the CPU holds (small.py), with one fault planted in
the program under the benchmark's hooks: a step that returns its state
unchanged, half of the window's views left out of a mapping call, and an
answer (the tracked pose) altered where it is produced. A run on one
device has no exchange between chips to leave out. The clean run of each
cell passes every compared number. The sequence's ATE is left out of
both: its limit is the configuration's at full size, which a run cut to
160x120 and 12 tracking iterations does not keep.

The 4D cell's deformation field is held at its mapping call's first
iteration (`dyn_warp`, `dyn_field_bwd`, `dyn_field_step`): three faults
planted in the field (the flow loss's contribution to its gradient
dropped, its Adam step skipped, the warp head's output scaled by 1.01)
each fail one of those. Its end state is worked out but not compared; a
field left unchanged under a map that moves reads 1 by
`dyn_field_change`, which its clean run reads as 0."""

import functools
import inspect
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.small import shrink

SEED = 2**31 + 12345


FIELD_NUMBERS = ("dyn_warp", "dyn_field_bwd", "dyn_field_step")


def run(cell, numbers=None):
    """The run's compared numbers over their limits, the ATE left out;
    every number it worked out goes into `numbers`."""
    res = harness.run_cell(cell, SEED, 0.0, False, t_start=time.perf_counter(),
                           device="cpu", overrides=shrink)
    assert res["attempted"] > 0
    if numbers is not None:
        numbers.update(res["numbers"])
        numbers["compared"] = set(res["checks"])
    return [k for k, c in res["checks"].items() if k != "ate" and not c["value"] <= c["limit"]]


def patch_track(monkeypatch, change):
    from fourdgs_torch.slam import runner

    orig = runner.track_frame

    @functools.wraps(orig)   # the benchmark's hooks bind the signature
    def faulty(gmap, frame, T_init, exposure_init, *a, **kw):
        return change(orig(gmap, frame, T_init, exposure_init, *a, **kw), T_init)

    monkeypatch.setattr(runner, "track_frame", faulty)


def mapping_target(cell):
    from fourdgs_torch.slam import mapping_dynamic, runner

    if cell.startswith("bonn"):
        return mapping_dynamic, "map_chunk_dynamic"
    return runner, "map_chunk"


def patch_mapping(monkeypatch, cell, change_args=None, change_out=None):
    module, name = mapping_target(cell)
    orig = getattr(module, name)
    sig = inspect.signature(orig)

    @functools.wraps(orig)
    def faulty(*args, **kw):
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        given = dict(a.arguments)
        if change_args is not None:
            change_args(a.arguments)
        res = orig(**a.arguments)
        return res if change_out is None else change_out(res, given)

    monkeypatch.setattr(module, name, faulty)


def unchanged_pose(res, T_init):
    return res._replace(T_cw=T_init.clone())


def altered_pose(res, T_init):
    T = res.T_cw.clone()
    T[0, 3] += 2e-3                      # 2 mm
    return res._replace(T_cw=T)


def half_views(args):
    valid = np.asarray(args["window_valid"], bool).copy()
    ids = np.nonzero(valid)[0]
    valid[ids[(len(ids) + 1) // 2:]] = False
    args["window_valid"] = valid


def unchanged_map(res, given):
    out = res._replace(gmap=given["gmap"], adam=given["adam"])
    if hasattr(res, "deform"):
        out = out._replace(deform=given["cn"], deform_adam=given["deform_adam"])
    return out


def unchanged_field(res, given):
    return res._replace(deform=given["cn"], deform_adam=given["deform_adam"])


def plant_field_fault(monkeypatch, fault):
    """A fault of the deformation field, planted in the program for the
    whole run."""
    from fourdgs_torch.models import deform
    from fourdgs_torch.slam import mapping_dynamic

    if fault == "flow_grad_dropped":
        f = mapping_dynamic.masked_flow_l1
        monkeypatch.setattr(mapping_dynamic, "masked_flow_l1",
                            lambda *a, **k: f(*a, **k).detach())
    elif fault == "field_step_skipped":
        f = mapping_dynamic._adam_flat
        monkeypatch.setattr(mapping_dynamic, "_adam_flat",
                            lambda p, *a, **k: (p, *f(p, *a, **k)[1:]))
    else:
        f = deform.mlp_forward

        def scaled(*a):
            d_xyz, d_rot, d_scale = f(*a)
            return d_xyz * 1.01, d_rot, d_scale

        monkeypatch.setattr(deform, "mlp_forward", scaled)


CELLS = ["tum-fr3-static.walk", "bonn-balloon-4d.blob"]


@pytest.mark.parametrize("cell", CELLS)
def test_clean_run_passes(cell):
    numbers = {}
    assert run(cell, numbers) == []
    assert numbers.get("dyn_field_change", 0.0) == 0.0
    if cell.startswith("bonn"):
        assert set(FIELD_NUMBERS) <= numbers["compared"]


def test_field_left_unchanged_reads_one(monkeypatch):
    cell = "bonn-balloon-4d.blob"
    patch_mapping(monkeypatch, cell, change_out=unchanged_field)
    numbers = {}
    run(cell, numbers)
    assert numbers["dyn_field_change"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["track_unchanged", "track_altered", "map_unchanged",
                                   "map_half_views"])
def test_fault_is_caught(cell, fault, monkeypatch):
    torch.manual_seed(0)
    if fault == "track_unchanged":
        patch_track(monkeypatch, unchanged_pose)
    elif fault == "track_altered":
        patch_track(monkeypatch, altered_pose)
    elif fault == "map_unchanged":
        patch_mapping(monkeypatch, cell, change_out=unchanged_map)
    else:
        patch_mapping(monkeypatch, cell, change_args=half_views)
    assert run(cell)


@pytest.mark.parametrize("fault", ["flow_grad_dropped", "field_step_skipped", "head_scaled"])
def test_field_fault_fails_a_field_number(fault, monkeypatch):
    plant_field_fault(monkeypatch, fault)
    assert set(run("bonn-balloon-4d.blob")) & set(FIELD_NUMBERS)

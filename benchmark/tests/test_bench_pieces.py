"""A configuration's seeded weights (`weights`) and output checks
(`judges`), each found by name from a file of its own (harness.py).

A toy writer and a toy judge, defined here, stand in for the files: the
writer draws 16 numbers from its seed (and sleeps, as writing a real
checkpoint takes time); the judge keeps the tracked poses of the window
through a `hooks.Kept` drawn from the seed and reads `toy_rot`, how far
the kept rotations are from orthonormal, and `toy_weights`, the file at
the configuration's key against the writer's draw. The whole runs are
of the static cell cut to 160x120 (small.py), with the ATE left out of
its limits: its limit is the configuration's at full size, which such a
run does not keep (test_bench_faults.py)."""

import functools
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, hooks, traffic
from benchmark.tests.small import shrink

CELL = "tum-fr3-static.walk"
SEED = 2**31 + 4321
KEY = "Dataset.toy_weights"
WRITE_S = 3.0
TOY_LIMITS = {"toy_rot": {"limit": 1e-4}, "toy_weights": {"limit": 0.0}}


def toy_writer(sleep_s: float = 0.0):
    calls = []

    def write(path, seed):
        calls.append((path, seed))
        time.sleep(sleep_s)
        np.save(path, np.random.default_rng(seed).standard_normal(16))

    return SimpleNamespace(FILE="toy.npy", write=write, calls=calls)


def toy_judge(target: str = "track"):
    """Keeps the window's calls of `runner.track_frame`, or of
    `mapping_dynamic.map_chunk_dynamic`, which the static cell never
    makes (so the judge keeps nothing)."""

    ctxs = []

    def install(rec, ctx):
        from fourdgs_torch.slam import mapping_dynamic, runner

        module, name = ((runner, "track_frame") if target == "track"
                        else (mapping_dynamic, "map_chunk_dynamic"))
        fn = getattr(module, name)
        ctx.kept = hooks.Kept(ctx.rng, 2)
        ctxs.append(ctx)

        def keep(*a, **kw):
            if rec.in_window and not hasattr(ctx, "t_first"):
                ctx.t_first = time.perf_counter()
            res = fn(*a, **kw)
            if rec.in_window:
                ctx.kept.offer(res.T_cw.detach().double().numpy(), 0)
            return res

        rec._patch(module, name, keep)

    def judge(variant, ctx):
        picks = ctx.kept.picks()
        if variant is not None or not picks:
            return {}
        rot = max(float(np.abs(T[:3, :3] @ T[:3, :3].T - np.eye(3)).max()) for T in picks)
        path = ctx.config["Dataset"]["toy_weights"]
        want = np.random.default_rng(traffic.writer_seed(ctx.seed, "toy")).standard_normal(16)
        return {"toy_rot": rot, "toy_weights": float(np.abs(np.load(path) - want).max())}

    return SimpleNamespace(install=install, judge=judge, ctxs=ctxs)


def with_toys(monkeypatch, tmp_path, writer, judge):
    """The static cell with `weights` {KEY: "toy"} and `judges` ["toy"],
    the toys served for those names, and the cache under tmp_path."""
    pieces = {("weights", "toy"): writer, ("judges", "toy"): judge}
    load_piece, load_cell = harness.load_piece, harness.load_cell

    def load(name):
        cell = load_cell(name)
        config = dict(cell.config, weights={KEY: "toy"}, judges=["toy"])
        limits = {k: v for k, v in cell.limits.items() if k != "ate"} | TOY_LIMITS
        writers, judges = harness.load_pieces(config)
        return cell._replace(config=config, limits=limits, writers=writers, judges=judges)

    monkeypatch.setattr(harness, "load_piece",
                        lambda kind, name, needs: pieces.get((kind, name))
                        or load_piece(kind, name, needs))
    monkeypatch.setattr(harness, "load_cell", load)
    monkeypatch.setattr(traffic, "CACHE", tmp_path)


def run(t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    return harness.run_cell(CELL, SEED, 0.0, False, t_start=t_start, device="cpu",
                            overrides=shrink)


def over(res) -> list[str]:
    return [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]


def test_weights_written_once_per_seed(monkeypatch, tmp_path):
    monkeypatch.setattr(traffic, "CACHE", tmp_path)
    writer = toy_writer()
    writers = {KEY: ("toy", writer)}
    paths = []
    for seed in (SEED, SEED, SEED + 1):
        config = {"Dataset": {}}
        traffic.write_weights(CELL, writers, config, seed)
        paths.append(config["Dataset"]["toy_weights"])
    assert [c[1] for c in writer.calls] == [traffic.writer_seed(SEED, "toy"),
                                           traffic.writer_seed(SEED + 1, "toy")]
    assert paths[0] == paths[1] != paths[2]
    assert not np.array_equal(np.load(paths[0]), np.load(paths[2]))
    assert traffic.writer_seed(SEED, "toy") != traffic.writer_seed(SEED, "other")


def test_judge_numbers_held_to_limits(monkeypatch, tmp_path):
    writer, judge = toy_writer(WRITE_S), toy_judge()
    with_toys(monkeypatch, tmp_path, writer, judge)
    t_start = time.perf_counter()
    res = run(t_start)
    assert len(writer.calls) == 1
    assert {"toy_rot", "toy_weights"} <= set(res["checks"])
    assert res["checks"]["toy_rot"]["limit"] == TOY_LIMITS["toy_rot"]["limit"]
    assert over(res) == [] and res["correct"], res["checks"]
    # the writer's seconds lie between the run's start and the window's
    # first tracked frame, and are left out of setup_s
    assert res["metrics"]["setup_s"]["value"] + WRITE_S <= judge.ctxs[0].t_first - t_start


def test_planted_fault_fails_the_judges_number(monkeypatch, tmp_path):
    from fourdgs_torch.slam import runner

    with_toys(monkeypatch, tmp_path, toy_writer(), toy_judge())
    orig = runner.track_frame

    @functools.wraps(orig)
    def skewed(*a, **kw):
        res = orig(*a, **kw)
        T = res.T_cw.clone()
        T[:3, :3] *= 1.01                 # no longer a rotation
        return res._replace(T_cw=T)

    monkeypatch.setattr(runner, "track_frame", skewed)
    res = run()
    assert "toy_rot" in over(res) and not res["correct"]


def test_judge_that_kept_nothing_is_not_correct(monkeypatch, tmp_path):
    with_toys(monkeypatch, tmp_path, toy_writer(), toy_judge("map_chunk_dynamic"))
    res = run()
    assert res["checks"]["toy_rot"]["value"] == harness.MISSING
    assert over(res) == ["toy_rot", "toy_weights"] and not res["correct"]


@pytest.mark.parametrize("kind", ["weights", "judges"])
def test_unknown_name_fails_at_load(kind):
    config = {"weights": {KEY: "no_such_piece"}} if kind == "weights" else {
        "judges": ["no_such_piece"]}
    with pytest.raises(SystemExit, match=f"{kind}/no_such_piece.py"):
        harness.load_pieces(config)


def test_cells_load_their_pieces():
    static, dyn = harness.load_cell(CELL), harness.load_cell("bonn-balloon-4d.blob")
    assert static.writers == {} and static.judges == {}
    assert list(dyn.judges) == ["synthetic_sequence"]

"""Densify / opacity-reset cadence arithmetic (port of
fourdgs/slam/cadence.py).

The reference fires densification and opacity resets inside its mapping
iteration loop (slam_backend.py:336-338 advance `iteration_count` for
i > 100; :723-745 fire when `iteration_count % gaussian_update_every ==
gaussian_update_offset`, reset when `iteration_count % gaussian_reset ==
0`, both gated on i > 100). Mapping runs in chunks, so the host breaks
chunks exactly at those boundaries; this generator owns that arithmetic."""

from __future__ import annotations

from typing import Iterator


def mapping_cadence(
    total_iters: int,
    step_after: int,
    iteration_count: int,
    update_every: int,
    update_offset: int,
    reset_every: int,
    densify: bool = True,
    reset: bool = True,
) -> Iterator[tuple[int, int, str | None]]:
    """Yield (chunk, iteration_count_after, fire) where fire is one of
    None / "densify" / "reset".

    `step_after` mirrors the reference's `i > 100` gate: only iterations
    with local index i > step_after advance the global iteration_count
    (and can fire events). step_after < 0 means every iteration counts.
    """
    def next_boundary(it: int, period: int, off: int) -> int:
        if off >= period:
            # the reference compares the RAW offset, which never fires
            # when offset >= every
            return 1 << 62
        tb = (off - it) % period
        return period if tb == 0 else tb

    done = 0
    it = iteration_count
    while done < total_iters:
        to_boundary = total_iters
        if densify:
            to_boundary = min(to_boundary, next_boundary(it, update_every, update_offset))
        if reset:
            to_boundary = min(to_boundary, next_boundary(it, reset_every, 0))
        if done <= step_after:
            # iterations up to step_after don't advance the count
            to_boundary = step_after + 1 - done + to_boundary
        chunk = int(min(total_iters - done, max(1, to_boundary)))
        prev = done
        done += chunk
        if step_after < 0:
            it += chunk
        else:
            it += max(0, done - max(prev, step_after + 1))

        fire = None
        counted = done - 1 > step_after  # last executed iteration counted?
        if densify and counted and it % update_every == update_offset and it > 0:
            fire = "densify"
        elif reset and counted and it > 0 and it % reset_every == 0:
            fire = "reset"
        yield chunk, it, fire

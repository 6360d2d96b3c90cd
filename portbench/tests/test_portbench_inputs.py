"""Seeded inputs: the same seed gives the same frames, frames differ
across keys and seeds, the PNG codec round-trips, and a run that would
repeat a pair fails."""

from __future__ import annotations

import numpy as np
import pytest

import portbench_tiny

portbench_tiny.paths()

from pbcore import inputs  # noqa: E402

PARAMS = {"displacement_texels": 2.0, "modes": 4, "max_cycles": 3, "gain": 0.04}
BIG_SEED = 2**31 + 987654321


def maker():
    bases = [inputs.read_png(f"{portbench_tiny.BENCH}/data/{n}") for n in ("mA.png", "mB.png")]
    return inputs.FrameMaker(bases, 64, PARAMS, "cpu")


def test_frames_repeat_for_a_seed_and_differ_across_keys_and_seeds():
    a, b = maker(), maker()
    first = [a.frame(BIG_SEED, k) for k in range(6)]
    assert all(np.array_equal(x, b.frame(BIG_SEED, k)) for k, x in enumerate(first))
    assert len({inputs.digest(x) for x in first}) == 6
    assert not np.array_equal(first[0], a.frame(BIG_SEED + 1, 0))
    assert first[0].shape == (64, 64, 3) and first[0].dtype == np.uint8


@pytest.mark.parametrize("row_filter,level", [("none", 1), ("adaptive", 6)])
def test_png_round_trip(tmp_path, row_filter, level):
    frame = maker().frame(7, 3)
    path = str(tmp_path / "f.png")
    inputs.write_pngs([frame], [path], threads=1, row_filter=row_filter, level=level)
    assert np.array_equal(inputs.read_png(path), frame)
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    assert np.array_equal(read_png_rgb(path), frame)


def test_adaptive_rows_pick_the_least_sum_of_absolute_values():
    """Each row's filter is the one of the five whose bytes, read as signed,
    sum to the least absolute value (libpng's default heuristic)."""
    frame = maker().frame(7, 4)
    rows = inputs.adaptive_rows(frame, block=16)
    assert len(set(rows[:, 0].tolist())) > 1
    x = frame.reshape(frame.shape[0], -1).astype(np.int64)
    for y in (0, 1, 17, 63):
        up = x[y - 1] if y else np.zeros_like(x[0])
        left = np.concatenate([[0, 0, 0], x[y, :-3]])
        upleft = np.concatenate([[0, 0, 0], up[:-3]])
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        cands = [(x[y] - pred) % 256 for pred in (0, left, up, (left + up) // 2, paeth)]
        costs = [int(np.minimum(c, 256 - c).sum()) for c in cands]
        assert rows[y, 0] == int(np.argmin(costs))
        assert np.array_equal(rows[y, 1:], cands[rows[y, 0]])


@pytest.mark.parametrize("period", [1, 2])
def test_a_run_that_would_repeat_a_pair_fails(tmp_path, monkeypatch, period):
    """Frames that come back (period 1: every frame the same; period 2:
    pair (0, 1) again as (2, 3)) end the run before any result."""
    from pbcore import session

    real = inputs.FrameMaker.frame
    monkeypatch.setattr(inputs.FrameMaker, "frame",
                        lambda self, seed, key: real(self, seed, key % period
                                                     if key >= 0 else key))
    cell = portbench_tiny.cell(portbench_tiny.make_root(tmp_path), "tiny.series")
    with pytest.raises(RuntimeError, match="repeats"):
        session.run_cell(cell, 5, 1.0, False, "cpu", log=lambda m: None)

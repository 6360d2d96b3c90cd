"""What decides ``correct``: the program's answers against the plain
reference's (pbref), each number beside its limit from the configuration
file. ``tfield_gap`` is the relative 2-norm distance of the program's flow
from the reference's; ``halfway_mad`` the mean absolute difference of the
halfway blend, in uint8 levels over every texel and channel."""

from __future__ import annotations

import numpy as np


def tfield_gap(program: np.ndarray, reference: np.ndarray) -> float:
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    return float(np.linalg.norm(p - r) / np.linalg.norm(r))


def halfway_mad(program: np.ndarray, reference: np.ndarray) -> float:
    return float(np.mean(np.abs(program.astype(np.int16) - reference.astype(np.int16))))


def verdict(readings: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every reading at or under its
    limit. A reading that has no limit, or is not finite, fails."""
    out, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, out


def lines(numbers: dict) -> list:
    """The numbers as stderr lines: name, value, limit."""
    return [f"check {name} {v['value']!r} limit {v['limit']!r}" for name, v in numbers.items()]

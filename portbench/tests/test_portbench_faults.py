"""The timed path broken underneath a run: each fault the cells can have
turns ``correct`` false (tiny cells on the CPU, past the look for a card).
The cells run on one chip and exchange nothing between chips."""

from __future__ import annotations

import pytest
import torch

import portbench_tiny

portbench_tiny.paths()

from pbcore import session  # noqa: E402


def stale_state(monkeypatch):
    """A level step that returns its state unchanged."""
    from meshopticalflow_tpu_torch.flow import pipeline

    real = pipeline._level_step

    def step(arrays, coeffs, tfield, *args, **kwargs):
        _, _, metrics, x = real(arrays, coeffs, tfield, *args, **kwargs)
        return coeffs, tfield, metrics, x

    monkeypatch.setattr(pipeline, "_level_step", step)


def half_the_lanes(monkeypatch):
    """Half of the halfway march's lanes left where they start."""
    from meshopticalflow_tpu_torch.flow import pipeline

    real = pipeline._halfway_lanes

    def lanes(src_t, src_p, t_back, t_fwd):
        t2, p2, times = real(src_t, src_p, t_back, t_fwd)
        times = times.clone()
        times[::2] = 0.0
        return t2, p2, times

    monkeypatch.setattr(pipeline, "_halfway_lanes", lanes)


def altered_answer(monkeypatch):
    """The halfway blend altered where it is produced: a band of texels
    brightened by 12 levels."""
    from meshopticalflow_tpu_torch.flow import pipeline

    real = pipeline._halfway_tail

    def tail(*args):
        out = real(*args).clone()
        h = out.shape[0]
        out[h // 4: h // 2] = torch.clamp(out[h // 4: h // 2].to(torch.int16) + 12,
                                          0, 255).to(torch.uint8)
        return out

    monkeypatch.setattr(pipeline, "_halfway_tail", tail)


@pytest.mark.parametrize("fault", [stale_state, half_the_lanes, altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", ["tiny.series", "tiny.frames"])
def test_fault_turns_correct_false(tmp_path, monkeypatch, fault, name):
    cell = portbench_tiny.cell(portbench_tiny.make_root(tmp_path), name)
    fault(monkeypatch)
    out = session.run_cell(cell, 2**31 + 77, 0.5, False, "cpu", log=lambda m: None)
    assert out["correct"] is False, out["check"]

"""What a loop drives: the system under test, or the control in its place.

``program`` is meshopticalflow_tpu_torch through the entry the --serve
worker takes, FlowProblem.from_texture_inputs. ``control`` is the plain
reference (pbref) put in the program's place, computing in float32 and
storing every stage's result (signals, smoothed signals, the solved
direction, coefficients, flow, fetched colours) in bfloat16, the step
below the configuration's float32 that would tempt a later change. Both
give a problem with ``run()`` (a result with ``tfield`` and ``metrics``),
``halfway_texture(alpha)`` and ``tfield``, so that a run, its window and
its check are the same code whichever is in place."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def to_numpy(x) -> np.ndarray:
    """A flow or blend as a host array, from a tensor on any device."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Program:
    """The port: one FlowProblem a pair of texture files."""

    name = "program"

    def problem(self, run, paths):
        from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

        return FlowProblem.from_texture_inputs(run.root, tuple(paths), run.cfg,
                                               device=run.device)


@dataclasses.dataclass
class ControlResult:
    tfield: np.ndarray
    metrics: List[Dict]


class ControlProblem:
    def __init__(self, ref, tex0: np.ndarray, tex1: np.ndarray):
        from pbref.flow import bf16_store

        self.ref, self.tex0, self.tex1, self.store = ref, tex0, tex1, bf16_store
        self.tfield = None

    def run(self):
        self.tfield = self.ref.align(self.tex0, self.tex1, store=self.store)
        return ControlResult(tfield=to_numpy(self.tfield.double()), metrics=[])

    def halfway_texture(self, alpha: float = 0.5) -> np.ndarray:
        return self.ref.halfway(self.tfield, self.tex0, self.tex1, alpha, store=self.store)


class Control:
    """The reference in float32 with bfloat16 storage, reading the same
    files with the harness's own PNG decoder."""

    name = "control"

    def problem(self, run, paths):
        import torch

        from pbcore.inputs import read_png

        return ControlProblem(run.reference(torch.float32), *(read_png(p) for p in paths))


SYSTEMS = {"program": Program, "control": Control}

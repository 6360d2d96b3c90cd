"""The per-layer metrics that read the program's own spans
(meshopticalflow_tpu_torch/utils/spans.py): a traced run of a tiny cell
on the CPU returns the host-span ones, each above zero, and leaves out
those that need device time; an untraced run records no span."""

from __future__ import annotations

import pytest

import portbench_tiny

portbench_tiny.paths()

from pbcore import session  # noqa: E402

SEED = 2**31 + 919
HOST = {"tiny.series": {"init.decode_s", "init.bake_s", "init.signals_s", "init.artifact_s",
                        "solver.c1_factor_s"},
        "tiny.frames": set()}
DEVICE = {"solver.c1_solve_s", "halfway.blend_ms", "halfway.copy_gbps"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", ["tiny.series", "tiny.frames"])
def test_traced_run_reads_the_program_spans(root, name):
    from meshopticalflow_tpu_torch.utils import spans

    cell = portbench_tiny.cell(root, name)
    spans.reset()
    session.run_cell(cell, SEED, 0.5, False, "cpu", log=lambda m: None)
    assert spans.totals()["spans"] == {}
    spans.reset()
    out = session.run_cell(cell, SEED, 0.5, True, "cpu", log=lambda m: None)
    assert out["correct"] is True
    metrics = out["metrics"]
    assert HOST[name] <= set(metrics) and not DEVICE & set(metrics)
    assert all(metrics[m]["value"] > 0 for m in HOST[name])
    pairs = spans.totals()["spans"].get("init", {}).get("count", 0)
    assert pairs == (min(2, out["attempted"]) if name == "tiny.series" else 0)
    owners = {owner for owner, _ in out["breakdown"]["idle_gaps"]}
    assert owners & {"init.signals", "level.solve", "halfway.march", "mg.c1_solve"}
    spans.reset()

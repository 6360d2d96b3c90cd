"""A run of a tiny cell on the CPU, past the harness's look for a card:
the result line's schema, the port against the plain reference for one
small pair, the control failing the limits, and the modules that load."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import portbench_tiny

portbench_tiny.paths()

from pbcore import session  # noqa: E402

SEED = 2**31 + 4242


def quiet(msg):
    pass


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name,trace", [("tiny.series", 0), ("tiny.series", 1),
                                        ("tiny.frames", 0), ("tiny.frames", 1)])
def test_result_line_schema(root, name, trace):
    cell = portbench_tiny.cell(root, name)
    out = session.run_cell(cell, SEED, 1.0, bool(trace), "cpu", log=quiet)
    line = json.loads(json.dumps(out))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["metrics"]) <= {m.name for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == {m.name for m in cell.end_to_end}
        assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "peak_mem_gib")
    for reading in line["check"].values():
        assert reading["value"] <= reading["limit"]


def test_reference_against_port_on_cpu(root):
    """One small pair through the program and through pbref, float64 both:
    the flows agree to the program's solver tolerances (its smoothing
    solves stop at a relative residual of 1e-7; it read 1.6e-6). The
    blends differ at seam texels whose exp-remap test (barycentre inside
    its triangle) falls the other way in the program's native rasterizer
    than in the numpy one (6 of 4,096 texels here), inside the tiny
    limit."""
    import numpy as np
    import torch

    from pbcore import check
    from pbref.flow import ReferenceFlow

    cell = portbench_tiny.cell(root, "tiny.series")
    conf = dict(cell.config, flags=dict(cell.config["flags"], dtype="float64"))
    cell.config = conf
    work = str(root) + "/work64"
    os.makedirs(work, exist_ok=True)
    run = session.Run(cell, SEED, 1.0, False, torch.device("cpu"), work, quiet)
    prob = run.problem([0, 1])
    prob.run()
    hw = prob.halfway_texture()
    ref = ReferenceFlow(run.root, session.reference_flags(conf), 64, 64, torch.device("cpu"))
    tex0, tex1 = run.frames[0][1], run.frames[1][1]
    tf = ref.align(tex0, tex1)
    gap = check.tfield_gap(prob.tfield.numpy(), tf.numpy())
    assert gap < 1e-5, gap
    mad = check.halfway_mad(hw, ref.halfway(tf, tex0, tex1, 0.5))
    assert np.isfinite(mad) and mad < portbench_tiny.TINY_LIMITS["halfway_mad"], mad


@pytest.mark.parametrize("name", ["tiny.series", "tiny.frames"])
def test_control_fails_the_limits(root, name):
    """The control (the reference in float32, every stage stored in
    bfloat16) in the program's place: each of three whole runs, window and
    check as the program's, comes out not correct through the harness's
    own comparison, past a limit."""
    cmd = [sys.executable, os.path.join(root, "portbench", "control.py"), "--workload", name,
           "--system", "control", "--seeds", "11", "12", "13", "--seconds", "0.5",
           "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=portbench_tiny.REPO)
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert [row["seed"] for row in rows] == [11, 12, 13]
    for row in rows:
        assert row["system"] == "control" and row["correct"] is False, row
        assert any(v["value"] > v["limit"] for v in row["check"].values()), row


def test_control_in_place_turns_correct_false(root):
    """run_cell itself with the control in place: its result line says
    not correct; with the program, on the same seed, correct."""
    cell = portbench_tiny.cell(root, "tiny.series")
    assert session.run_cell(cell, SEED, 0.5, False, "cpu", log=quiet,
                            system="control")["correct"] is False
    assert session.run_cell(cell, SEED, 0.5, False, "cpu", log=quiet)["correct"] is True


SCRIPT = r"""
import json, sys
sys.path[:0] = [{bench!r}, {repo!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(body: str) -> set:
    code = SCRIPT.format(bench=portbench_tiny.BENCH, repo=portbench_tiny.REPO, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    root = portbench_tiny.make_root(tmp_path)
    body = (f"import run\nfrom pbcore import session\nimport portbench_tiny\n"
            f"cell = portbench_tiny.cell({root!r}, 'tiny.series')\n"
            f"session.run_cell(cell, 3, 0.5, True, 'cpu', log=lambda m: None)\n"
            f"assert run.forbidden_modules() == [], run.forbidden_modules()")
    body = f"sys.path.insert(0, {os.path.dirname(__file__)!r})\n" + body
    found = _modules(body)
    assert not found & {"jax", "jaxlib", "flax", "meshopticalflow_tpu"}
    assert "meshopticalflow_tpu_torch" in found


def test_reference_loads_nothing_of_the_port():
    body = ("import numpy as np, torch\n"
            "import pbref, pbref.flow, pbref.cg, pbref.fem, pbref.mesh, pbref.ply, "
            "pbref.rasterize, pbref.subdivide, pbref.trace, pbref.whitney\n"
            "from pbref.flow import ReferenceFlow\n"
            "flags = dict(eLength=0.1, pad=2, iterations=2, sSmooth=3e-3, vfSmooth=3e-6, "
            "vfSThreshold=1e-8, dogWeight=1.0, dogSmooth=1e-4, sMultiply=0.25, vMultiply=1.0, "
            "log=False, minStep=0.01, maxSteps=4096)\n"
            f"ref = ReferenceFlow({portbench_tiny.BENCH + '/data/cube.ply'!r}, flags, 32, 32, "
            "torch.device('cpu'))\n"
            "t = np.full((32, 32, 3), 100, np.uint8); t[:, 16:] = 200\n"
            "tf = ref.align(t, t[:, ::-1].copy())\n"
            "ref.halfway(tf, t, t, 0.5)")
    found = _modules(body)
    assert "meshopticalflow_tpu_torch" not in found
    assert not found & {"jax", "jaxlib", "flax", "meshopticalflow_tpu"}

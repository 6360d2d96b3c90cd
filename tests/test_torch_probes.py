"""The Hopper capability probes (kernels/probes.py) on the CPU.

On CPU tensors each probe wrapper takes its plain PyTorch version; those are
held here to the numpy expectations of the reference script
scripts/probe_pallas.py on its own inputs. The CUDA kernels are held to the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from meshopticalflow_tpu_torch.kernels import probes


@pytest.mark.parametrize("name,ref,kernel,builder", probes.PROBES,
                         ids=[p[0] for p in probes.PROBES])
def test_probe_plain_version_matches_script(name, ref, kernel, builder):
    before = kernel.launches
    res = probes.run_probe(kernel, builder, torch.device("cpu"))
    assert res["correct"] and res["matches_plain"], (name, res)
    assert kernel.launches == before          # CPU tensors: plain version
    assert probes.PLAINS[kernel].cuda_calls == 0


def test_probe_script_expectations_are_the_reference_ones():
    """The inputs and expectations are the reference script's: recompute the
    script's own numpy expressions from its source lines."""
    args, expect = probes._inputs_select()
    x, sel, bs = args
    assert x.shape == (1024, 128) and list(sel) == [3, 1, 4, 1] and bs == 128
    np.testing.assert_array_equal(expect[:128], x[3 * 128:4 * 128] + 1.0)
    args, expect = probes._inputs_dma()
    np.testing.assert_array_equal(expect, args[0][128:256])
    args, expect = probes._inputs_accumulate()
    assert args[0].shape == (4, 3, 8, 128) and expect.shape == (32, 128)


def test_entry_point_reports_each_probe(capsys):
    assert probes.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[ok]") for line in out) == len(probes.PROBES)


def test_entry_point_fails_on_a_wrong_probe(monkeypatch, capsys):
    name, ref, kernel, builder = probes.PROBES[2]

    def wrong():
        args, expect = builder()
        return args, expect + 1.0

    monkeypatch.setattr(probes, "PROBES",
                        probes.PROBES[:2] + [(name, ref, kernel, wrong)] + probes.PROBES[3:])
    assert probes.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"[FAIL] {name}" in out


@pytest.mark.parametrize("case", ["dtype", "shape", "bulk_unaligned"])
def test_probe_wrappers_refuse_bad_operands(case):
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    if case == "dtype":
        with pytest.raises(TypeError):
            probes.scale(x.to(torch.float64))
    elif case == "shape":
        with pytest.raises(ValueError):
            probes.row_gather(x, torch.zeros((2, 4), dtype=torch.int32).t())
    else:
        with pytest.raises(ValueError):
            probes.bulk_copy(torch.zeros((4, 3)), 1, 2)


# The launch plans of the bulk-copy and grid-accumulation kernels
# (kernels/probes.py), checked on the host: the kernels run only on the card.

SCRIPT_DMA_FLOATS = 128 * 128          # rows 128:256 of the (512, 128) probe: 64 KB
BULK_SIZES = [4, probes.BULK_MAX_CHUNK, probes.BULK_MAX_CHUNK + 4, SCRIPT_DMA_FLOATS,
              16 * 2 ** 20]            # 16 bytes, one chunk, one chunk + 16 bytes, 64 KB, 64 MB


def _bulk_schedule(plan, n):
    """(CTA, first float, floats) of every chunk, as
    csrc/probes.cu:probe_bulk_copy_kernel walks them: CTA b moves chunks b,
    b + grid, ..., the last one short."""
    n_chunks = -(-n // plan.chunk)
    for b in range(plan.grid):
        for c in range(b, n_chunks, plan.grid):
            yield b, c * plan.chunk, min(plan.chunk, n - c * plan.chunk)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("n", BULK_SIZES)
def test_bulk_copy_plan_covers_every_float_once(n, sms):
    plan = probes.bulk_copy_plan(n, sms)
    hits = np.zeros(n, np.int8)
    per_cta = np.zeros(plan.grid, np.int64)
    for b, first, size in _bulk_schedule(plan, n):
        assert (first * 4) % 16 == 0 and (size * 4) % 16 == 0 and size > 0
        hits[first:first + size] += 1
        per_cta[b] += 1
    assert (hits == 1).all()
    assert per_cta.min() >= 1 and per_cta.max() - per_cta.min() <= 1   # balanced
    assert plan.chunk % 4 == 0 and plan.chunk <= probes.BULK_MAX_CHUNK
    assert plan.smem == plan.stages * plan.chunk * 4 <= probes.BULK_SMEM_BUDGET
    assert 1 <= plan.grid <= probes.BULK_CTAS_PER_SM * sms
    # one stage exactly when every CTA has one chunk: the 2-stage ring is
    # only for persistent CTAs
    assert plan.stages == (1 if per_cta.max() == 1 else 2)


def test_bulk_copy_plan_spreads_the_script_copy_and_walks_a_large_one():
    """The script's 64 KB goes to at least 32 CTAs of at most 2 KB on the
    H100's 132 SMs; 64 MB goes to persistent CTAs of several chunks each."""
    small = probes.bulk_copy_plan(SCRIPT_DMA_FLOATS, 132)
    assert small.grid >= 32 and small.chunk * 4 <= 2048 and small.stages == 1
    large = probes.bulk_copy_plan(16 * 2 ** 20, 132)
    chunks = 16 * 2 ** 20 // large.chunk
    assert large.grid <= probes.BULK_CTAS_PER_SM * 132 and large.stages == 2
    assert chunks >= 4 * large.grid and chunks % large.grid == 0     # 8 chunks on every CTA


@pytest.mark.parametrize("n", [0, -4, 6])
def test_bulk_copy_plan_refuses_ragged_sizes(n):
    with pytest.raises(ValueError):
        probes.bulk_copy_plan(n, 132)


def _accumulate_hits(plan, b, rw):
    """How often each output float is written, as
    csrc/probes.cu:probe_accumulate_kernel's grid-stride loop writes them."""
    width = 4 if plan.vector else 1
    hits = np.zeros(b * rw, np.int64)
    stride = plan.grid * plan.threads
    for t in range(stride):
        for u in range(t, plan.units, stride):
            hits[u * width:(u + 1) * width] += 1
    return hits


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,r,w", [(4, 8, 128), (5, 6, 171), (3, 1, 1), (7, 3, 4),
                                   (2, 2, 2), (600, 8, 128), (1, 1, 4)])
def test_accumulate_plan_form_and_coverage(b, r, w, sms):
    plan = probes.accumulate_plan(b, r * w, sms)
    assert plan.vector == ((r * w) % 4 == 0)
    assert plan.per_block * (4 if plan.vector else 1) == r * w
    assert plan.units * (4 if plan.vector else 1) == b * r * w
    assert (_accumulate_hits(plan, b, r * w) == 1).all()
    assert probes.ACC_MIN_THREADS <= plan.threads <= probes.ACC_THREADS
    assert 1 <= plan.grid <= probes.ACC_CTAS_PER_SM * sms


def test_accumulate_plan_misaligned_operand_takes_the_scalar_form():
    plan = probes.accumulate_plan(4, 8 * 128, 132, aligned=False)
    assert not plan.vector and plan.units == 4 * 8 * 128
    assert (_accumulate_hits(plan, 4, 8 * 128) == 1).all()


def test_accumulate_plan_spreads_the_script_shape_and_strides_a_large_one():
    """The script's (4, 3, 8, 128): 1,024 vectors over 32 CTAs of 32 threads;
    (8192, 3, 8, 128): CTAs of 128 threads, capped, so threads stride."""
    small = probes.accumulate_plan(4, 8 * 128, 132)
    assert small.vector and small.units == 1024 and small.grid >= 32
    large = probes.accumulate_plan(8192, 8 * 128, 132)
    assert large.threads == probes.ACC_THREADS
    assert large.grid == probes.ACC_CTAS_PER_SM * 132
    assert large.units > large.grid * large.threads

"""The Hopper capability probes (kernels/probes.py) on the CPU.

On CPU tensors each probe wrapper takes its plain PyTorch version; those are
held here to the numpy expectations of the reference script
scripts/probe_pallas.py on its own inputs, and to the script's Pallas
kernels themselves, run in interpret mode. The CUDA kernels are held to the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from meshopticalflow_tpu_torch.kernels import probes

PROBE_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "probe_pallas.py"
# (function of scripts/probe_pallas.py, name of the port's probe). Left out:
# p_accumulate_grid, whose kernel stores the (1, 1, 8, 128) block of x into
# the (8, 128) output ref; Pallas' interpreter refuses that store
# ("ValueError: Invalid shape for `swap`", JAX 0.9.0), so the probe runs
# only under Mosaic on a TPU. The port's accumulation is held to the
# script's numpy expectation by test_probe_plain_version_matches_script.
JAX_PROBES = [("p_basic", "basic"),
              ("p_take_along_axis_rows", "take_along_axis rows (axis 0)"),
              ("p_flat_gather", "flat 1-D gather"),
              ("p_dynamic_gather_lanes", "take_along_axis lanes (axis 1)"),
              ("p_scalar_prefetch_indexmap", "scalar-prefetch index_map"),
              ("p_dma_hbm_to_vmem", "manual HBM->VMEM DMA")]


@pytest.fixture(scope="module")
def probe_script():
    spec = importlib.util.spec_from_file_location("probe_pallas_script", PROBE_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fn_name,name", JAX_PROBES, ids=[p[1] for p in JAX_PROBES])
def test_plain_version_matches_jax_probe_in_interpret_mode(probe_script, monkeypatch,
                                                           fn_name, name):
    """The script's own probe, its pallas_call run with interpret=True, on its
    own operands: the port's plain version gives the same array exactly
    (small integers in f32, plus 1.0), and the script's operands are the
    port's inputs."""
    calls = []
    pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        call = pallas_call(*args, **{**kwargs, "interpret": True})

        def run(*operands):
            out = call(*operands)
            calls.append(([np.asarray(o) for o in operands], np.asarray(out)))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    getattr(probe_script, fn_name)()
    assert len(calls) == 1
    operands, jax_out = calls[0]
    _, _, kernel, builder = next(p for p in probes.PROBES if p[0] == name)
    args, _ = probes.probe_args(builder, torch.device("cpu"))
    port_arrays = [a.numpy() for a in args if isinstance(a, torch.Tensor)]
    assert len(operands) == len(port_arrays)
    for op in operands:
        assert any(op.dtype == a.dtype and np.array_equal(op, a) for a in port_arrays)
    got = probes.PLAINS[kernel](*args).numpy()
    assert got.dtype == jax_out.dtype
    np.testing.assert_array_equal(got, jax_out)


def test_jax_parity_covers_every_probe_but_the_accumulation():
    names = {p[0] for p in probes.PROBES}
    assert names - {n for _, n in JAX_PROBES} == {"grid accumulation"}


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


# The launch plans of the block-select and row-gather kernels, checked on
# the host by walking them as the kernels do.

def _select_walk(plan, x, sel):
    """The output of csrc/probes.cu:probe_block_select_kernel under ``plan``,
    and how often each output float is written: CTA c takes tiles c, c +
    grid, ...; tile t covers block b = t // tiles_per_block, units
    (t % tiles_per_block) * tile + k + v * threads for thread k, v < vpt,
    read from block sel[b]."""
    width = 4 if plan.vector else 1
    src = x.reshape(-1, plan.block_units, width)
    out = np.full((len(sel), plan.block_units, width), np.nan, np.float32)
    hits = np.zeros(out.shape, np.int64)
    lanes = (np.arange(plan.threads)[:, None] + np.arange(plan.vpt)[None, :] * plan.threads)
    n_tiles = len(sel) * plan.tiles_per_block
    for c in range(plan.grid):
        for t in range(c, n_tiles, plan.grid):
            b = t // plan.tiles_per_block
            u = (t - b * plan.tiles_per_block) * plan.tile + lanes.ravel()
            u = u[u < plan.block_units]
            out[b, u] = src[sel[b], u] + 1.0
            hits[b, u] += 1
    return out.reshape(-1, x.shape[1]), hits


# (number of blocks, block rows, W, sel): the script's shape, a block of
# floats not a multiple of 4 (3 x 171), W = 171 in a block of whole float4s
# (4 x 171), repeated entries, one selected block of one float
SELECT_CASES = [(8, 128, 128, [3, 1, 4, 1]), (5, 3, 171, [4, 4, 0, 2, 4]),
                (4, 4, 171, [1, 3, 3]), (600, 8, 128, list(range(1, 600, 3)) * 2),
                (2, 1, 1, [1])]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("case", range(len(SELECT_CASES)))
def test_block_select_plan_form_and_coverage(case, sms):
    nblocks, rows, w, sel = SELECT_CASES[case]
    x = np.arange(nblocks * rows * w, dtype=np.float32).reshape(nblocks * rows, w) % 251
    plan = probes.block_select_plan(len(sel), rows * w, sms)
    assert plan.vector == ((rows * w) % 4 == 0)
    assert plan.block_units * (4 if plan.vector else 1) == rows * w
    assert plan.tile == plan.threads * plan.vpt and plan.vpt in (1, 2, 4, 8)
    assert plan.tiles_per_block == -(-plan.block_units // plan.tile)
    out, hits = _select_walk(plan, x, np.asarray(sel))
    assert (hits == 1).all()
    want = probes.block_select_plain(torch.from_numpy(x), torch.tensor(sel, dtype=torch.int32),
                                     rows).numpy()
    np.testing.assert_array_equal(out, want)
    assert probes.TILE_MIN_THREADS <= plan.threads <= probes.TILE_THREADS
    assert 1 <= plan.grid <= probes.TILE_CTAS_PER_SM * sms


def _gather_walk(plan, x, idx):
    """The output of csrc/probes.cu:probe_row_gather_kernel under ``plan``
    and the writes per output float: tile s (s = c, c + grid, ... for CTA
    c) covers units s * tile + k + v * threads; unit u is row u // per_row,
    lanes width * (u % per_row) + [0, width)."""
    width = 4 if plan.vector else 1
    m, w = idx.shape
    out = np.full(m * w, np.nan, np.float32)
    hits = np.zeros(m * w, np.int64)
    lanes = (np.arange(plan.threads)[:, None] + np.arange(plan.vpt)[None, :] * plan.threads)
    n_tiles = -(-plan.units // plan.tile)
    for c in range(plan.grid):
        for s in range(c, n_tiles, plan.grid):
            u = s * plan.tile + lanes.ravel()
            u = u[u < plan.units]
            for q in range(width):
                row, col = u // plan.per_row, width * (u % plan.per_row) + q
                out[row * w + col] = x[idx[row, col], col]
                hits[row * w + col] += 1
    return out.reshape(m, w), hits


def _rows_index(n, m, w, seed, broadcast):
    rng = np.random.default_rng(seed)
    if broadcast:
        return np.ascontiguousarray(np.broadcast_to((np.arange(m) * 3 % n)[:, None], (m, w)),
                                    dtype=np.int32)
    return rng.integers(0, n, (m, w)).astype(np.int32)


# (n, m, W, broadcast index): the script's shape, lanes of one output
# vector naming different rows, W = 171 (scalar form), a large grid, one
# float, W = 4
GATHER_CASES = [(256, 64, 128, True), (256, 64, 128, False), (50, 37, 171, False),
                (3000, 20000, 16, False), (1, 1, 1, True), (9, 7, 4, True)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("case", range(len(GATHER_CASES)))
def test_row_gather_plan_form_and_coverage(case, sms):
    n, m, w, broadcast = GATHER_CASES[case]
    x = np.arange(n * w, dtype=np.float32).reshape(n, w)
    idx = _rows_index(n, m, w, case, broadcast)
    plan = probes.row_gather_plan(m, w, sms)
    assert plan.vector == (w % 4 == 0)
    assert plan.per_row * (4 if plan.vector else 1) == w and plan.units == m * plan.per_row
    assert plan.tile == plan.threads * plan.vpt and plan.vpt in (1, 2, 4, 8)
    out, hits = _gather_walk(plan, x, idx)
    assert (hits == 1).all()
    want = probes.row_gather_plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, want)
    assert probes.TILE_MIN_THREADS <= plan.threads <= probes.TILE_THREADS
    assert 1 <= plan.grid <= probes.TILE_CTAS_PER_SM * sms


@pytest.mark.parametrize("kernel", ["block_select", "row_gather"])
def test_new_plans_misaligned_operand_takes_the_scalar_form(kernel):
    if kernel == "block_select":
        plan = probes.block_select_plan(4, 128 * 128, 132, aligned=False)
        assert not plan.vector and plan.block_units == 128 * 128
        x = np.arange(8 * 128 * 128, dtype=np.float32).reshape(-1, 128) % 251
        assert (_select_walk(plan, x, np.asarray([3, 1, 4, 1]))[1] == 1).all()
    else:
        plan = probes.row_gather_plan(64, 128, 132, aligned=False)
        assert not plan.vector and plan.units == 64 * 128 and plan.per_row == 128
        x = np.arange(256 * 128, dtype=np.float32).reshape(256, 128)
        assert (_gather_walk(plan, x, _rows_index(256, 64, 128, 0, True))[1] == 1).all()


def test_new_plans_spread_the_script_shapes_and_stride_the_large_ones():
    """The script's shapes go to at least 32 CTAs on the H100's 132 SMs; the
    byte-bound sizes of chip_smoke.py (1,024 blocks of 128 x 128; a
    (131072, 128) gather) go to capped grids whose CTAs walk several tiles."""
    small = probes.block_select_plan(4, 128 * 128, 132)
    assert small.vector and small.grid >= 32 and small.grid == 4 * small.tiles_per_block
    large = probes.block_select_plan(1024, 128 * 128, 132)
    assert large.threads == probes.TILE_THREADS and large.vpt == probes.TILE_VPT
    assert large.grid == probes.TILE_CTAS_PER_SM * 132
    assert 1024 * large.tiles_per_block > large.grid
    small = probes.row_gather_plan(64, 128, 132)
    assert small.vector and small.grid >= 32
    large = probes.row_gather_plan(131072, 128, 132)
    assert large.threads == probes.TILE_THREADS and large.vpt == probes.TILE_VPT
    assert large.grid == probes.TILE_CTAS_PER_SM * 132
    assert large.units > large.grid * large.tile


# The launch plans of the scale and flat-gather kernels and the flat
# gather's ordering twin, checked on the host by walking the plans as the
# kernels walk them.

SCRIPT_FLOATS = 8 * 128                 # the script's (8, 128) operands
LARGE_FLOATS = 262144 * 128             # chip_smoke.LARGE_PROBES: 134 MB of x


def _unit_floats(u, width):
    """The output floats of units ``u`` (float4 units: width 4)."""
    return (u[:, None] * width + np.arange(width)[None, :]).ravel()


def _scale_walk(plan, x):
    """The output of csrc/probes.cu:probe_scale_kernel under ``plan`` and the
    writes per output float: CTA c takes tiles c, c + grid, ...; tile s
    covers units s * tile + k + v * threads; CTA 0's first ``tail`` threads
    take the floats past the units."""
    width = 4 if plan.vector else 1
    n = x.size
    out = np.full(n, np.nan, np.float32)
    lanes = (np.arange(plan.threads)[:, None] + np.arange(plan.vpt)[None, :] * plan.threads)
    n_tiles = -(-plan.units // plan.tile)
    written = []
    for c in range(plan.grid):
        u = (np.arange(c, n_tiles, plan.grid)[:, None] * plan.tile + lanes.ravel()).ravel()
        f = _unit_floats(u[u < plan.units], width)
        out[f] = 2.0 * x[f]
        written.append(f)
    f = plan.units * width + np.arange(plan.tail)
    out[f] = 2.0 * x[f]
    written.append(f)
    return out, np.bincount(np.concatenate(written), minlength=n)


@pytest.mark.parametrize("aligned", [True, False], ids=["vector", "misaligned"])
@pytest.mark.parametrize("sms", [1, 132, 264])
@pytest.mark.parametrize("n", [SCRIPT_FLOATS, SCRIPT_FLOATS - 1, 3, 5, LARGE_FLOATS,
                               LARGE_FLOATS + 3])
def test_scale_plan_form_and_coverage(n, sms, aligned):
    plan = probes.scale_plan(n, sms, aligned)
    width = 4 if plan.vector else 1
    assert plan.vector == aligned                # misaligned operands: the scalar form
    assert plan.units * width + plan.tail == n and plan.tail == (n % 4 if aligned else 0)
    assert plan.threads == probes.SCALE_THREADS and plan.vpt in (1, 2, 4, 8)
    assert plan.vpt == probes.SCALE_VPT or plan.threads * plan.vpt * 2 > plan.units
    assert 1 <= plan.grid <= probes.SCALE_CTAS_PER_SM * sms
    x = (np.arange(n) % 251).astype(np.float32)
    out, hits = _scale_walk(plan, x)
    assert (hits == 1).all()
    if n <= SCRIPT_FLOATS:
        np.testing.assert_array_equal(out, probes.scale_plain(torch.from_numpy(x)).numpy())


def test_scale_plan_shapes_the_script_large_and_capped_sizes():
    """The script's (8, 128): 256 vectors in one CTA, a vector a thread (not
    spread over the SMs: one wide CTA reads fastest where the launch sets
    the time); (262144, 128): full tiles, one a CTA, under the cap; four
    times that: the capped grid, whose CTAs walk several tiles each."""
    small = probes.scale_plan(SCRIPT_FLOATS, 132)
    assert small.vector and small.units == 256 and small.grid == 1
    assert small.threads * small.vpt == 256
    large = probes.scale_plan(LARGE_FLOATS, 132)
    assert large.vpt == probes.SCALE_VPT
    assert large.grid == large.units // large.tile <= probes.SCALE_CTAS_PER_SM * 132
    larger = probes.scale_plan(4 * LARGE_FLOATS, 132)
    assert larger.grid == probes.SCALE_CTAS_PER_SM * 132
    assert larger.units > larger.grid * larger.tile


def _flat_walk(plan, x, idx, order):
    """The output of csrc/probes.cu:probe_flat_gather_kernel under ``plan``
    with chunk order ``order`` (None: index order) and the writes per output
    float: CTA c takes the tile steps [c * per, (c + 1) * per), per =
    ceil(steps / grid); with an order, step s is tile s % tiles_per_chunk of
    the chunk at position s // tiles_per_chunk, without one tile s of the
    units; CTA 0's first ``tail`` threads take the floats past the units."""
    width = 4 if plan.vector else 1
    flat = idx.reshape(-1)
    n = flat.size
    out = np.full(n, np.nan, np.float32)
    lanes = (np.arange(plan.threads)[:, None] + np.arange(plan.vpt)[None, :] * plan.threads)
    cu, tpc = plan.chunk_units, plan.tiles_per_chunk
    steps = plan.n_chunks * tpc if order is not None else -(-plan.units // plan.tile)
    written = []
    per = -(-steps // plan.grid)
    for c in range(plan.grid):
        s = np.arange(c * per, min((c + 1) * per, steps))
        p = s // tpc
        start = (np.asarray(order)[p] if order is not None else p).astype(np.int64) * cu
        end = np.minimum(start + cu, plan.units)
        u = (start + (s - p * tpc) * plan.tile)[:, None] + lanes.ravel()[None, :]
        f = _unit_floats(u[u < end[:, None]], width)
        out[f] = x[flat[f]]
        written.append(f)
    f = plan.units * width + np.arange(plan.tail)
    out[f] = x[flat[f]]
    written.append(f)
    return out, np.bincount(np.concatenate(written), minlength=n)


@pytest.mark.parametrize("aligned", [True, False], ids=["vector", "misaligned"])
@pytest.mark.parametrize("sms", [1, 132, 264])
@pytest.mark.parametrize("n", [SCRIPT_FLOATS, 3, 3 * 4096 + 5, LARGE_FLOATS])
def test_flat_gather_plan_writes_every_output_once_in_any_order(n, sms, aligned):
    """Every output float is written once whatever the chunk order: here a
    random permutation of the chunks (numpy seed), not the ordering pass's."""
    plan = probes.flat_gather_plan(n, sms, aligned)
    width = 4 if plan.vector else 1
    assert plan.vector == aligned
    assert plan.units * width + plan.tail == n and plan.tail == (n % 4 if aligned else 0)
    assert plan.n_chunks == -(-plan.units // plan.chunk_units)
    assert plan.ordered == (plan.n_chunks >= probes.GATHER_MIN_ORDERED_CHUNKS)
    assert plan.chunk_units % plan.tile == 0 and plan.vpt in (1, 2, 4, 8)
    assert 1 <= plan.grid <= probes.GATHER_CTAS_PER_SM * sms
    idx = (np.arange(n, dtype=np.int64) * 7 % max(n, 1)).astype(np.int32)
    x = (np.arange(n) % 251).astype(np.float32)
    order = (np.random.default_rng(n).permutation(plan.n_chunks) if plan.ordered else None)
    out, hits = _flat_walk(plan, x, idx, order)
    assert (hits == 1).all()
    if n < LARGE_FLOATS:
        np.testing.assert_array_equal(out, x[idx])


def test_flat_gather_plan_orders_the_large_size_and_not_the_script_one():
    """The script's 1,024 outputs are one chunk: no ordering pass, the tiles
    spread over at least 8 CTAs; x (33554432,) with idx (262144, 128): 8,192
    chunks of GATHER_CHUNK outputs, ordered, on a capped grid."""
    small = probes.flat_gather_plan(SCRIPT_FLOATS, 132)
    assert small.vector and not small.ordered and small.n_chunks == 1 and small.grid >= 8
    large = probes.flat_gather_plan(LARGE_FLOATS, 132)
    assert large.ordered and large.chunk == probes.GATHER_CHUNK
    assert large.n_chunks == LARGE_FLOATS // probes.GATHER_CHUNK == 8192
    assert large.grid == probes.GATHER_CTAS_PER_SM * 132
    assert large.n_chunks * large.tiles_per_chunk > large.grid


def test_flat_gather_plan_doubles_the_chunk_past_the_chunk_limit(monkeypatch):
    monkeypatch.setattr(probes, "GATHER_MAX_CHUNKS", 16)
    probes.clear_plans()
    try:
        plan = probes.flat_gather_plan(100 * probes.GATHER_CHUNK, 132)
        assert plan.chunk == 8 * probes.GATHER_CHUNK and plan.n_chunks == 13
        monkeypatch.setattr(probes, "GATHER_CHUNK", 3000)
        probes.clear_plans()
        with pytest.raises(ValueError):
            probes.flat_gather_plan(100000, 132)
    finally:
        monkeypatch.undo()
        probes.clear_plans()


def _flat_index(kind, n, nx):
    """idx of one of four kinds, x of ``nx`` floats: 7 t mod nx (the script's
    pattern), a random permutation, random entries with repeats, and all
    entries equal (every key ties)."""
    rng = np.random.default_rng(7)
    if kind == "7t":
        return (np.arange(n, dtype=np.int64) * 7 % nx).astype(np.int32)
    if kind == "permutation":
        return rng.permutation(nx)[:n].astype(np.int32)
    if kind == "repeats":
        return rng.integers(0, nx // 16, n).astype(np.int32)
    return np.full(n, nx // 2, np.int32)


# (kind, outputs, floats of x): at least two chunks of GATHER_CHUNK outputs;
# 5 chunks and 3 floats (a length not a multiple of the chunk, n % 4 = 3)
FLAT_CASES = [("7t", 6 * 4096, 12289), ("permutation", 5 * 4096 + 3, 5 * 4096 + 3),
              ("repeats", 5 * 4096 + 3, 9000), ("ties", 3 * 4096, 100)]


@pytest.mark.parametrize("kind,n,nx", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_flat_gather_order_twin_is_a_stable_sort_of_the_chunks(kind, n, nx):
    idx = torch.from_numpy(_flat_index(kind, n, nx))
    plan = probes.flat_gather_plan(n, 132)
    assert plan.ordered and plan.n_chunks >= 2
    order = probes.flat_gather_order_plain(idx, plan.chunk, plan.n_chunks)
    assert order.dtype == torch.int32
    order = order.numpy()
    assert sorted(order) == list(range(plan.n_chunks))          # a permutation
    keys = idx.numpy()[order.astype(np.int64) * plan.chunk]
    assert (np.diff(keys) >= 0).all()                           # non-decreasing in key
    ties = np.diff(keys) == 0
    assert (np.diff(order)[ties] > 0).all()                     # ties by id
    again = probes.flat_gather_order_plain(idx, plan.chunk, plan.n_chunks).numpy()
    np.testing.assert_array_equal(order, again)
    # the CPU wrapper is the twin
    np.testing.assert_array_equal(probes.flat_gather_order(idx, plan.chunk, plan.n_chunks),
                                  order)


@pytest.mark.parametrize("sms", [1, 132, 264])
@pytest.mark.parametrize("kind,n,nx", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_flat_gather_chunks_in_twin_order_equal_the_plain_version(kind, n, nx, sms):
    idx = _flat_index(kind, n, nx)
    x = (np.arange(nx) % 251).astype(np.float32) - 125.0
    plan = probes.flat_gather_plan(n, sms)
    order = probes.flat_gather_order_plain(torch.from_numpy(idx), plan.chunk,
                                           plan.n_chunks).numpy()
    out, hits = _flat_walk(plan, x, idx, order)
    assert (hits == 1).all()
    want = probes.flat_gather_plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("chunk,n_chunks", [(4096, 3), (4096, -1), (0, 2)])
def test_flat_gather_order_refuses_chunks_past_the_index(chunk, n_chunks):
    with pytest.raises(ValueError):
        probes.flat_gather_order(torch.zeros(2 * 4096, dtype=torch.int32), chunk, n_chunks)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
elsewhere. The file imports neither jax nor the reference package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from meshopticalflow_tpu_torch.kernels import probes, spmv

# max |kernel - plain| / max |plain|: the two sum the W slots in another
# order (and the kernel fuses multiply-adds).
KERNEL_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-6, torch.float64: 1e-12}


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _operands(n, w, c, dtype, seed=3, positive=False):
    """A random operator near the diagonal; ``positive`` draws values and x
    from |N(0, 1)|, so no output is a sum that cancels to near zero."""
    rng = np.random.default_rng(seed)
    cols = torch.from_numpy((np.arange(n)[:, None]
                             + rng.integers(-300, 300, (n, w))) % n).to(torch.int32)
    vals = torch.from_numpy(rng.standard_normal((n, w)))
    x = torch.from_numpy(rng.standard_normal((n, c) if c else n))
    if positive:
        vals, x = vals.abs(), x.abs()
    x_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    dev = torch.device("cuda")
    return cols.to(dev), vals.to(dtype).to(dev), x.to(x_dtype).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("n,w,c", [(5000, 9, 0), (5000, 7, 6), (5000, 9, 8),
                                   (589824, 9, 0), (196610, 7, 6)])
def test_cuda_kernel_matches_plain(dtype, n, w, c):
    _require_card()
    cols, vals, x = _operands(n, w, c, dtype)
    fn, plain = ((spmv.spmv_ell_multi, spmv.spmv_ell_multi_plain) if c
                 else (spmv.spmv_ell, spmv.spmv_ell_plain))
    before = fn.launches
    y = fn(cols, vals, x)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    ref = plain(cols, vals, x)
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err <= KERNEL_TOL[dtype], err


def _check_against_plain(cols, vals, x, c):
    fn, plain = ((spmv.spmv_ell_multi, spmv.spmv_ell_multi_plain) if c
                 else (spmv.spmv_ell, spmv.spmv_ell_plain))
    before = fn.launches
    y = fn(cols, vals, x)
    torch.cuda.synchronize()
    assert fn.launches == before + (1 if cols.shape[0] else 0)
    assert y.dtype == x.dtype and y.shape == ((cols.shape[0], c) if c else (cols.shape[0],))
    ref = plain(cols, vals, x)
    if cols.shape[0]:
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= KERNEL_TOL[vals.dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("w", [1, 3, 9, 13, 40, 49, 69])
@pytest.mark.parametrize("c", range(0, 9))
def test_cuda_widths_and_columns(dtype, w, c):
    """Both variants (slab rows up to SLAB_MAX_WIDTH slots, lane groups past
    it), single and 1..8 columns, bf16 with odd W, a ragged last slab."""
    _require_card()
    n = 3 * spmv.slab_rows(min(w, spmv.SLAB_MAX_WIDTH), max(c, 1), dtype.itemsize) + 5
    _check_against_plain(*_operands(n, w, c, dtype, seed=w + c), c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("tail", ["1", "7", "R-1", "R+1", "132*8*R+1"])
@pytest.mark.parametrize("w,c", [(9, 0), (3, 6)])
def test_cuda_ragged_tails(dtype, tail, w, c):
    """Row counts around the slab size R: below one slab (plain loads only),
    one short of and one past a slab, and more slabs than the card holds
    CTAs, plus one. Positive operands: a handful of rows must not make the
    relative error a measure of cancellation."""
    _require_card()
    r = spmv.slab_rows(w, max(c, 1), dtype.itemsize)
    n = {"1": 1, "7": 7, "R-1": r - 1, "R+1": r + 1, "132*8*R+1": 132 * 8 * r + 1}[tail]
    _check_against_plain(*_operands(n, w, c, dtype, seed=n, positive=True), c)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [0, 6])
def test_cuda_no_rows(c):
    _require_card()
    cols, vals, x = _operands(64, 9, c, torch.float32)
    _check_against_plain(cols[:0], vals[:0], x, c)


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["vals", "cols"])
def test_cuda_misaligned_operand_raises(operand):
    """The slab copies need 16-byte aligned cols and vals: a view 4 bytes
    into its storage is refused, not sent down another path."""
    _require_card()
    cols, vals, x = _operands(5000, 9, 0, torch.float32)
    if operand == "vals":
        vals = torch.cat([vals.reshape(-1), vals.new_zeros(1)])[1:].view(vals.shape)
    else:
        cols = torch.cat([cols.reshape(-1), cols.new_zeros(1)])[1:].view(cols.shape)
    before = spmv.spmv_ell.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        spmv.spmv_ell(cols, vals, x)
    assert spmv.spmv_ell.launches == before


@pytest.mark.gpu
def test_cuda_wrapper_refuses_mixed_devices():
    _require_card()
    cols, vals, x = _operands(64, 3, 0, torch.float32)
    with pytest.raises(ValueError):
        spmv.spmv_ell(cols, vals, x.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("n_out,n_in,w,c", [(589824, 36864, 3, 0), (36864, 589824, 40, 0),
                                            (196610, 12290, 3, 6), (12290, 196610, 30, 6)])
def test_cuda_rectangular_matches_plain(dtype, n_out, n_in, w, c):
    """The MG transfers P0 (fine <- coarse) and P0^T at the main path's sizes."""
    _require_card()
    rng = np.random.default_rng(n_out + w)
    dev = torch.device("cuda")
    cols = torch.from_numpy(rng.integers(0, n_in, (n_out, w))).to(torch.int32).to(dev)
    spmv.check_columns(cols, n_in)
    vals = torch.from_numpy(rng.standard_normal((n_out, w))).to(dtype).to(dev)
    x_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.from_numpy(rng.standard_normal((n_in, c) if c else n_in)).to(x_dtype).to(dev)
    fn, plain = ((spmv.spmv_ell_multi, spmv.spmv_ell_multi_plain) if c
                 else (spmv.spmv_ell, spmv.spmv_ell_plain))
    y = fn(cols, vals, x)
    torch.cuda.synchronize()
    assert y.shape == ((n_out, c) if c else (n_out,))
    ref = plain(cols, vals, x)
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err <= KERNEL_TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_group_kernel_square_w20(dtype):
    """The conformal flow operator's form: square, 20 slots a row (past
    SLAB_MAX_WIDTH, so lane groups), at the full-size row count."""
    _require_card()
    assert spmv.variant_of(20) == "group"
    cols, vals, x = _operands(393220, 20, 0, dtype)
    _check_against_plain(cols, vals, x, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_out,n_in,w,c", [
    (786432, 49152, 2, 0), (49152, 786432, 32, 0),      # connection P0, P0^T
    (393220, 24580, 3, 0), (24580, 393220, 55, 0),      # conformal P0, P0^T
    (196610, 12290, 3, 6), (12290, 196610, 55, 6)])     # vertex P0, P0^T
def test_cuda_twolevel_transfers_f32(n_out, n_in, w, c):
    """The two-level cycle's transfers in float32 values (its working dtype)."""
    _require_card()
    rng = np.random.default_rng(n_out + w)
    dev = torch.device("cuda")
    cols = torch.from_numpy(rng.integers(0, n_in, (n_out, w))).to(torch.int32).to(dev)
    spmv.check_columns(cols, n_in)
    vals = torch.from_numpy(rng.standard_normal((n_out, w))).to(torch.float32).to(dev)
    x = torch.from_numpy(rng.standard_normal((n_in, c) if c else n_in)).to(
        torch.float32).to(dev)
    _check_against_plain(cols, vals, x, c)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [p[0] for p in probes.PROBES])
def test_cuda_probe_matches_plain_and_script(name):
    _require_card()
    _, _, kernel, builder = next(p for p in probes.PROBES if p[0] == name)
    before = kernel.launches
    res = probes.run_probe(kernel, builder, torch.device("cuda"))
    assert kernel.launches == before + 1
    assert res["correct"] and res["matches_plain"], res


def _small_ints(shape, seed):
    """f32 small integers: every sum below is exact in any order, so kernel
    and plain version must agree bit for bit."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.float32)).cuda()


# (shape of x, start row, rows copied): one chunk (16 bytes; BULK_MIN_CHUNK
# floats), a short last chunk (3 chunks and 16 bytes), and a persistent
# grid with at least 8 chunks on each CTA and a short last one (69 MB)
BULK_CASES = {"16_bytes": ((8, 4), 3, 1),
              "one_chunk": ((16, 128), 2, 2),
              "ragged": ((1000, 4), 5, 3 * 64 + 1),
              "persistent": ((8 * 4 * 132 * 32 + 8, 128), 7, 8 * 4 * 132 * 32 + 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BULK_CASES))
def test_cuda_bulk_copy_matches_plain(case):
    _require_card()
    shape, start, rows = BULK_CASES[case]
    x = _small_ints(shape, 11)
    n = rows * shape[1]
    plan = probes.bulk_copy_plan(n, probes.sm_count(x.device))
    chunks = -(-n // plan.chunk)
    if case in ("16_bytes", "one_chunk"):
        assert chunks == 1
    elif case == "ragged":
        assert chunks > 1 and n % plan.chunk
    else:
        assert plan.stages == 2 and chunks >= 8 * plan.grid and n % plan.chunk
    before = probes.bulk_copy.launches
    o = probes.bulk_copy(x, start, rows)
    torch.cuda.synchronize()
    assert probes.bulk_copy.launches == before + 1
    assert torch.equal(o, probes.bulk_copy_plain(x, start, rows))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("r,w", [(8, 128), (6, 171)])     # R * W = 1,024 and 1,026
def test_cuda_accumulate_matches_plain(k, r, w):
    _require_card()
    x = _small_ints((37, k, r, w), k)
    plan = probes.accumulate_plan(37, r * w, probes.sm_count(x.device))
    assert plan.vector == (r * w == 1024)
    before = probes.accumulate.launches
    o = probes.accumulate(x)
    torch.cuda.synchronize()
    assert probes.accumulate.launches == before + 1
    assert torch.equal(o, probes.accumulate_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["bulk_copy", "accumulate"])
def test_cuda_probe_misaligned_operand(kernel):
    """A contiguous view 4 bytes into its storage: the bulk copy refuses it
    (cp.async.bulk needs 16-byte aligned addresses) without a launch; the
    accumulation takes its scalar form and still matches the plain version."""
    _require_card()
    flat = _small_ints(1 + 128 * 128, 5)
    if kernel == "bulk_copy":
        x = flat[1:].view(128, 128)
        before = probes.bulk_copy.launches
        with pytest.raises(ValueError, match="16-byte aligned"):
            probes.bulk_copy(x, 32, 32)
        assert probes.bulk_copy.launches == before
    else:
        x = flat[1:1 + 4 * 3 * 8 * 128].view(4, 3, 8, 128)
        assert x.data_ptr() % 16 and not probes.accumulate_plan(
            4, 1024, probes.sm_count(x.device), aligned=False).vector
        o = probes.accumulate(x)
        torch.cuda.synchronize()
        assert torch.equal(o, probes.accumulate_plain(x))
    torch.cuda.synchronize()       # the context is still sound


# (number of blocks, block rows, W, sel): the script's shape with a repeated
# entry; a block of floats not a multiple of 4 (3 x 171: the scalar form);
# W = 171 in blocks of whole float4s (4 x 171); a selection the capped grid
# walks (200 of 600 blocks three times over: 4,800 tiles, at most 4,224 CTAs)
SELECT_CASES = {"script": ((8, 128, 128), [3, 1, 4, 1]),
                "scalar": ((5, 3, 171), [4, 4, 0, 2, 4]),
                "ragged_w": ((4, 4, 171), [1, 3, 3]),
                "grid_stride": ((600, 128, 128), list(range(1, 600, 3)) * 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_cuda_block_select_matches_plain(case):
    _require_card()
    (nblocks, rows, w), sel = SELECT_CASES[case]
    x = _small_ints((nblocks * rows, w), 13)
    sel = torch.tensor(sel, dtype=torch.int32, device="cuda")
    plan = probes.block_select_plan(sel.shape[0], rows * w, probes.sm_count(x.device))
    assert plan.vector == (case != "scalar")
    if case == "grid_stride":
        assert sel.shape[0] * plan.tiles_per_block > plan.grid
    before = probes.block_select.launches
    o = probes.block_select(x, sel, rows)
    torch.cuda.synchronize()
    assert probes.block_select.launches == before + 1
    assert torch.equal(o, probes.block_select_plain(x, sel, rows))


def _row_index(n, m, w, broadcast, seed=17):
    """Row indices: one row across each output row (the script's broadcast
    pattern, 3 i mod n), or a random row per element, so the four lanes of
    an output vector name different rows."""
    if broadcast:
        rows = torch.arange(m, dtype=torch.int32) * 3 % n
        return rows[:, None].expand(m, w).contiguous().cuda()
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, n, (m, w)).astype(np.int32)).cuda()


# (n, m, W, broadcast index): the script's shape; lanes naming different
# rows; W = 171 (the scalar form); a grid the cap makes stride (80,000 x 32
# vectors: 5,000 tiles of 512, at most 4,224 CTAs), half its rows broadcast
GATHER_CASES = {"script": (256, 64, 128, True), "mixed_rows": (256, 64, 128, False),
                "scalar": (50, 37, 171, False), "grid_stride": (4096, 80000, 128, None)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_cuda_row_gather_matches_plain(case):
    _require_card()
    n, m, w, broadcast = GATHER_CASES[case]
    x = _small_ints((n, w), 19)
    if broadcast is None:
        idx = _row_index(n, m, w, False)
        idx[::2] = _row_index(n, m, w, True)[::2]
    else:
        idx = _row_index(n, m, w, broadcast)
    plan = probes.row_gather_plan(m, w, probes.sm_count(x.device))
    assert plan.vector == (case != "scalar")
    if case == "grid_stride":
        assert plan.units > plan.grid * plan.tile
    before = probes.row_gather.launches
    o = probes.row_gather(x, idx)
    torch.cuda.synchronize()
    assert probes.row_gather.launches == before + 1
    assert torch.equal(o, probes.row_gather_plain(x, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["block_select", "row_gather"])
def test_cuda_new_probes_misaligned_operand(kernel):
    """A contiguous view 4 bytes into its storage takes the scalar form and
    still matches the plain version bit for bit."""
    _require_card()
    sms = probes.sm_count(torch.device("cuda"))
    if kernel == "block_select":
        x = _small_ints(1 + 8 * 128 * 128, 23)[1:].view(8 * 128, 128)
        sel = torch.tensor([3, 1, 4, 1], dtype=torch.int32, device="cuda")
        assert x.data_ptr() % 16 and not probes.block_select_plan(
            4, 128 * 128, sms, aligned=False).vector
        before = probes.block_select.launches
        o = probes.block_select(x, sel, 128)
        torch.cuda.synchronize()
        assert probes.block_select.launches == before + 1
        assert torch.equal(o, probes.block_select_plain(x, sel, 128))
    else:
        x = _small_ints((256, 128), 29)
        idx = torch.empty(1 + 64 * 128, dtype=torch.int32, device="cuda")[1:].view(64, 128)
        idx.copy_(_row_index(256, 64, 128, False))
        assert idx.data_ptr() % 16 and not probes.row_gather_plan(
            64, 128, sms, aligned=False).vector
        before = probes.row_gather.launches
        o = probes.row_gather(x, idx)
        torch.cuda.synchronize()
        assert probes.row_gather.launches == before + 1
        assert torch.equal(o, probes.row_gather_plain(x, idx))


@pytest.mark.gpu
def test_cuda_spectrum_matches_arpack():
    """compute_spectrum's CUDA path (block Lanczos on the banded shift-invert
    solve) in float64 on the sphere subdivided twice, k = 6, against scipy's
    ARPACK at rtol 1e-5 (utils/testing.py, as chip_smoke.py)."""
    _require_card()
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.models.base import build_basis
    from meshopticalflow_tpu_torch.ops.assemble import vector_field_mass_blocks
    from meshopticalflow_tpu_torch.solvers.lanczos import compute_spectrum
    from meshopticalflow_tpu_torch.utils.testing import arpack_spectrum, octa_sphere

    tris, verts = octa_sphere(2)
    mesh = build_mesh(tris, vertices=verts)
    host, basis = build_basis(mesh, FlowConfig(dtype="float64"), "cuda")
    mass = torch.as_tensor(vector_field_mass_blocks(mesh)).cuda()
    spmv.reset_counts()
    res = compute_spectrum(basis, mass, 6, cg_tol=1e-12, max_lanczos=min(host.n_coeffs, 600),
                           host_stepped=True)
    counts = spmv.counts()
    np.testing.assert_allclose(res.eigenvalues, arpack_spectrum(host, mesh, 6), rtol=1e-5)
    assert counts["spmv_ell_multi"] > 0 and counts["plain_on_cuda"] == 0


# Scale: the script's (8, 128); n % 4 = 3 (float4 units and a tail); a view
# one float into its storage (the scalar form); a capped grid that strides
# (16,896 CTAs of 1,024 vectors on 132 SMs cover 17,301,504 vectors), with
# a tail
SCALE_CASES = {"script": (8 * 128, 0), "ragged": (1023, 0), "misaligned": (4097, 1),
               "grid_stride": (4 * 17301504 * 5 // 4 + 3, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SCALE_CASES))
def test_cuda_scale_matches_plain(case):
    _require_card()
    n, offset = SCALE_CASES[case]
    x = _small_ints(n + offset, 31)[offset:]
    plan = probes.scale_plan(n, probes.sm_count(x.device), probes._aligned(x))
    assert plan.vector == (case != "misaligned")
    if case == "grid_stride":
        assert plan.units > plan.grid * plan.tile and plan.tail == 3
    before = probes.scale.launches
    o = probes.scale(x)
    torch.cuda.synchronize()
    assert probes.scale.launches == before + 1
    assert torch.equal(o, probes.scale_plain(x))


def _flat_case(kind, n, nx, seed=37):
    """idx (n,) of one kind on the card: 7 t mod nx, a random permutation
    (numpy seed), random entries with repeats, all entries equal."""
    rng = np.random.default_rng(seed)
    if kind == "7t":
        idx = np.arange(n, dtype=np.int64) * 7 % nx
    elif kind == "permutation":
        idx = rng.permutation(nx)[:n]
    elif kind == "repeats":
        idx = rng.integers(0, max(nx // 16, 1), n)
    else:
        idx = np.full(n, nx // 2)
    return torch.from_numpy(idx.astype(np.int32)).cuda()


# (kind, outputs, floats of x): each over one chunk of GATHER_CHUNK outputs;
# a length that is not a multiple of the chunk (n % 4 = 3); more chunks than
# one ordering tile of 256 holds (1,027 chunks), so the merge kernel runs;
# a grid the cap makes stride (4,096 chunks of two tiles: 8,192 steps)
FLAT_GPU_CASES = {"7t": ("7t", 6 * 4096, 12289),
                  "permutation": ("permutation", 5 * 4096 + 3, 5 * 4096 + 3),
                  "repeats": ("repeats", 1027 * 4096 - 1, 100000),
                  "ties": ("ties", 3 * 4096, 100),
                  "grid_stride": ("7t", 4096 * 4096, 4096 * 4096)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLAT_GPU_CASES))
def test_cuda_flat_gather_matches_plain(case):
    _require_card()
    kind, n, nx = FLAT_GPU_CASES[case]
    x = _small_ints(nx, 41)
    idx = _flat_case(kind, n, nx)
    plan = probes.flat_gather_plan(n, probes.sm_count(x.device), probes._aligned(idx))
    assert plan.vector and plan.ordered
    if case == "grid_stride":
        assert plan.n_chunks * plan.tiles_per_chunk > plan.grid
    before, orders = probes.flat_gather.launches, probes.flat_gather_order.launches
    o = probes.flat_gather(x, idx)
    torch.cuda.synchronize()
    assert probes.flat_gather.launches == before + 1
    assert probes.flat_gather_order.launches == orders + 1
    assert torch.equal(o, probes.flat_gather_plain(x, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLAT_GPU_CASES))
def test_cuda_flat_gather_order_matches_twin(case):
    _require_card()
    kind, n, nx = FLAT_GPU_CASES[case]
    idx = _flat_case(kind, n, nx)
    plan = probes.flat_gather_plan(n, probes.sm_count(idx.device))
    got = probes.flat_gather_order(idx, plan.chunk, plan.n_chunks)
    again = probes.flat_gather_order(idx, plan.chunk, plan.n_chunks)
    torch.cuda.synchronize()
    want = probes.flat_gather_order_plain(idx, plan.chunk, plan.n_chunks)
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8 * 128, 5 * 4096 + 2])      # unordered and ordered
def test_cuda_flat_gather_misaligned_index(n):
    """idx a view one int into its storage: the scalar form, still equal to
    the plain version bit for bit."""
    _require_card()
    x = _small_ints(2048, 43)
    idx = torch.empty(n + 1, dtype=torch.int32, device="cuda")[1:]
    idx.copy_(_flat_case("permutation", n, 2048 * 16) % 2048)
    plan = probes.flat_gather_plan(n, probes.sm_count(x.device), probes._aligned(idx))
    assert idx.data_ptr() % 16 and not plan.vector and plan.ordered == (n > 4096)
    o = probes.flat_gather(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(o, probes.flat_gather_plain(x, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rank,world", [(0, 1), (0, 4), (2, 4), (3, 4)])
def test_cuda_halo_form_matches_plain(dtype, rank, world):
    """The halo product's rectangular form: a rank's (block, W) rows against
    x_ext of block + 2 * halo values (parallel/halo.py; the layout needs no
    exchange to build)."""
    _require_card()
    from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup
    from meshopticalflow_tpu_torch.parallel.halo import build_halo_ell
    from meshopticalflow_tpu_torch.utils.testing import halo_test_system

    s = halo_test_system(4)
    h = build_halo_ell(s["cols"], torch.as_tensor(s["vals"]).to(dtype),
                       DeviceGroup(None, rank, world, torch.device("cuda")))
    gen = torch.Generator(device="cuda").manual_seed(rank)
    x_ext = torch.randn(h.block + 2 * h.halo, generator=gen, device="cuda", dtype=dtype)
    assert spmv.form_of("spmv_ell", h.cols_local, h.vals_p, x_ext.shape[0]).split("/")[2] \
        == "rectangular"
    _check_against_plain(h.cols_local, h.vals_p, x_ext, 0)


@pytest.mark.gpu
def test_cuda_halo_mg_pcg_matches_cpu():
    """halo_mg_pcg at world size 1 on the card (the hand SpMV kernel, the
    float32 banded coarse solve) against the same float32 solve on the CPU:
    solutions within 1e-5 relative."""
    _require_card()
    from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup
    from meshopticalflow_tpu_torch.parallel.halo import (build_halo_coarse, build_halo_ell,
                                                         halo_mg_pcg)
    from meshopticalflow_tpu_torch.utils.testing import halo_test_system

    s = halo_test_system(4)
    out = {}
    for dev in ("cpu", "cuda"):
        g = DeviceGroup(None, 0, 1, torch.device(dev))
        h = build_halo_ell(s["cols"], s["vals"].astype(np.float32), g)
        hc = build_halo_coarse(h, s["p0_idx"], s["p0_wt"], s["c1_cols"], s["c1_vals"])
        before = spmv.spmv_ell.launches
        x, st = halo_mg_pcg(h, hc, torch.as_tensor(s["b"]).to(dev, torch.float32), tol=1e-6,
                            max_iters=400, chunk=8)
        out[dev] = (x.cpu().numpy().astype(np.float64), st, spmv.spmv_ell.launches - before)
    (xc, sc, lc), (xg, sg, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg > 0
    assert sc.rel_residual < 1e-5 and sg.rel_residual < 1e-5
    assert np.abs(xg - xc).max() / np.abs(xc).max() <= 1e-5


# -- the geodesic march (csrc/trace.cu) ----------------------------------------------
# Each march kernel against its plain version on the card: end points equal
# bit for bit (the kernels repeat the plain arithmetic op for op, built with
# -fmad=false; CUDA's division and square root are IEEE in both), exhausted
# counts equal.

MARCH_FORMS = ["field", "field_scalar_time", "field_no_min_step", "compacted", "whitney",
               "exp"]


def _march_mesh(surface):
    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.utils.testing import flat_grid, octa_sphere

    tris, verts = octa_sphere(4) if surface == "sphere" else flat_grid(33)
    return build_mesh(tris, vertices=verts, make_unit_area=surface == "sphere")


def _march_calls(tm, lanes, dev, dtype):
    from meshopticalflow_tpu_torch.kernels import advect, tracing

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)

    t0, p0, field = t(lanes["t0"], torch.int64), t(lanes["p0"]), t(lanes["field"])
    times = t(lanes["times"])
    return {
        "field": (tracing.flow_field_trace, tracing.flow_field_trace_plain,
                  (tm, field, times, t0, p0, 1e-2, 4096, 0.0, True)),
        "field_scalar_time": (tracing.flow_field_trace, tracing.flow_field_trace_plain,
                              (tm, field, -0.7, t0, p0, 1e-2, 7, 0.0, True)),
        "field_no_min_step": (tracing.flow_field_trace, tracing.flow_field_trace_plain,
                              (tm, field, times, t0, p0, 0.0, 4096, 0.0, True)),
        "compacted": (advect.flow_field_trace_compacted,
                      advect.flow_field_trace_compacted_plain,
                      (tm, field, times, t0, p0, 1e-2, 16, 2)),
        "whitney": (tracing.whitney_flow_trace, tracing.whitney_flow_trace_plain,
                    (tm, t(lanes["ce"]), times, t0, p0, 1e-2, 4096, 0.0, True)),
        "exp": (tracing.exp_map, tracing.exp_map_plain,
                (tm, t0, p0, t(lanes["v"]), 1024, 0.0, True)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("surface", ["sphere", "flat"])
@pytest.mark.parametrize("form", MARCH_FORMS)
def test_cuda_march_matches_plain(form, surface, dtype):
    _require_card()
    from meshopticalflow_tpu_torch.kernels import tracing
    from meshopticalflow_tpu_torch.utils.testing import march_lanes

    mesh = _march_mesh(surface)
    tm = tracing.make_trace_mesh(mesh, dtype, "cuda")
    lanes = march_lanes(mesh.opp, 20000, seed=5)
    wrapper, plain, args = _march_calls(tm, lanes, "cuda", dtype)[form]
    tracing.reset_counts()
    got = wrapper(*args)
    counts = tracing.counts()
    assert counts["by_wrapper"][wrapper.__name__] == 1 and counts["plain_on_cuda"] == 0
    ref = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    assert got[2] == ref[2]
    kernel = "exp_map" if form == "exp" else "march_whitney" if form == "whitney" \
        else "march_field"
    stats = tracing.last_stats(kernel)
    assert stats["lanes"] == 20000 and stats["exhausted"] == got[2]
    assert 0 < stats["max_lane_steps"] <= stats["lane_steps"] <= stats["warp_slots"]
    assert stats["warp_slots"] % 32 == 0


@pytest.mark.gpu
@pytest.mark.parametrize("form", MARCH_FORMS)
def test_cuda_march_no_lanes(form):
    _require_card()
    from meshopticalflow_tpu_torch.kernels import tracing
    from meshopticalflow_tpu_torch.utils.testing import march_lanes

    mesh = _march_mesh("flat")
    tm = tracing.make_trace_mesh(mesh, torch.float32, "cuda")
    lanes = {k: v[:0] if k in ("t0", "p0", "times", "v") else v
             for k, v in march_lanes(mesh.opp, 10).items()}
    wrapper, _, args = _march_calls(tm, lanes, "cuda", torch.float32)[form]
    tracing.reset_counts()
    out = wrapper(*args)
    assert out[0].shape == (0,) and out[1].shape == (0, 2) and out[2] == 0
    assert all(tracing.counts()[k] == 0 for k in tracing.KERNELS)
    kernel = "exp_map" if form == "exp" else "march_whitney" if form == "whitney" \
        else "march_field"
    assert tracing.last_stats(kernel) == dict(lanes=0, exhausted=0, lane_steps=0,
                                              max_lane_steps=0, warp_slots=0)


@pytest.mark.gpu
def test_cuda_march_noncontiguous_points():
    _require_card()
    from meshopticalflow_tpu_torch.kernels import tracing
    from meshopticalflow_tpu_torch.utils.testing import march_lanes

    mesh = _march_mesh("sphere")
    tm = tracing.make_trace_mesh(mesh, torch.float32, "cuda")
    lanes = march_lanes(mesh.opp, 4000)
    field = torch.as_tensor(lanes["field"]).float().cuda()
    t0 = torch.as_tensor(lanes["t0"]).cuda()
    wide = torch.zeros((4000, 4), dtype=torch.float32, device="cuda")
    wide[:, 1:3] = torch.as_tensor(lanes["p0"]).float()
    p0 = wide[:, 1:3]
    assert not p0.is_contiguous()
    got = tracing.flow_field_trace(tm, field, 0.5, t0, p0, 1e-2)
    ref = tracing.flow_field_trace_plain(tm, field, 0.5, t0, p0.contiguous(), 1e-2)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["field", "t_idx", "mesh"])
def test_cuda_march_refuses_mixed_devices(operand):
    _require_card()
    from meshopticalflow_tpu_torch.kernels import tracing
    from meshopticalflow_tpu_torch.utils.testing import march_lanes

    mesh = _march_mesh("flat")
    lanes = march_lanes(mesh.opp, 100)
    tm = tracing.make_trace_mesh(mesh, torch.float32, "cpu" if operand == "mesh" else "cuda")
    field = torch.as_tensor(lanes["field"]).float()
    t0 = torch.as_tensor(lanes["t0"])
    p0 = torch.as_tensor(lanes["p0"]).float().cuda()
    if operand != "field":
        field = field.cuda()
    if operand != "t_idx":
        t0 = t0.cuda()
    with pytest.raises(ValueError, match="different devices"):
        tracing.flow_field_trace(tm, field, 0.5, t0, p0, 1e-2)


# -- the march kernels at the edges of their launch: lane lengths, lane counts -------
# A warp whose lanes end after 1 step or at the budget, lane counts that are
# no multiple of a warp or of a resident grid, and far more lanes than
# resident threads must all equal the plain march lane for lane, with its
# exhausted count, lane-steps and longest lane; the warp-step slots count
# 32 a warp iteration.

def _plain_steps(tm, field, ce, times, t0, p0, min_step, budget):
    """The plain march's steps a lane (tracing._flow_step until the lane
    stops or has taken ``budget`` steps): (t, p, exhausted, steps (N,))."""
    from meshopticalflow_tpu_torch.kernels import tracing

    tab = tracing._tables(tm, field, ce)
    state = tracing._flow_init(tab, times, t0, p0, min_step)
    steps = torch.zeros(t0.shape[0], dtype=torch.int64, device=t0.device)
    for _ in range(budget):
        if not bool(state["active"].any()):
            break
        steps += state["active"].to(torch.int64)
        state = tracing._flow_step(state, tab, min_step, 0.0)
    t1, p1 = tracing._finish(state, t0, p0)
    return t1, p1, int(state["active"].sum()), steps


def _unequal_lanes(mesh, n, dtype, seed=11):
    """Lanes alternating, within every warp, flow times that end in one step
    (1e-7) and times no budget reaches (1e6 on the closed sphere, marched
    without re-reading the field, so no reversal stops them), with inactive
    lanes (t = -1) among them."""
    from meshopticalflow_tpu_torch.utils.testing import march_lanes

    lanes = march_lanes(mesh.opp, n, seed=seed)
    times = np.where(np.arange(n) % 2 == 0, 1e-7, 1e6) * np.sign(lanes["times"])
    dev = "cuda"
    return (torch.as_tensor(lanes["t0"]).to(dev),
            torch.as_tensor(lanes["p0"]).to(device=dev, dtype=dtype),
            torch.as_tensor(times).to(device=dev, dtype=dtype),
            torch.as_tensor(lanes["field"]).to(device=dev, dtype=dtype),
            torch.as_tensor(lanes["ce"]).to(device=dev, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["field", "whitney"])
def test_cuda_march_unequal_lanes_in_one_warp(form, dtype):
    _require_card()
    from meshopticalflow_tpu_torch.kernels import tracing

    mesh = _march_mesh("sphere")
    tm = tracing.make_trace_mesh(mesh, dtype, "cuda")
    t0, p0, times, field, ce = _unequal_lanes(mesh, 4992, dtype)
    budget = 300
    kw = dict(vfield=field) if form == "field" else dict(ce=ce)
    got = tracing.march(tm, times, t0, p0, 0.0, budget, **kw)
    stats = tracing.last_stats("march_field" if form == "field" else "march_whitney")
    ref_t, ref_p, ref_exhausted, ref_steps = _plain_steps(
        tm, field if form == "field" else None, ce if form == "whitney" else None, times,
        t0, p0, 0.0, budget)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref_t) and torch.equal(got[1], ref_p)
    assert stats["exhausted"] == ref_exhausted > 0
    assert stats["lane_steps"] == int(ref_steps.sum())
    assert stats["max_lane_steps"] == int(ref_steps.max()) == budget
    warps = ref_steps.reshape(-1, 32)          # each warp's first 32 lanes
    assert bool(((warps == 1).any(dim=1) & (warps == budget).any(dim=1)).any())
    assert stats["lane_steps"] <= stats["warp_slots"] and stats["warp_slots"] % 32 == 0


def _resident_threads():
    return torch.cuda.get_device_properties(0).multi_processor_count * 2048


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 4099, "resident+7", "3*resident+5"])
def test_cuda_march_lane_counts(lanes):
    _require_card()
    from meshopticalflow_tpu_torch.kernels import tracing
    from meshopticalflow_tpu_torch.utils.testing import march_lanes

    n = {"resident+7": _resident_threads() + 7,
         "3*resident+5": 3 * _resident_threads() + 5}.get(lanes, lanes)
    mesh = _march_mesh("flat")
    tm = tracing.make_trace_mesh(mesh, torch.float32, "cuda")
    lanes_np = march_lanes(mesh.opp, n, seed=13)
    t0 = torch.as_tensor(lanes_np["t0"]).cuda()
    p0 = torch.as_tensor(lanes_np["p0"]).float().cuda()
    times = torch.as_tensor(lanes_np["times"]).float().cuda()
    field = torch.as_tensor(lanes_np["field"]).float().cuda()
    got = tracing.march(tm, times, t0, p0, 1e-2, 4096, vfield=field)
    stats = tracing.last_stats("march_field")
    ref_t, ref_p, ref_exhausted, ref_steps = _plain_steps(tm, field, None, times, t0, p0,
                                                          1e-2, 4096)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref_t) and torch.equal(got[1], ref_p)
    assert stats["lanes"] == n and stats["exhausted"] == ref_exhausted
    assert stats["lane_steps"] == int(ref_steps.sum())
    assert stats["max_lane_steps"] == int(ref_steps.max())
    assert stats["lane_steps"] <= stats["warp_slots"] and stats["warp_slots"] % 32 == 0


# -- the banded Cholesky kernels (csrc/banded.cu) ---------------------------------

# (m, nb, bw, k): bw == S (the smoothing c1's band, the flow c1's), bw > S
# (k capped at 8, the window shifts by S a panel), and m % k != 0; nb 128,
# the block of every band layout the port builds
BANDED_SHAPES = {"bw_eq_S": (97, 128, 256, 2), "flow_c1": (288, 128, 768, 6),
                 "bw_gt_S": (37, 128, 1152, 8)}
# max |kernel - twin| / max |twin|: the two sum in other orders (cuBLAS,
# cuSOLVER against the kernels' fixed orders)
BANDED_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _band_blocks(shape, dtype, indefinite=False):
    from meshopticalflow_tpu_torch.utils.testing import band_test_blocks

    m, nb, bw, _ = BANDED_SHAPES[shape]
    return torch.as_tensor(band_test_blocks(m, nb, bw, seed=m, indefinite=indefinite)) \
        .to(device="cuda", dtype=dtype)


def _rel_err(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", list(BANDED_SHAPES))
def test_cuda_band_factor_matches_plain(shape, dtype):
    _require_card()
    from meshopticalflow_tpu_torch.kernels import banded as kb

    _, nb, bw, _ = BANDED_SHAPES[shape]
    s = _band_blocks(shape, dtype)
    before, plain_before = kb.band_factor.launches, kb.counts()["plain_on_cuda"]
    l_k, ok_k = kb.band_factor(s, 0.0, nb, bw)
    torch.cuda.synchronize()
    assert kb.band_factor.launches == before + 1
    assert kb.counts()["plain_on_cuda"] == plain_before
    l_p, ok_p = kb.band_cholesky_plain(s, 0.0, nb, bw)
    assert ok_k.device.type == "cuda" and bool(ok_k) and bool(ok_p)
    assert l_k.dtype == dtype and l_k.shape == s.shape
    assert _rel_err(l_k, l_p) <= BANDED_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 4, 6, 8, 32])
@pytest.mark.parametrize("panels,rhs", [(torch.float32, torch.float32),
                                        (torch.float64, torch.float64),
                                        (torch.bfloat16, torch.float32),
                                        (torch.bfloat16, torch.float64)])
@pytest.mark.parametrize("shape", ["bw_eq_S", "bw_gt_S"])
def test_cuda_panel_sweep_matches_plain(shape, panels, rhs, c):
    """Both sweeps, each from the same input as its twin; bf16 panels widened
    into the rhs type as the twin widens them."""
    _require_card()
    from meshopticalflow_tpu_torch.kernels import banded as kb
    from meshopticalflow_tpu_torch.solvers.banded import build_solve_panels

    _, nb, bw, k = BANDED_SHAPES[shape]
    l_blocks, _ = kb.band_cholesky_plain(_band_blocks(shape, torch.float64), 0.0, nb, bw)
    dinv, pbelow = (t.to(panels) for t in build_solve_panels(l_blocks, k))
    mp, s, _ = dinv.shape
    assert (bw > s) == (shape == "bw_gt_S")
    b = torch.as_tensor(np.random.default_rng(c).standard_normal((mp, s, c))) \
        .to(device="cuda", dtype=rhs)
    for upper, plain in ((False, kb.panel_lower_solve_plain), (True, kb.panel_upper_solve_plain)):
        before = kb.panel_sweep.launches
        out = kb.panel_sweep(dinv, pbelow, b, upper)
        torch.cuda.synchronize()
        assert kb.panel_sweep.launches == before + 1
        ref = plain(dinv, pbelow, b)
        assert out.dtype == rhs and out.shape == b.shape
        assert _rel_err(out, ref) <= BANDED_TOL[rhs], upper


@pytest.mark.gpu
def test_cuda_banded_runs_agree_bit_for_bit():
    _require_card()
    from meshopticalflow_tpu_torch.kernels import banded as kb
    from meshopticalflow_tpu_torch.solvers.banded import build_solve_panels

    _, nb, bw, k = BANDED_SHAPES["flow_c1"]
    s = _band_blocks("flow_c1", torch.float32)
    (l1, ok1), (l2, ok2) = kb.band_factor(s, 0.0, nb, bw), kb.band_factor(s, 0.0, nb, bw)
    assert torch.equal(l1, l2) and bool(ok1) and bool(ok2)
    dinv, pbelow = build_solve_panels(l1, k)
    b = torch.randn((dinv.shape[0], dinv.shape[1], 4), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    for upper in (False, True):
        assert torch.equal(kb.panel_sweep(dinv, pbelow, b, upper),
                           kb.panel_sweep(dinv, pbelow, b, upper))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_band_factor_breakdown_then_shift(dtype):
    """An indefinite system: the ok flag goes false on the device and the
    factor holds the twin's stand-ins (identity, zero) from the bad step on;
    the shift ladder's next rungs (solvers/banded.py:BandedCholeskySolver)
    factor it, as the twin does."""
    _require_card()
    from meshopticalflow_tpu_torch.kernels import banded as kb

    m, nb, bw, _ = BANDED_SHAPES["bw_eq_S"]
    s = _band_blocks("bw_eq_S", dtype, indefinite=True)
    l_k, ok_k = kb.band_factor(s, 0.0, nb, bw)
    l_p, ok_p = kb.band_cholesky_plain(s, 0.0, nb, bw)
    assert ok_k.device.type == "cuda" and not bool(ok_k) and not bool(ok_p)
    assert bool(torch.isfinite(l_k).all())
    bad = m // 2
    assert torch.equal(l_k[bad, :nb], torch.eye(nb, dtype=dtype, device="cuda"))
    assert not l_k[bad, nb:].any()
    assert _rel_err(l_k[:bad], l_p[:bad]) <= BANDED_TOL[dtype]
    dmax = float(s.abs().max())
    for rel in (1e-6, 1e-4, 1e-2, 1.0, 4.0):
        l_k, ok_k = kb.band_factor(s, rel * dmax, nb, bw)
        l_p, ok_p = kb.band_cholesky_plain(s, rel * dmax, nb, bw)
        assert bool(ok_k) == bool(ok_p)
        if bool(ok_k):
            break
    assert bool(ok_k) and rel == 1.0
    assert _rel_err(l_k, l_p) <= BANDED_TOL[dtype]


@pytest.mark.gpu
def test_cuda_banded_wrappers_refuse():
    """No twin on the card: mixed devices, a non-contiguous operand, c > 32
    and mismatched panel types raise, and nothing launches."""
    _require_card()
    from meshopticalflow_tpu_torch.kernels import banded as kb

    dev = "cuda"
    dinv = torch.zeros((3, 64, 64), device=dev)
    pbelow = torch.zeros((3, 64, 64), device=dev)
    b = torch.zeros((3, 64, 2), device=dev)
    before = (kb.panel_sweep.launches, kb.counts()["plain_on_cuda"])
    with pytest.raises(ValueError):
        kb.panel_sweep(dinv, pbelow.cpu(), b, False)
    with pytest.raises(ValueError):
        kb.panel_sweep(dinv.transpose(1, 2), pbelow, b, False)
    with pytest.raises(ValueError):
        kb.panel_sweep(dinv, pbelow, torch.zeros((3, 64, 33), device=dev), True)
    with pytest.raises(TypeError):
        kb.panel_sweep(dinv, pbelow.double(), b, True)
    with pytest.raises(ValueError):
        kb.band_factor(torch.zeros((4, 256, 128), device=dev).transpose(1, 2).contiguous()
                       .transpose(1, 2), 0.0, 128, 128)
    assert (kb.panel_sweep.launches, kb.counts()["plain_on_cuda"]) == before


# -- the texture bake (kernels/bake.py, csrc/bake.cu) ----------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bake_mesh():
    """The main path's mesh: 393,216 triangles on the cube root."""
    _require_card()
    from meshopticalflow_tpu_torch.utils.testing import main_path_mesh

    tris, uvs = main_path_mesh(os.path.join(REPO, "tests", "golden", "cube.ply"))
    assert len(tris) == 393216
    return tris, uvs


@pytest.mark.gpu
@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("size", [2048, 4096])
def test_cuda_bake_matches_host_copy(bake_mesh, size, bilinear):
    """The kernel equals the host copy (flow/pipeline.py:
    sample_texture_to_vertices) and the plain twin bit for bit, one launch
    for both textures."""
    _require_card()
    from meshopticalflow_tpu_torch.flow.pipeline import sample_texture_to_vertices
    from meshopticalflow_tpu_torch.kernels import bake

    tris, uvs = bake_mesh
    n_vertices = int(tris.max()) + 1
    textures = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    wedges, offsets = bake.wedge_table(tris, n_vertices, "cuda")
    tex = torch.from_numpy(textures).cuda()
    uv = torch.from_numpy(uvs.reshape(-1, 2)).cuda()
    before, twin_before = bake.bake_vertices.launches, bake.bake_vertices_plain.cuda_calls
    got = bake.bake_vertices(tex, uv, wedges, offsets, bilinear)
    torch.cuda.synchronize()
    assert bake.bake_vertices.launches == before + 1
    assert bake.bake_vertices_plain.cuda_calls == twin_before
    host = np.stack([sample_texture_to_vertices(tris, uvs, t, n_vertices, bilinear)
                     for t in textures])
    assert got.shape == (2, n_vertices, 3) and got.dtype == torch.float64
    assert np.array_equal(got.cpu().numpy(), host)
    twin = bake.bake_vertices_plain(tex, uv, wedges, offsets, bilinear)
    assert torch.equal(got, twin)


def _golden_pair(tmp_path, monkeypatch, flip=False):
    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "artifacts"))
    gold = os.path.join(REPO, "tests", "golden")
    paths = [os.path.join(gold, "mA.png"), os.path.join(gold, "mB.png")]
    return os.path.join(gold, "cube.ply"), tuple(paths[::-1] if flip else paths)


@pytest.mark.gpu
def test_cuda_bake_launches_once_per_construction(tmp_path, monkeypatch):
    _require_card()
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.kernels import bake

    mesh, paths = _golden_pair(tmp_path, monkeypatch)
    cfg = FlowConfig(subdivide_edge_length=0.06, levels=1, artifact_cache=False)
    before, twin_before = bake.bake_vertices.launches, bake.bake_vertices_plain.cuda_calls
    for k in (1, 2):
        FlowProblem.from_texture_inputs(mesh, paths, cfg, device="cuda")
        assert bake.bake_vertices.launches == before + k
    assert bake.bake_vertices_plain.cuda_calls == twin_before


@pytest.mark.gpu
def test_cuda_bake_frees_its_buffers(tmp_path, monkeypatch):
    """After a construction whose bake runs on the card, no buffer of the
    bake is left: its uploads and its output are gone when
    from_texture_inputs returns, and the memory the process holds once the
    problem is dropped grew by the device cache's new entries alone (the
    pair's textures and signals; the wedge table came with the first pair)."""
    _require_card()
    import gc
    import weakref

    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.kernels import bake
    from meshopticalflow_tpu_torch.utils import devcache

    cfg = FlowConfig(subdivide_edge_length=0.06, levels=1)
    devcache.clear()
    mesh, paths = _golden_pair(tmp_path, monkeypatch)
    FlowProblem.from_texture_inputs(mesh, paths, cfg, device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    held, cached = torch.cuda.memory_allocated(), devcache.total_bytes()

    refs = []
    shipped = bake.bake_vertices

    def spy(textures, uvs, wedges, offsets, bilinear=True):
        out = shipped(textures, uvs, wedges, offsets, bilinear)
        refs.extend(weakref.ref(t) for t in (textures, uvs, out))
        return out

    monkeypatch.setattr(bake, "bake_vertices", spy)
    mesh, paths = _golden_pair(tmp_path, monkeypatch, flip=True)   # a pair not baked yet
    prob = FlowProblem.from_texture_inputs(mesh, paths, cfg, device="cuda")
    assert len(refs) == 3 and all(r() is None for r in refs)
    del prob
    gc.collect()
    torch.cuda.synchronize()
    grown, new_entries = torch.cuda.memory_allocated() - held, devcache.total_bytes() - cached
    assert new_entries > 0
    # the allocator rounds each block up to 512 bytes; any bake buffer here
    # is over 64 KB
    assert abs(grown - new_entries) <= 16 * 1024, (grown, new_entries)
    devcache.clear()

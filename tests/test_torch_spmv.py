"""Padded-ELL SpMV of the PyTorch port against the reference package.

The port's wrappers take their plain PyTorch versions on CPU tensors; those
are held here against the Pallas kernels they replace (interpret mode,
through pack_pattern / to_tiles / from_tiles), square and rectangular, and
against ell_matvec.
The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.kernels.pallas_spmv import (
    PallasEll, from_tiles, from_tiles_multi, pack_pattern, to_tiles, to_tiles_multi)
from meshopticalflow_tpu.ops.ell import ell_matvec as jax_ell_matvec
from meshopticalflow_tpu_torch.kernels import spmv
from meshopticalflow_tpu_torch.ops.ell import ell_matvec

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)

# Tolerance of the Pallas kernel against scipy (tests/test_pallas.py:37):
# f32 products differ only by summation order.
F32_TOL = dict(rtol=2e-5, atol=1e-4)


def _random_ell(n, w, seed):
    """Random padded-ELL operator with distinct columns in every row (so a
    tile scatter never folds two entries into one value)."""
    rng = np.random.default_rng(seed)
    cols = np.argsort(rng.random((n, n)), axis=1)[:, :w].astype(np.int32)
    vals = rng.standard_normal((n, w))
    return rng, cols, vals


def _pallas_apply(cols, vals, x, dtype=jnp.float32, seed=0):
    """y = A x through the Pallas block-ELL kernel in interpret mode."""
    n = cols.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    pat = pack_pattern(cols, perm)
    op = PallasEll.from_ell_values(pat, jnp.asarray(pat.slots),
                                   jnp.asarray(vals, jnp.float32), dtype=dtype,
                                   interpret=True)
    perm_d = jnp.asarray(perm, jnp.int32)
    inv = jnp.asarray(np.argsort(perm), jnp.int32)
    if x.ndim == 1:
        y_t = op.apply(to_tiles(jnp.asarray(x, jnp.float32), perm_d, pat.nr))
        return np.asarray(from_tiles(y_t, inv, n))
    c = x.shape[1]
    y_t = op.apply_multi(to_tiles_multi(jnp.asarray(x, jnp.float32), perm_d, pat.nr))
    return np.asarray(from_tiles_multi(y_t, inv, n, c))


def _t(a, dtype):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("n,w", [(300, 7), (517, 9)])
def test_spmv_ell_plain_matches_pallas_f32(n, w):
    rng, cols, vals = _random_ell(n, w, seed=n)
    x = rng.standard_normal(n)
    before = spmv.spmv_ell.launches
    y = spmv.spmv_ell(_t(cols, torch.int32), _t(vals, torch.float32),
                      _t(x, torch.float32))
    assert y.dtype == torch.float32
    assert spmv.spmv_ell.launches == before      # CPU tensors: plain version
    np.testing.assert_allclose(y.numpy(), _pallas_apply(cols, vals, x), **F32_TOL)


@pytest.mark.parametrize("c", [6, 8])
def test_spmv_ell_multi_plain_matches_pallas_f32(c):
    rng, cols, vals = _random_ell(300, 9, seed=c)
    x = rng.standard_normal((300, c))
    y = spmv.spmv_ell_multi(_t(cols, torch.int32), _t(vals, torch.float32),
                            _t(x, torch.float32))
    np.testing.assert_allclose(y.numpy(), _pallas_apply(cols, vals, x), **F32_TOL)


@pytest.mark.parametrize("c", [0, 6])
def test_bf16_values_match_pallas(c):
    """bf16 values, f32 x and accumulation on both sides. Both see the same
    bf16-rounded values, so they differ only by summation order."""
    rng, cols, vals = _random_ell(300, 9, seed=11 + c)
    vals_bf = _t(vals, torch.float32).to(torch.bfloat16)
    rounded = vals_bf.to(torch.float32).numpy()
    x = rng.standard_normal((300, c) if c else 300)
    fn = spmv.spmv_ell_multi if c else spmv.spmv_ell
    y = fn(_t(cols, torch.int32), vals_bf, _t(x, torch.float32))
    assert y.dtype == torch.float32
    ref = _pallas_apply(cols, rounded, x, dtype=jnp.bfloat16)
    np.testing.assert_allclose(y.numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("c", [0, 3, 12])
def test_f64_matches_reference_ell_matvec(c):
    """float64 products through ell_matvec (12 columns run as 8 + 4)."""
    rng, cols, vals = _random_ell(400, 9, seed=21 + c)
    x = rng.standard_normal((400, c) if c else 400)
    y = ell_matvec(_t(cols, torch.int32), _t(vals, torch.float64),
                   _t(x, torch.float64))
    ref = np.asarray(jax_ell_matvec(jnp.asarray(cols), jnp.asarray(vals),
                                    jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-12)


def _pallas_apply_rect(cols, vals, x, n_in, dtype=jnp.float32, seed=0):
    """Rectangular y = A x through the Pallas kernel in interpret mode, with
    independent row and column permutations (tests/test_pallas.py:40-54)."""
    rng = np.random.default_rng(seed)
    n_out = cols.shape[0]
    row_perm, col_perm = rng.permutation(n_out), rng.permutation(n_in)
    pat = pack_pattern(cols, row_perm, col_perm=col_perm, col_n=n_in)
    op = PallasEll.from_ell_values(pat, jnp.asarray(pat.slots),
                                   jnp.asarray(vals, jnp.float32), dtype=dtype,
                                   interpret=True)
    inv = jnp.asarray(np.argsort(row_perm), jnp.int32)
    cp = jnp.asarray(col_perm, jnp.int32)
    if x.ndim == 1:
        y_t = op.apply(to_tiles(jnp.asarray(x, jnp.float32), cp, pat.col_nr))
        return np.asarray(from_tiles(y_t, inv, n_out))
    y_t = op.apply_multi(to_tiles_multi(jnp.asarray(x, jnp.float32), cp, pat.col_nr))
    return np.asarray(from_tiles_multi(y_t, inv, n_out, x.shape[1]))


@pytest.mark.parametrize("n_out,n_in,w,c", [(300, 150, 4, 0), (150, 300, 11, 0),
                                            (300, 150, 4, 6), (150, 300, 11, 8)])
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_rectangular_matches_pallas(n_out, n_in, w, c, vdtype):
    """Rectangular operators (the MG transfers P0 (fine <- coarse) and P0^T)
    through the single and multi-column wrappers, f32 and bf16 values."""
    rng = np.random.default_rng(n_out + w + c)
    cols = np.stack([rng.choice(n_in, w, replace=False) for _ in range(n_out)]).astype(np.int32)
    vals = rng.standard_normal((n_out, w))
    vt = _t(vals, torch.float32)
    if vdtype == "bfloat16":
        vt = vt.to(torch.bfloat16)
        vals = vt.to(torch.float32).numpy()
    x = rng.standard_normal((n_in, c) if c else n_in)
    spmv.check_columns(cols, n_in)
    fn = spmv.spmv_ell_multi if c else spmv.spmv_ell
    y = fn(_t(cols, torch.int32), vt, _t(x, torch.float32))
    assert y.shape == ((n_out, c) if c else (n_out,)) and y.dtype == torch.float32
    ref = _pallas_apply_rect(cols, vals, x, n_in,
                             dtype=jnp.bfloat16 if vdtype == "bfloat16" else jnp.float32)
    np.testing.assert_allclose(y.numpy(), ref, **F32_TOL)


def test_check_columns_refuses_out_of_range():
    cols = np.array([[0, 3], [2, 1]], np.int32)
    spmv.check_columns(cols, 4)
    spmv.check_columns(torch.as_tensor(cols), 4)
    for bad in (3, 2):
        with pytest.raises(ValueError):
            spmv.check_columns(cols, bad)
    with pytest.raises(ValueError):
        spmv.check_columns(-cols - 1, 4)


def _operands():
    _, cols, vals = _random_ell(16, 3, seed=5)
    return (_t(cols, torch.int32), _t(vals, torch.float32),
            torch.ones(16, dtype=torch.float32))


@pytest.mark.parametrize("case,exc", [
    ("cols_int64", TypeError),
    ("vals_float16", TypeError),
    ("x_dtype_mismatch", TypeError),
    ("bf16_with_bf16_x", TypeError),
    ("vals_shape", ValueError),
    ("x_length", ValueError),
    ("x_not_contiguous", ValueError),
    ("multi_too_wide", ValueError),
    ("multi_x_1d", ValueError),
])
def test_wrapper_rejects_bad_operands(case, exc):
    cols, vals, x = _operands()
    fn = spmv.spmv_ell
    if case == "cols_int64":
        cols = cols.to(torch.int64)
    elif case == "vals_float16":
        vals = vals.to(torch.float16)
    elif case == "x_dtype_mismatch":
        x = x.to(torch.float64)
    elif case == "bf16_with_bf16_x":
        vals, x = vals.to(torch.bfloat16), x.to(torch.bfloat16)
    elif case == "vals_shape":
        vals = vals[:, :2].contiguous()
    elif case == "x_length":
        x = x[:0]           # no rows at all for a non-empty operator
    elif case == "x_not_contiguous":
        fn = spmv.spmv_ell_multi
        x = torch.ones((2, 16), dtype=torch.float32).t()
    elif case == "multi_too_wide":
        fn = spmv.spmv_ell_multi
        x = torch.ones((16, 9), dtype=torch.float32)
    elif case == "multi_x_1d":
        fn = spmv.spmv_ell_multi
    with pytest.raises(exc):
        fn(cols, vals, x)


# The launch plan of the CUDA kernels (kernels/spmv.py:launch_plan), checked
# on the host: the kernels themselves run only on the card.

PLAN_CASES = [(589824, 9, 1, 4), (589824, 9, 1, 2), (589824, 9, 1, 8), (36864, 13, 1, 4),
              (589824, 3, 1, 2), (196610, 9, 6, 4), (196610, 9, 6, 2), (196610, 9, 6, 8),
              (196610, 3, 6, 2), (1, 1, 1, 4), (7, 16, 8, 8), (255, 9, 1, 4),
              (257, 9, 1, 2), (132 * 8 * 256 + 1, 9, 1, 4), (1000, 5, 3, 2)]


def _slab_schedule(plan, n):
    """Rows each CTA of the persistent slab kernel computes, as
    csrc/spmv_ell.cu:spmv_slab_kernel walks them: CTA b takes slabs b,
    b + grid, ...; full slabs through the ring, the partial last one from
    global memory."""
    n_slabs = -(-n // plan.rows)
    for b in range(plan.grid):
        for s in range(b, n_slabs, plan.grid):
            yield s, range(s * plan.rows, min((s + 1) * plan.rows, n))


@pytest.mark.parametrize("ctas_per_sm", [1, 3, 8])
@pytest.mark.parametrize("n,w,c,vs", PLAN_CASES)
def test_slab_schedule_covers_every_row_once(n, w, c, vs, ctas_per_sm):
    plan = spmv.launch_plan(n, w, c, vs, lambda v, t, s: ctas_per_sm)
    assert plan.variant == "slab"
    hits = np.zeros(n, np.int64)
    for _, rows in _slab_schedule(plan, n):
        hits[rows.start:rows.stop] += 1
    assert (hits == 1).all()
    assert 1 <= plan.grid <= ctas_per_sm * spmv.SMS


@pytest.mark.parametrize("n,w,c,vs", PLAN_CASES)
def test_slab_copies_are_16_byte_multiples(n, w, c, vs):
    """Every full slab's offset and byte count, in cols and in vals, is a
    multiple of 16 (the bulk copy's rule), bf16 with odd W included, and the
    ring fits the CTA's shared memory."""
    plan = spmv.launch_plan(n, w, c, vs)
    per_pass = plan.threads // spmv.row_lanes(c, spmv.x_elem_size(vs))
    assert plan.rows % 8 == 0 and 8 <= plan.rows and plan.rows % (per_pass // 8 * 8) == 0
    n_full = n // plan.rows
    for s, _ in _slab_schedule(plan, n):
        if s < n_full:
            for size in (4, vs):
                assert (s * plan.rows * w * size) % 16 == 0
                assert (plan.rows * w * size) % 16 == 0
    assert plan.smem == plan.stages * plan.rows * w * (4 + vs) <= spmv.SMEM_PER_CTA


@pytest.mark.parametrize("w", [0, 1, 3, 9, 13, 16, 17, 40, 49, 64, 65, 69, 128, 129, 300])
@pytest.mark.parametrize("vs", [2, 4, 8])
def test_variant_follows_width(w, vs):
    """Slab rows up to SLAB_MAX_WIDTH slots; past it G lanes per row, at most
    8 slots a lane, and the group grid covers every row."""
    n = 36864
    plan = spmv.launch_plan(n, w, 6, vs, lambda v, t, s: 2)
    if 1 <= w <= spmv.SLAB_MAX_WIDTH:
        assert plan.variant == "slab" and plan.group == 0
    else:
        assert plan.variant == "group" and plan.rows == 0 and plan.smem == 0
        assert plan.group in (4, 8, 16, 32) and -(-w // plan.group) <= max(8, -(-w // 32))
        assert plan.threads % plan.group == 0
        # the persistent row blocks (csrc/spmv_ell.cu:spmv_group_kernel)
        per_cta = plan.threads // plan.group
        hits = np.zeros(n, np.int64)
        for b in range(plan.grid):
            for base in range(b * per_cta, n, plan.grid * per_cta):
                hits[base:base + per_cta] += 1
        assert (hits == 1).all() and plan.grid <= 2 * spmv.SMS


def test_launch_plan_refuses_bad_columns():
    for c in (0, 9):
        with pytest.raises(ValueError):
            spmv.launch_plan(100, 9, c, 4)


@pytest.mark.parametrize("c,elem,want", [(1, 4, 4), (2, 4, 8), (3, 4, 4), (4, 4, 16),
                                         (6, 4, 8), (8, 4, 16), (1, 8, 8), (3, 8, 8),
                                         (6, 8, 16)])
def test_vector_bytes(c, elem, want):
    assert spmv.vector_bytes(c, elem) == want

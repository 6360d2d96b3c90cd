"""Padded-ELL SpMV of the PyTorch port against the reference package.

The port's wrappers take their plain PyTorch versions on CPU tensors; those
are held here against the Pallas kernels they replace (interpret mode,
through pack_pattern / to_tiles / from_tiles) and against ell_matvec.
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
        x = x[:15]
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

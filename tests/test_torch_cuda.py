"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
elsewhere. The file imports neither jax nor the reference package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

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


def _operands(n, w, c, dtype, seed=3):
    rng = np.random.default_rng(seed)
    cols = torch.from_numpy((np.arange(n)[:, None]
                             + rng.integers(-300, 300, (n, w))) % n).to(torch.int32)
    vals = torch.from_numpy(rng.standard_normal((n, w)))
    x = torch.from_numpy(rng.standard_normal((n, c) if c else n))
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
@pytest.mark.parametrize("name", [p[0] for p in probes.PROBES])
def test_cuda_probe_matches_plain_and_script(name):
    _require_card()
    _, _, kernel, builder = next(p for p in probes.PROBES if p[0] == name)
    before = kernel.launches
    res = probes.run_probe(kernel, builder, torch.device("cuda"))
    assert kernel.launches == before + 1
    assert res["correct"] and res["matches_plain"], res

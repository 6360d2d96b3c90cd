"""The banded Cholesky's device loops: kernels of csrc/banded.cu and their
plain PyTorch twins.

The reference package runs them as ``lax.scan``s with no Pallas kernel
(meshopticalflow_tpu/solvers/banded.py: band_cholesky, panel_lower_solve,
panel_upper_solve). Here:

  * ``panel_sweep(dinv, pbelow, rhs, upper)``: L y = rhs (lower) or
    L^T x = y (upper) on the solve panels of solvers/banded.py:
    build_solve_panels, dinv (mp, S, S), pbelow (mp, bw, S), rhs (mp, S, c),
    1 <= c <= 32, in the type pairs the port makes (``SWEEP_TYPES``): panels
    and rhs of one type, float32 or float64, or bfloat16 panels
    (``mg_c1_bf16``) widened in registers to a float32 or float64 rhs;
  * ``band_factor(s_blocks, shift, nb, bw)``: the blocked banded Cholesky of
    the (m, nb+bw, nb) band blocks, float32 or float64, nb 128 (the block of
    every band layout the port builds); returns the factor blocks and the
    ok flag as a device bool tensor (never read here).

On CUDA tensors each is one cooperative launch of a persistent grid (or an
error raised: no fallback); on CPU tensors it runs its plain twin
(``panel_lower_solve_plain``, ``panel_upper_solve_plain``,
``band_cholesky_plain``: the loops of one or a few small tensor ops a step
that the port ran before the kernels). Any other mix of devices, types,
shapes or layouts raises before anything launches. Each launch counts into
utils/spans.py's counter table under ``launch.<wrapper>/<form>``;
``<wrapper>.launches`` reads the wrapper's forms. Each twin counts the calls
it gets with CUDA tensors in ``<twin>.cuda_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from meshopticalflow_tpu_torch.kernels.build import CudaLibrary, stream_of
from meshopticalflow_tpu_torch.utils import spans

MAX_COLUMNS = 32
FACTOR_BLOCK = 128                 # band_factor's block size (nb)
_RHS_TAGS = {torch.float32: "f32", torch.float64: "f64"}
_PANEL_TAGS = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# (panel type, rhs type) pairs with a panel_sweep entry point in banded.cu
SWEEP_TYPES = ((torch.float32, torch.float32), (torch.float64, torch.float64),
               (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float64))


# -- the plain twins ------------------------------------------------------------

def _widen(panel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A panel in the rhs dtype (panels may be stored in bfloat16)."""
    return panel if panel.dtype == dtype else panel.to(dtype)


def panel_lower_solve_plain(dinv: torch.Tensor, pbelow: torch.Tensor,
                            rhs_panels: torch.Tensor) -> torch.Tensor:
    """y from L y = rhs on the panel layout; rhs_panels (mp, S, c)."""
    if rhs_panels.is_cuda:
        panel_lower_solve_plain.cuda_calls += 1
    mp, s, _ = dinv.shape
    bw = pbelow.shape[1]
    c = rhs_panels.shape[-1]
    dt = rhs_panels.dtype
    y = torch.empty_like(rhs_panels)
    acc = torch.zeros((bw, c), dtype=dt, device=rhs_panels.device)
    for i in range(mp):
        torch.matmul(_widen(dinv[i], dt), rhs_panels[i] - acc[:s], out=y[i])
        if bw == s:
            acc = _widen(pbelow[i], dt) @ y[i]
        else:
            acc = torch.cat([acc[s:], torch.zeros_like(acc[:s])], dim=0) \
                + _widen(pbelow[i], dt) @ y[i]
    return y


def panel_upper_solve_plain(dinv: torch.Tensor, pbelow: torch.Tensor,
                            y_panels: torch.Tensor) -> torch.Tensor:
    """x from L^T x = y (reverse sweep) on the panel layout."""
    if y_panels.is_cuda:
        panel_upper_solve_plain.cuda_calls += 1
    mp, s, _ = dinv.shape
    bw = pbelow.shape[1]
    c = y_panels.shape[-1]
    dt = y_panels.dtype
    x = torch.empty_like(y_panels)
    xwin = torch.zeros((bw, c), dtype=dt, device=y_panels.device)
    for i in range(mp - 1, -1, -1):
        t = y_panels[i] - _widen(pbelow[i], dt).T @ xwin
        torch.matmul(_widen(dinv[i], dt).T, t, out=x[i])
        xwin = x[i] if bw == s else torch.cat([x[i], xwin[: bw - s]], dim=0)
    return x


def band_cholesky_plain(s_blocks: torch.Tensor, shift, nb: int, bw: int):
    """Blocked banded Cholesky; returns (l_blocks (m, nb+bw, nb), ok flag as
    a device bool tensor, so the caller decides when to read it).

    ``shift`` is ADDED to the diagonal (absolute). A breakdown (a window
    that is not positive definite) surfaces as ok=False; its blocks are
    replaced by finite stand-ins (identity, zero) so the sweep finishes."""
    if s_blocks.is_cuda:
        band_cholesky_plain.cuda_calls += 1
    dtype, device = s_blocks.dtype, s_blocks.device
    m = s_blocks.shape[0]
    eye = torch.eye(nb, dtype=dtype, device=device)
    w = torch.zeros((nb + bw, nb + bw), dtype=dtype, device=device)
    out = torch.empty((m, nb + bw, nb), dtype=dtype, device=device)
    bad_any = torch.zeros((), dtype=torch.bool, device=device)
    for i in range(m):
        s_i = s_blocks[i]
        d_low = torch.tril(s_i[:nb])
        d = d_low + d_low.T - torch.diag(torch.diagonal(d_low)) + w[:nb, :nb] \
            + shift * eye
        ld, info = torch.linalg.cholesky_ex(d)
        p = s_i[nb:] + w[nb:, :nb]
        lp = torch.linalg.solve_triangular(ld.T, p, upper=True, left=False)
        bad = (info != 0) | ~torch.isfinite(ld).all()
        ld = torch.where(bad, eye, ld)
        lp = torch.where(bad, torch.zeros((), dtype=dtype, device=device), lp)
        bad_any |= bad
        w_next = torch.zeros_like(w)
        w_next[:bw, :bw] = w[nb:, nb:] - lp @ lp.T
        w = w_next
        out[i, :nb] = ld
        out[i, nb:] = lp
    return out, ~bad_any


panel_lower_solve_plain.cuda_calls = 0
panel_upper_solve_plain.cuda_calls = 0
band_cholesky_plain.cuda_calls = 0


# -- the CUDA kernels (csrc/banded.cu) ------------------------------------------

def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for pdt, tdt in SWEEP_TYPES:
        fn = getattr(lib, f"panel_sweep_{_PANEL_TAGS[pdt]}_{_RHS_TAGS[tdt]}")
        fn.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, p]
        fn.restype = ctypes.c_int
    for ttag in _RHS_TAGS.values():
        fn = getattr(lib, f"band_factor_{ttag}")
        fn.argtypes = [p, p, p, p, i32, i32, i32, f64, p]
        fn.restype = ctypes.c_int
    lib.banded_last_launch.argtypes = [p]
    lib.banded_last_launch.restype = ctypes.c_int
    lib.banded_grid_sync.argtypes = [i32, i32, p]
    lib.banded_grid_sync.restype = ctypes.c_int
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    """raise_on, with the refused launch's grid in the message."""
    if err != 0:
        info = (ctypes.c_int * 5)()
        lib.banded_last_launch(ctypes.addressof(info))
        grid, per_sm, sms, smem, _ = info
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err} (grid {grid} "
                           f"blocks, {per_sm} fit an SM of {sms}, {smem} B shared memory)")


LIBRARY = CudaLibrary("banded", "banded.cu", _bind)
# launches count under "launch.panel_sweep/<lower|upper>/<panel type>/<rhs
# type>" and "launch.band_factor/<type>"
WRAPPERS = ("panel_sweep", "band_factor")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_operands(name: str, tensors: dict) -> torch.device:
    """Every operand contiguous on one CUDA device; returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on different devices "
                         f"({sorted(str(d) for d in devices)})")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {dev}")
    return dev


@spans.launches("launch.panel_sweep")
def panel_sweep(dinv: torch.Tensor, pbelow: torch.Tensor, rhs: torch.Tensor,
                upper: bool) -> torch.Tensor:
    """One sweep over the solve panels: y from L y = rhs (``upper`` False) or
    x from L^T x = rhs (``upper`` True), rhs (mp, S, c). CPU tensors: the
    plain twin. CUDA tensors: one launch of panel_sweep, or an error."""
    if _on_cpu(dinv, pbelow, rhs):
        plain = panel_upper_solve_plain if upper else panel_lower_solve_plain
        return plain(dinv, pbelow, rhs)
    name = "panel_sweep"
    if pbelow.dtype != dinv.dtype or (dinv.dtype, rhs.dtype) not in SWEEP_TYPES:
        raise TypeError(f"{name}: panels {dinv.dtype} and {pbelow.dtype} with a {rhs.dtype} "
                        f"rhs; the kernel takes (panels, rhs) in "
                        f"{[(str(p), str(t)) for p, t in SWEEP_TYPES]}")
    if dinv.dim() != 3 or pbelow.dim() != 3 or rhs.dim() != 3:
        raise ValueError(f"{name}: dinv (mp, S, S), pbelow (mp, bw, S), rhs (mp, S, c) "
                         f"expected")
    mp, s, s2 = dinv.shape
    bw, c = pbelow.shape[1], rhs.shape[2]
    if s2 != s or pbelow.shape != (mp, bw, s) or rhs.shape[:2] != (mp, s) or bw < s:
        raise ValueError(f"{name}: dinv {tuple(dinv.shape)}, pbelow {tuple(pbelow.shape)}, "
                         f"rhs {tuple(rhs.shape)} do not fit (and bw >= S)")
    if not 1 <= c <= MAX_COLUMNS:
        raise ValueError(f"{name}: {c} right-hand sides; the kernel takes 1 to {MAX_COLUMNS}")
    dev = _check_operands(name, dict(dinv=dinv, pbelow=pbelow, rhs=rhs))
    out = torch.empty_like(rhs)
    scratch = torch.zeros((2 * bw if not upper else s, c), dtype=rhs.dtype, device=dev)
    lib = LIBRARY.load()
    fn = getattr(lib, f"panel_sweep_{_PANEL_TAGS[dinv.dtype]}_{_RHS_TAGS[rhs.dtype]}")
    with torch.cuda.device(dev):
        err = fn(dinv.data_ptr(), pbelow.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), mp, s, bw, c, int(upper), stream_of(dev))
    _raise_on(lib, err, name)
    spans.count(f"launch.{name}/{'upper' if upper else 'lower'}/{_PANEL_TAGS[dinv.dtype]}/"
                f"{_RHS_TAGS[rhs.dtype]}")
    return out


@spans.launches("launch.band_factor")
def band_factor(s_blocks: torch.Tensor, shift, nb: int, bw: int):
    """The blocked banded Cholesky of ``s_blocks`` (m, nb+bw, nb) with
    ``shift`` added to the diagonal; returns (l_blocks, ok) with ok a device
    bool tensor. CPU tensors: the plain twin. CUDA tensors: one launch of
    band_factor (nb ``FACTOR_BLOCK``), or an error."""
    if _on_cpu(s_blocks):
        return band_cholesky_plain(s_blocks, shift, nb, bw)
    name = "band_factor"
    if s_blocks.dtype not in _RHS_TAGS:
        raise TypeError(f"{name}: band blocks must be float32 or float64, got {s_blocks.dtype}")
    if s_blocks.dim() != 3 or s_blocks.shape[1:] != (nb + bw, nb) or s_blocks.shape[0] < 1:
        raise ValueError(f"{name}: band blocks of {tuple(s_blocks.shape)}, "
                         f"(m, {nb + bw}, {nb}) expected")
    if nb != FACTOR_BLOCK or bw < nb:
        raise ValueError(f"{name}: nb {nb}, bw {bw}; the kernel takes nb {FACTOR_BLOCK}, "
                         f"bw >= nb")
    dev = _check_operands(name, dict(s_blocks=s_blocks))
    m = s_blocks.shape[0]
    out = torch.empty_like(s_blocks)
    window = torch.zeros((bw, bw), dtype=s_blocks.dtype, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    fn = getattr(lib, f"band_factor_{_RHS_TAGS[s_blocks.dtype]}")
    with torch.cuda.device(dev):
        err = fn(s_blocks.data_ptr(), out.data_ptr(), window.data_ptr(), flags.data_ptr(),
                 m, nb, bw, float(shift), stream_of(dev))
    _raise_on(lib, err, name)
    spans.count(f"launch.{name}/{_RHS_TAGS[s_blocks.dtype]}")
    return out, flags[0] == 0


def grid_sync(blocks: int, n: int, device) -> None:
    """One cooperative launch of ``blocks`` blocks (at most one an SM) that
    meet at ``n`` grid-wide barriers and do nothing else: the barrier the
    kernels above meet at, for timing. Counts no launch."""
    dev = torch.device(device)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.banded_grid_sync(blocks, n, stream_of(dev))
    _raise_on(lib, err, "grid_sync")


def reset_counts() -> None:
    """Zero the launch counts and the twins' calls on CUDA tensors."""
    spans.clear(*(f"launch.{w}" for w in WRAPPERS))
    for fn in (panel_lower_solve_plain, panel_upper_solve_plain, band_cholesky_plain):
        fn.cuda_calls = 0


def counts() -> dict:
    """Launches per kernel and per form, and the twins' calls on CUDA tensors."""
    return dict(panel_sweep=panel_sweep.launches, band_factor=band_factor.launches,
                by_form=spans.forms("launch", *WRAPPERS),
                plain_on_cuda=(panel_lower_solve_plain.cuda_calls
                               + panel_upper_solve_plain.cuda_calls
                               + band_cholesky_plain.cuda_calls))

"""Padded-ELL sparse matvecs: hand-written CUDA kernels and their plain twins.

Two wrappers over the kernels of ``csrc/spmv_ell.cu`` replace the reference
package's Pallas kernels (meshopticalflow_tpu/kernels/pallas_spmv.py):

    spmv_ell(cols, vals, x)        y = A x         <- _spmv_kernel
    spmv_ell_multi(cols, vals, X)  Y = A X, C <= 8 <- _spmv_multi_kernel

A is a padded-ELL operator: ``cols`` (N_out, W) int32 and ``vals``
(N_out, W), row-major; padding slots hold value 0 and a real column. x has
N_in rows, any N_in: square operators (N_in = N_out) and the rectangular
multigrid transfers P0 (fine <- coarse) and P0^T alike, as the TPU kernel
takes them with independent row and column permutations
(pallas_spmv.py:41-42). Every column index must be below N_in; that is
checked once where an operator is built (``check_columns``), not per
launch. Value types: float32 values with float32 x; bfloat16 values with
float32 x (f32 accumulation, f32 result); float64 values with float64 x.

``launch_plan`` picks the kernel variant from the row width W: up to
``SLAB_MAX_WIDTH`` slots a row, persistent CTAs stream slabs of R rows
through a ring of TMA bulk copies; wider rows get a group of G lanes each.
The slab copies need 16-byte aligned ``cols`` and ``vals``; the wrapper
raises on a misaligned operand rather than take another path.

A CUDA tensor always launches the kernel or raises. A CPU tensor goes to the
plain PyTorch version (``spmv_ell_plain`` / ``spmv_ell_multi_plain``, a
gather plus a sum over W). Each launch counts into utils/spans.py's counter
table under ``launch.<form>`` (``form_of``: wrapper, value type, square or
rectangular, variant); ``<wrapper>.launches`` reads the wrapper's forms.
Each plain version counts the calls it gets with CUDA tensors in
``<plain>.cuda_calls`` (the wrappers never make such a call, so on the main
path that count stays 0).

The kernels are compiled by nvcc at first use (kernels/build.py) and loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from meshopticalflow_tpu_torch.kernels.build import CudaLibrary, raise_on, stream_of
from meshopticalflow_tpu_torch.utils import spans

MAX_MULTI_COLUMNS = 8
SLAB_MAX_WIDTH = 16       # widest row the slab ring takes; wider rows use lane groups
# The slab ring's shape: small CTAs and two stages, because shared memory per
# CTA sets how many CTAs, and so how many rows and gathers, an SM holds.
SLAB_THREADS = 128
SLAB_STAGES = 2
SLAB_MIN_BYTES = 8192     # a slab holds at least this much of cols and vals
SLAB_MAX_PASSES = 4       # passes of a thread over one slab run one after another
GROUP_THREADS = 256
SMEM_PER_CTA = 227 * 1024
SMS = 132                 # H100 SXM; the wrapper reads the card's own count

# value dtype -> (tag of the C entry points, x / result dtype)
_VALUE_TYPES = {torch.float32: ("f32", torch.float32),
                torch.bfloat16: ("bf16", torch.float32),
                torch.float64: ("f64", torch.float64)}
_VARIANT_CODE = {"slab": 0, "group": 1}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    variant: str      # "slab" (TMA-staged row slabs) or "group" (G lanes per row)
    threads: int      # per CTA
    rows: int         # R, rows per slab ("slab"); 0 for "group"
    group: int        # G, lanes per row ("group"); 0 for "slab"
    stages: int       # slabs in the shared-memory ring ("slab"); 0 for "group"
    smem: int         # dynamic shared memory per CTA, bytes
    grid: int         # CTAs


def row_lanes(c: int, elem_size: int) -> int:
    """Lanes that share one row in the slab kernel, one vector of its C
    columns each (csrc/spmv_ell.cu:RowVec::kLanes)."""
    return c * elem_size // vector_bytes(c, elem_size)


def slab_rows(w: int, c: int, value_size: int) -> int:
    """R, rows per slab: whole passes of the CTA's lanes over the slab, each
    a multiple of 8 rows (which keeps every slab's offset and size a
    multiple of 16 bytes for every value type), enough passes for
    SLAB_MIN_BYTES of cols and vals, at most SLAB_MAX_PASSES: a thread's
    passes run one after another."""
    per_pass = SLAB_THREADS // row_lanes(c, x_elem_size(value_size)) // 8 * 8
    passes = SLAB_MIN_BYTES // (per_pass * w * (4 + value_size))
    return per_pass * min(SLAB_MAX_PASSES, max(1, passes))


def variant_of(w: int) -> str:
    """The kernel variant for rows of W slots."""
    return "slab" if 1 <= w <= SLAB_MAX_WIDTH else "group"


def form_of(name: str, cols: torch.Tensor, vals: torch.Tensor, n_in: int) -> str:
    """The form a launch counts under (``launch.<form>``):
    "wrapper/value type/square|rectangular/slab|group"."""
    n, w = cols.shape
    return "/".join((name, _VALUE_TYPES[vals.dtype][0],
                     "rectangular" if n != n_in else "square", variant_of(w)))


def lane_group(w: int, c: int) -> int:
    """G lanes per row: enough that a lane's slots fit one chunk of gathers
    (4 slots) for one column, or two chunks for C columns, whose C sums each
    cost a shuffle per halving of G; 4 to 32."""
    per_lane = 4 if c == 1 else 8
    g = 4
    while g < 32 and g * per_lane < w:
        g *= 2
    return g


def launch_plan(n: int, w: int, c: int, value_size: int,
                ctas_per_sm: Callable[[str, int, int], int] = lambda v, t, s: 1,
                sms: int = SMS) -> LaunchPlan:
    """The launch of one product: (n, W, C, value size) -> variant, R or G,
    grid. ``ctas_per_sm(variant, threads, smem)`` is the occupancy the card
    reports for that kernel (the wrapper asks the CUDA occupancy API once per
    configuration). Both variants are persistent: the grid is the CTAs the
    card holds at once, capped at the work."""
    if not 1 <= c <= MAX_MULTI_COLUMNS:
        raise ValueError(f"launch_plan: {c} columns, the kernels take 1..{MAX_MULTI_COLUMNS}")
    if variant_of(w) == "slab":
        rows = slab_rows(w, c, value_size)
        stages = SLAB_STAGES
        smem = stages * rows * w * (4 + value_size)
        if smem > SMEM_PER_CTA:
            raise ValueError(f"launch_plan: a {stages}-stage ring of {rows} rows x {w} "
                             f"needs {smem} B of shared memory")
        resident = max(1, ctas_per_sm("slab", SLAB_THREADS, smem)) * sms
        grid = max(1, min(resident, -(-n // rows)))
        return LaunchPlan("slab", SLAB_THREADS, rows, 0, stages, smem, grid)
    g = lane_group(w, c)
    resident = max(1, ctas_per_sm("group", GROUP_THREADS, 0)) * sms
    grid = max(1, min(resident, -(-n * g // GROUP_THREADS)))
    return LaunchPlan("group", GROUP_THREADS, 0, g, 0, 0, grid)


def x_elem_size(value_size: int) -> int:
    """Bytes of one element of x and y for values of ``value_size`` bytes
    (bf16 and f32 values take f32 x)."""
    return 8 if value_size == 8 else 4


def vector_bytes(c: int, elem_size: int) -> int:
    """Bytes of the vector access the kernels use for one C-wide row of x
    and y (csrc/spmv_ell.cu:RowVec); x must be aligned to it."""
    row = c * elem_size
    return 16 if row % 16 == 0 else 8 if row % 8 == 0 else elem_size


class _Kernels:
    """The loaded library's entry points, bound once per value type, and
    what each operator shape's launches need, worked out at its first launch
    (per loaded library)."""

    def __init__(self, lib: ctypes.CDLL):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        self.launch, self.occupancy = {}, {}
        for dtype, (tag, _) in _VALUE_TYPES.items():
            fn = getattr(lib, f"spmv_ell_{tag}")
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, i32,
                           i32, ptr]
            fn.restype = i32
            self.launch[dtype] = fn
            occ = getattr(lib, f"spmv_ell_occupancy_{tag}")
            occ.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32)]
            occ.restype = i32
            self.occupancy[dtype] = occ
        self.entries: dict = {}
        self.ctas: dict = {}

    def ctas_per_sm(self, dtype, c: int, variant: str, threads: int, smem: int) -> int:
        key = (dtype, c, variant, threads, smem)
        if key not in self.ctas:
            out = ctypes.c_int(0)
            raise_on(self.occupancy[dtype](c, _VARIANT_CODE[variant], threads, smem,
                                           ctypes.byref(out)), "spmv occupancy")
            if out.value < 1:
                raise RuntimeError(f"spmv: the card fits no CTA of {threads} threads "
                                   f"and {smem} B of shared memory")
            self.ctas[key] = out.value
        return self.ctas[key]

    def plan(self, dtype, n: int, w: int, c: int, device) -> LaunchPlan:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return launch_plan(n, w, c, dtype.itemsize,
                           lambda v, t, s: self.ctas_per_sm(dtype, c, v, t, s), sms)

    def entry(self, name: str, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
              c: int) -> tuple:
        """(entry point, the launch's size and plan arguments, form, x's
        alignment) for this operator shape on x's device."""
        n, w = cols.shape
        key = (name, vals.dtype, n, w, c, x.shape[0], x.device.index)
        hit = self.entries.get(key)
        if hit is None:
            plan = self.plan(vals.dtype, n, w, c, x.device)
            hit = (self.launch[vals.dtype],
                   (n, w, c, _VARIANT_CODE[plan.variant], plan.threads,
                    plan.rows or plan.group, plan.stages, plan.smem, plan.grid),
                   form_of(name, cols, vals, x.shape[0]), vector_bytes(c, x.element_size()))
            self.entries[key] = hit
        return hit


LIBRARY = CudaLibrary("spmv_ell", "spmv_ell.cu", _Kernels)
WRAPPERS = ("spmv_ell", "spmv_ell_multi")


def check_columns(cols, n_in: int) -> None:
    """Host-side bound check of an operator's column indices (cols may be a
    numpy array or a tensor): every index in [0, n_in). Called once where a
    pack or operator is built; the kernels themselves do not check."""
    c = cols.detach().cpu().numpy() if isinstance(cols, torch.Tensor) else np.asarray(cols)
    if c.size and (int(c.min()) < 0 or int(c.max()) >= n_in):
        raise ValueError(f"ELL column indices span [{int(c.min())}, {int(c.max())}], "
                         f"outside the {n_in} rows of x")


def _check(name: str, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
           x_ndim: int) -> torch.dtype:
    """Validate operands; returns the x / result dtype."""
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be a 2-D int32 tensor, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    if vals.shape != cols.shape:
        raise ValueError(f"{name}: vals shape {tuple(vals.shape)} != cols "
                         f"shape {tuple(cols.shape)}")
    if vals.dtype not in _VALUE_TYPES:
        raise TypeError(f"{name}: vals dtype {vals.dtype} not in "
                        f"float32/bfloat16/float64")
    x_dtype = _VALUE_TYPES[vals.dtype][1]
    if x.dtype != x_dtype:
        raise TypeError(f"{name}: {vals.dtype} values take {x_dtype} x, got "
                        f"{x.dtype}")
    if x.dim() != x_ndim:
        want = "(N_in,)" if x_ndim == 1 else "(N_in, C)"
        raise ValueError(f"{name}: x must be {want}, got {tuple(x.shape)}")
    if x.shape[0] == 0 and cols.numel() > 0:
        raise ValueError(f"{name}: x has no rows for a {tuple(cols.shape)} operator")
    if not (cols.device == vals.device == x.device):
        raise ValueError(f"{name}: operands on different devices "
                         f"({cols.device}, {vals.device}, {x.device})")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cols.device}")
    if not (cols.is_contiguous() and vals.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    return x_dtype


def spmv_ell_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A x: one gather and a sum over the W slots."""
    if x.is_cuda:
        spmv_ell_plain.cuda_calls += 1
    return (vals.to(x.dtype) * x[cols]).sum(dim=1)


def spmv_ell_multi_plain(cols: torch.Tensor, vals: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A X for X (N, C)."""
    if x.is_cuda:
        spmv_ell_multi_plain.cuda_calls += 1
    return (vals.to(x.dtype)[:, :, None] * x[cols]).sum(dim=1)


spmv_ell_plain.cuda_calls = 0
spmv_ell_multi_plain.cuda_calls = 0


def _launch(name: str, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor, c: int) -> None:
    """Launch the kernel for y = A x on x's device and stream; raises on a
    misaligned operand or a refused launch."""
    fn, sizes, form, x_align = LIBRARY.load().entry(name, cols, vals, x, c)
    p_cols, p_vals, p_x = cols.data_ptr(), vals.data_ptr(), x.data_ptr()
    if p_cols % 16 or p_vals % 16:
        raise ValueError(f"{name}: cols and vals must be 16-byte aligned for the slab "
                         f"copies (data_ptr % 16: {p_cols % 16}, {p_vals % 16})")
    if p_x % x_align:
        raise ValueError(f"{name}: x must be {x_align}-byte aligned for {c}-wide rows")
    dev = x.device
    if dev.index == torch.cuda.current_device():
        err = fn(p_cols, p_vals, p_x, y.data_ptr(), *sizes, stream_of(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(p_cols, p_vals, p_x, y.data_ptr(), *sizes, stream_of(dev))
    raise_on(err, name)
    spans.count("launch." + form)


@spans.launches("launch.spmv_ell")
def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (N_out,) = A x for a padded-ELL operator; x (N_in,)."""
    x_dtype = _check("spmv_ell", cols, vals, x, 1)
    if not x.is_cuda:
        return spmv_ell_plain(cols, vals, x)
    y = torch.empty(cols.shape[0], dtype=x_dtype, device=x.device)
    if y.numel():
        _launch("spmv_ell", cols, vals, x, y, 1)
    return y


@spans.launches("launch.spmv_ell_multi")
def spmv_ell_multi(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y (N_out, C) = A X for a padded-ELL operator; X (N_in, C), 1 <= C <= 8."""
    x_dtype = _check("spmv_ell_multi", cols, vals, x, 2)
    c = x.shape[1]
    if not 1 <= c <= MAX_MULTI_COLUMNS:
        raise ValueError(f"spmv_ell_multi: X has {c} columns, the kernel "
                         f"takes 1..{MAX_MULTI_COLUMNS}")
    if not x.is_cuda:
        return spmv_ell_multi_plain(cols, vals, x)
    y = torch.empty((cols.shape[0], c), dtype=x_dtype, device=x.device)
    if y.numel():
        _launch("spmv_ell_multi", cols, vals, x, y, c)
    return y


def reset_counts() -> None:
    """Zero the launch counts and the plain-on-CUDA call counts."""
    spans.clear(*(f"launch.{w}" for w in WRAPPERS))
    spmv_ell_plain.cuda_calls = spmv_ell_multi_plain.cuda_calls = 0


def counts() -> dict:
    """Launches per wrapper, per form ("wrapper/type/square|rectangular/
    slab|group"), and plain-version calls on CUDA tensors."""
    return {"spmv_ell": spmv_ell.launches,
            "spmv_ell_multi": spmv_ell_multi.launches,
            "by_form": spans.forms("launch", *WRAPPERS),
            "plain_on_cuda": spmv_ell_plain.cuda_calls
            + spmv_ell_multi_plain.cuda_calls}

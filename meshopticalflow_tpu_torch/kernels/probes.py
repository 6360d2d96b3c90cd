"""Hopper capability probes: hand-written CUDA kernels and their plain twins.

The seven kernels of ``csrc/probes.cu`` replace the Mosaic capability probes
of the reference package's ``scripts/probe_pallas.py``: each exercises, on
Hopper, the capability its probe tested on the TPU (see the source's header).
Every wrapper launches its kernel for CUDA tensors or raises, and takes its
plain PyTorch version for CPU tensors; its launches count into
utils/spans.py's counter table under ``launch.<wrapper>``, which
``<wrapper>.launches`` reads, and its plain version counts CUDA calls in
``<plain>.cuda_calls``, as kernels/spmv.py does.

Entry point (one ``[ok]`` / ``[FAIL]`` line per probe, exit status 1 if any
probe fails, as the reference script prints them):

    python -m meshopticalflow_tpu_torch.kernels.probes [--device cuda|cpu]

Each probe runs on the reference script's own inputs (its ``arange`` arrays)
and is held against the script's numpy expectation and, on the card, against
its plain version.

``bulk_copy_plan``, ``accumulate_plan``, ``block_select_plan``,
``row_gather_plan``, ``scale_plan`` and ``flat_gather_plan`` are the
launches of the bulk-copy, grid-accumulation, block-select, row-gather,
scale and flat-gather kernels (chunk size and CTAs; vector or scalar form,
tile and grid; the flat gather's chunks and whether its ordering pass
runs), in Python so that the CPU tests reach them. ``flat_gather_order``
is the flat gather's ordering pass (held to ``flat_gather_order_plain``).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from meshopticalflow_tpu_torch.kernels.build import CudaLibrary, raise_on, stream_of
from meshopticalflow_tpu_torch.utils import spans


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {"probe_scale": [p, p, i64, i32, i32, i32, i32, i32, p],
            "probe_row_gather": [p, p, p, i64, i32, i32, i32, i32, i32, i32, p],
            "probe_flat_gather": [p, p, p, p, i64, i64, i32, i32, i32, i32, i32, p],
            "probe_flat_gather_order": [p, p, p, i64, i64, p],
            "probe_lane_gather": [p, p, p, i64, i32, p],
            "probe_block_select": [p, p, p, i32, i64, i32, i32, i32, i32, i32, p],
            "probe_accumulate": [p, p, i64, i32, i32, i32, i32, i32, p],
            "probe_bulk_copy": [p, p, i64, i32, i32, i32, p]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    return lib


LIBRARY = CudaLibrary("probes", "probes.cu", _bind)

SMS = 132                  # H100 SXM; the wrappers read the card's own count
# probe_bulk_copy: chunks of 1 KB (or the whole copy, if smaller) to 16 KB,
# a multiple of 16 bytes; one chunk per CTA while that spreads the copy
# over the SMs, else persistent CTAs walking 16 KB chunks through a 2-stage
# ring in dynamic shared memory (2 x 16 KB stays under the 48 KB a launch
# gets without opting in).
BULK_MIN_CHUNK = 256       # floats
BULK_MAX_CHUNK = 4096      # floats
BULK_SMEM_BUDGET = 48 * 1024
BULK_CTAS_PER_SM = 4
# probe_accumulate: CTAs of ACC_THREADS threads, halved down to
# ACC_MIN_THREADS while the grid would cover fewer CTAs than the card has
# SMs; at most ACC_CTAS_PER_SM CTAs an SM (four waves of 2,048 threads),
# then grid-stride.
ACC_THREADS = 128
ACC_MIN_THREADS = 32
ACC_CTAS_PER_SM = 64
# probe_block_select and probe_row_gather: CTA steps over tiles of
# TILE_THREADS threads x TILE_VPT units (float4 or float) a thread; while
# the tiles would cover fewer CTAs than the card has SMs, fewer threads a
# CTA down to TILE_MIN_THREADS, then fewer units a thread down to 1; at most
# TILE_CTAS_PER_SM CTAs an SM, then grid-stride. TILE_VPT is 1, 2, 4 or 8
# (the kernels' template arguments).
TILE_THREADS = 128
TILE_MIN_THREADS = 32
TILE_VPT = 4
TILE_CTAS_PER_SM = 32
# probe_scale: a tile of SCALE_THREADS threads x SCALE_VPT float4s a CTA,
# fewer float4s a thread while one CTA's threads would cover the units (at
# the launch-bound size one wide CTA, a float4 a thread, reads fastest; not
# spread over the SMs); at most SCALE_CTAS_PER_SM CTAs an SM, then
# grid-stride.
SCALE_THREADS = 256
SCALE_VPT = 4
SCALE_CTAS_PER_SM = 128
# probe_flat_gather: chunks of GATHER_CHUNK outputs (a power of two, at
# least 4 * GATHER_MIN_THREADS; doubled while there would be more than
# GATHER_MAX_CHUNKS of them), visited in the order of the ordering pass
# from GATHER_MIN_ORDERED_CHUNKS chunks on, else in index order; tiles of
# GATHER_THREADS x GATHER_VPT units (fewer while a tile would overrun a
# chunk), shrunk as scale's; at most GATHER_CTAS_PER_SM CTAs an SM, each
# a contiguous run of tiles: one wide CTA an SM, so the SM's L1 holds the
# region of x that its run of the order reads.
GATHER_CHUNK = 4096
GATHER_MAX_CHUNKS = 65536
GATHER_MIN_ORDERED_CHUNKS = 2
GATHER_THREADS = 1024
GATHER_MIN_THREADS = 32
GATHER_VPT = 1
GATHER_CTAS_PER_SM = 1


@dataclasses.dataclass(frozen=True)
class BulkCopyPlan:
    chunk: int        # floats a chunk (a multiple of 4: 16 bytes)
    grid: int         # CTAs; CTA b moves chunks b, b + grid, ...
    stages: int       # shared-memory stages: 1 if every CTA has one chunk, else 2
    smem: int         # dynamic shared memory per CTA, bytes


@functools.lru_cache(maxsize=256)
def bulk_copy_plan(n_floats: int, sm_count: int = SMS) -> BulkCopyPlan:
    """The launch of one bulk copy of ``n_floats`` (a positive multiple of 4):
    chunks of about n / SMs floats, rounded up to 16 bytes and held between
    BULK_MIN_CHUNK (or n) and BULK_MAX_CHUNK; one CTA per chunk up to
    BULK_CTAS_PER_SM CTAs an SM, past that persistent CTAs with a 2-stage
    ring."""
    if n_floats <= 0 or n_floats % 4:
        raise ValueError(f"bulk_copy_plan: {n_floats} floats, want a positive multiple of 4")
    per_sm = -(-n_floats // sm_count)
    chunk = min(n_floats, BULK_MAX_CHUNK, max(BULK_MIN_CHUNK, -(-per_sm // 4) * 4))
    chunks = -(-n_floats // chunk)
    per_cta = -(-chunks // (BULK_CTAS_PER_SM * sm_count))
    grid = -(-chunks // per_cta)            # every CTA within one chunk of the most
    stages = 1 if per_cta == 1 else 2
    return BulkCopyPlan(chunk, grid, stages, stages * chunk * 4)


@dataclasses.dataclass(frozen=True)
class AccumulatePlan:
    vector: bool      # float4 units (R * W % 4 == 0, operands 16-byte aligned) or floats
    units: int        # output units: B * R * W / 4 vectors or B * R * W floats
    per_block: int    # units of one output block (R * W / 4 or R * W)
    threads: int      # per CTA
    grid: int         # CTAs; a thread walks units t, t + grid * threads, ...


@functools.lru_cache(maxsize=256)
def accumulate_plan(b: int, rw: int, sm_count: int = SMS,
                    aligned: bool = True) -> AccumulatePlan:
    """The launch of one grid accumulation of B blocks of R * W = ``rw``
    floats: the vector form where R * W is a multiple of 4 and the operands
    are 16-byte aligned, else the scalar form; one thread per unit in CTAs
    of ACC_THREADS, fewer threads a CTA while that spreads a small grid over
    more SMs, at most ACC_CTAS_PER_SM CTAs an SM."""
    vector = aligned and rw % 4 == 0
    per_block = rw // 4 if vector else rw
    units = b * per_block
    threads = ACC_THREADS
    while threads > ACC_MIN_THREADS and -(-units // threads) < sm_count:
        threads //= 2
    grid = max(1, min(-(-units // threads), ACC_CTAS_PER_SM * sm_count))
    return AccumulatePlan(vector, units, per_block, threads, grid)


def _tile_shape(tiles_of, sm_count: int, threads: int, min_threads: int, vpt: int):
    """(threads, vpt): from ``threads`` x ``vpt``, halve the threads a CTA
    down to ``min_threads``, then the units a thread down to 1, while
    ``tiles_of(threads * vpt)`` tiles would cover fewer CTAs than
    ``sm_count``."""
    while tiles_of(threads * vpt) < sm_count and (threads > min_threads or vpt > 1):
        if threads > min_threads:
            threads //= 2
        else:
            vpt //= 2
    return threads, vpt


@dataclasses.dataclass(frozen=True)
class BlockSelectPlan:
    vector: bool          # float4 units (a block's floats % 4 == 0, aligned) or floats
    block_units: int      # units of one block
    threads: int          # per CTA
    vpt: int              # units a thread in one tile
    tiles_per_block: int  # tiles of threads * vpt units in one output block
    grid: int             # CTAs; CTA c walks tiles c, c + grid, ...

    @property
    def tile(self) -> int:
        return self.threads * self.vpt


@functools.lru_cache(maxsize=256)
def block_select_plan(nsel: int, block_elems: int, sm_count: int = SMS,
                      aligned: bool = True) -> BlockSelectPlan:
    """The launch of one block select of ``nsel`` blocks of ``block_elems``
    floats: the vector form where a block is whole float4s and the operands
    are 16-byte aligned, else the scalar form; tiles inside one block each
    (a tile reads one ``sel`` entry), spread over the SMs and capped at
    TILE_CTAS_PER_SM CTAs an SM."""
    vector = aligned and block_elems % 4 == 0
    block_units = block_elems // 4 if vector else block_elems
    threads, vpt = _tile_shape(lambda tile: nsel * -(-block_units // tile), sm_count,
                               TILE_THREADS, TILE_MIN_THREADS, TILE_VPT)
    tiles_per_block = -(-block_units // (threads * vpt))
    grid = max(1, min(nsel * tiles_per_block, TILE_CTAS_PER_SM * sm_count))
    return BlockSelectPlan(vector, block_units, threads, vpt, tiles_per_block, grid)


@dataclasses.dataclass(frozen=True)
class RowGatherPlan:
    vector: bool      # float4 units (W % 4 == 0, operands 16-byte aligned) or floats
    units: int        # output units: M * W / 4 vectors or M * W floats
    per_row: int      # units of one row (W / 4 or W)
    threads: int      # per CTA
    vpt: int          # units a thread in one tile
    grid: int         # CTAs; CTA c walks tiles c, c + grid, ...

    @property
    def tile(self) -> int:
        return self.threads * self.vpt


@functools.lru_cache(maxsize=256)
def row_gather_plan(m: int, w: int, sm_count: int = SMS,
                    aligned: bool = True) -> RowGatherPlan:
    """The launch of one row gather into an (``m``, ``w``) output: the vector
    form where W is a multiple of 4 and the operands are 16-byte aligned,
    else the scalar form; tiles spread over the SMs and capped at
    TILE_CTAS_PER_SM CTAs an SM."""
    vector = aligned and w % 4 == 0
    per_row = w // 4 if vector else w
    units = m * per_row
    threads, vpt = _tile_shape(lambda tile: -(-units // tile), sm_count,
                               TILE_THREADS, TILE_MIN_THREADS, TILE_VPT)
    grid = max(1, min(-(-units // (threads * vpt)), TILE_CTAS_PER_SM * sm_count))
    return RowGatherPlan(vector, units, per_row, threads, vpt, grid)


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    vector: bool      # float4 units (x and o 16-byte aligned) or floats
    units: int        # n // 4 vectors or n floats
    tail: int         # floats past the units (n % 4 in the vector form, else 0)
    threads: int      # per CTA
    vpt: int          # units a thread in one tile
    grid: int         # CTAs; CTA c walks tiles c, c + grid, ...

    @property
    def tile(self) -> int:
        return self.threads * self.vpt


@functools.lru_cache(maxsize=256)
def scale_plan(n: int, sm_count: int = SMS, aligned: bool = True) -> ScalePlan:
    """The launch of one o = 2 x over ``n`` floats: float4 units and a tail
    of n % 4 floats where x and o are 16-byte aligned, else floats; one tile
    a CTA, capped at SCALE_CTAS_PER_SM CTAs an SM; fewer units a thread
    while SCALE_THREADS threads would cover them all."""
    units, tail = (n // 4, n % 4) if aligned else (n, 0)
    vpt = SCALE_VPT
    while vpt > 1 and SCALE_THREADS * vpt > units:
        vpt //= 2
    grid = max(1, min(-(-units // (SCALE_THREADS * vpt)), SCALE_CTAS_PER_SM * sm_count))
    return ScalePlan(aligned, units, tail, SCALE_THREADS, vpt, grid)


@dataclasses.dataclass(frozen=True)
class FlatGatherPlan:
    vector: bool      # float4 / int4 units (idx and o 16-byte aligned) or floats
    units: int        # n // 4 vectors or n floats
    tail: int         # floats past the units (n % 4 in the vector form, else 0)
    chunk: int        # outputs a chunk; the ordering key of chunk c is idx[c * chunk]
    n_chunks: int     # chunks of chunk_units covering the units, the last one short
    ordered: bool     # chunks in the ordering pass's order, else in index order
    threads: int      # per CTA
    vpt: int          # units a thread in one tile
    grid: int         # CTAs; CTA c takes the contiguous run c of the tile steps

    @property
    def tile(self) -> int:
        return self.threads * self.vpt

    @property
    def chunk_units(self) -> int:
        return self.chunk // 4 if self.vector else self.chunk

    @property
    def tiles_per_chunk(self) -> int:
        return self.chunk_units // self.tile


@functools.lru_cache(maxsize=256)
def flat_gather_plan(n: int, sm_count: int = SMS, aligned: bool = True) -> FlatGatherPlan:
    """The launch of one o = x[idx] over ``n`` outputs: int4 / float4 units
    and a tail of n % 4 floats where idx and o are 16-byte aligned, else
    floats; chunks of GATHER_CHUNK outputs (doubled past GATHER_MAX_CHUNKS
    chunks), ordered by the ordering pass from GATHER_MIN_ORDERED_CHUNKS
    chunks on; tiles spread over the SMs and capped at GATHER_CTAS_PER_SM
    CTAs an SM, each tile inside one chunk, each CTA a contiguous run of
    tile steps."""
    units, tail = (n // 4, n % 4) if aligned else (n, 0)
    width = 4 if aligned else 1
    chunk = GATHER_CHUNK
    if chunk & (chunk - 1) or chunk < 4 * GATHER_MIN_THREADS:
        raise ValueError(f"GATHER_CHUNK {chunk}: want a power of two of at least "
                         f"{4 * GATHER_MIN_THREADS}")
    while -(-units // (chunk // width)) > GATHER_MAX_CHUNKS:
        chunk *= 2
    n_chunks = -(-units // (chunk // width))
    threads, vpt = GATHER_THREADS, GATHER_VPT        # a tile fits in a chunk
    while threads * vpt > chunk // width:
        threads, vpt = (threads, vpt // 2) if vpt > 1 else (threads // 2, vpt)
    threads, vpt = _tile_shape(lambda tile: -(-units // tile), sm_count,
                               threads, min(threads, GATHER_MIN_THREADS), vpt)
    ordered = n_chunks >= GATHER_MIN_ORDERED_CHUNKS
    # ordered: every chunk's tiles, a short last chunk's empty ones too, so
    # that step s lies in the chunk at position s // tiles_per_chunk
    steps = (n_chunks * (chunk // width // (threads * vpt)) if ordered
             else -(-units // (threads * vpt)))
    grid = max(1, min(steps, GATHER_CTAS_PER_SM * sm_count))
    return FlatGatherPlan(aligned, units, tail, chunk, n_chunks, ordered, threads, vpt, grid)


def clear_plans() -> None:
    """Forget the cached plans (after a launch constant changed)."""
    for plan in (bulk_copy_plan, accumulate_plan, block_select_plan, row_gather_plan,
                 scale_plan, flat_gather_plan):
        plan.cache_clear()


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, *tensors: torch.Tensor) -> bool:
    """Same device, contiguous, f32 data / int32 indices; True on CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"{name}: float32 data and int32 indices, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _launch(wrapper, entry: str, *args) -> None:
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    call = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]   # None: null
    with torch.cuda.device(dev):
        err = getattr(LIBRARY.load(), entry)(*call, stream_of(dev))
    raise_on(err, entry)
    spans.count(wrapper.key)


def _plain(fn):
    """Mark a plain version: count the calls it gets with CUDA tensors."""
    def counted(*args):
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            counted.cuda_calls += 1
        return fn(*args)
    counted.cuda_calls = 0
    counted.__name__ = fn.__name__
    counted.__doc__ = fn.__doc__
    return counted


# -- plain versions -----------------------------------------------------------

@_plain
def scale_plain(x):
    return x * 2.0


@_plain
def row_gather_plain(x, idx):
    return torch.gather(x, 0, idx.long())


@_plain
def flat_gather_plain(x, idx):
    return x[idx.long()]


@_plain
def flat_gather_order_plain(idx, chunk: int, n_chunks: int):
    keys = idx.reshape(-1)[:n_chunks * chunk:chunk]
    return torch.sort(keys, stable=True).indices.to(torch.int32)


@_plain
def lane_gather_plain(x, idx):
    return torch.gather(x, 1, idx.long())


@_plain
def block_select_plain(x, sel, block_rows: int):
    w = x.shape[1]
    return (x.reshape(-1, block_rows, w).index_select(0, sel.long()) + 1.0).reshape(-1, w)


@_plain
def accumulate_plain(x):
    return x.sum(dim=1).reshape(-1, x.shape[-1])


@_plain
def bulk_copy_plain(x, start: int, rows: int):
    return x[start:start + rows].clone()


# -- kernels ------------------------------------------------------------------

@spans.launches("launch.scale")
def scale(x):
    """o = 2 x (p_basic)."""
    if not _check("scale", x):
        return scale_plain(x)
    o = torch.empty_like(x)
    if o.numel():
        plan = scale_plan(x.numel(), sm_count(x.device), _aligned(x, o))
        _launch(scale, "probe_scale", x, o, plan.units, plan.tail, int(plan.vector),
                plan.vpt, plan.threads, plan.grid)
    return o


@spans.launches("launch.row_gather")
def row_gather(x, idx):
    """o[i, j] = x[idx[i, j], j] for x (N, W), idx (M, W) (p_take_along_axis_rows)."""
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[1] != x.shape[1]:
        raise ValueError("row_gather: x (N, W) and idx (M, W)")
    if not _check("row_gather", x, idx):
        return row_gather_plain(x, idx)
    o = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    if o.numel():
        plan = row_gather_plan(idx.shape[0], idx.shape[1], sm_count(x.device),
                               _aligned(x, idx, o))
        _launch(row_gather, "probe_row_gather", x, idx, o, plan.units, plan.per_row,
                x.shape[1], int(plan.vector), plan.vpt, plan.threads, plan.grid)
    return o


@spans.launches("launch.flat_gather")
def flat_gather(x, idx):
    """o = x[idx] for a 1-D x and any-shaped idx (p_flat_gather)."""
    if x.dim() != 1:
        raise ValueError("flat_gather: x must be 1-D")
    if not _check("flat_gather", x, idx):
        return flat_gather_plain(x, idx)
    o = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    if o.numel():
        plan = flat_gather_plan(idx.numel(), sm_count(x.device), _aligned(idx, o))
        order = flat_gather_order(idx, plan.chunk, plan.n_chunks) if plan.ordered else None
        _launch(flat_gather, "probe_flat_gather", x, idx, o, order, plan.units,
                plan.chunk_units, plan.tail, int(plan.vector), plan.vpt, plan.threads,
                plan.grid)
    return o


@spans.launches("launch.flat_gather_order")
def flat_gather_order(idx, chunk: int, n_chunks: int):
    """The flat gather's ordering pass: chunk ids 0 .. n_chunks-1 sorted by
    their key idx.flat[c * chunk], ties by id (a stable sort), as int32.
    Counts one launch in ``flat_gather_order.launches`` per pass (three
    kernels)."""
    if chunk <= 0 or n_chunks < 0 or (n_chunks and (n_chunks - 1) * chunk >= idx.numel()):
        raise ValueError(f"flat_gather_order: {n_chunks} chunks of {chunk} in "
                         f"{idx.numel()} indices")
    if not _check("flat_gather_order", idx):
        return flat_gather_order_plain(idx, chunk, n_chunks)
    order = torch.empty(n_chunks, dtype=torch.int32, device=idx.device)
    if n_chunks:
        scratch = torch.empty(2 * n_chunks, dtype=torch.int32, device=idx.device)
        _launch(flat_gather_order, "probe_flat_gather_order", idx, scratch, order, n_chunks,
                chunk)
    return order


@spans.launches("launch.lane_gather")
def lane_gather(x, idx):
    """o[i, j] = x[i, idx[i, j]] for x, idx (M, W) (p_dynamic_gather_lanes)."""
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError("lane_gather: x and idx (M, W)")
    if not _check("lane_gather", x, idx):
        return lane_gather_plain(x, idx)
    o = torch.empty_like(x)
    _launch(lane_gather, "probe_lane_gather", x, idx, o, x.numel(), x.shape[1])
    return o


@spans.launches("launch.block_select")
def block_select(x, sel, block_rows: int):
    """Output block b = x's block sel[b] + 1, blocks of ``block_rows`` rows
    (p_scalar_prefetch_indexmap)."""
    if x.dim() != 2 or x.shape[0] % block_rows or sel.dim() != 1:
        raise ValueError("block_select: x (nblocks * block_rows, W), sel (S,)")
    if not _check("block_select", x, sel):
        return block_select_plain(x, sel, block_rows)
    o = torch.empty((sel.shape[0] * block_rows, x.shape[1]), dtype=x.dtype,
                    device=x.device)
    if o.numel():
        plan = block_select_plan(sel.shape[0], block_rows * x.shape[1], sm_count(x.device),
                                 _aligned(x, o))
        _launch(block_select, "probe_block_select", x, sel, o, sel.shape[0],
                plan.block_units, plan.tiles_per_block, int(plan.vector), plan.vpt,
                plan.threads, plan.grid)
    return o


@spans.launches("launch.accumulate")
def accumulate(x):
    """o[b] = sum_k x[b, k] for x (B, K, R, W) -> (B * R, W), summed in the
    order k = 0 .. K-1 (p_accumulate_grid)."""
    if x.dim() != 4:
        raise ValueError("accumulate: x (B, K, R, W)")
    if not _check("accumulate", x):
        return accumulate_plain(x)
    b, k, r, w = x.shape
    o = torch.empty((b * r, w), dtype=x.dtype, device=x.device)
    if o.numel():
        plan = accumulate_plan(b, r * w, sm_count(x.device), _aligned(x, o))
        _launch(accumulate, "probe_accumulate", x, o, plan.units, plan.per_block, k,
                int(plan.vector), plan.threads, plan.grid)
    return o


@spans.launches("launch.bulk_copy")
def bulk_copy(x, start: int, rows: int):
    """Rows [start, start + rows) of x (N, W) through bulk async copies into
    shared memory and back out (p_dma_hbm_to_vmem)."""
    if x.dim() != 2 or not 0 <= start <= start + rows <= x.shape[0]:
        raise ValueError("bulk_copy: rows out of range")
    w = x.shape[1]
    if (start * w) % 4 or (rows * w) % 4:
        raise ValueError("bulk_copy: the copied range must be whole 16-byte units")
    if not _check("bulk_copy", x):
        return bulk_copy_plain(x, start, rows)
    o = torch.empty((rows, w), dtype=x.dtype, device=x.device)
    src = x.view(-1)[start * w:]
    if src.data_ptr() % 16 or o.data_ptr() % 16:
        raise ValueError(f"bulk_copy: source and output must be 16-byte aligned for the bulk "
                         f"copies (data_ptr % 16: {src.data_ptr() % 16}, {o.data_ptr() % 16})")
    if o.numel():
        plan = bulk_copy_plan(rows * w, sm_count(x.device))
        _launch(bulk_copy, "probe_bulk_copy", src, o, rows * w, plan.chunk, plan.grid,
                plan.smem)
    return o


KERNELS = (scale, row_gather, flat_gather, lane_gather, block_select, accumulate,
           bulk_copy)
PLAINS = {scale: scale_plain, row_gather: row_gather_plain,
          flat_gather: flat_gather_plain, lane_gather: lane_gather_plain,
          block_select: block_select_plain, accumulate: accumulate_plain,
          bulk_copy: bulk_copy_plain}


def reset_counts() -> None:
    spans.clear(*(k.key for k in KERNELS + (flat_gather_order,)))
    for k in KERNELS:
        PLAINS[k].cuda_calls = 0
    flat_gather_order_plain.cuda_calls = 0


# -- the reference script's inputs and expectations ---------------------------

# (name, reference probe (scripts/probe_pallas.py line), kernel, args builder,
#  numpy expectation); args are numpy arrays or ints, as the probe builds them.
def _inputs_basic():
    x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    return (x,), x * 2.0


def _inputs_rows():
    n, m = 256, 64
    x = np.arange(n * 128, dtype=np.float32).reshape(n, 128)
    idx = np.broadcast_to((np.arange(m, dtype=np.int32) * 3 % n)[:, None], (m, 128))
    return (x, np.ascontiguousarray(idx)), np.take(x, idx[:, 0], axis=0)


def _inputs_flat():
    n = 2048
    x = np.arange(n, dtype=np.float32)
    idx = (np.arange(8 * 128, dtype=np.int32) * 7 % n).reshape(8, 128)
    return (x, idx), x[idx]


def _inputs_lanes():
    x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    idx = (np.arange(8 * 128, dtype=np.int32) * 5 % 128).reshape(8, 128)
    return (x, idx), np.take_along_axis(x, idx, axis=1)


def _inputs_select():
    nblocks, bs = 8, 128
    x = np.arange(nblocks * bs * 128, dtype=np.float32).reshape(nblocks * bs, 128)
    sel = np.asarray([3, 1, 4, 1], np.int32)
    expect = np.concatenate([x[s * bs:(s + 1) * bs] + 1.0 for s in sel])
    return (x, sel, bs), expect


def _inputs_accumulate():
    x = np.arange(4 * 3 * 8 * 128, dtype=np.float32).reshape(4, 3, 8, 128)
    return (x,), x.sum(1).reshape(4 * 8, 128)


def _inputs_dma():
    x = np.arange(512 * 128, dtype=np.float32).reshape(512, 128)
    return (x, 128, 128), x[128:256]


PROBES: List[Tuple[str, str, Callable, Callable]] = [
    ("basic", "scripts/probe_pallas.py:30", scale, _inputs_basic),
    ("take_along_axis rows (axis 0)", "scripts/probe_pallas.py:40", row_gather,
     _inputs_rows),
    ("flat 1-D gather", "scripts/probe_pallas.py:58", flat_gather, _inputs_flat),
    ("take_along_axis lanes (axis 1)", "scripts/probe_pallas.py:74", lane_gather,
     _inputs_lanes),
    ("scalar-prefetch index_map", "scripts/probe_pallas.py:89", block_select,
     _inputs_select),
    ("grid accumulation", "scripts/probe_pallas.py:110", accumulate,
     _inputs_accumulate),
    ("manual HBM->VMEM DMA", "scripts/probe_pallas.py:130", bulk_copy, _inputs_dma),
]


def probe_args(builder, device) -> Tuple[tuple, np.ndarray]:
    """A probe's inputs on ``device`` (arrays to tensors) and its expectation."""
    args, expect = builder()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else a for a in args), expect


def run_probe(kernel, builder, device) -> Dict:
    """One probe: kernel output against the numpy expectation and, on the
    card, against the plain version (all values are small integers in f32,
    so every comparison is exact)."""
    args, expect = probe_args(builder, device)
    out = kernel(*args)
    if out.is_cuda:
        torch.cuda.synchronize()
    got = out.cpu().numpy()
    plain = PLAINS[kernel](*args).cpu().numpy()
    return dict(correct=bool(got.shape == expect.shape and np.array_equal(got, expect)),
                matches_plain=bool(np.array_equal(got, plain)),
                max_abs_err=float(np.abs(got - plain).max()) if got.shape == plain.shape
                else float("inf"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probes: torch.cuda.is_available() is false")
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    failed = 0
    for name, _, kernel, builder in PROBES:
        try:
            res = run_probe(kernel, builder, device)
            ok = res["correct"] and res["matches_plain"]
            print(f"[{'ok' if ok else 'FAIL'}]{'   ' if ok else ' '}{name}: "
                  f"correct={res['correct']} matches_plain={res['matches_plain']}")
        except Exception as e:   # report every probe, as the reference script does
            ok = False
            msg = (str(e).splitlines() or [repr(e)])[0][:160]
            print(f"[FAIL] {name}: {type(e).__name__}: {msg}")
        failed += not ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

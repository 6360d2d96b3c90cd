"""GPU smoke run of the PyTorch port (meshopticalflow_tpu_torch).

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA GPU, in phases;
any failure raises, so the run exits non-zero and prints no final ok line.

  1. the card's name and power limit; refuse to run without a GPU;
  2. build the five CUDA libraries from the checkout's sources (SpMV,
     probes, the geodesic march, the banded Cholesky, the vertex bake; one
     nvcc each, started together, with a sixth beside them: the march kernel's
     earlier design, march_sweep.py's "pr13" case, for phase 7m's
     comparison) and,
     beside them, the native host library
     (native/meshhost.cpp, g++) into meshopticalflow_tpu_torch/_build/; every
     texture draw below must rasterize with it (``init_profile``'s
     ``raster_path`` "native"), never with the numpy fallback;
  3. the probe path: the seven capability-probe kernels through their entry
     point (``python -m meshopticalflow_tpu_torch.kernels.probes``), then each
     against its plain version and the reference script's numpy expectation,
     with times, bounds and the one-call PyTorch yardstick; every probe is
     timed in turns with its yardstick (torch.mul, torch.gather, torch.take,
     torch.sum, a slice clone; block select, which has no one-call
     yardstick, with its plain version: an index_select and an add, with
     the index_select alone beside it), at the script's shapes and at a
     size where bytes set the time (LARGE_PROBES), with its launch plan,
     rate and bound share, and checked for exact equality with its plain
     version at both; the flat gather's ordering pass is held to its plain
     twin (a stable sort) at LARGE_PROBES, counted, and timed alone;
  4. the reference-binary goldens in float64 on the card: ref_vertex.ply
     and the five goldens of the other bases (Conformal, Connection in its
     three modes, divFree), ref_cube256.png through the CLI default
     (multigrid), and the same cube with ``use_multigrid=False``,
     ``--flowBackend xla``, ``flow_mg_levels=2``, ``mg_c1_bf16`` and
     ``--flowBackend mf``, so every solver stays gated; the TrackSequence CLI on a.ply b.ply with
     ``--composed`` (halfway_000.ply against ref_vertex.ply) and on the 256^2
     cube (halfway_000.png against ref_cube256.png); the spectrum (block
     Lanczos, the CUDA path) of the sphere subdivided twice against scipy's
     ARPACK, rtol 1e-5;
  5. the Jacobi-PCG path at full size (``use_multigrid=False``):
     tests/golden/cube.ply at the CLI's default edge length (393,216
     triangles) with the 256^2 golden textures upsampled 8x to 2048^2;
  6. the CLI default path at full width (multigrid): the cube subdivided to a
     24,576-triangle root by the port's own subdivide_tracked, written as a
     textured PLY, then CLI defaults (float32, 10 levels, edge length 0.006:
     393,216 fine triangles), from_texture_inputs -> run -> halfway_texture;
  6b. the Conformal (``--vfMode 1``) and Connection (``--vfMode 2``) bases
     at the multigrid cell's size, CLI defaults otherwise: no patch level,
     so the flow and smoothing solves are the two-level cycle, with a host
     coarse solve in every iteration; then the split of one two-level
     iteration (device work, the host round trip);
  6e. the multifrontal direct solve (``--flowBackend mf``) at the
     multigrid cell's size, after a draw with ``--flowBackend xla`` (the
     same three-level smoothing cycle, which mf takes as the reference
     does, with the three-level multigrid flow solve): the
     nested-dissection pack's seconds and stats, refinement rounds per
     level, whether a level took the shifted refactor or the multigrid
     fallback, one factorization and one solve of the last level's system
     (CUDA events), every level's flow_res within 10 x flow_refine_tol;
     then both problems' levels again from the initial state under torch's
     deterministic algorithms, the mf final alignment error within
     MF_ALIGNMENT_REL of the xla one's (the draws' distances, and the mf
     draw's to phase 6's, are recorded);
  6f. the halo-exchange flow solve (``--flowBackend halo``) at the
     multigrid cell's size under a DeviceGroup of world size 1: the RCM
     semiband and halo, flow iterations against the xla draw's, the levels'
     stages, the launches of the halo product's rectangular form (this
     rank's rows against x_ext = [left halo, own rows, right halo]), the
     bytes a product exchanges; then its levels again under deterministic
     algorithms, the final alignment error within HALO_ALIGNMENT_REL of
     phase 6e's xla run under them. Then the xla draw under the same
     group of one, where nothing is split (every row helper is the
     identity), its deterministic final alignment error held to phase
     6e's. Where the machine shows two or more GPUs, the halo solve also
     runs in 2 processes over NCCL against the world-size-1 solve; on one
     GPU the run says that it did not. ``python3 chip_smoke.py --nccl``
     runs, at 2 ranks and at every GPU of the host, that halo solve and
     the row-split xla draw at the multigrid cell's size (one process per
     GPU, each holding the ``pick`` row blocks of the smoothing
     operators, signals and flow basis operator) against rank 0's one-rank
     draw (drawn once, at 2 ranks): per rank its rows, peak memory, stage seconds, flow_iters, the
     bytes a product gathers and its launches per SpMV form; its
     deterministic final alignment error within SPLIT_ALIGNMENT_REL of one
     rank's, flow_iters within SPLIT_ITERS_SLACK, tfield equal on every
     rank;
  6c. the per-mesh init cache: the multigrid cell built twice in one
     process with the artifact cache on (a scratch $MESHFLOW_CACHE), at
     WARM_LEVELS levels under torch's deterministic algorithms: both
     init profiles, the second construction holding the first one's
     tensors and computing its tfield bit for bit; then tracking at full
     width: mA/mB upsampled to 2048^2 baked onto the cube by the
     SampleTextureToVertices CLI at its default edge length (393,216
     triangles, 196,610 vertices), then the vertex TrackSequence CLI over
     frames A, B, A with ``--composed`` at float32 CLI defaults, the cache
     on: per pair init (pair 2 warm) and level seconds, flow iterations
     and alignment error, the composed resample's seconds, SpMV launches
     per form;
  6d. the spectrum at demo scale: the Spectrum CLI (k = 20, float32, block
     Lanczos on the banded shift-invert solve) on the cube at --eLength
     0.018 (49,152 triangles, 73,728 Whitney unknowns): seconds by stage,
     restarts, inner trip count, sigma escalations, launches per form, one
     block-Lanczos step's device time against its issued time, and the
     eigenvalues against scipy's eigsh (sigma 1e-8) on the same host
     operators (max relative error <= 1e-3);
  6g. the viewer's live terminal path (viz/live.py) on the card with
     scripted key tokens, its frames into a file: view_flow steps two levels
     of the cube at --eLength 0.018 (2048^2 inputs), whose tfield must equal a
     run() of the same two levels bit for bit (both under deterministic
     algorithms), then view_spectrum pages phase 6d's fields; where
     matplotlib imports, both also export one PNG frame ('o');
  7. each SpMV kernel against its plain version at the operators of those
     problems (the f32 / bf16 / f64 flow and smoothing operators, the c1
     operator, the rectangular transfers P0 and P0^T of both hierarchies;
     the conformal and connection flow operators and their f32 transfers;
     the spectrum's S + sigma M at 1, 4 and 8 columns; the halo product's
     rows, whose times also go into main_path_halo.json; rank 0's rows of
     the f32 flow and smoothing operators at 2 and 4 ranks against every
     row of x, the row-split draw's products),
     with its launch plan, warm and cold-L2 times, the warm time with the
     scattered gather of x taken out (every slot of a row reading one x
     element), the byte bound (stored non-zeros only), cuSPARSE's time on
     the same operator, and the launches of its form (wrapper, value type,
     square or rectangular, slab or lane-group variant) in the draws of
     phases 5 to 6g; then the split of one
     multigrid PCG iteration, each part timed alone (the sweeps' share of
     the levels is timed inside phase 6's run);
  7m. each march kernel against its plain version at the main path's
     lanes: phase 6's level trace (786,432 barycentre lanes along its last
     tfield, float32 and float64) and halfway march (every texel lane of
     both 2048^2 textures), the init's exp remap of phase 6's texels, and
     phase 6c's composed Whitney marches; every lane's t and p equal bit for
     bit and the exhausted counts equal; lanes, lane-steps, warp-step slots
     and SIMT efficiency, the kernel's device time, the plain march's, the
     byte bound; march_field and march_whitney also timed in turns with PR
     13's design of their kernel (march_sweep.py's "pr13" case, built in
     phase 2 and held to the plain march too), which the shipped kernel
     must not trail at the level trace and the halfway;
  7b. band_factor and panel_sweep (csrc/banded.cu) against their plain
     twins at the main path's banded systems: the last level's flow c1
     (float32, float64, and bfloat16 panels into a float32 rhs), the
     smoothing c1 (float32, float64, 6 columns) and the spectrum's S +
     sigma M (float32, 4 columns): the solve panels each factor gives
     within BANDED_TOL (the factor blocks' own distance, and for float32
     each factor's distance to the float64 factor, recorded beside it),
     each float32 factor no more than BANDED_F32_FACTOR_VS_TWIN times as
     far from the float64 factor as the twin's, each sweep and the solve
     within BANDED_TOL, device times in turns with the twins, bounds from
     the work this input needs (the panels' and factor's non-zero
     entries), the panels' batched triangular inversion, one cuBLAS panel
     product as the yardstick, one grid barrier timed alone; then the last
     level's flow system solved through the kernels and through the twins
     (patched into solvers/mg.py), equal in iterations and within 1e-5;
     every draw records the banded launches and fails if a twin ran on
     CUDA tensors, and the multigrid, halo, spectrum and phase 4's
     multigrid draws fail without both banded kernels;
  7k. bake_vertices (csrc/bake.cu) on the main path's mesh (393,216
     triangles) at 2048^2 and 4096^2, bilinear and nearest: equal to the
     host copy (flow/pipeline.py:sample_texture_to_vertices) and to its
     plain twin bit for bit, timed warm beside its byte bound, the twin and
     the host copy (``python3 chip_smoke.py --bake`` runs this phase alone);
  8. the result lines.

Every phase that drives a path (3, 5, 6, 6b, 6e, 6f, 6c, 6d, 6g) sets the
launch counts to 0 just before it and reads them just after; phases 5 to 6g
print and record the SpMV launches per form, the march kernels'
launches (every draw that traces launches them, and no plain march runs on
CUDA tensors) and the banded kernels' launches. The draws of phases 5, 6, 6b,
6e, 6f and 6g run with the artifact cache off, so their init is cold as in
earlier records. The second-to-last line is a JSON record of the fifteen
kernels; the last line is {"ok": true, "device": {...}}. The full records
go to chiprun_out/chip_smoke/ (kernels.json, main_path_{jacobi,multigrid,
conformal,connection,xla,mf,halo,xla_group,warm_init,tracking,spectrum,
viewer}.json, nccl.json and ranks/ under --nccl,
the viewer's frames and exports under viewer/); the artifact
cache ($MESHFLOW_CACHE), the baked frames and the CLIs' outputs to a
scratch directory in the checkout that the run deletes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "golden")
WORK = os.path.join(REPO, "chiprun_out", "chip_smoke")
# max |kernel - plain| / max |plain| allowed per value type
KERNEL_TOL = {"float32": 1e-6, "bfloat16": 1e-6, "float64": 1e-12}
# Published H100 SXM peaks (NVIDIA data sheet; at the full 700 W limit):
# HBM3 rate; float32 outside the tensor cores (TF32 would round the
# operands), bf16 values widened to f32 before the FMA, as every kernel
# here computes them; float64 at the FP64 tensor-core rate, the card's
# fastest at full precision.
HBM_TB_S = 3.35
PEAK_TFLOP_S = {"float32": 67.0, "bfloat16": 67.0, "float64": 67.0}
MG_ROOT_FRACTION = 0.024       # root edge length: 24,576 triangles
# the mf run's final alignment error against the xla run's (the same
# pipeline but the flow solve, both under deterministic algorithms): the
# bound of tests/test_torch_multifrontal.py and tests/test_multifrontal.py
MF_ALIGNMENT_REL = 1e-5
# the halo run's final alignment error against the xla run's, both under
# deterministic algorithms: mf's bound, as both flow solves refine to
# flow_refine_tol; in float64 on the CPU the halo runs keep every level's
# alignment error within 1e-6 of the solo run's and the JAX package's
# (tests/test_torch_parallel.py, the production-run cases)
HALO_ALIGNMENT_REL = 1e-5
# the row-split xla run's (--nccl) final alignment error against one rank's,
# both under deterministic algorithms: the same bound, as the split solves
# refine to flow_refine_tol; its flow_iters within one PCG chunk (8) a level
SPLIT_ALIGNMENT_REL = 1e-5
SPLIT_ITERS_SLACK = 8
WARM_LEVELS = 3                # depth of the two warm-init constructions' runs
DEVICE = "cuda"


T_START = time.time()


def phase(n, msg: str) -> None:
    print(f"[phase {n} +{time.time() - T_START:.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# Timing and bounds
# ----------------------------------------------------------------------------

def issue_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back calls
    issued as a caller issues them: the larger of the host's time to issue a
    call and the device's time to run it."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


_CYCLES_PER_MS = []


def _device_sleep(ms: float) -> None:
    """Keep the device busy for at least about ``ms`` (torch.cuda._sleep,
    calibrated at the fastest of four 10^7-cycle sleeps: a card that idled,
    as through a build, runs the first at a low clock, and a rate taken
    there would make every later sleep too short to cover the host)."""
    import torch

    if not _CYCLES_PER_MS:
        rates = []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(10 ** 7)
            end.record()
            end.synchronize()
            rates.append(10 ** 7 / max(start.elapsed_time(end), 1e-3))
        _CYCLES_PER_MS.append(max(rates))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def median_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Device time per call: median over ``reps`` CUDA-event windows of
    ``inner`` back-to-back calls, each window queued behind a device sleep
    longer than the host needs to issue it, so the window times the device
    alone (operands that fit stay in L2 between the calls)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    cover_ms = 2e3 * max(host) * inner + 0.05
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _device_sleep(cover_ms)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


_FLUSH = []


def cold_ms(fn, reps: int = 15) -> float:
    """Median of single calls, each after 256 MB of writes that evict L2."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2 ** 20, dtype=torch.float32, device=DEVICE))
    fn()
    times = []
    for _ in range(reps):
        _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def copy_rate_tb_s(nbytes: int) -> float:
    """Device copy rate (bytes read + written per second, TB/s) of a buffer
    of ``nbytes``: 1 GB measures HBM, 16 MB an L2-resident pair."""
    import torch

    src = torch.ones(nbytes // 4, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src))
    return 2 * nbytes / (ms * 1e-3) / 1e12


def bound(nbytes: float, flops: float, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the HBM peak and
    operations over the peak rate of their type."""
    t_bytes = nbytes / (HBM_TB_S * 1e12) * 1e3
    t_ops = flops / (PEAK_TFLOP_S[dtype_name] * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rounded(profile: dict) -> dict:
    """An init profile for printing: seconds to 3 decimals, labels as they are."""
    return {k: round(v, 3) if isinstance(v, float) else v for k, v in profile.items()}


def launches_where(counts: dict, kernel=None, dtype=None, shape=None, variant=None) -> int:
    """SpMV launches of the forms that match (kernels/spmv.py:counts keys
    its ``by_form`` entries "wrapper/type/square|rectangular/slab|group")."""
    want = (kernel, dtype, shape, variant)
    return sum(v for k, v in counts["by_form"].items()
               if all(w is None or w == part for w, part in zip(want, k.split("/"))))


def reset_counts(spmv) -> None:
    """Zero the launch counts of the SpMV, march, banded and bake kernels
    and their plain versions' calls on CUDA tensors."""
    from meshopticalflow_tpu_torch.kernels import bake, banded, tracing

    spmv.reset_counts()
    tracing.reset_counts()
    banded.reset_counts()
    bake.reset_counts()


def launch_counts(spmv) -> dict:
    """kernels/spmv.py:counts, with kernels/tracing.py:counts (the march
    kernels' launches by kernel and by wrapper, the plain marches' calls on
    CUDA tensors) under "march" and kernels/banded.py:counts (panel_sweep
    and band_factor by form, the twins' calls on CUDA tensors) under
    "banded" and bake_vertices' launches under "bake"."""
    from meshopticalflow_tpu_torch.kernels import bake, banded, tracing

    out = spmv.counts()
    out["march"] = tracing.counts()
    out["banded"] = banded.counts()
    out["bake"] = bake.bake_vertices.launches
    return out


def check_banded_launches(tag: str, counts: dict, solves: bool = False) -> None:
    """No draw ran a banded twin on CUDA tensors; a draw that ``solves``
    through the banded factor launched both banded kernels."""
    b = counts["banded"]
    if b["plain_on_cuda"] != 0:
        raise RuntimeError(f"{tag}: a banded twin ran on CUDA tensors: {b}")
    if solves and (b["panel_sweep"] == 0 or b["band_factor"] == 0):
        raise RuntimeError(f"{tag}: the banded kernels were not launched: {b}")


def banded_line(counts: dict) -> str:
    b = counts["banded"]
    return (f"banded launches: band_factor {b['band_factor']}, panel_sweep "
            f"{b['panel_sweep']}, plain on CUDA {b['plain_on_cuda']}")


def check_march_launches(tag: str, counts: dict, traces: bool = True) -> None:
    """A draw that traces launched the march kernels; no draw ran a plain
    march on CUDA tensors."""
    march = counts["march"]
    if march["plain_on_cuda"] != 0:
        raise RuntimeError(f"{tag}: a plain march ran on CUDA tensors: {march}")
    if traces and march["march_field"] + march["march_whitney"] == 0:
        raise RuntimeError(f"{tag}: no march kernel was launched: {march}")


def march_line(counts: dict) -> str:
    m = counts["march"]
    return (f"march launches: march_field {m['march_field']}, march_whitney "
            f"{m['march_whitney']}, exp_map {m['exp_map']}, plain on CUDA {m['plain_on_cuda']}")


# ----------------------------------------------------------------------------
# Phase 3: the probe path
# ----------------------------------------------------------------------------

def _probe_need(name: str, args, out):
    """(bytes, operations) each probe's inputs need: the source elements it
    actually reads (a gather reads only the rows or blocks its indices
    name), its index arrays and its output."""
    import torch

    x = args[0]
    if name == "take_along_axis rows (axis 0)":
        read = int(torch.unique(args[1]).numel()) * x.shape[1] * 4 + _nbytes(args[1])
        return read + _nbytes(out), 0
    if name == "flat 1-D gather":
        return int(torch.unique(args[1]).numel()) * 4 + _nbytes(args[1], out), 0
    if name == "scalar-prefetch index_map":
        blocks = int(torch.unique(args[1]).numel())
        return blocks * args[2] * x.shape[1] * 4 + _nbytes(args[1], out), out.numel()
    if name == "grid accumulation":
        return _nbytes(x, out), x.numel() - out.numel()
    if name == "manual HBM->VMEM DMA":
        return 2 * _nbytes(out), 0
    if name == "basic":
        return _nbytes(x, out), x.numel()
    return _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], out), 0


def _probe_library(name: str, args):
    """One PyTorch call computing the probe's function, or None (block
    select needs an index_select and an add)."""
    import torch

    x = args[0]
    idx = args[1].long() if len(args) > 1 and isinstance(args[1], torch.Tensor) else None
    calls = {
        "basic": lambda: torch.mul(x, 2.0),
        "take_along_axis rows (axis 0)": lambda: torch.gather(x, 0, idx),
        "flat 1-D gather": lambda: torch.take(x, idx),
        "take_along_axis lanes (axis 1)": lambda: torch.gather(x, 1, idx),
        "grid accumulation": lambda: torch.sum(x, dim=1),
        "manual HBM->VMEM DMA": lambda: x[args[1]:args[1] + args[2]].clone(),
    }
    return calls.get(name)


SELECT = "scalar-prefetch index_map"
FLAT = "flat 1-D gather"


def _yardstick(probes, name: str, args):
    """(label, call) the probe is timed in turns with: its one-call library
    function, else its plain version (block select)."""
    lib = _probe_library(name, args)
    if lib is not None:
        return "library", lib
    plain = probes.PLAINS[next(p[2] for p in probes.PROBES if p[0] == name)]
    return "plain (two calls)", lambda: plain(*args)


# x's shape at the size where bytes, not the launch, set each probe's time
# (large_probe_args builds the operands on the card, the script's index
# patterns scaled up): 134 MB of x but for the accumulation's 101 MB.
# scale: 134 MB in, 134 MB out. Row gather: rows 3 i mod 262,144 of x for
# i < 131,072, broadcast over the 128 lanes (67 MB of x read, 67 MB of idx,
# 67 MB out). Flat gather: x[7 t mod n] for every t (134 MB each of x, idx,
# o). Lane gather: o[i, j] = x[i, 5 j mod 128] (134 MB each). Block select:
# 2,048 blocks of 128 rows, sel[i] = 3 i + 1 mod 2,048 for i < 1,024 (67 MB
# read, 67 MB out). Accumulation: (8,192, 3, 8, 128) -> (65,536, 128),
# 100.7 MB in and 33.6 MB out. Bulk copy: rows 65,536:196,608, 67 MB in and
# 67 MB out.
LARGE_PROBES = {"basic": (262144, 128),
                "take_along_axis rows (axis 0)": (262144, 128),
                "flat 1-D gather": (262144 * 128,),
                "take_along_axis lanes (axis 1)": (262144, 128),
                SELECT: (262144, 128),
                "grid accumulation": (8192, 3, 8, 128),
                "manual HBM->VMEM DMA": (262144, 128)}
TURN_ROUNDS = {"script": 5, "large": 2}


def in_turns(kernel_fn, library_fn, rounds: int):
    """Device medians (median_ms) of a kernel and its yardstick taken in
    turns, kernel, library, library, kernel, for ``rounds`` rounds, so the
    two are read on one card in one window: (kernel list, library list)."""
    k_ms, l_ms = [], []
    for _ in range(rounds):
        k_ms.append(median_ms(kernel_fn))
        l_ms += [median_ms(library_fn), median_ms(library_fn)]
        k_ms.append(median_ms(kernel_fn))
    return k_ms, l_ms


def _plan_of(probes, name: str, args) -> dict:
    """The launch plan the wrapper takes for these operands."""
    x = args[0]
    sms = probes.sm_count(x.device)
    if name == "grid accumulation":
        b, _, r, w = x.shape
        return dataclasses.asdict(probes.accumulate_plan(b, r * w, sms, probes._aligned(x)))
    if name == "manual HBM->VMEM DMA":
        return dataclasses.asdict(probes.bulk_copy_plan(args[2] * x.shape[1], sms))
    if name == SELECT:
        return dataclasses.asdict(probes.block_select_plan(
            args[1].shape[0], args[2] * x.shape[1], sms, probes._aligned(x)))
    if name == "take_along_axis rows (axis 0)":
        return dataclasses.asdict(probes.row_gather_plan(*args[1].shape, sms,
                                                         probes._aligned(*args)))
    if name == "basic":
        return dataclasses.asdict(probes.scale_plan(x.numel(), sms, probes._aligned(x)))
    if name == FLAT:
        return dataclasses.asdict(probes.flat_gather_plan(args[1].numel(), sms,
                                                          probes._aligned(args[1])))
    # the lane gather: one thread per output float in CTAs of 256
    # (csrc/probes.cu, kThreads)
    return dict(threads=256, grid=-(-x.numel() // 256))


def yardstick_turns(probes, name: str, kernel, args, size: str) -> dict:
    """A probe and its yardstick (_yardstick) in turns at ``args``: both
    medians and their spread, bytes and bound, the kernel's rate and bound
    share, and the plan the wrapper takes; for block select also the
    index_select alone (the copy's own time, not a yardstick)."""
    label, yard = _yardstick(probes, name, args)
    k_ms, l_ms = in_turns(lambda: kernel(*args), yard, TURN_ROUNDS[size])
    out = kernel(*args)
    nbytes, flops = _probe_need(name, args, out)
    b_ms, b_by = bound(nbytes, flops, "float32")
    ms, lib = float(np.median(k_ms)), float(np.median(l_ms))
    rec = dict(shape=list(args[0].shape), plan=_plan_of(probes, name, args), ms=ms,
               ms_spread=[min(k_ms), max(k_ms)], yardstick=label, library_ms=lib,
               library_ms_spread=[min(l_ms), max(l_ms)], bytes=nbytes, bound_ms=b_ms,
               bound_by=b_by, tb_s=nbytes / (ms * 1e-3) / 1e12, bound_share=b_ms / ms,
               library_tb_s=nbytes / (lib * 1e-3) / 1e12)
    copy = ""
    if name == SELECT:
        x, sel, rows = args
        blocks, index = x.view(-1, rows, x.shape[1]), sel.long()
        rec["index_select_ms"] = median_ms(lambda: blocks.index_select(0, index))
        copy = f", index_select alone {rec['index_select_ms'] * 1e3:.2f} us"
    phase(3, f"{name} ({kernel.__name__}) at {tuple(args[0].shape)}, in turns x"
             f"{TURN_ROUNDS[size]}: kernel {ms * 1e3:.2f} us "
             f"[{min(k_ms) * 1e3:.2f}-{max(k_ms) * 1e3:.2f}], {label} "
             f"{lib * 1e3:.2f} us [{min(l_ms) * 1e3:.2f}-{max(l_ms) * 1e3:.2f}]{copy}; "
             f"kernel <= {label}: {ms <= lib}; {rec['tb_s']:.3f} TB/s, bound "
             f"{b_ms * 1e3:.3f} us ({nbytes} B), bound share {rec['bound_share']:.3f}; "
             f"plan {rec['plan']}")
    return rec


def order_check(probes, idx) -> dict:
    """The flat gather's ordering pass at ``idx`` under the plan the wrapper
    takes: exactly equal to its plain twin (a stable torch.sort), and both
    timed in turns (the twin is no yardstick of the gather: it is the
    ordering alone)."""
    import torch

    plan = probes.flat_gather_plan(idx.numel(), probes.sm_count(idx.device),
                                   probes._aligned(idx))
    if not plan.ordered:
        return dict(ordered=False)
    got = probes.flat_gather_order(idx, plan.chunk, plan.n_chunks)
    want = probes.flat_gather_order_plain(idx, plan.chunk, plan.n_chunks)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"flat gather ordering pass at {tuple(idx.shape)}: differs from "
                           f"its plain twin at {int((got != want).sum())} of {plan.n_chunks}")
    k_ms, p_ms = in_turns(lambda: probes.flat_gather_order(idx, plan.chunk, plan.n_chunks),
                          lambda: probes.flat_gather_order_plain(idx, plan.chunk,
                                                                 plan.n_chunks),
                          TURN_ROUNDS["large"])
    rec = dict(ordered=True, n_chunks=plan.n_chunks, chunk=plan.chunk, exact=True,
               ms=float(np.median(k_ms)), ms_spread=[min(k_ms), max(k_ms)],
               plain_ms=float(np.median(p_ms)), plain_ms_spread=[min(p_ms), max(p_ms)])
    phase(3, f"flat gather ordering pass ({plan.n_chunks} chunks of {plan.chunk}): equal to "
             f"its twin; {rec['ms'] * 1e3:.2f} us [{min(k_ms) * 1e3:.2f}-"
             f"{max(k_ms) * 1e3:.2f}], stable torch.sort twin {rec['plain_ms'] * 1e3:.2f} us")
    return rec


def large_probe_args(name: str):
    """The byte-bound operands of LARGE_PROBES, made on the card: small
    integers in f32, so every sum is exact."""
    import torch

    shape = LARGE_PROBES[name]
    n = math.prod(shape)
    x = (torch.arange(n, dtype=torch.int32, device=DEVICE) % 251).to(torch.float32).view(shape)

    def pattern(count: int, mul: int, add: int, mod: int):
        t = torch.arange(count, dtype=torch.int64, device=DEVICE)
        return ((t * mul + add) % mod).to(torch.int32)

    if name == "take_along_axis rows (axis 0)":
        m = shape[0] // 2
        return x, pattern(m, 3, 0, shape[0])[:, None].expand(m, shape[1]).contiguous()
    if name == "flat 1-D gather":
        return x, pattern(n, 7, 0, n).view(-1, 128)
    if name == "take_along_axis lanes (axis 1)":
        return x, pattern(n, 5, 0, shape[1]).view(shape)
    if name == SELECT:
        rows = 128
        nblocks = shape[0] // rows
        return x, pattern(nblocks // 2, 3, 1, nblocks), rows
    if name == "manual HBM->VMEM DMA":
        return x, shape[0] // 4, shape[0] // 2
    return (x,)


def probe_phase(probes):
    """Phase 3: the probe entry point with counts from 0, then per-probe
    checks and times, in turns with the yardstick at the script's shapes
    and at LARGE_PROBES."""
    import torch

    probes.reset_counts()
    rc = probes.main([])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in probes.KERNELS}
    phase(3, f"probe entry point: exit status {rc}; launches {launches}")
    if rc != 0:
        raise RuntimeError("a probe kernel failed its check")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a probe kernel was not launched: {launches}")
    report = {}
    for name, ref, kernel, builder in probes.PROBES:
        res = probes.run_probe(kernel, builder, torch.device(DEVICE))
        if not (res["correct"] and res["matches_plain"]):
            raise RuntimeError(f"probe {name}: {res}")
        args, _ = probes.probe_args(builder, torch.device(DEVICE))
        plain = probes.PLAINS[kernel]
        out = kernel(*args)
        nbytes, flops = _probe_need(name, args, out)
        b_ms, b_by = bound(nbytes, flops, "float32")
        lib = _probe_library(name, args)
        rec = dict(replaces=ref, launches=launches[kernel.__name__],
                   max_abs_err=res["max_abs_err"], issue_ms=issue_ms(lambda: kernel(*args)),
                   plain_ms=median_ms(lambda: plain(*args)), bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes)
        rec["turns"] = yardstick_turns(probes, name, kernel, args, "script")
        rec.update(ms=rec["turns"]["ms"],
                   library_ms=None if lib is None else rec["turns"]["library_ms"])
        big = large_probe_args(name)
        orders = probes.flat_gather_order.launches
        got, want = kernel(*big), plain(*big)
        torch.cuda.synchronize()
        order_launches = probes.flat_gather_order.launches - orders
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"probe {name} at {LARGE_PROBES[name]}: kernel and plain "
                               f"differ by {err}")
        del got, want
        rec["large"] = dict(max_abs_err=err,
                            **yardstick_turns(probes, name, kernel, big, "large"))
        if name == FLAT:
            rec["large"]["order"] = dict(launches=order_launches, **order_check(probes, big[1]))
            if rec["large"]["order"]["ordered"] and order_launches != 1:
                raise RuntimeError(f"flat gather at {LARGE_PROBES[name]}: ordering pass "
                                   f"launched {order_launches} times, want 1")
        del big
        torch.cuda.empty_cache()
        report[kernel.__name__] = rec
        phase(3, f"{name} ({kernel.__name__}): matches plain and script; kernel "
                 f"{rec['ms'] * 1e3:.2f} us ({rec['issue_ms'] * 1e3:.2f} us issued back "
                 f"to back), plain {rec['plain_ms'] * 1e3:.2f} us, "
                 f"library {'n/a' if lib is None else f'{rec['library_ms'] * 1e3:.2f} us'}"
                 f", bound {b_ms * 1e3:.4f} us ({nbytes} B)")
    return report


# ----------------------------------------------------------------------------
# Phase 4: goldens
# ----------------------------------------------------------------------------

# The vertex goldens of the other bases and their largest allowed u8
# difference (tests/test_golden.py:48-72).
VERTEX_GOLDENS = ((["--vfMode", "1"], "ref_vertex_conformal.ply", 0),
                  (["--vfMode", "2"], "ref_vertex_connection.ply", 0),
                  (["--vfMode", "2", "--cMode", "1"], "ref_vertex_cmode1.ply", 1),
                  (["--vfMode", "2", "--cMode", "2"], "ref_vertex_cmode2.ply", 1),
                  (["--vfMode", "1", "--divFree"], "ref_vertex_divfree.ply", 1))
# (config changes, tag) of the 256^2 cube golden runs
CUBE_SOLVERS = (({}, "multigrid"), (dict(use_multigrid=False), "jacobi"),
                (dict(flow_backend="xla"), "xla"), (dict(flow_mg_levels=2), "2level"),
                (dict(mg_c1_bf16=True), "c1_bf16"), (dict(flow_backend="mf"), "mf"))


def vertex_blend(device, flags=()):
    """The per-vertex halfway blend (float64) of the a/b golden pair."""
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    cfg = config_from_args(build_parser().parse_args(
        ["--in", a, b, "--out", "unused.ply", "--dtype", "float64", *flags]))
    prob = FlowProblem.from_vertex_inputs(a, b, cfg, device=device)
    prob.run()
    tag = "_".join(flags).replace("-", "") or "whitney"
    prob.write_output(os.path.join(WORK, f"golden_vertex_{tag}_{device}.ply"))
    adv = prob.advected_vertex_colors()
    return (adv[0] + adv[1]) / 2.0


def check_vertex_goldens():
    """The five goldens of the other bases on the CPU and the card, at the
    JAX tests' thresholds; a channel whose CPU blend is within 1e-9 of an
    integer (a knife edge) may land one level lower on either device (the
    CPU run of the Connection golden has one such channel)."""
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh

    out = {}
    for flags, fixture, max_lvl in VERTEX_GOLDENS:
        ref = read_triangle_mesh(os.path.join(GOLD, fixture)).colors.astype(int)
        cpu = vertex_blend("cpu", flags)
        gpu = vertex_blend(DEVICE, flags)
        knife = np.abs(cpu - np.round(cpu)) < 1e-9
        rec = {}
        for where, blend in (("cpu", cpu), ("cuda", gpu)):
            diff = np.abs(np.clip(blend, 0, 255).astype(np.uint8).astype(int) - ref)
            off = diff > max_lvl
            rec[where] = dict(max_diff=int(diff.max()), off_at_knife_edges=int(off.sum()))
            if (diff > max_lvl + 1).any() or (off & ~knife).any():
                raise RuntimeError(f"{fixture} on {where}: max diff {int(diff.max())} "
                                   f"(allowed {max_lvl}) off the knife edges")
        rec["max_abs_cuda_minus_cpu"] = float(np.abs(gpu - cpu).max())
        out[fixture] = rec
        phase(4, f"{fixture} ({' '.join(flags)}): max u8 diff cpu {rec['cpu']['max_diff']}, "
                 f"cuda {rec['cuda']['max_diff']} (allowed {max_lvl}; knife-edge channels "
                 f"one lower: cpu {rec['cpu']['off_at_knife_edges']}, cuda "
                 f"{rec['cuda']['off_at_knife_edges']}); max |cuda - cpu| blend "
                 f"{rec['max_abs_cuda_minus_cpu']:.3e}")
    return out


def _texture_scores(path):
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    a = read_png_rgb(path).astype(float)
    b = read_png_rgb(os.path.join(GOLD, "ref_cube256.png")).astype(float)
    return (float(np.sqrt(((a - b) ** 2).mean())), float((a == b).all(-1).mean()),
            float((np.abs(a - b) <= 1).all(-1).mean()))


def check_tracker_goldens(spmv, cpu_blend):
    """Phase 4: the TrackSequence CLI in float64 on the card. Vertex mode on
    a.ply b.ply with --composed: halfway_000.ply against ref_vertex.ply at
    the vertex golden's gate (off by one only at the CPU blend's knife
    edges) and a finite composed resample; texture mode on the 256^2 cube:
    halfway_000.png at the ref_cube256 thresholds."""
    from meshopticalflow_tpu_torch.apps.track_sequence import main as track
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
    from meshopticalflow_tpu_torch.kernels import advect

    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    out = {}
    reset_counts(spmv)
    vdir = os.path.join(WORK, "track_vertex")
    if track(["--in", a, b, "--outDir", vdir, "--composed", "--dtype", "float64",
              "--device", DEVICE]) != 0:
        raise RuntimeError("vertex tracker CLI failed")
    counts = launch_counts(spmv)
    ref = read_triangle_mesh(os.path.join(GOLD, "ref_vertex.ply")).colors.astype(int)
    ours = read_triangle_mesh(os.path.join(vdir, "halfway_000.ply")).colors.astype(int)
    knife = np.abs(cpu_blend - np.round(cpu_blend)) < 1e-9
    off = ours != ref
    composed = read_triangle_mesh(os.path.join(vdir, "composed_resampled.ply")).colors
    if (np.abs(ours - ref) > 1).any() or (off & ~knife).any():
        raise RuntimeError("tracker halfway_000.ply differs from ref_vertex.ply off the "
                           "knife edges")
    if composed.shape != ref.shape or not np.isfinite(composed).all():
        raise RuntimeError(f"composed resample: {composed.shape}, finite "
                           f"{np.isfinite(composed).all()}")
    if counts["spmv_ell"] == 0 or counts["spmv_ell_multi"] == 0 or counts["plain_on_cuda"]:
        raise RuntimeError(f"vertex tracker did not go through the kernels: {counts}")
    check_banded_launches("vertex tracker", counts)
    out["vertex"] = dict(exact=int((~off).sum()), off_at_knife_edges=int(off.sum()),
                         launches=counts)
    phase(4, f"TrackSequence a b --composed: halfway_000.ply {int((~off).sum())}/{off.size} "
             f"channels exact, {int(off.sum())} off by one at knife edges; composed "
             f"resample finite; launches {counts}")
    reset_counts(spmv)
    tdir = os.path.join(WORK, "track_texture")
    t0 = time.time()
    if track(["--mesh", os.path.join(GOLD, "cube.ply"), "--in", os.path.join(GOLD, "mA.png"),
              os.path.join(GOLD, "mB.png"), "--outDir", tdir, "--eLength", "0.06",
              "--dtype", "float64", "--device", DEVICE]) != 0:
        raise RuntimeError("texture tracker CLI failed")
    secs = time.time() - t0
    counts = launch_counts(spmv)
    rmse, exact, within1 = _texture_scores(os.path.join(tdir, "halfway_000.png"))
    out["texture"] = dict(rmse=rmse, exact=exact, within1=within1, seconds=secs,
                          launches=counts)
    phase(4, f"TrackSequence cube256 mA mB: halfway_000.png rmse {rmse:.3f} (< 2.2), exact "
             f"{exact:.4f} (> 0.97), within1 {within1:.4f} (> 0.995), {secs:.1f} s")
    if not (rmse < 2.2 and exact > 0.97 and within1 > 0.995):
        raise RuntimeError("texture tracker outside the ref_cube256 thresholds on the card")
    if counts["spmv_ell"] == 0 or counts["spmv_ell_multi"] == 0 or counts["plain_on_cuda"]:
        raise RuntimeError(f"texture tracker did not go through the kernels: {counts}")
    check_banded_launches("texture tracker", counts)
    return out


def check_spectrum_golden(spmv):
    """Phase 4: compute_spectrum's CUDA path (block Lanczos on the banded
    shift-invert solve) in float64 on the sphere subdivided twice, k = 6,
    against ARPACK at rtol 1e-5."""
    import torch
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.models.base import build_basis
    from meshopticalflow_tpu_torch.ops.assemble import vector_field_mass_blocks
    from meshopticalflow_tpu_torch.solvers.lanczos import compute_spectrum
    from meshopticalflow_tpu_torch.utils.testing import arpack_spectrum, octa_sphere

    tris, verts = octa_sphere(2)
    mesh = build_mesh(tris, vertices=verts)
    host, basis = build_basis(mesh, FlowConfig(dtype="float64"), DEVICE)
    mass = torch.as_tensor(vector_field_mass_blocks(mesh)).to(DEVICE)
    reset_counts(spmv)
    stats = {}
    res = compute_spectrum(basis, mass, 6, cg_tol=1e-12, max_lanczos=min(host.n_coeffs, 600),
                           host_stepped=True, stats=stats)
    counts = launch_counts(spmv)
    oracle = arpack_spectrum(host, mesh, 6)
    rel = float(np.max(np.abs(res.eigenvalues - oracle) / np.abs(oracle)))
    phase(4, f"spectrum, sphere subdivided twice ({host.n_coeffs} unknowns), k 6, float64: "
             f"max rel err vs ARPACK {rel:.3e} (rtol 1e-5); restarts "
             f"{stats['restart_count']}, inner_iters {stats['packs'][-1]['inner_iters']}; "
             f"launches {counts}")
    if not rel <= 1e-5:
        raise RuntimeError(f"spectrum golden: max rel err {rel:.3e} > 1e-5")
    if counts["spmv_ell_multi"] == 0 or counts["plain_on_cuda"]:
        raise RuntimeError(f"spectrum did not go through the kernels: {counts}")
    check_banded_launches("spectrum golden", counts, solves=True)
    return dict(max_rel_err=rel, eigenvalues=res.eigenvalues.tolist(), oracle=oracle.tolist(),
                launches=counts, stats=stats)


def check_goldens(spmv):
    """Phase 4: the vertex and 256^2 texture goldens in float64 on the card.

    The vertex golden is truncated to u8 from float64 blends; where a blend
    is an integer to float64 precision (a knife edge), the card's other sum
    orders may land one ulp below it. The CPU run must reproduce the golden
    byte for byte; the card must match it on every channel that is not such
    a knife edge, and be within one level on those that are. The texture
    golden runs through the CLI default (multigrid) and through the library
    with use_multigrid=False (Jacobi-PCG), flow_backend "xla", flow_mg_levels
    2 and mg_c1_bf16; every multigrid run must reach the rectangular
    transfers, and the Jacobi run none."""
    from meshopticalflow_tpu_torch.apps.optical_flow import (
        build_parser, config_from_args, main as cli)
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh

    ref = read_triangle_mesh(os.path.join(GOLD, "ref_vertex.ply")).colors.astype(int)
    cpu = vertex_blend("cpu")
    reset_counts(spmv)
    gpu = vertex_blend(DEVICE)
    cpu_u8 = np.clip(cpu, 0, 255).astype(np.uint8).astype(int)
    gpu_u8 = np.clip(gpu, 0, 255).astype(np.uint8).astype(int)
    if not np.array_equal(cpu_u8, ref):
        raise RuntimeError("vertex golden differs on the CPU")
    knife = np.abs(cpu - np.round(cpu)) < 1e-9
    off = gpu_u8 != ref
    if (np.abs(gpu_u8 - ref) > 1).any() or (off & ~knife).any():
        raise RuntimeError("vertex golden differs on the card off the knife edges")
    phase(4, f"ref_vertex.ply: cpu byte-exact; cuda {int((~off).sum())}/{off.size} "
             f"channels exact, {int(off.sum())} off by one at knife edges "
             f"({int(knife.sum())} knife-edge channels); max |cuda - cpu| blend "
             f"{float(np.abs(gpu - cpu).max()):.3e}")
    argv = ["--mesh", os.path.join(GOLD, "cube.ply"), "--in", os.path.join(GOLD, "mA.png"),
            os.path.join(GOLD, "mB.png"), "--out", "", "--eLength", "0.06",
            "--dtype", "float64", "--device", DEVICE]
    out = {"vertex": check_vertex_goldens(), "tracker": check_tracker_goldens(spmv, cpu),
           "spectrum": check_spectrum_golden(spmv)}
    for changes, solver in CUBE_SOLVERS:
        path = os.path.join(WORK, f"golden_cube256_{solver}.png")
        argv[argv.index("--out") + 1] = path
        reset_counts(spmv)
        t0 = time.time()
        if solver == "multigrid":
            cli(argv)
        else:
            cfg = dataclasses.replace(config_from_args(build_parser().parse_args(argv)),
                                      **changes)
            prob = FlowProblem.from_texture_inputs(argv[1], (argv[3], argv[4]), cfg,
                                                   device=DEVICE)
            prob.run()
            prob.write_output(path)
        secs = time.time() - t0
        counts = launch_counts(spmv)
        rmse, exact, within1 = _texture_scores(path)
        out[solver] = dict(rmse=rmse, exact=exact, within1=within1, seconds=secs,
                           launches=counts)
        phase(4, f"ref_cube256.png ({solver}): rmse {rmse:.3f} (< 2.2), exact "
                 f"{exact:.4f} (> 0.97), within1 {within1:.4f} (> 0.995), {secs:.1f} s; "
                 f"launches {counts}")
        if not (rmse < 2.2 and exact > 0.97 and within1 > 0.995):
            raise RuntimeError(f"256^2 golden ({solver}) outside the thresholds on the card")
        if counts["spmv_ell"] == 0 or counts["spmv_ell_multi"] == 0 or counts["plain_on_cuda"]:
            raise RuntimeError(f"golden run ({solver}) did not go through the kernels: "
                               f"{counts}")
        if (launches_where(counts, shape="rectangular") > 0) != (solver != "jacobi"):
            raise RuntimeError(f"golden run ({solver}) took the wrong solver: {counts}")
        check_banded_launches(f"golden run ({solver})", counts,
                              solves=solver in ("multigrid", "c1_bf16"))
    return out


# ----------------------------------------------------------------------------
# Phases 5 and 6: the main paths at full size
# ----------------------------------------------------------------------------

def upsampled_inputs(factor: int = 8):
    """mA/mB upsampled by pixel repetition into the work directory."""
    from meshopticalflow_tpu_torch.io.png import read_png_rgb, write_png_rgb

    paths = []
    for name in ("mA.png", "mB.png"):
        img = read_png_rgb(os.path.join(GOLD, name))
        big = np.repeat(np.repeat(img, factor, axis=0), factor, axis=1)
        path = os.path.join(WORK, f"{name[:-4]}_{big.shape[0]}.png")
        write_png_rgb(path, big)
        paths.append(path)
    return paths, big.shape[0]


def write_mg_root(fraction: float = MG_ROOT_FRACTION) -> str:
    """The cube subdivided by the port's subdivide_tracked to a root of the
    demo mesh's kind (24,576 triangles at 0.024), written with its UVs."""
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_tracked
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh, write_ply_textured

    data = read_triangle_mesh(os.path.join(GOLD, "cube.ply"))
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts, uvs, _, _ = subdivide_tracked(data.faces, data.vertices, data.face_uvs,
                                               fraction * diag)
    path = os.path.join(WORK, f"cube_root_{len(tris)}.ply")
    write_ply_textured(path, verts, tris, uvs, fmt="binary")
    return path


LEVEL_KEYS = ("level", "smooth_seconds", "trace_seconds", "solve_seconds", "seconds",
              "flow_iters", "smooth_iters", "flow_res", "smooth_res", "alignment_error",
              "trace_exhausted")
MG_LEVEL_KEYS = ("coarse_factor_s", "smooth_factor_s", "flow_gb_per_iter",
                 "smooth_gb_per_iter")


@contextlib.contextmanager
def timed_sweeps(spans: list):
    """Time every exact c1 solve (solvers.mg._inner1_exact: both banded
    sweeps) while the block runs: a CUDA event pair around each call, read
    after the block, so the run gains no host synchronization. Each span runs
    from the device reaching the call's first operation to its last one
    finishing, host issue gaps included."""
    import torch
    from meshopticalflow_tpu_torch.solvers import mg

    real = mg._inner1_exact

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        spans.append((start, end))
        return out

    mg._inner1_exact = timed
    try:
        yield
    finally:
        mg._inner1_exact = real


def drive(spmv, mesh, paths, size, cfg, tag: str, n: int,
          during_run=contextlib.nullcontext, device_group=None):
    """One draw through the user's entry points (from_texture_inputs -> run
    -> halfway_texture) with the launch counts set to 0 just before it and
    read just after; ``during_run()`` is entered around ``run``. The
    artifact cache is off: the init is cold. ``device_group`` runs the
    problem as a rank of that group. Returns (problem, record)."""
    import torch
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.io.png import write_png_rgb
    from meshopticalflow_tpu_torch.utils import spans

    cfg = dataclasses.replace(cfg, artifact_cache=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(spmv)
    t0 = time.time()
    prob = FlowProblem.from_texture_inputs(mesh, tuple(paths), cfg, device=DEVICE,
                                           device_group=device_group)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    t0 = time.time()
    with during_run():
        res = prob.run()
    torch.cuda.synchronize()
    run_s = time.time() - t0
    exhausted = spans.counter("halfway.exhausted_lanes")
    t0 = time.time()
    blend = prob.halfway_texture()
    out_s = time.time() - t0
    exhausted = spans.counter("halfway.exhausted_lanes") - exhausted
    counts = launch_counts(spmv)
    write_png_rgb(os.path.join(WORK, f"halfway_{tag}_{size}.png"), np.flipud(blend))
    total_s = init_s + run_s + out_s
    keys = LEVEL_KEYS + (MG_LEVEL_KEYS if prob.hier is not None else ()) \
        + (("mf_fallback",) if prob.nd is not None else ())
    rec = dict(triangles=prob.mesh.n_triangles, vertices=prob.mesh.n_vertices,
               flow_unknowns=prob.arrays.basis.n_coeffs,
               flow_ell_width=prob.arrays.basis.ell_width,
               smooth_ell_width=int(prob.arrays.smooth_ops.cols.shape[1]),
               atlas=size, texel_lanes=2 * size * size,
               init_s=init_s, levels_s=run_s, advect_s=out_s, total_s=total_s,
               e2e_texels_per_sec=size * size / total_s,
               init_profile=prob.init_profile,
               levels=[{k: m[k] for k in keys} for m in res.metrics],
               halfway_exhausted=exhausted,
               launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    hier = prob.hier
    if hier is not None:
        rec["hierarchy"] = dict(
            flow_kind=hier.flow_kind, smooth_kind=hier.smooth_kind,
            c1_unknowns=hier.coarse.coarse_dev.n_coeffs,
            c1_ell_width=hier.coarse.coarse_dev.ell_width,
            vertex_coarse_unknowns=int(hier.vcoarse.cols0.shape[0]))
        for key, t in (("p0", hier.coarse.transfer), ("vertex_p0", hier.vcoarse.transfer)):
            if t is not None:
                rec["hierarchy"][key + "_width"] = int(t.p.cols.shape[1])
                rec["hierarchy"][key + "t_width"] = int(t.pt.cols.shape[1])
    if hier is not None and hier.flow_kind == "mg3":
        fpack, vpack = prob.hier.patch.mg_pack, prob.hier.vcoarse.mg_pack
        rec["mg"] = dict(
            c1_unknowns=fpack.n1, vertex_coarse_unknowns=vpack.n1,
            patch_unknowns=fpack.n2, vertex_patch_unknowns=vpack.n2,
            flow_pack=fpack.stats, smooth_pack=vpack.stats,
            flow_band=dict(bw=prob.hier.patch.c1_band.bw, m=prob.hier.patch.c1_band.m),
            smooth_band=dict(bw=prob.hier.vcoarse.c1_band.bw,
                             m=prob.hier.vcoarse.c1_band.m))
    with open(os.path.join(WORK, f"main_path_{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    for m in rec["levels"]:
        extra = ""
        if prob.hier is not None:
            extra = (", c1 factor {coarse_factor_s:.3f} s (smoothing {smooth_factor_s:.3f} s),"
                     " flow {flow_gb_per_iter:.4f} GB/iter, smoothing "
                     "{smooth_gb_per_iter:.4f} GB/iter").format(**m)
        phase(n, ("level {level}: smooth {smooth_seconds:.3f} s, trace "
                  "{trace_seconds:.3f} s, solve {solve_seconds:.3f} s, flow_iters "
                  "{flow_iters:.0f}, smooth_iters {smooth_iters:.0f}, flow_res "
                  "{flow_res:.3e}, alignment_error {alignment_error:.6f}").format(**m) + extra)
    phase(n, f"{rec['triangles']} triangles, {rec['flow_unknowns']} flow unknowns "
             f"(ELL width {rec['flow_ell_width']}), {size}^2 atlas: init {init_s:.2f} s, "
             f"levels {run_s:.2f} s, halfway {out_s:.2f} s, e2e "
             f"{rec['e2e_texels_per_sec']:.1f} texels/s; peak {rec['peak_mem_gb']:.2f} GB")
    phase(n, "init profile " + json.dumps(rounded(prob.init_profile)))
    phase(n, f"raster {prob.init_profile['raster']:.3f} s by the "
             f"{prob.init_profile['raster_path']} rasterizer")
    phase(n, f"launches: spmv_ell {counts['spmv_ell']}, spmv_ell_multi "
             f"{counts['spmv_ell_multi']}, plain on CUDA {counts['plain_on_cuda']}")
    for form, k in counts["by_form"].items():
        phase(n, f"launches of {form}: {k}")
    phase(n, march_line(counts))
    phase(n, banded_line(counts))
    if hier is not None:
        phase(n, f"hierarchy {json.dumps(rec['hierarchy'])}")
    if "mg" in rec:
        phase(n, f"multigrid pack {json.dumps(rec['mg'])}")
    metrics = [v for m in rec["levels"] for k, v in m.items() if k != "level"]
    metrics += [init_s, run_s, out_s]
    if not all(math.isfinite(float(v)) for v in metrics):
        raise RuntimeError(f"{tag}: non-finite metric on the main path")
    if len(rec["levels"]) != cfg.levels:
        raise RuntimeError(f"{tag}: ran {len(rec['levels'])} levels, expected {cfg.levels}")
    if counts["plain_on_cuda"] != 0:
        raise RuntimeError(f"{tag}: a plain version ran on CUDA tensors: {counts}")
    check_march_launches(tag, counts)
    check_banded_launches(tag, counts)
    if counts["march"]["exp_map"] == 0:
        raise RuntimeError(f"{tag}: the init's exp remap launched no exp_map kernel")
    if prob.init_profile["raster_path"] != "native":
        raise RuntimeError(f"{tag}: the texel table came from the "
                           f"{prob.init_profile['raster_path']} rasterizer, not the native one")
    if blend.shape != (size, size, 3) or blend.dtype != np.uint8:
        raise RuntimeError(f"{tag}: halfway texture has shape {blend.shape} {blend.dtype}")
    return prob, rec


def jacobi_path(spmv, paths, size, levels: int):
    """Phase 5: the Jacobi-PCG path (use_multigrid=False) at full size."""
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args

    mesh = os.path.join(GOLD, "cube.ply")
    cfg = dataclasses.replace(config_from_args(build_parser().parse_args(
        ["--mesh", mesh, "--in", *paths, "--out", "unused.png",
         "--iterations", str(levels)])), use_multigrid=False)
    prob, rec = drive(spmv, mesh, paths, size, cfg, "jacobi", 5)
    counts = rec["launches"]
    if counts["spmv_ell"] == 0 or counts["spmv_ell_multi"] == 0:
        raise RuntimeError(f"jacobi: a kernel was not launched: {counts}")
    if (prob.hier is not None or launches_where(counts, shape="rectangular")
            or launches_where(counts, dtype="bf16")):
        raise RuntimeError(f"jacobi: the multigrid path ran: {counts}")
    return rec


def multigrid_path(spmv, root, paths, size):
    """Phase 6: the CLI default (multigrid) at full width."""
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(
        ["--mesh", root, "--in", *paths, "--out", "unused.png"]))
    import torch

    if not cfg.use_multigrid:
        raise RuntimeError("the CLI default is not the multigrid configuration")
    spans = []
    prob, rec = drive(spmv, root, paths, size, cfg, "multigrid", 6,
                      lambda: timed_sweeps(spans))
    torch.cuda.synchronize()
    sweeps_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    rec["sweeps"] = dict(c1_solves=len(spans), seconds=sweeps_s,
                         share_of_levels=sweeps_s / rec["levels_s"])
    phase(6, f"exact c1 solves (two banded sweeps each) timed in this run: {len(spans)} "
             f"calls, {sweeps_s:.3f} s of the levels' {rec['levels_s']:.3f} s "
             f"({100 * rec['sweeps']['share_of_levels']:.1f} %)")
    counts = rec["launches"]
    for form in (dict(kernel="spmv_ell", dtype="f32", shape="square"), dict(dtype="bf16"),
                 dict(shape="rectangular"), dict(kernel="spmv_ell_multi"),
                 dict(variant="slab"), dict(variant="group")):
        if launches_where(counts, **form) == 0:
            raise RuntimeError(f"multigrid: no {form} launches on the main path: {counts}")
    check_banded_launches("multigrid", counts, solves=True)
    phase(6, "flow_iters per level " + ", ".join(f"{m['flow_iters']:.0f}"
                                                  for m in rec["levels"]))
    if prob.hier is None:
        raise RuntimeError("multigrid: no hierarchy was built")
    worst = max(m["flow_res"] for m in rec["levels"])
    if worst > 10 * cfg.flow_refine_tol:
        raise RuntimeError(f"multigrid: a level's flow_res {worst:.3e} is above "
                           f"10 x flow_refine_tol")
    return prob, rec


# Bases whose two-level flow cycle misses flow_refine_tol at CLI defaults
# in the JAX package as in the port, measured on the CPU; their draws record
# the misses instead of failing on them (every value must still be finite).
# Conformal, float32: the coarse system is singular (constant potentials)
# and its 1e-12 * max|diag| Tikhonov guard leaves the float32 rounding of the
# restricted residual's null-space part amplified ~1e12, so the inner solve
# diverges and refinement keeps x = 0: flow_res 1.0 at every level (cube root
# of 1,536 triangles subdivided to 24,576, mA/mB, 4 levels: JAX 1.0, 1.0,
# 1.0, 0.90; the port 1.0 at all four).
FLOW_RES_MISS_OF_THE_METHOD = ("conformal",)


def twolevel_path(spmv, root, paths, size, vf_mode: int, tag: str):
    """Phase 6b: one non-Whitney basis at the multigrid cell's size, CLI
    defaults otherwise (float32, 10 levels): the two-level cycle for the
    flow and the smoothing solves."""
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(
        ["--mesh", root, "--in", *paths, "--out", "unused.png", "--vfMode", str(vf_mode)]))
    prob, rec = drive(spmv, root, paths, size, cfg, tag, "6b")
    counts = rec["launches"]
    if (prob.hier is None or prob.hier.patch is not None
            or (prob.hier.flow_kind, prob.hier.smooth_kind) != ("twolevel", "twolevel")):
        raise RuntimeError(f"{tag}: not the two-level hierarchy")
    for form in (dict(kernel="spmv_ell", dtype="f32", shape="square"),
                 dict(kernel="spmv_ell", dtype="f32", shape="rectangular"),
                 dict(kernel="spmv_ell_multi", dtype="f32", shape="square"),
                 dict(kernel="spmv_ell_multi", dtype="f32", shape="rectangular")):
        if launches_where(counts, **form) == 0:
            raise RuntimeError(f"{tag}: no {form} launches on the path: {counts}")
    if launches_where(counts, dtype="bf16"):
        raise RuntimeError(f"{tag}: the two-level cycle streamed bf16 values: {counts}")
    limit = 10 * cfg.flow_refine_tol
    misses = [m["level"] for m in rec["levels"] if not m["flow_res"] <= limit]
    rec["flow_res_misses"] = misses
    phase("6b", f"{tag}: flow_iters per level "
                + ", ".join(f"{m['flow_iters']:.0f}" for m in rec["levels"])
                + "; levels above 10 x flow_refine_tol: " + (str(misses) if misses else "none"))
    if misses and tag not in FLOW_RES_MISS_OF_THE_METHOD:
        raise RuntimeError(f"{tag}: levels {misses} end above 10 x flow_refine_tol")
    rec["split"] = twolevel_split(prob, tag)
    with open(os.path.join(WORK, f"main_path_{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return prob, rec


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms for the block: the accumulating
    scatters (index_add_, index_put_) otherwise sum in no fixed order on
    CUDA, which moves a float32 draw's final alignment error by a few 1e-6
    relative from one run to the next."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def mf_path(spmv, root, paths, size, mg_rec):
    """Phase 6e: the multigrid cell's size, CLI defaults otherwise, with
    --flowBackend xla (the three-level multigrid cycle for the flow and the
    smoothing solves), then with --flowBackend mf (the multifrontal direct
    flow solve, the same three-level smoothing cycle); then one
    factorization and one solve of the final state's level system, timed
    alone. Then both problems run their ten levels again from the initial
    state under torch's deterministic algorithms, so that what tells them
    apart is the flow solve and not the order of atomic sums: the mf
    run's final alignment error is held to the xla run's (the draws'
    distance, and the mf draw's to phase 6's, whose smoothing is the
    Hopper-kernel cycle, are recorded). Returns the two records."""
    import torch
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.ops.ell import ell_matvec
    from meshopticalflow_tpu_torch.solvers.multifrontal import _factor, _solve

    def config(backend):
        return config_from_args(build_parser().parse_args(
            ["--mesh", root, "--in", *paths, "--out", "unused.png", "--flowBackend", backend]))

    cfg = config("mf")
    xla_prob, xla_rec = drive(spmv, root, paths, size, config("xla"), "xla", "6e")
    prob, rec = drive(spmv, root, paths, size, cfg, "mf", "6e")
    _check_draw("xla", xla_rec["launches"], [xla_rec["init_s"], xla_rec["levels_s"]])
    counts = rec["launches"]
    _check_draw("mf", counts, [rec["init_s"], rec["levels_s"]])
    if prob.nd is None or (prob.hier.flow_kind, prob.hier.smooth_kind) != ("xla", "xla"):
        raise RuntimeError("mf: no multifrontal context, or not the three-level cycles")
    if launches_where(counts, dtype="bf16"):
        raise RuntimeError(f"mf: the Hopper multigrid cycle ran: {counts}")
    pack = prob.nd.pack
    fronts = [dict(fronts=int(d.rows.shape[0]), epad=d.epad, bpad=d.bpad)
              for d in pack.levels]
    system = _final_systems(prob)
    levels, vals, rhs = prob.nd.levels_dev, system["sys_vals"], system["rhs"]
    factors = _factor(levels, vals)
    x = _solve(levels, factors, rhs)
    r = rhs.double() - ell_matvec(prob.arrays.basis.ell_cols, vals.double(), x.double())
    solve_rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(rhs.double()))
    timing = dict(
        factor_device_ms=median_ms(lambda: _factor(levels, vals), reps=5, inner=1),
        factor_issued_ms=issue_ms(lambda: _factor(levels, vals), reps=5, inner=1),
        solve_device_ms=median_ms(lambda: _solve(levels, factors, rhs), reps=9, inner=1),
        solve_issued_ms=issue_ms(lambda: _solve(levels, factors, rhs), reps=9, inner=1))
    del factors
    deterministic = {}
    with deterministic_algorithms():
        for tag, p in (("xla", xla_prob), ("mf", prob)):
            p.coeffs, p.tfield = torch.zeros_like(p.coeffs), torch.zeros_like(p.tfield)
            p._warm_x = None
            deterministic[tag] = p.run().metrics[-1]["alignment_error"]
    del xla_prob
    fallbacks = [int(m["mf_fallback"]) for m in rec["levels"]]
    ref, final = deterministic["xla"], deterministic["mf"]
    mg = mg_rec["levels"][-1]["alignment_error"]
    draw, xla_draw = rec["levels"][-1]["alignment_error"], xla_rec["levels"][-1]["alignment_error"]
    rec.update(nd=dict(nd_pack_s=prob.init_profile["nd_pack"], stats=pack.stats,
                       fronts=fronts, unknowns=pack.n, ell_width=pack.w,
                       last_system_rel_residual_one_solve=solve_rel, **timing),
               mf_fallback=fallbacks, final_alignment_error=draw,
               xla_final_alignment_error=xla_draw, multigrid_final_alignment_error=mg,
               deterministic_final_alignment_error=deterministic,
               alignment_rel_to_xla=abs(final - ref) / abs(ref),
               draw_alignment_rel_to_xla=abs(draw - xla_draw) / abs(xla_draw),
               alignment_rel_to_multigrid=abs(draw - mg) / abs(mg),
               xla_levels_s=xla_rec["levels_s"],
               xla_flow_iters=[m["flow_iters"] for m in xla_rec["levels"]])
    with open(os.path.join(WORK, "main_path_mf.json"), "w") as f:
        json.dump(rec, f, indent=1)
    phase("6e", f"nd pack {prob.init_profile['nd_pack']:.2f} s: {json.dumps(pack.stats)}, "
                f"{sum(d['fronts'] for d in fronts)} fronts, largest "
                f"{max(d['epad'] + d['bpad'] for d in fronts)} rows, per depth (fronts, epad, "
                f"bpad) " + ", ".join(f"({d['fronts']}, {d['epad']}, {d['bpad']})"
                                      for d in fronts))
    phase("6e", "one factorization {factor_device_ms:.3f} ms of device time, issued in "
                "{factor_issued_ms:.3f} ms; one solve {solve_device_ms:.3f} ms, issued in "
                "{solve_issued_ms:.3f} ms".format(**timing)
                + f"; one solve's relative residual {solve_rel:.3e} (float32 factor)")
    phase("6e", "refinement rounds per level " + ", ".join(
        f"{m['flow_iters']:.0f}" for m in rec["levels"]) + "; fallback per level (0 direct, "
        "1 shifted refactor, 2 multigrid) " + ", ".join(map(str, fallbacks)))
    phase("6e", f"final alignment error {draw:.6f}; xla draw {xla_draw:.6f}: relative "
                f"difference {rec['draw_alignment_rel_to_xla']:.3e}; phase 6's draw "
                f"{mg:.6f}: {rec['alignment_rel_to_multigrid']:.3e}")
    phase("6e", f"the levels again under deterministic algorithms: mf {final:.6f}, xla "
                f"{ref:.6f}: relative difference {rec['alignment_rel_to_xla']:.3e} "
                f"(<= {MF_ALIGNMENT_REL})")
    for tag, r in (("xla", xla_rec), ("mf", rec)):
        worst = max(m["flow_res"] for m in r["levels"])
        if worst > 10 * cfg.flow_refine_tol:
            raise RuntimeError(f"{tag}: a level's flow_res {worst:.3e} is above 10 x "
                               f"flow_refine_tol")
    if not rec["alignment_rel_to_xla"] <= MF_ALIGNMENT_REL:
        raise RuntimeError(f"mf: final alignment error {final} differs from the xla "
                           f"run's {ref} by more than {MF_ALIGNMENT_REL} relative")
    return xla_rec, rec


# ----------------------------------------------------------------------------
# Phase 6f: the halo-exchange flow solve; phase 6g: the viewer
# ----------------------------------------------------------------------------

def _halo_layout(prob):
    """The cached halo layout of ``prob``'s flow pattern, with the last
    level's values (parallel/halo.py's static-layout cache)."""
    from meshopticalflow_tpu_torch.parallel import halo

    cols = prob.arrays.basis.ell_cols
    for ent in halo._FLOW_HALO_CACHE.values():
        if ent["ref"]() is cols:
            return ent["h"]
    raise RuntimeError("halo: the flow solve built no halo layout")


def halo_operator(h):
    """Phase 7's halo form: this rank's rows against x_ext = [left halo, own
    rows, right halo], as one product of the halo solve runs it."""
    import torch

    xp = _rand(h.block)
    return ("spmv_ell", "halo rows", h.cols_local, h.vals_p,
            torch.cat([xp[-h.halo:], xp, xp[:h.halo]]))


def halo_path(spmv, root, paths, size, xla_rec, mf_rec):
    """Phase 6f: the multigrid cell's size, CLI defaults otherwise, with
    --flowBackend halo under a DeviceGroup of world size 1 (the card this
    run has): the flow solve is the halo-exchange two-level cycle of
    parallel/halo.py (its halos copies on the device, the neighbour pairs
    0 -> 0), the smoothing the three-level cycle phase 6e's xla draw runs.
    Then its ten levels again from the initial state under deterministic
    algorithms: the final alignment error is held to phase 6e's xla run
    under them within HALO_ALIGNMENT_REL."""
    import torch
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.parallel import halo
    from meshopticalflow_tpu_torch.parallel.distributed import global_device_group

    cfg = config_from_args(build_parser().parse_args(
        ["--mesh", root, "--in", *paths, "--out", "unused.png", "--flowBackend", "halo"]))
    group = global_device_group(DEVICE)
    if group.world_size != 1 or group.group is not None:
        raise RuntimeError(f"halo: expected world size 1 without a process group: {group}")
    halo._FLOW_HALO_CACHE.clear()
    prob, rec = drive(spmv, root, paths, size, cfg, "halo", "6f", device_group=group)
    counts = rec["launches"]
    _check_draw("halo", counts, [rec["init_s"], rec["levels_s"]])
    check_banded_launches("halo", counts, solves=True)
    if (prob.config.flow_backend, prob.hier.flow_kind, prob.hier.smooth_kind) != (
            "halo", "xla", "xla"):
        raise RuntimeError("halo: not the halo flow solve over the three-level smoothing")
    halo_form = "spmv_ell/f32/rectangular/slab"
    if counts["by_form"].get(halo_form, 0) == 0 or launches_where(counts, dtype="bf16"):
        raise RuntimeError(f"halo: no launches of the halo form, or the Hopper cycle ran: "
                           f"{counts}")
    h = _halo_layout(prob)
    elem = h.vals_p.element_size()
    deterministic = {}
    with deterministic_algorithms():
        prob.coeffs = torch.zeros_like(prob.coeffs)
        prob.tfield = torch.zeros_like(prob.tfield)
        t0 = time.time()
        deterministic["halo"] = prob.run().metrics[-1]["alignment_error"]
        deterministic["halo_levels_s"] = time.time() - t0
    deterministic["xla"] = mf_rec["deterministic_final_alignment_error"]["xla"]
    rel = abs(deterministic["halo"] - deterministic["xla"]) / abs(deterministic["xla"])
    levels = rec["levels"]
    rec.update(
        layout=dict(unknowns=h.n, ell_width=int(h.cols_local.shape[1]), semiband=h.halo,
                    halo=h.halo, block=h.block, x_ext_rows=h.block + 2 * h.halo,
                    world_size=group.world_size,
                    bytes_exchanged_per_matvec=h.bytes_exchanged,
                    bytes_sent_per_rank_per_matvec_at_two_or_more_ranks=2 * h.halo * elem),
        halo_form=halo_form, halo_form_launches=counts["by_form"][halo_form],
        flow_iters=[m["flow_iters"] for m in levels],
        xla_flow_iters=[m["flow_iters"] for m in xla_rec["levels"]],
        stage_s={k: sum(m[k + "_seconds"] for m in levels)
                 for k in ("smooth", "trace", "solve")},
        final_alignment_error=levels[-1]["alignment_error"],
        xla_final_alignment_error=xla_rec["levels"][-1]["alignment_error"],
        deterministic_final_alignment_error=deterministic, alignment_rel_to_xla=rel,
        nccl="not run: one process, world size 1")
    with open(os.path.join(WORK, "main_path_halo.json"), "w") as f:
        json.dump(rec, f, indent=1)
    lay = rec["layout"]
    phase("6f", f"halo layout: {lay['unknowns']} unknowns, RCM semiband {lay['semiband']}, "
                f"halo {lay['halo']} rows a side, block {lay['block']} rows, x_ext "
                f"{lay['x_ext_rows']} rows; bytes exchanged a product at world size 1: "
                f"{lay['bytes_exchanged_per_matvec']} (halos copied on the device); at two "
                f"or more ranks each rank would send "
                f"{lay['bytes_sent_per_rank_per_matvec_at_two_or_more_ranks']} B a product")
    phase("6f", "flow_iters per level: halo " + ", ".join(
        f"{i:.0f}" for i in rec["flow_iters"]) + "; xla " + ", ".join(
        f"{i:.0f}" for i in rec["xla_flow_iters"]))
    phase("6f", "levels {levels_s:.2f} s (smooth {smooth:.2f} / trace {trace:.2f} / solve "
                "{solve:.2f}), init {init_s:.2f} s, halfway {advect_s:.2f} s".format(
                    levels_s=rec["levels_s"], init_s=rec["init_s"], advect_s=rec["advect_s"],
                    **rec["stage_s"]))
    phase("6f", f"the halo form {halo_form} launched {rec['halo_form_launches']} times")
    phase("6f", f"final alignment error {rec['final_alignment_error']:.6f}; xla draw "
                f"{rec['xla_final_alignment_error']:.6f}; under deterministic algorithms halo "
                f"{deterministic['halo']:.6f}, xla {deterministic['xla']:.6f}: relative "
                f"difference {rel:.3e} (<= {HALO_ALIGNMENT_REL})")
    worst = max(m["flow_res"] for m in levels)
    if worst > 10 * cfg.flow_refine_tol:
        raise RuntimeError(f"halo: a level's flow_res {worst:.3e} is above 10 x "
                           f"flow_refine_tol")
    if not rel <= HALO_ALIGNMENT_REL:
        raise RuntimeError(f"halo: final alignment error {deterministic['halo']} differs "
                           f"from the xla run's {deterministic['xla']} by more than "
                           f"{HALO_ALIGNMENT_REL} relative")
    return prob, rec


def record_halo_form(spmv_report, rec: dict) -> None:
    """Phase 7's times of the halo form beside the square flow form's, into
    phase 6f's record (main_path_halo.json)."""
    def row(op):
        return next(r for r in spmv_report if r["name"] == "spmv_ell"
                    and r["operator"] == op and r["dtype"] == "float32")

    halo_row, flow = row("halo rows"), row("flow")
    rec["halo_form_timing"] = {k: halo_row[k] for k in (
        "ms", "ms_cold", "ms_local_gather", "issue_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "max_abs_err", "plan")}
    rec["flow_form_ms"] = flow["ms"]
    with open(os.path.join(WORK, "main_path_halo.json"), "w") as f:
        json.dump(rec, f, indent=1)
    phase(7, f"the halo form {halo_row['ms'] * 1e3:.2f} us warm against its "
             f"{halo_row['bound_ms'] * 1e3:.2f} us bound; the square flow form "
             f"{flow['ms'] * 1e3:.2f} us")


def _deterministic_final(prob) -> float:
    """The problem's levels again from the initial state under deterministic
    algorithms; the final level's alignment error."""
    import torch

    with deterministic_algorithms():
        prob.coeffs = torch.zeros_like(prob.coeffs)
        prob.tfield = torch.zeros_like(prob.tfield)
        prob._warm_x = None
        return prob.run().metrics[-1]["alignment_error"]


def xla_group_path(spmv, root, paths, size, mf_rec):
    """Phase 6f: the multigrid cell's size, CLI defaults otherwise, with
    --flowBackend xla under the DeviceGroup of world size 1 that the halo
    draw runs under: every row helper is the identity there (nothing is
    split), so this is phase 6e's xla draw through the group's code path.
    Then its levels again under deterministic algorithms: the final
    alignment error is held to phase 6e's xla run under them within
    HALO_ALIGNMENT_REL. Returns the record."""
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.parallel.distributed import global_device_group

    cfg = config_from_args(build_parser().parse_args(
        ["--mesh", root, "--in", *paths, "--out", "unused.png", "--flowBackend", "xla"]))
    group = global_device_group(DEVICE)
    prob, rec = drive(spmv, root, paths, size, cfg, "xla_group", "6f", device_group=group)
    _check_draw("xla_group", rec["launches"], [rec["init_s"], rec["levels_s"]])
    arrays = prob.arrays
    if (prob.config.flow_backend, prob.hier.flow_kind, prob.hier.smooth_kind) != (
            "xla", "xla", "xla") or arrays.vrows.split or arrays.frows.split:
        raise RuntimeError("xla_group: not the unsplit three-level cycles at world size 1")
    final = _deterministic_final(prob)
    ref = mf_rec["deterministic_final_alignment_error"]["xla"]
    rel = abs(final - ref) / abs(ref)
    rec.update(world_size=group.world_size, deterministic_final_alignment_error=final,
               xla_deterministic_final_alignment_error=ref, alignment_rel_to_xla=rel,
               flow_iters=[m["flow_iters"] for m in rec["levels"]])
    with open(os.path.join(WORK, "main_path_xla_group.json"), "w") as f:
        json.dump(rec, f, indent=1)
    phase("6f", f"xla under the world-size-1 group: levels {rec['levels_s']:.2f} s, "
                f"flow_iters per level " + ", ".join(f"{i:.0f}" for i in rec["flow_iters"])
                + f"; under deterministic algorithms {final:.6f}, phase 6e's xla {ref:.6f}: "
                f"relative difference {rel:.3e} (<= {HALO_ALIGNMENT_REL})")
    if not rel <= HALO_ALIGNMENT_REL:
        raise RuntimeError(f"xla_group: final alignment error {final} differs from the xla "
                           f"run's {ref} by more than {HALO_ALIGNMENT_REL} relative")
    return rec


_NCCL_WORKER = r"""
import json, os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
from meshopticalflow_tpu_torch.kernels import banded, spmv
from meshopticalflow_tpu_torch.parallel import distributed as D, halo as H
from meshopticalflow_tpu_torch.utils.testing import halo_test_system

assert D.maybe_init_distributed(%(device)r, timeout_s=120)
g = D.global_device_group(%(device)r)
s = halo_test_system(6)
b = torch.as_tensor(s["b"], dtype=torch.float32)
x_in = torch.as_tensor(np.random.default_rng(6).normal(size=len(s["b"])), dtype=torch.float32)
torch.backends.cuda.matmul.allow_tf32 = False


def solve(grp):
    h = H.build_halo_ell(s["cols"], s["vals"].astype(np.float32), grp)
    hc = H.build_halo_coarse(h, s["p0_idx"], s["p0_wt"], s["c1_cols"], s["c1_vals"])
    spmv.reset_counts()
    banded.reset_counts()
    y = h.matvec(x_in.to(g.device)).cpu()
    x, st = H.halo_mg_pcg(h, hc, b.to(g.device), tol=1e-6, max_iters=400, chunk=8)
    x = x.cpu()
    res = float(np.linalg.norm(s["a"] @ x.double().numpy() - b.double().numpy())
                / np.linalg.norm(b.double().numpy()))
    return x, y, dict(iters=st.iterations, rel=st.rel_residual, residual=res, halo=h.halo,
                      block=h.block, bytes=h.bytes_exchanged,
                      launches=spmv.counts()["by_form"], banded=banded.counts(),
                      x_sum=float(x.double().sum()))


out = {}
x, y, out["split"] = solve(g)
if g.rank == 0:
    x1, y1, out["solo"] = solve(D.DeviceGroup(None, 0, 1, g.device))
    out["x_diff"] = float((x - x1).abs().max() / x1.abs().max())
    out["y_diff"] = float((y - y1).abs().max() / y1.abs().max())
print("NCCL_RESULT " + json.dumps(dict(rank=g.rank, world=g.world_size,
                                       device=str(g.device), **out)), flush=True)
torch.distributed.destroy_process_group()
"""


def run_ranks(code: str, world: int, prefix: str, timeout: float) -> list:
    """``python -c code`` in ``world`` processes of one process group (rank
    r on GPU r, a free local port); every rank's JSON line after
    ``prefix``, in rank order. The first rank to fail, or the deadline,
    stops every process: a rank left waiting in a collective for one that
    died is killed, not waited for. Each rank's output goes to a file under
    the records directory."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    logs = os.path.join(WORK, "ranks")
    os.makedirs(logs, exist_ok=True)
    procs, files = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, MESHFLOW_COORDINATOR=f"127.0.0.1:{port}",
                       MESHFLOW_NUM_PROCESSES=str(world), MESHFLOW_PROCESS_ID=str(rank),
                       LOCAL_RANK=str(rank))
            out = open(os.path.join(logs, f"{prefix.strip().lower()}_{world}_{rank}.out"), "w+")
            err = open(os.path.join(logs, f"{prefix.strip().lower()}_{world}_{rank}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=out,
                                          stderr=err, text=True))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            for rank, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    files[rank][1].seek(0)
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{files[rank][1].read()[-3000:]}")
            if time.time() > deadline:
                raise RuntimeError(f"{world} ranks still running after {timeout} s")
            time.sleep(0.5)
        results = []
        for rank, p in enumerate(procs):
            out, err = files[rank]
            out.seek(0)
            err.seek(0)
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err.read()[-3000:]}")
            results.append(json.loads(next(line for line in out.read().splitlines()
                                           if line.startswith(prefix))[len(prefix):]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()


def nccl_exchange(world: int, device: str = DEVICE) -> dict:
    """The halo solve over NCCL in ``world`` processes, one per GPU: a halo
    product and halo_mg_pcg (float32) on a 49,152-unknown sphere system,
    against rank 0's world-size-1 solve of the same system. Every process
    started here is stopped before it returns. (``device`` "cpu" runs the
    same code over gloo, a rehearsal.)"""
    results = run_ranks(_NCCL_WORKER % {"repo": REPO, "device": device}, world,
                        "NCCL_RESULT ", timeout=300)
    solo = results[0]["solo"]
    for r in results:
        sp_ = r["split"]
        if not (sp_["rel"] < 1e-5 and sp_["bytes"] > 0
                and abs(sp_["x_sum"] - results[0]["split"]["x_sum"]) == 0):
            raise RuntimeError(f"NCCL rank {r['rank']}: {sp_}")
        cuda_rank = device == "cuda"
        if sp_["banded"]["plain_on_cuda"] or (cuda_rank and not sp_["banded"]["panel_sweep"]):
            raise RuntimeError(f"NCCL rank {r['rank']}: banded launches {sp_['banded']}")
    if not (results[0]["x_diff"] <= 1e-5 and results[0]["y_diff"] <= KERNEL_TOL["float32"]
            and results[0]["split"]["iters"] == solo["iters"]):
        raise RuntimeError(f"NCCL: the split solve differs from the solo one: {results[0]}")
    return dict(world=world, ranks=results)


_NCCL_XLA_WORKER = r"""
import dataclasses, hashlib, json, sys, time
sys.path.insert(0, %(repo)r)
import torch
from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
from meshopticalflow_tpu_torch.kernels import spmv
from meshopticalflow_tpu_torch.parallel import distributed as D

root, paths = %(root)r, %(paths)r
assert D.maybe_init_distributed(%(device)r, timeout_s=180)
g = D.global_device_group(%(device)r)
cuda = g.device.type == "cuda"
torch.backends.cuda.matmul.allow_tf32 = False
cfg = dataclasses.replace(config_from_args(build_parser().parse_args(
    ["--mesh", root, "--in", *paths, "--out", "unused.png", "--flowBackend", "xla",
     *%(flags)r])), artifact_cache=False)


def sync():
    if cuda:
        torch.cuda.synchronize(g.device)


def draw(group):
    # one draw through the user's entry points, then its levels again from
    # the initial state under deterministic algorithms
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(g.device)
    spmv.reset_counts()
    sync()
    t0 = time.time()
    prob = FlowProblem.from_texture_inputs(root, tuple(paths), cfg, device=str(g.device),
                                           device_group=group)
    sync()
    init_s, t0 = time.time() - t0, time.time()
    res = prob.run()
    sync()
    levels_s, t0 = time.time() - t0, time.time()
    blend = prob.halfway_texture()
    sync()
    halfway_s = time.time() - t0
    counts = spmv.counts()
    a = prob.arrays
    ops, basis = a.smooth_ops, a.basis
    elem = basis.s_vals.element_size()
    m = res.metrics
    rec = dict(
        init_s=init_s, levels_s=levels_s, halfway_s=halfway_s,
        stage_s={k: sum(v[k + "_seconds"] for v in m) for k in ("smooth", "trace", "solve")},
        flow_iters=[v["flow_iters"] for v in m], smooth_iters=[v["smooth_iters"] for v in m],
        flow_res=[v["flow_res"] for v in m], alignment_error=[v["alignment_error"] for v in m],
        peak_mem_gb=torch.cuda.max_memory_allocated(g.device) / 1e9 if cuda else None,
        rows={"smooth_ops.cols": ops.cols.shape[0], "smooth_ops.mass_vals":
              ops.mass_vals.shape[0], "smooth_ops.stiff_vals": ops.stiff_vals.shape[0],
              "smooth_ops.diag_slot": ops.diag_slot.shape[0], "smooth_ops.lumped":
              ops.lumped.shape[0], "signals": a.signals.shape[0], "basis.ell_cols":
              basis.ell_cols.shape[0], "basis.s_vals": basis.s_vals.shape[0],
              "basis.diag_slot": basis.diag_slot.shape[0]},
        vertices=a.vrows.n, unknowns=a.frows.n,
        gather_bytes_flow=(a.frows.n - a.frows.n_local) * elem,
        gather_bytes_smooth=(a.vrows.n - a.vrows.n_local) * elem * a.signals.shape[1],
        launches=counts["by_form"], spmv_ell=counts["spmv_ell"],
        spmv_ell_multi=counts["spmv_ell_multi"], plain_on_cuda=counts["plain_on_cuda"],
        blend=list(blend.shape), trace_exhausted=sum(v["trace_exhausted"] for v in m))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        prob.coeffs = torch.zeros_like(prob.coeffs)
        prob.tfield = torch.zeros_like(prob.tfield)
        prob._warm_x = None
        det = prob.run().metrics
    finally:
        torch.use_deterministic_algorithms(False)
    rec.update(det_alignment_error=det[-1]["alignment_error"],
               det_alignment_errors=[v["alignment_error"] for v in det],
               det_flow_iters=[v["flow_iters"] for v in det],
               tfield_sha1=hashlib.sha1(prob.tfield.cpu().numpy().tobytes()).hexdigest())
    return rec


out = dict(rank=g.rank, world=g.world_size, device=str(g.device), split=draw(g))
if g.rank == 0 and %(solo)r:
    out["solo"] = draw(D.DeviceGroup(None, 0, 1, g.device))
print("NCCL_XLA_RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


def nccl_xla(world: int, root: str, paths, flags=(), device: str = DEVICE,
             solo: dict = None) -> dict:
    """The row-split xla draw (--flowBackend xla under a DeviceGroup) in
    ``world`` processes, one per GPU, on ``root`` and ``paths`` with CLI
    defaults but ``flags``: each rank holds the ``pick`` row blocks of the
    smoothing operators, signals and flow basis operator, and solves on
    them. Rank 0 then draws the same problem alone (world size 1), unless
    ``solo`` holds that draw's record from an earlier call. Each
    draw's levels run again under deterministic algorithms: every rank's
    final alignment error must be within SPLIT_ALIGNMENT_REL of the one-rank
    draw's, its flow_iters within SPLIT_ITERS_SLACK a level, its tfield equal
    on every rank bit for bit, and the fine flow products must have left the
    square form; each rank's record lists the checks it failed under
    "failed", for the caller to raise on after recording. Every process
    started here is stopped before it returns. (``device`` "cpu" runs the
    same code over gloo, a rehearsal, where no kernel launches.)"""
    code = _NCCL_XLA_WORKER % {"repo": REPO, "device": device, "root": root,
                               "paths": list(paths), "flags": list(flags),
                               "solo": solo is None}
    results = run_ranks(code, world, "NCCL_XLA_RESULT ", timeout=420)
    solo = solo or results[0]["solo"]
    ref = solo["det_alignment_error"]
    square = "spmv_ell/f32/square/slab"
    for r in results:
        sp_ = r["split"]
        r["alignment_rel_to_one_rank"] = abs(sp_["det_alignment_error"] - ref) / abs(ref)
        r["flow_iters_diff"] = [a - b for a, b in zip(sp_["det_flow_iters"],
                                                      solo["det_flow_iters"])]
        expect = {k: n // world if n % world == 0 else n for k, n in solo["rows"].items()}
        checks = dict(
            alignment=r["alignment_rel_to_one_rank"] <= SPLIT_ALIGNMENT_REL,
            iters=len(r["flow_iters_diff"]) == len(solo["det_flow_iters"])
            and max(abs(d) for d in r["flow_iters_diff"]) <= SPLIT_ITERS_SLACK,
            rows=sp_["rows"] == expect and sp_["unknowns"] % world == 0,
            tfield=sp_["tfield_sha1"] == results[0]["split"]["tfield_sha1"],
            kernels=device == "cpu" or (sp_["spmv_ell"] > 0 and sp_["spmv_ell_multi"] > 0
                                        and sp_["plain_on_cuda"] == 0),
            form=device == "cpu"
            or sp_["launches"].get(square, 0) < solo["launches"].get(square, 0),
            finite=all(math.isfinite(float(v)) for v in sp_["alignment_error"]
                       + [sp_["init_s"], sp_["levels_s"], sp_["halfway_s"]]))
        r["failed"] = [k for k, v in checks.items() if not v]
    return dict(world=world, ranks=results)


# the viewer's problem: the cube at this edge length (49,152 triangles), two levels
VIEW_FRACTION = 0.018


def viewer_path(spmv, paths, size, scratch: str):
    """Phase 6g: the viewer's live terminal path (viz/live.py, numpy only)
    on the card, with scripted key tokens and its frames into a file:
    ``view_flow`` steps two levels of the cube at --eLength 0.018 with the
    2048^2 inputs ('a a v', then 'o' where matplotlib imports, 'q'), and a
    ``FlowProblem.run`` of the same two levels must compute the same tfield,
    bit for bit (both under deterministic algorithms); then ``view_spectrum``
    pages phase 6d's eigenvector fields ('n n b', 'o', 'q')."""
    import importlib.util
    import io

    import torch
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_mesh
    from meshopticalflow_tpu_torch.io.binio import read_vector
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
    from meshopticalflow_tpu_torch.viz import view_flow, view_spectrum

    cube = os.path.join(GOLD, "cube.ply")
    cfg = dataclasses.replace(config_from_args(build_parser().parse_args(
        ["--mesh", cube, "--in", *paths, "--out", "unused.png", "--iterations", "2",
         "--eLength", str(VIEW_FRACTION)])), artifact_cache=False)
    mpl = importlib.util.find_spec("matplotlib") is not None
    export = "o " if mpl else ""
    out_dir = os.path.join(WORK, "viewer")
    os.makedirs(out_dir, exist_ok=True)

    @contextlib.contextmanager
    def scripted(keys: str, frames_path: str):
        saved = sys.stdin, os.environ.get("MESHFLOW_LIVE")
        os.environ["MESHFLOW_LIVE"] = "1"
        sys.stdin = io.StringIO(keys)
        try:
            with open(frames_path, "w") as f, contextlib.redirect_stdout(f):
                yield
        finally:
            sys.stdin = saved[0]
            if saved[1] is None:
                del os.environ["MESHFLOW_LIVE"]
            else:
                os.environ["MESHFLOW_LIVE"] = saved[1]

    torch.cuda.synchronize()
    reset_counts(spmv)
    flow_frames = os.path.join(out_dir, "view_flow_frames.txt")
    t0 = time.time()
    with deterministic_algorithms():
        prob = FlowProblem.from_texture_inputs(cube, tuple(paths), cfg, device=DEVICE)
        with scripted("a a v " + export + "q\n", flow_frames):
            stepped = view_flow(prob, out_dir=out_dir, interactive=False)
        torch.cuda.synchronize()
        view_s = time.time() - t0
        counts = launch_counts(spmv)
        ref = FlowProblem.from_texture_inputs(cube, tuple(paths), cfg, device=DEVICE)
        res = ref.run()
    same = bool(torch.equal(prob.tfield, ref.tfield))
    max_diff = float((prob.tfield - ref.tfield).abs().max())
    with open(flow_frames) as f:
        flow_text = f.read()

    data = read_triangle_mesh(cube)
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts = subdivide_mesh(data.faces, data.vertices, SPECTRUM_FRACTION * diag)
    dumps = sorted(glob.glob(os.path.join(scratch, "spectrum", "eigenvector-*")))
    fields = np.stack([read_vector(p, width=2).reshape(len(tris), 2) for p in dumps])
    spec_frames = os.path.join(out_dir, "view_spectrum_frames.txt")
    t0 = time.time()
    with scripted("n n b " + export + "q\n", spec_frames):
        pages = view_spectrum(verts, tris, fields, out_dir=os.path.join(out_dir, "spectrum"),
                              interactive=False)
    spec_s = time.time() - t0
    with open(spec_frames) as f:
        spec_text = f.read()
    exports = sorted(glob.glob(os.path.join(out_dir, "live_export_*"))
                     + glob.glob(os.path.join(out_dir, "spectrum", "live_export_*")))
    rec = dict(triangles=prob.mesh.n_triangles, levels_stepped=stepped,
               flow_frames=flow_text.count("\x1b[H"), spectrum_frames=spec_text.count("\x1b[H"),
               spectrum_pages=pages, fields=int(fields.shape[0]), matplotlib=mpl,
               png_exports=[os.path.relpath(p, REPO) for p in exports],
               tfield_equal_to_run=same, tfield_max_abs_diff=max_diff,
               alignment_error=[m["alignment_error"] for m in res.metrics],
               view_flow_s=view_s, view_spectrum_s=spec_s, launches=counts)
    with open(os.path.join(WORK, "main_path_viewer.json"), "w") as f:
        json.dump(rec, f, indent=1)
    phase("6g", f"view_flow (live, scripted 'a a v {export}q') on {rec['triangles']} "
                f"triangles: {stepped} levels stepped, {rec['flow_frames']} frames written in "
                f"{view_s:.2f} s (init included); tfield equal bit for bit to run() of the same "
                f"levels: {same} (max |d| {max_diff:.3e})")
    phase("6g", f"view_spectrum (live, 'n n b {export}q') on phase 6d's {rec['fields']} "
                f"fields: {rec['spectrum_frames']} frames in {spec_s:.2f} s; matplotlib "
                f"imports: {mpl}; PNG exports: {rec['png_exports']}")
    phase("6g", f"launches: spmv_ell {counts['spmv_ell']}, spmv_ell_multi "
                f"{counts['spmv_ell_multi']}, plain on CUDA {counts['plain_on_cuda']}")
    phase("6g", march_line(counts))
    _check_draw("viewer", counts, rec["alignment_error"] + [view_s, spec_s])
    if stepped != 2 or rec["flow_frames"] < 4 or rec["spectrum_frames"] < 4:
        raise RuntimeError(f"viewer: {stepped} levels, {rec['flow_frames']} / "
                           f"{rec['spectrum_frames']} frames")
    if not same:
        raise RuntimeError(f"viewer: the stepped tfield differs from run()'s by {max_diff}")
    if mpl and len(exports) != 2:
        raise RuntimeError(f"viewer: expected two PNG exports, found {exports}")
    return rec


def warm_init_path(spmv, root, paths, size):
    """Phase 6c, first half: the multigrid cell built twice in one process
    with the artifact cache on ($MESHFLOW_CACHE is the run's scratch), each
    run for WARM_LEVELS levels under torch's deterministic algorithms. The
    second construction must hold the first one's device tensors and
    compute its tfield and alignment errors exactly."""
    import torch
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.utils import artifacts, devcache

    cfg = config_from_args(build_parser().parse_args(
        ["--mesh", root, "--in", *paths, "--out", "unused.png",
         "--iterations", str(WARM_LEVELS)]))
    if not cfg.artifact_cache:
        raise RuntimeError("the CLI default does not use the artifact cache")
    devcache.clear()
    torch.cuda.synchronize()
    reset_counts(spmv)
    runs = []
    with deterministic_algorithms():
        for _ in range(2):
            t0 = time.time()
            prob = FlowProblem.from_texture_inputs(root, tuple(paths), cfg, device=DEVICE)
            torch.cuda.synchronize()
            init_s = time.time() - t0
            t0 = time.time()
            res = prob.run()
            torch.cuda.synchronize()
            runs.append((prob, res, init_s, time.time() - t0))
    counts = launch_counts(spmv)
    (p1, r1, init1, run1), (p2, r2, init2, run2) = runs
    shared = {
        "basis": p2.arrays.basis.ell_cols is p1.arrays.basis.ell_cols,
        "trace_tables": p2.arrays.tm is p1.arrays.tm,
        "texel_table": p2.src_t is p1.src_t and p2.src_p is p1.src_p,
        "textures": p2.textures is p1.textures,
        "signals": p2.arrays.signals is p1.arrays.signals,
        "hierarchy": p2.hier.coarse is p1.hier.coarse
        and p2.hier.patch.c1_band is p1.hier.patch.c1_band}
    same_tfield = bool(np.array_equal(r1.tfield, r2.tfield))
    align = [[m["alignment_error"] for m in r.metrics] for r in (r1, r2)]
    cache = artifacts.cache_dir()
    files = sorted(os.listdir(cache))
    rec = dict(levels=WARM_LEVELS, init_s=[init1, init2], levels_s=[run1, run2],
               init_profile=[p1.init_profile, p2.init_profile], shared=shared,
               same_tfield=same_tfield, alignment_error=align, launches=counts,
               artifact_files=files,
               artifact_mb=sum(os.path.getsize(os.path.join(cache, f)) for f in files) / 1e6)
    with open(os.path.join(WORK, "main_path_warm_init.json"), "w") as f:
        json.dump(rec, f, indent=1)
    for k, (prob, init_s) in enumerate(((p1, init1), (p2, init2))):
        phase("6c", f"construction {k + 1} ({'cold' if k == 0 else 'warm'}): init "
                    f"{init_s:.2f} s; init profile " + json.dumps(rounded(prob.init_profile)))
    phase("6c", f"levels {run1:.2f} s / {run2:.2f} s; {len(files)} artifact files, "
                f"{rec['artifact_mb']:.1f} MB; shared tensors {json.dumps(shared)}; "
                f"tfield equal bit for bit: {same_tfield}")
    phase("6c", "warm init: " + march_line(counts))
    _check_draw("warm_init", counts, [init1, init2, run1, run2] + align[0] + align[1])
    if not all(shared.values()):
        raise RuntimeError(f"warm init: the second construction rebuilt {shared}")
    if not same_tfield or align[0] != align[1]:
        raise RuntimeError("warm init: the second construction computed other numbers")
    for prob in (p1, p2):
        if prob.init_profile["raster_path"] != "native":
            raise RuntimeError("warm init: the texel table did not come from the native "
                               "rasterizer")
    del runs, p1, p2
    devcache.clear()
    return rec


def _final_systems(prob):
    """The last state's level systems, rebuilt as a level builds them:
    (flow system values, flow diag, flow rhs, data blocks, scale, weight,
    smoothing system values, smoothing rhs)."""
    import torch
    from meshopticalflow_tpu_torch.flow import pipeline as P
    from meshopticalflow_tpu_torch.flow.signal import _smooth_system
    from meshopticalflow_tpu_torch.models.base import build_flow_system

    arrays, cfg, hier = prob.arrays, prob.config, prob.hier
    s_weight = cfg.scalar_smooth_weight
    smoothed, _, _ = P._stage_smooth(arrays, s_weight, cfg, hier)
    d_blocks, rhs_t, _, _, _ = P._stage_resample(arrays, prob.tfield, smoothed, cfg)
    w = torch.tensor(cfg.resolved_vf_smooth_weight(), dtype=prob.dtype, device=prob.device)
    sys_vals, _, rhs, diag, scale = build_flow_system(arrays.basis, d_blocks, rhs_t, w)
    sm_vals, sm_b, _ = _smooth_system(arrays.smooth_ops, arrays.signals, s_weight)
    return dict(sys_vals=sys_vals, diag=diag, rhs=rhs, d_blocks=d_blocks, scale=scale, w=w,
                sm_vals=sm_vals, sm_b=sm_b)


def _wall_ms(fn, reps: int = 15) -> float:
    """Median host wall time of fn() followed by a device synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def twolevel_split(prob, tag: str):
    """One two-level PCG iteration of the last state's flow system, split at
    the host coarse solve: the device part (post-smooth, CG step, pre-smooth
    and restriction: device time and issued time), the host round trip
    (restricted residual to the host, splu solve, correction back; wall
    time) with the splu solve alone, and the whole iteration as the solve
    loop runs it (wall time, its residual read included)."""
    import torch
    from meshopticalflow_tpu_torch.models import base

    cfg, hier = prob.config, prob.hier
    sy = _final_systems(prob)
    solver = base._make_mg_solver(prob.arrays.basis, hier.coarse, None, sy["d_blocks"],
                                  sy["scale"], sy["w"], sy["sys_vals"], sy["diag"],
                                  hier.flow_kind, cfg.mg_cheb_k, cfg.mg_nu,
                                  cfg.mg_fine_cheb, cfg.mg_coarse_exact)
    rhs = sy["rhs"]
    z1, rc = solver.pre_cycle(rhs)
    ec = solver.coarse_solve(rc)
    zero = torch.zeros_like(rhs)
    rz0 = torch.ones((), dtype=prob.dtype, device=prob.device)
    rc_host = rc.detach().to("cpu", torch.float64).numpy()

    def splu_only():
        solver.coarse_lu.solve(rc_host)

    def whole():
        out = solver.iteration(zero, rhs, z1, solver.coarse_solve(rc), zero, rz0)
        float(out[-1])

    device_part = lambda: solver.iteration(zero, rhs, z1, ec, zero, rz0)   # noqa: E731
    out = dict(coarse_unknowns=solver.n_coarse, factor_s=solver.factor_seconds,
               lu_fill=int(solver.coarse_lu.L.nnz + solver.coarse_lu.U.nnz),
               device_part_device_ms=median_ms(device_part, reps=9, inner=3),
               device_part_issued_ms=issue_ms(device_part, reps=9, inner=3),
               round_trip_wall_ms=_wall_ms(lambda: solver.coarse_solve(rc)),
               splu_solve_ms=_wall_ms(splu_only),
               iteration_wall_ms=_wall_ms(whole))
    out["device_idle_share_of_iteration"] = 1 - (out["device_part_device_ms"]
                                                 / out["iteration_wall_ms"])
    phase("6b", ("{tag}: one two-level flow iteration {iteration_wall_ms:.3f} ms of wall "
                 "({device_part_device_ms:.3f} ms of device time, issued in "
                 "{device_part_issued_ms:.3f} ms); host round trip {round_trip_wall_ms:.3f} ms, "
                 "of which splu solve {splu_solve_ms:.3f} ms ({coarse_unknowns} coarse "
                 "unknowns, factored in {factor_s:.3f} s, L+U {lu_fill} non-zeros); device "
                 "idle {pct:.1f} % of the iteration").format(
                     tag=tag, pct=100 * out["device_idle_share_of_iteration"], **out))
    return out


# ----------------------------------------------------------------------------
# Phases 6c and 6d: tracking and the spectrum at full width
# ----------------------------------------------------------------------------

def _check_draw(tag: str, counts: dict, values, traces: bool = True) -> None:
    if counts["spmv_ell"] == 0 or counts["spmv_ell_multi"] == 0:
        raise RuntimeError(f"{tag}: a kernel was not launched: {counts}")
    if counts["plain_on_cuda"] != 0:
        raise RuntimeError(f"{tag}: a plain version ran on CUDA tensors: {counts}")
    check_march_launches(tag, counts, traces)
    check_banded_launches(tag, counts)
    if not all(math.isfinite(float(v)) for v in values):
        raise RuntimeError(f"{tag}: non-finite value in the record")


def tracking_path(spmv, paths, size, scratch: str):
    """Phase 6c: bake both upsampled textures onto the cube with the
    SampleTextureToVertices CLI (default edge length), then the vertex
    TrackSequence CLI over A, B, A with --composed at float32 CLI defaults.
    The frames and the tracker's outputs go to ``scratch``."""
    import torch
    from meshopticalflow_tpu_torch.apps.sample_texture_to_vertices import main as bake
    from meshopticalflow_tpu_torch.apps.track_sequence import main as track
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
    from meshopticalflow_tpu_torch.kernels import advect

    t0 = time.time()
    frames = []
    for path, tag in zip(paths, "AB"):
        frames.append(os.path.join(scratch, f"frame_{tag}_{size}.ply"))
        if bake(["--in", os.path.join(GOLD, "cube.ply"), "--texture", path,
                 "--out", frames[-1]]) != 0:
            raise RuntimeError("SampleTextureToVertices failed")
    bake_s = time.time() - t0
    out = os.path.join(scratch, "track_full")
    # the composed resample's inputs, for phase 7m's Whitney lanes
    real_composed = advect.resample_signal_composed_whitney
    composed_args = {}

    def recording_composed(tm, edge_fields, values, length, min_step=1e-2, max_steps=4096):
        composed_args.update(tm=tm, fields=edge_fields, length=length, min_step=min_step,
                             max_steps=max_steps)
        return real_composed(tm, edge_fields, values, length, min_step, max_steps)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(spmv)
    advect.resample_signal_composed_whitney = recording_composed
    t0 = time.time()
    try:
        rc = track(["--in", frames[0], frames[1], frames[0], "--outDir", out, "--composed",
                    "--device", DEVICE])
    finally:
        advect.resample_signal_composed_whitney = real_composed
    total_s = time.time() - t0
    counts = launch_counts(spmv)
    if rc != 0:
        raise RuntimeError("TrackSequence failed")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        *pairs, composed = [json.loads(line) for line in f]
    comp = read_triangle_mesh(os.path.join(out, "composed_resampled.ply"))
    rec = dict(triangles=len(comp.faces), vertices=len(comp.vertices), atlas=size,
               bake_s=bake_s, total_s=total_s, composed_s=composed["composed_seconds"], pairs=pairs,
               launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    with open(os.path.join(WORK, "main_path_tracking.json"), "w") as f:
        json.dump(rec, f, indent=1)
    for p in pairs:
        phase("6c", f"pair {p['pair']}: init {p['init_seconds']:.2f} s, levels "
                    f"{p['level_seconds']:.2f} s, flow_iters "
                    f"{', '.join(f'{i:.0f}' for i in p['flow_iters'])}, alignment error "
                    f"{p['alignment_error']:.6f}; init profile "
                    + json.dumps(rounded(p["init_profile"])))
    phase("6c", "pair init with the artifact cache on: " + ", ".join(
        f"pair {p['pair']} {p['init_seconds']:.2f} s" for p in pairs)
        + " (pair 2 reuses pair 1's mesh tables and basis)")
    phase("6c", f"{rec['triangles']} triangles, {rec['vertices']} vertices from {size}^2: bake "
                f"{bake_s:.2f} s, tracker {total_s:.2f} s, composed resample "
                f"{rec['composed_s']:.3f} s; peak {rec['peak_mem_gb']:.2f} GB")
    phase("6c", f"launches: spmv_ell {counts['spmv_ell']}, spmv_ell_multi "
                f"{counts['spmv_ell_multi']}, plain on CUDA {counts['plain_on_cuda']}")
    for form, k in counts["by_form"].items():
        phase("6c", f"launches of {form}: {k}")
    phase("6c", march_line(counts))
    values = [v for p in pairs for v in [p["init_seconds"], p["level_seconds"],
                                           p["alignment_error"], *p["flow_iters"]]]
    _check_draw("tracking", counts, values + [bake_s, total_s, rec["composed_s"]])
    if counts["march"]["march_whitney"] == 0 or not composed_args:
        raise RuntimeError(f"tracking: the composed resample launched no Whitney march: "
                           f"{counts['march']}")
    if len(pairs) != 2 or not np.isfinite(comp.colors).all():
        raise RuntimeError(f"tracking: {len(pairs)} pairs, composed colours finite "
                           f"{np.isfinite(comp.colors).all()}")
    return rec, composed_args


SPECTRUM_FRACTION = 0.018      # the cube at this edge length: 49,152 triangles


def spectrum_path(spmv, scratch: str):
    """Phase 6d: the Spectrum CLI at its defaults (k = 20, float32) on the
    cube at --eLength 0.018, on the card (block Lanczos on the banded
    shift-invert solve); then the eigenvalues against ARPACK on the same
    host operators, and one block-Lanczos step timed alone. The eigenvector
    dumps go to ``scratch``. Returns (record, (basis, pack) for phase 7)."""
    import io

    import torch
    from meshopticalflow_tpu_torch.apps.spectrum import main as spectrum
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_mesh
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
    from meshopticalflow_tpu_torch.models.base import build_basis
    from meshopticalflow_tpu_torch.ops.assemble import vector_field_mass_blocks
    from meshopticalflow_tpu_torch.solvers import lanczos
    from meshopticalflow_tpu_torch.utils.testing import arpack_spectrum

    cube = os.path.join(GOLD, "cube.ply")
    stats = {}
    torch.cuda.synchronize()
    reset_counts(spmv)
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = spectrum(["--mesh", cube, "--eLength", str(SPECTRUM_FRACTION), "--device",
                       DEVICE, "--outPrefix", os.path.join(scratch, "spectrum"), "--verbose"],
                      stats=stats)
    total_s = time.time() - t0
    counts = launch_counts(spmv)
    printed = buf.getvalue()
    if rc != 0 or "m_alloc" not in stats["restarts"][0]:
        raise RuntimeError("Spectrum CLI failed or did not take the block path")
    eigenvalues = np.array(json.loads(printed.strip().splitlines()[-1])["eigenvalues"])

    # the same host operators as scripts/bench_spectrum.py: S and M in float64
    data = read_triangle_mesh(cube)
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts = subdivide_mesh(data.faces, data.vertices, SPECTRUM_FRACTION * diag)
    mesh = build_mesh(tris, vertices=verts)
    host, basis = build_basis(mesh, FlowConfig(dtype="float32"), DEVICE)
    t0 = time.time()
    oracle = arpack_spectrum(host, mesh, len(eigenvalues))
    oracle_s = time.time() - t0
    wellpos = np.abs(oracle) > 1e-4 * np.abs(oracle).max()
    rel = np.abs(eigenvalues[wellpos] - oracle[wellpos]) / np.abs(oracle[wellpos])

    # The CLI's last shift-invert pack, built again on the same operators,
    # then one block-Lanczos step and one banded solve, each timed alone, at
    # the first restart's shapes.
    kw = dict(dtype=basis.s_vals.dtype, device=basis.s_vals.device)
    mass = torch.as_tensor(vector_field_mass_blocks(mesh)).to(**kw)
    pack = lanczos._shift_invert_pack(basis, mass, stats["packs"][-1]["sigma"])._replace(
        inner_iters=stats["packs"][-1]["inner_iters"])
    first = stats["restarts"][0]
    n, bs, m_alloc = basis.n_coeffs, first["block"], first["m_alloc"]
    defl_v = torch.zeros((first["deflation_width"], n), **kw)
    defl_mv = torch.zeros_like(defl_v)
    big_v = torch.zeros((m_alloc, n), **kw)
    big_mv = torch.zeros_like(big_v)
    a_blk = torch.zeros((m_alloc // bs, bs, bs), **kw)
    b_blk = torch.zeros_like(a_blk)
    x = lanczos._block_init(basis, mass, _rand(n, bs).to(kw["dtype"]), defl_v, defl_mv)
    zero_b, zero_x = torch.zeros((bs, bs), **kw), torch.zeros((n, bs), **kw)

    def step():
        lanczos._lanczos_banded_blockstep(basis, mass, pack, big_v, big_mv, a_blk, b_blk,
                                          defl_v, defl_mv, x, zero_b, zero_x, 0, 1, bs)

    rhs = _rand(n, bs).to(kw["dtype"])
    split = dict(step_device_ms=median_ms(step, reps=5, inner=2),
                 step_issued_ms=issue_ms(step, reps=5, inner=2),
                 band_solve_device_ms=median_ms(lambda: pack.bsolver.solve(rhs), reps=9,
                                                inner=3),
                 band_solve_issued_ms=issue_ms(lambda: pack.bsolver.solve(rhs), reps=9,
                                               inner=3))
    split["device_idle_share_of_step"] = 1 - split["step_device_ms"] / split["step_issued_ms"]
    # one panel product of the sweeps (a solve makes two per panel and sweep)
    dinv = pack.bsolver.dinv
    panel_rhs = _rand(dinv.shape[1], bs).to(dinv.dtype)
    split["panel_matmul_device_ms"] = median_ms(lambda: dinv[0] @ panel_rhs, reps=9, inner=10)
    pat = pack.bsolver.pat
    rec = dict(triangles=len(tris), unknowns=n, ell_width=basis.ell_width, k=len(oracle),
               band=dict(bw=pat.bw, nb=pat.nb, m=pat.m, panels=int(pack.bsolver.dinv.shape[0]),
                         panel_width=int(pack.bsolver.dinv.shape[1])),
               total_s=total_s, init_s=total_s - stats["seconds"], solve_s=stats["seconds"],
               stats=stats, launches=counts, eigenvalues=eigenvalues.tolist(),
               oracle=oracle.tolist(), oracle_s=oracle_s, max_rel_err=float(rel.max()),
               median_rel_err=float(np.median(rel)), well_positive=int(wellpos.sum()),
               split=split)
    with open(os.path.join(WORK, "main_path_spectrum.json"), "w") as f:
        json.dump(rec, f, indent=1)
    for p in stats["packs"]:
        phase("6d", f"shift-invert pack at sigma {p['sigma']:.4g}: {p['seconds']:.3f} s "
                    f"(band {pat.bw} over {pat.m} blocks of {pat.nb}, shift {p['shift_used']}), "
                    f"inner_iters {p['inner_iters']}")
    for r in stats["restarts"]:
        phase("6d", "restart {restart}: depth {depth}, cut {cut}, +{new_found} pairs; lanczos "
                    "{lanczos_s:.3f} s, purify {purify_s:.3f} s, Rayleigh-Ritz "
                    "{rayleigh_ritz_s:.3f} s, acceptance {accept_s:.3f} s".format(**r))
    phase("6d", f"{len(tris)} triangles, {n} unknowns (ELL width {basis.ell_width}), k "
                f"{len(oracle)}: CLI {total_s:.2f} s (init {rec['init_s']:.2f} s, solve "
                f"{rec['solve_s']:.2f} s), {stats['restart_count']} restarts, sigma "
                f"escalations {stats['sigma_escalations']}; eigenvalues vs eigsh(sigma 1e-8): "
                f"max rel err {rec['max_rel_err']:.3e} (<= 1e-3), median "
                f"{rec['median_rel_err']:.3e} over {rec['well_positive']} pairs; eigsh "
                f"{oracle_s:.2f} s")
    phase("6d", "one block-Lanczos step: {step_device_ms:.3f} ms of device time, issued in "
                "{step_issued_ms:.3f} ms (device idle {pct:.1f} %); one banded solve (4 "
                "columns) {band_solve_device_ms:.3f} ms device, {band_solve_issued_ms:.3f} ms "
                "issued; one panel product ({s}x{s} by {s}x4) {us:.2f} us device".format(
                    pct=100 * split["device_idle_share_of_step"], s=int(dinv.shape[1]),
                    us=1e3 * split["panel_matmul_device_ms"], **split))
    phase("6d", f"launches: spmv_ell {counts['spmv_ell']}, spmv_ell_multi "
                f"{counts['spmv_ell_multi']}, plain on CUDA {counts['plain_on_cuda']}")
    for form, k in counts["by_form"].items():
        phase("6d", f"launches of {form}: {k}")
    phase("6d", march_line(counts))
    phase("6d", banded_line(counts))
    _check_draw("spectrum", counts, [total_s, *eigenvalues, *split.values()], traces=False)
    check_banded_launches("spectrum", counts, solves=True)
    if not rec["max_rel_err"] <= 1e-3:
        raise RuntimeError(f"spectrum: max rel err {rec['max_rel_err']:.3e} > 1e-3")
    return rec, (basis, pack)


def spectrum_operators(basis, pack):
    """The spectrum's S + sigma M (float32) at 1, 4 and 8 columns: the
    Lanczos products, the block recurrence and the 32-column purification
    and Rayleigh-Ritz blocks (four launches of 8)."""
    n = basis.n_coeffs
    return [(name, "spectrum S+sigma M", basis.ell_cols, pack.sys_vals, x)
            for name, x in (("spmv_ell", _rand(n)), ("spmv_ell_multi", _rand(n, 4)),
                            ("spmv_ell_multi", _rand(n, 8)))]


# ----------------------------------------------------------------------------
# Phase 7: the SpMV kernels at the multigrid problem's operators
# ----------------------------------------------------------------------------

def _library_ms(cols, vals, x, n_in):
    """cuSPARSE through torch.sparse: CSR (the ELL arrays, row pointers of
    stride W) times x, in the values' type. Returns (ms, None) or
    (None, reason)."""
    import torch

    n, w = cols.shape
    crow = torch.arange(0, n * w + 1, w, dtype=torch.int32, device=cols.device)
    xx = x.to(vals.dtype)
    try:
        csr = torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1),
                                      size=(n, n_in))
        csr @ xx
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, "not supported: " + (str(e).splitlines() or [repr(e)])[0][:120]
    return median_ms(lambda: csr @ xx), None


def _rand(*shape):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(sum(shape))
    return torch.randn(*shape, generator=gen, device=DEVICE, dtype=torch.float32)


def mg_operators(prob):
    """(name, operator, cols, vals, x) at the operators the multigrid main
    path runs, rebuilt from the problem's final state."""
    from meshopticalflow_tpu_torch.models.base import coarse_system_vals
    from meshopticalflow_tpu_torch.solvers.mg import bf16_values

    arrays, hier = prob.arrays, prob.hier
    sy = _final_systems(prob)
    flow_vals, rhs, sm_vals, sm_b = sy["sys_vals"], sy["rhs"], sy["sm_vals"], sy["sm_b"]
    c1_vals, _ = coarse_system_vals(hier.coarse.coarse_dev, sy["d_blocks"], sy["scale"],
                                    sy["w"])
    fpack, vpack = hier.patch.mg_pack, hier.vcoarse.mg_pack
    fcols, vcols = arrays.basis.ell_cols, arrays.smooth_ops.cols
    n1, nv1 = fpack.n1, vpack.n1
    c = sm_b.shape[1]
    return [
        ("spmv_ell", "flow", fcols, flow_vals, rhs),
        ("spmv_ell", "flow", fcols, bf16_values(flow_vals, fpack.fine_canon), rhs),
        ("spmv_ell", "flow", fcols, flow_vals.double(), rhs.double()),
        ("spmv_ell", "c1", hier.coarse.coarse_dev.ell_cols, c1_vals, _rand(n1)),
        ("spmv_ell", "P0", fpack.p0.cols, fpack.p0.vals, _rand(n1)),
        ("spmv_ell", "P0^T", fpack.p0t.cols, fpack.p0t.vals, rhs),
        ("spmv_ell_multi", "smoothing", vcols, sm_vals, sm_b),
        ("spmv_ell_multi", "smoothing", vcols, bf16_values(sm_vals, vpack.fine_canon), sm_b),
        ("spmv_ell_multi", "smoothing", vcols, sm_vals.double(), sm_b.double()),
        ("spmv_ell_multi", "vertex P0", vpack.p0.cols, vpack.p0.vals, _rand(nv1, c)),
        ("spmv_ell_multi", "vertex P0^T", vpack.p0t.cols, vpack.p0t.vals, sm_b),
    ]


def split_operators(operators):
    """Phase 7's row-split forms: rank 0's rows of the float32 flow and
    smoothing operators of ``operators`` at 2 and 4 ranks, wherever the
    rows divide (196,610 smoothing rows do not divide 4), against every row
    of x, as a product of the split xla draw (``--nccl``) runs them."""
    import torch

    out = []
    for name, op, cols, vals, x in operators:
        if op not in ("flow", "smoothing") or vals.dtype != torch.float32:
            continue
        for world in (2, 4):
            if cols.shape[0] % world == 0:
                rows = cols.shape[0] // world
                out.append((name, f"{op} rows 1/{world}", cols[:rows].clone(),
                            vals[:rows].clone(), x))
    return out


def twolevel_operators(prob, tag: str, f64: bool, vertex: bool):
    """The forms a two-level draw adds: its flow operator (f32, and f64
    when ``f64``: the refinement residuals), its f32 transfers P0 / P0^T,
    and (``vertex``) the smoothing cycle's f32 vertex transfers."""
    hier = prob.hier
    sy = _final_systems(prob)
    flow_vals, rhs, sm_b = sy["sys_vals"], sy["rhs"], sy["sm_b"]
    fcols = prob.arrays.basis.ell_cols
    t, vt = hier.coarse.transfer, hier.vcoarse.transfer
    ops = [("spmv_ell", f"{tag} flow", fcols, flow_vals, rhs)]
    if f64:
        ops.append(("spmv_ell", f"{tag} flow", fcols, flow_vals.double(), rhs.double()))
    ops += [("spmv_ell", f"{tag} P0", t.p.cols, t.p.vals, _rand(t.pt.cols.shape[0])),
            ("spmv_ell", f"{tag} P0^T", t.pt.cols, t.pt.vals, rhs)]
    if vertex:
        c = sm_b.shape[1]
        ops += [("spmv_ell_multi", "two-level vertex P0", vt.p.cols, vt.p.vals,
                 _rand(vt.pt.cols.shape[0], c)),
                ("spmv_ell_multi", "two-level vertex P0^T", vt.pt.cols, vt.pt.vals, sm_b)]
    return ops


def check_spmv(spmv, operators, l2_tb_s: float, draws: dict):
    """Phase 7: every SpMV form of ``operators`` against its plain version,
    timed, with its form's launches in each draw of ``draws`` (tag ->
    record) and those launches times (warm time - bound)."""
    import torch

    report = []
    for name, op, cols, vals, x in operators:
        kernel, plain = getattr(spmv, name), getattr(spmv, name + "_plain")
        tname = str(vals.dtype).removeprefix("torch.")
        x = x.contiguous()
        vals = vals.contiguous()
        n_in = x.shape[0]
        y = kernel(cols, vals, x)
        ref = plain(cols, vals, x)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(ref).all()):
            raise RuntimeError(f"{name} {op} {tname}: non-finite output")
        abs_err = float((y - ref).abs().max())
        rel = abs_err / max(float(ref.abs().max()), 1e-300)
        # the product needs only the stored non-zeros (a padding slot holds a
        # zero value) as CSR: an int32 index and a value each, n_out + 1 row
        # pointers, x read once and y written once
        nnz = int((vals != 0).sum())
        nbytes = nnz * (4 + vals.element_size()) + 4 * (cols.shape[0] + 1) + _nbytes(x, y)
        b_ms, b_by = bound(nbytes, 2 * nnz * (x.shape[1] if x.dim() == 2 else 1), tname)
        lib_ms, lib_note = _library_ms(cols, vals, x, n_in)
        form = spmv.form_of(name, cols, vals, n_in)
        plan = spmv.LIBRARY.load().plan(vals.dtype, cols.shape[0], cols.shape[1],
                                        x.shape[1] if x.dim() == 2 else 1, x.device)
        # the same kernel and stream with the scattered gather taken out:
        # every slot of row i reads x[i * n_in // n_out]
        n_out = cols.shape[0]
        local = (torch.arange(n_out, device=cols.device, dtype=torch.int64) * n_in
                 // n_out).to(torch.int32)[:, None].expand(cols.shape).contiguous()
        rec = dict(name=name, operator=op, dtype=tname, shape=list(cols.shape), form=form,
                   plan=dataclasses.asdict(plan),
                   x_shape=list(x.shape), nnz=nnz, max_abs_err=abs_err, rel_err=rel,
                   ms=median_ms(lambda: kernel(cols, vals, x)),
                   ms_cold=cold_ms(lambda: kernel(cols, vals, x)),
                   ms_local_gather=median_ms(lambda: kernel(local, vals, x)),
                   issue_ms=issue_ms(lambda: kernel(cols, vals, x)),
                   plain_ms=median_ms(lambda: plain(cols, vals, x)),
                   bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                   bound_l2_ms=nbytes / (l2_tb_s * 1e12) * 1e3,
                   library_ms=lib_ms, library_note=lib_note)
        for tag, draw in draws.items():
            k = draw["launches"]["by_form"].get(form, 0)
            rec[f"launches_{tag}"] = k
            rec[f"excess_ms_{tag}"] = k * (rec["ms"] - b_ms)
        report.append(rec)
        lib = f"{lib_ms * 1e3:.2f} us" if lib_ms is not None else lib_note
        layout = (f"R {plan.rows}, {plan.stages} stages" if plan.variant == "slab"
                  else f"G {plan.group}")
        phase(7, f"{name} {op} {tname} {tuple(cols.shape)} x{tuple(x.shape)} "
                 f"({plan.variant}: {plan.threads} threads, {layout}, {plan.grid} CTAs): "
                 f"max|d|/max|y| {rel:.3e} (tol {KERNEL_TOL[tname]:.0e}); kernel "
                 f"{rec['ms'] * 1e3:.2f} us warm, {rec['ms_cold'] * 1e3:.2f} us cold, "
                 f"{rec['issue_ms'] * 1e3:.2f} us issued back to back, "
                 f"{rec['ms_local_gather'] * 1e3:.2f} us warm with a local gather; "
                 f"plain {rec['plain_ms'] * 1e3:.2f} us; cuSPARSE {lib}; bound "
                 f"{b_ms * 1e3:.2f} us HBM, {rec['bound_l2_ms'] * 1e3:.2f} us L2 "
                 f"({nbytes / 1e6:.1f} MB, {nnz} non-zeros in {cols.numel()} slots); "
                 + "; ".join(f"{form} launched {rec[f'launches_{t}']} times in the {t} draw, "
                             f"x (warm - bound) = {rec[f'excess_ms_{t}']:.3f} ms"
                             for t in draws))
        if not rel <= KERNEL_TOL[tname]:
            raise RuntimeError(f"{name} {op} {tname}: kernel disagrees with plain "
                               f"version ({rel:.3e} > {KERNEL_TOL[tname]:.0e})")
    return report


# ----------------------------------------------------------------------------
# Phase 7m: the march kernels against their plain versions
# ----------------------------------------------------------------------------

# The reference package's marches (XLA while_loops, no Pallas kernel).
MARCH_REPLACES = {
    "march_field": "meshopticalflow_tpu/kernels/tracing.py:159",
    "march_whitney": "meshopticalflow_tpu/kernels/tracing.py:320",
    "exp_map": "meshopticalflow_tpu/kernels/tracing.py:623",
}
# Floating-point operations of one lane-step of csrc/trace.cu, counted from
# its source (edge exit 12, metric 9 + 3, advance 5, crossing 16; the
# Whitney form's field at the point 16 more; exp_map's step 32).
MARCH_OPS_PER_STEP = {"march_field": 45, "march_whitney": 61, "exp_map": 32}
MARCH_ESCALATE = 16            # flow_field_trace_compacted's default


def _march_bytes(kernel: str, tm, n: int, lane_floats: int, elem: int, field_rows: int,
                 lane_steps: int) -> int:
    """Bytes the march must move: every lane's start (t int64, lane_floats
    values) and end (t, p) once, and the table rows it reads once: the
    whole tables (metric, opposite, transition map and offset; the field,
    or the Whitney coefficients and inverse metric) or, where this run's
    lanes take fewer steps than that, the rows a step reads at most (metric
    3 values; on a crossing the opposite, map and offset; on a re-read the
    field), counted once a lane-step."""
    t = tm.n_triangles
    tables = 3 * t * (8 + 6 * elem)                    # opp, lin, const
    per_step = 8 + 6 * elem
    if kernel != "exp_map":
        tables += 4 * t * elem + field_rows * elem      # g, field
        per_step += 3 * elem + 2 * elem
    if kernel == "march_whitney":
        tables += 4 * t * elem                          # g_inv
        per_step += 5 * elem
    lanes = n * (8 + lane_floats * elem) + n * (8 + 2 * elem)
    return lanes + min(tables, lane_steps * per_step)


MARCH_TURN_ROUNDS = 2           # rounds of (kernel, PR 13's, PR 13's, kernel)


def _with_library(tracing, library, fn):
    """fn with kernels/tracing.py's march library swapped for ``library``."""
    def run():
        shipped = tracing.LIBRARY
        tracing.LIBRARY = library
        try:
            return fn()
        finally:
            tracing.LIBRARY = shipped
    return run


def _march_case(tracing, kernel: str, label: str, call, plain, launch, bytes_of,
                dtype_name: str, plain_reps: int, earlier=None) -> dict:
    """Hold one march to its plain version: every lane's t and p equal bit
    for bit and the exhausted counts equal, then time the kernel (CUDA
    events, ``launch`` = the wrapper's launch without its read-back) and
    the plain version (wall clock to a synchronize). With ``earlier`` (the
    library of PR 13's design), that design too is held to the plain march
    and timed in turns with the kernel."""
    import torch

    got = call()
    stats = tracing.last_stats(kernel)
    ref = plain()
    torch.cuda.synchronize()
    t_diff = got[0] != ref[0]
    p_diff = (got[1] != ref[1]).any(dim=1)
    differ = int((t_diff | p_diff).sum())
    err = float((got[1] - ref[1]).abs().max()) if got[1].numel() else 0.0
    rec = dict(name=kernel, case=label, dtype=dtype_name, lanes=stats["lanes"],
               lane_steps=stats["lane_steps"], max_lane_steps=stats["max_lane_steps"],
               warp_slots=stats["warp_slots"],
               simt_efficiency=stats["lane_steps"] / max(stats["warp_slots"], 1),
               exhausted=got[2], plain_exhausted=ref[2], lanes_differing=differ,
               t_differing=int(t_diff.sum()), max_abs_err=err)
    if differ or got[2] != ref[2] or stats["exhausted"] != got[2]:
        raise RuntimeError(f"{kernel} ({label}): {differ} of {stats['lanes']} lanes differ "
                           f"from the plain march (t {rec['t_differing']}, max |dp| {err:.3e});"
                           f" exhausted {got[2]} against {ref[2]}")
    if earlier is None:
        rec["ms"] = median_ms(launch, reps=10, inner=2)
    else:
        old_launch = _with_library(tracing, earlier, launch)
        t1, p1, _ = old_launch()
        old = tracing.last_stats(kernel)
        old_differ = int(((t1 != ref[0]) | (p1 != ref[1]).any(dim=1)).sum())
        if old_differ or old["exhausted"] != ref[2] or old["lane_steps"] != stats["lane_steps"]:
            raise RuntimeError(f"{kernel} ({label}): PR 13's design differs from the plain "
                               f"march in {old_differ} lanes, exhausted {old['exhausted']}, "
                               f"lane-steps {old['lane_steps']} against {stats['lane_steps']}")
        new_ms, old_ms = [], []
        for _ in range(MARCH_TURN_ROUNDS):
            new_ms.append(median_ms(launch, reps=10, inner=2))
            old_ms += [median_ms(old_launch, reps=10, inner=2) for _ in range(2)]
            new_ms.append(median_ms(launch, reps=10, inner=2))
        rec.update(ms=float(np.median(new_ms)), ms_rounds=new_ms,
                   pr13_ms=float(np.median(old_ms)), pr13_ms_rounds=old_ms,
                   pr13_warp_slots=old["warp_slots"],
                   pr13_simt_efficiency=old["lane_steps"] / max(old["warp_slots"], 1))
    rec["plain_ms"] = _wall_ms(plain, reps=plain_reps)
    flops = MARCH_OPS_PER_STEP[kernel] * stats["lane_steps"]
    rec["bound_ms"], rec["bound_by"] = bound(bytes_of(stats["lane_steps"]), flops, dtype_name)
    rec["library_ms"] = None          # no one PyTorch call computes a march
    old = ""
    if earlier is not None:
        old = (f"; PR 13's design in turns {rec['pr13_ms'] * 1e3:.2f} us "
               f"[{min(rec['pr13_ms_rounds']) * 1e3:.2f}-{max(rec['pr13_ms_rounds']) * 1e3:.2f}]"
               f", SIMT efficiency {rec['pr13_simt_efficiency']:.3f}, equal bit for bit")
    phase("7m", f"{kernel} ({label}, {dtype_name}): {stats['lanes']} lanes equal to the plain "
                f"march bit for bit, exhausted {got[2]}; lane-steps {stats['lane_steps']} "
                f"(max {stats['max_lane_steps']}), warp-step slots {stats['warp_slots']}, "
                f"SIMT efficiency {rec['simt_efficiency']:.3f}; kernel {rec['ms'] * 1e3:.2f} us"
                f", plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms'] * 1e3:.2f} us "
                f"({rec['bound_by']}, share {rec['bound_ms'] / rec['ms']:.3f})" + old)
    return rec


def check_march(prob, composed, earlier) -> list:
    """Phase 7m: each march kernel on the card against its plain version at
    the main path's lanes: the multigrid cell's level trace (its 2T
    barycentre lanes at -1/2 and +1/2 along phase 6's last tfield, float32,
    then in float64), the halfway march (every texel lane of both 2048^2
    textures), the init's exp remap (phase 6's out-of-triangle texels), and
    the composed tracker's Whitney marches (phase 6c's fields, last to
    first, from the barycentres). march_field and march_whitney are timed
    in turns with ``earlier``, PR 13's design of their kernel; the shipped
    kernel must be no slower than it at the level trace and the halfway."""
    import torch
    from meshopticalflow_tpu_torch.flow.pipeline import _halfway_lanes
    from meshopticalflow_tpu_torch.kernels import advect, tracing

    cfg, tm, tfield = prob.config, prob.arrays.tm, prob.tfield
    dev, dtype = tfield.device, tfield.dtype
    min_step, max_steps = cfg.flow_min_step, cfg.flow_max_steps
    budget = max_steps * MARCH_ESCALATE
    rows = []

    def field_case(label, tmx, field, times, t0, p0, dtype_name, plain_reps=5):
        elem = field.element_size()
        rows.append(_march_case(
            tracing, "march_field", label,
            lambda: advect.flow_field_trace_compacted(tmx, field, times, t0, p0, min_step,
                                                      max_steps),
            lambda: advect.flow_field_trace_compacted_plain(tmx, field, times, t0, p0,
                                                            min_step, max_steps),
            lambda: tracing.march(tmx, times, t0, p0, min_step, budget, vfield=field),
            lambda steps: _march_bytes("march_field", tmx, t0.shape[0], 3, elem,
                                       2 * tmx.n_triangles, steps),
            dtype_name, plain_reps, earlier))

    t_count = tm.n_triangles
    t0 = torch.arange(t_count, device=dev).repeat(2)
    p0 = torch.full((2 * t_count, 2), 1.0 / 3.0, dtype=dtype, device=dev)
    times = torch.cat([torch.full((t_count,), -0.5, dtype=dtype, device=dev),
                       torch.full((t_count,), 0.5, dtype=dtype, device=dev)])
    field_case("level trace", tm, tfield, times, t0, p0, "float32")
    t2, p2, times2 = _halfway_lanes(prob._advect_src_t, prob._advect_src_p, -0.5, 0.5)
    field_case("halfway", tm, tfield, times2, t2, p2, "float32", plain_reps=3)
    del t2, p2, times2
    tm64 = tracing.make_trace_mesh(prob.mesh, torch.float64, dev)
    field_case("level trace", tm64, tfield.double(), times.double(), t0, p0.double(),
               "float64")
    del tm64

    src = prob.texture_source
    idx = torch.as_tensor(np.nonzero(src.needs_remap)[0]).to(dev)
    t_in = torch.as_tensor(src.tri_idx).to(device=dev, dtype=torch.int64)[idx]
    p_in = torch.as_tensor(src.bary).to(device=dev, dtype=dtype)[idx]
    center = torch.full_like(p_in, 1.0 / 3.0)
    v = p_in - center
    rows.append(_march_case(
        tracing, "exp_map", "exp remap",
        lambda: tracing.exp_map(tm, t_in, center, v, with_diagnostics=True),
        lambda: tracing.exp_map_plain(tm, t_in, center, v, with_diagnostics=True),
        lambda: tracing.march_exp(tm, t_in, center, v, 1024),
        lambda steps: _march_bytes("exp_map", tm, t_in.shape[0], 4, 4, 0, steps),
        "float32", 5))

    ctm, fields = composed["tm"], composed["fields"]
    length, c_step, c_max = composed["length"], composed["min_step"], composed["max_steps"]
    t = torch.arange(ctm.n_triangles, device=dev)
    p = torch.full((ctm.n_triangles, 2), 1.0 / 3.0, dtype=fields.dtype, device=dev)
    for k, ce in enumerate(reversed(fields)):
        rows.append(_march_case(
            tracing, "march_whitney", f"composed field {k + 1} of {len(fields)}",
            lambda: tracing.whitney_flow_trace(ctm, ce, length, t, p, c_step, c_max,
                                               with_diagnostics=True),
            lambda: tracing.whitney_flow_trace_plain(ctm, ce, length, t, p, c_step, c_max,
                                                     with_diagnostics=True),
            lambda: tracing.march(ctm, length, t, p, c_step, c_max, ce=ce),
            lambda steps: _march_bytes("march_whitney", ctm, t.shape[0], 2, 4,
                                       3 * ctm.n_triangles, steps),
            "float32", 5, earlier))
        t, p = tracing.whitney_flow_trace(ctm, ce, length, t, p, c_step, c_max)
    slower = [f"{r['case']} {r['dtype']}: {r['ms'] * 1e3:.2f} us against "
              f"{r['pr13_ms'] * 1e3:.2f} us" for r in rows
              if r["name"] == "march_field" and r["dtype"] == "float32"
              and r["ms"] > r["pr13_ms"]]
    if slower:
        raise RuntimeError("march_field trails PR 13's design: " + "; ".join(slower))
    return rows


# ----------------------------------------------------------------------------
# Phase 7b: the banded Cholesky kernels at the main path's systems
# ----------------------------------------------------------------------------

# max |kernel - twin| / max |twin| of a solution or a factor, by rhs type
# (bf16 panels widen into a float32 rhs): the kernels sum in fixed orders,
# the twins in cuBLAS's and cuSOLVER's
BANDED_TOL = {"float32": 1e-5, "float64": 1e-12}
# a float32 factor's max |L - L64| / max |L64| from the float64 factor of
# the same input, at most this many times the twin's own: the solve panels
# can hide a factor that lost precision (the twin's cuSOLVER sums are no
# more exact than the kernel's; readings 1.13-1.52x)
BANDED_F32_FACTOR_VS_TWIN = 2.0
GRID_SYNC_BARRIERS = 2000     # barriers a timed grid_sync launch
BANDED_REPLACES = {"band_factor": "meshopticalflow_tpu/solvers/banded.py:130",
                   "panel_sweep": "meshopticalflow_tpu/solvers/banded.py:206/:224"}


def _max_rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _nonzeros(*tensors) -> int:
    return sum(int((t != 0).sum()) for t in tensors)


def _factor_work(s_blocks, l_blocks):
    """(bytes, operations) the factorization needs for this input: the band
    blocks' and the factor's non-zero entries once each; (c_j + 1)^2 for a
    column j of L with c_j entries below its diagonal (its root, c_j scalings
    and the c_j (c_j + 1) / 2 multiply-adds of its update of the lower half
    that is left), zeros the band's profile keeps skipped."""
    below = (l_blocks != 0).sum(dim=1) - 1
    flops = float(((below + 1).double() ** 2).sum())
    return _nonzeros(s_blocks, l_blocks) * s_blocks.element_size(), flops


def _banded_systems(prob, pack):
    """The main path's banded systems: (name, s_blocks in float64, nb, bw,
    panel width k, right-hand sides c, [(panel type, rhs type)], factor
    types): the last level's flow c1 (the multigrid and halo draws' c1
    system; the goldens' float64 path; ``mg_c1_bf16``'s bfloat16 panels),
    the smoothing c1 and the spectrum's S + sigma M (the CLI's last
    pack)."""
    import torch
    from meshopticalflow_tpu_torch.flow import pipeline as P
    from meshopticalflow_tpu_torch.models import base
    from meshopticalflow_tpu_torch.solvers.banded import band_revalue

    arrays, cfg, hier = prob.arrays, prob.config, prob.hier
    sy = _final_systems(prob)
    flow = base._make_mg_solver(arrays.basis, hier.coarse, hier.patch, sy["d_blocks"],
                                sy["scale"], sy["w"], sy["sys_vals"], sy["diag"], "mg3",
                                cfg.mg_cheb_k, cfg.mg_nu, cfg.mg_fine_cheb, True)
    vsolver, _ = P._vertex_mg_solver(arrays.smooth_ops, arrays.signals, hier,
                                     cfg.scalar_smooth_weight)
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    out = []
    for name, solver, c, pairs in (
            ("flow c1", flow, 1, [(f32, f32), (bf16, f32), (f64, f64)]),
            ("smoothing c1", vsolver, 6, [(f32, f32), (f64, f64)])):
        band, vals, _, _ = solver._c1_factor_args
        blocks = band_revalue(band.slots, vals.to(f64), band.m, band.nb, band.bw, band.n1)
        k = max(1, min(8, band.bw // band.nb))
        out.append((name, blocks, band.nb, band.bw, k, c, pairs, (f32, f64)))
    bs, pat = pack.bsolver, pack.bsolver.pat
    blocks = band_revalue(bs.slots, pack.sys_vals.to(f64), pat.m, pat.nb, pat.bw, pat.n)
    out.append(("spectrum", blocks, pat.nb, pat.bw, bs.panel_k, 4, [(f32, f32)], (f32,)))
    return out, flow


def _in_turns(kernel, twin, kernel_reps, twin_reps):
    """Device ms of kernel and twin timed in turns (kernel, twin, twin,
    kernel), each behind the device sleep of ``median_ms``; the mean of each
    pair."""
    k1 = median_ms(kernel, **kernel_reps)
    t1 = median_ms(twin, **twin_reps)
    t2 = median_ms(twin, **twin_reps)
    k2 = median_ms(kernel, **kernel_reps)
    return (k1 + k2) / 2, (t1 + t2) / 2


def check_banded(prob, pack, draws) -> dict:
    """Phase 7b: band_factor and panel_sweep against their twins at the
    main path's three banded systems, in every type the draws use: the
    solve panels each factor gives (``build_solve_panels``) and each solve
    (lower then upper sweep, and each sweep alone from the same input)
    within BANDED_TOL, each float32 factor within BANDED_F32_FACTOR_VS_TWIN
    of the twin's distance to the float64 factor; device times in turns
    with the twin, bounds, the batched triangular inversion that builds the
    panels, one cuBLAS panel product (the component yardstick), one grid
    barrier, launches in every draw; then the last level's flow system
    solved twice, through
    the kernels and through the twins, equal in iterations and within 1e-5.
    The comparisons run outside every draw's counting window."""
    import torch
    from meshopticalflow_tpu_torch.kernels import banded as kb
    from meshopticalflow_tpu_torch.models import base
    from meshopticalflow_tpu_torch.solvers import mg
    from meshopticalflow_tpu_torch.solvers.banded import build_solve_panels

    systems, flow = _banded_systems(prob, pack)
    tname = {torch.float32: "float32", torch.float64: "float64", torch.bfloat16: "bfloat16"}
    # one grid barrier alone, at the grids of the smoothing, flow and
    # spectrum systems' launches: n barriers less an empty launch
    barrier_us = {}
    for blocks in (32, 96, 112):
        empty = median_ms(lambda: kb.grid_sync(blocks, 0, "cuda"), reps=9, inner=5)
        full = median_ms(lambda: kb.grid_sync(blocks, GRID_SYNC_BARRIERS, "cuda"), reps=9,
                         inner=5)
        barrier_us[blocks] = (full - empty) / GRID_SYNC_BARRIERS * 1e3
    phase("7b", "one grid barrier (cooperative_groups grid sync, 256-thread blocks): "
                + ", ".join(f"{us:.3f} us at {b} blocks" for b, us in barrier_us.items()))
    factors, sweeps = [], []
    for name, blocks, nb, bw, k, c, pairs, factor_types in systems:
        m = blocks.shape[0]
        for dt in factor_types:
            sb = blocks.to(dt).contiguous()
            l_k, ok_k = kb.band_factor(sb, 0.0, nb, bw)
            l_p, ok_p = kb.band_cholesky_plain(sb, 0.0, nb, bw)
            # the tolerance holds the solve panels each factor gives; the
            # blocks' own distance, and each factor's from the float64 factor
            # of the same (rounded) input, are recorded beside it
            (dinv_k, pbelow_k), (dinv_p, pbelow_p) = (build_solve_panels(l, k)
                                                      for l in (l_k, l_p))
            err = max(_max_rel(dinv_k, dinv_p), _max_rel(pbelow_k, pbelow_p))
            rec = dict(system=name, dtype=tname[dt], m=m, nb=nb, bw=bw, ok=bool(ok_k),
                       ok_twin=bool(ok_p), max_abs_err=float((l_k - l_p).abs().max()),
                       panels_rel_err=err, blocks_rel_err=_max_rel(l_k, l_p))
            if dt != torch.float64:
                l_ref, _ = kb.band_factor(sb.double(), 0.0, nb, bw)
                rec["blocks_rel_err_to_f64"] = _max_rel(l_k, l_ref)
                rec["twin_blocks_rel_err_to_f64"] = _max_rel(l_p, l_ref)
                del l_ref
            del dinv_k, pbelow_k, dinv_p, pbelow_p
            rec["ms"], rec["plain_ms"] = _in_turns(
                lambda: kb.band_factor(sb, 0.0, nb, bw),
                lambda: kb.band_cholesky_plain(sb, 0.0, nb, bw),
                dict(reps=5, inner=2), dict(reps=3, inner=1))
            nbytes, flops = _factor_work(sb, l_p)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, tname[dt])
            rec["gflop"] = flops / 1e9
            rec["build_panels_ms"] = median_ms(lambda: build_solve_panels(l_k, k), reps=3,
                                               inner=1)
            factors.append(rec)
            to_f64 = ("" if dt == torch.float64 else
                      f"; to the float64 factor: kernel {rec['blocks_rel_err_to_f64']:.3e}, "
                      f"twin {rec['twin_blocks_rel_err_to_f64']:.3e} (kernel <= "
                      f"{BANDED_F32_FACTOR_VS_TWIN} x twin)")
            phase("7b", f"band_factor {name} {tname[dt]} ({m} steps of {nb}, band {bw}): "
                        f"solve panels max|d|/max|x| {err:.3e} (tol {BANDED_TOL[tname[dt]]}); "
                        f"blocks {rec['blocks_rel_err']:.3e}{to_f64}; ok {rec['ok']} / twin "
                        f"{rec['ok_twin']}; kernel {rec['ms']:.3f} ms, twin "
                        f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
                        f"({rec['gflop']:.2f} GFLOP, {rec['bound_by']}, share "
                        f"{rec['bound_ms'] / rec['ms']:.3f}); "
                        f"panels built (batched solve_triangular) in "
                        f"{rec['build_panels_ms']:.3f} ms")
            near_f64 = dt == torch.float64 or (
                rec["blocks_rel_err_to_f64"]
                <= BANDED_F32_FACTOR_VS_TWIN * rec["twin_blocks_rel_err_to_f64"])
            if not (rec["ok"] and rec["ok_twin"] and err <= BANDED_TOL[tname[dt]] and near_f64):
                raise RuntimeError(f"band_factor {name} {tname[dt]}: {rec}")
        l64, _ = kb.band_cholesky_plain(blocks, 0.0, nb, bw)
        dinv64, pbelow64 = build_solve_panels(l64, k)
        mp, s_, _ = dinv64.shape
        gen = torch.Generator(device=blocks.device).manual_seed(mp)
        b64 = torch.randn((mp, s_, c), dtype=torch.float64, device=blocks.device,
                          generator=gen)
        for pdt, rdt in pairs:
            dinv, pbelow, b = dinv64.to(pdt), pbelow64.to(pdt), b64.to(rdt)
            y_k, y_p = kb.panel_sweep(dinv, pbelow, b, False), \
                kb.panel_lower_solve_plain(dinv, pbelow, b)
            x_k, x_p = kb.panel_sweep(dinv, pbelow, y_k, True), \
                kb.panel_upper_solve_plain(dinv, pbelow, y_p)
            rec = dict(system=name, panels=tname[pdt], rhs=tname[rdt], mp=mp, s=s_, bw=bw,
                       c=c, lower_err=_max_rel(y_k, y_p),
                       upper_err=_max_rel(x_k, kb.panel_upper_solve_plain(dinv, pbelow, y_k)),
                       solve_err=_max_rel(x_k, x_p), max_abs_err=float((x_k - x_p).abs().max()))
            rec["ms"], rec["plain_ms"] = _in_turns(
                lambda: kb.panel_sweep(dinv, pbelow, b, False),
                lambda: kb.panel_lower_solve_plain(dinv, pbelow, b),
                dict(reps=15, inner=5), dict(reps=5, inner=2))
            rec["upper_ms"], rec["upper_plain_ms"] = _in_turns(
                lambda: kb.panel_sweep(dinv, pbelow, y_k, True),
                lambda: kb.panel_upper_solve_plain(dinv, pbelow, y_k),
                dict(reps=15, inner=5), dict(reps=5, inner=2))
            rec["solve_issued_ms"] = issue_ms(
                lambda: kb.panel_sweep(dinv, pbelow, kb.panel_sweep(dinv, pbelow, b, False),
                                       True), reps=9, inner=3)
            # the panels' non-zero entries once (dinv's upper half, pbelow's
            # blocks past the band's staircase and the profile's zeros are
            # zero; the kernel reads them whole), the vectors once
            entries = _nonzeros(dinv, pbelow)
            rec["nonzero_share"] = entries / (dinv.numel() + pbelow.numel())
            rec["bound_ms"], rec["bound_by"] = bound(
                entries * dinv.element_size() + 2 * _nbytes(b), 2.0 * c * entries, tname[rdt])
            dw, bw_ = dinv[0].to(rdt), b[0]
            rec["panel_product_ms"] = median_ms(lambda: dw @ bw_, reps=9, inner=10)
            sweeps.append(rec)
            tol = BANDED_TOL[tname[rdt]]
            phase("7b", f"panel_sweep {name} {tname[pdt]} panels, {tname[rdt]} rhs ({mp} "
                        f"panels of {s_}, band {bw}, {c} columns): solve max|d|/max|x| "
                        f"{rec['solve_err']:.3e}, lower {rec['lower_err']:.3e}, upper "
                        f"{rec['upper_err']:.3e} (tol {tol}); lower {rec['ms'] * 1e3:.1f} us, "
                        f"upper {rec['upper_ms'] * 1e3:.1f} us (twins "
                        f"{rec['plain_ms'] * 1e3:.1f} / {rec['upper_plain_ms'] * 1e3:.1f} us), "
                        f"both issued {rec['solve_issued_ms'] * 1e3:.1f} us; bound "
                        f"{rec['bound_ms'] * 1e3:.1f} us a sweep ({rec['bound_by']}; "
                        f"non-zero share of the panels {rec['nonzero_share']:.3f}; share "
                        f"{rec['bound_ms'] / rec['ms']:.3f} lower, "
                        f"{rec['bound_ms'] / rec['upper_ms']:.3f} upper); one cuBLAS panel "
                        f"product ({s_}x{s_} by {s_}x{c}) {rec['panel_product_ms'] * 1e3:.2f} us")
            if max(rec["solve_err"], rec["lower_err"], rec["upper_err"]) > tol:
                raise RuntimeError(f"panel_sweep {name}: {rec}")

    # the last level's flow system, solved through the kernels and the twins
    cfg, hier, arrays = prob.config, prob.hier, prob.arrays
    sy = _final_systems(prob)
    rho = dict(hier.patch.mg_pack.rho)

    def solve_once():
        hier.patch.mg_pack.rho.clear()
        hier.patch.mg_pack.rho.update(rho)
        solver = base._make_mg_solver(arrays.basis, hier.coarse, hier.patch, sy["d_blocks"],
                                      sy["scale"], sy["w"], sy["sys_vals"], sy["diag"], "mg3",
                                      cfg.mg_cheb_k, cfg.mg_nu, cfg.mg_fine_cheb, True)
        x, st = solver.solve(sy["rhs"], tol=cfg.cg_tol, max_iters=min(cfg.cg_max_iters, 200))
        torch.cuda.synchronize()
        return x, st

    kb.reset_counts()
    x_k, st_k = solve_once()
    via_kernels = kb.counts()
    real = (mg.band_cholesky, mg.panel_lower_solve, mg.panel_upper_solve)
    mg.band_cholesky, mg.panel_lower_solve, mg.panel_upper_solve = (
        kb.band_cholesky_plain, kb.panel_lower_solve_plain, kb.panel_upper_solve_plain)
    try:
        kb.reset_counts()
        x_p, st_p = solve_once()
        via_twins = kb.counts()
    finally:
        mg.band_cholesky, mg.panel_lower_solve, mg.panel_upper_solve = real
    last = dict(iterations_kernels=st_k.iterations, iterations_twins=st_p.iterations,
                residual_kernels=st_k.rel_residual, residual_twins=st_p.rel_residual,
                rel_diff=_max_rel(x_k, x_p), launches_kernels=via_kernels,
                launches_twins=via_twins)
    phase("7b", f"last level's flow system ({arrays.basis.n_coeffs} unknowns): through the "
                f"kernels {st_k.iterations} iterations (residual {st_k.rel_residual:.3e}, "
                f"{via_kernels['band_factor']} factor and {via_kernels['panel_sweep']} sweep "
                f"launches), through the twins {st_p.iterations} ({st_p.rel_residual:.3e}, "
                f"{via_twins['plain_on_cuda']} twin calls, {via_twins['panel_sweep']} "
                f"launches); solutions max|d|/max|x| {last['rel_diff']:.3e} (<= 1e-5)")
    if (st_k.iterations != st_p.iterations or last["rel_diff"] > 1e-5
            or via_kernels["plain_on_cuda"] or via_twins["panel_sweep"]
            or via_twins["band_factor"] or not via_kernels["panel_sweep"]):
        raise RuntimeError(f"last-level flow solve, kernels against twins: {last}")
    launches = {tag: d["launches"]["banded"] for tag, d in draws.items()
                if "launches" in d and "banded" in d["launches"]}
    return dict(factors=factors, sweeps=sweeps, last_level=last, launches=launches,
                barrier_us=barrier_us)


BAKE_SIZES = (2048, 4096)


def _bake_touched(uvs: np.ndarray, size: int, bilinear: bool) -> int:
    """Distinct texels that the bake's taps read in one size x size texture."""
    uv = uvs.reshape(-1, 2)
    x = np.clip(uv[:, 0], 0, 1) * (size - 1)
    y = np.clip(1.0 - uv[:, 1], 0, 1) * (size - 1)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    taps = [(y0, x0)]
    if bilinear:
        x1, y1 = np.minimum(x0 + 1, size - 1), np.minimum(y0 + 1, size - 1)
        taps += [(y0, x1), (y1, x1), (y1, x0)]
    return int(np.unique(np.concatenate([yy * size + xx for yy, xx in taps])).size)


def check_bake() -> list:
    """Phase 7k: bake_vertices on the main path's mesh at BAKE_SIZES,
    bilinear and nearest, both textures the golden pair upsampled: equal to
    the host copy and to the twin bit for bit; device ms warm (median_ms)
    and cold (cold_ms); the twin's device ms on the same CUDA tensors; the
    host copy's wall ms (both textures); ``pair_ms``, the wall ms of what
    from_texture_inputs does around the kernel (the two uploads, the launch,
    the download); the byte bound: uvs, wedge ids and offsets read once,
    the output written once, and the texels that the taps read (3 bytes
    each, two textures)."""
    import torch

    from meshopticalflow_tpu_torch.flow.pipeline import sample_texture_to_vertices
    from meshopticalflow_tpu_torch.io.png import read_png_rgb
    from meshopticalflow_tpu_torch.kernels import bake
    from meshopticalflow_tpu_torch.utils.testing import main_path_mesh

    tris, uvs = main_path_mesh(os.path.join(GOLD, "cube.ply"))
    n_vertices, n_wedges = int(tris.max()) + 1, tris.size
    wedges, offsets = bake.wedge_table(tris, n_vertices, DEVICE)
    golden = [read_png_rgb(os.path.join(GOLD, n)) for n in ("mA.png", "mB.png")]
    report = []
    for size in BAKE_SIZES:
        f = size // golden[0].shape[0]
        textures = np.stack([np.repeat(np.repeat(g, f, axis=0), f, axis=1) for g in golden])
        tex = torch.from_numpy(textures).to(DEVICE)
        uv = torch.from_numpy(uvs.reshape(-1, 2)).to(DEVICE)
        for bilinear in (True, False):
            bake.reset_counts()
            got = bake.bake_vertices(tex, uv, wedges, offsets, bilinear)
            launches = bake.bake_vertices.launches
            twin = bake.bake_vertices_plain(tex, uv, wedges, offsets, bilinear)
            t0 = time.perf_counter()
            host = np.stack([sample_texture_to_vertices(tris, uvs, t, n_vertices, bilinear)
                             for t in textures])
            host_ms = (time.perf_counter() - t0) * 1e3
            equal = bool(np.array_equal(got.cpu().numpy(), host)) and bool(torch.equal(got, twin))
            if not equal or launches != 1:
                raise RuntimeError(f"bake {size}^2 bilinear={bilinear}: equal {equal}, "
                                   f"{launches} launches")

            def pair():
                t = torch.from_numpy(textures).to(DEVICE)
                u = torch.from_numpy(uvs.reshape(-1, 2)).to(DEVICE)
                return bake.bake_vertices(t, u, wedges, offsets, bilinear).cpu().numpy()

            pair_times = []
            for _ in range(7):
                t0 = time.perf_counter()
                pair()
                pair_times.append((time.perf_counter() - t0) * 1e3)
            touched = _bake_touched(uvs, size, bilinear)
            nbytes = 20 * n_wedges + 4 * (n_vertices + 1) + 48 * n_vertices + 6 * touched
            rec = dict(size=size, bilinear=bilinear, equal=equal, wedges=n_wedges,
                       vertices=n_vertices, touched_texels=touched, bytes=nbytes,
                       bound_ms=nbytes / (HBM_TB_S * 1e12) * 1e3,
                       ms=median_ms(lambda: bake.bake_vertices(tex, uv, wedges, offsets,
                                                               bilinear)),
                       ms_cold=cold_ms(lambda: bake.bake_vertices(tex, uv, wedges, offsets,
                                                                  bilinear)),
                       plain_ms=median_ms(lambda: bake.bake_vertices_plain(
                           tex, uv, wedges, offsets, bilinear), reps=5, inner=2),
                       host_ms=host_ms, pair_ms=float(np.median(pair_times)))
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            report.append(rec)
            phase("7k", f"bake_vertices {size}^2 {'bilinear' if bilinear else 'nearest'}: "
                        f"bit for bit with the host copy and the twin; kernel "
                        f"{rec['ms'] * 1e3:.2f} us warm, {rec['ms_cold'] * 1e3:.2f} us cold, "
                        f"bound {rec['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, "
                        f"{touched} texels tapped; share {rec['bound_share']:.3f}); twin "
                        f"{rec['plain_ms'] * 1e3:.1f} us; host copy {host_ms:.1f} ms; "
                        f"uploads + kernel + download {rec['pair_ms']:.2f} ms")
        del tex, uv
    bake.reset_counts()
    return report


def bake_only(card: str) -> int:
    """``python3 chip_smoke.py --bake``: phase 7k alone (its build, then
    check_bake); records chiprun_out/chip_smoke/bake.json."""
    import torch

    sys.path.insert(0, REPO)
    from meshopticalflow_tpu_torch.kernels import bake

    os.makedirs(WORK, exist_ok=True)
    t0 = time.time()
    bake.LIBRARY.load()
    phase(2, f"built {os.path.relpath(bake.LIBRARY.path(), REPO)} in {time.time() - t0:.2f} s")
    report = check_bake()
    with open(os.path.join(WORK, "bake.json"), "w") as f:
        json.dump(dict(card=card, bake=report), f, indent=1)
    print(card)
    print(json.dumps({"bake": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def iteration_split(prob):
    """One multigrid PCG iteration of the last level's flow system, each
    part timed alone: the exact c1 solve (the two banded sweeps), the whole
    V-cycle, the whole iteration; and one c1 factorization."""
    import torch
    from meshopticalflow_tpu_torch.flow import pipeline as P
    from meshopticalflow_tpu_torch.models import base
    from meshopticalflow_tpu_torch.solvers import mg

    arrays, cfg, hier = prob.arrays, prob.config, prob.hier
    sy = _final_systems(prob)
    rhs = sy["rhs"]
    solver = base._make_mg_solver(arrays.basis, hier.coarse, hier.patch, sy["d_blocks"],
                                  sy["scale"], sy["w"], sy["sys_vals"], sy["diag"],
                                  "mg3", cfg.mg_cheb_k, cfg.mg_nu, cfg.mg_fine_cheb, True)
    r1 = torch.ones(hier.patch.mg_pack.n1, dtype=prob.dtype, device=prob.device)
    zero = torch.zeros_like(rhs)
    rz0 = torch.ones((), dtype=prob.dtype, device=prob.device)
    vsolver, vb = P._vertex_mg_solver(arrays.smooth_ops, arrays.signals, hier,
                                      cfg.scalar_smooth_weight)
    rv = torch.ones((hier.vcoarse.mg_pack.n1, vb.shape[1]), dtype=prob.dtype,
                    device=prob.device)
    parts = dict(
        smooth_c1_solve=lambda: mg._inner1_exact(vsolver.c1_dinv, vsolver.c1_pbelow,
                                                 vsolver.c1_band, rv),
        c1_solve=lambda: mg._inner1_exact(solver.c1_dinv, solver.c1_pbelow,
                                          solver.c1_band, r1),
        cycle=lambda: solver._precondition(rhs),
        iteration=lambda: solver._chunk(zero, rhs, zero, rz0, 1))
    out = dict(factor_s=solver.factor_seconds, panels=int(solver.c1_dinv.shape[0]),
               panel_width=int(solver.c1_dinv.shape[1]),
               band_width=int(solver.c1_pbelow.shape[1]))
    for key, fn in parts.items():
        out[key + "_device_ms"] = median_ms(fn, reps=9, inner=3)
        out[key + "_issued_ms"] = issue_ms(fn, reps=9, inner=3)
    out["device_idle_share_of_iteration"] = 1 - (out["iteration_device_ms"]
                                                 / out["iteration_issued_ms"])
    phase(7, "one flow PCG iteration: {iteration_issued_ms:.3f} ms issued ({iteration_device_ms:.3f}"
             " ms of device time); V-cycle {cycle_issued_ms:.3f} ms ({cycle_device_ms:.3f});"
             " exact c1 solve, two sweeps over {panels} panels of {panel_width}: "
             "{c1_solve_issued_ms:.3f} ms ({c1_solve_device_ms:.3f}); c1 factorization "
             "{factor_s:.3f} s".format(**out))
    phase(7, f"device idle {100 * out['device_idle_share_of_iteration']:.1f} % of the "
             f"iteration; smoothing c1 solve "
             f"{out['smooth_c1_solve_issued_ms']:.3f} ms "
             f"({out['smooth_c1_solve_device_ms']:.3f})")
    return out


# ----------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")
    t_start = time.time()
    card = card_line()
    phase(1, f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if sys.argv[1:] == ["--nccl"]:
        return nccl_only(card)
    if sys.argv[1:] == ["--bake"]:
        return bake_only(card)
    # the artifact cache, the baked frames, the tracker's and the spectrum's
    # outputs (hundreds of MB) stay out of the records directory
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as scratch:
        os.environ["MESHFLOW_CACHE"] = os.path.join(scratch, "artifacts")
        return run_phases(card, scratch, t_start)


def run_phases(card: str, scratch: str, t_start: float) -> int:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    sys.path.insert(0, REPO)
    import march_sweep
    from meshopticalflow_tpu_torch import native
    from meshopticalflow_tpu_torch.kernels import bake, banded, build, probes, spmv, tracing

    os.makedirs(WORK, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    earlier_march = march_sweep.case_library("pr13")     # PR 13's march kernel
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build)      # g++, beside the nvcc builds
        libs = build.build_all([spmv.LIBRARY, probes.LIBRARY, tracing.LIBRARY,
                                banded.LIBRARY, bake.LIBRARY, earlier_march])
        libs["meshhost"] = host_lib.result()
    spmv.LIBRARY.load()
    probes.LIBRARY.load()
    tracing.LIBRARY.load()
    banded.LIBRARY.load()
    bake.LIBRARY.load()
    if native.get_lib() is None:
        raise RuntimeError("the native host library does not load")
    phase(2, f"built {', '.join(os.path.relpath(p, REPO) for p in libs.values())} "
             f"in {time.time() - t0:.2f} s")

    probe_report = probe_phase(probes)
    goldens = check_goldens(spmv)

    paths, size = upsampled_inputs()
    jacobi = jacobi_path(spmv, paths, size, levels=10)
    torch.cuda.empty_cache()

    root = write_mg_root()
    prob, mg_rec = multigrid_path(spmv, root, paths, size)
    operators = mg_operators(prob)
    operators += split_operators(operators)
    draws = {"multigrid": mg_rec, "jacobi": jacobi}
    for vf_mode, tag in ((1, "conformal"), (2, "connection")):
        tprob, draws[tag] = twolevel_path(spmv, root, paths, size, vf_mode, tag)
        operators += twolevel_operators(tprob, tag, f64=tag == "conformal",
                                        vertex=tag == "conformal")
        del tprob
    torch.cuda.empty_cache()
    draws["xla"], draws["mf"] = mf_path(spmv, root, paths, size, mg_rec)
    torch.cuda.empty_cache()
    hprob, draws["halo"] = halo_path(spmv, root, paths, size, draws["xla"], draws["mf"])
    operators.append(halo_operator(_halo_layout(hprob)))
    del hprob
    torch.cuda.empty_cache()
    draws["xla_group"] = xla_group_path(spmv, root, paths, size, draws["mf"])
    if torch.cuda.device_count() >= 2:
        draws["halo"]["nccl"] = nccl_exchange(2)
        phase("6f", "the halo solve over NCCL in 2 processes, one per GPU: "
                    + json.dumps({r["rank"]: r["split"]["iters"] for r in
                                  draws["halo"]["nccl"]["ranks"]}) + " iterations a rank, "
                    "equal to the world-size-1 solve")
    else:
        phase("6f", "the multi-rank NCCL exchange was not run: this machine shows "
                    f"{torch.cuda.device_count()} GPU (the gloo tests on the CPU hold the "
                    "multi-rank logic)")
    torch.cuda.empty_cache()
    draws["warm_init"] = warm_init_path(spmv, root, paths, size)
    torch.cuda.empty_cache()

    draws["tracking"], composed = tracking_path(spmv, paths, size, scratch)
    torch.cuda.empty_cache()
    draws["spectrum"], spectrum_ops = spectrum_path(spmv, scratch)
    operators += spectrum_operators(*spectrum_ops)
    draws["viewer"] = viewer_path(spmv, paths, size, scratch)

    rates = dict(hbm_copy_tb_s=copy_rate_tb_s(2 ** 30), l2_copy_tb_s=copy_rate_tb_s(2 ** 24))
    phase(7, f"measured copy rates: HBM {rates['hbm_copy_tb_s']:.3f} TB/s (1 GB), "
             f"L2-resident {rates['l2_copy_tb_s']:.3f} TB/s (16 MB); published HBM "
             f"{HBM_TB_S} TB/s")
    spmv_report = check_spmv(spmv, operators, rates["l2_copy_tb_s"], draws)
    banded_report = check_banded(prob, spectrum_ops[1], draws)
    del operators, spectrum_ops
    record_halo_form(spmv_report, draws["halo"])
    march_report = check_march(prob, composed, earlier_march)
    del composed
    split = iteration_split(prob)
    del prob
    torch.cuda.empty_cache()
    bake_report = check_bake()

    def row(name, op, dtype="float32"):
        return next(r for r in spmv_report
                    if r["name"] == name and r["operator"] == op and r["dtype"] == dtype)

    kernels = []
    for name, op, line in (("spmv_ell", "flow", 76), ("spmv_ell_multi", "smoothing", 395)):
        r = row(name, op)
        kernels.append(dict(
            name=name, route="cuda", source="meshopticalflow_tpu_torch/csrc/spmv_ell.cu",
            replaces=f"meshopticalflow_tpu/kernels/pallas_spmv.py:{line}",
            launches=mg_rec["launches"][name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], ms_cold=r["ms_cold"], issue_ms=r["issue_ms"],
            **{f"launches_{tag}_path": draws[tag]["launches"][name]
               for tag in ("jacobi", "conformal", "connection", "xla", "mf", "halo",
                           "xla_group", "warm_init", "tracking", "spectrum", "viewer")}))
    for name, draw in (("march_field", "multigrid"), ("march_whitney", "tracking"),
                       ("exp_map", "multigrid")):
        r = next(r for r in march_report if r["name"] == name)
        kernels.append(dict(
            name=name, route="cuda", source="meshopticalflow_tpu_torch/csrc/trace.cu",
            replaces=MARCH_REPLACES[name], launches=draws[draw]["launches"]["march"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            lanes=r["lanes"], lane_steps=r["lane_steps"], max_lane_steps=r["max_lane_steps"],
            exhausted=r["exhausted"], simt_efficiency=r["simt_efficiency"],
            **{k: r[k] for k in ("pr13_ms", "pr13_simt_efficiency") if k in r},
            **{f"launches_{tag}_path": draws[tag]["launches"]["march"][name]
               for tag in ("multigrid", "jacobi", "conformal", "connection", "xla", "mf",
                           "halo", "xla_group", "warm_init", "tracking", "spectrum",
                           "viewer")}))
    flow_factor = next(r for r in banded_report["factors"]
                       if r["system"] == "flow c1" and r["dtype"] == "float32")
    flow_sweep = next(r for r in banded_report["sweeps"]
                      if r["system"] == "flow c1" and r["panels"] == "float32")
    for name, r, extra in (
            ("band_factor", flow_factor, dict(build_panels_ms=flow_factor["build_panels_ms"],
                                              panel_product_ms=flow_sweep["panel_product_ms"])),
            ("panel_sweep", flow_sweep, dict(upper_ms=flow_sweep["upper_ms"],
                                             upper_plain_ms=flow_sweep["upper_plain_ms"],
                                             solve_issued_ms=flow_sweep["solve_issued_ms"],
                                             panel_product_ms=flow_sweep["panel_product_ms"]))):
        kernels.append(dict(
            name=name, route="cuda", source="meshopticalflow_tpu_torch/csrc/banded.cu",
            replaces=BANDED_REPLACES[name], launches=draws["multigrid"]["launches"]["banded"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None, **extra,
            **{f"launches_{tag}_path": n[name] for tag, n in banded_report["launches"].items()}))
    r = next(r for r in bake_report if r["size"] == size and r["bilinear"])
    kernels.append(dict(
        name="bake_vertices", route="cuda", source="meshopticalflow_tpu_torch/csrc/bake.cu",
        replaces=None, launches=draws["multigrid"]["launches"]["bake"], max_abs_err=0.0,
        ms=r["ms"], plain_ms=r["plain_ms"], host_ms=r["host_ms"], bound_ms=r["bound_ms"],
        bound_by="bytes", library_ms=None))
    for fn_name, rec in probe_report.items():
        kernels.append(dict(
            name=fn_name, route="cuda", source="meshopticalflow_tpu_torch/csrc/probes.cu",
            replaces=rec["replaces"], launches=rec["launches"],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"], issue_ms=rec["issue_ms"], large=rec.get("large")))
    elapsed = time.time() - t_start
    with open(os.path.join(WORK, "kernels.json"), "w") as f:
        json.dump(dict(card=card, rates=rates, spmv=spmv_report, probes=probe_report,
                       march=march_report, banded=banded_report, bake=bake_report,
                       iteration_split=split, sweeps=mg_rec["sweeps"], goldens=goldens,
                       twolevel_split={t: draws[t]["split"] for t in ("conformal",
                                                                      "connection")},
                       mf=draws["mf"]["nd"], warm_init={k: draws["warm_init"][k] for k in (
                           "init_s", "levels_s", "shared", "same_tfield", "artifact_mb")},
                       halo={k: draws["halo"][k] for k in (
                           "layout", "halo_form_launches", "alignment_rel_to_xla", "nccl")},
                       seconds=elapsed), f, indent=1)
    phase(8, f"all phases passed in {elapsed:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def nccl_only(card: str) -> int:
    """``python3 chip_smoke.py --nccl`` on a machine with two or more GPUs:
    the halo solve over NCCL, then the row-split xla draw at full width
    (the multigrid cell: 393,216 triangles, 2048^2) against one rank's
    draw, each at 2 ranks and at every GPU of the host."""
    import torch

    sys.path.insert(0, REPO)
    from meshopticalflow_tpu_torch.kernels import spmv

    count = torch.cuda.device_count()
    if count < 2:
        raise SystemExit(f"chip_smoke --nccl: needs two or more GPUs, this machine shows {count}")
    os.makedirs(WORK, exist_ok=True)
    spmv.LIBRARY.load()
    out, split = {}, {}
    for world in sorted({2, count}):
        out[world] = nccl_exchange(world)
        for r in out[world]["ranks"]:
            phase("6f", f"NCCL world {world} rank {r['rank']} on {r['device']}: halo "
                        f"{r['split']['halo']}, block {r['split']['block']}, "
                        f"{r['split']['bytes']} B sent a product, "
                        f"{r['split']['iters']} iterations, residual "
                        f"{r['split']['residual']:.3e}")
    paths, size = upsampled_inputs()
    root = write_mg_root()
    for world in sorted({2, count}):
        # one one-rank draw, at the first size, is the reference of both
        first = split[min(split)]["ranks"][0]["solo"] if split else None
        split[world] = nccl_xla(world, root, paths, solo=first)
        for r in split[world]["ranks"]:
            for tag in ("split", "solo"):
                if tag not in r:
                    continue
                d = r[tag]
                who = (f"NCCL xla world {world} rank {r['rank']} on {r['device']}"
                       if tag == "split" else f"one-rank xla draw on {r['device']}")
                phase("6f", f"{who}: rows {json.dumps(d['rows'])}; peak "
                            f"{d['peak_mem_gb']:.3f} GB; init {d['init_s']:.2f} s, levels "
                            f"{d['levels_s']:.2f} s (smooth {d['stage_s']['smooth']:.2f} / trace "
                            f"{d['stage_s']['trace']:.2f} / solve {d['stage_s']['solve']:.2f}), "
                            f"halfway {d['halfway_s']:.2f} s; flow_iters per level "
                            + ", ".join(f"{i:.0f}" for i in d["flow_iters"])
                            + f"; a fine flow product gathers {d['gather_bytes_flow']} B, a "
                            f"smoothing product {d['gather_bytes_smooth']} B; launches "
                            + json.dumps(d["launches"]))
            phase("6f", f"NCCL xla world {world} rank {r['rank']}: under deterministic "
                        f"algorithms final alignment error {r['split']['det_alignment_error']:.6f}"
                        f", one rank {r['alignment_rel_to_one_rank']:.3e} relative away "
                        f"(<= {SPLIT_ALIGNMENT_REL}); flow_iters per level minus one rank's "
                        f"{r['flow_iters_diff']}; failed checks {r['failed']}")
    with open(os.path.join(WORK, "nccl.json"), "w") as f:
        json.dump(dict(card=card, runs=out, split_xla=split), f, indent=1)
    failed = {(w, r["rank"]): r["failed"] for w, o in split.items() for r in o["ranks"]
              if r["failed"]}
    if failed:
        raise RuntimeError(f"NCCL xla: checks failed (world, rank): {failed}")
    print(card)
    print(json.dumps({"nccl": {w: len(o["ranks"]) for w, o in out.items()},
                      "split_xla": {w: len(o["ranks"]) for w, o in split.items()}, "ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

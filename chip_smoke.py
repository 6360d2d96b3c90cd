"""GPU smoke run of the PyTorch port (meshopticalflow_tpu_torch).

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA GPU, in phases;
any failure raises, so the run exits non-zero and prints no final ok line.

  1. the card's name and power limit; refuse to run without a GPU;
  2. build the CUDA kernels from the checkout's sources (nvcc);
  3. each kernel against its plain PyTorch version on the card, at the
     operators of the main-path problem (the level-0 flow system and the
     6-column smoothing system), in float32, bfloat16 and float64, with
     median times of kernel and plain version;
  4. the reference-binary goldens in float64 on the card, through the kernels;
  5. the main path at full size: tests/golden/cube.ply at the CLI's default
     edge length (393,216 triangles) with the 256^2 golden textures
     upsampled 8x to 2048^2, CLI defaults (float32, 10 levels),
     from_texture_inputs -> run -> halfway_texture;
  6. the result line.

The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Scratch files go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "golden")
WORK = os.path.join(REPO, "chiprun_out", "chip_smoke")
# max |kernel - plain| / max |plain| allowed per value type
KERNEL_TOL = {"float32": 1e-6, "bfloat16": 1e-6, "float64": 1e-12}


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back calls."""
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


def check_kernels(problem, spmv):
    """Phase 3: kernels against plain versions at the main-path operators."""
    import torch
    from meshopticalflow_tpu_torch.flow import pipeline as P
    from meshopticalflow_tpu_torch.flow.signal import _smooth_system
    from meshopticalflow_tpu_torch.models.base import build_flow_system

    arrays, cfg = problem.arrays, problem.config
    smoothed, _ = P._stage_smooth(arrays, cfg.scalar_smooth_weight, cfg)
    d_blocks, rhs_t, _, _, _ = P._stage_resample(arrays, problem.tfield, smoothed, cfg)
    weight = torch.tensor(cfg.resolved_vf_smooth_weight(), dtype=problem.dtype,
                          device=problem.device)
    flow_vals, _, flow_rhs, _, _ = build_flow_system(arrays.basis, d_blocks, rhs_t,
                                                     weight)
    smooth_vals, smooth_b, _ = _smooth_system(arrays.smooth_ops, arrays.signals,
                                              cfg.scalar_smooth_weight)
    ops = {"spmv_ell": (arrays.basis.ell_cols, flow_vals, flow_rhs),
           "spmv_ell_multi": (arrays.smooth_ops.cols, smooth_vals, smooth_b)}
    report = {}
    for name, (cols, vals, x) in ops.items():
        kernel = getattr(spmv, name)
        plain = getattr(spmv, name + "_plain")
        report[name] = {"shape": list(cols.shape) + ([x.shape[1]] if x.dim() == 2 else [])}
        for tname, vdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                           ("float64", torch.float64)):
            xdt = torch.float64 if vdt == torch.float64 else torch.float32
            v = vals.to(vdt).contiguous()
            xx = x.to(xdt).contiguous()
            y = kernel(cols, v, xx)
            ref = plain(cols, v, xx)
            torch.cuda.synchronize()
            if not (torch.isfinite(y).all() and torch.isfinite(ref).all()):
                raise RuntimeError(f"{name} {tname}: non-finite output")
            abs_err = float((y - ref).abs().max())
            rel = abs_err / max(float(ref.abs().max()), 1e-300)
            ms = median_ms(lambda: kernel(cols, v, xx))
            plain_ms = median_ms(lambda: plain(cols, v, xx))
            report[name][tname] = dict(max_abs_err=abs_err, rel_err=rel, ms=ms,
                                       plain_ms=plain_ms)
            phase(3, f"{name} {tname} {tuple(cols.shape)} x{tuple(xx.shape)}: "
                     f"max|d|/max|y| {rel:.3e} (tol {KERNEL_TOL[tname]:.0e}), "
                     f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us")
            if not rel <= KERNEL_TOL[tname]:
                raise RuntimeError(f"{name} {tname}: kernel disagrees with plain "
                                   f"version ({rel:.3e} > {KERNEL_TOL[tname]:.0e})")
    return report


def vertex_blend(device):
    """The per-vertex halfway blend (float64) of the a/b golden pair."""
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    cfg = config_from_args(build_parser().parse_args(
        ["--in", a, b, "--out", "unused.ply", "--dtype", "float64"]))
    prob = FlowProblem.from_vertex_inputs(a, b, cfg, device=device)
    prob.run()
    prob.write_output(os.path.join(WORK, f"golden_vertex_{device}.ply"))
    adv = prob.advected_vertex_colors()
    return (adv[0] + adv[1]) / 2.0


def check_goldens(spmv):
    """Phase 4: the vertex and 256^2 texture goldens in float64 on the card.

    The vertex golden is truncated to u8 from float64 blends; where a blend
    is an integer to float64 precision (a knife edge), the card's other sum
    orders may land one ulp below it. The CPU run must reproduce the golden
    byte for byte; the card must match it on every channel that is not such
    a knife edge, and be within one level on those that are."""
    from meshopticalflow_tpu_torch.apps.optical_flow import main as cli
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    ref = read_triangle_mesh(os.path.join(GOLD, "ref_vertex.ply")).colors.astype(int)
    cpu = vertex_blend("cpu")
    spmv.reset_counts()
    gpu = vertex_blend("cuda")
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
    out_t = os.path.join(WORK, "golden_cube256.png")
    t0 = time.time()
    cli(["--mesh", os.path.join(GOLD, "cube.ply"), "--in", os.path.join(GOLD, "mA.png"),
         os.path.join(GOLD, "mB.png"), "--out", out_t, "--eLength", "0.06",
         "--dtype", "float64", "--device", "cuda"])
    secs = time.time() - t0
    a = read_png_rgb(out_t).astype(float)
    b = read_png_rgb(os.path.join(GOLD, "ref_cube256.png")).astype(float)
    rmse = float(np.sqrt(((a - b) ** 2).mean()))
    exact = float((a == b).all(-1).mean())
    within1 = float((np.abs(a - b) <= 1).all(-1).mean())
    counts = spmv.counts()
    phase(4, f"ref_cube256.png: rmse {rmse:.3f} (< 2.2), exact {exact:.4f} (> 0.97), "
             f"within1 {within1:.4f} (> 0.995), {secs:.1f} s; launches {counts}")
    if not (rmse < 2.2 and exact > 0.97 and within1 > 0.995):
        raise RuntimeError("256^2 golden outside the thresholds on the card")
    if counts["spmv_ell"] == 0 or counts["spmv_ell_multi"] == 0 or counts["plain_on_cuda"]:
        raise RuntimeError(f"golden runs did not go through the kernels: {counts}")


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


def main_path(spmv, paths, size):
    """Phase 5: one draw of the main path at full size, timed like bench.py."""
    import torch
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.io.png import write_png_rgb

    mesh = os.path.join(GOLD, "cube.ply")
    cfg = config_from_args(build_parser().parse_args(
        ["--mesh", mesh, "--in", *paths, "--out", "unused.png"]))
    spmv.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    prob = FlowProblem.from_texture_inputs(mesh, tuple(paths), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    t0 = time.time()
    res = prob.run()
    torch.cuda.synchronize()
    run_s = time.time() - t0
    t0 = time.time()
    blend = prob.halfway_texture()
    out_s = time.time() - t0
    counts = spmv.counts()
    out_path = os.path.join(WORK, f"halfway_{size}.png")
    write_png_rgb(out_path, np.flipud(blend))
    total_s = init_s + run_s + out_s
    rec = dict(triangles=prob.mesh.n_triangles, vertices=prob.mesh.n_vertices,
               flow_unknowns=prob.arrays.basis.n_coeffs,
               flow_ell_width=prob.arrays.basis.ell_width,
               smooth_ell_width=int(prob.arrays.smooth_ops.cols.shape[1]),
               atlas=size, texel_lanes=2 * size * size,
               init_s=init_s, levels_s=run_s, advect_s=out_s, total_s=total_s,
               e2e_texels_per_sec=size * size / total_s,
               init_profile=prob.init_profile,
               levels=[{k: m[k] for k in (
                   "level", "smooth_seconds", "trace_seconds", "solve_seconds",
                   "seconds", "flow_iters", "smooth_iters", "flow_res",
                   "smooth_res", "alignment_error", "trace_exhausted")}
                   for m in res.metrics],
               halfway_exhausted=prob.last_advect_stats["exhausted"],
               launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    with open(os.path.join(WORK, "main_path.json"), "w") as f:
        json.dump(rec, f, indent=1)
    for m in rec["levels"]:
        phase(5, "level {level}: smooth {smooth_seconds:.3f} s, trace "
                 "{trace_seconds:.3f} s, solve {solve_seconds:.3f} s, flow_iters "
                 "{flow_iters:.0f}, smooth_iters {smooth_iters:.0f}, flow_res "
                 "{flow_res:.3e}, alignment_error {alignment_error:.6f}, "
                 "trace_exhausted {trace_exhausted:.0f}".format(**m))
    phase(5, f"{rec['triangles']} triangles, {rec['flow_unknowns']} flow unknowns "
             f"(ELL width {rec['flow_ell_width']}), {size}^2 atlas: init {init_s:.2f} s, "
             f"levels {run_s:.2f} s, halfway {out_s:.2f} s, e2e "
             f"{rec['e2e_texels_per_sec']:.1f} texels/s; launches {counts}; "
             f"peak {rec['peak_mem_gb']:.2f} GB")
    metrics = [v for m in rec["levels"] for k, v in m.items() if k != "level"]
    metrics += [init_s, run_s, out_s]
    if not all(math.isfinite(float(v)) for v in metrics):
        raise RuntimeError("non-finite metric on the main path")
    if len(rec["levels"]) != cfg.levels:
        raise RuntimeError(f"ran {len(rec['levels'])} levels, expected {cfg.levels}")
    if counts["spmv_ell"] == 0 or counts["spmv_ell_multi"] == 0:
        raise RuntimeError(f"a kernel was not launched on the main path: {counts}")
    if counts["plain_on_cuda"] != 0:
        raise RuntimeError(f"a plain version ran on CUDA tensors: {counts}")
    if blend.shape != (size, size, 3) or blend.dtype != np.uint8:
        raise RuntimeError(f"halfway texture has shape {blend.shape} {blend.dtype}")
    return rec, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")
    card = card_line()
    phase(1, f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sys.path.insert(0, REPO)
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
    from meshopticalflow_tpu_torch.kernels import spmv

    os.makedirs(WORK, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    lib = spmv.build_library()
    spmv._library()
    phase(2, f"built {os.path.relpath(lib, REPO)} in {time.time() - t0:.2f} s")

    paths, size = upsampled_inputs()
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    cfg = config_from_args(build_parser().parse_args(
        ["--mesh", "m", "--in", *paths, "--out", "o"]))
    t0 = time.time()
    prob = FlowProblem.from_texture_inputs(os.path.join(GOLD, "cube.ply"), tuple(paths),
                                           cfg, device="cuda")
    phase(3, f"main-path problem built in {time.time() - t0:.1f} s")
    report = check_kernels(prob, spmv)
    del prob
    torch.cuda.empty_cache()

    check_goldens(spmv)

    torch.cuda.reset_peak_memory_stats()
    rec, counts = main_path(spmv, paths, size)

    replaces = {"spmv_ell": "meshopticalflow_tpu/kernels/pallas_spmv.py:76",
                "spmv_ell_multi": "meshopticalflow_tpu/kernels/pallas_spmv.py:395"}
    kernels = [dict(name=name, route="cuda",
                    source="meshopticalflow_tpu_torch/csrc/spmv_ell.cu",
                    replaces=replaces[name], launches=counts[name],
                    max_abs_err=report[name]["float32"]["max_abs_err"],
                    ms=report[name]["float32"]["ms"],
                    plain_ms=report[name]["float32"]["plain_ms"])
               for name in ("spmv_ell", "spmv_ell_multi")]
    with open(os.path.join(WORK, "kernels.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

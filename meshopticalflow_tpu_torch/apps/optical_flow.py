"""OpticalFlow CLI of the PyTorch port (reference: OpticalFlow/OpticalFlow.cpp:56-109).

Usage:
    python -m meshopticalflow_tpu_torch.apps.optical_flow \
        --mesh mesh.ply --in A.png B.png --out result.png [--device cuda] [options]
    python -m meshopticalflow_tpu_torch.apps.optical_flow \
        --in A.ply B.ply --out result.ply [options]
    python -m meshopticalflow_tpu_torch.apps.optical_flow --serve [options]

The flags are the reference CLI's: the basis (--vfMode 0 Whitney, 1
Conformal, 2 Connection; --cMode; --divFree), the flow solver
(--flowBackend auto/pallas: the Hopper-kernel multigrid cycle, xla: the
three-level cycle, mf: the multifrontal direct solve, halo: the
halo-exchange cycle split over the processes of a multi-process run; the
Conformal and Connection bases take the two-level cycle), the host
direct-solve oracle (--hostSolve), per-level dumps (--debug, into the
working directory) and --serve, a worker that reads one JSON job per stdin
line and prints one JSON result line per job; jobs over one mesh share its
init state through the artifact and device caches ($MESHFLOW_CACHE,
utils/devcache.py). Without --out the viewer runs (viz/surface.py::view_flow:
level frames into the working directory, or the live terminal viewer on a
tty or with MESHFLOW_LIVE=1), as the reference's does. ``--device cuda``
(the default) raises when no GPU is available; it never falls back to the
CPU.

Multi-process runs (one process per GPU) take the environment contract of
parallel/distributed.py (MESHFLOW_COORDINATOR, MESHFLOW_NUM_PROCESSES,
MESHFLOW_PROCESS_ID, or torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK, LOCAL_RANK): every rank runs the same problem, the halo flow solve and
the final texel marches split over the ranks; rank 0 writes the output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from meshopticalflow_tpu_torch.config import ConnectionMode, FlowConfig, VectorFieldMode


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="OpticalFlow",
        description="Halfway optical-flow alignment of signals on a mesh surface "
                    "(PyTorch/CUDA)")
    p.add_argument("--in", dest="inputs", nargs=2, metavar=("A", "B"),
                   help="input textures (.ply pair or .png pair)")
    p.add_argument("--mesh", help="input geometry (.ply); switches to texture mode")
    p.add_argument("--out", help="output file (.ply or .png)")
    p.add_argument("--serve", action="store_true",
                   help="persistent worker: read JSON job lines from stdin "
                        "({\"in\": [A, B], \"out\": ..., optional flags}), print one "
                        "JSON result line per job; {\"cmd\": \"quit\"} or EOF ends it")
    add_alignment_flags(p)
    return p


def add_alignment_flags(p: argparse.ArgumentParser) -> None:
    """The device and the alignment/solver flags shared by the pairwise CLI
    and the sequence-tracking CLI (OpticalFlow.cpp:56-109 defaults)."""
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--vfMode", type=int, default=0,
                   help="vector field mode: 0 Whitney, 1 Conformal, 2 Connection")
    p.add_argument("--cMode", type=int, default=0,
                   help="connection mode: 0 projected barycentric, 1 barycentric dual, "
                        "2 inverse cotangent")
    p.add_argument("--iterations", type=int, default=10, help="alignment iterations")
    p.add_argument("--threads", type=int, default=0,
                   help="accepted for reference compatibility; parallelism is device-wide")
    p.add_argument("--pad", type=int, default=2, help="texture padding radius")
    p.add_argument("--sSmooth", type=float, default=3e-3, help="scalar smoothing weight")
    p.add_argument("--vfSmooth", type=float, default=None,
                   help="vector field smoothing weight (default per mode: 3e-6 / 5e-7 / 1e4)")
    p.add_argument("--vfSThreshold", type=float, default=1e-8,
                   help="vector field weight threshold")
    p.add_argument("--eLength", type=float, default=0.006,
                   help="subdivide edges up to this bbox-diagonal fraction")
    p.add_argument("--dogWeight", type=float, default=1.0,
                   help="difference-of-Gaussians blending weight")
    p.add_argument("--dogSmooth", type=float, default=1e-4,
                   help="difference-of-Gaussians smoothing weight")
    p.add_argument("--sMultiply", type=float, default=0.25,
                   help="scalar weight multiplication factor")
    p.add_argument("--vMultiply", type=float, default=1.0,
                   help="vector field weight multiplication factor")
    p.add_argument("--search", type=float, default=1.0,
                   help="golden-section search range (vestigial in the reference; accepted, unused)")
    p.add_argument("--divFree", action="store_true",
                   help="divergence-free (rotated-gradient) basis")
    p.add_argument("--log", action="store_true", help="log-space signal comparison")
    p.add_argument("--nearest", action="store_true", help="nearest-neighbor texture sampling")
    p.add_argument("--error", action="store_true", help="report alignment error")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="dump per-level resampled signals into the working directory")
    p.add_argument("--dtype", default="float32", choices=("float32", "float64"),
                   help="device dtype")
    p.add_argument("--hostSolve", action="store_true",
                   help="solve each level's flow system on the host (scipy direct solve)")
    p.add_argument("--flowBackend", default="auto",
                   choices=("auto", "pallas", "xla", "mf", "halo"),
                   help="flow solver: auto/pallas = the Hopper-kernel multigrid cycle "
                        "with the exact banded coarse solve, xla = the three-level cycle, "
                        "mf = the multifrontal direct solve, halo = the halo-exchange "
                        "cycle over the processes of a multi-process run")


def config_from_args(args) -> FlowConfig:
    # DoG weight clamped to [0, 1] (OpticalFlow.cpp:1113).
    dog = min(1.0, max(0.0, args.dogWeight))
    return FlowConfig(
        vf_mode=VectorFieldMode(args.vfMode),
        connection_mode=ConnectionMode(args.cMode),
        levels=args.iterations,
        pad_radius=args.pad,
        scalar_smooth_weight=args.sSmooth,
        vf_smooth_weight=args.vfSmooth,
        vf_smooth_weight_threshold=args.vfSThreshold,
        subdivide_edge_length=args.eLength,
        dog_weight=dog,
        dog_smooth=args.dogSmooth,
        scalar_weight_multiplier=args.sMultiply,
        vf_weight_multiplier=args.vMultiply,
        divergence_free=args.divFree,
        log_space=args.log,
        nearest=args.nearest,
        dtype=args.dtype,
        use_host_cholesky=args.hostSolve,
        flow_backend=args.flowBackend,
    )


def _run_one(args, config: FlowConfig, device_group=None):
    """Load the inputs, run every level and write the output; shared by the
    one-shot path and the --serve loop. Without ``args.out`` the viewer
    steps the levels instead (reference: OpticalFlow.cpp:1072-1092) and
    nothing is returned."""
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

    if not args.out and device_group is not None and device_group.world_size > 1:
        raise ValueError("the viewer runs in one process: pass --out in a "
                         "multi-process run")
    if args.mesh:
        problem = FlowProblem.from_texture_inputs(args.mesh, tuple(args.inputs),
                                                  config, device=args.device,
                                                  device_group=device_group)
    else:
        problem = FlowProblem.from_vertex_inputs(args.inputs[0], args.inputs[1],
                                                 config, device=args.device,
                                                 device_group=device_group)
    if args.verbose:
        print(f"Vertices / Triangles: {problem.mesh.n_vertices} / "
              f"{problem.mesh.n_triangles}")
    if not args.out:
        from meshopticalflow_tpu_torch.viz import view_flow

        view_flow(problem, out_dir=".")
        return None
    result = problem.run(verbose=args.verbose, debug_dir="." if args.debug else None)
    problem.write_output(args.out)
    return result


def _job_argv(job: dict) -> list:
    """A JSON job's keys as command-line flags ("in" or "inputs" -> --in)."""
    argv = []
    for key, val in job.items():
        if key == "cmd":
            continue
        flag = "--" + ("in" if key == "inputs" else key)
        if isinstance(val, bool):
            if val:
                argv.append(flag)
        elif isinstance(val, (list, tuple)):
            argv.extend([flag, *map(str, val)])
        else:
            argv.extend([flag, str(val)])
    return argv


def serve(base_args, stdin=None, stdout=None, device_group=None) -> int:
    """The worker loop (the reference's apps/optical_flow.py:134-193): one
    JSON job per line, {"in": [A, B], "out": PATH, "mesh": PATH?, ...flag
    overrides}, over the flags this process started with; one JSON result
    line per job. A failed job prints {"error": ...} and the loop goes on.
    EOF or {"cmd": "quit"} ends it. The process keeps the built kernels and
    the device context across jobs."""
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    parser = build_parser()

    def emit(rec):
        print(json.dumps(rec), file=stdout, flush=True)

    emit({"ready": True})
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
        except json.JSONDecodeError as exc:
            emit({"error": f"bad job line: {exc}"})
            continue
        if job.get("cmd") == "quit":
            break
        try:
            argv = _job_argv(job)
            ns = argparse.Namespace(**vars(base_args))
            ns.serve = False
            try:
                args = parser.parse_args(argv, namespace=ns)
            except SystemExit:   # argparse errors exit; keep serving
                raise ValueError(f"bad job flags: {argv}")
            if not args.inputs or not args.out:
                raise ValueError("job needs \"in\" and \"out\"")
            t0 = time.time()
            result = _run_one(args, config_from_args(args), device_group)
            rec = {"out": args.out, "seconds": round(time.time() - t0, 2)}
            if result.metrics:
                rec["alignment_error"] = float(result.metrics[-1]["alignment_error"])
            emit(rec)
        except Exception as exc:   # report per job, keep serving
            emit({"error": f"{type(exc).__name__}: {exc}"})
    return 0


def main(argv=None) -> int:
    from meshopticalflow_tpu_torch.parallel.distributed import (global_device_group,
                                                                maybe_init_distributed)

    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.serve and not args.inputs:
        parser.error("--in is required (unless --serve)")
    # Multi-process runs: a no-op unless a coordinator is configured; then
    # the problem runs as one rank of the group of every process.
    group = global_device_group(args.device) if maybe_init_distributed(args.device) \
        else None
    if args.serve:
        return serve(args, device_group=group)
    result = _run_one(args, config_from_args(args), group)
    if args.error and result is not None and (group is None or group.rank == 0):
        print(json.dumps({"alignment_error": result.metrics[-1]["alignment_error"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

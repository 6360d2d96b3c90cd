"""OpticalFlow CLI of the PyTorch port (reference: OpticalFlow/OpticalFlow.cpp:56-109).

Usage:
    python -m meshopticalflow_tpu_torch.apps.optical_flow \
        --mesh mesh.ply --in A.png B.png --out result.png [--device cuda] [options]
    python -m meshopticalflow_tpu_torch.apps.optical_flow \
        --in A.ply B.ply --out result.ply [options]

The port runs the Whitney basis with Jacobi-PCG solves (no multigrid), so
the reference CLI's --vfMode, --cMode, --divFree, --hostSolve, --flowBackend,
--debug and --serve flags are not taken. ``--device cuda`` (the default)
raises when no GPU is available; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from meshopticalflow_tpu_torch.config import FlowConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="OpticalFlow",
        description="Halfway optical-flow alignment of signals on a mesh surface "
                    "(PyTorch/CUDA)")
    p.add_argument("--in", dest="inputs", nargs=2, metavar=("A", "B"), required=True,
                   help="input textures (.ply pair or .png pair)")
    p.add_argument("--mesh", help="input geometry (.ply); switches to texture mode")
    p.add_argument("--out", required=True, help="output file (.ply or .png)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--iterations", type=int, default=10, help="alignment iterations")
    p.add_argument("--threads", type=int, default=0,
                   help="accepted for reference compatibility; parallelism is device-wide")
    p.add_argument("--pad", type=int, default=2, help="texture padding radius")
    p.add_argument("--sSmooth", type=float, default=3e-3, help="scalar smoothing weight")
    p.add_argument("--vfSmooth", type=float, default=None,
                   help="vector field smoothing weight (default 3e-6)")
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
    p.add_argument("--log", action="store_true", help="log-space signal comparison")
    p.add_argument("--nearest", action="store_true", help="nearest-neighbor texture sampling")
    p.add_argument("--error", action="store_true", help="report alignment error")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--dtype", default="float32", choices=("float32", "float64"),
                   help="device dtype")
    return p


def config_from_args(args) -> FlowConfig:
    # DoG weight clamped to [0, 1] (OpticalFlow.cpp:1113).
    dog = min(1.0, max(0.0, args.dogWeight))
    return FlowConfig(
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
        log_space=args.log,
        nearest=args.nearest,
        dtype=args.dtype,
        use_multigrid=False,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

    if args.mesh:
        problem = FlowProblem.from_texture_inputs(args.mesh, tuple(args.inputs),
                                                  config, device=args.device)
    else:
        problem = FlowProblem.from_vertex_inputs(args.inputs[0], args.inputs[1],
                                                 config, device=args.device)
    if args.verbose:
        print(f"Vertices / Triangles: {problem.mesh.n_vertices} / "
              f"{problem.mesh.n_triangles}")
    result = problem.run(verbose=args.verbose)
    problem.write_output(args.out)
    if args.error:
        print(json.dumps({"alignment_error": result.metrics[-1]["alignment_error"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sequence-tracking CLI of the PyTorch port: halfway-align every consecutive
frame pair of a signal sequence over one shared mesh.

Port of meshopticalflow_tpu/apps/track_sequence.py. Consecutive frames of a
signal on a fixed mesh are aligned pair by pair, and the per-pair flows can
be composed across the sequence (the ResampleSignalWhitneyComposedFlow
machinery, OpticalFlow.cpp:239-260). Each pair is one ``FlowProblem``.

Usage:
    python -m meshopticalflow_tpu_torch.apps.track_sequence \
        --in f0.png f1.png f2.png ... --mesh mesh.ply --outDir out/ [--device cuda]
    python -m meshopticalflow_tpu_torch.apps.track_sequence \
        --in f0.ply f1.ply f2.ply ... --outDir out/ [--composed]

Outputs in --outDir, for each pair i = (frame i, frame i+1):
    halfway_%03d.png|.ply  the blended halfway signal (what --out writes)
    vectorField_%03d.bin   per-triangle flow 2-vectors in the reference's
                           WriteVector layout (Src/VectorIO.h:8-31)
    metrics.jsonl          one JSON line per pair (seconds, init stages,
                           flow iterations per level, alignment error);
                           with --composed, a last line with the composed
                           resample's seconds
    composed_resampled.ply (--composed, per-vertex Whitney runs) frame 0's
                           colours advected through the whole composed flow
                           chain, last to first (OpticalFlow.cpp:251)
The alignment flags and --device are OpticalFlow's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from meshopticalflow_tpu_torch.apps.optical_flow import add_alignment_flags

    p = argparse.ArgumentParser(
        prog="TrackSequence",
        description="Pairwise halfway alignment of a frame sequence on a mesh "
                    "(PyTorch/CUDA)")
    p.add_argument("--in", dest="inputs", nargs="+", metavar="FRAME", required=True,
                   help="frame sequence: .png textures (with --mesh) or colored .ply meshes")
    p.add_argument("--mesh", help="shared geometry (.ply); switches to texture mode")
    p.add_argument("--outDir", required=True, help="output directory")
    p.add_argument("--composed", action="store_true",
                   help="also resample frame 0 through the composed flow chain "
                        "(per-vertex Whitney runs)")
    add_alignment_flags(p)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if len(args.inputs) < 2:
        parser.error("need at least two frames")

    import torch

    from meshopticalflow_tpu_torch.apps.optical_flow import config_from_args
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem, _sync
    from meshopticalflow_tpu_torch.io.binio import write_vector

    config = config_from_args(args)
    texture_mode = bool(args.mesh)
    composed = args.composed and not texture_mode and args.vfMode == 0
    os.makedirs(args.outDir, exist_ok=True)

    coeff_chain = []
    first = last = None
    with open(os.path.join(args.outDir, "metrics.jsonl"), "w") as mf:
        for i in range(len(args.inputs) - 1):
            pair = (args.inputs[i], args.inputs[i + 1])
            t0 = time.time()
            if texture_mode:
                problem = FlowProblem.from_texture_inputs(args.mesh, pair, config,
                                                          device=args.device)
                ext = ".png"
            else:
                problem = FlowProblem.from_vertex_inputs(pair[0], pair[1], config,
                                                         device=args.device)
                ext = ".ply"
            _sync(problem.device)
            init_s = time.time() - t0
            if args.verbose:
                print(f"[pair {i}] {pair[0]} -> {pair[1]}: {problem.mesh.n_vertices} verts"
                      f" / {problem.mesh.n_triangles} tris (init {init_s:.1f} s)")
            t0 = time.time()
            result = problem.run(verbose=args.verbose)
            run_s = time.time() - t0
            problem.write_output(os.path.join(args.outDir, f"halfway_{i:03d}{ext}"))
            write_vector(os.path.join(args.outDir, f"vectorField_{i:03d}.bin"),
                         np.asarray(result.tfield, np.float64))
            mf.write(json.dumps({
                "pair": i, "frames": list(pair),
                "init_seconds": init_s, "init_profile": problem.init_profile,
                "level_seconds": run_s,
                "flow_iters": [m["flow_iters"] for m in result.metrics],
                "alignment_error": float(result.metrics[-1]["alignment_error"]),
            }) + "\n")
            mf.flush()
            if composed:
                coeff_chain.append(result.coeffs.astype(np.float64))
                first = problem if first is None else first
                last = problem
            del problem

    if composed:
        from meshopticalflow_tpu_torch.io.ply import write_ply_colored
        from meshopticalflow_tpu_torch.kernels.advect import resample_signal_composed_whitney
        from meshopticalflow_tpu_torch.models.whitney import edge_reduction

        # Signed half-edge expansion of each pair's Whitney coefficients
        # (Whitney.inl:28-62), stacked into the (F, 3T) chain the composed
        # resampler applies last to first.
        red, sign, _ = edge_reduction(first.mesh.opp)
        fields = torch.as_tensor(np.stack([c[red] * sign for c in coeff_chain])).to(
            dtype=first.dtype, device=first.device)
        _sync(first.device)
        t0 = time.time()
        out = resample_signal_composed_whitney(
            last.arrays.tm, fields, first.vertex_colors[0], 0.5,
            min_step=config.flow_min_step, max_steps=config.flow_max_steps)
        colors = out.double().cpu().numpy()
        composed_s = time.time() - t0
        write_ply_colored(os.path.join(args.outDir, "composed_resampled.ply"),
                          np.asarray(first.vertices), np.clip(colors, 0, 255),
                          first.mesh.triangles)
        with open(os.path.join(args.outDir, "metrics.jsonl"), "a") as mf:
            mf.write(json.dumps({"composed_frames": len(args.inputs),
                                 "composed_seconds": composed_s}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

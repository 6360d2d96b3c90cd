"""Spectrum CLI of the PyTorch port (reference: Spectrum/Spectrum.cpp).

Usage:
    python -m meshopticalflow_tpu_torch.apps.spectrum --mesh m.ply \
        [--eigenVectors 20] [--outPrefix DIR] [--device cuda] [options]

Computes the lowest-k eigenpairs of the vector-field Laplacian (the basis
smoothness operator against the vector-field mass) and writes
``eigenvector-%03d.bin``, byte-compatible with the reference
(Spectrum.cpp:191-195). On CUDA the eigensolver runs block Lanczos on the
banded shift-invert solve; on the CPU, the Jacobi-PCG recurrence.
``--device cuda`` (the default) raises when no GPU is available. ``--view
DIR`` also renders the eigenvector fields through the viewer
(viz/surface.py::view_spectrum): a pager on a display, the live terminal
viewer on a tty or with MESHFLOW_LIVE=1, PNG frames into DIR otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from meshopticalflow_tpu_torch.config import ConnectionMode, FlowConfig, VectorFieldMode


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="Spectrum",
                                description="Vector-field Laplacian spectrum (PyTorch/CUDA)")
    p.add_argument("--mesh", required=True, help="input geometry (.ply)")
    p.add_argument("--vfMode", type=int, default=0)
    p.add_argument("--cMode", type=int, default=0)
    p.add_argument("--eigenVectors", type=int, default=20)
    p.add_argument("--eLength", type=float, default=0.0)
    p.add_argument("--edgeMetric", action="store_true",
                   help="metric from per-face squared edge lengths (PlyMetricFace)")
    p.add_argument("--outPrefix", default="", help="output directory/prefix for the dumps")
    p.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--femDual", type=int, default=-1,
                   help="use the FEM vector-field stiffness family as the smoothness "
                        "operator (vfMode 2 only): dual type 0-5 (FEM.h:52-58); -1 keeps "
                        "the basis operator")
    p.add_argument("--femQuadrature", type=int, default=0,
                   help="quadrature flags for --femDual (1 angular, 2 square-length)")
    p.add_argument("--femLinearFit", action="store_true",
                   help="use the linear-fit Monte-Carlo stiffness (FEM.inl:1840)")
    p.add_argument("--view", default="",
                   help="render the eigenvector fields into this directory (interactive "
                        "viewer with orbit/pan/zoom on a tty; PNG frames otherwise)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p


def main(argv=None, stats: dict | None = None) -> int:
    """Run the CLI; ``stats`` (when given) receives compute_spectrum's stage
    record."""
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch

    from meshopticalflow_tpu_torch.flow.pipeline import resolve_device, torch_dtype
    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_mesh
    from meshopticalflow_tpu_torch.io.binio import write_vector
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
    from meshopticalflow_tpu_torch.models.base import build_basis, finalize_basis
    from meshopticalflow_tpu_torch.ops.assemble import vector_field_mass_blocks
    from meshopticalflow_tpu_torch.solvers.lanczos import compute_spectrum

    device = resolve_device(args.device)
    dtype = torch_dtype(args.dtype)
    data = read_triangle_mesh(args.mesh)
    tris, verts = data.faces, data.vertices
    if args.edgeMetric:
        if data.face_metric is None:
            print("[ERROR] --edgeMetric requires square_length face properties",
                  file=sys.stderr)
            return 1
        mesh = build_mesh(tris, square_edge_lengths=data.face_metric)
    else:
        if args.eLength > 0:
            diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
            tris, verts = subdivide_mesh(tris, verts, args.eLength * diag)
        mesh = build_mesh(tris, vertices=verts)

    config = FlowConfig(vf_mode=VectorFieldMode(args.vfMode),
                        connection_mode=ConnectionMode(args.cMode), dtype=args.dtype)
    host, basis = build_basis(mesh, config, device)
    if args.femDual >= 0:
        # The FEM vector-field stiffness family over per-triangle DoFs as
        # the smoothness operator.
        if VectorFieldMode(args.vfMode) != VectorFieldMode.CONNECTION:
            print("[ERROR] --femDual requires --vfMode 2 (per-triangle DoFs)",
                  file=sys.stderr)
            return 1
        from meshopticalflow_tpu_torch.ops import fem_ops
        if args.femLinearFit:
            smooth = fem_ops.vector_field_stiffness_matrix_mc(
                mesh, args.femDual, args.femQuadrature, linear_fit_=True)
        else:
            smooth = fem_ops.vector_field_stiffness_matrix(mesh, args.femDual,
                                                           args.femQuadrature)
        host = dataclasses.replace(host, smooth=smooth.tocsr())
        basis = finalize_basis(host, dtype, device)
    mass = torch.as_tensor(vector_field_mass_blocks(mesh)).to(dtype=dtype, device=device)
    result = compute_spectrum(basis, mass, args.eigenVectors,
                              host_stepped=device.type == "cuda", stats=stats)
    if args.outPrefix:
        os.makedirs(args.outPrefix, exist_ok=True)
    for i, field in enumerate(result.triangle_fields):
        write_vector(os.path.join(args.outPrefix, f"eigenvector-{i + 1:03d}.bin"),
                     field.reshape(-1, 2))
    if args.verbose:
        print(json.dumps({"eigenvalues": [float(x) for x in result.eigenvalues]}))
    if args.view:
        from meshopticalflow_tpu_torch.viz import view_spectrum

        view_spectrum(verts, tris, np.asarray(result.triangle_fields),
                      np.asarray(result.eigenvalues), out_dir=args.view)
    return 0


if __name__ == "__main__":
    sys.exit(main())

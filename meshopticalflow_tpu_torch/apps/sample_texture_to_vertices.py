"""SampleTextureToVertices CLI of the PyTorch port (reference:
SampleTextureToVertices/SampleTextureToVertices.cpp:47-120): bake a uv
texture into per-vertex colours on an (optionally subdivided) mesh and write
an ASCII coloured PLY. Host work only (numpy), so it takes no --device.

Usage:
    python -m meshopticalflow_tpu_torch.apps.sample_texture_to_vertices \
        --in mesh.ply --texture A.png --out baked.ply [--eLength 0.006] [--nearest]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="SampleTextureToVertices")
    p.add_argument("--in", dest="mesh", required=True, help="textured mesh (.ply)")
    p.add_argument("--texture", required=True, help="texture image (.png)")
    p.add_argument("--out", required=True, help="output colored mesh (.ply)")
    p.add_argument("--eLength", type=float, default=0.006,
                   help="subdivide edges up to this bbox-diagonal fraction")
    p.add_argument("--nearest", action="store_true")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from meshopticalflow_tpu_torch.flow.pipeline import sample_texture_to_vertices
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_textured_mesh
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh, write_ply_colored
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    data = read_triangle_mesh(args.mesh)
    if data.face_uvs is None:
        print("[ERROR] input mesh has no texture coordinates", file=sys.stderr)
        return 1
    tris, verts, uvs = data.faces, data.vertices, data.face_uvs
    if args.eLength > 0:
        diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
        tris, verts, uvs = subdivide_textured_mesh(tris, verts, uvs, args.eLength * diag)
        if args.verbose:
            print(f"Subdivided to {len(verts)} vertices / {len(tris)} triangles")
    texture = read_png_rgb(args.texture)
    colors = sample_texture_to_vertices(tris, uvs, texture, int(tris.max()) + 1,
                                        not args.nearest)
    write_ply_colored(args.out, verts, colors, tris, fmt="ascii")
    return 0


if __name__ == "__main__":
    sys.exit(main())

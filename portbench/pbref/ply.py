"""Reader of the textured triangle PLYs the benchmark ships: vertex x, y, z
and a face list of vertex indices with a list of wedge texture coordinates,
ASCII or binary little-endian."""

from __future__ import annotations

import numpy as np

_TYPES = {"char": "i1", "uchar": "u1", "short": "<i2", "ushort": "<u2", "int": "<i4",
          "uint": "<u4", "float": "<f4", "double": "<f8", "int8": "i1", "uint8": "u1",
          "int32": "<i4", "uint32": "<u4", "float32": "<f4", "float64": "<f8"}


def read_textured_ply(path: str):
    """(faces (T, 3) int64, vertices (V, 3) float64, face_uvs (T, 3, 2)
    float64) of a triangle PLY whose faces carry 6 texture coordinates."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header") + len(b"end_header")
    end = data.index(b"\n", end) + 1
    header = data[:end].decode("ascii").split("\n")
    fmt, n_vert, n_face, vprops, uv_type = None, 0, 0, [], "<f4"
    current = None
    for line in header:
        words = line.split()
        if not words:
            continue
        if words[0] == "format":
            fmt = words[1]
        elif words[0] == "element":
            current = words[1]
            if current == "vertex":
                n_vert = int(words[2])
            elif current == "face":
                n_face = int(words[2])
        elif words[0] == "property" and current == "vertex":
            vprops.append((words[-1], _TYPES[words[1]]))
        elif words[0] == "property" and current == "face" and words[-1] == "texcoord":
            uv_type = _TYPES[words[3]]
    body = data[end:]
    if fmt == "ascii":
        tokens = body.split()
        nv = len(vprops)
        vals = np.array(tokens[:n_vert * nv], np.float64).reshape(n_vert, nv)
        names = [p[0] for p in vprops]
        # values as their declared type holds them, as a binary file would
        verts = np.stack([vals[:, names.index(c)].astype(vprops[names.index(c)][1])
                          for c in "xyz"], axis=1).astype(np.float64)
        rows = np.array(tokens[n_vert * nv:n_vert * nv + n_face * 11],
                        np.float64).reshape(n_face, 11)
        faces = rows[:, 1:4].astype(np.int64)
        uvs = rows[:, 5:11].astype(uv_type).astype(np.float64).reshape(n_face, 3, 2)
        return faces, verts, uvs
    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: PLY format {fmt} not read")
    vdt = np.dtype([(name, t) for name, t in vprops])
    verts_rec = np.frombuffer(body, vdt, count=n_vert)
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,)), ("un", "u1"), ("uv", "<f4", (6,))])
    face_rec = np.frombuffer(body, fdt, count=n_face, offset=vdt.itemsize * n_vert)
    if not (np.all(face_rec["n"] == 3) and np.all(face_rec["un"] == 6)):
        raise ValueError(f"{path}: faces are not textured triangles")
    verts = np.stack([verts_rec[c].astype(np.float64) for c in "xyz"], axis=1)
    return (face_rec["idx"].astype(np.int64), verts,
            face_rec["uv"].astype(np.float64).reshape(n_face, 3, 2))

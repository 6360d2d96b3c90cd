"""PLY triangle-mesh I/O.

Covers the record types the reference consumes/produces
(Misha/Ply.h:742-828): plain vertices, colored vertices, textured faces
(wedge-uv list property ``texcoord``), metric faces (squared-edge-length
list), and per-face vector fields. Formats: ascii, binary little/big endian.

This is an independent numpy implementation, not a port of the vendored
Turk plyfile (Misha/PlyFile.inl).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class _Property:
    name: str
    dtype: str  # numpy dtype char code, sans byte order
    is_list: bool = False
    count_dtype: str = ""


@dataclasses.dataclass
class _Element:
    name: str
    count: int
    properties: List[_Property]


def _parse_header(f) -> Tuple[List[_Element], str]:
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    elements: List[_Element] = []
    fmt = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == b"comment" or key == b"obj_info":
            continue
        if key == b"format":
            fmt = tokens[1].decode()
        elif key == b"element":
            elements.append(_Element(tokens[1].decode(), int(tokens[2]), []))
        elif key == b"property":
            if tokens[1] == b"list":
                prop = _Property(tokens[4].decode(), _PLY_TYPES[tokens[3].decode()],
                                 True, _PLY_TYPES[tokens[2].decode()])
            else:
                prop = _Property(tokens[2].decode(), _PLY_TYPES[tokens[1].decode()])
            elements[-1].properties.append(prop)
        elif key == b"end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return elements, fmt


def _read_ascii_element(tokens: List[bytes], cursor: int, elem: _Element) -> Tuple[dict, int]:
    out: Dict[str, list] = {p.name: [] for p in elem.properties}
    has_list = any(p.is_list for p in elem.properties)
    if not has_list:
        width = len(elem.properties)
        n = elem.count * width
        block = np.array(tokens[cursor:cursor + n], dtype=np.float64).reshape(elem.count, width)
        cursor += n
        data = {}
        for j, p in enumerate(elem.properties):
            data[p.name] = block[:, j].astype(np.dtype(p.dtype))
        return data, cursor
    for _ in range(elem.count):
        for p in elem.properties:
            if p.is_list:
                n = int(tokens[cursor]); cursor += 1
                vals = np.array(tokens[cursor:cursor + n], dtype=np.float64).astype(np.dtype(p.dtype))
                cursor += n
                out[p.name].append(vals)
            else:
                out[p.name].append(np.dtype(p.dtype).type(float(tokens[cursor])))
                cursor += 1
    data = {}
    for p in elem.properties:
        if p.is_list:
            lens = {len(v) for v in out[p.name]}
            if len(lens) == 1:  # uniform lists stack into a 2-D array
                data[p.name] = np.stack(out[p.name]) if out[p.name] else np.zeros((0, 0))
            else:
                data[p.name] = out[p.name]
        else:
            data[p.name] = np.array(out[p.name])
    return data, cursor


def _read_binary_element(buf: memoryview, offset: int, elem: _Element, bo: str) -> Tuple[dict, int]:
    has_list = any(p.is_list for p in elem.properties)
    if not has_list:
        dt = np.dtype([(p.name, bo + p.dtype) for p in elem.properties])
        arr = np.frombuffer(buf, dtype=dt, count=elem.count, offset=offset)
        offset += dt.itemsize * elem.count
        return {p.name: np.ascontiguousarray(arr[p.name]) for p in elem.properties}, offset

    # Fast path: assume uniform list lengths (true for triangle meshes); verify
    # against the first record and fall back to a slow walk otherwise.
    probe = offset
    fields = []
    ok = True
    for p in elem.properties:
        if p.is_list:
            cdt = np.dtype(bo + p.count_dtype)
            n = int(np.frombuffer(buf, dtype=cdt, count=1, offset=probe)[0])
            probe += cdt.itemsize
            fields.append((p, n))
            probe += np.dtype(p.dtype).itemsize * n
        else:
            fields.append((p, None))
            probe += np.dtype(p.dtype).itemsize
    struct_fields = []
    for p, n in fields:
        if p.is_list:
            struct_fields.append((p.name + "__n", bo + p.count_dtype))
            struct_fields.append((p.name, bo + p.dtype, (n,)))
        else:
            struct_fields.append((p.name, bo + p.dtype))
    dt = np.dtype(struct_fields)
    if offset + dt.itemsize * elem.count <= len(buf):
        arr = np.frombuffer(buf, dtype=dt, count=elem.count, offset=offset)
        for p, n in fields:
            if p.is_list and not np.all(arr[p.name + "__n"] == n):
                ok = False
        if ok:
            data = {}
            for p, n in fields:
                data[p.name] = np.ascontiguousarray(arr[p.name])
            return data, offset + dt.itemsize * elem.count
    # Slow walk for ragged lists.
    out: Dict[str, list] = {p.name: [] for p in elem.properties}
    for _ in range(elem.count):
        for p in elem.properties:
            if p.is_list:
                cdt = np.dtype(bo + p.count_dtype)
                n = int(np.frombuffer(buf, dtype=cdt, count=1, offset=offset)[0])
                offset += cdt.itemsize
                idt = np.dtype(bo + p.dtype)
                out[p.name].append(np.frombuffer(buf, dtype=idt, count=n, offset=offset).copy())
                offset += idt.itemsize * n
            else:
                idt = np.dtype(bo + p.dtype)
                out[p.name].append(np.frombuffer(buf, dtype=idt, count=1, offset=offset)[0])
                offset += idt.itemsize
    data = {}
    for p in elem.properties:
        data[p.name] = out[p.name] if p.is_list else np.array(out[p.name])
    return data, offset


def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a PLY file into {element: {property: array}}."""
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        body = f.read()
    result: Dict[str, Dict[str, np.ndarray]] = {}
    if fmt == "ascii":
        tokens = body.split()
        cursor = 0
        for elem in elements:
            result[elem.name], cursor = _read_ascii_element(tokens, cursor, elem)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        buf = memoryview(body)
        offset = 0
        for elem in elements:
            result[elem.name], offset = _read_binary_element(buf, offset, elem, bo)
    return result


@dataclasses.dataclass
class TriangleMeshData:
    """Decoded triangle-mesh payload of a PLY file."""

    vertices: np.ndarray              # (V, 3) float64
    faces: np.ndarray                 # (F, 3) int32
    colors: Optional[np.ndarray] = None       # (V, 3) float64, 0..255
    face_uvs: Optional[np.ndarray] = None     # (F, 3, 2) float64 wedge uvs
    face_metric: Optional[np.ndarray] = None  # (F, 3) float64 squared edge lengths


def read_triangle_mesh(path: str) -> TriangleMeshData:
    """Read a PLY mesh covering every reference record type.

    Handles plain vertices, colored vertices (PlyColorVertex), textured faces
    (PlyTexturedFace's 6-float ``texcoord`` list), and metric faces
    (Src/MetricFace.h squared edge-length list).
    """
    data = read_ply(path)
    if "vertex" not in data or "face" not in data:
        raise ValueError(f"{path}: missing vertex/face elements")
    v = data["vertex"]
    vertices = np.stack([np.asarray(v[c], np.float64) for c in ("x", "y", "z")], axis=1)
    colors = None
    if "red" in v:
        colors = np.stack([np.asarray(v[c], np.float64) for c in ("red", "green", "blue")], axis=1)
    fdata = data["face"]
    idx_key = next((k for k in ("vertex_indices", "vertex_index") if k in fdata), None)
    if idx_key is None:
        raise ValueError(f"{path}: no face index property")
    faces_raw = fdata[idx_key]
    if isinstance(faces_raw, list):
        raise ValueError(f"{path}: non-triangular faces are not supported")
    if faces_raw.shape[1] != 3:
        raise ValueError(f"{path}: faces must be triangles, got {faces_raw.shape[1]} vertices")
    faces = np.asarray(faces_raw, np.int32)
    face_uvs = None
    if "texcoord" in fdata and not isinstance(fdata["texcoord"], list):
        uv = np.asarray(fdata["texcoord"], np.float64)
        if uv.shape[1] != 6:
            raise ValueError(f"{path}: bad texcoord arity {uv.shape[1]} (expected 6)")
        face_uvs = uv.reshape(-1, 3, 2)
    face_metric = None
    for key in ("square_lengths", "square_length", "metric"):
        if key in fdata and not isinstance(fdata[key], list):
            face_metric = np.asarray(fdata[key], np.float64)
            break
    return TriangleMeshData(vertices, faces, colors, face_uvs, face_metric)


def _header(fmt: str, lines: List[str]) -> bytes:
    return ("ply\nformat %s 1.0\n%s\nend_header\n" % (fmt, "\n".join(lines))).encode()


def write_ply_colored(path: str, vertices: np.ndarray, colors: np.ndarray,
                      faces: np.ndarray, fmt: str = "ascii") -> None:
    """Write a colored triangle mesh (reference OutputMesh, OpticalFlow.cpp:139-148).

    Colors are clamped to [0, 255] and stored as uchar.
    """
    vertices = np.asarray(vertices, np.float32)
    colors = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
    faces = np.asarray(faces, np.int32)
    lines = [
        f"element vertex {len(vertices)}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
    ]
    if fmt == "ascii":
        with open(path, "wb") as f:
            f.write(_header("ascii", lines))
            for p, c in zip(vertices, colors):
                f.write(b"%g %g %g %d %d %d\n" % (p[0], p[1], p[2], c[0], c[1], c[2]))
            for t in faces:
                f.write(b"3 %d %d %d\n" % (t[0], t[1], t[2]))
    else:
        vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("r", "u1"), ("g", "u1"), ("b", "u1")])
        varr = np.empty(len(vertices), vdt)
        varr["x"], varr["y"], varr["z"] = vertices.T
        varr["r"], varr["g"], varr["b"] = colors.T
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
        farr = np.empty(len(faces), fdt)
        farr["n"] = 3
        farr["idx"] = faces
        with open(path, "wb") as f:
            f.write(_header("binary_little_endian", lines))
            f.write(varr.tobytes())
            f.write(farr.tobytes())


def write_ply_face_vectors(path: str, vertices: np.ndarray, faces: np.ndarray,
                           face_vectors: np.ndarray) -> None:
    """Write a mesh with a per-face 3-vector (reference PlyVFFace output,
    OpticalFlow.cpp:163-178), binary little-endian."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    face_vectors = np.asarray(face_vectors, np.float32)
    lines = [
        f"element vertex {len(vertices)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "property float vx", "property float vy", "property float vz",
    ]
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    varr = np.empty(len(vertices), vdt)
    varr["x"], varr["y"], varr["z"] = vertices.T
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,)),
                    ("vx", "<f4"), ("vy", "<f4"), ("vz", "<f4")])
    farr = np.empty(len(faces), fdt)
    farr["n"] = 3
    farr["idx"] = faces
    farr["vx"], farr["vy"], farr["vz"] = face_vectors.T
    with open(path, "wb") as f:
        f.write(_header("binary_little_endian", lines))
        f.write(varr.tobytes())
        f.write(farr.tobytes())


def write_ply_textured(path: str, vertices: np.ndarray, faces: np.ndarray,
                       face_uvs: np.ndarray, fmt: str = "ascii") -> None:
    """Write a uv-textured mesh (PlyTexturedFace wedge-uv layout)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    face_uvs = np.asarray(face_uvs, np.float32).reshape(len(faces), 6)
    lines = [
        f"element vertex {len(vertices)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "property list uchar float texcoord",
    ]
    if fmt == "ascii":
        with open(path, "wb") as f:
            f.write(_header("ascii", lines))
            for p in vertices:
                f.write(b"%g %g %g\n" % (p[0], p[1], p[2]))
            for t, uv in zip(faces, face_uvs):
                f.write(b"3 %d %d %d 6 %g %g %g %g %g %g\n"
                        % (t[0], t[1], t[2], uv[0], uv[1], uv[2], uv[3], uv[4], uv[5]))
    else:
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,)), ("un", "u1"), ("uv", "<f4", (6,))])
        farr = np.empty(len(faces), fdt)
        farr["n"] = 3
        farr["idx"] = faces
        farr["un"] = 6
        farr["uv"] = face_uvs
        vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        varr = np.empty(len(vertices), vdt)
        varr["x"], varr["y"], varr["z"] = vertices.T
        with open(path, "wb") as f:
            f.write(_header("binary_little_endian", lines))
            f.write(varr.tobytes())
            f.write(farr.tobytes())


def write_ply_metric(path: str, vertices: np.ndarray, faces: np.ndarray,
                     square_lengths: np.ndarray) -> None:
    """Write a mesh with per-face squared edge lengths (Src/MetricFace.h) —
    the input record for Spectrum's --edgeMetric mode."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    sq = np.asarray(square_lengths, np.float64).reshape(len(faces), 3)
    lines = [
        f"element vertex {len(vertices)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "property list uchar double square_lengths",
    ]
    with open(path, "wb") as f:
        f.write(_header("ascii", lines))
        for p_ in vertices:
            f.write(b"%g %g %g\n" % (p_[0], p_[1], p_[2]))
        for t, q in zip(faces, sq):
            f.write(b"3 %d %d %d 3 %.17g %.17g %.17g\n"
                    % (t[0], t[1], t[2], q[0], q[1], q[2]))

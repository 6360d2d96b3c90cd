"""Raw binary vector dumps, byte-compatible with the reference
(Src/VectorIO.h:8-31: ``int size`` followed by the raw payload).

Used for Spectrum's ``eigenvector-%03d.bin`` files (Spectrum.cpp:191-195)
and the flow-field debug dumps (OpticalFlow.cpp:641-651).
"""

from __future__ import annotations

import struct

import numpy as np


def write_vector(path: str, data: np.ndarray, dtype=np.float64) -> None:
    """Write ``int32 count`` + raw elements. A (N, 2) array of 2-vectors is
    written as N records of 2 scalars (matching std::vector<Point2D<Real>>)."""
    arr = np.ascontiguousarray(np.asarray(data, dtype=dtype))
    count = arr.shape[0]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", count))
        f.write(arr.tobytes())


def read_vector(path: str, dtype=np.float64, width: int = 1) -> np.ndarray:
    """Read a reference binary vector; returns (N,) or (N, width)."""
    with open(path, "rb") as f:
        (count,) = struct.unpack("<i", f.read(4))
        payload = np.frombuffer(f.read(), dtype=dtype)
    if width > 1:
        payload = payload.reshape(count, width)
    else:
        payload = payload[:count]
    return payload


def write_grid(path: str, grid) -> None:
    """Binary Grid dump (Misha/Grid.inl read/write): int32 resX, int32 resY,
    then resX*resY elements row-major in the element dtype."""
    import numpy as np
    grid = np.asarray(grid)
    res_y, res_x = grid.shape[:2]
    with open(path, "wb") as f:
        np.asarray([res_x, res_y], "<i4").tofile(f)
        # Grid(x, y) indexes x fastest in memory: store as (resY, resX).
        grid.astype(grid.dtype.newbyteorder("<")).tofile(f)


def read_grid(path: str, dtype="<f8", channels: int = 1):
    """Read a binary Grid dump; returns (resY, resX) or (resY, resX, C)."""
    import numpy as np
    with open(path, "rb") as f:
        res_x, res_y = np.fromfile(f, "<i4", 2)
        data = np.fromfile(f, dtype, int(res_x) * int(res_y) * channels)
    if channels == 1:
        return data.reshape(res_y, res_x)
    return data.reshape(res_y, res_x, channels)

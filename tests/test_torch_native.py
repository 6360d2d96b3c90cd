"""The port's native host library (native/meshhost.cpp, built by g++ into
meshopticalflow_tpu_torch/_build/) against the port's numpy paths and the
reference package's native library (tests/test_native.py's cases)."""

import os

import numpy as np
import pytest

from meshopticalflow_tpu import native as j_native
from meshopticalflow_tpu.geometry.rasterize import rasterize_texture_source as j_raster
from meshopticalflow_tpu.geometry.subdivide import subdivide_tracked
from meshopticalflow_tpu_torch import native
from meshopticalflow_tpu_torch.geometry import mesh as t_mesh
from meshopticalflow_tpu_torch.geometry.rasterize import rasterize_texture_source
from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
from meshopticalflow_tpu_torch.utils import devcache

from conftest import make_grid_mesh, make_sphere_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ could not build native/meshhost.cpp"
    return lib


def test_library_builds_into_build_dir(lib):
    path = native.lib_path()
    pkg = os.path.join(REPO, "meshopticalflow_tpu_torch")
    assert str(path.parent) == os.path.join(pkg, "_build")
    assert path.name.startswith("libmeshhost_") and path.exists()
    assert native.build() == path
    assert not os.path.exists(os.path.join(pkg, "native", "libmeshhost.so"))


@pytest.mark.parametrize("mesh_fn,arg", [(make_sphere_mesh, 2), (make_grid_mesh, 7)])
def test_half_edge_native_matches_numpy(lib, monkeypatch, mesh_fn, arg):
    tris, _ = mesh_fn(arg)
    got = native.half_edge_opposites(tris)
    monkeypatch.setattr(native, "half_edge_opposites", lambda t: None)
    expect = t_mesh._half_edge_opposites(tris)
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("pad", [0, 2])
def test_rasterize_native_matches_numpy(lib, pad):
    rng = np.random.default_rng(7)
    uvs = rng.uniform(0.05, 0.95, (40, 3, 2))
    uvs[:, 1] = uvs[:, 0] + rng.uniform(0.05, 0.25, (40, 2))
    uvs[:, 2] = uvs[:, 0] + rng.uniform(-0.25, -0.05, (40, 2))
    uvs = np.clip(uvs, 0, 1)
    a = rasterize_texture_source(uvs, 64, 64, pad, use_native=True)
    b = rasterize_texture_source(uvs, 64, 64, pad, use_native=False)
    np.testing.assert_array_equal(a.tri_idx, b.tri_idx)
    claimed = a.tri_idx >= 0
    np.testing.assert_allclose(a.bary[claimed], b.bary[claimed], atol=1e-12)
    # needs_remap may differ only for texels sitting exactly on a triangle
    # boundary (1e-16-level sign flips in the inside test).
    border = np.minimum.reduce([b.bary[:, 0], b.bary[:, 1], 1 - b.bary.sum(1)])
    robust = claimed & (np.abs(border) > 1e-9)
    np.testing.assert_array_equal(a.needs_remap[robust], b.needs_remap[robust])


def test_native_matches_reference_on_cube256(lib):
    """The texel table and half-edge pairing of the 256^2 cube (0.06 edge
    length) equal the reference package's native output."""
    assert j_native.get_lib() is not None
    data = read_triangle_mesh(os.path.join(GOLD, "cube.ply"))
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, _, uvs, _, _ = subdivide_tracked(data.faces, data.vertices, data.face_uvs,
                                           0.06 * diag)
    ours = rasterize_texture_source(uvs, 256, 256, 2)
    ref = j_raster(uvs, 256, 256, 2)
    for field in ("tri_idx", "bary", "needs_remap"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field))
    np.testing.assert_array_equal(native.half_edge_opposites(tris),
                                  j_native.half_edge_opposites(tris))


def test_texture_problem_records_raster_path(lib, tmp_path, monkeypatch):
    """init_profile["raster_path"] names the rasterizer that built the texel
    table: the native one, or numpy when the library is unavailable."""
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path))
    devcache.clear()
    cfg = FlowConfig(dtype="float64", subdivide_edge_length=0.0, levels=1,
                     artifact_cache=False)
    paths = (os.path.join(GOLD, "cA.png"), os.path.join(GOLD, "cB.png"))
    mesh = os.path.join(GOLD, "cube.ply")
    ours = FlowProblem.from_texture_inputs(mesh, paths, cfg, device="cpu")
    assert ours.init_profile["raster_path"] == "native"
    monkeypatch.setattr(native, "get_lib", lambda: None)
    fallback = FlowProblem.from_texture_inputs(mesh, paths, cfg, device="cpu")
    assert fallback.init_profile["raster_path"] == "numpy"
    np.testing.assert_array_equal(fallback.texture_source.tri_idx,
                                  ours.texture_source.tri_idx)
    devcache.clear()

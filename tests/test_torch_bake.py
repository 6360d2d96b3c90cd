"""The per-vertex texture bake (kernels/bake.py) against the host copy.

* ``bake_vertices`` on CPU tensors (the plain twin, which the CUDA kernel
  repeats op for op) equals flow/pipeline.py:sample_texture_to_vertices bit
  for bit: bilinear and nearest, two meshes (one with a vertex index that
  no triangle uses), atlases of other widths and heights, uvs at and beyond
  0 and 1.
* The wedge table lists each vertex's wedges in ascending wedge index, the
  order in which ``np.add.at`` adds them.
* ``FlowProblem.from_texture_inputs`` on the CPU hands the constructor the
  same signals, textures and wedge uvs as the host bake and host casts did.
* The wrapper refuses operands it does not take.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.flow import pipeline
from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
from meshopticalflow_tpu_torch.kernels import bake
from meshopticalflow_tpu_torch.utils.testing import octa_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")


def _cube():
    data = read_triangle_mesh(os.path.join(GOLD, "cube.ply"))
    return data.faces, data.face_uvs


def _sphere_with_gap():
    """The octahedral sphere with vertex 5 left out of every triangle (its
    index shifted past a gap), and random wedge uvs."""
    tris, _ = octa_sphere(2)
    tris = np.where(tris >= 5, tris + 1, tris).astype(np.int32)
    uvs = np.random.default_rng(11).uniform(0.0, 1.0, (len(tris), 3, 2))
    return tris, uvs


MESHES = {"cube": _cube, "sphere_gap": _sphere_with_gap}


def _uvs(uvs, kind, seed):
    """The mesh's own uvs, or uvs at and beyond 0 and 1 on a share of the
    wedges: exactly 0 and 1 (the atlas' last texel, no right neighbour),
    and below 0 and above 1 (clipped)."""
    if kind == "mesh":
        return uvs
    rng = np.random.default_rng(seed)
    out = uvs.reshape(-1, 2).copy()
    pick = rng.random(out.shape) < 0.4
    edge = rng.choice(np.array([0.0, 1.0, -0.25, 1.5, -1e-12, 1.0 + 1e-12]), out.shape)
    out[pick] = edge[pick]
    return out.reshape(uvs.shape)


def _textures(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (2, h, w, 3), dtype=np.uint8)


def _host(tris, uvs, textures, n_vertices, bilinear):
    return np.stack([pipeline.sample_texture_to_vertices(tris, uvs, t, n_vertices, bilinear)
                     for t in textures])


def _bake(tris, uvs, textures, n_vertices, bilinear):
    wedges, offsets = bake.wedge_table(tris, n_vertices)
    out = bake.bake_vertices(torch.from_numpy(textures),
                             torch.from_numpy(np.ascontiguousarray(uvs, np.float64)),
                             wedges, offsets, bilinear)
    return out.numpy()


@pytest.mark.parametrize("uv_kind", ["mesh", "edges"])
@pytest.mark.parametrize("atlas", [(48, 64), (80, 37)])
@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bake_equals_host_copy(mesh, bilinear, atlas, uv_kind):
    tris, uvs = MESHES[mesh]()
    uvs = _uvs(uvs, uv_kind, seed=atlas[0])
    textures = _textures(*atlas, seed=atlas[1])
    n_vertices = int(tris.max()) + 1
    ours = _bake(tris, uvs, textures, n_vertices, bilinear)
    ref = _host(tris, uvs, textures, n_vertices, bilinear)
    assert ours.dtype == np.float64 and ours.shape == (2, n_vertices, 3)
    assert np.array_equal(ours, ref)
    if mesh == "sphere_gap":
        assert not ours[:, 5].any()     # the unused vertex: count 0, colour 0


def test_bake_counts_no_launch_on_the_cpu():
    tris, uvs = _cube()
    before = bake.bake_vertices.launches
    _bake(tris, uvs, _textures(8, 8, 0), int(tris.max()) + 1, True)
    assert bake.bake_vertices.launches == before


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_wedge_table_is_the_order_of_add_at(mesh):
    tris, _ = MESHES[mesh]()
    n_vertices = int(tris.max()) + 1
    wedges, offsets = bake.wedge_table(tris, n_vertices)
    assert wedges.dtype == offsets.dtype == torch.int32
    wedges, offsets = wedges.numpy(), offsets.numpy()
    corners = tris.ravel()
    for v in range(n_vertices):
        mine = wedges[offsets[v]:offsets[v + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(corners == v))
    # np.add.at adds in the index order: values whose sums depend on the
    # order (1e16 + 1.0 rounds back to 1e16), summed a vertex in the
    # table's order
    vals = np.random.default_rng(5).choice([1e16, -1e16, 1.0, 1.0], corners.size)
    at = np.zeros(n_vertices)
    np.add.at(at, corners, vals)
    walked = np.zeros(n_vertices)
    backwards = np.zeros(n_vertices)
    for v in range(n_vertices):
        for k in wedges[offsets[v]:offsets[v + 1]]:
            walked[v] += vals[k]
        for k in wedges[offsets[v]:offsets[v + 1]][::-1]:
            backwards[v] += vals[k]
    assert np.array_equal(at, walked)
    assert not np.array_equal(at, backwards)   # the values do tell the orders apart


@pytest.mark.parametrize("nearest", [False, True])
def test_from_texture_inputs_bakes_as_before(monkeypatch, nearest):
    """The constructor gets the host bake's signals, and the textures and
    wedge uvs that the host casts gave, bit for bit."""
    mesh = os.path.join(GOLD, "cube.ply")
    paths = (os.path.join(GOLD, "mA.png"), os.path.join(GOLD, "mB.png"))
    cfg = FlowConfig(dtype="float32", subdivide_edge_length=0.08, levels=1,
                     nearest=nearest, artifact_cache=False)
    seen = {}
    shipped = pipeline.FlowProblem.__init__

    def spy(self, config, mesh_, signals, **kw):
        seen["signals"] = np.array(signals)
        shipped(self, config, mesh_, signals, **kw)

    monkeypatch.setattr(pipeline.FlowProblem, "__init__", spy)
    prob = pipeline.FlowProblem.from_texture_inputs(mesh, paths, cfg, device="cpu")
    geo = pipeline._texture_geometry(mesh, cfg.subdivide_edge_length)
    tex = np.stack([pipeline.read_png_rgb(p) for p in paths])
    ref = _host(geo["tris"], geo["uvs"], tex, int(geo["tris"].max()) + 1, not nearest)
    assert seen["signals"].dtype == np.float64
    assert np.array_equal(seen["signals"], ref)
    assert torch.equal(prob.textures, torch.as_tensor(tex).to(torch.float32))
    assert torch.equal(prob.tri_uvs, torch.as_tensor(geo["uvs"]).to(torch.float32))


def _operands(**change):
    tris, uvs = _cube()
    wedges, offsets = bake.wedge_table(tris, int(tris.max()) + 1)
    ops = dict(textures=torch.from_numpy(_textures(8, 8, 1)),
               uvs=torch.from_numpy(uvs.reshape(-1, 2).copy()), wedges=wedges, offsets=offsets)
    ops.update(change)
    return ops


@pytest.mark.parametrize("case,error", [
    ("float_textures", TypeError), ("float32_uvs", TypeError), ("int64_table", TypeError),
    ("one_texture", ValueError), ("rgba", ValueError), ("short_uvs", ValueError),
    ("mixed_devices", ValueError), ("meta", ValueError)])
def test_bake_refuses(case, error):
    base = _operands()
    change = {
        "float_textures": dict(textures=base["textures"].float()),
        "float32_uvs": dict(uvs=base["uvs"].float()),
        "int64_table": dict(wedges=base["wedges"].long()),
        "one_texture": dict(textures=base["textures"][:1]),
        "rgba": dict(textures=torch.zeros((2, 8, 8, 4), dtype=torch.uint8)),
        "short_uvs": dict(uvs=base["uvs"][:-1]),
        "mixed_devices": dict(uvs=base["uvs"].to("meta")),
        "meta": {k: v.to("meta") for k, v in base.items()},
    }[case]
    with pytest.raises(error):
        bake.bake_vertices(**_operands(**change))


def test_wedge_table_refuses_a_vertex_past_the_count():
    tris, _ = _cube()
    with pytest.raises(ValueError):
        bake.wedge_table(tris, int(tris.max()))

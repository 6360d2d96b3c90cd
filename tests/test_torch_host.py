"""Host code of the PyTorch port against the reference package, exactly.

The port carries jax-free copies of the reference package's numpy host code
(the machine that runs the port has no jax). Every copy is held here to its
original on the cube and sphere fixtures with exact equality, and a drift
guard pins the reference sources the copies were taken from.
"""

import hashlib
import importlib
import inspect
import os
import struct
import zlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.geometry import mesh as j_mesh
from meshopticalflow_tpu.geometry import rasterize as j_raster
from meshopticalflow_tpu.geometry import subdivide as j_subdiv
from meshopticalflow_tpu.io import ply as j_ply
from meshopticalflow_tpu.models import base as j_base
from meshopticalflow_tpu.models import whitney as j_whitney
from meshopticalflow_tpu.ops import ell as j_ell
from meshopticalflow_tpu.utils.testing import octa_sphere
from meshopticalflow_tpu_torch import config as t_config
from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline
from meshopticalflow_tpu_torch.geometry import mesh as t_mesh
from meshopticalflow_tpu_torch.geometry import rasterize as t_raster
from meshopticalflow_tpu_torch.geometry import subdivide as t_subdiv
from meshopticalflow_tpu_torch.io import ply as t_ply
from meshopticalflow_tpu_torch.io import png as t_png
from meshopticalflow_tpu_torch.models import base as t_base
from meshopticalflow_tpu_torch.models import whitney as t_whitney
from meshopticalflow_tpu_torch.ops import ell as t_ell

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _cube(edge_fraction=0.08):
    data = j_ply.read_triangle_mesh(os.path.join(GOLD, "cube.ply"))
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    return data.faces, data.vertices, data.face_uvs, edge_fraction * diag


def _sphere():
    tris, verts = octa_sphere(2)
    return tris, verts, np.zeros((len(tris), 3, 2)), 0.3


FIXTURES = {"cube": _cube, "sphere": _sphere}


def _assert_same(a, b):
    """Exact equality of two (possibly nested) host results."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif sp.issparse(a):
        _assert_same(a.tocsr().toarray(), b.tocsr().toarray())
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def fixture(request):
    tris0, verts0, uvs0, edge = FIXTURES[request.param]()
    out_j = j_subdiv.subdivide_tracked(tris0, verts0, uvs0, edge)
    out_t = t_subdiv.subdivide_tracked(tris0, verts0, uvs0, edge)
    tris, verts, uvs = out_j[:3]
    return dict(name=request.param, subdiv=(out_j, out_t), tris=tris,
                verts=verts, uvs=uvs,
                mesh_j=j_mesh.build_mesh(tris, vertices=verts),
                mesh_t=t_mesh.build_mesh(tris, vertices=verts))


def test_ply_reader():
    for name in ("cube.ply", "a.ply", "ref_vertex.ply"):
        a = j_ply.read_triangle_mesh(os.path.join(GOLD, name))
        b = t_ply.read_triangle_mesh(os.path.join(GOLD, name))
        for field in ("vertices", "faces", "colors", "face_uvs"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None)
            if x is not None:
                _assert_same(x, y)


def test_subdivision(fixture):
    out_j, out_t = fixture["subdiv"]
    _assert_same(out_j, out_t)


def test_mesh_tables(fixture):
    a, b = fixture["mesh_j"], fixture["mesh_t"]
    for field in ("triangles", "g", "g_inv", "area", "opp", "xform_linear",
                  "xform_const"):
        _assert_same(getattr(a, field), getattr(b, field))
    assert a.n_vertices == b.n_vertices
    t_mesh.sanity_check(b)


def test_rasterizer():
    tris0, verts0, uvs0, edge = _cube()
    uvs = j_subdiv.subdivide_tracked(tris0, verts0, uvs0, edge)[2]
    for w, h, pad in ((64, 64, 2), (96, 80, 1)):
        a = j_raster.rasterize_texture_source(uvs, w, h, pad, use_native=False)
        b = t_raster.rasterize_texture_source(uvs, w, h, pad)
        for field in ("tri_idx", "bary", "needs_remap"):
            _assert_same(getattr(a, field), getattr(b, field))


def test_whitney_basis_and_ell_patterns(fixture):
    host_j = j_whitney.build_whitney_basis(fixture["mesh_j"])
    host_t = t_whitney.build_whitney_basis(fixture["mesh_t"])
    assert host_j.n_coeffs == host_t.n_coeffs
    _assert_same((host_j.p_idx, host_j.p_wt, host_j.smooth),
                 (host_t.p_idx, host_t.p_wt, host_t.smooth))
    dev_j = j_base.finalize_basis(host_j, dtype=jnp.float64)
    cols, s_vals, diag_slot, dt_slots = t_base.basis_patterns(host_t)
    _assert_same((np.asarray(dev_j.ell_cols), np.asarray(dev_j.s_vals),
                  np.asarray(dev_j.diag_slot), np.asarray(dev_j.dt_slots)),
                 (cols, s_vals, diag_slot, dt_slots))


def test_smoothing_operator_patterns(fixture):
    from meshopticalflow_tpu.flow.signal import make_smoothing_operators as j_make
    from meshopticalflow_tpu_torch.flow.signal import make_smoothing_operators as t_make

    a = j_make(fixture["mesh_j"], jnp.float64)
    b = t_make(fixture["mesh_t"], dtype=torch.float64)
    for field in ("cols", "mass_vals", "stiff_vals", "diag_slot", "lumped"):
        x, y = np.asarray(getattr(a, field)), getattr(b, field).numpy()
        np.testing.assert_array_equal(x, y.astype(x.dtype))


def test_ell_from_scipy_and_slot_map():
    rng = np.random.default_rng(0)
    mat = sp.random(120, 120, density=0.05, random_state=1, format="csr")
    a, b = j_ell.ell_from_scipy(mat), t_ell.ell_from_scipy(mat)
    _assert_same((a.cols, a.vals, a.diag_slot), (b.cols, b.vals, b.diag_slot))
    coo = mat.tocoo()
    pick = rng.permutation(coo.nnz)
    _assert_same(j_ell.coo_slot_map(a.cols, coo.row[pick], coo.col[pick]),
                 t_ell.coo_slot_map(b.cols, coo.row[pick], coo.col[pick]))
    missing = np.setdiff1d(np.arange(120), b.cols[0])[0]
    with pytest.raises(ValueError):
        t_ell.coo_slot_map(b.cols, np.array([0]), np.array([missing]))


def test_texture_bake():
    from meshopticalflow_tpu.flow.pipeline import sample_texture_to_vertices as j_bake

    tris0, verts0, uvs0, edge = _cube()
    tex = t_png.read_png_rgb(os.path.join(GOLD, "mA.png"))
    for bilinear in (True, False):
        _assert_same(j_bake(tris0, uvs0, tex, len(verts0), bilinear),
                     t_pipeline.sample_texture_to_vertices(tris0, uvs0, tex,
                                                           len(verts0), bilinear))


def test_config_matches_reference_fields():
    import dataclasses

    a = {f.name: f.default for f in dataclasses.fields(JaxFlowConfig)}
    b = {f.name: f.default for f in dataclasses.fields(t_config.FlowConfig)}
    assert a == b


@pytest.mark.parametrize("kwargs", [
    dict(), dict(vf_mode=1), dict(flow_backend="pallas"), dict(use_host_cholesky=True),
    dict(divergence_free=True), dict(connection_mode=1),
])
def test_config_refuses_unported_paths(kwargs):
    cfg = t_config.FlowConfig(**kwargs)     # default use_multigrid=True
    with pytest.raises(NotImplementedError):
        t_config.require_supported(cfg)
    if kwargs:
        with pytest.raises(NotImplementedError):
            t_config.require_supported(t_config.FlowConfig(use_multigrid=False, **kwargs))
    else:
        t_config.require_supported(t_config.FlowConfig(use_multigrid=False))


# -- PNG reader --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(f for f in os.listdir(GOLD) if f.endswith(".png")))
def test_png_reader_matches_pillow(name):
    from PIL import Image

    path = os.path.join(GOLD, name)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"), dtype=np.uint8)
    _assert_same(t_png.read_png_rgb(path), ref)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _encode_png(path, img, kinds):
    """Write ``img`` (H, W, 3|4) uint8 with scanline filter kinds[y] on row y."""
    h, w, ch = img.shape
    flat = img.reshape(h, w * ch).astype(int)
    raw = bytearray()
    for y in range(h):
        k = kinds[y % len(kinds)]
        prior = flat[y - 1] if y else np.zeros(w * ch, int)
        row = []
        for i in range(w * ch):
            a = flat[y, i - ch] if i >= ch else 0
            b = prior[i]
            c = prior[i - ch] if i >= ch else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][k]
            row.append((flat[y, i] - pred) % 256)
        raw += bytes([k]) + bytes(row)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    colour = {3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_all_filters(tmp_path, channels):
    from PIL import Image

    img = np.random.default_rng(channels).integers(0, 256, (10, 7, channels),
                                                   dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _encode_png(path, img, kinds=[0, 1, 2, 3, 4])
    ours = t_png.read_png_rgb(path)
    _assert_same(ours, img[:, :, :3])
    with Image.open(path) as im:
        _assert_same(ours, np.asarray(im.convert("RGB"), dtype=np.uint8))


def test_png_write_read_round_trip(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (33, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    t_png.write_png_rgb(path, img)
    _assert_same(t_png.read_png_rgb(path), img)


# -- drift guard -------------------------------------------------------------

# sha256[:16] of the reference sources the port's host code was copied from:
# the whole module, or the listed functions and classes. A failing case means
# the reference changed: carry the change into the port's copy (and its tests
# above), then update the pinned hash.
HOST_COPIES = {
    "config": (None, "ac22be9ae16714e6"),
    "io.ply": (None, "f2d3a17e572c089c"),
    "io.png": (None, "58359726d8d3919d"),
    "geometry.mesh": (None, "9193dd5a48fbb66c"),
    "geometry.subdivide": (None, "2154b569f47565d9"),
    "geometry.rasterize": (None, "2cd16078e8234c8e"),
    "ops.elements": (None, "71f36243538ef108"),
    "ops.assemble": (None, "cd5bd5a3c287da89"),
    "models.whitney": (None, "f9a18ce7870648fa"),
    "ops.ell": (("HostEll", "ell_from_scipy", "coo_slot_map"), "f3334ac3c9490bc0"),
    "models.base": (("BasisHost", "finalize_basis"), "9d030c633e89ba46"),
    "flow.signal": (("make_smoothing_operators",), "0c929c8905ae3dd2"),
    "flow.pipeline": (("_host_sample_texture", "sample_texture_to_vertices"),
                      "56aa701ba05c4175"),
}


@pytest.mark.parametrize("module", sorted(HOST_COPIES))
def test_host_copy_tracks_reference(module):
    names, pinned = HOST_COPIES[module]
    ref = importlib.import_module(f"meshopticalflow_tpu.{module}")
    src = inspect.getsource(ref) if names is None else \
        "".join(inspect.getsource(getattr(ref, n)) for n in names)
    assert hashlib.sha256(src.encode()).hexdigest()[:16] == pinned, (
        f"meshopticalflow_tpu/{module.replace('.', '/')}.py changed since the "
        f"port copied it into meshopticalflow_tpu_torch: port the change")
    importlib.import_module(f"meshopticalflow_tpu_torch.{module}")

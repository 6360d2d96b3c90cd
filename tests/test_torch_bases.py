"""The Conformal and Connection bases and their coarse spaces against the
reference package.

* Host copies, exact equality on the cube and the sphere: the Conformal
  basis (with and without ``divergence_free``), the Connection basis in each
  ConnectionMode, their ELL patterns, and ``build_coarse_space`` for the five
  non-Whitney configurations (the Whitney one is in tests/test_torch_host.py).
* Device operations on those bases and coarse spaces in float64, to 1e-12
  relative: the level system (``build_flow_system``), the Galerkin coarse
  system (``coarse_system_vals``), ``prolong`` and ``restrict``.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.geometry import mesh as j_mesh
from meshopticalflow_tpu.io import ply as j_ply
from meshopticalflow_tpu.models import base as j_base
from meshopticalflow_tpu.models import coarse as j_coarse
from meshopticalflow_tpu.models import conformal as j_conformal
from meshopticalflow_tpu.models import connection as j_connection
from meshopticalflow_tpu.utils.testing import octa_sphere
from meshopticalflow_tpu_torch import config as t_config
from meshopticalflow_tpu_torch.geometry import mesh as t_mesh
from meshopticalflow_tpu_torch.geometry import subdivide as t_subdiv
from meshopticalflow_tpu_torch.models import base as t_base
from meshopticalflow_tpu_torch.models import coarse as t_coarse
from meshopticalflow_tpu_torch.models import conformal as t_conformal
from meshopticalflow_tpu_torch.models import connection as t_connection

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
DEVICE_TOL = 1e-12

# (vf_mode, connection_mode, divergence_free) of the non-Whitney bases
CONFIGS = {
    "conformal": (1, 0, False),
    "conformal-divfree": (1, 0, True),
    "connection-pb": (2, 0, False),
    "connection-bary": (2, 1, False),
    "connection-invcot": (2, 2, False),
}


def _cube():
    data = j_ply.read_triangle_mesh(os.path.join(GOLD, "cube.ply"))
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    return data.faces, data.vertices, data.face_uvs, 0.08 * diag


def _sphere():
    tris, verts = octa_sphere(2)
    return tris, verts, np.zeros((len(tris), 3, 2)), 0.3


@pytest.fixture(scope="module", params=["cube", "sphere"])
def meshes(request):
    """Both packages' fine and root meshes of one subdivided fixture."""
    tris0, verts0, uvs0, edge = {"cube": _cube, "sphere": _sphere}[request.param]()
    tris, verts, _, parent, bary = t_subdiv.subdivide_tracked(tris0, verts0, uvs0, edge)
    return dict(
        fine_j=j_mesh.build_mesh(tris, vertices=verts),
        fine_t=t_mesh.build_mesh(tris, vertices=verts),
        root_j=j_mesh.build_mesh(tris0, vertices=verts0),
        root_t=t_mesh.build_mesh(tris0, vertices=verts0),
        parent=parent, bary=bary)


def _same(a, b):
    """Exact equality; sparse matrices by their dense values, integer index
    arrays regardless of width."""
    if sp.issparse(a):
        a, b = a.toarray(), b.toarray()
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b.astype(a.dtype))


def _configs(name):
    vf, cm, df = CONFIGS[name]
    kw = dict(vf_mode=vf, connection_mode=cm, divergence_free=df, dtype="float64")
    return JaxFlowConfig(**kw), t_config.FlowConfig(**kw)


@pytest.mark.parametrize("divergence_free", [False, True])
def test_conformal_basis_host_copy(meshes, divergence_free):
    a = j_conformal.build_conformal_basis(meshes["fine_j"], divergence_free)
    b = t_conformal.build_conformal_basis(meshes["fine_t"], divergence_free)
    assert (a.name, a.n_coeffs) == (b.name, b.n_coeffs)
    for x, y in ((a.p_idx, b.p_idx), (a.p_wt, b.p_wt), (a.smooth, b.smooth)):
        _same(x, y)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_connection_basis_host_copy(meshes, mode):
    a = j_connection.build_connection_basis(meshes["fine_j"], mode)
    b = t_connection.build_connection_basis(meshes["fine_t"], t_config.ConnectionMode(mode))
    assert (a.name, a.n_coeffs) == (b.name, b.n_coeffs)
    for x, y in ((a.p_idx, b.p_idx), (a.p_wt, b.p_wt), (a.smooth, b.smooth)):
        _same(x, y)
    # and the union ELL pattern the device system lives on
    dev = j_base.finalize_basis(a, dtype=jnp.float64)
    cols, s_vals, diag_slot, dt_slots = t_base.basis_patterns(b)
    for x, y in ((dev.ell_cols, cols), (dev.s_vals, s_vals), (dev.diag_slot, diag_slot),
                 (dev.dt_slots, dt_slots)):
        _same(x, y)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def spaces(request, meshes):
    """Both packages' fine bases and coarse spaces of one configuration."""
    cfg_j, cfg_t = _configs(request.param)
    host_j, dev_j = j_base.build_basis(meshes["fine_j"], cfg_j)
    host_t, dev_t = t_base.build_basis(meshes["fine_t"], cfg_t)
    cs_j = j_coarse.build_coarse_space(cfg_j, meshes["fine_j"], host_j, meshes["root_j"],
                                       meshes["parent"], meshes["bary"])
    cs_t = t_coarse.build_coarse_space(cfg_t, meshes["fine_t"], host_t, meshes["root_t"],
                                       meshes["parent"], meshes["bary"])
    return dict(name=request.param, dev_j=dev_j, dev_t=dev_t, cs_j=cs_j, cs_t=cs_t,
                n_tri=meshes["fine_t"].n_triangles)


def test_coarse_space_host_copy(spaces):
    j, t = spaces["cs_j"], spaces["cs_t"]
    for x, y in ((j.p0, t.p0), (j.p0_idx, t.p0_idx), (j.p0_wt, t.p0_wt),
                 (j.coarse_host.p_idx, t.coarse_host.p_idx),
                 (j.coarse_host.p_wt, t.coarse_host.p_wt),
                 (j.coarse_host.smooth, t.coarse_host.smooth)):
        _same(x, y)
    assert (j.coarse_host.name, j.coarse_host.n_coeffs) == \
        (t.coarse_host.name, t.coarse_host.n_coeffs)
    for field in ("ell_cols", "s_vals", "diag_slot", "dt_slots"):
        _same(getattr(j.coarse_dev, field), getattr(t.coarse_dev, field))


def _rel(a, b):
    """max |a - b| / max |b| over the finite entries; the non-finite ones
    (inverse-cotangent weights of right-angled cube triangles are infinite
    in both packages) must sit at the same places with the same values."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    if not fin.any():
        return 0.0
    return float(np.abs(a[fin] - b[fin]).max() / max(np.abs(b[fin]).max(), 1e-300))


def test_device_ops_on_new_bases(spaces):
    """Level system, Galerkin coarse system, prolong and restrict, f64."""
    rng = np.random.default_rng(7)
    t = spaces["n_tri"]
    a = rng.normal(size=(t, 2, 2))
    d_blocks = np.einsum("tak,tbk->tab", a, a) + 0.1 * np.eye(2)
    rhs_t = rng.normal(size=(t, 2))
    lam = 3e-3
    dj, dt = spaces["dev_j"], spaces["dev_t"]
    out_j = j_base.build_flow_system(dj, jnp.asarray(d_blocks), jnp.asarray(rhs_t),
                                     jnp.asarray(lam))
    out_t = t_base.build_flow_system(dt, torch.as_tensor(d_blocks), torch.as_tensor(rhs_t),
                                     torch.as_tensor(lam, dtype=torch.float64))
    for x, y in zip(out_t, out_j):          # sys_vals, dt_vals, rhs, diag, scale
        assert _rel(x, y) <= DEVICE_TOL
    scale = out_j[4]
    cj, ct = spaces["cs_j"].coarse_dev, spaces["cs_t"].coarse_dev
    c_j = j_base.coarse_system_vals(cj, jnp.asarray(d_blocks), scale, jnp.asarray(lam))
    c_t = t_base.coarse_system_vals(ct, torch.as_tensor(d_blocks),
                                    torch.as_tensor(np.array(scale)),
                                    torch.as_tensor(lam, dtype=torch.float64))
    for x, y in zip(c_t, c_j):              # values and diagonal
        assert _rel(x, y) <= DEVICE_TOL
    coeffs = rng.normal(size=dt.n_coeffs)
    assert _rel(t_base.prolong(dt, torch.as_tensor(coeffs)),
                j_base.prolong(dj, jnp.asarray(coeffs))) <= DEVICE_TOL
    assert _rel(t_base.restrict(dt, torch.as_tensor(rhs_t)),
                j_base.restrict(dj, jnp.asarray(rhs_t))) <= DEVICE_TOL
    cc = rng.normal(size=ct.n_coeffs)
    assert _rel(t_base.prolong(ct, torch.as_tensor(cc)),
                j_base.prolong(cj, jnp.asarray(cc))) <= DEVICE_TOL

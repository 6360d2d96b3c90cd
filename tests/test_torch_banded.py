"""The port's banded Cholesky (solvers/banded.py) against the reference.

The reference's revalue and factorization run in float32 only, so they are
held to the port's float32 path (revalue exactly; factor and solves to 1e-5
relative, as two Cholesky implementations round differently), and the port's
float64 path is held to scipy at 1e-10. The panel solves are dtype-generic
in both packages and are compared in float64 from the same factor to 1e-12.
The systems are those of tests/test_banded.py.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.solvers import banded as jb
from meshopticalflow_tpu_torch.solvers import banded as tb
from meshopticalflow_tpu_torch.solvers import mg
from tests.test_banded import _mesh_like_spd, _to_ell

torch.set_num_threads(1)

F32_TOL = 1e-5
F64_TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_factor(pat, vals, dtype, shift=0.0, k=None):
    s = tb.band_revalue(torch.as_tensor(pat.slots), torch.as_tensor(np.array(vals)).to(dtype),
                        pat.m, pat.nb, pat.bw, pat.n)
    l_blocks, ok = tb.band_cholesky(s, shift, pat.nb, pat.bw)
    k = max(1, min(8, pat.bw // pat.nb)) if k is None else k
    return s, l_blocks, bool(ok), tb.build_solve_panels(l_blocks, k)


def _port_solve(pat, panels, b):
    return tb.band_solve_panels(*panels, torch.as_tensor(pat.perm),
                                torch.as_tensor(pat.inv_perm), b, pat.n).numpy()


@pytest.mark.parametrize("n,nb", [(300, 32), (1000, 64), (513, 128)])
def test_banded_solve_matches_reference(n, nb):
    rng = np.random.default_rng(n)
    a = _mesh_like_spd(n, rng)
    cols, vals = _to_ell(a)
    pat = tb.build_band_pattern(cols, nb=nb)
    b = rng.normal(size=n)
    # float32: the reference's own precision
    s32, _, ok, panels = _port_factor(pat, vals, torch.float32)
    s_ref = jb.band_revalue(jnp.asarray(pat.slots), jnp.asarray(vals, jnp.float32),
                            pat.m, pat.nb, pat.bw, pat.n)
    np.testing.assert_array_equal(s32.numpy(), np.asarray(s_ref))
    ref = jb.BandedCholeskySolver(pat).factor(jnp.asarray(vals, jnp.float32))
    x_ref = np.asarray(ref.solve(jnp.asarray(b, jnp.float32)), np.float64)
    x32 = _port_solve(pat, panels, torch.as_tensor(b, dtype=torch.float32))
    assert ok and _rel(x32, x_ref) < F32_TOL
    # float64 on the port against scipy
    _, _, ok64, panels64 = _port_factor(pat, vals, torch.float64)
    x64 = _port_solve(pat, panels64, torch.as_tensor(b))
    assert ok64 and _rel(x64, spla.spsolve(a.tocsc(), b)) < F64_TOL


def test_banded_multi_rhs_and_dtype():
    rng = np.random.default_rng(0)
    n = 640
    a = _mesh_like_spd(n, rng)
    cols, vals = _to_ell(a)
    pat = tb.build_band_pattern(cols, nb=64)
    b = rng.normal(size=(n, 5))
    for dtype, tol in ((torch.float32, 5e-5), (torch.float64, F64_TOL)):
        _, _, ok, panels = _port_factor(pat, vals, dtype)
        x = tb.band_solve_panels(*panels, torch.as_tensor(pat.perm),
                                 torch.as_tensor(pat.inv_perm),
                                 torch.as_tensor(b).to(dtype), n)
        assert ok and x.shape == (n, 5) and x.dtype == dtype
        for k in range(5):
            assert _rel(x[:, k].numpy(), spla.spsolve(a.tocsc(), b[:, k])) < tol


@pytest.mark.parametrize("n,nb,k", [(1000, 64, 4), (513, 32, 2), (700, 64, 1)])
def test_panel_solves_match_reference_f64(n, nb, k):
    """Same float64 factor into both packages' panel layouts and sweeps."""
    rng = np.random.default_rng(n + k)
    a = _mesh_like_spd(n, rng)
    cols, vals = _to_ell(a)
    pat = tb.build_band_pattern(cols, nb=nb, bw_pad=k * nb)
    _, l_blocks, ok, (dinv, pbelow) = _port_factor(pat, vals, torch.float64, k=k)
    dinv_j, pbelow_j = jb.build_solve_panels(jnp.asarray(l_blocks.numpy()), k)
    np.testing.assert_allclose(dinv.numpy(), np.asarray(dinv_j), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(pbelow.numpy(), np.asarray(pbelow_j))
    mp, s, _ = dinv.shape
    rhs = rng.normal(size=(mp, s, 3))
    y_t = tb.panel_lower_solve(dinv, pbelow, torch.as_tensor(rhs))
    y_j = jb.panel_lower_solve(dinv_j, pbelow_j, jnp.asarray(rhs))
    assert _rel(y_t.numpy(), y_j) < 1e-12
    x_t = tb.panel_upper_solve(dinv, pbelow, y_t)
    x_j = jb.panel_upper_solve(dinv_j, pbelow_j, y_j)
    assert ok and _rel(x_t.numpy(), x_j) < 1e-12


@pytest.mark.parametrize("case", ["shift_recovers", "total_breakdown"])
def test_c1_shift_ladder_matches_reference(case):
    """The MG c1 factor's escalating diagonal shift (0, 1e-6, 1e-4, 1e-2 of
    max|diag|): an indefinite system that a 1e-2 shift makes definite
    factors in both packages; a nearly semidefinite one with a tiny diagonal
    (tests/test_banded.py:112-125) breaks down at every shift in both."""
    import scipy.sparse as sp

    from meshopticalflow_tpu.solvers import pallas_mg as pm

    rng = np.random.default_rng(3)
    n = 256
    a = _mesh_like_spd(n, rng)
    if case == "shift_recovers":
        lmin = np.linalg.eigvalsh(a.toarray())[0]
        a = (a - sp.identity(n) * (lmin + 1e-3 * a.diagonal().max())).tocsr()
    else:
        a = (a - sp.diags(a.diagonal()) + sp.diags(np.full(n, 1e-7))).tocsr()
    cols, vals = _to_ell(a)
    pat = tb.build_band_pattern(cols, nb=32)
    _, _, ok0, _ = _port_factor(pat, vals, torch.float32)
    assert not ok0
    band_j = pm.BandedC1(slots=jnp.asarray(pat.slots), tile_to_band=None,
                         band_to_tile=None, nb=pat.nb, bw=pat.bw, m=pat.m, n1=pat.n)
    dinv_j, _, _ = pm._factor_c1_panels(band_j, jnp.asarray(vals, jnp.float32),
                                        jnp.asarray(a.diagonal(), jnp.float32))
    band = mg.BandedC1(slots=torch.as_tensor(pat.slots), perm=torch.as_tensor(pat.perm),
                       inv_perm=torch.as_tensor(pat.inv_perm), nb=pat.nb, bw=pat.bw,
                       m=pat.m, n1=pat.n)
    dinv, pbelow, ok = mg._factor_c1_panels(band, torch.as_tensor(vals, dtype=torch.float32),
                                            torch.as_tensor(a.diagonal(), dtype=torch.float32))
    assert (dinv is None) == (dinv_j is None) == (case == "total_breakdown")
    if dinv is not None:
        assert bool(ok)
        assert _rel(dinv.numpy(), np.asarray(dinv_j)) < F32_TOL * 10
        assert torch.isfinite(mg._inner1_exact(dinv, pbelow, band, torch.ones(n))).all()


def test_banded_on_real_coarse_flow_system():
    """The c1-like Whitney flow system of a sphere problem
    (tests/test_banded.py:128-162), float32 against the reference and
    float64 against scipy."""
    import scipy.sparse as sp

    from meshopticalflow_tpu.config import FlowConfig
    from meshopticalflow_tpu.geometry.mesh import build_mesh
    from meshopticalflow_tpu.models.base import build_basis, build_flow_system
    from meshopticalflow_tpu.utils.testing import sphere_signal_pair

    tris, verts, _, _ = sphere_signal_pair(3)
    mesh = build_mesh(tris, vertices=verts)
    _, dev = build_basis(mesh, FlowConfig(dtype="float64"))
    t = mesh.n_triangles
    rng = np.random.default_rng(5)
    d_blocks = rng.normal(size=(t, 2, 2))
    d_blocks = d_blocks @ d_blocks.transpose(0, 2, 1) + 0.1 * np.eye(2)
    sys_vals, _, rhs, _, _ = build_flow_system(
        dev, jnp.asarray(d_blocks), jnp.asarray(rng.normal(size=(t, 2))), jnp.asarray(3e-6))
    cols, vals, rhs = np.asarray(dev.ell_cols), np.asarray(sys_vals), np.asarray(rhs)
    pat = tb.build_band_pattern(cols, nb=64)
    ref = jb.BandedCholeskySolver(pat).factor(jnp.asarray(vals))
    x_ref = np.asarray(ref.solve(jnp.asarray(rhs)), np.float64)
    _, _, ok, panels = _port_factor(pat, vals, torch.float32)
    x32 = _port_solve(pat, panels, torch.as_tensor(rhs, dtype=torch.float32))
    assert ok and _rel(x32, x_ref) < 1e-3   # condition ~1e6 in float32
    n, w = cols.shape
    a = sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(n), w), cols.ravel())),
                      shape=(n, n))
    _, _, ok64, panels64 = _port_factor(pat, vals, torch.float64)
    x64 = _port_solve(pat, panels64, torch.as_tensor(rhs))
    assert ok64 and _rel(x64, spla.spsolve(a.tocsc(), rhs)) < 1e-8


# -- the spectrum's shift-invert solver ---------------------------------------

def _shift_invert_system(case):
    """(cols, vals) float64: a spectrum system S + sigma M (Whitney basis):
    "sphere", the octahedral sphere subdivided twice at sigma 1e-3; "torus",
    the 12x8 torus of tests/test_spectrum.py at sigma 1e-8 (nearly singular:
    its float32 factor needs a diagonal shift); or "indefinite", the
    mesh-like SPD system shifted indefinite by 1e-3 of its largest diagonal
    (a 1e-2 relative shift makes it definite again)."""
    import scipy.sparse as sp

    if case == "indefinite":
        rng = np.random.default_rng(3)
        a = _mesh_like_spd(256, rng)
        lmin = np.linalg.eigvalsh(a.toarray())[0]
        a = (a - sp.identity(256) * (lmin + 1e-3 * a.diagonal().max())).tocsr()
        return _to_ell(a)
    from meshopticalflow_tpu.config import FlowConfig
    from meshopticalflow_tpu.geometry.mesh import build_mesh
    from meshopticalflow_tpu.models.base import build_basis
    from meshopticalflow_tpu.ops.assemble import vector_field_mass_blocks
    from meshopticalflow_tpu.solvers.lanczos import _shift_invert_pack
    from tests.conftest import make_sphere_mesh
    from tests.test_spectrum import _make_torus_mesh

    tris, verts = make_sphere_mesh(2) if case == "sphere" else _make_torus_mesh()
    mesh = build_mesh(tris, vertices=verts)
    _, dev = build_basis(mesh, FlowConfig(dtype="float64"))
    pack = _shift_invert_pack(dev, jnp.asarray(vector_field_mass_blocks(mesh)),
                              1e-3 if case == "sphere" else 1e-8, inner="jacobi")
    return np.asarray(dev.ell_cols), np.asarray(pack.sys_vals)


def _csr(cols, vals):
    import scipy.sparse as sp

    n, w = cols.shape
    return sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(n), w), cols.ravel())),
                         shape=(n, n))


@pytest.mark.parametrize("case", ["sphere", "indefinite"])
def test_banded_cholesky_solver_matches_reference(case):
    """BandedCholeskySolver.factor/solve: the float32 factor (both packages'
    precision) against the reference's, with the same diagonal shift; the
    port's float64 factor against scipy (SPD case)."""
    cols, vals = _shift_invert_system(case)
    n = cols.shape[0]
    pat = tb.build_band_pattern(cols, nb=64)
    ref = jb.BandedCholeskySolver(pat).factor(jnp.asarray(vals))
    ours = tb.BandedCholeskySolver(pat).factor(torch.as_tensor(vals))
    assert ours.shift_used == ref.shift_used
    assert (ours.shift_used > 0) == (case == "indefinite")
    b = np.random.default_rng(7).normal(size=(n, 3))
    x_ref = np.asarray(ref.solve(jnp.asarray(b)))
    x = ours.solve(torch.as_tensor(b))
    assert x.dtype == torch.float64 and _rel(x.numpy(), x_ref) < F32_TOL
    if case == "sphere":
        _, _, ok64, panels64 = _port_factor(pat, vals, torch.float64)
        x64 = _port_solve(pat, panels64, torch.as_tensor(b))
        assert ok64 and _rel(x64, spla.spsolve(_csr(cols, vals).tocsc(), b)) < F64_TOL
    with pytest.raises(RuntimeError):
        tb.BandedCholeskySolver(pat).factor(torch.as_tensor(-np.abs(vals)),
                                            rel_shifts=(0.0, 1e-6))


@pytest.mark.parametrize("case", ["sphere", "torus"])
def test_bpcg_probe_trajectory_matches_reference(case):
    """The probe's ||r||^2 trajectory, each package with its own float32
    factor. Both packages' panel solves round the rhs to float32, so past
    ~1e-12 of ||b||^2 the trajectory is that rounding; above it they agree
    to 1e-5. The factor here is of A + max|A| I (the shift ladder's 1.0
    rung), a weak preconditioner, so the trajectory stays above that floor
    for a few steps."""
    cols, vals = _shift_invert_system(case)
    pat = tb.build_band_pattern(cols, nb=64)
    ref = jb.BandedCholeskySolver(pat).factor(jnp.asarray(vals), rel_shifts=(1.0,))
    ours = tb.BandedCholeskySolver(pat).factor(torch.as_tensor(vals), rel_shifts=(1.0,))
    b = np.random.default_rng(12345).normal(size=cols.shape[0])
    h_ref = np.asarray(jb.bpcg_probe(jnp.asarray(cols), jnp.asarray(vals), ref.dinv,
                                     ref.pbelow, ref.perm, ref.inv_perm, jnp.asarray(b), 12,
                                     ref.pat.n))
    h = tb.bpcg_probe(torch.as_tensor(cols), torch.as_tensor(vals), ours,
                      torch.as_tensor(b), 12).numpy()
    assert h.shape == h_ref.shape == (13,)
    live = h_ref > 1e-12 * h_ref[0]
    assert live[:4].all() and h_ref[4] < h_ref[0]
    np.testing.assert_allclose(h[live], h_ref[live], rtol=1e-5)


@pytest.mark.parametrize("multi", [False, True])
def test_ell_pcg_banded_matches_reference(multi):
    """Each package with its own float32 factor: equal iteration counts and
    solutions within 1e-10, single and multi-rhs."""
    cols, vals = _shift_invert_system("sphere")
    n = cols.shape[0]
    pat = tb.build_band_pattern(cols, nb=64)
    ref = jb.BandedCholeskySolver(pat).factor(jnp.asarray(vals))
    ours = tb.BandedCholeskySolver(pat).factor(torch.as_tensor(vals))
    rng = np.random.default_rng(11)
    b = rng.normal(size=(n, 5)) if multi else rng.normal(size=n)
    if multi:
        b[:, 4] = 0.0   # a zero column converges at once
    fn_j = jb.ell_pcg_banded_multi if multi else jb.ell_pcg_banded
    fn_t = tb.ell_pcg_banded_multi if multi else tb.ell_pcg_banded
    x_ref, st_ref = fn_j(jnp.asarray(cols), jnp.asarray(vals), ref, jnp.asarray(b), tol=1e-12)
    x, st = fn_t(torch.as_tensor(cols), torch.as_tensor(vals), ours, torch.as_tensor(b),
                 tol=1e-12)
    iters_ref = st_ref if multi else int(st_ref.iterations)
    iters = st if multi else st.iterations
    assert iters == iters_ref > 0
    assert _rel(x.numpy(), x_ref) <= 1e-10
    r = b - _csr(cols, vals) @ x.numpy()
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b)

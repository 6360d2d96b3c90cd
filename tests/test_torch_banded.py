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


# -- the plain twins of the banded kernels at the kernels' shapes ---------------

def _panels_of(n, nb, k, seed, bw_pad=None):
    """A float64 factor of a mesh-like SPD system reblocked into panels of
    k * nb, in both packages' layouts (the reference's from the same
    factor blocks)."""
    rng = np.random.default_rng(seed)
    a = _mesh_like_spd(n, rng)
    cols, vals = _to_ell(a)
    pat = tb.build_band_pattern(cols, nb=nb, bw_pad=bw_pad)
    _, l_blocks, ok, (dinv, pbelow) = _port_factor(pat, vals, torch.float64, k=k)
    assert ok
    dinv_j, pbelow_j = jb.build_solve_panels(jnp.asarray(l_blocks.numpy()), k)
    return pat, dinv, pbelow, dinv_j, pbelow_j


# (case, n, nb, k, bw_pad, c): bw > S with k capped at 8 (the window shifts by
# S a panel), c = 6 at S = 256 (the smoothing c1's), c = 32, one panel, and a
# block count that k does not divide
TWIN_CASES = {
    "bw_gt_S_k8": (1200, 32, 8, 384, 2),
    "c6_S256": (1100, 64, 4, 256, 6),
    "c32": (700, 64, 2, 128, 32),
    "mp1": (200, 64, 4, 256, 3),
    "m_not_divisible": (1000, 64, 3, 192, 1),
}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_panel_sweep_twins_match_reference_f64(case):
    n, nb, k, bw_pad, c = TWIN_CASES[case]
    pat, dinv, pbelow, dinv_j, pbelow_j = _panels_of(n, nb, k, n + c, bw_pad)
    mp, s, _ = dinv.shape
    bw = pbelow.shape[1]
    assert {"bw_gt_S_k8": bw > s and k == 8, "mp1": mp == 1,
            "m_not_divisible": pat.m % k != 0}.get(case, True)
    rhs = np.random.default_rng(c).normal(size=(mp, s, c))
    from meshopticalflow_tpu_torch.kernels import banded as kb

    y = kb.panel_lower_solve_plain(dinv, pbelow, torch.as_tensor(rhs))
    y_j = jb.panel_lower_solve(dinv_j, pbelow_j, jnp.asarray(rhs))
    assert _rel(y.numpy(), y_j) < 1e-12
    x = kb.panel_upper_solve_plain(dinv, pbelow, y)
    x_j = jb.panel_upper_solve(dinv_j, pbelow_j, y_j)
    assert _rel(x.numpy(), x_j) < 1e-12


@pytest.mark.parametrize("case", ["bw_gt_S_k8", "c6_S256", "c32"])
def test_panel_sweep_twins_match_reference_f32_and_bf16(case):
    """float32 panels and rhs, and bfloat16 panels widened into a float32
    rhs (the ``mg_c1_bf16`` path), against the reference's scans on the same
    values: JAX promotes the bfloat16 panel to float32 in the product, as
    the twin's ``_widen`` does."""
    from meshopticalflow_tpu_torch.kernels import banded as kb

    n, nb, k, bw_pad, c = TWIN_CASES[case]
    _, dinv, pbelow, _, _ = _panels_of(n, nb, k, n + c, bw_pad)
    rhs = np.random.default_rng(c).normal(size=(dinv.shape[0], dinv.shape[1], c))
    for panel_dtype, jnp_dtype in ((torch.float32, jnp.float32),
                                   (torch.bfloat16, jnp.bfloat16)):
        d_t, p_t = dinv.to(panel_dtype), pbelow.to(panel_dtype)
        d_j = jnp.asarray(d_t.float().numpy()).astype(jnp_dtype)
        p_j = jnp.asarray(p_t.float().numpy()).astype(jnp_dtype)
        r_t = torch.as_tensor(rhs, dtype=torch.float32)
        y = kb.panel_lower_solve_plain(d_t, p_t, r_t)
        y_j = jb.panel_lower_solve(d_j, p_j, jnp.asarray(rhs, jnp.float32))
        assert y.dtype == torch.float32 and _rel(y.numpy(), y_j) < F32_TOL
        x = kb.panel_upper_solve_plain(d_t, p_t, y)
        x_j = jb.panel_upper_solve(d_j, p_j, y_j)
        assert _rel(x.numpy(), x_j) < F32_TOL


@pytest.mark.parametrize("case", ["bw_gt_S_k8", "m_not_divisible"])
def test_band_cholesky_twin_matches_reference(case):
    """The factor's twin against the reference's scan (float32, its only
    precision) at a band the panel reblocking shifts by S < bw, and at a
    block count the panel width does not divide."""
    from meshopticalflow_tpu_torch.kernels import banded as kb

    n, nb, k, bw_pad, _ = TWIN_CASES[case]
    rng = np.random.default_rng(n)
    a = _mesh_like_spd(n, rng)
    cols, vals = _to_ell(a)
    pat = tb.build_band_pattern(cols, nb=nb, bw_pad=bw_pad)
    s = tb.band_revalue(torch.as_tensor(pat.slots), torch.as_tensor(vals, dtype=torch.float32),
                        pat.m, pat.nb, pat.bw, pat.n)
    l_t, ok_t = kb.band_cholesky_plain(s, 0.0, pat.nb, pat.bw)
    l_j, ok_j = jb.band_cholesky(jnp.asarray(s.numpy()), 0.0, pat.nb, pat.bw)
    assert bool(ok_t) and bool(ok_j)
    assert _rel(l_t.numpy(), np.asarray(l_j)) < F32_TOL


def test_banded_wrappers_take_the_twin_on_cpu():
    """CPU tensors run the twins and count no kernel launch (the wrappers
    route only by device)."""
    from meshopticalflow_tpu_torch.kernels import banded as kb

    n, nb, k, bw_pad, c = TWIN_CASES["c6_S256"]
    _, dinv, pbelow, _, _ = _panels_of(n, nb, k, 1, bw_pad)
    rhs = torch.as_tensor(np.random.default_rng(2).normal(size=(dinv.shape[0], dinv.shape[1], c)))
    kb.reset_counts()
    y = tb.panel_lower_solve(dinv, pbelow, rhs)
    x = tb.panel_upper_solve(dinv, pbelow, y)
    assert torch.equal(y, kb.panel_lower_solve_plain(dinv, pbelow, rhs))
    assert torch.equal(x, kb.panel_upper_solve_plain(dinv, pbelow, y))
    s = torch.zeros((3, 3 * nb, nb), dtype=torch.float64)
    s[:, torch.arange(nb), torch.arange(nb)] = 1.0
    l_blocks, ok = tb.band_cholesky(s, 0.0, nb, 2 * nb)
    assert bool(ok) and l_blocks.shape == s.shape
    assert kb.counts() == dict(panel_sweep=0, band_factor=0, by_form={}, plain_on_cuda=0)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["mixed_devices", "panel_types", "rhs_type", "c33",
                                  "noncontiguous", "not_cuda", "f32_panels_f64_rhs",
                                  "f64_panels_f32_rhs"])
def test_panel_sweep_refuses_rather_than_take_the_twin(case):
    """Operands that are not all on the CPU never reach the twin: mixed
    devices, mismatched types, a type pair banded.cu has no entry point for,
    more than 32 columns and non-contiguous operands raise before anything
    launches (meta tensors stand in for a card's)."""
    from meshopticalflow_tpu_torch.kernels import banded as kb

    dinv, pbelow, rhs = _meta(4, 64, 64), _meta(4, 128, 64), _meta(4, 64, 3)
    err = ValueError
    if case == "mixed_devices":
        pbelow = torch.zeros(4, 128, 64)
    elif case == "panel_types":
        pbelow, err = _meta(4, 128, 64, dtype=torch.float64), TypeError
    elif case == "rhs_type":
        rhs, err = _meta(4, 64, 3, dtype=torch.bfloat16), TypeError
    elif case == "c33":
        rhs = _meta(4, 64, 33)
    elif case == "f32_panels_f64_rhs":
        rhs, err = _meta(4, 64, 3, dtype=torch.float64), TypeError
    elif case == "f64_panels_f32_rhs":
        dinv, pbelow, err = (_meta(4, 64, 64, dtype=torch.float64),
                             _meta(4, 128, 64, dtype=torch.float64), TypeError)
    elif case == "noncontiguous":
        dinv = _meta(4, 64, 64).transpose(1, 2)
    kb.reset_counts()
    with pytest.raises(err):
        kb.panel_sweep(dinv, pbelow, rhs, upper=case == "c33")
    assert kb.counts()["panel_sweep"] == 0 and kb.counts()["plain_on_cuda"] == 0


@pytest.mark.parametrize("case", ["float16", "nb_above_128", "nb_64", "nb_32",
                                  "noncontiguous", "not_cuda"])
def test_band_factor_refuses_rather_than_take_the_twin(case):
    """The kernel factors blocks of 128 (every band layout the port builds):
    another block size, another type or a non-contiguous operand raises
    before anything launches."""
    from meshopticalflow_tpu_torch.kernels import banded as kb

    nb = {"nb_above_128": 256, "nb_64": 64, "nb_32": 32}.get(case, 128)
    bw = max(nb, 256)
    s, err = _meta(5, nb + bw, nb), ValueError
    if case == "float16":
        s, err = _meta(5, nb + bw, nb, dtype=torch.float16), TypeError
    elif case == "noncontiguous":
        s = _meta(5, nb, nb + bw).transpose(1, 2)
    kb.reset_counts()
    with pytest.raises(err):
        kb.band_factor(s, 0.0, nb, bw)
    assert kb.counts()["band_factor"] == 0


@pytest.mark.parametrize("c", [33, 70])
def test_band_solve_panels_splits_wide_rhs(c):
    """More right-hand sides than a sweep takes (the spectrum's purification
    solves 64): solved in column groups of MAX_COLUMNS, equal to the
    reference's sweeps over all columns at once within 1e-12 (float64)."""
    n, nb, k, bw_pad, _ = TWIN_CASES["c6_S256"]
    pat, dinv, pbelow, dinv_j, pbelow_j = _panels_of(n, nb, k, c, bw_pad)
    b = np.random.default_rng(c).normal(size=(n, c))
    x = tb.band_solve_panels(dinv, pbelow, torch.as_tensor(pat.perm),
                             torch.as_tensor(pat.inv_perm), torch.as_tensor(b), n)
    mp, s, _ = dinv.shape
    bp = np.zeros((mp * s, c))
    bp[:n] = b[pat.perm]
    y_j = jb.panel_lower_solve(dinv_j, pbelow_j, jnp.asarray(bp.reshape(mp, s, c)))
    x_j = np.asarray(jb.panel_upper_solve(dinv_j, pbelow_j, y_j)).reshape(mp * s, c)
    assert x.shape == (n, c) and _rel(x.numpy(), x_j[:n][pat.inv_perm]) < 1e-12


def _banded_cu_entries():
    import pathlib
    import re

    from meshopticalflow_tpu_torch.kernels.build import CSRC

    text = (pathlib.Path(CSRC) / "banded.cu").read_text()
    sweeps = set(re.findall(r"^BANDED_SWEEP_ENTRY\((\w+), (\w+),", text, re.M))
    factors = set(re.findall(r"^int band_factor_(\w+)\(", text, re.M))
    return sweeps, factors


_SWEEP_FORMS = [("float32", "float32"), ("float64", "float64"), ("bfloat16", "float32"),
                ("bfloat16", "float64")]


@pytest.mark.parametrize("form", [f"panel_sweep/{p}/{t}" for p, t in _SWEEP_FORMS]
                         + ["band_factor/float32", "band_factor/float64"])
def test_banded_cu_exports_each_form_the_wrapper_binds(form):
    """Each (panel, rhs) type pair the wrapper launches, and each factor type,
    has its entry point in csrc/banded.cu, and banded.cu exports no other
    (the library binds them all on the card's first load)."""
    from meshopticalflow_tpu_torch.kernels import banded as kb

    sweeps, factors = _banded_cu_entries()
    tag = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
    assert sweeps == {(tag[p], tag[t]) for p, t in kb.SWEEP_TYPES}
    assert factors == {"f32", "f64"}
    kind, *types = form.split("/")
    dts = [getattr(torch, t) for t in types]
    if kind == "panel_sweep":
        assert tuple(dts) in kb.SWEEP_TYPES and (tag[dts[0]], tag[dts[1]]) in sweeps
    else:
        assert tag[dts[0]] in factors

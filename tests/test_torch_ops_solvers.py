"""Device operators and solvers of the PyTorch port against the reference.

Same float64 inputs (made with numpy from a seed) go through the reference
package's function and the port's; results agree to 1e-12 relative (the two
sum in different orders) and the chunked PCG solves take equal iteration
counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.flow import signal as j_signal
from meshopticalflow_tpu.geometry.mesh import build_mesh as j_build_mesh
from meshopticalflow_tpu.models import base as j_base
from meshopticalflow_tpu.models.whitney import build_whitney_basis as j_whitney
from meshopticalflow_tpu.ops.dataterm import data_term_blocks as j_dataterm
from meshopticalflow_tpu.solvers import cg as j_cg
from meshopticalflow_tpu.solvers.refine import ell_solve_refined as j_refined
from meshopticalflow_tpu.utils.testing import sphere_signal_pair
from meshopticalflow_tpu_torch.flow import signal as t_signal
from meshopticalflow_tpu_torch.geometry.mesh import build_mesh as t_build_mesh
from meshopticalflow_tpu_torch.models import base as t_base
from meshopticalflow_tpu_torch.models.whitney import build_whitney_basis as t_whitney
from meshopticalflow_tpu_torch.ops.dataterm import data_term_blocks as t_dataterm
from meshopticalflow_tpu_torch.solvers import cg as t_cg
from meshopticalflow_tpu_torch.solvers.refine import ell_solve_refined as t_refined

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-12


def _close(ours, ref, rtol=RTOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ours - ref).max()) / scale
    assert err <= rtol, f"max |diff| / max |ref| = {err:.3e} > {rtol:.0e}"


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a)).to(dtype)


@pytest.fixture(scope="module")
def sphere():
    tris, verts, sig0, sig1 = sphere_signal_pair(3, angle=0.12)
    mesh_j = j_build_mesh(tris, vertices=verts)
    mesh_t = t_build_mesh(tris, vertices=verts)
    basis_j = j_base.finalize_basis(j_whitney(mesh_j), dtype=jnp.float64)
    basis_t = t_base.finalize_basis(t_whitney(mesh_t), dtype=F64)
    rng = np.random.default_rng(7)
    t_count = len(tris)
    # rank-1 blocks, like the data term's gamma gamma^T, make the level
    # systems near-singular; the regularized blocks make them well posed
    g = rng.standard_normal((t_count, 2))
    singular = np.einsum("ta,tb->tab", g, g)
    rhs_t = rng.standard_normal((t_count, 2))
    return dict(tris=tris, sig=np.concatenate([sig0, sig1], axis=1),
                mesh_j=mesh_j, mesh_t=mesh_t, basis_j=basis_j, basis_t=basis_t,
                d_blocks=singular, d_regular=singular + 0.1 * np.eye(2),
                rhs_t=rhs_t, rng=rng,
                ops_j=j_signal.make_smoothing_operators(mesh_j, jnp.float64),
                ops_t=t_signal.make_smoothing_operators(mesh_t, F64))


def test_data_term_blocks(sphere):
    rng = np.random.default_rng(1)
    v = sphere["sig"].shape[0]
    r0, r1 = rng.standard_normal((v, 3)) * 50, rng.standard_normal((v, 3)) * 50
    area = sphere["mesh_j"].area
    d_j, rhs_j = j_dataterm(jnp.asarray(sphere["tris"]), jnp.asarray(area),
                            jnp.asarray(r0), jnp.asarray(r1))
    d_t, rhs_t = t_dataterm(_t(sphere["tris"], torch.int64), _t(area), _t(r0), _t(r1))
    _close(d_t, d_j)
    _close(rhs_t, rhs_j)


def test_prolong_restrict(sphere):
    rng = np.random.default_rng(2)
    c = rng.standard_normal(sphere["basis_t"].n_coeffs)
    y = rng.standard_normal((len(sphere["tris"]), 2))
    _close(t_base.prolong(sphere["basis_t"], _t(c)),
           j_base.prolong(sphere["basis_j"], jnp.asarray(c)))
    _close(t_base.restrict(sphere["basis_t"], _t(y)),
           j_base.restrict(sphere["basis_j"], jnp.asarray(y)))


def _systems(sphere, weight=3e-6, blocks="d_blocks"):
    sys_j = j_base.build_flow_system(sphere["basis_j"], jnp.asarray(sphere[blocks]),
                                     jnp.asarray(sphere["rhs_t"]), jnp.asarray(weight))
    sys_t = t_base.build_flow_system(sphere["basis_t"], _t(sphere[blocks]),
                                     _t(sphere["rhs_t"]), torch.tensor(weight, dtype=F64))
    return sys_j, sys_t


def test_build_flow_system(sphere):
    sys_j, sys_t = _systems(sphere)
    for a, b in zip(sys_t, sys_j):      # sys_vals, dt_vals, rhs, diag, scale
        _close(a, b)


def test_finalize_flow_step(sphere):
    (_, dt_j, rhs_j, _, _), (_, dt_t, rhs_t, _, _) = _systems(sphere)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(sphere["basis_t"].n_coeffs)
    c = rng.standard_normal(sphere["basis_t"].n_coeffs)
    out_j = j_base.finalize_flow_step(sphere["basis_j"], jnp.asarray(c), jnp.asarray(x),
                                      dt_j, rhs_j)
    out_t = t_base.finalize_flow_step(sphere["basis_t"], _t(c), _t(x), dt_t, rhs_t)
    for a, b in zip(out_t, out_j):
        _close(a, b)


def test_smoothing_system(sphere):
    sys_j = j_signal._smooth_system(sphere["ops_j"], jnp.asarray(sphere["sig"]), 3e-3)
    sys_t = t_signal._smooth_system(sphere["ops_t"], _t(sphere["sig"]), 3e-3)
    for a, b in zip(sys_t, sys_j):
        _close(a, b)


@pytest.mark.parametrize("weight", [3e-3, 1e-4])
def test_smooth_signal(sphere, weight):
    x_j, st_j = j_signal.smooth_signal(sphere["ops_j"], jnp.asarray(sphere["sig"]),
                                       weight, tol=1e-7, max_iters=2000)
    x_t, st_t = t_signal.smooth_signal(sphere["ops_t"], _t(sphere["sig"]), weight,
                                       tol=1e-7, max_iters=2000)
    assert st_t.iterations == int(st_j.iterations)
    _close(x_t, x_j)


def test_dog_band(sphere):
    b_j = j_signal.dog_band(sphere["ops_j"], jnp.asarray(sphere["sig"]), 1e-4,
                            tol=1e-7, max_iters=2000)
    b_t = t_signal.dog_band(sphere["ops_t"], _t(sphere["sig"]), 1e-4,
                            tol=1e-7, max_iters=2000)
    _close(b_t, b_j)


def test_log_space():
    s = np.random.default_rng(4).uniform(0, 255, (50, 6))
    _close(t_signal.log_space(_t(s)), j_signal.log_space(jnp.asarray(s)))


# A PCG solve amplifies the last-bit differences of the two sum orders
# (which on the CPU also depend on torch's thread count) by the system's
# condition number: on the well-posed system the solutions agree to 1e-12;
# on the near-singular one (the level systems' kind) to 1e-9, and its
# recurrence residuals (~1e-10) within a factor of 2. A relative residual
# below 1e-14 is rounding noise.
SOLVE_TOL = {"d_regular": (RTOL, 1e-6), "d_blocks": (1e-9, 1.0)}


@pytest.mark.parametrize("blocks", ["d_regular", "d_blocks"])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_ell_pcg(sphere, multi, tol, blocks):
    (sv_j, _, rhs_j, dg_j, _), (sv_t, _, rhs_t, dg_t, _) = _systems(sphere, blocks=blocks)
    cols_j, cols_t = sphere["basis_j"].ell_cols, sphere["basis_t"].ell_cols
    b_np = np.asarray(rhs_j)
    if multi:
        b_np = np.stack([b_np, np.random.default_rng(5).standard_normal(b_np.shape)], 1)
    x_j, st_j = j_cg.ell_pcg(cols_j, sv_j, dg_j, jnp.asarray(b_np), tol=tol,
                             max_iters=3000, chunk=128)
    x_t, st_t = t_cg.ell_pcg(cols_t, sv_t, dg_t, _t(b_np), tol=tol,
                             max_iters=3000, chunk=128)
    x_tol, res_tol = SOLVE_TOL[blocks]
    assert st_t.iterations == int(st_j.iterations)
    assert st_t.iterations % 128 == 0
    _close(x_t, x_j, x_tol)
    assert abs(st_t.rel_residual - float(st_j.rel_residual)) <= \
        res_tol * float(st_j.rel_residual) + 1e-14


def test_pcg_multi_matches_reference(sphere):
    ops_j, ops_t = sphere["ops_j"], sphere["ops_t"]
    sys_j, b_j, d_j = j_signal._smooth_system(ops_j, jnp.asarray(sphere["sig"]), 1e-3)
    sys_t, b_t, d_t = t_signal._smooth_system(ops_t, _t(sphere["sig"]), 1e-3)
    from meshopticalflow_tpu.ops.ell import ell_matvec as j_mv
    from meshopticalflow_tpu_torch.ops.ell import ell_matvec as t_mv

    x_j, st_j = j_cg.pcg_multi(lambda v: j_mv(ops_j.cols, sys_j, v), b_j, d_j, tol=1e-9)
    x_t, st_t = t_cg.pcg_multi(lambda v: t_mv(ops_t.cols, sys_t, v), b_t, d_t, tol=1e-9)
    assert st_t.iterations == int(st_j.iterations)
    _close(x_t, x_j)
    x1_j, _ = j_cg.pcg(lambda v: j_mv(ops_j.cols, sys_j, v), b_j[:, 0], d_j, tol=1e-9)
    x1_t, _ = t_cg.pcg(lambda v: t_mv(ops_t.cols, sys_t, v), b_t[:, 0], d_t, tol=1e-9)
    _close(x1_t, x1_j)


def test_ell_solve_refined(sphere):
    (sv_j, _, rhs_j, dg_j, _), (sv_t, _, rhs_t, dg_t, _) = _systems(sphere)
    x_j, st_j = j_refined(sphere["basis_j"].ell_cols, sv_j, dg_j, rhs_j,
                          inner_tol=1e-6, inner_iters=2000)
    x_t, st_t = t_refined(sphere["basis_t"].ell_cols, sv_t, dg_t, rhs_t,
                          inner_tol=1e-6, inner_iters=2000)
    assert st_t.iterations == int(st_j.iterations)
    assert st_t.rel_residual < 1e-11
    _close(x_t, x_j)


def test_update_optical_flow(sphere):
    rng = np.random.default_rng(6)
    c = rng.standard_normal(sphere["basis_t"].n_coeffs) * 1e-3
    out_j = j_base.update_optical_flow(
        sphere["basis_j"], jnp.asarray(c), jnp.asarray(sphere["d_blocks"]),
        jnp.asarray(sphere["rhs_t"]), 3e-6, refine=True)
    out_t = t_base.update_optical_flow(
        sphere["basis_t"], _t(c), _t(sphere["d_blocks"]), _t(sphere["rhs_t"]),
        3e-6, refine=True)
    _close(out_t[0], out_j[0])
    _close(out_t[1], out_j[1])
    assert out_t[2].iterations == int(out_j[2].iterations)

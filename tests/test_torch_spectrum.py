"""The port's spectrum (solvers/lanczos.py, apps/spectrum.py) against the
reference package, in float64 on the CPU.

The spaces are those of tests/test_spectrum.py: the octahedral sphere
subdivided 1-3 times, the 12x8 torus (a two-dimensional harmonic
nullspace) and the Connection basis. The same numpy draws reach both
packages. Checks:

* ``_shift_invert_pack``: system values within 1e-12 relative, equal probed
  inner trip counts (each package factors with its own float32 Cholesky);
* ``_lanczos_host_block`` from one start block: the block tridiagonal T
  within 1e-8, the Krylov basis M-orthonormal to 1e-8;
* ``compute_spectrum`` through each of its three recurrences, against the
  same recurrence of the reference: eigenvalues within 1e-6 relative
  (harmonic pairs within 1e-7 of the spectrum's scale), fields of simple
  eigenvalues within 1e-5 after sign alignment, and the ARPACK oracle at the
  reference tests' tolerances; float32 at 2e-3 against the oracle;
* the Spectrum CLI of both packages on a written PLY, plain, with the FEM
  stiffness (--vfMode 2 --femDual 0) and with --edgeMetric: eigenvalues and
  the eigenvector-%03d.bin fields.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.geometry.mesh import build_mesh as j_build_mesh
from meshopticalflow_tpu.io.binio import read_vector
from meshopticalflow_tpu.models.base import build_basis as j_build_basis
from meshopticalflow_tpu.ops.assemble import vector_field_mass_blocks
from meshopticalflow_tpu.solvers import lanczos as jl
from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.geometry.mesh import build_mesh as t_build_mesh
from meshopticalflow_tpu_torch.models.base import build_basis as t_build_basis
from meshopticalflow_tpu_torch.solvers import lanczos as tl
from tests.conftest import make_sphere_mesh
from tests.test_spectrum import _dense_reference_spectrum, _make_torus_mesh

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# space -> (mesh, vf_mode, k, ARPACK rtol, atol)
SPACES = {
    "sphere1": (lambda: make_sphere_mesh(1), 0, 4, 1e-5, 1e-8),
    "sphere2": (lambda: make_sphere_mesh(2), 0, 6, 1e-5, 1e-8),
    "sphere3": (lambda: make_sphere_mesh(3), 0, 12, 1e-4, 1e-7),
    "torus": (_make_torus_mesh, 0, 6, 1e-5, None),
    "connection": (lambda: make_sphere_mesh(1), 2, 4, 1e-4, 1e-6),
}


def _space(name, dtype="float64"):
    make, vf_mode, k, rtol, atol = SPACES[name]
    tris, verts = make()
    mesh = j_build_mesh(tris, vertices=verts)
    host, j_basis = j_build_basis(mesh, JaxFlowConfig(vf_mode=vf_mode, dtype=dtype))
    _, t_basis = t_build_basis(t_build_mesh(tris, vertices=verts),
                               FlowConfig(vf_mode=vf_mode, dtype=dtype), "cpu")
    mass = vector_field_mass_blocks(mesh)
    return dict(host=host, mesh=mesh, j_basis=j_basis, t_basis=t_basis, k=k, rtol=rtol,
                atol=atol, j_mass=jnp.asarray(mass, dtype),
                t_mass=torch.as_tensor(mass).to(getattr(torch, dtype)))


@pytest.fixture(scope="module", params=sorted(SPACES))
def space(request):
    return dict(name=request.param, **_space(request.param))


@pytest.mark.parametrize("sigma", [1e-8, 1e-3])
def test_shift_invert_pack(space, sigma):
    """Equal trip counts where the factor needs no diagonal shift. The torus
    at sigma 1e-8 breaks down until a shift of 6.2e-4: the two packages'
    float32 factors of that nearly singular window then differ by 0.5 %,
    the probe's erratic trajectory with them, and its bucket may too (48 in
    the reference, 24 in the port)."""
    ref = jl._shift_invert_pack(space["j_basis"], space["j_mass"], sigma)
    ours = tl._shift_invert_pack(space["t_basis"], space["t_mass"], sigma)
    assert _rel(ours.sys_vals.numpy(), ref.sys_vals) <= 1e-12
    assert _rel(ours.diag.numpy(), ref.diag) <= 1e-12
    assert (ours.bsolver is None) == (ref.bsolver is None)
    if ref.bsolver is not None:
        assert ours.bsolver.shift_used == ref.bsolver.shift_used
    if ref.bsolver is None or ref.bsolver.shift_used == 0.0:
        assert ours.inner_iters == ref.inner_iters
    else:
        assert ours.inner_iters in (0, 8, 12, 16, 24, 32, 48)


@pytest.mark.parametrize("name", ["sphere2", "connection"])
def test_block_lanczos_from_one_start(name):
    sp_ = _space(name)
    pack_j = jl._shift_invert_pack(sp_["j_basis"], sp_["j_mass"], 1e-3)
    pack_t = tl._shift_invert_pack(sp_["t_basis"], sp_["t_mass"], 1e-3)
    n = sp_["host"].n_coeffs
    x0 = np.random.default_rng(3).normal(size=(n, 4))
    defl = np.zeros((2, n))
    big_v_j, t_j, cut_j = jl._lanczos_host_block(
        sp_["j_basis"], sp_["j_mass"], jnp.asarray(x0), jnp.asarray(defl), jnp.asarray(defl),
        24, pack_j, bs=4)
    big_v, t_mat, cut = tl._lanczos_host_block(
        sp_["t_basis"], sp_["t_mass"], torch.as_tensor(x0), torch.as_tensor(defl),
        torch.as_tensor(defl), 24, pack_t, bs=4)
    assert cut == cut_j
    assert np.abs(t_mat - t_j).max() <= 1e-8 * np.abs(t_j).max()
    v = big_v[:cut]
    gram = (v @ tl._mass_matvec_multi(sp_["t_basis"], sp_["t_mass"], v.T.contiguous())).numpy()
    np.testing.assert_allclose(gram, np.eye(cut), atol=1e-8)


PATHS = {"fused": dict(), "host": dict(host_stepped=True, block=1),
         "block": dict(host_stepped=True, block=4)}


def _aligned_field_error(ours, ref, lams, spectrum):
    """Largest difference of the sign-aligned fields of the eigenvalues
    ``lams`` that are simple in ``spectrum`` (which reaches past them: a
    degenerate cluster's basis is not unique)."""
    worst = 0.0
    scale = np.abs(spectrum).max()
    for i, lam in enumerate(lams):
        if np.sum(np.abs(spectrum - lam) <= 1e-6 * max(abs(lam), scale * 1e-3)) > 1:
            continue
        a, b = ours[i].ravel(), ref[i].ravel()
        sign = 1.0 if a @ b >= 0 else -1.0
        worst = max(worst, float(np.abs(sign * a - b).max() / np.abs(b).max()))
    return worst


# (space, path): every recurrence on the small spaces; the block recurrence
# (the card's) on the larger sphere and the torus. On the torus the
# reference's scalar banded recurrence misses the second harmonic field (the
# port's, whose probe picks 24 trips, finds it; see test_shift_invert_pack),
# and the Jacobi recurrence takes ~93,000 inner iterations.
CASES = [(name, path) for name in ("sphere1", "sphere2", "connection") for path in PATHS] \
    + [("sphere3", "block"), ("torus", "block")]


@pytest.mark.parametrize("name,path", CASES)
def test_compute_spectrum_matches_reference(name, path):
    space = _space(name)
    host, k = space["host"], space["k"]
    kw = dict(cg_tol=1e-12, max_lanczos=min(host.n_coeffs, 600), **PATHS[path])
    ref = jl.compute_spectrum(space["j_basis"], space["j_mass"], k, **kw)
    ours = tl.compute_spectrum(space["t_basis"], space["t_mass"], k, **kw)
    wider, _ = _dense_reference_spectrum(host, space["mesh"], k + 3)
    oracle = wider[:k]
    scale = abs(oracle[-1])
    harmonic = np.abs(oracle) < 1e-8 * scale
    np.testing.assert_allclose(ours.eigenvalues[harmonic], ref.eigenvalues[harmonic],
                               rtol=0, atol=1e-7 * scale)
    np.testing.assert_allclose(ours.eigenvalues[~harmonic], ref.eigenvalues[~harmonic],
                               rtol=1e-6)
    assert _aligned_field_error(ours.triangle_fields, np.asarray(ref.triangle_fields),
                                ours.eigenvalues, wider) <= 1e-5
    # the oracle, at tests/test_spectrum.py's tolerances
    np.testing.assert_allclose(ours.eigenvalues[harmonic], oracle[harmonic], rtol=0,
                               atol=1e-7 * scale)
    atol = space["atol"] if space["atol"] is not None else 0.0
    np.testing.assert_allclose(ours.eigenvalues[~harmonic], oracle[~harmonic],
                               rtol=space["rtol"], atol=atol)


def test_compute_spectrum_float32():
    sp_ = _space("sphere2", "float32")
    ours = tl.compute_spectrum(sp_["t_basis"], sp_["t_mass"], 6, cg_tol=1e-7,
                               max_lanczos=min(sp_["host"].n_coeffs, 400))
    oracle, _ = _dense_reference_spectrum(sp_["host"], sp_["mesh"], 6)
    np.testing.assert_allclose(ours.eigenvalues, oracle, rtol=2e-3)
    assert ours.triangle_fields.dtype == np.float32


@pytest.fixture(scope="module")
def metric_ply(tmp_path_factory):
    from meshopticalflow_tpu.io.ply import write_ply_metric
    from meshopticalflow_tpu.utils.testing import octa_sphere

    tris, verts = octa_sphere(1)
    p = verts[tris]
    sq = np.stack([((p[:, (j + 1) % 3] - p[:, (j + 2) % 3]) ** 2).sum(1) for j in range(3)],
                  axis=1)
    path = str(tmp_path_factory.mktemp("spectrum") / "metric.ply")
    write_ply_metric(path, verts, tris, sq)
    return path


@pytest.mark.parametrize("flags", [[], ["--vfMode", "2", "--femDual", "0"], ["--edgeMetric"]])
def test_spectrum_cli_matches_reference(metric_ply, tmp_path, capsys, flags):
    from meshopticalflow_tpu.apps.spectrum import main as j_main
    from meshopticalflow_tpu_torch.apps.spectrum import main as t_main

    common = ["--mesh", metric_ply, "--eigenVectors", "4", "--dtype", "float64",
              "--verbose"] + flags
    out = {}
    for tag, main, extra in (("ref", j_main, []), ("port", t_main, ["--device", "cpu"])):
        d = tmp_path / tag
        assert main(common + ["--outPrefix", str(d)] + extra) == 0
        lams = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["eigenvalues"]
        fields = [read_vector(str(d / f"eigenvector-{i:03d}.bin"), width=2)
                  for i in range(1, 5)]
        out[tag] = (np.array(lams), np.stack(fields))
    (lam_j, f_j), (lam_t, f_t) = out["ref"], out["port"]
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-6)
    assert f_t.shape == f_j.shape and np.isfinite(f_t).all()
    # the fourth pair may open a cluster the CLI cuts: only the first three
    assert _aligned_field_error(f_t[:3], f_j[:3], lam_t[:3], lam_t) <= 1e-5


def test_spectrum_cli_refuses_cuda_without_gpu_and_view(metric_ply, tmp_path, monkeypatch):
    """--device cuda without a GPU raises; --view, now ported, renders the
    fields (headless: one frame each)."""
    from meshopticalflow_tpu_torch.apps.spectrum import main as t_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_main(["--mesh", metric_ply, "--outPrefix", str(tmp_path)])
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setenv("MESHFLOW_LIVE", "0")
    view = tmp_path / "view"
    assert t_main(["--mesh", metric_ply, "--view", str(view), "--eigenVectors", "2",
                   "--outPrefix", str(tmp_path / "bins"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(view)) == ["camera.json", "eigenfield_001.png",
                                        "eigenfield_002.png"]

"""The port's multi-device modules against the JAX package.

parallel/{distributed,sharding,halo}.py, flow/fixed.py and
``flow_backend="halo"`` of meshopticalflow_tpu_torch, held to
tests/test_parallel.py and tests/test_distributed.py. The JAX side runs on
the conftest's 8 virtual CPU devices (``make_device_mesh(2)`` / ``(4)``); the
port side runs in 2 and 4 worker processes under gloo, spawned with
subprocess (``python -c`` code that imports no jax), each rendezvousing
through the environment contract of parallel/distributed.py on a free port,
with a 60 s collective timeout and a 120 s process timeout. Inputs are
made with numpy (seeded) or by the JAX package on the host and handed to
both sides as npz files.

Tolerances, float64 throughout unless named:
* the halo layout (perm, inv_perm, cols_local, block, halo) equals the
  reference's exactly, every rank's rows;
* halo products within 1e-12 of scipy (tests/test_parallel.py:196);
* halo_pcg and halo_mg_pcg: iteration counts equal to the reference's (both
  count in chunks), solutions within 1e-10 relative of the reference's; the
  replicated coarse solve's input and output equal bit for bit on every rank;
* the fixed level step: coeffs and tfield within 1e-9, the alignment error
  within 1e-9 relative (tests/test_parallel.py:35-37), at 2 and 4 ranks and
  solo;
* texel advection within 1e-12 (tests/test_parallel.py:61);
* the production runs: tfield within 1e-8, per-level alignment error within
  1e-6 (tests/test_parallel.py:82-85, 311-314), against the solo run and
  the JAX package's run on a device mesh of as many devices; under "xla"
  every rank holds only the row blocks the reference's ``pick`` splits,
  flow_iters equal the solo run's, and the replicated coarse solves read
  and return the same vectors on every rank, bit for bit;
* the three-level cycle (one column and a block of three), Jacobi-PCG and
  the refinement loop on split rows: iteration counts equal to the
  replicated solve's, solutions within 1e-10 relative (the three-level
  block's, with its dots over gathered rows, equal bit for bit), every
  rank's replicated coarse input and output equal bit for bit; the
  replicated three-level and Jacobi-PCG solves against the reference's
  with equal iteration counts, within 1e-10 relative;
* smoothing and the DoG band on split rows within 1e-10 relative of the
  reference's dog_band / smooth_signal.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.config import VectorFieldMode
from meshopticalflow_tpu.flow.fixed import flow_level_fixed as j_flow_level_fixed
from meshopticalflow_tpu.parallel import halo as j_halo
from meshopticalflow_tpu.parallel.sharding import make_device_mesh
from meshopticalflow_tpu.utils.testing import (_sphere_signals, sphere_signal_pair,
                                               synthetic_sphere_problem)
from meshopticalflow_tpu_torch import convert
from meshopticalflow_tpu_torch.config import FlowConfig, require_supported
from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline
from meshopticalflow_tpu_torch.flow.fixed import flow_level_fixed
from meshopticalflow_tpu_torch.geometry.mesh import build_mesh as t_build_mesh
from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_tracked
from meshopticalflow_tpu_torch.parallel import distributed as t_dist
from meshopticalflow_tpu_torch.parallel import halo as t_halo
from meshopticalflow_tpu_torch.parallel import sharding as t_sharding
from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup
from meshopticalflow_tpu_torch.solvers.cg import pcg, pcg_multi
from meshopticalflow_tpu_torch.utils.testing import octa_sphere

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")
CPU = torch.device("cpu")
SW, VW = 3e-3, 3e-6          # tests/test_parallel.py:25-26

# --------------------------------------------------------------------------
# The worker: one process of a gloo group. It imports torch, numpy, scipy and
# the port, never jax. argv: job, input npz, output directory.
# --------------------------------------------------------------------------

_WORKER = r"""
import json, os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
from meshopticalflow_tpu_torch.parallel import distributed as D

job, inp, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
assert "jax" not in sys.modules
assert D.maybe_init_distributed("cpu", timeout_s=60)
g = D.global_device_group("cpu")
data = dict(np.load(inp, allow_pickle=False))
res = {}

from meshopticalflow_tpu_torch.config import FlowConfig, VectorFieldMode
from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
from meshopticalflow_tpu_torch.parallel import halo as H, sharding as S

def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))

def layout(prefix, h):
    res[prefix + "perm"] = h.perm.numpy(); res[prefix + "inv_perm"] = h.inv_perm.numpy()
    res[prefix + "cols_local"] = h.cols_local.numpy(); res[prefix + "vals_p"] = h.vals_p.numpy()
    res[prefix + "diag_p"] = h.diag_p.numpy()
    res[prefix + "block_halo"] = np.array([h.block, h.halo])

def sphere_problem(cfg, group, hierarchy):
    d = {k[2:]: v for k, v in data.items() if k.startswith("h_")} if hierarchy else data
    root = (d["tris0"], d["verts0"], d["parent"], d["bary"]) if hierarchy else None
    return FlowProblem(cfg, build_mesh(d["tris"], vertices=d["verts"]), d["sig"],
                       vertices=d["verts"], vertex_colors=d["sig"], device="cpu",
                       root=root, device_group=group)

if job == "solvers":
    # the halo basis: layout, product, Jacobi halo PCG
    h = H.build_halo_ell(data["cols"], data["vals"], g)
    layout("", h)
    res["y"] = h.matvec(t(data["x"])).numpy()
    hs = H.build_halo_ell(data["cols"], data["vals_shift"], g)
    x, st = H.halo_pcg(hs, t(data["b"]), tol=1e-9, max_iters=4000)
    res["pcg_x"], res["pcg_iters"] = x.numpy(), np.array(st.iterations)
    # the production two-level cycle on a real flow system
    hm = H.build_halo_ell(data["mg_cols"], data["mg_vals"], g)
    hc = H.build_halo_coarse(hm, data["p0_idx"], data["p0_wt"], data["c1_cols"],
                             data["c1_vals"])
    seen = []
    real = H.band_solve_panels
    def record(dinv, pbelow, perm, inv_perm, b, n):
        out = real(dinv, pbelow, perm, inv_perm, b, n)
        if not seen:
            seen.append((b.clone(), out.clone()))
        return out
    H.band_solve_panels = record
    x, st = H.halo_mg_pcg(hm, hc, t(data["mg_b"]), tol=1e-9, max_iters=400, chunk=16)
    H.band_solve_panels = real
    res["mg_x"], res["mg_iters"] = x.numpy(), np.array(st.iterations)
    res["r1"], res["z1"] = seen[0][0].numpy(), seen[0][1].numpy()
    _, st = H.halo_pcg(hm, t(data["mg_b"]), tol=1e-9, max_iters=4000)
    res["mg_jac_iters"] = np.array(st.iterations)
    res["bytes_exchanged"] = np.array(hm.bytes_exchanged)
    # the fixed level step and the texel advection on the small sphere
    cfg = FlowConfig(vf_mode=VectorFieldMode.WHITNEY, dog_weight=0.0, levels=2,
                     dtype="float64", artifact_cache=False)
    prob = sphere_problem(cfg, None, False)
    fn, placed = S.sharded_level_step(g, prob.arrays, smooth_iters=16, flow_iters=16,
                                      max_steps=64)
    res["split"] = np.array(json.dumps({"smooth_ops": placed.vrows.split,
                                        "signals": placed.vrows.split,
                                        "basis": placed.frows.split}))
    res["local_rows"] = np.array([placed.smooth_ops.cols.shape[0],
                                  placed.basis.ell_cols.shape[0]])
    c, tf, e = fn(placed, prob.coeffs, prob.tfield, data["sw"], data["vw"])
    res["fixed_c"], res["fixed_t"], res["fixed_e"] = c.numpy(), tf.numpy(), e.numpy()
    colors, exhausted = S.advect_texture_sharded(
        g, prob.arrays.tm, t(data["adv_tfield"]), t(data["adv_uvs"]), t(data["adv_tex"]),
        t(data["adv_src_t"]), t(data["adv_src_p"]), 0.5, max_steps=64)
    res["adv"], res["adv_exhausted"] = colors.numpy(), np.array(exhausted)
    # the three-level cycle, Jacobi-PCG and refinement on this rank's rows
    # ("split") and on all of them ("whole", no group)
    import dataclasses
    from meshopticalflow_tpu_torch.flow import signal as SG
    from meshopticalflow_tpu_torch.solvers import cg as CG, mg3 as M3, refine as R
    from meshopticalflow_tpu_torch.solvers.twolevel import build_transfer, padded_to_csr
    cols, vals, diag = t(data["mg_cols"]), t(data["mg_vals"]), t(data["mg_diag"])
    n = cols.shape[0]
    p01 = build_transfer(padded_to_csr(data["p0_idx"], data["p0_wt"],
                                       data["c1_cols"].shape[0]), torch.float64, "cpu")
    p12 = build_transfer(padded_to_csr(data["p12_idx"], data["p12_wt"],
                                       data["a2"].shape[0]), torch.float64, "cpu")
    seen = []

    def three(rows, gathered_dots=False):
        s = M3.ThreeLevelSolver(rows.local(cols), rows.local(vals), rows.local(diag),
                                t(data["c1_cols"]), t(data["c1_vals"]), t(data["c1_diag"]),
                                p01, t(data["a2"]), p12, nu=4, rows=rows,
                                gathered_dots=gathered_dots)
        real = s.coarse
        def coarse(r1):
            out = real(r1)
            seen.append((r1.clone(), out.clone()))
            return out
        s.coarse = coarse
        return s

    def keep(key, rows, x, st):
        res[key + "_x"] = rows.full(x).numpy()
        res[key + "_iters"] = np.array(st.iterations)
        res[key + "_rel"] = np.array(st.rel_residual)

    for tag, rows in (("split", S.Rows(n, g)), ("whole", S.Rows(n))):
        res["mg_local_rows_" + tag] = np.array(rows.n_local)
        for form in ("one", "multi"):
            seen.clear()
            b = t(data["mg_b"] if form == "one" else data["mg_b3"])
            # the flow solve's form sums partial dots, the smoothing's takes
            # them over gathered rows, as the production solves do
            x, st = three(rows, form == "multi").solve(rows.local(b), tol=1e-9,
                                                       max_iters=400)
            keep(f"mg3_{form}_{tag}", rows, x, st)
            res[f"mg3_{form}_{tag}_r1"] = seen[0][0].numpy()
            res[f"mg3_{form}_{tag}_z1"] = seen[0][1].numpy()
            res[f"mg3_{form}_{tag}_calls"] = np.array(len(seen))
        b = rows.local(t(data["mg_b"]))
        x, st = CG.ell_pcg(rows.local(cols), rows.local(vals), rows.local(diag), b,
                           tol=1e-9, max_iters=4000, chunk=16, rows=rows)
        keep("pcg_" + tag, rows, x, st)
        x, st = R.ell_solve_refined(rows.local(cols), rows.local(vals), rows.local(diag), b,
                                    tol=1e-12, chunk=16, rows=rows)
        keep("refined_" + tag, rows, x, st)
        s = three(rows)
        x, st = R.refine_loop(rows.local(cols), rows.local(vals), b,
                              lambda r, tol_inner, rn2=None: s.solve(
                                  r, tol=max(1e-10, tol_inner), max_iters=120, b_norm2=rn2),
                              tol=1e-12, x0=rows.local(t(data["mg_x0"])), rows=rows)
        keep("refine_mg3_" + tag, rows, x, st)
    # smoothing and the DoG band on split vertex rows of a 576-vertex grid
    ops = SG.make_smoothing_operators(build_mesh(data["g_tris"], vertices=data["g_verts"]),
                                      torch.float64, "cpu")
    for tag, rows in (("split", S.Rows(ops.cols.shape[0], g)),
                      ("whole", S.Rows(ops.cols.shape[0]))):
        lops = dataclasses.replace(ops, **{f.name: rows.local(getattr(ops, f.name))
                                           for f in dataclasses.fields(ops)})
        sig = t(data["g_sig"])
        x, st = SG.smooth_signal(lops, sig, float(data["sw"]), tol=1e-10, max_iters=4000,
                                 rows=rows)
        keep("smooth_" + tag, rows, x, st)
        res["dog_" + tag] = rows.full(SG.dog_band(lops, sig, 1e-4, tol=1e-10, max_iters=4000,
                                                  rows=rows)).numpy()
        res["g_local_rows_" + tag] = np.array(rows.n_local)
    res["amax"] = g.all_reduce(torch.tensor([float(g.rank), -float(g.rank)]), op="max").numpy()
    res["rows_amax"] = S.Rows(2 * g.world_size, g).amax(
        torch.tensor([-3.0 * g.rank, 1.0])).numpy()

elif job == "runs":
    import hashlib
    from meshopticalflow_tpu_torch.flow import pipeline as P
    from meshopticalflow_tpu_torch.solvers import mg3 as M3
    base = dict(vf_mode=VectorFieldMode.WHITNEY, levels=3, dtype="float64",
                cg_tol=1e-10, cg_max_iters=3000, artifact_cache=False)
    runs = {"plain": (dict(dog_weight=0.0), False), "full": (dict(dog_weight=1.0), True),
            "halo": (dict(dog_weight=1.0, flow_backend="halo"), True)}
    # every replicated coarse solve's input and output, hashed in call order
    digest = [hashlib.sha1()]
    real_coarse = M3.ThreeLevelSolver.coarse
    def coarse(self, r1):
        out = real_coarse(self, r1)
        digest[0].update(r1.numpy().tobytes())
        digest[0].update(out.numpy().tobytes())
        return out
    M3.ThreeLevelSolver.coarse = coarse
    # the level trace's lanes still marching at flow_max_steps (the fixed cap
    # of the reference's sharded run), beside the compacted trace it runs
    at_cap = []
    real_trace = P.flow_field_trace_compacted
    def trace(tm, vfield, times, t0, p0, min_step, max_steps=4096, **kw):
        at_cap.append(real_trace(tm, vfield, times, t0, p0, min_step, max_steps,
                                 escalate=1)[2])
        return real_trace(tm, vfield, times, t0, p0, min_step, max_steps, **kw)
    P.flow_field_trace_compacted = trace
    for name in data["runs"].tolist():
        kw, hier = runs[name]
        digest[0] = hashlib.sha1()
        at_cap.clear()
        prob = sphere_problem(FlowConfig(**base, **kw), g, hier)
        if name == "halo":
            assert (prob.hier.flow_kind, prob.hier.smooth_kind) == ("xla", "xla")
        out = prob.run()
        a = prob.arrays
        res[name + "_backend"] = np.array(prob.config.flow_backend)
        res[name + "_tfield"] = out.tfield
        res[name + "_coeffs"] = out.coeffs
        res[name + "_align"] = np.array([m["alignment_error"] for m in out.metrics])
        res[name + "_flow_res"] = np.array([m["flow_res"] for m in out.metrics])
        for key in ("flow_iters", "smooth_iters", "trace_exhausted"):
            res[f"{name}_{key}"] = np.array([m[key] for m in out.metrics])
        res[name + "_at_cap"] = np.array(at_cap)
        res[name + "_coarse"] = np.array(digest[0].hexdigest())
        ops, basis = a.smooth_ops, a.basis
        res[name + "_split_rows"] = np.array([
            ops.cols.shape[0], ops.mass_vals.shape[0], ops.stiff_vals.shape[0],
            ops.diag_slot.shape[0], ops.lumped.shape[0], a.signals.shape[0],
            basis.ell_cols.shape[0], basis.s_vals.shape[0], basis.diag_slot.shape[0]])
        res[name + "_whole_rows"] = np.array([
            basis.p_idx.shape[0], basis.p_wt.shape[0], basis.dt_slots.shape[0],
            a.tm.triangles.shape[0], a.area.shape[0], prob.coeffs.shape[0],
            prob.tfield.shape[0]])

elif job == "cli":
    from meshopticalflow_tpu_torch.apps.optical_flow import main
    main(list(data["argv"]))

elif job == "contract":
    # a cross-rank reduction: local shards carry 1 + rank
    x = torch.full((2,), 1.0 + g.rank, dtype=torch.float64)
    res["total"] = g.all_reduce(x.sum().reshape(1)).numpy()
    res["gathered"] = g.all_gather_rows(x).numpy()
    h = H.build_halo_ell(data["cols"], t(data["vals"]).float(), g)
    x, st = H.halo_pcg(h, t(data["b"]).float(), tol=1e-6, max_iters=512)
    res["x"], res["rel"] = x.numpy(), np.array(st.rel_residual)

res["world"] = np.array([g.rank, g.world_size])
np.savez(os.path.join(out_dir, f"rank{g.rank}.npz"), **res)
print("WORKER_OK", g.rank, g.world_size, flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(job: str, world: int, inputs: dict, tmp_path, torchrun_env: bool = False,
           cwd=None):
    """Run the worker ``job`` in ``world`` processes; returns every rank's
    results (dicts of numpy arrays), rank order."""
    work = tmp_path / f"{job}_{world}"
    work.mkdir()
    inp = str(work / "in.npz")
    np.savez(inp, **inputs)
    port = _free_port()
    code = _WORKER % {"repo": REPO}
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("MESHFLOW_", "MASTER_", "WORLD_SIZE", "RANK",
                                    "LOCAL_RANK"))}
        env["MESHFLOW_CACHE"] = str(work / "artifacts")
        if torchrun_env:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
        else:
            env.update(MESHFLOW_COORDINATOR=f"127.0.0.1:{port}",
                       MESHFLOW_NUM_PROCESSES=str(world), MESHFLOW_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, job, inp, str(work)], env=env, cwd=cwd or str(work),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {rank}:\n{err[-3000:]}"
            assert f"WORKER_OK {rank} {world}" in out
            outs.append(dict(np.load(work / f"rank{rank}.npz")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# --------------------------------------------------------------------------
# Inputs, made once per module
# --------------------------------------------------------------------------

def _sphere_inputs(hierarchy: bool):
    """The synthetic sphere of utils/testing.synthetic_sphere_problem
    (subdiv 2) as numpy: its mesh, signals and, with ``hierarchy``, the root
    and the subdivision's parents."""
    if not hierarchy:
        tris, verts, s0, s1 = sphere_signal_pair(2)
        return dict(tris=tris, verts=verts, sig=np.stack([s0, s1]))
    tris0, verts0 = octa_sphere(2)
    e0 = verts0[tris0[:, 0]] - verts0[tris0[:, 1]]
    edge_len = 0.6 * float(np.median(np.linalg.norm(e0, axis=1)))
    tris, verts, _, parent, bary = subdivide_tracked(
        tris0, verts0, np.zeros((len(tris0), 3, 2)), edge_len)
    return dict(tris=tris, verts=verts, sig=np.stack(_sphere_signals(verts, 0.12)),
                tris0=tris0, verts0=verts0, parent=parent, bary=bary)


@pytest.fixture(scope="module")
def halo_system():
    """tests/test_parallel.py's halo basis (sphere 5, Whitney, f64) and
    production flow system (sphere 3 with the hierarchy, its first level)."""
    from meshopticalflow_tpu.flow.pipeline import _stage_resample, _stage_smooth
    from meshopticalflow_tpu.geometry.mesh import build_mesh
    from meshopticalflow_tpu.models.base import (build_basis, build_flow_system,
                                                 coarse_system_vals, patch_system_dense)
    from meshopticalflow_tpu.solvers.cg import ell_pcg as j_ell_pcg
    from meshopticalflow_tpu.solvers.mg3 import ThreeLevelSolver as JaxThreeLevel

    tris, verts, _, _ = sphere_signal_pair(5)
    _, basis = build_basis(build_mesh(tris, vertices=verts), JaxFlowConfig(dtype="float64"))
    cols = np.asarray(basis.ell_cols)
    vals = np.asarray(basis.s_vals, np.float64) + 0.0
    vals_shift = vals.copy()
    vals_shift[np.arange(cols.shape[0]), np.asarray(basis.diag_slot)] += 1e-2

    cfg = JaxFlowConfig(dog_weight=0.0, levels=2, dtype="float64")
    prob = synthetic_sphere_problem(cfg, subdiv=3, hierarchy=True)
    arrays = prob.arrays
    smoothed, _ = _stage_smooth(arrays, jnp.asarray(cfg.scalar_smooth_weight, jnp.float64),
                                cfg, prob.vcoarse, prob.vpatch)
    d_blocks, rhs_t, _, _, _ = _stage_resample(arrays, prob.tfield, smoothed, cfg)
    lam = cfg.resolved_vf_smooth_weight()
    sys_vals, _, rhs, fdiag, scale = build_flow_system(arrays.basis, d_blocks, rhs_t,
                                                       jnp.asarray(lam, jnp.float64))
    cs, patch = prob.coarse, prob.patch
    c_vals, c_diag = coarse_system_vals(cs.coarse_dev, d_blocks, jnp.asarray(scale),
                                        jnp.asarray(lam))
    a2 = patch_system_dense(patch.q2_idx, patch.q2_wt, d_blocks, scale, lam, patch.s2_dense)
    rng = np.random.default_rng(0)
    mg_b = np.asarray(rhs, np.float64)
    extra = np.random.default_rng(2).normal(size=(mg_b.shape[0], 2))
    mg_b3 = np.concatenate([mg_b[:, None], extra * np.abs(mg_b).max()], axis=1)
    # the reference's whole-row solves of that system: the three-level cycle
    # (one column and three) and Jacobi-PCG, as the "solvers" job runs them
    j3 = JaxThreeLevel(arrays.basis.ell_cols, sys_vals, fdiag, cs.coarse_dev.ell_cols,
                       c_vals, cs.p0_idx, cs.p0_wt, a2, patch.p12_idx, patch.p12_wt, nu=4)
    refs = {}
    for form, b in (("one", mg_b), ("multi", mg_b3)):
        x, st = j3.solve(jnp.asarray(b), tol=1e-9, max_iters=400)
        refs[f"ref_mg3_{form}"] = (np.asarray(x), int(st.iterations))
    x, st = j_ell_pcg(arrays.basis.ell_cols, sys_vals, fdiag, jnp.asarray(mg_b), tol=1e-9,
                      max_iters=4000, chunk=16)
    refs["ref_ell_pcg"] = (np.asarray(x), int(st.iterations))
    return dict(cols=cols, vals=vals, vals_shift=vals_shift,
                x=rng.normal(size=cols.shape[0]),
                b=np.random.default_rng(1).normal(size=cols.shape[0]),
                mg_cols=np.asarray(arrays.basis.ell_cols),
                mg_vals=np.asarray(sys_vals, np.float64), mg_b=mg_b,
                mg_diag=np.asarray(fdiag, np.float64),
                mg_b3=mg_b3,
                p0_idx=np.asarray(cs.p0_idx), p0_wt=np.asarray(cs.p0_wt, np.float64),
                c1_cols=np.asarray(cs.coarse_dev.ell_cols),
                c1_vals=np.asarray(c_vals, np.float64), c1_diag=np.asarray(c_diag, np.float64),
                a2=np.asarray(a2, np.float64), p12_idx=np.asarray(patch.p12_idx),
                p12_wt=np.asarray(patch.p12_wt, np.float64), **refs)


def _grid_inputs(n: int = 24):
    """An n x n vertex grid over a curved patch (an open mesh whose 576
    vertices divide 2 and 4 ranks) with a seeded six-column signal."""
    x, y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    verts = np.stack([x.ravel(), y.ravel(), 0.1 * np.sin(3 * x.ravel()) * np.cos(2 * y.ravel())],
                     axis=1)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = (idx[:-1, :-1].ravel(), idx[1:, :-1].ravel(), idx[:-1, 1:].ravel(),
                  idx[1:, 1:].ravel())
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)]).astype(np.int32)
    return dict(g_tris=tris, g_verts=verts,
                g_sig=np.random.default_rng(4).uniform(0, 255, (n * n, 6)))


@pytest.fixture(scope="module")
def grid_signal():
    """The grid's inputs and the reference's smooth_signal (weight SW) and
    dog_band (dogSmooth 1e-4) of its signal, float64."""
    from meshopticalflow_tpu.flow.signal import (dog_band, make_smoothing_operators,
                                                 smooth_signal)
    from meshopticalflow_tpu.geometry.mesh import build_mesh

    g = _grid_inputs()
    ops = make_smoothing_operators(build_mesh(g["g_tris"], vertices=g["g_verts"]), jnp.float64)
    sig = jnp.asarray(g["g_sig"])
    smoothed, st = smooth_signal(ops, sig, SW, tol=1e-10, max_iters=4000)
    ref = dict(smooth=np.asarray(smoothed), smooth_iters=int(st.iterations),
               dog=np.asarray(dog_band(ops, sig, 1e-4, tol=1e-10, max_iters=4000)))
    return g, ref


def _advection_inputs(t_count: int):
    """tests/test_parallel.py:40-57's lanes, one more than 3 T so that the
    port pads them to the world size itself."""
    rng = np.random.default_rng(0)
    lanes = 3 * t_count + 1
    src_t = np.concatenate([np.tile(np.arange(t_count, dtype=np.int64), 3), [-1]])
    return dict(adv_src_t=src_t, adv_src_p=rng.uniform(0.1, 0.4, (lanes, 2)),
                adv_uvs=rng.uniform(0, 1, (t_count, 3, 2)),
                adv_tex=rng.uniform(0, 255, (32, 32, 3)),
                adv_tfield=rng.normal(size=(t_count, 2)) * 0.05)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def solvers(request, halo_system, grid_signal, tmp_path_factory):
    """The "solvers" job at 2 and 4 ranks and the reference's results on a
    device mesh of the same size."""
    import scipy.sparse.linalg as spla

    world = request.param
    small = _sphere_inputs(False)
    adv = _advection_inputs(len(small["tris"]))
    n, w = halo_system["mg_cols"].shape
    a = sp.csc_matrix((halo_system["mg_vals"].ravel(), (np.repeat(np.arange(n), w),
                                                        halo_system["mg_cols"].ravel())),
                      shape=(n, n))
    # a warm start that refinement accepts: half the solution
    x0 = 0.5 * spla.spsolve(a, halo_system["mg_b"])
    system = {k: v for k, v in halo_system.items() if not k.startswith("ref_")}
    inputs = dict(system, **small, **adv, **grid_signal[0], mg_x0=x0, sw=np.array(SW),
                  vw=np.array(VW))
    outs = _spawn("solvers", world, inputs, tmp_path_factory.mktemp("solvers"))

    mesh = make_device_mesh(world)
    ref = {}
    h = j_halo.build_halo_ell(halo_system["cols"], jnp.asarray(halo_system["vals"]), mesh)
    ref["layout"] = h
    ref["y"] = np.asarray(h.matvec(jnp.asarray(halo_system["x"])))
    hs = j_halo.build_halo_ell(halo_system["cols"], jnp.asarray(halo_system["vals_shift"]),
                               mesh)
    x, st = j_halo.halo_pcg(hs, jnp.asarray(halo_system["b"]), tol=1e-9, max_iters=4000)
    ref["pcg"] = (np.asarray(x), int(st.iterations))
    hm = j_halo.build_halo_ell(halo_system["mg_cols"], jnp.asarray(halo_system["mg_vals"]),
                               mesh)
    hc = j_halo.build_halo_coarse(hm, halo_system["p0_idx"], halo_system["p0_wt"],
                                  halo_system["c1_cols"], halo_system["c1_vals"])
    x, st = j_halo.halo_mg_pcg(hm, hc, jnp.asarray(halo_system["mg_b"]), tol=1e-9,
                               max_iters=400, chunk=16)
    ref["mg"] = (np.asarray(x), int(st.iterations))
    ref.update(grid_signal[1])
    ref.update({k[4:]: v for k, v in halo_system.items() if k.startswith("ref_")})
    return dict(world=world, outs=outs, ref=ref, inputs=inputs)


# --------------------------------------------------------------------------
# In-process cases
# --------------------------------------------------------------------------

def test_all_reduce_refuses_an_unknown_op():
    """DeviceGroup.all_reduce takes "sum" (the default) and "max" only."""
    g = DeviceGroup(None, 0, 1, CPU)
    x = torch.tensor([1.0, -2.0])
    assert g.all_reduce(x.clone(), op="max").equal(x)
    with pytest.raises(ValueError, match="reduction"):
        g.all_reduce(x, op="min")


@pytest.mark.parametrize("n", [66, 642, 1920])
def test_rows_follow_the_pick_rule(n):
    """Rows split ``n`` into equal contiguous blocks when it divides the
    world size (the reference's ``pick``) and two or more ranks run; else
    every rank holds all rows and nothing is gathered or reduced."""
    t = torch.arange(float(n))
    for world in (1, 2, 4):
        for rank in range(world):
            rows = t_sharding.Rows(n, DeviceGroup(None, rank, world, CPU))
            if world > 1 and n % world == 0:
                b = n // world
                assert rows.split and rows.n_local == b
                assert rows.local(t).equal(t[rank * b:(rank + 1) * b])
            else:
                assert not rows.split and rows.group is None and rows.n_local == n
                assert rows.local(t) is t and rows.full(t) is t
                assert rows.dot(t, t) == torch.sum(t * t) and rows.amax(-t) == n - 1


def test_place_problem_at_world_one_is_the_identity(small_sphere):
    """At world size 1 place_problem keeps every tensor as it is."""
    _, arrays = small_sphere
    placed = t_sharding.place_problem(DeviceGroup(None, 0, 1, CPU), arrays)
    assert not placed.vrows.split and not placed.frows.split
    for f in ("cols", "mass_vals", "stiff_vals", "diag_slot", "lumped"):
        assert getattr(placed.smooth_ops, f) is getattr(arrays.smooth_ops, f)
    for f in ("ell_cols", "s_vals", "diag_slot"):
        assert getattr(placed.basis, f) is getattr(arrays.basis, f)
    assert placed.signals is arrays.signals


def test_distributed_init_noop_without_coordinator(monkeypatch):
    """maybe_init_distributed is a no-op without the environment contract,
    and the group helper still gives world size 1 (tests/test_parallel.py:118)."""
    for var in ("MESHFLOW_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert t_dist.maybe_init_distributed("cpu") is False
    g = t_dist.global_device_group("cpu")
    assert (g.group, g.rank, g.world_size, g.device) == (None, 0, 1, CPU)
    x = torch.arange(3.0)
    assert g.all_reduce(x.clone()).equal(x) and g.all_gather_rows(x) is x


def test_pcg_without_group_is_unchanged():
    """A world-size-1 group sums nothing: pcg and pcg_multi give the same
    numbers, bit for bit, with and without it."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 40))
    a = torch.as_tensor(a @ a.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.normal(size=(40, 3)))
    g = DeviceGroup(None, 0, 1, CPU)
    diag = torch.diagonal(a)
    x1, s1 = pcg_multi(lambda v: a @ v, b, diag, tol=1e-12, max_iters=30)
    rows = t_sharding.Rows(len(b), g)
    x2, s2 = pcg_multi(lambda v: a @ v, b, diag, tol=1e-12, max_iters=30, rows=rows)
    assert torch.equal(x1, x2) and s1 == s2
    y1, _ = pcg(lambda v: a @ v, b[:, 0], diag, tol=1e-12, max_iters=30)
    y2, _ = pcg(lambda v: a @ v, b[:, 0], diag, tol=1e-12, max_iters=30, rows=rows)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_halo_layout_matches_reference_every_rank(halo_system, world):
    """The host layout of every rank equals the reference's rows exactly
    (built here for each rank in turn; the layout needs no exchange)."""
    cols, vals = halo_system["cols"], halo_system["vals"]
    ref = j_halo.build_halo_ell(cols, jnp.asarray(vals), make_device_mesh(world))
    assert ref.halo < ref.block
    width = ref.block + 2 * ref.halo
    for rank in range(world):
        h = t_halo.build_halo_ell(cols, vals, DeviceGroup(None, rank, world, CPU))
        rows = slice(rank * h.block, (rank + 1) * h.block)
        assert (h.n, h.block, h.halo) == (ref.n, ref.block, ref.halo)
        np.testing.assert_array_equal(h.perm.numpy(), np.asarray(ref.perm))
        np.testing.assert_array_equal(h.inv_perm.numpy(), np.asarray(ref.inv_perm))
        ref_cols = np.asarray(ref.cols_local)[rows]
        assert ref_cols.min() >= 0 and ref_cols.max() < width     # the clip is a no-op
        np.testing.assert_array_equal(h.cols_local.numpy(), ref_cols)
        np.testing.assert_array_equal(h.vals_p.numpy(), np.asarray(ref.vals_p)[rows])
        np.testing.assert_array_equal(h.diag_p.numpy(), np.asarray(ref.diag_p)[rows])


def test_halo_refuses_a_semiband_wider_than_a_block(halo_system):
    """The reference's ValueError (parallel/halo.py:130-133): a block of rows
    narrower than the RCM semiband cannot take its halo from its neighbours."""
    cols, vals = halo_system["cols"], halo_system["vals"]
    world = cols.shape[0] // 8
    with pytest.raises(ValueError, match="semiband"):
        j_halo.build_halo_ell(cols, jnp.asarray(vals), make_device_mesh(8),
                              perm=np.arange(cols.shape[0])[::-1].copy())
    with pytest.raises(ValueError, match="semiband"):
        t_halo.build_halo_ell(cols, vals, DeviceGroup(None, 0, world, CPU))


def test_halo_from_reference_layout_solves_alike(halo_system):
    """convert.halo_from_reference feeds the reference's layout to the port's
    solver: the same iterations and solution as the port's own layout, and
    the reference's halo_pcg on one device."""
    cols, vals, b = halo_system["cols"], halo_system["vals_shift"], halo_system["b"]
    ref = j_halo.build_halo_ell(cols, jnp.asarray(vals), make_device_mesh(1))
    h = convert.halo_from_reference(np.asarray(ref.perm), np.asarray(ref.inv_perm),
                                    np.asarray(ref.cols_local), np.asarray(ref.vals_p),
                                    np.asarray(ref.diag_p), ref.n, ref.block, ref.halo)
    own = t_halo.build_halo_ell(cols, vals, DeviceGroup(None, 0, 1, CPU))
    x1, s1 = t_halo.halo_pcg(h, torch.as_tensor(b), tol=1e-9, max_iters=4000)
    x2, s2 = t_halo.halo_pcg(own, torch.as_tensor(b), tol=1e-9, max_iters=4000)
    xr, sr = j_halo.halo_pcg(ref, jnp.asarray(b), tol=1e-9, max_iters=4000)
    assert s1.iterations == s2.iterations == int(sr.iterations)
    assert torch.equal(x1, x2)
    assert _rel(x1.numpy(), np.asarray(xr)) <= 1e-10


@pytest.fixture(scope="module")
def small_sphere():
    """The reference's synthetic sphere problem (tests/test_parallel.py:14-18)
    and its state carried into the port (meshopticalflow_tpu_torch.convert)."""
    cfg = JaxFlowConfig(vf_mode=VectorFieldMode.WHITNEY, dog_weight=0.0, levels=2,
                        dtype="float64")
    jp = synthetic_sphere_problem(cfg, subdiv=2)
    return jp, convert.problem_arrays(jp.arrays, torch.float64, "cpu")


def test_flow_level_fixed_matches_reference(small_sphere):
    """The port's fixed-iteration level step (no group) against the
    reference's, one device each, from the same state."""
    jp, arrays = small_sphere
    c1, t1, e1 = j_flow_level_fixed(jp.arrays, jp.coeffs, jp.tfield, jnp.asarray(SW),
                                    jnp.asarray(VW), smooth_iters=16, flow_iters=16,
                                    max_steps=64)
    c, t, e = flow_level_fixed(arrays, torch.zeros(arrays.basis.n_coeffs, dtype=torch.float64),
                               torch.zeros((arrays.tm.n_triangles, 2), dtype=torch.float64),
                               SW, VW, smooth_iters=16, flow_iters=16, max_steps=64)
    assert np.abs(np.asarray(t1)).max() > 0
    np.testing.assert_allclose(c.numpy(), np.asarray(c1), atol=1e-9)
    np.testing.assert_allclose(t.numpy(), np.asarray(t1), atol=1e-9)
    np.testing.assert_allclose(float(e), float(e1), rtol=1e-9)


def test_require_supported_accepts_halo():
    require_supported(FlowConfig(flow_backend="halo"))
    with pytest.raises(NotImplementedError):
        require_supported(FlowConfig(flow_backend="tiles"))


def _port_sphere(cfg, hierarchy: bool, group=None):
    d = _sphere_inputs(hierarchy)
    root = (d["tris0"], d["verts0"], d["parent"], d["bary"]) if hierarchy else None
    return t_pipeline.FlowProblem(cfg, t_build_mesh(d["tris"], vertices=d["verts"]), d["sig"],
                                  vertices=d["verts"], vertex_colors=d["sig"], device="cpu",
                                  root=root, device_group=group)


def test_mf_backend_under_device_group_raises():
    """flow_backend="mf" is single-device only: a problem under a group
    refuses, pointing at the halo backend (tests/test_parallel.py:317)."""
    cfg = FlowConfig(levels=2, dog_weight=0.0, artifact_cache=False, flow_backend="mf")
    with pytest.raises(ValueError, match="halo"):
        _port_sphere(cfg, True, DeviceGroup(None, 0, 1, CPU))


def test_halo_backend_without_group_is_the_three_level_cycle():
    """Without a group "halo" runs what the reference runs without a device
    mesh (models/base.py:374 needs both): the three-level cycles, the same
    numbers as flow_backend="xla"."""
    kw = dict(levels=2, dtype="float64", artifact_cache=False)
    halo = _port_sphere(FlowConfig(flow_backend="halo", **kw), True)
    xla = _port_sphere(FlowConfig(flow_backend="xla", **kw), True)
    assert (halo.hier.flow_kind, halo.hier.smooth_kind) == ("xla", "xla")
    r1, r2 = halo.run(), xla.run()
    np.testing.assert_array_equal(r1.tfield, r2.tfield)
    assert [m["flow_iters"] for m in r1.metrics] == [m["flow_iters"] for m in r2.metrics]


@pytest.mark.parametrize("name", ["plain", "full"])
def test_xla_under_world_one_group_is_the_solo_run(name):
    """Under a world-size-1 group nothing is split and every helper is the
    identity: the "xla" run equals the solo run bit for bit."""
    kw, hier = RUNS[name]
    cfg = FlowConfig(**RUN_KW, **dict(kw, flow_backend="xla"))
    grouped = _port_sphere(cfg, hier, DeviceGroup(None, 0, 1, CPU))
    assert not grouped.arrays.vrows.split and not grouped.arrays.frows.split
    r1, r2 = grouped.run(), _port_sphere(cfg, hier).run()
    np.testing.assert_array_equal(r1.tfield, r2.tfield)
    np.testing.assert_array_equal(r1.coeffs, r2.coeffs)
    for a, b in zip(r1.metrics, r2.metrics):
        for k in ("alignment_error", "flow_iters", "smooth_iters", "flow_res"):
            assert a[k] == b[k]


def test_world_one_group_runs_the_halo_solver():
    """flow_backend="halo" under a world-size-1 group (the one-card case):
    the halo solver runs with the (0 -> 0) pairs, and its trajectory is the
    solo run's to the production tolerances."""
    kw = dict(vf_mode=VectorFieldMode.WHITNEY, levels=3, dtype="float64", dog_weight=1.0,
              cg_tol=1e-10, cg_max_iters=3000, artifact_cache=False)
    g = DeviceGroup(None, 0, 1, CPU)
    halo = _port_sphere(FlowConfig(flow_backend="halo", **kw), True, g)
    t_halo._FLOW_HALO_CACHE.clear()
    res = halo.run()
    assert halo.config.flow_backend == "halo"
    assert len(t_halo._FLOW_HALO_CACHE) == 1        # one layout, revalued per level
    assert all(m["flow_res"] < 1e-6 for m in res.metrics)
    solo = _port_sphere(FlowConfig(**kw), True).run()
    np.testing.assert_allclose(res.tfield, solo.tfield, atol=1e-8)
    for a, b in zip(solo.metrics, res.metrics):
        assert abs(a["alignment_error"] - b["alignment_error"]) < 1e-6


# --------------------------------------------------------------------------
# Multi-process cases
# --------------------------------------------------------------------------

def test_halo_layout_in_ranks_matches_reference(solvers):
    ref = solvers["ref"]["layout"]
    for rank, out in enumerate(solvers["outs"]):
        rows = slice(rank * ref.block, (rank + 1) * ref.block)
        assert out["world"].tolist() == [rank, solvers["world"]]
        assert out["block_halo"].tolist() == [ref.block, ref.halo]
        np.testing.assert_array_equal(out["perm"], np.asarray(ref.perm))
        np.testing.assert_array_equal(out["inv_perm"], np.asarray(ref.inv_perm))
        np.testing.assert_array_equal(out["cols_local"], np.asarray(ref.cols_local)[rows])
        np.testing.assert_array_equal(out["vals_p"], np.asarray(ref.vals_p)[rows])


def test_halo_matvec_matches_dense(solvers):
    """tests/test_parallel.py:176 at 2 and 4 ranks: every rank's product
    equals scipy's and the reference's."""
    inp = solvers["inputs"]
    n, w = inp["cols"].shape
    a = sp.csr_matrix((inp["vals"].ravel(), (np.repeat(np.arange(n), w),
                                             inp["cols"].ravel())), shape=(n, n))
    for out in solvers["outs"]:
        np.testing.assert_allclose(out["y"], a @ inp["x"], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out["y"], solvers["ref"]["y"], rtol=1e-12, atol=1e-12)


def test_halo_pcg_matches_reference(solvers):
    """tests/test_parallel.py:199: the Jacobi halo PCG solves the shifted
    system, in the reference's iterations, to its solution."""
    inp = solvers["inputs"]
    x_ref, it_ref = solvers["ref"]["pcg"]
    n, w = inp["cols"].shape
    a = sp.csr_matrix((inp["vals_shift"].ravel(), (np.repeat(np.arange(n), w),
                                                   inp["cols"].ravel())), shape=(n, n))
    for out in solvers["outs"]:
        assert int(out["pcg_iters"]) == it_ref
        assert _rel(out["pcg_x"], x_ref) <= 1e-10
        res = np.linalg.norm(a @ out["pcg_x"] - inp["b"]) / np.linalg.norm(inp["b"])
        assert res < 1e-7
    np.testing.assert_array_equal(solvers["outs"][0]["pcg_x"], solvers["outs"][-1]["pcg_x"])


def test_halo_mg_pcg_matches_reference(solvers):
    """tests/test_parallel.py:224: the production two-level cycle on the halo
    layout solves to tolerance, in the reference's iterations, matches
    scipy's direct solution, and takes a third of Jacobi's iterations or
    fewer; every rank's replicated coarse solve reads and returns the same
    vectors, bit for bit."""
    import scipy.sparse.linalg as spla

    inp = solvers["inputs"]
    x_ref, it_ref = solvers["ref"]["mg"]
    n, w = inp["mg_cols"].shape
    a = sp.csr_matrix((inp["mg_vals"].ravel(), (np.repeat(np.arange(n), w),
                                                inp["mg_cols"].ravel())), shape=(n, n))
    x_direct = spla.spsolve(a.tocsc(), inp["mg_b"])
    outs = solvers["outs"]
    for out in outs:
        assert int(out["mg_iters"]) == it_ref
        assert _rel(out["mg_x"], x_ref) <= 1e-10
        res = np.linalg.norm(a @ out["mg_x"] - inp["mg_b"]) / np.linalg.norm(inp["mg_b"])
        assert res < 1e-7
        err = np.linalg.norm(out["mg_x"] - x_direct) / np.linalg.norm(x_direct)
        assert err < 1e-6
        assert int(out["mg_iters"]) * 3 <= int(out["mg_jac_iters"])
        np.testing.assert_array_equal(out["r1"], outs[0]["r1"])
        np.testing.assert_array_equal(out["z1"], outs[0]["z1"])
        assert int(out["bytes_exchanged"]) > 0


def test_sharded_level_step_matches_single_device(solvers, small_sphere):
    """tests/test_parallel.py:21 at 2 and 4 ranks: the split level step
    equals the reference's single-device step, every output replicated."""
    jp, _ = small_sphere
    c1, t1, e1 = j_flow_level_fixed(jp.arrays, jp.coeffs, jp.tfield, jnp.asarray(SW),
                                    jnp.asarray(VW), smooth_iters=16, flow_iters=16,
                                    max_steps=64)
    world = solvers["world"]
    for out in solvers["outs"]:
        split = json.loads(str(out["split"]))
        v, n = jp.arrays.signals.shape[0], int(jp.arrays.basis.n_coeffs)
        assert split == {"smooth_ops": v % world == 0, "signals": v % world == 0,
                         "basis": n % world == 0}
        assert out["local_rows"].tolist() == [v // world if split["smooth_ops"] else v,
                                              n // world if split["basis"] else n]
        np.testing.assert_allclose(out["fixed_c"], np.asarray(c1), atol=1e-9)
        np.testing.assert_allclose(out["fixed_t"], np.asarray(t1), atol=1e-9)
        np.testing.assert_allclose(float(out["fixed_e"]), float(e1), rtol=1e-9)


def test_sharded_texel_advection_matches(solvers, small_sphere):
    """tests/test_parallel.py:40 at 2 and 4 ranks, with a lane count that
    does not divide the world size: the gathered colours equal the
    reference's single-device advection."""
    from meshopticalflow_tpu.kernels.advect import advect_texture

    jp, _ = small_sphere
    inp = solvers["inputs"]
    lanes = len(inp["adv_src_t"])
    ref = advect_texture(jp.arrays.tm, jnp.asarray(inp["adv_tfield"]),
                         jnp.asarray(inp["adv_uvs"]), jnp.asarray(inp["adv_tex"]),
                         jnp.asarray(inp["adv_src_t"], jnp.int32),
                         jnp.asarray(inp["adv_src_p"]), jnp.asarray(0.5), 1e-2, 64)
    for out in solvers["outs"]:
        assert out["adv"].shape == (lanes, 3)
        assert int(out["adv_exhausted"]) == 0
        np.testing.assert_allclose(out["adv"], np.asarray(ref), atol=1e-12)


def _same_on_every_rank(outs, *keys):
    for key in keys:
        for out in outs[1:]:
            np.testing.assert_array_equal(out[key], outs[0][key])


@pytest.mark.parametrize("form", ["one", "multi"])
def test_three_level_solver_split_matches_replicated(solvers, form):
    """solvers/mg3.py's cycle on this rank's fine rows, one column (the flow
    solve's form: partial dots summed over the ranks) and a block of three
    (the smoothing solve's form: dots over the gathered rows, so equal to
    the replicated solve bit for bit): the replicated solve's iteration
    count and its solution within 1e-10 relative, and the replicated coarse
    half reading and returning the same vectors on every rank, bit for bit,
    as often as the replicated solve calls it. The replicated solve holds
    the reference's iteration count and its solution within 1e-10."""
    world, outs = solvers["world"], solvers["outs"]
    n = solvers["inputs"]["mg_cols"].shape[0]
    x_ref, it_ref = solvers["ref"]["mg3_" + form]
    k = f"mg3_{form}_"
    for out in outs:
        assert int(out["mg_local_rows_split"]) == n // world
        assert int(out["mg_local_rows_whole"]) == n
        assert int(out[k + "split_iters"]) == int(out[k + "whole_iters"]) == it_ref > 0
        assert int(out[k + "split_calls"]) == int(out[k + "whole_calls"])
        assert float(out[k + "split_rel"]) <= 1e-9
        assert _rel(out[k + "split_x"], out[k + "whole_x"]) <= 1e-10
        assert _rel(out[k + "whole_x"], x_ref) <= 1e-10
        if form == "multi":
            np.testing.assert_array_equal(out[k + "split_x"], out[k + "whole_x"])
        np.testing.assert_array_equal(out[k + "split_r1"], out[k + "whole_r1"])
    _same_on_every_rank(outs, k + "split_r1", k + "split_z1", k + "split_x")


def test_ell_pcg_split_matches_replicated(solvers):
    """Jacobi-PCG (ell_pcg) on this rank's rows: the replicated solve's
    iterations and its solution within 1e-10 relative, on every rank; the
    replicated solve holds the reference's ell_pcg the same way."""
    x_ref, it_ref = solvers["ref"]["ell_pcg"]
    for out in solvers["outs"]:
        assert int(out["pcg_split_iters"]) == int(out["pcg_whole_iters"]) == it_ref > 0
        assert float(out["pcg_split_rel"]) <= 1e-9
        assert _rel(out["pcg_split_x"], out["pcg_whole_x"]) <= 1e-10
        assert _rel(out["pcg_whole_x"], x_ref) <= 1e-10
    _same_on_every_rank(solvers["outs"], "pcg_split_x")


@pytest.mark.parametrize("inner", ["refined", "refine_mg3"])
def test_refine_loop_split_matches_replicated(solvers, inner):
    """The float64 refinement loop on this rank's rows, around Jacobi-PCG
    (ell_solve_refined) and around the three-level cycle warm-started from
    half the solution: the replicated loop's inner iterations and best
    relative residual's order, its solution within 1e-10 relative."""
    for out in solvers["outs"]:
        assert int(out[inner + "_split_iters"]) == int(out[inner + "_whole_iters"]) > 0
        assert float(out[inner + "_split_rel"]) < 1e-10
        assert _rel(out[inner + "_split_x"], out[inner + "_whole_x"]) <= 1e-10
    _same_on_every_rank(solvers["outs"], inner + "_split_x")


def test_dog_band_split_matches_reference(solvers):
    """smooth_signal and dog_band on this rank's vertex rows of the grid
    (576 vertices: split at 2 and 4 ranks) against the reference's
    smooth_signal and dog_band, within 1e-10 relative."""
    ref, world = solvers["ref"], solvers["world"]
    for out in solvers["outs"]:
        assert int(out["g_local_rows_split"]) == 576 // world
        assert int(out["smooth_split_iters"]) == int(out["smooth_whole_iters"]) \
            == ref["smooth_iters"]
        assert _rel(out["smooth_split_x"], ref["smooth"]) <= 1e-10
        assert _rel(out["dog_split"], ref["dog"]) <= 1e-10
        assert _rel(out["dog_whole"], ref["dog"]) <= 1e-10


def test_all_reduce_max_over_ranks(solvers):
    """DeviceGroup.all_reduce(op="max") and Rows.amax over the ranks."""
    world = solvers["world"]
    for out in solvers["outs"]:
        assert out["amax"].tolist() == [world - 1.0, 0.0]
        assert float(out["rows_amax"]) == 3.0 * (world - 1)


RUN_KW = dict(vf_mode=VectorFieldMode.WHITNEY, levels=3, dtype="float64", cg_tol=1e-10,
              cg_max_iters=3000, artifact_cache=False)
# name -> (config overrides, hierarchy): tests/test_parallel.py:64, :88, :284
RUNS = {"plain": (dict(dog_weight=0.0), False), "full": (dict(dog_weight=1.0), True),
        "halo": (dict(dog_weight=1.0, flow_backend="halo"), True)}


def _run_inputs(names):
    small, big = _sphere_inputs(False), _sphere_inputs(True)
    return dict(small, **{"h_" + k: v for k, v in big.items()}, runs=np.array(names))


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The production runs at 2 and 4 ranks, all three."""
    tmp = tmp_path_factory.mktemp("runs")
    return {world: _spawn("runs", world, _run_inputs(list(RUNS)), tmp) for world in (2, 4)}


def _solo(name, **over):
    kw, hier = RUNS[name]
    return _port_sphere(FlowConfig(**RUN_KW, **dict(kw, **over)), hier).run()


def _jax_solo(name, device_mesh=None):
    kw, hier = RUNS[name]
    prob = synthetic_sphere_problem(JaxFlowConfig(**RUN_KW, **kw), subdiv=2,
                                    hierarchy=hier, device_mesh=device_mesh)
    return prob.run()


def _assert_trajectory(out, name, other):
    """tfield within 1e-8 and every level's alignment error within 1e-6."""
    np.testing.assert_allclose(out[name + "_tfield"], np.asarray(other.tfield), atol=1e-8)
    align = [m["alignment_error"] for m in other.metrics]
    assert len(align) == len(out[name + "_align"])
    assert np.abs(out[name + "_align"] - np.asarray(align)).max() < 1e-6


@pytest.fixture(scope="module")
def run_refs():
    """For "plain" and "full": the port's solo "xla" run, the reference's
    solo run, and the reference's runs on device meshes of 2 and 4."""
    refs = {}
    for name in ("plain", "full"):
        refs[name] = {w: _jax_solo(name, make_device_mesh(w)) for w in (2, 4)}
        refs[name].update(solo=_solo(name, flow_backend="xla"), ref=_jax_solo(name))
    return refs


def _check_xla_run(outs, name, refs, world):
    """Every rank's trajectory against the port's solo run, the reference's
    solo run and its run on as many devices; flow_iters equal the solo
    run's."""
    solo = refs["solo"]
    for out in outs:
        assert str(out[name + "_backend"]) == "xla"
        assert np.all(out[name + "_flow_res"] < 1e-6)
        for other in (solo, refs["ref"], refs[world]):
            _assert_trajectory(out, name, other)
        assert out[name + "_flow_iters"].tolist() == [m["flow_iters"] for m in solo.metrics]


@pytest.mark.parametrize("name", ["plain", "full"])
def test_production_run_sharded_matches_single_device(sharded_runs, run_refs, name):
    """tests/test_parallel.py:64 (``plain``: no hierarchy) and :88 (``full``:
    multigrid, DoG, refinement) at 2 ranks: under a group every backend but
    "halo" runs the three-level "xla" pipeline on this rank's rows, and the
    trajectory matches that pipeline's solo run, the reference's solo run
    and the reference's run on a mesh of 2 devices."""
    _check_xla_run(sharded_runs[2], name, run_refs[name], 2)


@pytest.mark.parametrize("name", ["plain", "full"])
def test_production_run_four_ranks_matches_single_device(sharded_runs, run_refs, name):
    """The same at 4 ranks, against the reference's run on 4 devices: the V
    rows (66, 642) do not divide 4, so the smoothing stays replicated while
    the flow basis (192, 1920 rows) splits, the reference's partition."""
    _check_xla_run(sharded_runs[4], name, run_refs[name], 4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["plain", "full"])
def test_production_run_holds_pick_row_blocks(sharded_runs, run_refs, name, world):
    """Each rank holds rows / world of every tensor ``pick`` splits (the
    smoothing operators, the lumped masses and the signals by V; the flow
    basis operator by n_coeffs) and all rows of the rest (the basis's
    prolongation and slots, the trace tables, coeffs and tfield); the
    replicated coarse solves read and return the same vectors on every
    rank, bit for bit, and so do coeffs and tfield."""
    d = _sphere_inputs(RUNS[name][1])
    v, t = len(d["verts"]), len(d["tris"])
    n = len(run_refs[name]["solo"].coeffs)
    outs = sharded_runs[world]
    for out in outs:
        v_loc = v // world if v % world == 0 else v
        n_loc = n // world if n % world == 0 else n
        assert out[name + "_split_rows"].tolist() == [v_loc] * 6 + [n_loc] * 3
        assert out[name + "_whole_rows"].tolist() == [t, t, 9 * t, t, t, n, t]
    _same_on_every_rank(outs, name + "_coarse", name + "_tfield", name + "_coeffs",
                        name + "_flow_iters", name + "_align")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_runs_trace_lanes_below_cap(sharded_runs, world):
    """The level trace under a group compacts and escalates its cap where the
    reference's sharded run marches a fixed ``flow_max_steps``
    (meshopticalflow_tpu/flow/pipeline.py:1273): the two agree while no lane
    reaches the cap. Count, in the split runs, the lanes still marching at
    ``flow_max_steps``: none, at any level."""
    for out in sharded_runs[world]:
        for name in ("plain", "full"):
            assert len(out[name + "_at_cap"]) == len(out[name + "_align"])
            assert out[name + "_at_cap"].tolist() == [0] * len(out[name + "_align"])
            assert out[name + "_trace_exhausted"].tolist() == [0.0] * len(out[name + "_align"])


@pytest.mark.parametrize("world", [2, 4])
def test_production_run_sharded_halo_backend_matches(sharded_runs, world):
    """tests/test_parallel.py:284: flow_backend="halo" under a group runs the
    halo-exchange two-level solver inside the production refinement, and
    the trajectory matches the reference's halo run on a device mesh of as
    many devices and the port's solo run."""
    ref = _jax_solo("halo", make_device_mesh(world))
    solo = _solo("halo")
    for out in sharded_runs[world]:
        assert str(out["halo_backend"]) == "halo"
        assert np.all(out["halo_flow_res"] < 1e-6)
        _assert_trajectory(out, "halo", ref)
        _assert_trajectory(out, "halo", solo)


def test_texture_cli_runs_sharded(tmp_path, monkeypatch):
    """tests/test_parallel.py:133 on tests/golden/cube.ply: the OpticalFlow
    CLI in 2 processes through the environment contract, with --flowBackend
    halo on the multigrid hierarchy; rank 0 writes the halfway PNG, which
    agrees with the solo run of the same pipeline (halo without a group is
    the three-level cycle, "xla") but where u8 rounding sits on a knife
    edge: the two flow solves agree to the refinement tolerance only."""
    from meshopticalflow_tpu_torch.apps.optical_flow import main as port_main
    from meshopticalflow_tpu_torch.io.png import read_png_rgb, write_png_rgb

    rng = np.random.default_rng(0)
    paths = []
    for name in ("a", "b"):
        p = str(tmp_path / f"{name}.png")
        write_png_rgb(p, rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        paths.append(p)
    flags = ["--mesh", os.path.join(GOLD, "cube.ply"), "--in", *paths, "--iterations", "2",
             "--dtype", "float64", "--eLength", "0.1", "--device", "cpu"]
    out = str(tmp_path / "sharded.png")
    _spawn("cli", 2, dict(argv=np.array(flags + ["--out", out, "--flowBackend", "halo"])),
           tmp_path)
    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "solo_cache"))
    port_main(flags + ["--out", str(tmp_path / "solo.png"), "--flowBackend", "halo"])
    a, b = read_png_rgb(out), read_png_rgb(str(tmp_path / "solo.png"))
    assert a.shape == b.shape == (64, 64, 3)
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_two_process_env_contract_halo_pcg(tmp_path):
    """tests/test_distributed.py:73 through torchrun's variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK): a cross-rank reduction and
    gather, and the float32 halo PCG on a real smoothing system across the
    process boundary against scipy's solve."""
    import scipy.sparse.linalg as spla

    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.models.base import build_basis

    tris, verts = octa_sphere(4)
    _, basis = build_basis(build_mesh(tris, vertices=verts), FlowConfig(dtype="float32"), "cpu")
    cols = basis.ell_cols.numpy()
    vals = basis.s_vals.numpy().astype(np.float64)
    vals[np.arange(vals.shape[0]), basis.diag_slot.numpy()] += 1e-2
    b = np.ones(cols.shape[0])
    outs = _spawn("contract", 2, dict(cols=cols, vals=vals, b=b), tmp_path, torchrun_env=True)
    n, w = cols.shape
    a = sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(n), w), cols.ravel())), shape=(n, n))
    x_ref = spla.spsolve(a.tocsc(), b)
    for out in outs:
        assert out["total"].tolist() == [6.0]
        assert out["gathered"].tolist() == [1.0, 1.0, 2.0, 2.0]
        assert float(out["rel"]) < 1e-5
        got = float(out["x"].astype(np.float64) @ out["x"])
        assert abs(got - x_ref @ x_ref) / (x_ref @ x_ref) < 1e-4
    np.testing.assert_array_equal(outs[0]["x"], outs[1]["x"])

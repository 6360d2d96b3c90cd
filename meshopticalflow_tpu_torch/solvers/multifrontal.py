"""Batched multifrontal Cholesky on nested-dissection schedules: the
direct per-level flow solve (``flow_backend="mf"``).

Port of meshopticalflow_tpu/solvers/multifrontal.py. The flow system's
sparsity pattern (the union ELL of S and R D P, models/base.py) is the same
at every level, so the nested-dissection ordering, the front structure and
every gather/scatter index table are computed once per problem on the host
(and disk-cached, utils/artifacts.py); each level is then a numeric
refactorization and triangular solves on the device with fixed shapes.

The host half (``_pad8``, ``dof_positions``, ``nested_dissection``,
``front_structure``, ``_DepthTables``, ``build_nd_pack``) is a jax-free copy
of the reference's (tests/test_torch_host.py pins it). The numeric half is
rewritten in torch: all fronts at one elimination-tree depth are padded to a
common shape and processed as one batched dense step (gather the ELL rows,
scatter-assemble, extend-add the children by gathers, batched Cholesky,
triangular solve, Schur update), deepest depth first. ``cholesky_ex`` keeps
a front that is not positive definite from raising: its factor becomes NaN,
as the reference's is, so the caller's residual check sees the breakdown.
The scatters that accumulate (``index_add``) sum in no fixed order on CUDA
unless torch's deterministic algorithms are on.

The factor runs in the working dtype (float32 on the main path) inside the
refinement loop of solvers/refine.py, which restores float64 residual
quality, as the reference's non-df32 path does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as nnf

from meshopticalflow_tpu_torch.utils import spans


def _pad8(x: int, minimum: int = 8) -> int:
    """Pad a front dimension up to a sublane-friendly multiple of 8."""
    return max(minimum, (x + 7) // 8 * 8)


def dof_positions(tris: np.ndarray, verts: np.ndarray, p_idx: np.ndarray,
                  n_coeffs: int) -> np.ndarray:
    """A 3D embedding per basis coefficient: the mean of the centroids of
    the triangles whose prolongation stencil touches it. Drives the
    inertial bisection only — quality affects fill, never correctness."""
    cent = np.asarray(verts)[np.asarray(tris)].mean(axis=1)   # (T, 3)
    pos = np.zeros((n_coeffs, 3))
    cnt = np.zeros(n_coeffs)
    p_idx = np.asarray(p_idx)
    for k in range(p_idx.shape[1]):
        np.add.at(pos, p_idx[:, k], cent)
        np.add.at(cnt, p_idx[:, k], 1.0)
    pos /= np.maximum(cnt, 1.0)[:, None]
    return pos


# ---------------------------------------------------------------------------
# Host symbolic analysis: nested dissection + closed-border fronts.
# ---------------------------------------------------------------------------

def nested_dissection(pattern: sp.csr_matrix, pos: np.ndarray, leaf: int):
    """Recursive inertial bisection with vertex separators on the DOF graph.

    Returns a node list of {depth, cols (global DOF ids eliminated at this
    node), parent, leaf}. Children of a node always sit at depth+1, so the
    elimination schedule is a strict depth-by-depth sweep."""
    nodes = []
    root_ids = np.arange(pattern.shape[0], dtype=np.int64)
    stack = [(pattern, root_ids, 0, -1)]
    while stack:
        g, ids, depth, parent = stack.pop()
        nid = len(nodes)
        if len(ids) <= leaf:
            nodes.append(dict(depth=depth, cols=ids, parent=parent, leaf=True))
            continue
        p = pos[ids]
        c = p - p.mean(0)
        axis = np.linalg.eigh(c.T @ c)[1][:, -1]
        t = c @ axis
        mask_b = t > np.median(t)
        if mask_b.all() or (~mask_b).all():
            mask_b = np.zeros(len(ids), bool)
            mask_b[np.argsort(t, kind="stable")[len(ids) // 2:]] = True
        # Vertex separator: A-side DOFs adjacent to B-side DOFs.
        touch_b = g @ mask_b.astype(np.float32)
        sep_local = (~mask_b) & (touch_b > 0)
        a_local = (~mask_b) & ~sep_local
        nodes.append(dict(depth=depth, cols=ids[sep_local], parent=parent,
                          leaf=False))
        for m in (a_local, mask_b):
            sub = g[m][:, m]
            stack.append((sub, ids[m], depth + 1, nid))
    return nodes


def front_structure(pattern: sp.csr_matrix, nodes):
    """Closed-border fronts: border(nid) = (pattern-neighbors of cols ∪
    children's borders) minus DOFs eliminated at nid or its descendants.
    Closure means every child border id lands INSIDE the parent front, so
    the extend-add is a static gather."""
    n = pattern.shape[0]
    elim_at = np.empty(n, np.int64)
    for nid, nd in enumerate(nodes):
        elim_at[nd["cols"]] = nid
    depths = np.array([nd["depth"] for nd in nodes])
    indptr, indices = pattern.indptr, pattern.indices

    is_anc: List[set] = []
    for nid, nd in enumerate(nodes):
        s = set()
        p = nd["parent"]
        while p != -1:
            s.add(p)
            p = nodes[p]["parent"]
        is_anc.append(s)

    children = {}
    for nid, nd in enumerate(nodes):
        children.setdefault(nd["parent"], []).append(nid)

    borders: List[Optional[np.ndarray]] = [None] * len(nodes)
    maxd = int(depths.max())
    for d in range(maxd, -1, -1):
        for nid in np.nonzero(depths == d)[0]:
            cols = nodes[nid]["cols"]
            chunks = [indices[indptr[c]:indptr[c + 1]] for c in cols]
            for ch in children.get(nid, []):
                chunks.append(borders[ch])
            if chunks:
                nb = np.unique(np.concatenate(chunks))
            else:
                nb = np.empty(0, np.int64)
            anc = is_anc[nid]
            keep = np.fromiter((elim_at[x] in anc for x in nb), bool, len(nb))
            borders[nid] = nb[keep]
    return borders, depths, children


# ---------------------------------------------------------------------------
# The pack: per-depth padded batches + every static index table.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _DepthTables:
    """One elimination-tree depth, padded to a common front shape."""

    epad: int
    bpad: int
    rows: np.ndarray        # (B, Kpad) int32 global DOF per slot; sentinel n
    loc: np.ndarray         # (B, Kpad, W) int16 assembly target col slot;
    #                         Kpad = dump (entry belongs to another front)
    child_idx: np.ndarray   # (B, 2) int32 into the NEXT-DEEPER batch;
    #                         sentinel B_child = zero front
    child_map: np.ndarray   # (B, 2, Kpad) int16 slot -> child border pos;
    #                         sentinel bpad_child = zero row
    pad_elim: np.ndarray    # (B, epad) f32: 1.0 on padding slots

    @property
    def kpad(self) -> int:
        return self.epad + self.bpad


@dataclasses.dataclass
class NDPack:
    """Host pack (cacheable): depth tables ordered DEEPEST FIRST."""

    n: int
    w: int
    levels: List[_DepthTables]
    stats: dict

    def device(self, device="cpu") -> list:
        """Upload the per-depth tables once, as int64 index tensors (torch
        advanced indexing takes long indices). ``asm`` is the flat
        assembly target of every (row slot, ELL slot) entry in the
        (B, Kpad, Kpad + 1) front buffer, whose last column is the
        reference's dump slot ``loc == Kpad``."""
        out = []
        for dt in self.levels:
            b, kpad = dt.rows.shape
            front_row = np.arange(b * kpad, dtype=np.int64).reshape(b, kpad, 1)
            asm = front_row * (kpad + 1) + dt.loc.astype(np.int64)
            out.append(dict(
                rows=_index(dt.rows, device),
                asm=_index(asm.reshape(-1), device),
                child_idx=_index(dt.child_idx, device),
                child_map=_index(dt.child_map, device),
                pad_elim=torch.as_tensor(np.asarray(dt.pad_elim, np.float32)).to(device),
            ))
        return out


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int64)).to(device)


def build_nd_pack(ell_cols: np.ndarray, pos: np.ndarray, leaf: int = 64,
                  cache_key: str = "") -> NDPack:
    """Symbolic analysis + index tables for the union-ELL pattern.

    ``pos`` gives a 3D coordinate per DOF (for the inertial bisection);
    any geometry-respecting embedding works — quality only affects fill.
    Disk-cached per pattern via utils/artifacts when ``cache_key`` is set.
    """
    from meshopticalflow_tpu_torch.utils.artifacts import cached

    ell_cols = np.asarray(ell_cols)
    n, w = ell_cols.shape

    def compute():
        rows_h = np.repeat(np.arange(n, dtype=np.int64), w)
        pattern = sp.csr_matrix(
            (np.ones(n * w, np.float32), (rows_h, ell_cols.astype(np.int64).ravel())),
            shape=(n, n))
        pattern.sum_duplicates()
        nodes = nested_dissection(pattern, np.asarray(pos, np.float64), leaf)
        borders, depths, children = front_structure(pattern, nodes)
        maxd = int(depths.max())

        # ELL cols padded with a sentinel row (gathers of padding rows).
        cols_pad = np.concatenate(
            [ell_cols.astype(np.int64), np.full((1, w), n, np.int64)], axis=0)

        out = dict(meta=np.asarray([n, w, maxd], np.int64))
        order_at_depth = {}   # depth -> list of nids in batch order
        for d in range(maxd, -1, -1):
            nids = list(np.nonzero(depths == d)[0])
            order_at_depth[d] = nids
            B = len(nids)
            es = [len(nodes[i]["cols"]) for i in nids]
            bs = [len(borders[i]) for i in nids]
            epad = _pad8(max(es))
            bpad = _pad8(max(bs)) if max(bs) > 0 else 8
            kpad = epad + bpad

            rows = np.full((B, kpad), n, np.int64)
            g2f = np.full(n + 1, -1, np.int64)
            g2loc = np.zeros(n + 1, np.int64)
            for i, nid in enumerate(nids):
                c, b = nodes[nid]["cols"], borders[nid]
                rows[i, :len(c)] = c
                rows[i, epad:epad + len(b)] = b
                g2f[c] = i
                g2loc[c] = np.arange(len(c))
                g2f[b] = i
                g2loc[b] = epad + np.arange(len(b))

            # Assembly targets: entry (row slot k, ELL col c) lands at the
            # front-local slot of c iff c belongs to THIS front, with the
            # border x border couplings excluded (they are assembled at the
            # ancestor that eliminates them).
            C = cols_pad[rows]                        # (B, kpad, w)
            own = g2f[C] == np.arange(B)[:, None, None]
            tgt = np.where(own, g2loc[C], kpad)
            is_elim_row = (np.arange(kpad) < epad)[None, :, None]
            tgt = np.where(own & (is_elim_row | (tgt < epad)), tgt, kpad)

            # Children: strictly at depth d+1 (construction invariant).
            child_idx = np.full((B, 2), -1, np.int64)
            child_map = np.zeros((B, 2, kpad), np.int64)
            if d < maxd:
                prev_nids = order_at_depth[d + 1]
                prev_pos = {nid: i for i, nid in enumerate(prev_nids)}
                bpad_c = _pad8(max(len(borders[i]) for i in prev_nids)) \
                    if max(len(borders[i]) for i in prev_nids) > 0 else 8
                child_idx[:] = len(prev_nids)         # sentinel: zero front
                child_map[:] = bpad_c                 # sentinel: zero row
                for i, nid in enumerate(nids):
                    for ci, ch in enumerate(children.get(nid, [])):
                        assert nodes[ch]["depth"] == d + 1
                        child_idx[i, ci] = prev_pos[ch]
                        bc = borders[ch]
                        idx = np.searchsorted(bc, rows[i])
                        hit = (idx < len(bc))
                        hit[hit] &= bc[idx[hit]] == rows[i][hit]
                        # Closed borders: every child-border id is in the
                        # parent front.
                        assert hit.sum() == len(bc), "open border"
                        child_map[i, ci][hit] = idx[hit]
            else:
                child_idx[:] = 0
                child_map[:] = 0

            pad_elim = (rows[:, :epad] == n).astype(np.float32)
            out[f"d{d:02d}_rows"] = rows.astype(np.int32)
            out[f"d{d:02d}_loc"] = tgt.astype(np.int16)
            out[f"d{d:02d}_cidx"] = child_idx.astype(np.int32)
            out[f"d{d:02d}_cmap"] = child_map.astype(np.int16)
            out[f"d{d:02d}_pad"] = pad_elim
            out[f"d{d:02d}_shape"] = np.asarray([epad, bpad], np.int64)
        return out

    d = cached("ndpack", cache_key, compute, enabled=bool(cache_key))
    n_, w_, maxd = [int(v) for v in d["meta"]]
    levels = []
    padded_flops = 0.0
    padded_mb = 0.0
    for dep in range(maxd, -1, -1):
        epad, bpad = [int(v) for v in d[f"d{dep:02d}_shape"]]
        dt = _DepthTables(
            epad=epad, bpad=bpad,
            rows=np.asarray(d[f"d{dep:02d}_rows"]),
            loc=np.asarray(d[f"d{dep:02d}_loc"]),
            child_idx=np.asarray(d[f"d{dep:02d}_cidx"]),
            child_map=np.asarray(d[f"d{dep:02d}_cmap"]),
            pad_elim=np.asarray(d[f"d{dep:02d}_pad"]),
        )
        levels.append(dt)
        b = dt.rows.shape[0]
        padded_flops += b * (epad ** 3 / 3 + epad ** 2 * bpad + epad * bpad ** 2)
        padded_mb += b * 4 * (epad + bpad) ** 2 / 1e6
    return NDPack(n=n_, w=w_, levels=levels,
                  stats=dict(depths=maxd + 1,
                             padded_gflops=round(padded_flops / 1e9, 2),
                             padded_front_mb=round(padded_mb, 1)))


# ---------------------------------------------------------------------------
# Device numeric factorization + triangular solves.
# ---------------------------------------------------------------------------

def shift_diag(sys_vals, diag_slot, shift_rel):
    """A + shift_rel * diag(A), out of place: the factorization safety shift
    for semi-definite systems (open-mesh conformal bases have an exact null
    space; the Whitney level systems are positive definite but nearly
    singular). The shifted factor is a preconditioner; iterative refinement
    restores true-residual accuracy. ``sys_vals`` is never written: it may
    be shared with the unshifted solver of the same level."""
    rows = torch.arange(sys_vals.shape[0], device=sys_vals.device)
    d = sys_vals[rows, diag_slot]
    return sys_vals.index_put((rows, diag_slot), shift_rel * d, accumulate=True)


def _factor(levels_dev, sys_vals):
    """One batched multifrontal Cholesky sweep (deepest depth to the root).

    ``sys_vals`` is the level system on the union ELL pattern (N, W).
    Returns [(Ld, Lp)] per depth, deepest first: Ld (B, epad, epad) the
    fronts' eliminated block factors, Lp (B, bpad, epad) their border rows."""
    n, w = sys_vals.shape
    vals_pad = torch.cat([sys_vals, sys_vals.new_zeros((1, w))])
    u_prev = None
    factors = []
    for dt in levels_dev:
        rows = dt["rows"]
        b, kpad = rows.shape
        epad = dt["pad_elim"].shape[1]
        # Scatter-assemble the gathered ELL rows; column kpad is the dump.
        f = sys_vals.new_zeros(b * kpad * (kpad + 1))
        f.index_add_(0, dt["asm"], vals_pad[rows].reshape(-1))
        f = f.view(b, kpad, kpad + 1)[:, :, :kpad]
        if u_prev is not None:
            # Extend-add the children's Schur complements: a zero front
            # (sentinel child index) and a zero row and column (sentinel
            # border position) pad the previous depth's updates.
            u_pad = nnf.pad(u_prev, (0, 1, 0, 1, 0, 1))
            for c in (0, 1):
                cidx = dt["child_idx"][:, c]
                cmap = dt["child_map"][:, c]                 # (B, kpad)
                f = f + u_pad[cidx[:, None, None], cmap[:, :, None], cmap[:, None, :]]
        eye = torch.eye(epad, dtype=f.dtype, device=f.device)
        fe = f[:, :epad, :epad] + eye * dt["pad_elim"][:, None, :].to(f.dtype)
        ld, info = torch.linalg.cholesky_ex(fe)
        ld = torch.where((info == 0)[:, None, None], ld, torch.full_like(ld, float("nan")))
        # X Ld^T = B_border, i.e. the reference's right-side transposed solve.
        lp = torch.linalg.solve_triangular(ld.mT, f[:, epad:, :epad], upper=True,
                                           left=False)
        u_prev = f[:, epad:, epad:] - lp @ lp.mT
        factors.append((ld, lp))
    return factors


def _solve(levels_dev, factors, b):
    """Forward and backward triangular sweeps for one rhs. Padding slots
    write into the sentinel entry n, which stays finite (an identity block
    and zero couplings) and is dropped at the end."""
    x = torch.cat([b, b.new_zeros(1)])
    # Forward: L y = b, depth by depth from the leaves.
    for dt, (ld, lp) in zip(levels_dev, factors):
        epad = ld.shape[1]
        re, rb = dt["rows"][:, :epad], dt["rows"][:, epad:]
        y = torch.linalg.solve_triangular(ld, x[re].unsqueeze(-1), upper=False).squeeze(-1)
        x = x.index_put((re,), y)
        upd = torch.einsum("bke,be->bk", lp, y)
        x = x.index_add(0, rb.reshape(-1), upd.reshape(-1), alpha=-1)
    # Backward: L^T x = y, root to leaves.
    for dt, (ld, lp) in zip(reversed(levels_dev), reversed(factors)):
        epad = ld.shape[1]
        re, rb = dt["rows"][:, :epad], dt["rows"][:, epad:]
        z = x[re] - torch.einsum("bke,bk->be", lp, x[rb])
        z = torch.linalg.solve_triangular(ld.mT, z.unsqueeze(-1), upper=True).squeeze(-1)
        x = x.index_put((re,), z)
    return x[:-1]


class NDSolver:
    """Per-level direct solver: numeric refactorization on a static pack.

    The inner-solver contract of solvers/refine.py: ``solve(r, ...)``
    returns (x, CGStats) with ``iterations`` 1 (one pair of triangular
    sweeps); the factorization runs at the first solve. ``factor_seconds``
    is its wall time (synchronized while the span record is on), ``gb_per_iter`` the padded fronts'
    gigabytes at 4 bytes a value, the reference's streamed-bytes model."""

    def __init__(self, pack: NDPack, levels_dev, sys_vals,
                 diag_slot=None, shift_rel: float = 0.0):
        self.pack = pack
        self.levels_dev = levels_dev
        if shift_rel and diag_slot is not None:
            sys_vals = shift_diag(sys_vals, diag_slot, shift_rel)
        self.sys_vals = sys_vals
        self.factors = None
        self.factor_seconds = 0.0
        self.gb_per_iter = pack.stats["padded_front_mb"] / 1e3

    def factor(self) -> None:
        with spans.timed("multifrontal.factor", sync=self.sys_vals.device) as factor:
            self.factors = _factor(self.levels_dev, self.sys_vals)
        self.factor_seconds = factor.seconds

    def solve_direct(self, r):
        if self.factors is None:
            self.factor()
        return _solve(self.levels_dev, self.factors, r)

    def solve(self, r, tol=None, max_iters=None, b_norm2=None, x0=None):
        from meshopticalflow_tpu_torch.solvers.cg import CGStats

        x = self.solve_direct(r.to(self.sys_vals.dtype)).to(r.dtype)
        return x, CGStats(1, 0.0)


@dataclasses.dataclass
class NDContext:
    """Per-problem multifrontal state: the symbolic pack (host, disk-cached)
    and its device tables, built once; every level refactorizes numerically
    on the same static structure."""

    pack: NDPack
    levels_dev: list
    diag_slot: object = None


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_nd_context(tris, verts, p_idx, ell_cols, n_coeffs: int,
                     diag_slot=None, leaf: int = 64, cache_key: str = "",
                     device="cpu") -> NDContext:
    """Symbolic analysis and device upload for one problem's flow pattern."""
    pos = dof_positions(_host(tris), _host(verts), _host(p_idx), n_coeffs)
    pack = build_nd_pack(_host(ell_cols), pos, leaf=leaf, cache_key=cache_key)
    return NDContext(pack=pack, levels_dev=pack.device(device), diag_slot=diag_slot)

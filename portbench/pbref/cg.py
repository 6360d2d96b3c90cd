"""Plain Jacobi-preconditioned conjugate gradients on a padded-ELL matrix,
one or several right-hand sides, with a convergence test every ``chunk``
iterations."""

from __future__ import annotations

import torch

from pbref.fem import ell_matvec


def _col_dots(u, v):
    return torch.einsum("nc,nc->c", u, v)


def jacobi_pcg(cols, vals, diag, b, x0=None, tol=1e-11, max_iters=20000, chunk=64):
    """Solve A x = b for SPD A (every column of b at once) until each
    column's residual is under ``tol`` of its right-hand side. Returns (x,
    iterations, worst relative residual)."""
    single = b.dim() == 1
    if single:
        b = b[:, None]
        x0 = None if x0 is None else x0[:, None]
    inv_diag = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag)),
                           torch.zeros_like(diag))[:, None]
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - ell_matvec(cols, vals, x) if x0 is not None else b.clone()
    z = inv_diag * r
    p = z
    rz = _col_dots(r, z)
    b2 = _col_dots(b, b)
    b2 = torch.where(b2 > 0, b2, torch.ones_like(b2))
    it = 0
    rel = float(torch.sqrt(torch.max(_col_dots(r, r) / b2)))
    while it < max_iters and rel > tol:
        for _ in range(chunk):
            ap = ell_matvec(cols, vals, p)
            pap = _col_dots(p, ap)
            alpha = torch.where(pap != 0, rz / torch.where(pap != 0, pap, torch.ones_like(pap)),
                                torch.zeros_like(pap))
            x = x + alpha[None] * p
            r = r - alpha[None] * ap
            z = inv_diag * r
            rz_new = _col_dots(r, z)
            beta = torch.where(rz != 0, rz_new / torch.where(rz != 0, rz, torch.ones_like(rz)),
                               torch.zeros_like(rz))
            p = z + beta[None] * p
            rz = rz_new
        it += chunk
        rel = float(torch.sqrt(torch.max(_col_dots(r, r) / b2)))
    return (x[:, 0] if single else x), it, rel

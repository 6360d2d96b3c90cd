"""Run configuration mirroring the reference CLI contract.

Flag surface and defaults follow the reference exactly
(OpticalFlow/OpticalFlow.cpp:56-63, Spectrum/Spectrum.cpp:57-61,
SampleTextureToVertices/SampleTextureToVertices.cpp:47-50).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class VectorFieldMode(enum.IntEnum):
    """Vector-field basis (Src/VectorField.h:3-7)."""

    WHITNEY = 0
    CONFORMAL = 1
    CONNECTION = 2


class ConnectionMode(enum.IntEnum):
    """Dual-edge weight mode for the connection basis (Src/Connection.inl:1-5)."""

    PROJECTED_BARYCENTRIC = 0
    BARYCENTRIC = 1
    INVERSE_COTANGENT = 2


# Per-mode default vector-field smoothing weights (OpticalFlow.cpp:1063-1070).
DEFAULT_VF_SMOOTH_WEIGHT = {
    VectorFieldMode.WHITNEY: 3e-6,
    VectorFieldMode.CONFORMAL: 5e-7,
    VectorFieldMode.CONNECTION: 1e4,
}


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Static configuration of an optical-flow run (hashable, jit-friendly).

    Defaults match OpticalFlow.cpp:56-63.
    """

    vf_mode: VectorFieldMode = VectorFieldMode.WHITNEY
    connection_mode: ConnectionMode = ConnectionMode.PROJECTED_BARYCENTRIC
    levels: int = 10
    pad_radius: int = 2
    scalar_smooth_weight: float = 3e-3
    vf_smooth_weight: Optional[float] = None  # None -> per-mode default
    vf_smooth_weight_threshold: float = 1e-8
    subdivide_edge_length: float = 0.006  # x bbox diagonal (OpticalFlow.cpp:712-714)
    dog_weight: float = 1.0
    dog_smooth: float = 1e-4
    scalar_weight_multiplier: float = 0.25
    vf_weight_multiplier: float = 1.0
    divergence_free: bool = False
    log_space: bool = False
    nearest: bool = False
    # Numerics (rebuild-specific):
    dtype: str = "float32"  # device compute dtype
    cg_tol: float = 1e-7  # relative residual tolerance for PCG solves
    cg_max_iters: int = 2000
    flow_refine: bool = True  # mixed-precision iterative refinement of flow solves
    flow_refine_tol: float = 3e-9   # outer (true-residual) target of refinement
    # Round-1 inner tolerance floor. The f32 CG recurrence drifts ~1e-4 from
    # the true residual at 2K scale, so asking the inner solve for 1e-5 burns
    # a whole extra chunk (72 vs 48 iters measured) without improving the
    # true residual round 1 hands to round 2; 1e-4 converges in 96 total
    # iters vs 120 with the same final rel residual < 3e-9.
    flow_refine_floor: float = 1e-4
    # Warm-start each level's flow solve from the previous level's solved
    # direction (the basis lives on the fixed mesh, so the DoF space is the
    # same at every level). Default OFF: the on-chip interleaved A/B
    # (bench_runs/battery_warmAB_2026-08-18T1057.jsonl) measured it a net
    # LOSS at bench scale — the lower starting residual makes the adaptive
    # refinement demand extra late-level rounds (iters 96..144 vs 96..120,
    # solve total 30.3 s vs 26.7 s warm). Final accuracy is governed by
    # flow_refine_tol either way.
    flow_warm_start: bool = False
    use_multigrid: bool = True  # geometric MG when a subdivision hierarchy exists
    # 2: host-factored coarse; 3: fully on-device (SA patch coarsest + tiled
    # fine SpMV) — 1.5x faster per flow solve on TPU, identical trajectories.
    flow_mg_levels: int = 3
    # Flow-solve SpMV backend: "pallas" (block-ELL kernels, tile-space MG,
    # bf16 smoothing), "xla" (gather+einsum), "auto" = pallas on TPU,
    # (float64 problems always resolve to "xla": Mosaic has no f64
    # lowering; XLA:TPU runs f64 natively — kernels/pallas_spmv.py
    # resolve_flow_backend),
    # "mf" = batched multifrontal DIRECT solve on the nested-dissection
    # schedule (solvers/multifrontal.py; single-device, needs the vertex
    # embedding; falls back to the MG path on factorization breakdown),
    # "halo" = ppermute halo-exchange sharded cycle under a device mesh.
    flow_backend: str = "auto"
    # Chebyshev order of the inner coarse-1 solve inside the Pallas MG
    # V-cycle (1 = plain V). k>1 spends k cheap coarse-level cycles per
    # fine cycle for a much stronger coarse correction: measured outer
    # PCG iterations drop 64 -> 26 (k=4) / 18 (k=6) on the demo system
    # (scripts/exp_mg.py), a net ~30% matvec-work cut.
    mg_cheb_k: int = 4
    # Damped-Jacobi smoothing steps per half-cycle of the MG preconditioner
    # (the V-cycle runs nu-1 pre-smooths + nu post-smooths around the coarse
    # correction). More smoothing costs 2 extra bf16 fine-operator streams
    # per step but cuts outer PCG iterations; 2 measured best with the
    # exact banded c1 (scripts/exp_nu.py).
    mg_nu: int = 2
    # Chebyshev fine-smoother degree for the banded-exact MG cycle
    # (0 = damped Jacobi). deg=2 streams the same fine-operator passes as
    # nu=2 Jacobi; measured on-chip via scripts/exp_nu.py.
    mg_fine_cheb: int = 0
    # EXACT coarse-1 solve via blocked banded Cholesky on the MXU
    # (solvers/banded.py) inside the Pallas MG cycle — the round-3 strong
    # coarse solve (VERDICT r2 next #1): outer PCG iterations drop to the
    # measured 2-level-exact count (~59 vs 236-304 at the 2K bench). Falls
    # back to the 3-level cycle on factorization breakdown.
    mg_coarse_exact: bool = True
    # Store the exact-c1 solve panels in bfloat16: the banded factor is the
    # largest per-iteration stream of the exact-c1 cycle (~0.5 GB of the
    # ~2.4 GB/iter at the 2K bench shape). A ~1e-2-accurate coarse solve is
    # still far stronger than the Chebyshev fallback, and refinement owns
    # the trajectory — but the outer iteration count may rise; default OFF
    # until measured on chip (scripts/exp_warm.py --toggle mg_c1_bf16).
    mg_c1_bf16: bool = False
    # Disk cache of per-mesh init artifacts (subdivision, operators, coarse
    # spaces, kernel pattern packs) under $MESHFLOW_CACHE (utils/artifacts.py).
    artifact_cache: bool = True
    flow_min_step: float = 1e-2  # minStepSize (OpticalFlow.cpp:209,510)
    flow_max_steps: int = 4096  # safety cap on tracing iterations (ref: 1e6, FEM.inl:905)
    use_host_cholesky: bool = False  # scipy oracle path for the level solves

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def channels(self) -> int:
        """double,6 when 0<dogWeight<1 (signal + DoG band), else 3 (OpticalFlow.cpp:1113-1115)."""
        return 6 if 0.0 < self.dog_weight < 1.0 else 3

    def resolved_vf_smooth_weight(self) -> float:
        if self.vf_smooth_weight is not None:
            return self.vf_smooth_weight
        return DEFAULT_VF_SMOOTH_WEIGHT[VectorFieldMode(self.vf_mode)]


def require_supported(config: FlowConfig) -> None:
    """Refuse the settings whose code paths this package does not have.

    The port runs the Whitney basis with the plain Jacobi-PCG solves
    (``use_multigrid=False``) of the reference package. The multigrid knobs
    (``flow_mg_levels``, ``mg_*``, ``flow_refine_tol``, ``flow_refine_floor``)
    have no effect with ``use_multigrid=False`` in either package, and
    ``artifact_cache`` only speeds up the reference package's init; none of
    them changes a result here.
    """
    refused = []
    if config.use_multigrid:
        refused.append("use_multigrid=True (pass use_multigrid=False)")
    if config.flow_backend != "auto":
        refused.append(f"flow_backend={config.flow_backend!r}")
    if VectorFieldMode(config.vf_mode) != VectorFieldMode.WHITNEY:
        refused.append(f"vf_mode={VectorFieldMode(config.vf_mode).name}")
    if ConnectionMode(config.connection_mode) != ConnectionMode.PROJECTED_BARYCENTRIC:
        refused.append(f"connection_mode={ConnectionMode(config.connection_mode).name}")
    if config.divergence_free:
        refused.append("divergence_free=True")
    if config.use_host_cholesky:
        refused.append("use_host_cholesky=True")
    if config.dtype not in ("float32", "float64"):
        refused.append(f"dtype={config.dtype!r}")
    if refused:
        raise NotImplementedError(
            "meshopticalflow_tpu_torch does not support: " + ", ".join(refused))

"""meshopticalflow_tpu_torch — the PyTorch/CUDA port of meshopticalflow_tpu.

Halfway optical-flow alignment of texture atlases and per-vertex colours on
a triangle mesh, on one NVIDIA GPU (or the CPU, for tests). The package
mirrors the module layout of ``meshopticalflow_tpu``, which stays the
reference: host preprocessing is a jax-free copy of its numpy code, device
work is PyTorch, and the sparse matvecs of the solvers run through
hand-written CUDA kernels (``csrc/spmv_ell.cu``, bound in ``kernels/spmv.py``).

This slice runs the Whitney basis with Jacobi-PCG solves (no multigrid).
"""

__version__ = "0.1.0"

from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

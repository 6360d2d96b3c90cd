"""Plain reference of the texture-pair alignment that the benchmark's cells
time: the geometry, the Whitney basis, the smoothing, the level trace, the
flow solve and the halfway march, fetch and blend, in plain NumPy and
PyTorch, by the reference CLI's equations (OpticalFlow.cpp, MeshFlow.inl,
FEM.inl, Whitney.inl). The host modules are frozen copies of the port's
numpy code; the device half has no kernel and no multigrid: the solves are
plain Jacobi-PCG, the marches the plain batched march. Nothing here imports
the program under test."""

"""Tensor operations: graph primitives, radial bases, FGW solver, kernels."""

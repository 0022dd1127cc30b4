"""Compute ops: preprocessing kernels and reductions.

The five performance-critical kernels flagged in SURVEY.md §2 live here
(bilateral grid, backprojection, stencil normals, projective-ICP reduction,
voxel-hash NN) as fused XLA ops, and the fused ICP Pallas kernel.
"""

"""Ops: activations, layers, ring-state engine core, CUDA kernels."""

"""HQI (workload-aware hybrid vector search) on PyTorch and CUDA for Hopper.

The counterpart of the JAX package ``repro``: the same index, planner and
engine, with the device work in PyTorch and the scan kernels hand-written in
CUDA (``kernels/csrc``); and the decoder-only LM's serving path (dense
family: ``models``, ``serve``, ``configs``, ``launch``) with its
flash-attention kernel in CUDA. Entry points run on "cuda" unless the caller
passes another device. This package imports neither ``jax`` nor ``repro``.
"""

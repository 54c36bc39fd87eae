"""HQI (workload-aware hybrid vector search) on PyTorch and CUDA for Hopper.

The counterpart of the JAX package ``repro``: the same index, planner and
engine, with the device work in PyTorch and the scan kernels hand-written in
CUDA (``kernels/csrc``); and the LM's serving and training paths (every
family of the reference: dense, moe, ssm, hybrid, vlm and encdec;
``models``, ``serve``, ``train``, ``data``, ``configs``, ``launch``) with
its flash-attention kernels, forward and backward, in CUDA. Entry points run on "cuda" unless the caller passes
another device. This package imports neither ``jax`` nor ``repro``.
"""

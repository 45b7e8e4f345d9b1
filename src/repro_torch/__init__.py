"""PyTorch/CUDA port of the CSMAAFL system.

The twin of ``repro`` (the JAX package), module for module: the same
public names and the same flat parameter layout, with tensors on a CUDA
card by default.  It imports neither ``jax`` nor ``repro``; what it needs
of the reference's numpy-only code is transcribed here.
"""

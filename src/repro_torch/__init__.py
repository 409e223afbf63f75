"""PyTorch/CUDA port of the BPMF system (the JAX package `repro` is the reference).

Imports torch, never jax or repro. Entry points run on CUDA unless the
caller asks for the CPU.
"""

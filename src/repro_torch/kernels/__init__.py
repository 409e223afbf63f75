"""Hand-written CUDA kernels of the port, their plain PyTorch versions and dispatch.

Importing this package builds nothing: a kernel is compiled with nvcc the
first time it is launched on a CUDA tensor (``kernels/build.py``).
"""

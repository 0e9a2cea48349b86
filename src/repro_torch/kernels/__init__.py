"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``csrc/`` holds the CUDA sources, ``build`` compiles and loads them,
``ops`` holds the wrappers with launch counters, and ``ref`` the plain
PyTorch versions. Nothing here builds or imports CUDA code at import time.
"""

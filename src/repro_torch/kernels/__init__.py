"""Kernels of the port: CUDA sources under ``csrc/``, built at first use.

Importing this package (or any module in it) builds nothing and imports
neither ``triton`` nor a compiled library.
"""

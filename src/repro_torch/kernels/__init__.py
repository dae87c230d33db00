"""Legendre-stage kernels of the port.

``legendre_cuda`` wraps the CUDA kernels of ``csrc/legendre.cu`` (built at
first use by ``build``), ``ref`` holds their plain PyTorch versions and the
seed tables, and ``ops`` chooses the variant and routes CPU tensors to the
plain versions and CUDA tensors to the kernels.  Nothing here compiles or
touches a device at import time.
"""

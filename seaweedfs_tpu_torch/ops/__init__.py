"""Erasure-coding compute: GF(2^8) algebra on the host, the bit-matrix
kernels for CUDA (csrc/) with their plain PyTorch versions."""

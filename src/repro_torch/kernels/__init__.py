"""Hand-written CUDA kernels for Hopper (sm_90a).

Layout (one directory per kernel family):
  bloom/     — blocked-Bloom fused multi-filter probe (K1) and build (K2)
               in csrc/bloom.cu; ops.py holds the wrappers and their
               plain torch versions
  semijoin/  — the device sorted-segment join (torch ops, no hand kernel)
  build.py   — nvcc build at first use + ctypes loading
"""

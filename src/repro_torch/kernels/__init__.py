"""Hand-written CUDA kernels for Hopper (sm_90a).

Layout (one directory per kernel family):
  bloom/     — blocked-Bloom fused multi-filter probe (K1), build (K2)
               and single-filter probe (K3) in csrc/bloom.cu; ops.py
               holds the wrappers and their plain torch versions
  semijoin/  — the device sorted-segment join (torch ops, no hand
               kernel), and the key -> row map build (K4) and lookup
               (K5) in csrc/semijoin.cu with their wrappers and plain
               versions in ops.py
  csrc/      — headers the kernel sources share (hash.cuh: the key hash)
  build.py   — nvcc build at first use + ctypes loading; the int32
               tensor check every wrapper runs before a launch
"""

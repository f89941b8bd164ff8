"""Hand-written CUDA kernels for Hopper (sm_90a).

Layout (one directory per kernel family):
  bloom/     — blocked-Bloom fused multi-filter probe (K1), build (K2),
               single-filter probe (K3) and fused filter transfer (K7)
               in csrc/bloom.cu; ops.py holds the wrappers, their plain
               torch versions and the public entry points `bloom_build`,
               `bloom_probe`, `bloom_transfer` (exported here by
               bloom/__init__.py); ref.py re-exports the oracle
  semijoin/  — the device sorted-segment join (torch ops, no hand
               kernel), the key -> row map build (K4) and lookup (K5),
               and the key set build (K6a) and probe (K6b) in
               csrc/semijoin.cu, with their wrappers, plain versions and
               the public `semijoin_build`, `semijoin_probe`,
               `semi_mask` in ops.py; ref.py holds the numpy oracle
               `semi_mask_ref`
  flashattn/ — flash attention forward (K8) in csrc/flashattn.cu: a
               prefill and a decode variant; ops.py holds the public
               `flash_attention` (reference layout [B, S, H, D], GQA),
               its launch wrapper and its plain torch version
               `flash_plain`; ref.py the dense oracle `sdpa_ref`
  csrc/      — headers the kernel sources share (hash.cuh: the key hash)
  build.py   — nvcc build at first use + ctypes loading; the tensor
               checks every wrapper runs before a launch

The Bloom and semi-join entry points take host int64 keys and a
`device=` (default "cuda"): a CUDA device launches the kernels or
raises, "cpu" runs their plain torch versions, any other device raises.
`flash_attention` follows its tensors' device the same way.
"""

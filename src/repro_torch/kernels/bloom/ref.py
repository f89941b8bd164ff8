"""Plain torch oracle for the bloom kernels.

This is exactly the framework-level implementation in
`repro_torch.core.bloom`, re-exported so the kernel directory is
self-contained per the kernels/<name>/{ops,ref} convention.
"""
from repro_torch.core.bloom import (  # noqa: F401
    BLOCK_BITS, LANES, DEFAULT_K,
    build as bloom_build_ref,
    probe as bloom_probe_ref,
    transfer as bloom_transfer_ref,
)

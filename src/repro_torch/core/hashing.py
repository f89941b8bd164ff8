"""32-bit vectorized hashing (murmur3 finalizer based), torch + numpy mirrors.

All engine keys are int64 on host. Keys are split into (lo, hi) uint32
halves on host and the pair is hashed. The same mix is implemented in
numpy (host/oracle) and torch (device); tests assert bit-exact agreement.

The torch mix computes in int64 masked to 32 bits: this torch's CPU
build raises NotImplementedError on `uint32` shifts, adds and compares,
and an int64 product wraps mod 2^64, so its low 32 bits stay exact.
Device tensors hold uint32 values as the same bit pattern in `int32`
(key halves, filter words) or as non-negative `int64` (hash state).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

GOLDEN = np.uint32(0x9E3779B9)
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
P2 = np.uint32(0x7FEB352D)
MASK32 = 0xFFFFFFFF


# -- host (numpy) -----------------------------------------------------------

def key_halves(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 keys -> (lo, hi) uint32 halves (host-side)."""
    k = keys.astype(np.int64, copy=False).view(np.uint64)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def fmix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= _C1
        h ^= h >> np.uint32(13)
        h *= _C2
        h ^= h >> np.uint32(16)
    return h


def hash64_np(lo: np.ndarray, hi: np.ndarray,
              salt: np.uint32 = np.uint32(0)) -> np.ndarray:
    with np.errstate(over="ignore"):
        return fmix32_np(lo ^ fmix32_np(hi ^ salt))


# -- device (torch, int64 masked to 32 bits) --------------------------------

def keys64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Signed int64 keys from int32 (lo, hi) bit-pattern halves — the
    device inverse of `key_halves`."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & MASK32)


def u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 bit pattern (int32 or int64 tensor) -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over int64 tensors holding uint32 values."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = (h * int(_C1)) & MASK32
    h = h ^ (h >> 13)
    h = (h * int(_C2)) & MASK32
    h = h ^ (h >> 16)
    return h


def hash64(lo: torch.Tensor, hi: torch.Tensor, salt: int = 0
           ) -> torch.Tensor:
    return fmix32(u32(lo) ^ fmix32(u32(hi) ^ int(salt)))

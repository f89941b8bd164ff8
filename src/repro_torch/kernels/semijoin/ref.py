"""Oracle for the semijoin kernels: sorted-membership test (host numpy).

The kernels operate on (lo, hi) uint32 halves of int64 keys; the oracle
takes the original int64 keys, so tests exercise the halving round-trip
as well.
"""
from __future__ import annotations

import numpy as np


def semi_mask_ref(probe_keys: np.ndarray, build_keys: np.ndarray,
                  build_mask: np.ndarray | None = None) -> np.ndarray:
    """bool mask over probe_keys: does the key appear in build_keys?"""
    bk = np.asarray(build_keys)
    if build_mask is not None:
        bk = bk[np.asarray(build_mask, bool)]
    bk = np.unique(bk)
    pk = np.asarray(probe_keys)
    if len(bk) == 0:
        return np.zeros(len(pk), bool)
    pos = np.minimum(np.searchsorted(bk, pk), len(bk) - 1)
    return bk[pos] == pk

"""Device sorted-segment equi-join (the device-resident data plane's join).

Duplicate-key joins entirely on the device — a stable argsort of the
build keys, a binary search per probe key, segment emission — with the
host syncing one output-size scalar per join. Bit-identical
(build_idx, probe_idx) to `engine_join.sorted_join_indices` under the
NULL contract of `JoinEngine.join_indices_valid`.

torch sorts and searches int64 natively, so the keys travel as their
(lo, hi) int32 halves (one stacked upload per side, the same bytes as
the reference) and are rebuilt as signed int64 on the device. NULL-key
and padding build rows are sorted past every real key with a second
stable pass on an invalid flag, and each probe row's match range is
clamped to the valid prefix, so they never match; NULL-key probe rows
get a zero match count (inner drops them, left emits them unmatched,
anti keeps them — no compact-and-remap on either side).

These are torch ops, not a hand kernel: sort and searchsorted were XLA
primitives in the reference too.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import device_plane as dp
from repro_torch.core import hashing

_I64MAX = torch.iinfo(torch.int64).max


def _pow2(n: int, floor: int = 256) -> int:
    return max(floor, int(2 ** np.ceil(np.log2(max(int(n), 1)))))


def _pad_pow2(a: np.ndarray, m: int, fill=0) -> np.ndarray:
    if m == len(a):
        return a
    out = np.full(m, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _segjoin_counts(bstack: torch.Tensor, pstack: torch.Tensor,
                    np_live: int):
    """(order, lo_pos, counts): build sort permutation (valid rows in
    stable key order first), each probe row's first-match position in
    it, and its match count (0 past `np_live` and for NULL probe keys)."""
    bkey = hashing.keys64(bstack[0], bstack[1])
    binv = bstack[2] != 0
    bkey = torch.where(binv, _I64MAX, bkey)
    order = torch.argsort(bkey, stable=True)
    order = order[torch.argsort(binv[order].to(torch.int8), stable=True)]
    skey = bkey[order]
    nvalid = torch.sum(~binv)
    pkey = hashing.keys64(pstack[0], pstack[1])
    lo_pos = torch.minimum(torch.searchsorted(skey, pkey), nvalid)
    hi_pos = torch.minimum(torch.searchsorted(skey, pkey, right=True),
                           nvalid)
    live = torch.arange(pkey.shape[0], device=pkey.device) < np_live
    if pstack.shape[0] == 3:
        live = live & (pstack[2] != 0)
    counts = torch.where(live, hi_pos - lo_pos, 0)
    return order.to(torch.int32), lo_pos, counts


def _segjoin_emit(order, lo_pos, counts, out_counts, total: int,
                  left: bool):
    """Match-pair emission: probe rows in original order, matches in
    stable build-key order (the engine output contract)."""
    npb = counts.shape[0]
    dev = counts.device
    starts = torch.cumsum(out_counts, 0) - out_counts
    probe_idx = torch.repeat_interleave(
        torch.arange(npb, dtype=torch.int64, device=dev), out_counts,
        output_size=total)
    within = torch.arange(total, dtype=torch.int64, device=dev) \
        - starts[probe_idx]
    build_pos = lo_pos[probe_idx] + within
    build_idx = order[torch.clamp(build_pos, 0, order.shape[0] - 1)]
    if left:
        build_idx = torch.where(counts[probe_idx] == 0, -1, build_idx)
    return build_idx.to(torch.int32), probe_idx.to(torch.int32)


def segment_join_device(build_key: np.ndarray, probe_key: np.ndarray,
                        how: str = "inner",
                        build_valid: Optional[np.ndarray] = None,
                        probe_valid: Optional[np.ndarray] = None,
                        device="cuda"):
    """Device sorted-segment equi-join. Returns (build_idx, probe_idx)
    with the exact semantics of `JoinEngine.join_indices_valid` — NULL
    contract included — as int32 device tensors (semi/anti build_idx is
    a host -1 vector, and an empty result two empty host vectors,
    matching the reference). Two counted uploads and one d2h scalar
    sync (the output size) per call."""
    build_key = np.asarray(build_key)
    probe_key = np.asarray(probe_key)
    nb, npr = len(build_key), len(probe_key)
    bb, pb = _pow2(nb), _pow2(npr)

    blo, bhi = hashing.key_halves(_pad_pow2(build_key, bb))
    bstack = np.empty((3, bb), np.uint32)
    bstack[0] = blo
    bstack[1] = bhi
    binv = np.zeros(bb, np.uint32)
    binv[nb:] = 1
    if build_valid is not None:
        binv[:nb][~np.asarray(build_valid, bool)] = 1
    bstack[2] = binv
    plo, phi = hashing.key_halves(_pad_pow2(probe_key, pb))
    pstack = np.empty((3 if probe_valid is not None else 2, pb),
                      np.uint32)
    pstack[0] = plo
    pstack[1] = phi
    if probe_valid is not None:
        pstack[2] = _pad_pow2(np.asarray(probe_valid, bool), pb, False)

    order, lo_pos, counts = _segjoin_counts(dp.to_device(bstack, device),
                                            dp.to_device(pstack, device),
                                            npr)
    live = torch.arange(pb, device=counts.device) < npr

    if how in ("semi", "anti"):
        ok = live & ((counts == 0) if how == "anti" else (counts > 0))
        sel = dp.compact(ok, pb)
        total = dp.scalar(torch.sum(ok, dtype=torch.int32))
        return np.full(total, -1, np.int64), sel[:total]
    if how == "left":
        out_counts = torch.where(live, torch.clamp(counts, min=1), 0)
    elif how == "inner":
        out_counts = counts
    else:
        raise ValueError(how)
    total = dp.scalar(torch.sum(out_counts, dtype=torch.int32))
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return _segjoin_emit(order, lo_pos, counts, out_counts, total,
                         how == "left")

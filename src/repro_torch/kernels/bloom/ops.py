"""Blocked-Bloom kernels K1 (fused multi-filter probe), K2 (build), K3
(single-filter probe) and K7 (fused filter transfer), and the kernel
library's public entry points `bloom_build`, `bloom_probe` and
`bloom_transfer`.

`multi_probe`, `build` and `probe` are the wrappers the engine calls
(K1 on the device-resident plane, K3 on the plane-off route, K2 on
both); `transfer` (K7) is reached through `bloom_transfer` only. The
public functions take host int64 keys, upload their halves with a plain
`.to(device)` (the reference's `jnp.asarray`, outside `DeviceStats`),
and run K2, K3 and K7. On a CUDA tensor each wrapper launches its
hand-written kernel from `csrc/bloom.cu` on the current stream (and
raises if it cannot); on a CPU tensor it runs the plain torch version
(`multi_probe_ref`, `build_ref`, `probe_ref`, and for K7
`core.bloom.transfer`), which repeats the kernel's hash arithmetic in
int64 masked to 32 bits — the port's counterpart of running the
reference's Pallas kernels in interpret mode. Any other device raises.

Device layout: key halves and filter words are `int32` tensors holding
the uint32 bit pattern (the kernels read them as `uint32_t`); survivor
ids are `int32`; masks are `bool` (one byte, the kernels write 0/1).

`LAUNCHES` counts kernel launches (bumped under a lock, only where a
kernel is launched), so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bloom
from repro_torch.core.bloom import DEFAULT_BITS_PER_KEY, DEFAULT_K, LANES
from repro_torch.kernels.build import (LaunchCounts, check, check_bool,
                                      check_i32, library)

LAUNCHES = LaunchCounts("multi_probe", "bloom_build", "probe",
                        "bloom_transfer")

_c_void_p_p = ctypes.POINTER(ctypes.c_void_p)
_c_int_p = ctypes.POINTER(ctypes.c_int)
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = library("bloom")
        lib.bloom_max_filters.argtypes = []
        lib.bloom_max_filters.restype = ctypes.c_int
        lib.bloom_multi_probe.argtypes = [
            _c_void_p_p, _c_void_p_p, _c_void_p_p, _c_int_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.bloom_multi_probe.restype = ctypes.c_int
        lib.bloom_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.bloom_build.restype = ctypes.c_int
        lib.bloom_build_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bloom_build_scratch_bytes.restype = ctypes.c_longlong
        lib.bloom_build_force_route.argtypes = [ctypes.c_int]
        lib.bloom_build_force_route.restype = ctypes.c_int
        lib.bloom_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.bloom_probe.restype = ctypes.c_int
        lib.bloom_probe_force_rows.argtypes = [ctypes.c_int]
        lib.bloom_probe_force_rows.restype = ctypes.c_int
        lib.bloom_probe_rows.argtypes = [ctypes.c_int]
        lib.bloom_probe_rows.restype = ctypes.c_int
        lib.bloom_transfer.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.bloom_transfer.restype = ctypes.c_int
        lib.bloom_transfer_scratch_bytes.argtypes = [ctypes.c_int,
                                                     ctypes.c_int]
        lib.bloom_transfer_scratch_bytes.restype = ctypes.c_longlong
        lib.bloom_transfer_force.argtypes = [ctypes.c_int]
        lib.bloom_transfer_force.restype = ctypes.c_int
        lib.bloom_transfer_plan.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bloom_transfer_plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _log2(nb: int) -> int:
    l2 = int(nb).bit_length() - 1
    if nb < 1 or (1 << l2) != nb:
        raise ValueError(f"filter block count {nb} is not a power of two")
    return l2


def _check_words(words: torch.Tensor, dev: torch.device,
                 what: str) -> None:
    check_i32(words, dev, what, ndim=2)
    if words.shape[1] != LANES:
        raise ValueError(f"{what} must be [nblocks, {LANES}]")


def _rows(los: Sequence[torch.Tensor], idx: Optional[torch.Tensor],
          count: Optional[int]):
    n = int(idx.shape[0]) if idx is not None else int(los[0].shape[0])
    count = n if count is None else int(count)
    if not 0 <= count <= n:
        raise ValueError(f"count {count} outside [0, {n}]")
    return n, count


# --------------------------------------------------------------------------
# K1: fused multi-filter probe
# --------------------------------------------------------------------------


def multi_probe_ref(words_list: Sequence[torch.Tensor],
                    los: Sequence[torch.Tensor], his: Sequence[torch.Tensor],
                    idx: Optional[torch.Tensor] = None,
                    count: Optional[int] = None,
                    k: int = DEFAULT_K) -> torch.Tensor:
    """Plain torch K1: bool [m, n], row f = cumulative survivor mask after
    filters 0..f over rows `idx` (None = rows 0..n-1 of the key columns);
    rows at and past `count` are False."""
    n, count = _rows(los, idx, count)
    dev = los[0].device
    ok = torch.arange(n, device=dev) < count
    out = torch.empty((len(words_list), n), dtype=torch.bool, device=dev)
    sel = None if idx is None else idx.to(torch.int64)
    for f, words in enumerate(words_list):
        lo, hi = los[f], his[f]
        if sel is not None:
            lo, hi = lo[sel], hi[sel]
        h, g1, g2 = bloom.hash_state(lo, hi)
        ok = ok & bloom.probe_hashed_dev(words, h, g1, g2, k=k)
        out[f] = ok
    return out


def multi_probe(words_list: Sequence[torch.Tensor],
                los: Sequence[torch.Tensor], his: Sequence[torch.Tensor],
                idx: Optional[torch.Tensor] = None,
                count: Optional[int] = None,
                k: int = DEFAULT_K) -> torch.Tensor:
    """K1. Probe m filters (int32 words [nb_f, 8]) over m key columns
    (int32 lo/hi halves) of the same rows. Returns bool [m, n]."""
    m = len(words_list)
    if m == 0 or len(los) != m or len(his) != m:
        raise ValueError("need one (lo, hi) key column per filter")
    dev = los[0].device
    if dev.type == "cpu":
        return multi_probe_ref(words_list, los, his, idx, count, k)
    if dev.type != "cuda":
        raise RuntimeError(f"multi_probe: no kernel for device {dev}")
    lib = _lib()
    if m > lib.bloom_max_filters():
        raise ValueError(f"multi_probe takes at most "
                         f"{lib.bloom_max_filters()} filters, got {m}")
    n, count = _rows(los, idx, count)
    ncol = int(los[0].shape[0])
    log2nbs = []
    for f in range(m):
        _check_words(words_list[f], dev, f"words[{f}]")
        log2nbs.append(_log2(words_list[f].shape[0]))
        check_i32(los[f], dev, f"lo[{f}]")
        check_i32(his[f], dev, f"hi[{f}]")
        if los[f].shape[0] != ncol or his[f].shape[0] != ncol:
            raise ValueError("key columns differ in length")
    if idx is not None:
        check_i32(idx, dev, "idx")
    elif n > ncol:
        raise ValueError("n exceeds the key columns")
    out = torch.empty((m, n), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    err = lib.bloom_multi_probe(
        (ctypes.c_void_p * m)(*[t.data_ptr() for t in words_list]),
        (ctypes.c_void_p * m)(*[t.data_ptr() for t in los]),
        (ctypes.c_void_p * m)(*[t.data_ptr() for t in his]),
        (ctypes.c_int * m)(*log2nbs),
        m, int(k), None if idx is None else idx.data_ptr(), n, count,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bloom_multi_probe")
    LAUNCHES.bump("multi_probe")
    return out


# --------------------------------------------------------------------------
# K3: single-filter probe
# --------------------------------------------------------------------------


def probe_ref(words: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              idx: Optional[torch.Tensor] = None,
              count: Optional[int] = None,
              k: int = DEFAULT_K) -> torch.Tensor:
    """Plain torch K3: bool [n], membership of rows `idx` (None = rows
    0..n-1 of the key columns) in one filter; rows at and past `count`
    are False."""
    n, count = _rows([lo], idx, count)
    ok = torch.arange(n, device=lo.device) < count
    if idx is not None:
        sel = idx.to(torch.int64)
        lo, hi = lo[sel], hi[sel]
    return ok & bloom.probe(words, lo, hi, k=k)


def probe(words: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
          idx: Optional[torch.Tensor] = None, count: Optional[int] = None,
          k: int = DEFAULT_K) -> torch.Tensor:
    """K3. Probe one filter (int32 words [nb, 8]) over int32 key halves;
    see `probe_ref`. Returns bool [n]."""
    dev = lo.device
    if dev.type == "cpu":
        return probe_ref(words, lo, hi, idx, count, k)
    if dev.type != "cuda":
        raise RuntimeError(f"bloom probe: no kernel for device {dev}")
    lib = _lib()
    _check_words(words, dev, "words")
    check_i32(lo, dev, "lo")
    check_i32(hi, dev, "hi")
    if hi.shape[0] != lo.shape[0]:
        raise ValueError("lo and hi differ in length")
    n, count = _rows([lo], idx, count)
    if idx is not None:
        check_i32(idx, dev, "idx")
    log2nb = _log2(words.shape[0])
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    err = lib.bloom_probe(
        words.data_ptr(), log2nb, int(k), lo.data_ptr(), hi.data_ptr(),
        None if idx is None else idx.data_ptr(), n, count, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bloom_probe")
    LAUNCHES.bump("probe")
    return out


# --------------------------------------------------------------------------
# K2: build
# --------------------------------------------------------------------------


def build_ref(lo: torch.Tensor, hi: torch.Tensor, nblocks: int,
              idx: Optional[torch.Tensor] = None,
              count: Optional[int] = None,
              valid: Optional[torch.Tensor] = None,
              k: int = DEFAULT_K) -> torch.Tensor:
    """Plain torch K2: int32 words [nblocks, 8] from rows `idx[:count]`
    (None = rows 0..count-1), skipping rows whose `valid` (indexed by
    original row id) is False."""
    n, count = _rows([lo], idx, count)
    mask = torch.arange(n, device=lo.device) < count
    if idx is not None:
        sel = idx.to(torch.int64)
        lo, hi = lo[sel], hi[sel]
        if valid is not None:
            mask = mask & valid[sel]
    elif valid is not None:
        lo, hi = lo[:n], hi[:n]
        mask = mask & valid[:n]
    return bloom.build(lo, hi, mask, nblocks, k=k)


def build(lo: torch.Tensor, hi: torch.Tensor, nblocks: int,
          idx: Optional[torch.Tensor] = None, count: Optional[int] = None,
          valid: Optional[torch.Tensor] = None,
          k: int = DEFAULT_K) -> torch.Tensor:
    """K2. Blocked Bloom build from int32 key halves; see `build_ref`."""
    dev = lo.device
    if dev.type == "cpu":
        return build_ref(lo, hi, nblocks, idx, count, valid, k)
    if dev.type != "cuda":
        raise RuntimeError(f"bloom build: no kernel for device {dev}")
    lib = _lib()
    check_i32(lo, dev, "lo")
    check_i32(hi, dev, "hi")
    if hi.shape[0] != lo.shape[0]:
        raise ValueError("lo and hi differ in length")
    n, count = _rows([lo], idx, count)
    if idx is not None:
        check_i32(idx, dev, "idx")
    if valid is not None:
        check_bool(valid, dev, lo.shape[0], "valid")
    log2nb = _log2(nblocks)
    if count == 0:
        return torch.zeros((nblocks, LANES), dtype=torch.int32, device=dev)
    # the kernels write every word; the scratch (the partitioned route's
    # cursors, slice regions and overflow list, see bloom.cu) is theirs
    # for the call
    words = torch.empty((nblocks, LANES), dtype=torch.int32, device=dev)
    nscratch = int(lib.bloom_build_scratch_bytes(count, log2nb))
    scratch = (torch.empty(nscratch, dtype=torch.uint8, device=dev)
               if nscratch else None)
    err = lib.bloom_build(
        lo.data_ptr(), hi.data_ptr(),
        None if idx is None else idx.data_ptr(),
        None if valid is None else valid.data_ptr(), count, log2nb, int(k),
        words.data_ptr(), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bloom_build")
    LAUNCHES.bump("bloom_build")
    return words


# --------------------------------------------------------------------------
# K7: fused filter transfer
# --------------------------------------------------------------------------


def transfer(in_words: torch.Tensor, in_lo: torch.Tensor,
             in_hi: torch.Tensor, out_lo: torch.Tensor, out_hi: torch.Tensor,
             mask: torch.Tensor, nblocks: int, k: int = DEFAULT_K):
    """K7. Probe `in_words` on the incoming int32 key halves of the rows
    whose `mask` is True, and build a fresh filter of `nblocks` blocks from
    the outgoing key halves of the rows that pass. Its plain version is
    `core.bloom.transfer` (`ref.bloom_transfer_ref`)."""
    dev = in_lo.device
    if dev.type == "cpu":
        return bloom.transfer(in_words, in_lo, in_hi, out_lo, out_hi, mask,
                              nblocks, k=k)
    if dev.type != "cuda":
        raise RuntimeError(f"bloom transfer: no kernel for device {dev}")
    lib = _lib()
    _check_words(in_words, dev, "in_words")
    n = int(in_lo.shape[0])
    for t, what in ((in_lo, "in_lo"), (in_hi, "in_hi"), (out_lo, "out_lo"),
                    (out_hi, "out_hi")):
        check_i32(t, dev, what)
        if t.shape[0] != n:
            raise ValueError("key columns differ in length")
    check_bool(mask, dev, n, "mask")
    log2nb_in, log2nb_out = _log2(in_words.shape[0]), _log2(nblocks)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return ok, torch.zeros((nblocks, LANES), dtype=torch.int32,
                               device=dev)
    # the library zeroes the words where its route needs it; the scratch
    # (the partitioned route's, as K2's) is its for the call (bloom.cu, K7)
    words = torch.empty((nblocks, LANES), dtype=torch.int32, device=dev)
    nscratch = int(lib.bloom_transfer_scratch_bytes(n, log2nb_out))
    scratch = (torch.empty(nscratch, dtype=torch.uint8, device=dev)
               if nscratch else None)
    err = lib.bloom_transfer(
        in_words.data_ptr(), log2nb_in, in_lo.data_ptr(), in_hi.data_ptr(),
        out_lo.data_ptr(), out_hi.data_ptr(), mask.data_ptr(), n, log2nb_out,
        int(k), ok.data_ptr(), words.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bloom_transfer")
    LAUNCHES.bump("bloom_transfer")
    return ok, words


# --------------------------------------------------------------------------
# the kernel library's public entry points (host int64 keys in)
# --------------------------------------------------------------------------


def _live_blocks(mask: Optional[np.ndarray], n: int,
                 bits_per_key: int) -> int:
    """The reference's filter size: blocks for the mask's live count."""
    live = n if mask is None else int(np.asarray(mask, bool).sum())
    return bloom.blocks_for(max(live, 1), bits_per_key)


def bloom_build(keys: np.ndarray, mask: Optional[np.ndarray] = None,
                bits_per_key: int = DEFAULT_BITS_PER_KEY,
                k: int = DEFAULT_K, device="cuda") -> torch.Tensor:
    """Filter words (int32 [nblocks, 8] on `device`) from host int64 keys,
    rows with a False `mask` left out, through K2."""
    keys = np.asarray(keys)
    lo, hi = bloom.keys_to_device(keys, device)
    valid = (None if mask is None else
             torch.from_numpy(np.asarray(mask, bool)).to(device))
    return build(lo, hi, _live_blocks(mask, len(keys), bits_per_key),
                 valid=valid, k=k)


def bloom_probe(words: torch.Tensor, keys: np.ndarray,
                k: int = DEFAULT_K) -> np.ndarray:
    """Membership of host int64 keys in a filter, through K3, as a host
    bool array."""
    lo, hi = bloom.keys_to_device(keys, words.device)
    return probe(words, lo, hi, k=k).cpu().numpy()


def bloom_transfer(in_words: torch.Tensor, in_keys: np.ndarray,
                   out_keys: np.ndarray, mask: Optional[np.ndarray] = None,
                   bits_per_key: int = DEFAULT_BITS_PER_KEY,
                   k: int = DEFAULT_K) -> Tuple[np.ndarray, torch.Tensor]:
    """Fused filter transformation through K7: (host bool survivor mask,
    the outgoing filter's words on the device). The outgoing filter is
    sized for the mask's live rows, as the reference sizes it."""
    in_keys, out_keys = np.asarray(in_keys), np.asarray(out_keys)
    if len(in_keys) != len(out_keys):
        raise ValueError("in_keys and out_keys differ in length")
    n = len(in_keys)
    dev = in_words.device
    ilo, ihi = bloom.keys_to_device(in_keys, dev)
    olo, ohi = bloom.keys_to_device(out_keys, dev)
    live = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    ok, words = transfer(in_words, ilo, ihi, olo, ohi,
                         torch.from_numpy(live).to(dev),
                         _live_blocks(mask, n, bits_per_key), k=k)
    return ok.cpu().numpy(), words


def reset_launches() -> None:
    LAUNCHES.reset()

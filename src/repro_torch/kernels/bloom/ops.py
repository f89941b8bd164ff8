"""Blocked-Bloom kernels K1 (fused multi-filter probe), K2 (build) and K3
(single-filter probe).

`multi_probe`, `build` and `probe` are the wrappers the engine calls
(K1 on the device-resident plane, K3 on the plane-off route, K2 on
both). On a CUDA tensor each launches its hand-written kernel from
`csrc/bloom.cu` on the current stream (and raises if it cannot); on a
CPU tensor it runs the plain torch version beside it (`multi_probe_ref`,
`build_ref`, `probe_ref`), which repeats the kernel's hash arithmetic
in int64 masked to 32 bits — the port's counterpart of running the
reference's Pallas kernels in interpret mode. Any other device raises.

Device layout: key halves and filter words are `int32` tensors holding
the uint32 bit pattern (the kernels read them as `uint32_t`); survivor
ids are `int32`; masks are `bool` (one byte, the kernels write 0/1).

`LAUNCHES` counts kernel launches (plain integers, bumped only where a
kernel is launched), so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.core import bloom
from repro_torch.core.bloom import DEFAULT_K, LANES
from repro_torch.kernels.build import check, check_i32, library

LAUNCHES = {"multi_probe": 0, "bloom_build": 0, "probe": 0}

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
            ctypes.c_void_p, _c_void_p_p, _c_void_p_p, _c_int_p, _c_int_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.bloom_multi_probe.restype = ctypes.c_int
        lib.bloom_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.bloom_build.restype = ctypes.c_int
        lib.bloom_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.bloom_probe.restype = ctypes.c_int
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
    for f in range(m):
        _check_words(words_list[f], dev, f"words[{f}]")
        check_i32(los[f], dev, f"lo[{f}]")
        check_i32(his[f], dev, f"hi[{f}]")
        if los[f].shape[0] != ncol or his[f].shape[0] != ncol:
            raise ValueError("key columns differ in length")
    if idx is not None:
        check_i32(idx, dev, "idx")
    elif n > ncol:
        raise ValueError("n exceeds the key columns")
    log2nbs, offsets, acc = [], [], 0
    for w in words_list:
        log2nbs.append(_log2(w.shape[0]))
        offsets.append(acc)
        acc += int(w.shape[0])
    words = words_list[0] if m == 1 else torch.cat(list(words_list))
    out = torch.empty((m, n), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    err = lib.bloom_multi_probe(
        words.data_ptr(),
        (ctypes.c_void_p * m)(*[t.data_ptr() for t in los]),
        (ctypes.c_void_p * m)(*[t.data_ptr() for t in his]),
        (ctypes.c_int * m)(*log2nbs), (ctypes.c_int * m)(*offsets),
        m, int(k), None if idx is None else idx.data_ptr(), n, count,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bloom_multi_probe")
    LAUNCHES["multi_probe"] += 1
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
    LAUNCHES["probe"] += 1
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
        if (valid.device != dev or valid.dtype != torch.bool
                or valid.dim() != 1 or not valid.is_contiguous()):
            raise ValueError("valid must be a contiguous 1-D bool tensor "
                             f"on {dev}")
        if valid.shape[0] != lo.shape[0]:
            raise ValueError("valid must cover every key row")
    log2nb = _log2(nblocks)
    words = torch.zeros((nblocks, LANES), dtype=torch.int32, device=dev)
    if count == 0:
        return words
    err = lib.bloom_build(
        lo.data_ptr(), hi.data_ptr(),
        None if idx is None else idx.data_ptr(),
        None if valid is None else valid.data_ptr(), count, log2nb, int(k),
        words.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bloom_build")
    LAUNCHES["bloom_build"] += 1
    return words


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0

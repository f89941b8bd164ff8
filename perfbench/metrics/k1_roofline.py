"""K1, the fused multi-filter probe (`bloom.cu` `multi_probe_kernel`):
percent of its byte bound over the traced window.

The bound: the bytes these calls need at the card's HBM bandwidth
(`perfbench/peaks.json`), each input read once and each output written
once: of filter f's key column (two 4-byte halves) the rows still alive
before it (every row for the first; the probe stops at a row's first
miss), 4 bytes a row of the survivor ids where the call has them, every
filter's 32-byte blocks, and the [m, n] byte mask. Divided by the
device time of the kernels of that name in the trace."""

PATTERN = r"multi_probe_kernel"


def call_bytes(c):
    keys = 8 * (c["count"] + sum(c["alive"] or []))
    ids = 4 * c["count"] if c["idx"] else 0
    return keys + ids + 32 * sum(c["blocks"]) + c["m"] * c["n"]


def read(r):
    calls = [c for c in r.calls or () if c["kernel"] == "k1"]
    bw = r.peak("hbm_bytes_per_s")
    if r.trace is None or not calls or bw is None:
        return None
    seconds, launches = r.trace.kernel_seconds(PATTERN)
    if not launches or seconds <= 0:
        return None
    return 100.0 * sum(call_bytes(c) for c in calls) / bw / seconds

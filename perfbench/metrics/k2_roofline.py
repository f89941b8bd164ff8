"""K2, the blocked Bloom build (`bloom.cu`: `build_kernel`, or the
partitioned route's `slice_scatter_kernel`, `slice_build_kernel` and
`overflow_kernel`): percent of its byte bound over the traced window.

The bound: the bytes these calls need at the card's HBM bandwidth
(`perfbench/peaks.json`), each input read once and each output written
once: the key halves (8 bytes) of each row inserted (a row whose
validity byte is false is not), 4 bytes a row of the survivor ids and 1
of the validity where the call has them, and the filter's 32-byte blocks
written. Divided by the device time of the kernels of those names in the
trace (the filter's zeroing by memset is not counted in either)."""

#: bloom.cu's K2 kernels; semijoin.cu's kernels of like names take a
#: `Slot` table and are left out
PATTERN = (r"^(?!.*Slot).*(?:slice_scatter_kernel|slice_build_kernel"
           r"|overflow_kernel|(?<![A-Za-z_])build_kernel)")


def call_bytes(c):
    rows = c["live"] if c["live"] is not None else c["count"]
    ids = 4 * c["count"] if c["idx"] else 0
    valid = c["count"] if c["valid"] else 0
    return 8 * rows + ids + valid + 32 * c["blocks"]


def read(r):
    calls = [c for c in r.calls or () if c["kernel"] == "k2"]
    bw = r.peak("hbm_bytes_per_s")
    if r.trace is None or not calls or bw is None:
        return None
    seconds, launches = r.trace.kernel_seconds(PATTERN)
    if not launches or seconds <= 0:
        return None
    return 100.0 * sum(call_bytes(c) for c in calls) / bw / seconds

"""Host<->device traffic accounting for the device-resident data plane.

The device-resident data plane (DESIGN.md section 15) keeps transfer
and join intermediates on the GPU; the host only schedules.  Its
claim — "fewer host<->device round trips" — must be measurable, so every
place the engines intentionally cross the boundary calls one of the
counters here.  A query run wraps itself in :func:`track`; with no
active context every counter is a no-op, so library code can call them
unconditionally.

torch syncs behind the caller's back: ``torch.nonzero``, boolean-mask
indexing, ``.item()``, ``bool(t)`` and ``int(t)`` on a CUDA tensor each
block the host.  The plane-on path therefore never calls them directly:
every sync goes through :func:`scalar` / :func:`to_host` (and is
counted), and survivors are compacted with :func:`compact`, which never
syncs.

Counted events:

``h2d``  host -> device uploads (filter words, key halves, validity).
``d2h``  device -> host syncs.  A scalar sync (``int(x.sum())``) counts
         as one sync of ``SCALAR_BYTES``; an array sync counts its
         nbytes.  Both block the host on device completion, so the
         *sync count* (not bytes) is what the round-trip gate watches.

The counters are thread-local: concurrent queries each see only their
own traffic.  Nested contexts
attribute to the innermost one; the executor merges subquery stats
upward explicitly (mirroring how ``ExecStats.subqueries`` works).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

SCALAR_BYTES = 8


@dataclass
class DeviceStats:
    """Host<->device boundary-crossing counts for one query run."""

    h2d_syncs: int = 0
    h2d_bytes: int = 0
    d2h_syncs: int = 0
    d2h_bytes: int = 0
    fused_calls: int = 0          # fused multi-filter probe invocations
    device_compactions: int = 0   # survivor compactions done on device

    def round_trips(self) -> int:
        return self.h2d_syncs + self.d2h_syncs

    def merge(self, other: "DeviceStats") -> None:
        self.h2d_syncs += other.h2d_syncs
        self.h2d_bytes += other.h2d_bytes
        self.d2h_syncs += other.d2h_syncs
        self.d2h_bytes += other.d2h_bytes
        self.fused_calls += other.fused_calls
        self.device_compactions += other.device_compactions

    def report(self) -> dict:
        return {
            "h2d_syncs": self.h2d_syncs,
            "h2d_bytes": self.h2d_bytes,
            "d2h_syncs": self.d2h_syncs,
            "d2h_bytes": self.d2h_bytes,
            "round_trips": self.round_trips(),
            "fused_calls": self.fused_calls,
            "device_compactions": self.device_compactions,
        }


_tls = threading.local()


def active() -> DeviceStats | None:
    return getattr(_tls, "stats", None)


@contextmanager
def track(stats: DeviceStats):
    """Attribute boundary crossings on this thread to ``stats``."""
    prev = getattr(_tls, "stats", None)
    _tls.stats = stats
    try:
        yield stats
    finally:
        _tls.stats = prev


def count_h2d(nbytes: int = SCALAR_BYTES) -> None:
    s = active()
    if s is not None:
        s.h2d_syncs += 1
        s.h2d_bytes += int(nbytes)


def count_d2h(nbytes: int = SCALAR_BYTES) -> None:
    s = active()
    if s is not None:
        s.d2h_syncs += 1
        s.d2h_bytes += int(nbytes)


def count_fused() -> None:
    s = active()
    if s is not None:
        s.fused_calls += 1


def count_compaction() -> None:
    s = active()
    if s is not None:
        s.device_compactions += 1


def scalar(x) -> int:
    """``int(x)`` for a device scalar, counted as one d2h sync."""
    count_d2h(SCALAR_BYTES)
    return int(x.item()) if hasattr(x, "item") else int(x)


def to_host(a):
    """Host numpy copy of a tensor, with d2h accounting (free for host
    arrays). uint32 data held as int32 on device comes back as int32:
    the caller reinterprets it (`bloom.words_to_host`)."""
    import numpy as np
    import torch

    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    out = a.detach().cpu().numpy()
    count_d2h(out.nbytes)
    return out


def to_device(a, device):
    """``torch.as_tensor(a, device=device)`` with h2d accounting (free for
    tensors already on a device). np.uint32 arrays travel as their int32
    bit pattern — the port's device layout for uint32 data."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    count_h2d(a.nbytes)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def compact(ok, size: int, idx=None):
    """Front-packed ids of the True rows of bool ``ok``, without a host
    sync: an inclusive ``cumsum`` gives each survivor its slot, and a
    ``scatter_`` writes it into a pre-sized buffer of ``size`` entries,
    zero-padded (what the reference does with a sized ``nonzero``).  With ``idx`` the survivors' ``idx`` values are
    packed instead of their positions.  Returns int32 [size]."""
    import torch

    n = ok.shape[0]
    pos = torch.cumsum(ok, 0, dtype=torch.int64) - 1
    # dead rows scatter into a spill slot past the end, dropped below
    pos = torch.where(ok, pos, size)
    src = (torch.arange(n, dtype=torch.int32, device=ok.device)
           if idx is None else idx.to(torch.int32))
    out = torch.zeros(size + 1, dtype=torch.int32, device=ok.device)
    out.scatter_(0, pos, src)
    return out[:size]


def resolve_device(device):
    """``torch.device`` for an entry point's ``device=`` argument. A CUDA
    device without CUDA raises RuntimeError: a device backend never
    carries on quietly on the CPU — ask for ``"cpu"`` explicitly."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the kernels' plain torch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    return dev

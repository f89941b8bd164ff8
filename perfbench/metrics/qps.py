"""Queries answered a second over the window. Each answered request
counts by the share of its time, submit to answer, that lies inside the
window, and the sum is over the window's length: a request still running
when the window closes is waited for and counts for its part inside it,
so a long query in flight at the close neither drops out nor stretches
the window. Failed requests count nothing."""


def read(r):
    work = 0.0
    for sent, answered in r.spans:
        inside = min(answered, r.seconds) - max(sent, 0.0)
        if inside > 0:
            work += inside / (answered - sent)
    return work / r.seconds if work else None

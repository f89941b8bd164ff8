"""Megabytes (10**6 bytes) uploaded to the device a query, from
`ExecStats.report()["device"]["h2d_bytes"]`, over the window's answered
requests."""


def read(r):
    if not r.reports:
        return None
    return sum(rep["device"]["h2d_bytes"] for rep in r.reports) \
        / len(r.reports) / 1e6

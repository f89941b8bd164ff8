"""Host-device syncs a query (uploads and read-backs), from
`ExecStats.report()["device"]["round_trips"]`, over the window's
answered requests."""


def read(r):
    if not r.reports:
        return None
    return sum(rep["device"]["round_trips"] for rep in r.reports) \
        / len(r.reports)

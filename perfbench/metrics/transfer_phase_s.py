"""The executor's transfer phase, seconds a query: `ExecStats.report()`'s
`phase_seconds["transfer"]` summed over the window's answered requests,
over their number."""


def read(r):
    if not r.reports:
        return None
    return sum(rep["phase_seconds"].get("transfer", 0.0)
               for rep in r.reports) / len(r.reports)

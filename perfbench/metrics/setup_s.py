"""Seconds from the process's start to the window's opening: imports,
the warm-up (the CUDA context, the kernels' build or load, and one pass
of every template the cell sends on a small copy of its data), data
generation, and the program's catalog and server."""


def read(r):
    return r.setup_s

"""Carry state across from the reference package as plain numpy arrays.

This system has no weights: its state is the catalog and the Bloom
filters built over it. Both cross as numpy arrays, so nothing here
imports the reference package — the export from that side (for example
`{c: (t[c].decode(), t[c].valid) for c in t.names}` per table) lives in
the code that has both packages, such as the tests.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.bloom import LANES, BloomFilter
from repro_torch.relational.table import Table

ColumnArrays = Tuple[np.ndarray, Optional[np.ndarray]]


def catalog_from_arrays(arrays: Mapping[str, Mapping[str, ColumnArrays]]
                        ) -> dict:
    """{table: {column: (values, validity or None)}} -> {table: Table}.

    Values are plain numpy arrays (strings as decoded values, which are
    dictionary-encoded again here); validity is a bool mask of the
    column's non-NULL rows. Column order is kept as given."""
    catalog = {}
    for name, cols in arrays.items():
        values = {c: np.asarray(v) for c, (v, _) in cols.items()}
        validity = {c: np.asarray(m, bool) for c, (_, m) in cols.items()
                    if m is not None}
        catalog[name] = Table.from_arrays(values, name, validity=validity)
    return catalog


def filter_from_words(words: np.ndarray, k: int) -> BloomFilter:
    """A host `BloomFilter` from the reference's np.uint32 words
    [nblocks, 8] (nblocks a power of two) and its hash count k."""
    words = np.asarray(words)
    if words.dtype != np.uint32 or words.ndim != 2 \
            or words.shape[1] != LANES:
        raise ValueError(f"expected np.uint32 words [nblocks, {LANES}], "
                         f"got {words.dtype} {words.shape}")
    nb = words.shape[0]
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"block count {nb} is not a power of two")
    return BloomFilter(np.ascontiguousarray(words).copy(), int(k))

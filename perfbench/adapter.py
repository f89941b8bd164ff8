"""Hands the generator's arrays to the program: one `Table` per table.

The program gets its own copy of every array, so that nothing it does
can reach the arrays the reference reads. A string column becomes a
dictionary-encoded column over the same sorted vocabulary, which is the
program's own encoding (`Table.from_arrays`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.reflib import Strings


def catalog(db: Dict[str, Dict[str, object]]) -> dict:
    from repro_torch.relational.table import Table
    out = {}
    for name, cols in db.items():
        arrays, dicts = {}, {}
        for col, v in cols.items():
            if isinstance(v, Strings):
                arrays[col] = v.codes.copy()
                dicts[col] = v.vocab.copy()
            else:
                arrays[col] = np.array(v, copy=True)
        out[name] = Table.from_arrays(arrays, name, dictionaries=dicts)
    return out


def answer(table) -> Dict[str, np.ndarray]:
    """A result `Table` as the comparison reads it: name -> decoded
    values."""
    return {name: table[name].decode() for name in table.names}

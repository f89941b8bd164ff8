"""Carry state across from the reference package as plain numpy arrays.

Two kinds of state cross: the query engine's (the catalog and the Bloom
filters built over it) and the LM layer's weights (the parameter pytree
of `repro.models`). All of it crosses as numpy arrays, so nothing here
imports the reference package — the export from that side (for example
`{c: (t[c].decode(), t[c].valid) for c in t.names}` per table, or
`jax.tree.map(np.asarray, params)`) lives in the code that has both
packages, such as the tests.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bloom import LANES, BloomFilter
from repro_torch.models.common import ModelConfig, param_shapes
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


def _tensor(a, device) -> torch.Tensor:
    """One weight: bf16 (ml_dtypes' `bfloat16`, or its bit pattern as
    np.uint16) is carried bit for bit; every other dtype as it is."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_arrays(tree: Any, cfg: ModelConfig,
                       device="cuda") -> Any:
    """The reference's parameter pytree (dicts and lists of numpy arrays,
    e.g. `jax.tree.map(np.asarray, params)`) -> the port's, on `device`,
    with the layout unchanged. Raises ValueError where a leaf's shape is
    not the one `param_shapes(cfg)` gives."""
    def walk(node, shape, where):
        if isinstance(shape, dict):
            if not isinstance(node, Mapping) or set(node) != set(shape):
                raise ValueError(f"{where}: keys {sorted(node)} are not "
                                 f"{sorted(shape)}")
            return {k: walk(node[k], shape[k], f"{where}.{k}")
                    for k in shape}
        if isinstance(shape, list):
            if len(node) != len(shape):
                raise ValueError(f"{where}: {len(node)} entries, expected "
                                 f"{len(shape)}")
            return [walk(n, s, f"{where}[{i}]")
                    for i, (n, s) in enumerate(zip(node, shape))]
        t = _tensor(node, device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{where}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        return t
    return walk(tree, param_shapes(cfg), "params")

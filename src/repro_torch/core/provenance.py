"""Deterministic provenance signatures for cross-query artifact reuse.

A transfer artifact (Bloom filter, min-max range, post-transfer slot
state) is only reusable if the *exact row set* it was computed from can
be re-identified later — possibly in a different query, session, or
thread. Live-row counts cannot do that (two different predicate states
can keep the same number of rows); these signatures can.

The scheme is a Merkle-style event chain per vertex:

* a leaf's signature hashes (base table name, `Table.version`, the
  canonical fingerprint of its pushed-down predicate) — identical scans
  of an unchanged table share it across queries and aliases;
* every mask mutation the transfer phase applies appends an event:
  a fused Bloom probe hashes the *sorted* signatures of the filters it
  applied (set intersection commutes, so apply order must not split
  states), a min-max range cut hashes its bounds, a disjoint-range cut
  hashes the cutting filter;
* an emitted filter's signature hashes (source vertex signature,
  canonical key columns, filter parameters) — equal signatures mean
  bit-identical filter words, because every engine backend builds
  identical filters from identical live rows (tests/test_engine_bloom).

`None` is the "unknown" signature: any input that cannot be fingerprinted
(an opaque callable, a mask mutated outside the event protocol) poisons
the chain, and unknown states are simply never cached or reused.

Digests are 16-byte blake2b over a typed token encoding, so distinct
token *types* (int 1 vs string "1" vs True) can never collide.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


class UnsupportedToken(TypeError):
    """A value outside the deterministic token vocabulary."""


def _feed(h, tok) -> None:
    if tok is None:
        h.update(b"\x00N")
    elif isinstance(tok, bool):          # before int (bool is an int)
        h.update(b"\x00B" + (b"1" if tok else b"0"))
    elif isinstance(tok, (int, np.integer)):
        h.update(b"\x00I" + str(int(tok)).encode())
    elif isinstance(tok, (float, np.floating)):
        h.update(b"\x00F" + repr(float(tok)).encode())
    elif isinstance(tok, str):
        h.update(b"\x00S" + str(len(tok)).encode() + b":" + tok.encode())
    elif isinstance(tok, bytes):
        h.update(b"\x00Y" + str(len(tok)).encode() + b":" + tok)
    elif isinstance(tok, (tuple, list, frozenset)):
        items = sorted(tok, key=repr) if isinstance(tok, frozenset) \
            else tok
        h.update(b"\x00T" + str(len(items)).encode())
        for t in items:
            _feed(h, t)
        h.update(b"\x00t")
    elif isinstance(tok, np.generic):
        _feed(h, tok.item())
    else:
        raise UnsupportedToken(f"unhashable provenance token {tok!r}")


def digest(*tokens) -> bytes:
    """16-byte typed digest of a token tree (raises UnsupportedToken)."""
    h = hashlib.blake2b(digest_size=16)
    for tok in tokens:
        _feed(h, tok)
    return h.digest()


def try_digest(*tokens) -> Optional[bytes]:
    """`digest`, or None when any token is outside the vocabulary."""
    try:
        return digest(*tokens)
    except UnsupportedToken:
        return None


def chain(sig: Optional[bytes], event) -> Optional[bytes]:
    """Append one mask-mutation event to a vertex's state chain.
    None (unknown state) absorbs: once unknown, always unknown."""
    if sig is None:
        return None
    return try_digest("evt", sig, event)


def filter_sig(state_sig: Optional[bytes], cols, nblocks: int, k: int,
               minmax: bool = False) -> Optional[bytes]:
    """Identity of an emitted Bloom (+ optional min-max) filter: the
    source row-set state plus every parameter that shapes the bits."""
    if state_sig is None:
        return None
    return try_digest("bloom", state_sig, tuple(cols), int(nblocks),
                      int(k), bool(minmax))


def callable_fp(fn) -> Optional[tuple]:
    """Token tree identifying a python callable's behavior: bytecode,
    consts, names, and captured closure-cell values. Stable for the
    plan-construction lambdas (e.g. `substring`'s start/length capture);
    None for anything opaque (builtins, partials, C callables)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    toks = ["fn", code.co_code, tuple(code.co_names),
            tuple(code.co_varnames[:code.co_argcount])]
    consts = []
    for c in code.co_consts:
        if hasattr(c, "co_code"):        # nested code object (inner def)
            consts.append(("code", c.co_code, tuple(c.co_names)))
        else:
            consts.append(c)
    toks.append(tuple(consts))
    cells = []
    for cell in (fn.__closure__ or ()):
        try:
            cells.append(cell.cell_contents)
        except ValueError:               # empty cell
            cells.append(("empty-cell",))
    toks.append(tuple(cells))
    return tuple(toks)

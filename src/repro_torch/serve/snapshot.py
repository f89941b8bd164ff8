"""Warm-restart cache snapshots (DESIGN.md §16).

A drained `QueryServer` can serialize its cache tier — artifact cache,
plan cache, selectivity history — to one file, and a freshly
constructed server can absorb it so the *first* post-restart query
replays warm instead of recomputing every filter and slot state.

The hard part is identity. Cache keys embed `Table.version` numbers,
which are process-local counters — a restarted process builds the same
catalog under different numbers, and blindly reusing snapshot entries
would marry artifacts to the wrong data. Restore therefore re-verifies
provenance end to end:

1. **File integrity** — the payload travels behind a magic header and
   an md5 signature; a mismatch (bit rot, truncation, an injected
   ``snapshot.load`` fault) drops the whole snapshot and the server
   starts cold. Corruption is a counted, non-fatal event.
2. **Catalog identity** — the snapshot records every referenced
   catalog table's ``(version, table_digest)``. A current catalog
   table whose digest matches **re-adopts** the snapshot's version
   number (after `bump_version_floor` guarantees the number can never
   be handed out again, and any unrelated table squatting on it is
   re-versioned first); a table that changed — or disappeared —
   invalidates every entry derived from its recorded version.
3. **Entry integrity** — each artifact's stored content checksum is
   recomputed on absorb (`ArtifactCache.absorb`); rows whose bytes no
   longer match are dropped and counted, never served.

Within one process (drain → restart the server object) versions
already match and steps 2–3 degenerate to cheap equality checks; the
digest walk is what makes the cross-process path safe.

In the port every cached artifact is a host value (filter words are
downloaded before they are cached, slot states are host tables and
keys), so a snapshot written on the card loads on a machine without
one. The format is the port's own; the reference's files are not read.
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
from typing import Mapping, Optional

from repro_torch.core import faultinject

#: file magic; bump when the payload layout changes (older snapshots
#: are then dropped as corrupt — a cold start, never a crash)
_MAGIC = b"RSNAP1\n"
FORMAT_VERSION = 1


def write_snapshot(path: str, catalog: Mapping[str, object],
                   artifact_cache=None, plan_cache=None,
                   sel_history=None) -> dict:
    """Serialize the cache tier to `path` (atomic rename). Returns
    counts of what was written."""
    from repro_torch.relational.table import table_digest
    referenced = set()
    artifacts = artifact_cache.export_entries() \
        if artifact_cache is not None else []
    for row in artifacts:
        referenced |= set(row[3])          # versions
    plans = plan_cache.export_entries() if plan_cache is not None else []
    sels = sel_history.export_entries() if sel_history is not None else []
    for key, _ in list(plans) + list(sels):
        referenced |= {v for _, v in key[1]}   # cat_sig versions
    by_version = {t.version: name for name, t in catalog.items()}
    tables = {}
    for v in sorted(referenced):
        name = by_version.get(v)
        if name is not None:
            tables[name] = (v, table_digest(catalog[name]))
    doc = {
        "format": FORMAT_VERSION,
        "tables": tables,
        "artifacts": artifacts,
        "plans": plans,
        "sels": sels,
    }
    buf = io.BytesIO()
    pickle.dump(doc, buf, protocol=pickle.HIGHEST_PROTOCOL)
    payload = buf.getvalue()
    sig = hashlib.md5(payload).hexdigest().encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC + sig + b"\n" + payload)
    os.replace(tmp, path)
    return {"path": path, "bytes": len(payload),
            "artifacts": len(artifacts), "plans": len(plans),
            "sels": len(sels), "tables": len(tables)}


def load_snapshot(path: str, catalog: Mapping[str, object],
                  artifact_cache=None, plan_cache=None,
                  sel_history=None) -> dict:
    """Absorb a snapshot into the given caches. Never raises for bad
    snapshots: any integrity failure reports ``loaded: False`` (cold
    start). Mutates matching catalog tables' `version` to the
    snapshot's recorded numbers (see module docstring) — call before
    serving any query from this catalog."""
    from repro_torch.relational.table import bump_version_floor, table_digest
    out = {"loaded": False, "reason": None, "artifacts": 0,
           "artifacts_dropped": 0, "plans": 0, "sels": 0,
           "tables_matched": 0, "tables_stale": 0}
    try:
        with open(path, "rb") as f:
            raw = f.read()
        faultinject.fire("snapshot.load")
        if not raw.startswith(_MAGIC):
            out["reason"] = "bad-magic"
            return out
        head, _, payload = raw[len(_MAGIC):].partition(b"\n")
        if hashlib.md5(payload).hexdigest().encode() != head:
            out["reason"] = "signature-mismatch"
            return out
        doc = pickle.loads(payload)
        if doc.get("format") != FORMAT_VERSION:
            out["reason"] = f"format-{doc.get('format')!r}"
            return out
    except FileNotFoundError:
        out["reason"] = "missing"
        return out
    except Exception as e:                 # injected fault, bad pickle
        out["reason"] = f"corrupt:{type(e).__name__}"
        return out

    # -- catalog identity: re-adopt digest-verified versions -----------
    matched = {}                           # name -> snapshot version
    for name, (ver, digest) in doc["tables"].items():
        t = catalog.get(name)
        if t is not None and table_digest(t) == digest:
            matched[name] = int(ver)
        else:
            out["tables_stale"] += 1
    valid = set(matched.values())
    if doc["tables"]:
        bump_version_floor(max(v for v, _ in doc["tables"].values()))
    # move any unrelated current table off a number we are re-adopting
    # (fresh-process counters can collide across table identities)
    from repro_torch.relational.table import _next_version
    for name, t in catalog.items():
        if t.version in valid and matched.get(name) != t.version:
            t.version = _next_version()
    for name, ver in matched.items():
        catalog[name].version = ver
    out["tables_matched"] = len(matched)

    def _versions_ok(versions) -> bool:
        return all(int(v) in valid for v in versions)

    if artifact_cache is not None:
        rows = [r for r in doc["artifacts"] if _versions_ok(r[3])]
        kept, dropped = artifact_cache.absorb(rows)
        out["artifacts"] = kept
        out["artifacts_dropped"] = (len(doc["artifacts"]) - len(rows)
                                    + dropped)
    if plan_cache is not None:
        rows = [(k, v) for k, v in doc["plans"]
                if _versions_ok(ver for _, ver in k[1])]
        out["plans"] = plan_cache.absorb(rows)
    if sel_history is not None:
        rows = [(k, v) for k, v in doc["sels"]
                if _versions_ok(ver for _, ver in k[1])]
        out["sels"] = sel_history.absorb(rows)
    out["loaded"] = True
    return out


def restore_if_present(path: Optional[str], catalog, artifact_cache=None,
                       plan_cache=None, sel_history=None) -> Optional[dict]:
    """`load_snapshot` if `path` names an existing file, else None."""
    if not path or not os.path.exists(path):
        return None
    return load_snapshot(path, catalog, artifact_cache=artifact_cache,
                         plan_cache=plan_cache, sel_history=sel_history)

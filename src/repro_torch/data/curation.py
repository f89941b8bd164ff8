"""Training-data curation as a multi-join query with predicate transfer.

LM data curation is relationally shaped exactly like TPC-H's selective
multi-joins (DESIGN.md §4): select document chunks whose document passes
quality/license filters, whose dedup cluster is clean, and whose source
domain is admitted:

    chunks ⋈ documents ⋈ quality ⋈ dedup_clusters ⋈ domains

with highly selective local predicates on quality / dedup / domains. The
pipeline runs the paper's predicate-transfer phase over this join graph
before materializing any join, then packs surviving chunks into training
batches. `strategy` is pluggable, so the same pipeline doubles as an
ablation harness (benchmarks report curation throughput per strategy).

In the port the query runs on the cuda backends, on the card by default
(`device="cuda"`; `"cpu"` runs the kernels' plain versions, for tests);
`device=None` runs the numpy backends, the host mirror.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.transfer import BACKEND_AWARE, Strategy, make_strategy
from repro_torch.relational import ExecConfig, Executor, Table, col
from repro_torch.relational.plan import Join, Project, Scan, Sort


def synthetic_corpus(n_docs: int = 20_000, chunks_per_doc: int = 8,
                     vocab: int = 50_000, chunk_len: int = 128,
                     seed: int = 0) -> Dict[str, Table]:
    """Synthetic curation catalog with realistic selectivities."""
    rng = np.random.default_rng(seed)
    n_chunks = n_docs * chunks_per_doc
    n_clusters = max(n_docs // 4, 1)
    n_domains = 64

    docs = Table.from_arrays({
        "doc_id": np.arange(n_docs, dtype=np.int64),
        "doc_domain": rng.integers(0, n_domains, n_docs).astype(np.int64),
        "doc_cluster": rng.integers(0, n_clusters, n_docs).astype(np.int64),
        "doc_lang": rng.integers(0, 20, n_docs).astype(np.int64),
    }, "documents")
    quality = Table.from_arrays({
        "q_doc_id": np.arange(n_docs, dtype=np.int64),
        "q_score": rng.random(n_docs),
        "q_toxicity": rng.random(n_docs),
    }, "quality")
    clusters = Table.from_arrays({
        "cl_id": np.arange(n_clusters, dtype=np.int64),
        "cl_dup_frac": rng.random(n_clusters),
    }, "dedup_clusters")
    domains = Table.from_arrays({
        "dom_id": np.arange(n_domains, dtype=np.int64),
        "dom_allowed": (rng.random(n_domains) < 0.4).astype(np.int64),
        "dom_weight": rng.random(n_domains),
    }, "domains")
    chunks = Table.from_arrays({
        "ch_id": np.arange(n_chunks, dtype=np.int64),
        "ch_doc_id": np.repeat(np.arange(n_docs, dtype=np.int64),
                               chunks_per_doc),
        "ch_offset": np.tile(np.arange(chunks_per_doc, dtype=np.int64),
                             n_docs),
        # token payload is materialized lazily in practice; here a seed
        "ch_seed": rng.integers(0, 2**31, n_chunks).astype(np.int64),
    }, "chunks")
    return {"documents": docs, "quality": quality,
            "dedup_clusters": clusters, "domains": domains,
            "chunks": chunks}


def curation_plan(min_quality: float = 0.7, max_toxicity: float = 0.5,
                  max_dup: float = 0.3):
    """The curation join plan (local predicates pushed to the leaves)."""
    chunks = Scan("chunks")
    docs = Scan("documents")
    quality = Scan("quality",
                   filter=(col("q_score") >= min_quality)
                   & (col("q_toxicity") <= max_toxicity))
    clusters = Scan("dedup_clusters",
                    filter=col("cl_dup_frac") <= max_dup)
    domains = Scan("domains", filter=col("dom_allowed") == 1)
    j = Join(docs, quality, ["doc_id"], ["q_doc_id"])
    j = Join(j, clusters, ["doc_cluster"], ["cl_id"])
    j = Join(j, domains, ["doc_domain"], ["dom_id"])
    j = Join(chunks, j, ["ch_doc_id"], ["doc_id"])
    j = Project(j, {"ch_id": col("ch_id"), "ch_doc_id": col("ch_doc_id"),
                    "ch_offset": col("ch_offset"),
                    "ch_seed": col("ch_seed"),
                    "dom_weight": col("dom_weight")})
    return Sort(j, [("ch_id", True)])


@dataclasses.dataclass
class CurationStats:
    strategy: str
    seconds: float
    chunks_in: int
    chunks_out: int
    join_input_rows: int


class CurationPipeline:
    """Curation query -> token batches for the training loop.

    `device` is the torch device the cuda bloom and join backends run
    on; None runs the numpy backends. A `Strategy` instance is used as
    given, a strategy name is built for `device` (only the strategies in
    `BACKEND_AWARE` take a bloom backend)."""

    def __init__(self, catalog: Dict[str, Table],
                 strategy: str | Strategy = "pred-trans",
                 vocab: int = 50_000, chunk_len: int = 128,
                 device: Optional[str] = "cuda",
                 **plan_kw):
        self.catalog = catalog
        self.device = device
        if isinstance(strategy, Strategy):
            self.strategy = strategy
        elif device is not None and strategy in BACKEND_AWARE:
            self.strategy = make_strategy(strategy, backend="cuda",
                                          device=device)
        else:
            self.strategy = make_strategy(strategy)
        self.vocab = vocab
        self.chunk_len = chunk_len
        self.plan_kw = plan_kw
        self._selected: Optional[Table] = None
        self.stats: Optional[CurationStats] = None

    def select(self) -> Table:
        t0 = time.perf_counter()
        cfg = ExecConfig(strategy=self.strategy) if self.device is None \
            else ExecConfig(strategy=self.strategy, join_backend="cuda",
                            torch_device=self.device)
        ex = Executor(self.catalog, cfg)
        out, st = ex.execute(curation_plan(**self.plan_kw))
        self.stats = CurationStats(
            strategy=self.strategy.name,
            seconds=time.perf_counter() - t0,
            chunks_in=len(self.catalog["chunks"]),
            chunks_out=len(out),
            join_input_rows=st.join_input_rows())
        self._selected = out
        return out

    def batches(self, batch_size: int, seq_len: Optional[int] = None,
                seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (tokens, targets) arrays packed from selected chunks.
        Token payloads are deterministically derived from ch_seed (the
        stand-in for a tokenized shard fetch)."""
        if self._selected is None:
            self.select()
        sel = self._selected
        seq_len = seq_len or self.chunk_len
        n = len(sel)
        order = np.random.default_rng(seed).permutation(n)
        seeds = sel.array("ch_seed")[order]
        for i in range(0, n - batch_size + 1, batch_size):
            bs = seeds[i: i + batch_size]
            toks = np.stack([
                np.random.default_rng(int(s)).integers(
                    0, self.vocab, seq_len) for s in bs]).astype(np.int32)
            targets = np.roll(toks, -1, axis=1)
            targets[:, -1] = -1
            yield toks, targets

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1.0] [--phase all|kernels]

`--phase kernels` runs phases 1-4 only (to iterate on a kernel), then
each Bloom and hash-map case's device time alone, the route sweeps of
K2 and K4, the rows-a-thread sweep of K3 and the plan sweep of K7, and
prints neither the kernel table nor the ok line.

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — the card's name and, from nvidia-smi, name and power limit;
2. build   — compiles the hand-written CUDA kernels from the sources in
             the checkout (one nvcc per source, started together);
3. kernels — each Bloom kernel (K1 fused multi-filter probe, K2 build,
             K3 single-filter probe) against its plain torch version on
             the card, at the shapes TPC-H SF 1 gives them: 2^23-row
             (lineitem's bucket) and 2^21-row key columns, filters sized
             for 1.5 M and 6 M keys plus a one-block filter, ragged
             counts, survivor-id gathers, and K3 at the plane-off path's
             most frequent shape (`K3_PATH_CASE`). As on the main path, each
             filter of a K1 call probes its own key column, and each
             filter is built from its own build-side keys; K2 also at a
             skew (6 M keys whose hashes all fall in one of the 256
             slices K2's partitioned build cuts the filter into, so all
             but one slice's share go to its overflow list), and at
             2^17 keys, on its direct route. Results must be bit-exact.
             Median CUDA-event times of kernel and plain version, and
             the bound (bytes moved over the H100's 3.35 TB/s; K1's and
             K3's key columns counted as the 32-byte sectors that hold a
             row still live before the filter, `gathered_sector_bytes`).
             With `--phase kernels` only, after phase 4: each case's
             device time alone (torch.profiler, `device_times`) and a
             sweep of K2's direct and partitioned routes, each forced,
             at 2^14 to 2^20 keys (`route_sweep`);
4. joinmap — the hash-map join kernels (K4 build, K5 lookup) at the
             orders shape of SF 1: 1,500,000 distinct keys in 2^22
             slots, probed by 6,001,215 lineitem-like keys. K4's
             occupied count must equal the distinct count and the plain
             sequential build's (run on CPU copies: a step-by-step build
             on the card would eat the time limit); K5's rows must equal
             the plain lookup over the same K4 table at every shape, and
             at SF 1 a sort-and-searchsorted expectation too, and at the
             plane-off path's most frequent lookup shape
             (`K5_PATH_CASE`); a build
             with duplicate keys must count its distinct keys, and one of
             2^20 keys crowded at a region's tail, at the last region's
             wrap into slot 0 and past a region's part of K4's scratch
             (`crowded_keys`, K4's partitioned route) must find each
             key's last row. Times and bounds as in phase 3, the
             lookup's table reads counted as the distinct 32-byte
             sectors its probe walks touch. With `--phase kernels`
             only: each case's device time and device ops alone (a
             memset and each kernel apart) and a sweep of K4's direct
             and partitioned routes (regions of 2^11 to 2^13 slots),
             each forced, at 2^12 to 2^21 keys (`joinmap_route_sweep`);
   Phases 3 and 4 also hold the kernels behind the kernel library's
   public entry points against their plain versions, on the SF 1
   columns of phase 6's cases: K7 (fused filter transfer) at case C's
   shape (lineitem's 6,000,205 rows through a 16,384-block orders
   filter into a 524,288-block one: the partitioned route), the same
   with every outgoing key distinct, its first 2^20 rows (the L2 route)
   and a ragged shape into 8 blocks (the tiny route; `transfer_cases`,
   each line names the route the rule takes); with `--phase kernels`
   only, K7 at 2^16 to 2^23 rows and into filters of at most 64 blocks,
   foreign and distinct outgoing keys, with each route (L2, tiny or
   partitioned) forced (`transfer_sweep`; each case's device ops name
   the outgoing filter's zeroing apart from the kernels); K6a/K6b
   (key set build and membership probe) at case A's (1.5 M orders keys,
   2^22 slots, probed by lineitem's order keys), each beside a small
   ragged shape (their
   bounds count the key halves they load, of the masked or surviving
   rows, as the distinct 32-byte sectors that hold them); K6a's
   occupied count against the distinct count and the plain sequential
   build (CPU copies), K6b's mask against the plain probe over the same
   K6a table and against `torch.isin`, whose time is K6's
   `library_ms` (compare it with K6a + K6b together);
5. slice   — runs all 20 join queries of TPC-H at `--sf` (seed 7,
             generated once before phase 3) through `Executor` with the
             cuda bloom and join backends, three paths: `pred-trans`
             with the device-resident
             data plane on (`pred-trans`), `pred-trans-adaptive` on Q5
             with it on (`pred-trans-adaptive`), and `pred-trans` with it
             off (`pred-trans-plane-off`: per-filter probes, hash-map
             joins). Every result must have the md5 (`table_digest`) of
             the port's eager numpy oracle. Each path reads its own
             kernel launch counts: they are zeroed just before the path's
             runs (cold and warm) and read just after; the plane-on paths
             must launch K1 and K2, the plane-off path K2, K3, K4 and K5
             and never K1, and the plane-on sweep never K3, K4 or K5. A
             `compare` line sets each query's warm seconds and round
             trips on the two planes side by side. During the warm
             `pred-trans` runs a wrapper around K1's and K2's wrappers
             counts each call's shape (live rows to a power of two,
             nblocks, K1's m) into one `shapes` line, and during the warm
             plane-off runs one around K4's and K5's (keys to a power of
             two, table slots) and K3's (live rows to a power of two,
             nblocks, gather or not) into another. Then one warm run each
             of Q5 and Q9 on each plane under torch.profiler (device busy
             seconds, idle share, top device ops), after every reading;
6. kernel-api — path `kernel-api`: the kernel library's public entry
             points on the same catalog, each case cold then warm, the
             launch counts zeroed before and read after. (A) Q5's
             lineitem ⋉ σ(orders): `semi_mask(l_orderkey, o_orderkey,
             o_orderdate in 1994)` == `semi_mask_ref` == `torch.isin`;
             (B) Q4's EXISTS, orders ⋉ σ(lineitem), duplicate build keys:
             `semijoin_build(l_orderkey, l_commitdate < l_receiptdate)`
             holds as many keys as `np.unique` finds, and
             `semijoin_probe(.., o_orderkey)` == `semi_mask_ref`; (C) Q5's
             transfer chain σ(orders) → lineitem → supplier:
             `bloom_build`, `bloom_transfer` and `bloom_probe`, the
             transfer's survivors and words bit-exact against the plain
             version on the card and a superset of (A)'s mask, the probe
             equal to the plain probe with no false negative. The path
             must launch K2, K3, K6a, K6b and K7 and never K1, K4 or K5;
             the three engine paths never launch K6a, K6b or K7.
6a. serve-tpch — path `serve-tpch`: the serving layer on the card over
             the same catalog. `QueryServer` (`pred-trans`, the cuda
             backends, 4 workers, a queue of 64) takes the 20 join
             queries twice in a shuffle seeded 1234, all submitted, then
             awaited: a cold pass, then a warm pass on the same server,
             then 4 `Session` clients on 4 threads (2 `pred-trans`, 2
             `pred-trans-adaptive`) each submitting the 20. Every result
             must have phase 5's eager-oracle md5. Each pass prints its
             wall seconds, queries a second, the server's p50/p99, its
             slot- and filter-cache hits, its summed `report()["device"]`
             round trips and its K1/K2 launches; K1 and K2 must launch in
             the cold pass and fewer times in the warm one, K3-K8 never.
             Then `drain_to_snapshot` to a temporary file: a new server
             restored from it must answer Q5 first from the cache
             (`transfer.from_cache`), md5-equal, with no K1/K2 launch; and
             `update_table("orders", <the same data, a new version>)`
             must drop entries, after which Q5 must launch K2 again and
             stay md5-equal. The path's count sums every window.
6b. curation — path `curation`: `CurationPipeline` on the card
             (`pred-trans`, 100,000 documents, 800,000 chunks: the size of
             `benchmarks/curation_bench.py`); its selection must have the
             md5 of the numpy backends' `pred-trans` and `no-pred-trans`
             selections, and it must launch K1 and K2 (K3-K8 never).
7. attention — K8 (flash attention, bf16) against its plain version
             `flash_plain` and the dense oracle `sdpa_ref` on the card,
             within atol = rtol = 2e-2 (the reference's bf16 tolerance),
             one line per shape: qwen1.5-4b's prefill (B 4, Sq 2048, Skv
             2088, 20 heads, d 128, causal, the ring-cache positions of a
             fresh prefill), the same shape on a ring that has wrapped
             (kv_pos not monotone), minitron-4b's 24/8 GQA heads, d 64
             with a window of 64 and ragged validity (rows that see no key
             included), a non-causal shape; and decode (Sq 1): qwen1.5-4b
             at position 2080 (the serve path's shape), the same on a
             wrapped ring, at B 1 over 32,768 slots (Qwen1.5-4B's context
             length: 40 splits of 13 64-key tiles), minitron-4b's 24/8
             GQA at B 2, and d 64 with a window of 64 (31 of 33 tiles
             skipped), then MLA's head sizes (deepseek-v2-lite-16b:
             16 heads, q/k 192, v 128) at its serve shapes, prefill and
             decode, each fresh and on a wrapped ring. A decode line must
             also lie within two bf16 ulps
             of the largest output of each reference (`decode_limit`).
             Each line's bound is the larger of 2*(D + Dv) flops per
             unmasked (q, k) pair over 989 TFLOP/s and the bytes these
             inputs need
             over 3.35 TB/s: q, o and the positions once, K at the kv
             slots some query row may see, V there too, or at every slot
             when some row sees none (it averages all of V); its library
             time is `torch.nn.functional.scaled_dot_product_attention`
             with the same boolean mask (and `enable_gqa`); beside the
             CUDA-event times, each call's device time alone from
             torch.profiler (at Sq 1 the host's dispatch can outlast the
             kernels); each line adds its registers and spills from
             nvcc's ptxas log; a prefill line adds the kernel's device
             TFLOP/s (unmasked flops over its device time) and its shared
             memory a CTA, a decode line its device GB/s (the bytes above
             over its device time);
8. serve   — path `serve`: `repro_torch.launch.serve.serve` runs
             qwen1.5-4b at its full config (40 layers, d_model 2560,
             random weights from seed 0) with batch 4, a 2048-token
             random prompt (seed 1) and 32 greedy tokens: one warm-up
             pass, one timed pass (prefill seconds and tok/s, decode
             ms/token and tok/s, peak device memory). Inside the path's
             launch-count window K8 must launch 40 times per prefill call
             and 40 times per decode step, and K1-K7 never; the engine
             and kernel-api paths never launch K8. Then the check:
             the greedy run's tokens, fed to the same model with the
             attention backend "auto" (plain torch dense attention, no
             K8 launch), must give the prefill's and every step's logits
             within the tolerance stated at `TF_MAX_ABS`; the greedy
             argmax agreement is reported. Last, one prefill and one
             decode step under torch.profiler (device busy share, top
             device ops), outside every counted window;
9. serve-deepseek — path `serve-deepseek`: the same for
             deepseek-v2-lite-16b at its full config (27 layers, d_model
             2048, MLA with 16 heads of q/k 192 and v 128, 64 routed
             experts top-6 and 2 shared, the first layer dense; 15.7 B
             parameters, 31.4 GB of bf16) at the same batch, prompt and
             tokens, once qwen1.5-4b's model is freed and the peak
             memory reset: K8 launches 27 times per prefill call and per
             decode step (every layer is MLA) and K1-K7 never; the
             teacher-forced check within `TF_MLA_MAX_ABS` and
             `TF_MLA_MEAN_ABS`, and the share of (token, layer) routing
             choices whose experts differ between the flash run and the
             "auto" run (`route_differing_share`).
f32 matmuls run with TF32 off (`torch.backends.cuda.matmul.allow_tf32 =
False`) throughout, so the plain versions and oracles sum in f32.

The line before the last is the kernel table (K8's MLA shapes in rows
of their own, `flash_prefill_mla` and `flash_decode_mla`, whose
launches are path `serve-deepseek`'s)
`{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "plain_device", "bound_ms", "bound_by",
"library_ms", "launches_by_path"}]}` (`plain_device` says where
`plain_ms` was taken: "cuda" for CUDA-event times on the card, "cpu" for
the sequential K4 and K6a builds timed on the host; K6's and K8's rows
add `library_call`, what `library_ms` timed; K8's rows add `device_ms`
and `library_device_ms`, the device time alone of a call of each, read
from torch.profiler)
and the last line is `{"ok": true, "device": {...}}`. Without CUDA, or
without the repository's `src/` beside it, the script exits non-zero
before printing any result. Imports torch, numpy and `repro_torch` only.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
#: published HBM3 rate of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: published dense bf16 tensor-core rate of one H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12
#: serve path: qwen1.5-4b at its published widths, serve_lm.py's batch, a
#: 2048-token prompt and 32 greedy tokens (cap = 2048 + 32 + 8 = 2088)
SERVE = {"arch": "qwen1.5-4b", "config": "full", "batch": 4,
         "prompt_len": 2048, "gen_tokens": 32}
#: The teacher-forced check of the serve path: the flash run's logits
#: against the same model's with dense attention ("auto"), fed the same
#: tokens. Both runs compute in bf16 with the same matmuls, so they differ
#: only where the attention rounds: the online softmax rounds p to bf16
#: relative to a running max, the dense path the normalised
#: probabilities, and each attention output is rounded to bf16 and
#: carried through 40 residual layers. At init the logits have std ~1
#: (unembed scale 0.02 * sqrt(2560)) and |max| ~5, where one bf16 ulp is
#: 2^-5 = 0.031. Measured on the CPU with `flash_plain` at qwen1.5-4b's
#: full width (batch 2, prompt 256, 6 steps): max |d| 0.063 / mean 0.010
#: at 4 layers, 0.086 / 0.013 at 12; extrapolated to 40 layers, about
#: 0.12 / 0.02. The bounds leave twice that: a wrong mask, head mapping or
#: position moves logits by their own scale (~1), far above them.
TF_MAX_ABS = 0.25
TF_MEAN_ABS = 0.04
#: serve-deepseek: deepseek-v2-lite-16b at its published widths, the same
#: batch, prompt and tokens as SERVE
SERVE_MLA = {**SERVE, "arch": "deepseek-v2-lite-16b"}
#: Its teacher-forced check. Under a routed MoE a rounding difference can
#: flip a token's top-6 experts, a discrete jump that then cascades: on
#: the CPU (`tools/tf_gap.py`, flash_plain, full width, batch 2, prompt
#: 256, 6 steps) the dense run routing on its own lies max |d| 0.051 /
#: 0.34 / 0.76 and mean 0.0084 / 0.055 / 0.114 from the flash run at 2 /
#: 4 / 8 layers, with 5%, 8% and 14% of (token, layer) choices flipped:
#: at 27 layers a wrong mask would hide in that. So the gated check gives
#: the dense run the flash run's routing choices (`record_routes`'s
#: replay), and the two then differ only where attention rounds: max
#: 0.050 / 0.0625 / 0.078 and mean 0.0084 / 0.0107 / 0.0125 at 2 / 4 / 8
#: layers, about 0.11 / 0.016 at 27 by the same growth a doubling; the
#: bounds leave twice that, the same as qwen1.5-4b's. The run that routes
#: on its own is reported, with its share of flipped choices.
TF_MLA_MAX_ABS = 0.25
TF_MLA_MEAN_ABS = 0.04
#: the reference's bf16 tolerance for the flash kernel
#: (tests/test_kernels_flash.py)
FLASH_TOL = 2e-2
#: bf16 ulps of the largest output a decode line may differ by: K8 decode
#: and its references round f32 values that differ by far less than an
#: ulp, so each output lands within one ulp of the largest output; at a
#: long cache the outputs (averages of v over the cache) are as small as
#: FLASH_TOL, while a split left out or misweighted moves them by a share
#: of their own scale, well past two ulps
DECODE_ULPS = 2
FLASH = ("flash_prefill", "flash_decode")
#: the kernel table's rows of K8 at MLA's head sizes (launched as FLASH)
FLASH_MLA = ("flash_prefill_mla", "flash_decode_mla")


def launched(row: str) -> str:
    """The launch counter a kernel-table row reads: an MLA row counts its
    variant's launches (on its own path)."""
    return row.removesuffix("_mla")
#: TPC-H SF 1 shapes: lineitem's rows pad to the 2^23 bucket; filters are
#: sized for the orders-sized (1.5 M) and lineitem-sized (6 M) key sets
N_BIG, N_MID = 1 << 23, 1 << 21
KEYS_ORDERS, KEYS_LINEITEM = 1_500_000, 6_000_000
#: the three key columns K1 probes, one per filter, each drawn on its own:
#: (value domain, distinct build-side keys, name). SF 1 orderkeys span
#: [0, 6 M) and 1.5 M of them build the orders-sized filter; 6 M keys over
#: [0, 24 M) build the lineitem-sized one; 5 of the 25 nation keys build a
#: one-block filter (a region's nations)
COLUMNS = ((6_000_000, KEYS_ORDERS, "orders"),
           (24_000_000, KEYS_LINEITEM, "lineitem"),
           (25, 5, "one-block"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int, warm: int = 2, per: int = 1) -> float:
    """Median CUDA-event milliseconds of `fn`: each sample times `per`
    calls back to back and divides (per > 1 keeps the host's launch
    overhead out of a kernel shorter than it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def sector_bytes(torch, sel) -> int:
    """Bytes of the 32-byte sectors of a 4-byte column that hold a row
    where `sel` (bool [n] on the card) is True: what a kernel that loads
    the column only at those rows must read of it (torch allocations are
    sector-aligned)."""
    pad = torch.zeros(-(-sel.numel() // 8) * 8, dtype=torch.bool,
                      device=sel.device)
    pad[: sel.numel()] = sel
    return 32 * int(pad.view(-1, 8).any(dim=1).sum())


def gathered_sector_bytes(torch, live, idx, ncol: int) -> int:
    """`sector_bytes` of a 4-byte key column of `ncol` rows read at the
    rows `live` (bool [n] on the card) selects, through survivor ids
    `idx` (int32 [n]) where given."""
    if idx is None:
        return sector_bytes(torch, live)
    sel = torch.zeros(ncol, dtype=torch.bool, device=live.device)
    sel[idx[live].long()] = True
    return sector_bytes(torch, sel)


def api_inputs(np, cat) -> dict:
    """The TPC-H columns of the kernel-api cases: (A) Q5's orders
    semi-join, (B) Q4's EXISTS, (C) Q5's transfer chain."""
    from repro_torch.tpch.gen import date
    o, li = cat["orders"], cat["lineitem"]
    o_date = o.array("o_orderdate")
    return {"o_orderkey": o.array("o_orderkey").astype(np.int64),
            "l_orderkey": li.array("l_orderkey").astype(np.int64),
            "l_suppkey": li.array("l_suppkey").astype(np.int64),
            "s_suppkey": cat["supplier"].array("s_suppkey").astype(np.int64),
            "q5": (o_date >= date("1994-01-01"))
            & (o_date < date("1995-01-01")),
            "q4": li.array("l_commitdate") < li.array("l_receiptdate")}


def keys_with_hashes(np, h, hi):
    """int64 keys whose high halves are `hi` (uint32) and whose hash
    (`hashing.hash64_np` of their halves: lo ^ fmix32(hi), mixed by
    fmix32) is `h` (uint32): fmix32 undone step by step (each step is a
    bijection on uint32; an odd multiplier has an inverse mod 2^32)."""
    from repro_torch.core import hashing
    lo = np.asarray(h).astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        lo ^= lo >> np.uint32(16)
        lo *= np.uint32(pow(0xC2B2AE35, -1, 1 << 32))
        lo ^= (lo >> np.uint32(13)) ^ (lo >> np.uint32(26))
        lo *= np.uint32(pow(0x85EBCA6B, -1, 1 << 32))
        lo ^= lo >> np.uint32(16)
    lo ^= hashing.fmix32_np(hi)
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint64)).view(np.int64)


def skewed_keys(np, rng, n: int):
    """n int64 keys whose hashes all lie below 2^24, so in the first of
    the 256 slices K2's partitioned build cuts a 2^12- to 2^19-block
    filter into: hashes drawn there, keys built back from them."""
    h = rng.integers(0, 1 << 24, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return keys_with_hashes(np, h, hi)


def region_cap(n: int, log2p: int, log2r: int) -> int:
    """Keys a region's part of K4's scratch holds on its partitioned
    route (`region_cap` in semijoin.cu): 5/4 of the mean, plus 256, at
    most the region's slots."""
    return min((n >> log2p) + (n >> (log2p + 2)) + 256, 1 << log2r)


def crowded_keys(np, rng, n: int, cap: int, log2r: int = 13):
    """n int64 keys for a K4 table of `cap` slots cut into regions of
    2^log2r slots (its partitioned route), built back from chosen home
    slots (`keys_with_hashes`): min(n / 8, 256) keys homed in the last 32
    slots of region 0 (their walks run past its end), as many in the last
    32 slots of the table (the last region's walks wrap into slot 0),
    256 more than its part of the scratch holds homed anywhere in region
    1 (when the table has one), the rest homed outside region 1; one key
    in 8 of the rest is repeated at a later row (the last row wins)."""
    log2cap = cap.bit_length() - 1
    log2r = min(log2r, log2cap)
    nslots = 1 << log2r
    crowd = min(n // 8, 256)
    over = (region_cap(n, log2cap - log2r, log2r) + 256
            if cap > nslots else 0)
    rest = n - 2 * crowd - over
    ndup = rest // 8
    rest -= ndup
    check(rest > 0, f"crowded_keys: {n} keys are too few")
    homes = [nslots - 32 + rng.integers(0, 32, crowd),
             cap - 32 + rng.integers(0, 32, crowd),
             nslots + rng.integers(0, nslots, over)]
    spread = rng.integers(0, cap - nslots if over else cap, rest)
    homes.append(np.where((spread >= nslots) & (over > 0),
                          spread + nslots, spread))
    home = np.concatenate(homes).astype(np.uint64)
    top = rng.integers(0, 1 << 32, len(home), dtype=np.uint64)
    h = ((top << np.uint64(log2cap)) | home) & np.uint64(0xFFFFFFFF)
    keys = keys_with_hashes(np, h.astype(np.uint32),
                            rng.integers(0, 1 << 32, len(home),
                                         dtype=np.uint64).astype(np.uint32))
    keys = keys[rng.permutation(len(keys))]
    return np.concatenate([keys, rng.choice(keys, ndup)])


def probe_inputs(np, kb, bloom, dev):
    """The Bloom cases' key columns and filters, one of each per
    `COLUMNS` entry, on the card: (the generator, for the cases' further
    inputs; [(lo, hi)] [2^23] each; [int32 words])."""
    rng = np.random.default_rng(7)
    cols, filt = [], []
    for domain, nkeys, _ in COLUMNS:
        cols.append(bloom.keys_to_device(
            rng.integers(0, domain, N_BIG, dtype=np.int64), dev))
        blo, bhi = bloom.keys_to_device(
            rng.choice(domain, nkeys, replace=False), dev)
        # filters from the plain build, so K1's check does not lean on K2
        filt.append(kb.build_ref(blo, bhi, bloom.blocks_for(nkeys)))
    return rng, cols, filt


#: K3's cases at the plane-off path's shapes (its warm `shapes` line):
#: name -> (rows, live rows, key domain, build keys); the most frequent
#: (`K3_PATH_CASE`: 16,384 rows into a one-block filter, as a region's
#: nations build) and the heaviest (2^23 rows into 4,096 blocks), neither
#: through survivor ids
K3_PATH_CASES = {"16384 into 1 block": (1 << 14, 12_289, 25, 5),
                 "2^23 into 4096 blocks": (N_BIG, 6_001_215, 6_000_000,
                                           1 << 16)}
K3_PATH_CASE = "16384 into 1 block"


def k3_path_inputs(torch, np, kb, bloom, dev, case: str = K3_PATH_CASE):
    """One of `K3_PATH_CASES`: a key column of its rows over its domain
    and a filter built (plainly) from its build keys, drawn from the
    domain: (words, (lo, hi), idx None, live rows)."""
    n, count, domain, nkeys = K3_PATH_CASES[case]
    rng = np.random.default_rng(41)
    cols = bloom.keys_to_device(rng.integers(0, domain, n, dtype=np.int64),
                                dev)
    blo, bhi = bloom.keys_to_device(
        rng.choice(domain, nkeys, replace=False), dev)
    return kb.build_ref(blo, bhi, bloom.blocks_for(nkeys)), cols, None, count


def transfer_cases(torch, np, kb, bloom, dev, api) -> dict:
    """K7's cases, name -> `transfer` arguments (in_words, in lo, in hi,
    out lo, out hi, mask, nblocks_out) on the card: "SF 1 case C"
    (lineitem's rows probed on `l_orderkey` against the Q5-date orders
    filter, from the plain build, into a lineitem-sized filter of the
    survivors' `l_suppkey`: about 90 copies of each of 10,000 keys: the
    partitioned route), "case C distinct" (the same, every outgoing key
    distinct), "2^20 case C rows" (case C's first 2^20 rows into a
    filter sized for them: the L2 route) and "5003 ragged" (random keys,
    a 64-block incoming filter, 80% of rows masked, an 8-block outgoing
    filter: the tiny route)."""
    olo, ohi = bloom.keys_to_device(api["o_orderkey"], dev)
    q5 = torch.from_numpy(api["q5"]).to(dev)
    in_words = kb.build_ref(olo, ohi, bloom.blocks_for(int(api["q5"].sum())),
                            valid=q5)
    n_l = len(api["l_orderkey"])
    ilo, ihi = bloom.keys_to_device(api["l_orderkey"], dev)
    slo, shi = bloom.keys_to_device(api["l_suppkey"], dev)
    live = torch.ones(n_l, dtype=torch.bool, device=dev)
    nb = bloom.blocks_for(n_l)
    rng = np.random.default_rng(53)
    keys = rng.integers(0, 1 << 40, 5003).astype(np.int64)
    klo, khi = bloom.keys_to_device(keys[:1700], dev)
    few = min(n_l, 1 << 20)
    return {"SF 1 case C": (in_words, ilo, ihi, slo, shi, live, nb),
            "case C distinct": (in_words, ilo, ihi, *bloom.keys_to_device(
                np.arange(n_l, dtype=np.int64) + (1 << 33), dev), live, nb),
            "2^20 case C rows": (in_words, ilo[:few], ihi[:few], slo[:few],
                                 shi[:few], live[:few],
                                 bloom.blocks_for(few)),
            "5003 ragged": (kb.build_ref(klo, khi, 64),
                            *bloom.keys_to_device(keys, dev),
                            *bloom.keys_to_device(rng.integers(
                                0, 1 << 40, 5003).astype(np.int64), dev),
                            torch.from_numpy(rng.random(5003) < 0.8).to(dev),
                            8)}


#: K7's sweep: rows (2^16-2^23 into `blocks_for` blocks, and the outgoing
#: filters of at most 64 blocks the tiny route takes: rows, nblocks_out)
TRANSFER_SWEEP = ([(1 << log2n, None) for log2n in range(16, 24)]
                  + [(1024, 64), (4096, 64), (16384, 64), (5003, 8),
                     (1 << 16, 1)])
#: bloom_transfer_force's route codes (bloom.cu, K7's note)
TRANSFER_ROUTES = {1: "l2", 2: "tiny", 3: "partitioned"}


def transfer_sweep_cases(torch, np, kb, bloom, dev) -> dict:
    """K7 at `TRANSFER_SWEEP`'s shapes, name -> `transfer` arguments, with
    case C's proportions: incoming keys drawn from 1.5 M order keys and
    sorted (lineitem's rows come by order), every row live, probed against
    a 16,384-block filter of 228,000 of them drawn at random (Q5's 15%, so
    the survivors are spread over the rows); the survivors' outgoing keys
    either about 90 copies each ("foreign", as suppliers are) or all
    distinct."""
    rng = np.random.default_rng(67)
    blo, bhi = bloom.keys_to_device(
        rng.choice(KEYS_ORDERS, 228_000, replace=False), dev)
    in_words = kb.build_ref(blo, bhi, bloom.blocks_for(228_000))
    cases = {}
    for n, nb in TRANSFER_SWEEP:
        ilo, ihi = bloom.keys_to_device(
            np.sort(rng.integers(0, KEYS_ORDERS, n, dtype=np.int64)), dev)
        live = torch.ones(n, dtype=torch.bool, device=dev)
        nb = bloom.blocks_for(n) if nb is None else nb
        foreign = rng.integers(0, max(1, n * 152 // 1000 // 90), n,
                               dtype=np.int64)
        distinct = rng.permutation(n).astype(np.int64) + (1 << 33)
        for kind, out in (("foreign", foreign), ("distinct", distinct)):
            cases[f"{n} into {nb} {kind}"] = (
                in_words, ilo, ihi, *bloom.keys_to_device(out, dev), live,
                nb)
    return cases


def transfer_routes(nb: int) -> dict:
    """K7's routes into nb blocks, code -> name: the L2 route, and the
    tiny one (at most 64 blocks) or the partitioned one (more)."""
    return {route: TRANSFER_ROUTES[route]
            for route in ((1, 2) if nb <= 64 else (1, 3))}


def transfer_route(lib, n: int, nb: int) -> str:
    """The route K7's rule takes for n rows into nb blocks
    (`bloom_transfer_plan`)."""
    return TRANSFER_ROUTES[lib.bloom_transfer_plan(n, nb.bit_length() - 1)]


def kernel_phase(torch, np, kb, bloom, dev, api, later: list):
    """K1/K2/K3/K7 vs their plain versions on the card; returns the
    record of each kernel at the main path's heaviest shape (K7: case
    C's), and each kernel's largest error. Appends (record, call) for
    each case to `later` (unless None), for `device_times`."""

    def defer(rec, call):
        if later is not None:
            later.append((rec, call))

    def halves(keys):
        return bloom.keys_to_device(keys, dev)

    rng, cols, filt = probe_inputs(np, kb, bloom, dev)
    idx = torch.from_numpy(np.sort(rng.choice(N_BIG, N_MID, replace=False))
                           .astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(N_BIG) < 0.95).to(dev)
    worst = {"multi_probe": 0, "bloom_build": 0, "probe": 0,
             "bloom_transfer": 0}
    rep = {}

    def probe_case(name, which, n, count, ix):
        m = len(which)
        ws = [filt[c] for c in which]
        args = (ws, [cols[c][0] for c in which], [cols[c][1] for c in which])
        got = kb.multi_probe(*args, idx=ix, count=count)
        ref = kb.multi_probe_ref(*args, idx=ix, count=count)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        worst["multi_probe"] = max(worst["multi_probe"], err)
        check(torch.equal(got, ref), f"multi_probe {name} disagrees")
        # bytes the function must move: of each filter's own key column
        # (both halves), the 32-byte sectors that hold a row still live
        # before that filter (probing stops at the first miss), the
        # survivor ids, every filter once, and the [m, n] mask
        live = [torch.arange(n, device=dev) < count] + list(ref[:-1])
        alive = [int(x.sum()) for x in live]
        nbytes = (sum(2 * gathered_sector_bytes(torch, x, ix,
                                                int(cols[c][0].shape[0]))
                      for x, c in zip(live, which))
                  + (4 * count if ix is not None else 0)
                  + sum(w.numel() * 4 for w in ws) + m * n)
        ms = cuda_ms(torch, lambda: kb.multi_probe(*args, idx=ix,
                                                   count=count), 20)
        plain = cuda_ms(torch, lambda: kb.multi_probe_ref(
            *args, idx=ix, count=count), 3, warm=1)
        rec = {"kernel": "multi_probe", "case": name, "m": m, "n": n,
               "count": count, "filters": [COLUMNS[c][2] for c in which],
               "nblocks": [int(w.shape[0]) for w in ws],
               "alive": alive, "ms": ms, "plain_ms": plain,
               "plain_device": "cuda",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "survivors": int(ref[-1].sum()), "max_abs_err": err,
               "library_ms": None}
        emit({"phase": "kernels", **rec})
        defer(rec, lambda: kb.multi_probe(*args, idx=ix, count=count))
        return rec

    def single_case(name, words, col, n, count, ix, filter_name):
        args = (words, col[0], col[1])
        got = kb.probe(*args, idx=ix, count=count)
        ref = kb.probe_ref(*args, idx=ix, count=count)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        worst["probe"] = max(worst["probe"], err)
        check(torch.equal(got, ref), f"probe {name} disagrees")
        # the key halves' 32-byte sectors that hold a live row (gathered
        # through the survivor ids, which are read once), the filter once,
        # one mask byte per row
        live = torch.arange(n, device=dev) < count
        nbytes = (2 * gathered_sector_bytes(torch, live, ix,
                                            int(col[0].shape[0]))
                  + (4 * count if ix is not None else 0)
                  + words.numel() * 4 + n)
        ms = cuda_ms(torch, lambda: kb.probe(*args, idx=ix, count=count),
                     20)
        plain = cuda_ms(torch, lambda: kb.probe_ref(*args, idx=ix,
                                                    count=count), 3, warm=1)
        rec = {"kernel": "probe", "case": name, "n": n, "count": count,
               "filter": filter_name, "nblocks": int(words.shape[0]),
               "ms": ms, "plain_ms": plain, "plain_device": "cuda",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "survivors": int(ref.sum()), "max_abs_err": err,
               "library_ms": None}
        emit({"phase": "kernels", **rec})
        defer(rec, lambda: kb.probe(*args, idx=ix, count=count))
        return rec

    def build_case(name, col, nb, count, ix, v):
        lo, hi = cols[col]
        got = kb.build(lo, hi, nb, idx=ix, count=count, valid=v)
        ref = kb.build_ref(lo, hi, nb, idx=ix, count=count, valid=v)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        worst["bloom_build"] = max(worst["bloom_build"], err)
        check(torch.equal(got, ref), f"bloom_build {name} disagrees")
        nbytes = (8 * count + (4 * count if ix is not None else 0)
                  + (count if v is not None else 0) + nb * 32)
        ms = cuda_ms(torch, lambda: kb.build(lo, hi, nb, idx=ix,
                                             count=count, valid=v), 20)
        plain = cuda_ms(torch, lambda: kb.build_ref(
            lo, hi, nb, idx=ix, count=count, valid=v), 3, warm=1)
        rec = {"kernel": "bloom_build", "case": name, "n": count,
               "nblocks": nb, "ms": ms, "plain_ms": plain,
               "plain_device": "cuda",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "max_abs_err": err, "library_ms": None}
        emit({"phase": "kernels", **rec})
        defer(rec, lambda: kb.build(lo, hi, nb, idx=ix, count=count,
                                    valid=v))
        return rec

    def transfer_case(name, args):
        in_words, _, _, _, _, mask, nb = args
        ok, words = kb.transfer(*args)
        ok_ref, words_ref = bloom.transfer(*args)
        torch.cuda.synchronize()
        err = max(int((ok.to(torch.int16) - ok_ref.to(torch.int16))
                      .abs().max()),
                  int((words.to(torch.int64) - words_ref.to(torch.int64))
                      .abs().max()))
        worst["bloom_transfer"] = max(worst["bloom_transfer"], err)
        check(torch.equal(ok, ok_ref) and torch.equal(words, words_ref),
              f"bloom_transfer {name} disagrees")
        # the mask byte in and the survivor byte out per row; the incoming
        # key halves of the masked rows and the outgoing ones of the
        # survivors (the kernel loads no others), each 32-byte sector
        # once; the incoming filter read once, the outgoing one written
        n = int(mask.shape[0])
        nbytes = (2 * n + 2 * sector_bytes(torch, mask)
                  + 2 * sector_bytes(torch, ok_ref)
                  + in_words.numel() * 4 + nb * 32)
        rec = {"kernel": "bloom_transfer", "case": name, "n": n,
               "live": int(mask.sum()), "nblocks_in": int(in_words.shape[0]),
               "nblocks_out": nb, "survivors": int(ok_ref.sum()),
               "route": transfer_route(kb._lib(), n, nb),
               "ms": cuda_ms(torch, lambda: kb.transfer(*args), 20),
               "plain_ms": cuda_ms(torch, lambda: bloom.transfer(*args), 3,
                                   warm=1),
               "plain_device": "cuda",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "max_abs_err": err, "library_ms": None}
        emit({"phase": "kernels", **rec})
        defer(rec, lambda: kb.transfer(*args))
        return rec

    ragged = 6_001_215            # SF 1 lineitem rows
    nb_mid, nb_big = (int(filt[c].shape[0]) for c in (0, 1))
    probe_case("2^23 m=1", [0], N_BIG, ragged, None)
    rep["multi_probe"] = probe_case("2^23 m=2", [0, 1], N_BIG, ragged, None)
    probe_case("2^23 m=3 one-block", [0, 1, 2], N_BIG, ragged, None)
    probe_case("2^21 m=2 gather", [1, 0], N_MID, N_MID - 12345, idx)
    rep["probe"] = single_case("2^23 orders", filt[0], cols[0], N_BIG,
                               ragged, None, "orders")
    single_case("2^21 orders gather", filt[0], cols[0], N_MID,
                N_MID - 12345, idx, "orders")
    words, col, _, pcount = k3_path_inputs(torch, np, kb, bloom, dev)
    single_case(K3_PATH_CASE, words, col, K3_PATH_CASES[K3_PATH_CASE][0],
                pcount, None, "5 of 25 keys")
    rep["bloom_build"] = build_case("2^23 lineitem", 1, nb_big, ragged,
                                    None, None)
    build_case("2^21 orders gather+valid", 0, nb_mid, N_MID - 777, idx,
               valid)
    build_case("2^21 one-block", 2, 1, N_MID, None, None)
    # the direct route (fewer than 2^18 rows), where most of the path's
    # calls into more than 64 blocks go (the `shapes` line)
    build_case("2^17 orders", 0, bloom.blocks_for(1 << 17), 1 << 17, None,
               None)
    # skew: lineitem-many keys into the lineitem-sized filter, every one in
    # the first of its 256 slices, so all but that slice's capacity go to
    # K2's overflow list (a fault there shows as a time as well as a wrong
    # word); its own generator, so the cases after it keep their inputs
    cols.append(halves(skewed_keys(np, np.random.default_rng(23), N_BIG)))
    build_case("2^23 one slice", len(cols) - 1, nb_big, ragged, None, None)
    cases = transfer_cases(torch, np, kb, bloom, dev, api)
    rep["bloom_transfer"] = transfer_case("SF 1 case C",
                                          cases.pop("SF 1 case C"))
    for name, args in cases.items():
        transfer_case(name, args)
    return rep, worst


def device_times(torch, later: list) -> None:
    """Each Bloom and hash-map case's device time alone (`device_busy`),
    into its record and one line each with its device ops a call (a
    memset and each kernel apart); after every CUDA-event reading of
    phases 3-4, so that no torch.profiler session precedes those
    readings."""
    for rec, call in later:
        calls = 20
        prof = device_busy(torch, call, calls)
        rec["device_ms"] = prof["device_busy_seconds"] * 1e3 / calls
        emit({"phase": "kernels", "kernel": rec["kernel"],
              "case": rec["case"], "ms": rec["ms"],
              "device_ms": rec["device_ms"],
              "device_ops": [{"op": op["op"], "ms": op["ms"] / calls}
                             for op in prof["top_device_ms"]]})


def route_sweep(torch, np, kb, bloom, dev) -> None:
    """K2's direct and partitioned routes, each forced in turn
    (`bloom_build_force_route`), at the build sizes the `pred-trans`
    path gives K2 (2^14 to 2^20 keys, the `shapes` line's range, into
    `blocks_for` blocks): each bit-exact against the plain build, one
    line a size with both routes' CUDA-event and device ms and the route
    K2's rule takes there (`kFewRows` in bloom.cu comes from these)."""
    lib = kb._lib()
    rng = np.random.default_rng(29)
    for log2n in range(14, 21):
        n = 1 << log2n
        nb = bloom.blocks_for(n)
        lo, hi = bloom.keys_to_device(
            rng.integers(0, 1 << 40, n, dtype=np.int64), dev)
        ref = kb.build_ref(lo, hi, nb)
        rule = lib.bloom_build_scratch_bytes(n, kb._log2(nb))
        rec = {"phase": "kernels", "kernel": "bloom_build",
               "case": "route sweep", "n": n, "nblocks": nb,
               "rule": "partitioned" if rule else "direct"}
        for route, kind in (("direct", 1), ("partitioned", 2)):
            lib.bloom_build_force_route(kind)
            try:
                got = kb.build(lo, hi, nb)
                torch.cuda.synchronize()
                check(torch.equal(got, ref),
                      f"bloom_build {route} route at {n} rows disagrees")
                rec[f"{route}_ms"] = cuda_ms(
                    torch, lambda: kb.build(lo, hi, nb), 20)
                rec[f"{route}_device_ms"] = device_ms(
                    torch, lambda: kb.build(lo, hi, nb))
            finally:
                lib.bloom_build_force_route(-1)
        emit(rec)


def probe_rows_sweep(torch, np, kb, bloom, dev) -> None:
    """K3 at one row a thread and at four (`bloom_probe_force_rows`),
    each bit-exact against the plain probe, over 2^16 to 2^23 rows (72%
    live, orders-domain keys) into filters of 4,096 and 2^17 blocks
    (`K3_PATH_CASES`' heaviest, "2^23 orders"), and through survivor ids
    at 2^21 and 2^23 rows: one line a shape with both's CUDA-event and
    device ms and the rows a thread K3's rule takes there (`kManyRows` in
    bloom.cu comes from these)."""
    lib = kb._lib()
    rng = np.random.default_rng(61)
    lo, hi = bloom.keys_to_device(
        rng.integers(0, 6_000_000, N_BIG, dtype=np.int64), dev)
    filters = {}
    for nkeys in (1 << 16, KEYS_ORDERS):
        blo, bhi = bloom.keys_to_device(
            rng.choice(6_000_000, nkeys, replace=False), dev)
        filters[nkeys] = kb.build_ref(blo, bhi, bloom.blocks_for(nkeys))
    shapes = [(1 << log2n, nkeys, None) for nkeys in filters
              for log2n in range(16, 24)]
    for log2n in (21, 23):
        idx = torch.from_numpy(np.sort(rng.choice(
            N_BIG, (1 << log2n) * 3 // 4, replace=False)).astype(np.int32))
        shapes.append((1 << log2n, 1 << 16, idx.to(dev)))
    for n, nkeys, idx in shapes:
        words = filters[nkeys]
        rows = n if idx is None else int(idx.shape[0])
        count = rows * 18 // 25
        clo, chi = (lo[:n], hi[:n]) if idx is None else (lo, hi)
        ref = kb.probe_ref(words, clo, chi, idx=idx, count=count)
        rec = {"phase": "kernels", "kernel": "probe", "case": "rows sweep",
               "n": rows, "count": count, "nblocks": int(words.shape[0]),
               "gather": idx is not None,
               "rule": lib.bloom_probe_rows(rows)}
        for r in (1, 4):
            lib.bloom_probe_force_rows(r)
            try:
                def call():
                    return kb.probe(words, clo, chi, idx=idx, count=count)
                got = call()
                torch.cuda.synchronize()
                check(torch.equal(got, ref),
                      f"probe at {r} rows a thread, {rows} rows disagrees")
                rec[f"rows{r}_ms"] = cuda_ms(torch, call, 20)
                rec[f"rows{r}_device_ms"] = device_ms(torch, call)
            finally:
                lib.bloom_probe_force_rows(0)
        emit(rec)


def transfer_sweep(torch, np, kb, bloom, dev) -> None:
    """K7 with each route forced in turn (`bloom_transfer_force`) at
    `transfer_sweep_cases`' shapes, each run bit-exact against the plain
    version (survivors and words): one line a shape with every route's
    CUDA-event and device ms and the route K7's rule takes there
    (`kManyTransferRows` and `kTinyRowsABlock` in bloom.cu come from
    these). Other layouts and inserts are `tools/k7_floor.py`'s
    variants."""
    lib = kb._lib()
    for case, args in transfer_sweep_cases(torch, np, kb, bloom,
                                           dev).items():
        n, nb = int(args[1].shape[0]), args[6]
        ok_ref, words_ref = bloom.transfer(*args)
        rec = {"phase": "kernels", "kernel": "bloom_transfer",
               "case": "transfer sweep", "shape": case, "n": n,
               "nblocks_out": nb, "survivors": int(ok_ref.sum()),
               "rule": transfer_route(lib, n, nb)}
        for route, name in transfer_routes(nb).items():
            check(lib.bloom_transfer_force(route) == 0,
                  f"bloom_transfer_force {name}")
            try:
                ok, words = kb.transfer(*args)
                torch.cuda.synchronize()
                check(torch.equal(ok, ok_ref)
                      and torch.equal(words, words_ref),
                      f"bloom_transfer {name} at {case} disagrees")
                rec[f"{name}_ms"] = cuda_ms(torch,
                                            lambda: kb.transfer(*args), 20)
                rec[f"{name}_device_ms"] = device_ms(
                    torch, lambda: kb.transfer(*args))
            finally:
                lib.bloom_transfer_force(0)
        emit(rec)


def last_rows(np, keys, probe):
    """Each probe key's last row among `keys` (the sequential insert's
    answer), -1 where it is absent: int32 [len(probe)]."""
    uniq, first = np.unique(keys[::-1], return_index=True)
    pos = np.minimum(np.searchsorted(uniq, probe), len(uniq) - 1)
    return np.where(uniq[pos] == probe, len(keys) - 1 - first[pos],
                    -1).astype(np.int32)


def joinmap_inputs(np):
    """The hash-map cases' keys: (the generator, for the cases' further
    inputs; 2^16 distinct keys; their probe keys, half of them misses;
    2^20 keys with duplicates; SF 1 orders' 1.5 M keys)."""
    rng = np.random.default_rng(11)
    small = rng.choice(1 << 40, 1 << 16, replace=False).astype(np.int64)
    probe = np.concatenate([small, rng.integers(0, 1 << 40, 1 << 16)])
    dups = rng.integers(0, 1 << 19, 1 << 20).astype(np.int64)
    orders = rng.choice(6_000_000, KEYS_ORDERS,
                        replace=False).astype(np.int64)
    return rng, small, probe, dups, orders


def sf1_lookup_probe(np, rng, orders):
    """K5's "SF 1 lineitem" probe keys over a table of `orders` (SF 1
    orders' 1.5 M keys, `joinmap_inputs`, drawn next from its generator
    `rng`): 6,001,215 lineitem-like keys drawn from them, one in 8
    replaced by a key outside the orders domain, so it misses."""
    probe = orders[rng.integers(0, KEYS_ORDERS, 6_001_215)]
    probe[::8] = rng.integers(6_000_000, 24_000_000, len(probe[::8]))
    return probe


#: K5's case at the plane-off path's most frequent lookup shape (its warm
#: `shapes` line): 4,096 probe keys into a table of 512 slots
K5_PATH_CASE = "4096 into 512 slots"


def k5_path_keys(np):
    """K5's path-shape case: (200 distinct build keys, a table of
    `capacity_for(200)` = 512 slots; 4,096 probe keys drawn from them,
    one in 8 a miss)."""
    rng = np.random.default_rng(43)
    keys = rng.choice(1 << 40, 200, replace=False).astype(np.int64)
    probe = keys[rng.integers(0, len(keys), 4096)]
    probe[::8] = rng.integers(1 << 41, 1 << 42, len(probe[::8]))
    return keys, probe


def joinmap_route_sweep(torch, np, sj, bloom, dev) -> None:
    """K4's direct and partitioned routes, each forced in turn
    (`joinmap_build_force_route`), the partitioned one at regions of
    2^11, 2^12 and 2^13 slots, at 2^12 to 2^21 distinct keys in
    `capacity_for` slots (the plane-off path's K4 calls: its `shapes`
    line): each build's occupied count against the distinct count, one
    line a size with every variant's CUDA-event and device ms and the
    route K4's rule takes there (`kFewKeys` and `kRegionLog2` in
    semijoin.cu come from these)."""
    lib = sj._lib()
    rng = np.random.default_rng(37)
    for log2n in range(12, 22):
        n = 1 << log2n
        cap = sj.capacity_for(n)
        keys = rng.choice(1 << 40, n, replace=False).astype(np.int64)
        lo, hi = bloom.keys_to_device(keys, dev)
        rule = lib.joinmap_build_scratch_bytes(n, cap)
        rec = {"phase": "joinmap", "kernel": "joinmap_build",
               "case": "route sweep", "n": n, "cap": cap,
               "rule": "partitioned" if rule else "direct"}
        for name, route, log2r in (("direct", 1, 0),
                                   ("regions_2^11", 2, 11),
                                   ("regions_2^12", 2, 12),
                                   ("regions_2^13", 2, 13)):
            lib.joinmap_build_force_route(route, log2r)
            try:
                _, occ = sj.build_rows(lo, hi, cap)
                check(int(occ) == n,
                      f"joinmap_build {name} at {n} keys: occupied "
                      f"{int(occ)}")
                rec[f"{name}_ms"] = cuda_ms(
                    torch, lambda: sj.build_rows(lo, hi, cap), 20)
                rec[f"{name}_device_ms"] = device_ms(
                    torch, lambda: sj.build_rows(lo, hi, cap))
            finally:
                lib.joinmap_build_force_route(-1, 0)
        emit(rec)


def joinmap_phase(torch, np, sj, bloom, dev, api, later: list):
    """K4/K5 vs their plain versions and a sort-based expectation on the
    card, and K6a/K6b vs theirs and `torch.isin`; returns each kernel's
    record at the SF 1 orders shape (K6: case A's) and its largest
    error. Appends (record, call) for each case to `later` (unless
    None), for `device_times`."""

    def defer(rec, call):
        if later is not None:
            later.append((rec, call))
    rng, small, small_probe, dups, orders = joinmap_inputs(np)
    worst = {"joinmap_build": 0, "joinmap_lookup": 0, "semijoin_build": 0,
             "semijoin_probe": 0}

    def halves(keys):
        return bloom.keys_to_device(keys, dev)

    def build(name, keys):
        lo, hi = halves(keys)
        n, cap = len(keys), sj.capacity_for(len(keys))
        table, occ = sj.build_rows(lo, hi, cap)
        distinct = len(np.unique(keys))
        rec = {"kernel": "joinmap_build", "case": name, "n": n, "cap": cap,
               "occupied": int(occ), "distinct": distinct}
        t = time.perf_counter()
        _, ref_occ = sj.build_rows_ref(lo.cpu(), hi.cpu(), cap)
        rec["plain_ms"] = (time.perf_counter() - t) * 1e3
        rec["plain_device"] = "cpu"
        err = max(abs(int(occ) - distinct), abs(int(occ) - int(ref_occ)))
        worst["joinmap_build"] = max(worst["joinmap_build"], err)
        check(err == 0, f"joinmap_build {name}: occupied {int(occ)}, "
              f"plain {int(ref_occ)}, distinct {distinct}")
        # keys in, the table (16 bytes a slot) and the count out
        nbytes = 8 * n + 16 * cap + 8
        rec.update(ms=cuda_ms(torch, lambda: sj.build_rows(lo, hi, cap), 10),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
                   max_abs_err=err, library_ms=None)
        emit({"phase": "joinmap", **rec})
        defer(rec, lambda: sj.build_rows(lo, hi, cap))
        return rec, table

    def lookup(name, table, probe, want=None):
        """K5 against the plain lookup over the same table, and against
        `want` where one is given."""
        plo, phi = halves(probe)
        got = sj.lookup(table, plo, phi)
        ref = sj.lookup_ref(table, plo, phi)
        err = 0
        for exp, what in ((ref, "the plain lookup"), (want, "the sort")):
            if exp is None:
                continue
            err = max(err, int((got.to(torch.int64) - exp.to(torch.int64))
                               .abs().max()))
            check(torch.equal(got, exp),
                  f"joinmap_lookup {name} disagrees with {what}")
        worst["joinmap_lookup"] = max(worst["joinmap_lookup"], err)
        visited, sectors = sj.lookup_work(table, plo, phi)
        # keys in, rows out, and each 32-byte sector of the table the
        # walks touch read once (at most the whole table)
        nbytes = 12 * len(probe) + 32 * sectors
        rec = {"kernel": "joinmap_lookup", "case": name, "n": len(probe),
               "cap": int(table.shape[0]), "slots_visited": visited,
               "sectors": sectors, "hits": int((ref >= 0).sum()),
               "ms": cuda_ms(torch, lambda: sj.lookup(table, plo, phi), 20),
               "plain_ms": cuda_ms(torch, lambda: sj.lookup_ref(
                   table, plo, phi), 3, warm=1),
               "plain_device": "cuda",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "max_abs_err": err, "library_ms": None}
        emit({"phase": "joinmap", **rec})
        defer(rec, lambda: sj.lookup(table, plo, phi))
        return rec

    # 2^16 keys: K5 against the plain lookup over the same K4 table
    _, table = build("2^16", small)
    lookup("2^16", table, small_probe)
    # duplicate keys: occupied is the distinct count
    build("2^20 dups", dups)
    # SF 1: orders' 1.5 M keys, probed by lineitem's 6,001,215 (one in 8
    # drawn outside the orders domain, so it misses)
    keys = orders
    rep = {}
    rep["joinmap_build"], table = build("SF 1 orders", keys)
    probe = sf1_lookup_probe(np, rng, keys)
    bk = torch.from_numpy(keys).to(dev)
    order = torch.argsort(bk)
    sk = bk[order]
    pk = torch.from_numpy(probe).to(dev)
    pos = torch.searchsorted(sk, pk).clamp(max=len(keys) - 1)
    want = torch.where(sk[pos] == pk, order[pos], -1).to(torch.int32)
    rep["joinmap_lookup"] = lookup("SF 1 lineitem", table, probe, want)
    # the plane-off path's most frequent lookup shape
    keys, probe = k5_path_keys(np)
    _, table = build(K5_PATH_CASE, keys)
    lookup(K5_PATH_CASE, table, probe)
    # keys crowded at a region's tail, at the last region's wrap into slot
    # 0 and past a region's part of K4's scratch, with repeated keys, on
    # the partitioned route (`crowded_keys`; its own generator, so the
    # cases after it keep their inputs): each key finds its last row
    crowd_rng = np.random.default_rng(31)
    keys = crowded_keys(np, crowd_rng, 1 << 20, sj.capacity_for(1 << 20))
    _, table = build("2^20 crowded", keys)
    probe = np.concatenate([keys, crowd_rng.integers(0, 1 << 40, 1 << 16)])
    lookup("2^20 crowded", table, probe, torch.from_numpy(
        last_rows(np, keys, probe)).to(dev))

    def set_case(name, keys, keep, probe):
        """K6a (occupied vs the distinct count and the plain sequential
        build on CPU copies) and K6b (vs the plain probe over the same
        K6a table and vs torch.isin, which is timed as `library_ms`)."""
        lo, hi = halves(keys)
        mask = torch.from_numpy(keep).to(dev)
        n, cap = len(keys), sj.capacity_for(len(keys))
        table, occ = sj.set_build(lo, hi, cap, mask)
        distinct = len(np.unique(keys[keep]))
        t = time.perf_counter()
        _, ref_occ = sj.set_build_ref(lo.cpu(), hi.cpu(), cap, mask.cpu())
        plain_build = (time.perf_counter() - t) * 1e3
        err = max(abs(int(occ) - distinct), abs(int(occ) - int(ref_occ)))
        worst["semijoin_build"] = max(worst["semijoin_build"], err)
        check(err == 0, f"semijoin_build {name}: occupied {int(occ)}, "
              f"plain {int(ref_occ)}, distinct {distinct}")
        plo, phi = halves(probe)
        got = sj.set_probe(table, plo, phi)
        ref = sj.set_probe_ref(table, plo, phi)
        pk, bk = (torch.from_numpy(a).to(dev) for a in (probe, keys))
        lib = torch.isin(pk, bk[mask])
        perr = 0
        for exp, what in ((ref, "the plain probe"), (lib, "torch.isin")):
            perr = max(perr, int((got.to(torch.int16) - exp.to(torch.int16))
                                 .abs().max()))
            check(torch.equal(got, exp),
                  f"semijoin_probe {name} disagrees with {what}")
        worst["semijoin_probe"] = max(worst["semijoin_probe"], perr)
        visited, sectors = sj.lookup_work(table, plo, phi)
        library = {"library_ms": cuda_ms(torch, lambda: torch.isin(
            pk, bk[mask]), 10),
            "library_call": "torch.isin(probe, build[mask]): compare with "
                            "semijoin_build + semijoin_probe together"}
        # the mask byte of every row and the key halves of the live rows
        # (the kernel loads no others, each 32-byte sector once) in, the
        # table (16 bytes a slot) and the count out
        nbytes = n + 2 * sector_bytes(torch, mask) + 16 * cap + 8
        brec = {"kernel": "semijoin_build", "case": name, "n": n,
                "live": int(keep.sum()), "cap": cap, "occupied": int(occ),
                "distinct": distinct,
                "ms": cuda_ms(torch, lambda: sj.set_build(lo, hi, cap, mask),
                              10),
                "plain_ms": plain_build, "plain_device": "cpu",
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                "max_abs_err": err, **library}
        # keys in, a byte out, and each 32-byte sector of the table the
        # walks touch read once
        nbytes = 9 * len(probe) + 32 * sectors
        prec = {"kernel": "semijoin_probe", "case": name, "n": len(probe),
                "cap": cap, "slots_visited": visited, "sectors": sectors,
                "hits": int(ref.sum()),
                "ms": cuda_ms(torch, lambda: sj.set_probe(table, plo, phi),
                              20),
                "plain_ms": cuda_ms(torch, lambda: sj.set_probe_ref(
                    table, plo, phi), 3, warm=1),
                "plain_device": "cuda",
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                "max_abs_err": perr, **library}
        emit({"phase": "joinmap", **brec})
        emit({"phase": "joinmap", **prec})
        defer(brec, lambda: sj.set_build(lo, hi, cap, mask))
        defer(prec, lambda: sj.set_probe(table, plo, phi))
        return brec, prec

    keys = rng.integers(0, 3000, 5003).astype(np.int64)
    set_case("5003 ragged dups", keys, rng.random(5003) < 0.7,
             np.concatenate([keys, rng.integers(0, 6000, 2001)]))
    rep["semijoin_build"], rep["semijoin_probe"] = set_case(
        "SF 1 case A", api["o_orderkey"], api["q5"], api["l_orderkey"])
    return rep, worst


def device_profile(torch, fn) -> dict:
    """`fn()` once under torch.profiler: wall seconds (host clock, ending
    in a synchronise), the seconds the device was busy (kernels and
    copies; one stream, so they do not overlap), the idle share, and the
    top device ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    busy = sum(ms for ms, _ in by_name.values()) / 1e3
    top = sorted(((ms, cnt, name) for name, (ms, cnt) in by_name.items()),
                 reverse=True)[:6]
    return {"wall_seconds": wall, "device_busy_seconds": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_device_ms": [{"op": k[:80], "ms": ms, "count": c}
                              for ms, c, k in top]}


def device_busy(torch, fn, calls: int = 20) -> dict:
    """`device_profile` of `calls` calls of `fn`, after a warm-up call. A
    profile that recorded no device op at all (torch.profiler drops one
    now and then) is taken again, twice at most."""
    fn()
    for _ in range(3):
        busy = device_profile(torch, lambda: [fn() for _ in range(calls)])
        if busy["device_busy_seconds"] > 0:
            break
    check(busy["device_busy_seconds"] > 0,
          "torch.profiler recorded no device time in three tries")
    return busy


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device milliseconds per call of `fn` (its kernels' and copies'
    busy time under torch.profiler, `device_busy`), free of the host's
    launch overhead."""
    return device_busy(torch, fn, calls)["device_busy_seconds"] * 1e3 / calls


def profile_query(torch, run, qn: int, path: str) -> dict:
    """One warm run of a query under torch.profiler (`device_profile`)."""
    return {"phase": "profile", "query": qn, "path": path,
            **device_profile(torch, run)}


#: kernels that only the kernel library's public entry points reach
API_ONLY = ("semijoin_build", "semijoin_probe", "bloom_transfer")
#: (path, strategy, device-resident plane, kernels that must launch on
#: it, kernels that must not)
PATHS = (
    ("pred-trans", "pred-trans", True, ("multi_probe", "bloom_build"),
     ("probe", "joinmap_build", "joinmap_lookup", *API_ONLY, *FLASH)),
    ("pred-trans-adaptive", "pred-trans-adaptive", True,
     ("multi_probe", "bloom_build"), (*API_ONLY, *FLASH)),
    ("pred-trans-plane-off", "pred-trans", False,
     ("probe", "bloom_build", "joinmap_build", "joinmap_lookup"),
     ("multi_probe", *API_ONLY, *FLASH)),
)
#: the kernel-api path: (kernels that must launch, kernels that must not)
API_PATH = (("bloom_build", "probe", *API_ONLY),
            ("multi_probe", "joinmap_build", "joinmap_lookup", *FLASH))


def check_path(counts: dict, path: str, must, never) -> None:
    for name in must:
        check(counts[name] > 0, f"kernel {name} never launched on {path}")
    for name in never:
        check(counts[name] == 0, f"kernel {name} launched on {path}")


def launch_window(kb, sj, fa):
    """Zero every launch count; the returned function reads them."""
    kb.reset_launches()
    sj.reset_launches()
    fa.reset_launches()
    return lambda: {**kb.LAUNCHES, **sj.LAUNCHES, **fa.LAUNCHES}


def record_shapes(kb, shapes: dict):
    """Wrap K1's and K2's wrappers (`kb.multi_probe`, `kb.build`, which
    the engine looks up at each call) so each call's shape is counted in
    `shapes` (a Counter each): K2 by (rows, nblocks), K1 by (rows, m,
    largest nblocks), rows being the live rows rounded up to a power of
    two. Returns a function that puts the wrappers back."""
    multi_probe, build = kb.multi_probe, kb.build

    def rows(cols, idx, count):
        return 1 << max(kb._rows(cols, idx, count)[1] - 1, 0).bit_length()

    def probe_rec(words, los, his, idx=None, count=None, **kw):
        shapes["multi_probe"][(rows(los, idx, count), len(words),
                               max(int(w.shape[0]) for w in words))] += 1
        return multi_probe(words, los, his, idx=idx, count=count, **kw)

    def build_rec(lo, hi, nblocks, idx=None, count=None, **kw):
        shapes["bloom_build"][(rows([lo], idx, count), int(nblocks))] += 1
        return build(lo, hi, nblocks, idx=idx, count=count, **kw)

    def restore():
        kb.multi_probe, kb.build = multi_probe, build
    kb.multi_probe, kb.build = probe_rec, build_rec
    return restore


def record_join_shapes(sj, kb, shapes: dict):
    """Wrap K4's and K5's wrappers (`sj.build_rows`, `sj.lookup`, which
    `joinmap_build` / `joinmap_lookup` look up at each call) so each
    call's shape is counted in `shapes` (a Counter each) by (keys rounded
    up to a power of two, table slots), and K3's (`kb.probe`, which the
    engine looks up at each call) by (live rows rounded up to a power of
    two, nblocks, whether it gathers through survivor ids). Returns a
    function that puts the wrappers back."""
    build_rows, lookup, probe = sj.build_rows, sj.lookup, kb.probe

    def pow2(n: int) -> int:
        return 1 << max(n - 1, 0).bit_length()

    def build_rec(lo, hi, cap):
        shapes["joinmap_build"][(pow2(int(lo.shape[0])), int(cap))] += 1
        return build_rows(lo, hi, cap)

    def lookup_rec(table, lo, hi):
        shapes["joinmap_lookup"][(pow2(int(lo.shape[0])),
                                  int(table.shape[0]))] += 1
        return lookup(table, lo, hi)

    def probe_rec(words, lo, hi, idx=None, count=None, **kw):
        live = kb._rows([lo], idx, count)[1]
        shapes["probe"][(pow2(live), int(words.shape[0]),
                         idx is not None)] += 1
        return probe(words, lo, hi, idx=idx, count=count, **kw)

    def restore():
        sj.build_rows, sj.lookup, kb.probe = build_rows, lookup, probe
    sj.build_rows, sj.lookup, kb.probe = build_rec, lookup_rec, probe_rec
    return restore


def slice_phase(torch, kb, sj, fa, cat, sf: float):
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import QUERIES, build_query

    launches = launch_window(kb, sj, fa)

    def cfg(strategy, plane: bool):
        return ExecConfig(
            strategy=make_strategy(strategy, backend="cuda",
                                   device_resident=plane),
            join_backend="cuda", device="on" if plane else "off")

    def run(strategy, plane, qn):
        before = launches()
        t = time.perf_counter()
        res, st = Executor(cat, cfg(strategy, plane)).execute(
            build_query(qn, sf=sf))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        return res, st, sec, {k: v - before[k]
                              for k, v in launches().items()}

    oracle = {}
    for qn in sorted(QUERIES):
        res, _ = Executor(cat, ExecConfig(late_materialize=False)).execute(
            build_query(qn, sf=sf))
        oracle[qn] = table_digest(res)

    per_query, counts = {}, {}
    shapes = {"multi_probe": collections.Counter(),
              "bloom_build": collections.Counter()}
    join_shapes = {"joinmap_build": collections.Counter(),
                   "joinmap_lookup": collections.Counter(),
                   "probe": collections.Counter()}
    for path, strategy, plane, _, _ in PATHS:
        queries = [5] if strategy == "pred-trans-adaptive" \
            else sorted(QUERIES)
        launch_window(kb, sj, fa)     # this path's counts start at 0 here
        for qn in queries:
            _, _, cold, _ = run(strategy, plane, qn)
            # the warm sweeps' K1/K2 and K3/K4/K5 shapes
            restore = (record_shapes(kb, shapes) if path == "pred-trans"
                       else record_join_shapes(sj, kb, join_shapes)
                       if path == "pred-trans-plane-off" else None)
            try:
                res, st, warm, query_launches = run(strategy, plane, qn)
            finally:
                if restore is not None:
                    restore()
            check(table_digest(res) == oracle[qn],
                  f"Q{qn} {path} differs from the eager oracle")
            rep = st.report()
            rec = {"phase": "slice", "query": qn, "path": path,
                   "seconds": warm, "cold_seconds": cold,
                   "rows": len(res), "phase_seconds": rep["phase_seconds"],
                   "transfer_seconds": rep["transfer"]["seconds"],
                   "device": rep["device"], "launches": query_launches,
                   "md5_equal": True}
            per_query[(path, qn)] = rec
            emit(rec)
        counts[path] = launches()     # read just after the path
        if path == "pred-trans":
            emit({"phase": "slice", "path": path, "shapes": "warm", **{
                name: [{"rows": k[0], "nblocks": k[-1], "calls": c,
                        **({"m": k[1]} if name == "multi_probe" else {})}
                       for k, c in sorted(counter.items())]
                for name, counter in shapes.items()}})
        if path == "pred-trans-plane-off":
            emit({"phase": "slice", "path": path, "shapes": "warm", **{
                name: [({"rows": k[0], "nblocks": k[1], "gather": k[2]}
                        if name == "probe" else {"keys": k[0], "cap": k[1]})
                       | {"calls": c} for k, c in sorted(counter.items())]
                for name, counter in join_shapes.items()}})
    emit({"kernels": counts})
    for path, _, _, must, never in PATHS:
        check_path(counts[path], path, must, never)
    compare = []
    for qn in sorted(QUERIES):
        on = per_query[("pred-trans", qn)]
        off = per_query[("pred-trans-plane-off", qn)]
        compare.append({"query": qn, "seconds_on": on["seconds"],
                        "seconds_off": off["seconds"],
                        "round_trips_on": on["device"]["round_trips"],
                        "round_trips_off": off["device"]["round_trips"]})
    emit({"phase": "compare", "sf": sf, "queries": compare})
    for path, strategy, plane in (("pred-trans", "pred-trans", True),
                                  ("pred-trans-plane-off", "pred-trans",
                                   False)):
        for qn in (5, 9):             # outside every counted window
            emit(profile_query(torch, lambda: run(strategy, plane, qn), qn,
                               path))
    return per_query, counts, oracle


def kernel_api_phase(torch, np, kb, sj, fa, bloom, dev, api) -> dict:
    """Path `kernel-api`: cases A-C through the public entry points, cold
    then warm, inside one launch-count window; every result is checked
    after the window. Returns the path's launch counts."""
    from repro_torch.kernels.bloom import (bloom_build, bloom_probe,
                                           bloom_transfer)
    from repro_torch.kernels.semijoin import (semi_mask, semijoin_build,
                                              semijoin_probe)
    from repro_torch.kernels.semijoin.ref import semi_mask_ref

    l_key, o_key, q5 = api["l_orderkey"], api["o_orderkey"], api["q5"]
    l_supp, s_key, q4 = api["l_suppkey"], api["s_suppkey"], api["q4"]

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def chain():
        w = bloom_build(o_key, mask=q5)
        ok, w2 = bloom_transfer(w, l_key, l_supp)
        return w, ok, w2, bloom_probe(w2, s_key)

    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    runs = []
    for run in ("cold", "warm"):
        a, sec_a = timed(lambda: semi_mask(l_key, o_key, q5))
        table_b, sec_build = timed(lambda: semijoin_build(l_key, q4))
        b, sec_probe = timed(lambda: semijoin_probe(table_b, o_key))
        c, sec_c = timed(chain)
        runs.append((run, a, table_b, b, c, sec_a, sec_build + sec_probe,
                     sec_c))
    counts = read()                 # just after the path

    # the oracles, outside the window
    want_a = semi_mask_ref(l_key, o_key, q5)
    isin_a = torch.isin(torch.from_numpy(l_key).to(dev),
                        torch.from_numpy(o_key[q5]).to(dev)).cpu().numpy()
    check(np.array_equal(want_a, isin_a), "semi_mask_ref != torch.isin")
    want_b = semi_mask_ref(o_key, l_key, q4)
    distinct_b = len(np.unique(l_key[q4]))

    olo, ohi = bloom.keys_to_device(o_key, dev)
    ilo, ihi = bloom.keys_to_device(l_key, dev)
    slo, shi = bloom.keys_to_device(l_supp, dev)
    klo, khi = bloom.keys_to_device(s_key, dev)
    nb_in = bloom.blocks_for(int(q5.sum()))
    nb_out = bloom.blocks_for(len(l_key))
    w_ref = kb.build_ref(olo, ohi, nb_in, valid=torch.from_numpy(q5).to(dev))
    for run, a, table_b, b, (w, ok, w2, hit), sec_a, sec_b, sec_c in runs:
        check(np.array_equal(a, want_a), f"case A ({run}) != semi_mask_ref")
        occupied = int(torch.count_nonzero(table_b[:, 2]))
        check(occupied == distinct_b,
              f"case B ({run}): {occupied} keys in the set, "
              f"{distinct_b} distinct")
        check(np.array_equal(b, want_b), f"case B ({run}) != semi_mask_ref")
        check(torch.equal(w, w_ref), f"case C ({run}): bloom_build words")
        ok_ref, w2_ref = bloom.transfer(
            w_ref, ilo, ihi, slo, shi,
            torch.ones(len(l_key), dtype=torch.bool, device=dev), nb_out)
        check(np.array_equal(ok, ok_ref.cpu().numpy())
              and torch.equal(w2, w2_ref),
              f"case C ({run}): bloom_transfer != the plain transfer")
        check(bool(ok[a].all()), f"case C ({run}): a false negative")
        hit_ref = kb.probe_ref(w2_ref, klo, khi).cpu().numpy()
        check(np.array_equal(hit, hit_ref),
              f"case C ({run}): bloom_probe != probe_ref")
        exact = np.isin(s_key, l_supp[a])
        check(bool(hit[exact].all()), f"case C ({run}): a supplier missed")
        emit({"phase": "kernel-api", "run": run,
              "A": {"seconds": sec_a, "build_rows": len(o_key),
                    "build_live": int(q5.sum()),
                    "cap": sj.capacity_for(len(o_key)),
                    "probe_rows": len(l_key), "hits": int(a.sum()),
                    "equal": ["semi_mask_ref", "torch.isin"]},
              "B": {"seconds": sec_b, "build_rows": len(l_key),
                    "build_live": int(q4.sum()), "distinct": distinct_b,
                    "occupied": occupied, "cap": int(table_b.shape[0]),
                    "table_mb": table_b.numel() * 4 / 2**20,
                    "probe_rows": len(o_key), "hits": int(b.sum()),
                    "equal": ["np.unique", "semi_mask_ref"]},
              "C": {"seconds": sec_c, "nblocks_in": int(w.shape[0]),
                    "nblocks_out": int(w2.shape[0]),
                    "survivors": int(ok.sum()), "exact": int(a.sum()),
                    "false_positives": int((ok & ~a).sum()),
                    "supplier_hits": int(hit.sum()),
                    "supplier_exact": int(exact.sum()),
                    "supplier_false_positives": int((hit & ~exact).sum()),
                    "equal": ["core.bloom.transfer", "probe_ref",
                              "build_ref"]}})
    emit({"phase": "kernel-api", "launches": counts})
    check_path(counts, "kernel-api", *API_PATH)
    return counts


#: the kernels the serving and curation paths may launch: K1 and K2 (the
#: plane-on transfer); K3-K8 never
SERVE_NEVER = ("probe", "joinmap_build", "joinmap_lookup", *API_ONLY,
               *FLASH)


def serve_tpch_phase(torch, kb, sj, fa, cat, sf: float, oracle: dict):
    """Path `serve-tpch`: `QueryServer` on the card (4 workers) over the
    slice phase's catalog, the 20 join queries twice in a seeded shuffle,
    a cold pass then a warm pass, then 4 `Session` clients on 4 threads
    (2 `pred-trans`, 2 `pred-trans-adaptive`) each submitting the 20;
    then a drained snapshot restored into a new server, whose first Q5
    must replay warm, and an `update_table` that must invalidate. Every
    result must have the eager oracle's md5. Counts are zeroed before
    each window and read after it; the path's count is their sum."""
    import random
    import tempfile
    import threading
    from repro_torch.relational.table import Table, table_digest
    from repro_torch.serve import QueryServer, ServeConfig
    from repro_torch.tpch import QUERIES, build_query

    # the cache holds SF 1's working set: the reference's 256 MB default
    # (sized for sf <= 0.1) held 41 of its entries, evicted 458 and let
    # 12 of 40 warm queries replay on the H100 (PERF.md)
    cfg = dict(strategy="pred-trans", join_backend="cuda", workers=4,
               max_queue=64, artifact_cache_bytes=16 << 30)
    schedule = sorted(QUERIES) * 2
    random.Random(1234).shuffle(schedule)
    total = collections.Counter()
    passes = {}

    def cache_hits(srv):
        kinds = srv.metrics_snapshot()["artifact_cache"]["kinds"]
        return {k: kinds.get(k, {}).get("hits", 0) for k in ("slots",
                                                             "bloom")}

    def run_pass(srv, name, submit_all):
        hits0 = cache_hits(srv)
        read = launch_window(kb, sj, fa)
        t = time.perf_counter()
        done = submit_all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read()                  # read just after the pass
        total.update(counts)
        trips = 0
        for qn, res, st in done:
            check(table_digest(res) == oracle[qn],
                  f"serve-tpch {name}: Q{qn} differs from the eager oracle")
            trips += st.report()["device"]["round_trips"]
        hits1 = cache_hits(srv)
        lat = srv.metrics_snapshot()["server"]["per_tag"][name]
        rec = {"phase": "serve-tpch", "pass": name, "queries": len(done),
               "seconds": wall, "qps": len(done) / wall,
               "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
               "slot_hits": hits1["slots"] - hits0["slots"],
               "filter_hits": hits1["bloom"] - hits0["bloom"],
               "from_cache": sum(st.transfer.from_cache
                                 for _, _, st in done),
               "round_trips": trips,
               "launches": {k: counts[k] for k in ("multi_probe",
                                                   "bloom_build")},
               "md5_equal": True}
        emit(rec)
        check_path(counts, f"serve-tpch {name}", (), SERVE_NEVER)
        passes[name] = counts
        return done

    def submit_schedule(srv, name):
        def go():
            futs = [(qn, srv.submit(build_query(qn, sf=sf), tag=name))
                    for qn in schedule]
            return [(qn, *f.result()) for qn, f in futs]
        return go

    def submit_sessions(srv):
        def go():
            sessions = [srv.session(s, tag="mixed") for s in (
                "pred-trans", "pred-trans", "pred-trans-adaptive",
                "pred-trans-adaptive")]
            futs, errors = [[] for _ in sessions], []

            def client(i):
                try:
                    futs[i] = [(qn, sessions[i].submit(build_query(qn, sf=sf)))
                               for qn in sorted(QUERIES)]
                except BaseException as e:   # noqa: BLE001 — re-raised
                    errors.append(e)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(sessions))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if errors:
                raise errors[0]
            return [(qn, *f.result()) for fs in futs for qn, f in fs]
        return go

    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "serve.snap")
        srv = QueryServer(cat, ServeConfig(**cfg))
        try:
            run_pass(srv, "cold", submit_schedule(srv, "cold"))
            run_pass(srv, "warm", submit_schedule(srv, "warm"))
            run_pass(srv, "mixed", submit_sessions(srv))
            snap = srv.metrics_snapshot()
            t = time.perf_counter()
            written = srv.drain_to_snapshot(path)
            written["seconds"] = time.perf_counter() - t
        finally:
            srv.close()
        cold, warm = passes["cold"], passes["warm"]
        for name in ("multi_probe", "bloom_build"):
            check(cold[name] > 0, f"serve-tpch cold: {name} never launched")
            check(warm[name] < cold[name],
                  f"serve-tpch warm: {name} launched {warm[name]} times, "
                  f"the cold pass {cold[name]}")
        server = snap["server"]
        emit({"phase": "serve-tpch", "server": {
            k: server[k] for k in ("submitted", "completed", "failed",
                                   "warm_replays", "degradations")},
            "latency": server["latency"],
            "artifact_cache": {k: snap["artifact_cache"][k] for k in (
                "entries", "bytes", "evictions", "kinds")},
            "plan_cache": snap["plan_cache"], "snapshot": written})
        check(server["failed"] == 0 and server["degradations"] == 0,
              "serve-tpch: a query failed or degraded")

        t = time.perf_counter()
        with QueryServer(cat, ServeConfig(snapshot_path=path,
                                          **cfg)) as srv2:
            info = {**srv2.restore_info,
                    "seconds": time.perf_counter() - t}
            read = launch_window(kb, sj, fa)
            t = time.perf_counter()
            res, st = srv2.query(build_query(5, sf=sf))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            counts = read()
            total.update(counts)
            check(info["loaded"] and info["artifacts"] > 0,
                  f"serve-tpch restart: snapshot not restored ({info})")
            check(st.transfer.from_cache,
                  "serve-tpch restart: the first Q5 was not a cache hit")
            check(table_digest(res) == oracle[5],
                  "serve-tpch restart: Q5 differs from the eager oracle")
            check(counts["multi_probe"] == counts["bloom_build"] == 0,
                  f"serve-tpch restart: K1/K2 launched ({counts})")
            emit({"phase": "serve-tpch", "step": "restart",
                  "restore": info, "seconds": sec, "from_cache": True,
                  "launches": {k: counts[k] for k in ("multi_probe",
                                                      "bloom_build")},
                  "md5_equal": True})

            orders = srv2.catalog["orders"]
            dropped = srv2.update_table("orders",
                                        Table(orders.columns, "orders"))
            read = launch_window(kb, sj, fa)
            t = time.perf_counter()
            res, st = srv2.query(build_query(5, sf=sf))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            counts = read()
            total.update(counts)
            check(dropped > 0, "serve-tpch update_table dropped nothing")
            check(not st.transfer.from_cache and counts["bloom_build"] > 0,
                  "serve-tpch update_table: Q5 did not rebuild its filters")
            check(table_digest(res) == oracle[5],
                  "serve-tpch update_table: Q5 differs from the eager oracle")
            check_path(counts, "serve-tpch update_table", (), SERVE_NEVER)
            emit({"phase": "serve-tpch", "step": "update_table",
                  "dropped": dropped, "seconds": sec,
                  "launches": {k: counts[k] for k in ("multi_probe",
                                                      "bloom_build")},
                  "md5_equal": True})
    counts = dict(total)
    check_path(counts, "serve-tpch", ("multi_probe", "bloom_build"),
               SERVE_NEVER)
    return counts


def curation_phase(torch, np, kb, sj, fa):
    """Path `curation`: `CurationPipeline` on the card at
    `benchmarks/curation_bench.py`'s size (100,000 documents, 800,000
    chunks) with `pred-trans`; its selection must have the md5 of the
    numpy backends' `pred-trans` and `no-pred-trans` selections."""
    from repro_torch.data import CurationPipeline, synthetic_corpus
    from repro_torch.relational.table import table_digest

    t = time.perf_counter()
    corpus = synthetic_corpus(n_docs=100_000)
    gen = time.perf_counter() - t
    read = launch_window(kb, sj, fa)
    pipe = CurationPipeline(corpus, "pred-trans", device="cuda")
    sel = pipe.select()
    torch.cuda.synchronize()
    counts = read()                       # read just after the path
    digest = table_digest(sel)
    host = {}
    for strategy in ("pred-trans", "no-pred-trans"):
        ref = CurationPipeline(corpus, strategy, device=None)
        check(table_digest(ref.select()) == digest,
              f"curation: the card's selection != numpy {strategy}'s")
        host[strategy] = {"seconds": ref.stats.seconds,
                          "join_input_rows": ref.stats.join_input_rows}
    toks, tgts = next(pipe.batches(batch_size=8, seq_len=128))
    check(toks.shape == (8, 128) and tgts.shape == (8, 128),
          "curation: a batch of the wrong shape")
    emit({"phase": "curation", "device": "cuda", "generate_seconds": gen,
          "seconds": pipe.stats.seconds, "chunks_in": pipe.stats.chunks_in,
          "chunks_out": pipe.stats.chunks_out,
          "join_input_rows": pipe.stats.join_input_rows,
          "numpy": host, "launches": {k: counts[k] for k in (
              "multi_probe", "bloom_build")}, "md5_equal": True})
    check_path(counts, "curation", ("multi_probe", "bloom_build"),
               SERVE_NEVER)
    return counts


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers and spill bytes of the entry function whose mangled name
    holds `kernel`, from nvcc's `-Xptxas -v` log (None each when the log
    does not name it)."""
    import re
    out = dict.fromkeys(("registers", "spill_stores", "spill_loads"))
    inside = False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        elif inside and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                out["spill_stores"], out["spill_loads"] = map(int, m.groups())
        elif inside and "Used" in ln:
            m = re.search(r"Used (\d+) registers", ln)
            out["registers"] = int(m.group(1)) if m else None
    return out


def decode_limit(ref) -> float:
    """DECODE_ULPS bf16 ulps (2^-7 relative) of the largest |ref|."""
    top = float(ref.float().abs().max())
    return DECODE_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7) \
        if top > 0 else 0.0


def attention_phase(torch, fa, dev, ptxas_log: str):
    """K8 against `flash_plain` and `sdpa_ref` on the card, one line per
    shape; returns the records of qwen1.5-4b's prefill and decode shapes
    (the serve path's) and each variant's largest error. Every line adds
    the kernel's registers and spills from `ptxas_log`; a prefill line
    its device TFLOP/s (unmasked flops over `device_ms`) and the shared
    memory one of its CTAs takes, a decode line its device GB/s."""
    import torch.nn.functional as F
    from repro_torch.kernels.flashattn.ref import attend_mask, sdpa_ref
    from repro_torch.models.layers import _ring_positions
    gen = torch.Generator(device=dev).manual_seed(3)

    def rows(b, n, start=0):
        return (torch.arange(start, start + n, dtype=torch.int32,
                             device=dev)[None].expand(b, n).contiguous())

    def ring(index, cap, b):          # the model's own cache positions
        return _ring_positions(index, cap, b, dev)

    ragged = torch.tensor([1024, 1000, 900, 700], device=dev)
    cases = (  # name, b, sq, skv, h, kvh, (d, dv), causal, window, q_pos, kv
        ("qwen1.5-4b prefill", 4, 2048, 2088, 20, 20, (128, 128), True,
         None, rows(4, 2048), ring(2048, 2088, 4)),
        # a chunk of 2048 after 1040 tokens: the ring has wrapped at slot
        # 1000, so kv_pos is not monotone
        ("qwen1.5-4b prefill, ring wrapped", 4, 2048, 2088, 20, 20,
         (128, 128), True, None, rows(4, 2048, 1040), ring(3088, 2088, 4)),
        ("qwen1.5-4b decode", 4, 1, 2088, 20, 20, (128, 128), True, None,
         rows(4, 1, 2080), ring(2081, 2088, 4)),
        ("minitron-4b GQA 24/8 prefill", 2, 2048, 2088, 24, 8, (128, 128),
         True, None, rows(2, 2048), ring(2048, 2088, 2)),
        ("d64 window 64 ragged", 4, 1024, 1024, 16, 16, (64, 64), True, 64,
         rows(4, 1024), (rows(4, 1024), rows(4, 1024) < ragged[:, None])),
        ("non-causal", 4, 1024, 1024, 16, 16, (128, 128), False, None,
         rows(4, 1024), (rows(4, 1024),
                         torch.ones(4, 1024, dtype=torch.bool, device=dev))),
        # decode after 3087 tokens: the ring has wrapped at slot 999
        ("qwen1.5-4b decode, ring wrapped", 4, 1, 2088, 20, 20, (128, 128),
         True, None, rows(4, 1, 3087), ring(3088, 2088, 4)),
        # hf:Qwen/Qwen1.5-4B's max_position_embeddings, one sequence
        ("qwen1.5-4b decode, B 1, Skv 32768", 1, 1, 32768, 20, 20,
         (128, 128), True, None, rows(1, 1, 32767), ring(32768, 32768, 1)),
        ("minitron-4b GQA 24/8 decode", 2, 1, 2088, 24, 8, (128, 128), True,
         None, rows(2, 1, 2080), ring(2081, 2088, 2)),
        ("d64 window 64 decode", 4, 1, 2088, 16, 16, (64, 64), True, 64,
         rows(4, 1, 2087), ring(2088, 2088, 4)),
        # MLA (deepseek-v2-lite-16b): 16 heads of q/k 192 (128 + 64 RoPE
        # dims) and v 128, the serve path's shapes, fresh and wrapped
        ("deepseek-v2-lite prefill", 4, 2048, 2088, 16, 16, (192, 128),
         True, None, rows(4, 2048), ring(2048, 2088, 4)),
        ("deepseek-v2-lite prefill, ring wrapped", 4, 2048, 2088, 16, 16,
         (192, 128), True, None, rows(4, 2048, 1040), ring(3088, 2088, 4)),
        ("deepseek-v2-lite decode", 4, 1, 2088, 16, 16, (192, 128), True,
         None, rows(4, 1, 2080), ring(2081, 2088, 4)),
        ("deepseek-v2-lite decode, ring wrapped", 4, 1, 2088, 16, 16,
         (192, 128), True, None, rows(4, 1, 3087), ring(3088, 2088, 4)),
    )
    worst = dict.fromkeys(FLASH + FLASH_MLA, 0.0)
    rep = {}
    for name, b, sq, skv, h, kvh, (d, dv), causal, window, qp, (kp, kval) \
            in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, k, v = randn(b, sq, h, d), randn(b, skv, kvh, d), \
            randn(b, skv, kvh, dv)
        args = (q, k, v, qp, kp, kval)
        kw = {"causal": causal, "window": window}
        got = fa.flash_attention(*args, **kw)
        plain = fa.flash_plain(*args, **kw)
        rep_kv = h // kvh
        dense = sdpa_ref(q, k.repeat_interleave(rep_kv, 2),
                         v.repeat_interleave(rep_kv, 2), qp, kp, kval, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K8 {name}: not finite")
        errs, limits = {}, {}
        for ref_name, ref in (("flash_plain", plain), ("sdpa_ref", dense)):
            errs[ref_name] = float((got.float() - ref.float()).abs().max())
            check(torch.allclose(got.float(), ref.float(), atol=FLASH_TOL,
                                 rtol=FLASH_TOL),
                  f"K8 {name} differs from {ref_name} by "
                  f"{errs[ref_name]}")
            if sq == 1:
                limits[ref_name] = decode_limit(ref)
                check(errs[ref_name] <= limits[ref_name],
                      f"K8 {name} differs from {ref_name} by "
                      f"{errs[ref_name]}, over {limits[ref_name]}")
        variant = "flash_decode" if sq == 1 else "flash_prefill"
        row = variant + ("_mla" if dv != d else "")
        worst[row] = max(worst[row], errs["flash_plain"])
        # the work these inputs need: 2*(d + dv) flops per unmasked (q, k)
        # pair; q, o and the positions moved once, K (at KVH heads) at the
        # slots some row may see, V there too or, when some row sees no key
        # (it averages V over every slot), at every slot
        allowed = attend_mask(qp, kp, kval, **kw)
        pairs = int(allowed.sum()) * h
        flops = 2 * (d + dv) * pairs
        seen = allowed.any(dim=1)
        v_rows = seen | (~allowed.any(dim=2)).any(dim=1)[:, None]
        nbytes = 2 * q.numel() + 2 * got.numel() + 2 * kvh * (
            d * int(seen.sum()) + dv * int(v_rows.sum())) \
            + 4 * qp.numel() + 4 * kp.numel() + kval.numel()
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = allowed[:, None]

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=h != kvh)
        rec = {"phase": "attention", "kernel": variant, "case": name,
               "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "KVH": kvh,
                         "D": d, "Dv": dv},
               "causal": causal, "window": window,
               "unmasked_pairs": pairs, "flops": flops, "bytes": nbytes,
               "ms": cuda_ms(torch, lambda: fa.flash_attention(*args, **kw),
                             10, per=10),
               "plain_ms": cuda_ms(torch, lambda: fa.flash_plain(*args, **kw),
                                   3, warm=1),
               "plain_device": "cuda",
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": cuda_ms(torch, library, 10, per=10),
               "library_call": "torch.nn.functional."
                               "scaled_dot_product_attention(attn_mask="
                               "bool, enable_gqa)",
               # device time alone, out of the profiler: at Sq 1 the
               # host's dispatch can outlast both calls' kernels
               "device_ms": device_ms(
                   torch, lambda: fa.flash_attention(*args, **kw)),
               "library_device_ms": device_ms(torch, library),
               "max_abs_err": errs["flash_plain"],
               "max_abs_err_sdpa_ref": errs["sdpa_ref"], "tol": FLASH_TOL}
        if variant == "flash_prefill":
            rec["device_tflops"] = flops / (rec["device_ms"] * 1e-3) / 1e12
            rec["ptxas"] = ptxas_usage(ptxas_log,
                                       f"prefill_kernelILi{d}ELi{dv}E")
            rec["smem_bytes"] = fa.prefill_smem_bytes(d, dv)
        else:
            rec["device_gb_s"] = nbytes / (rec["device_ms"] * 1e-3) / 1e9
            rec["decode_limit"] = limits
            group = min(g for g in (1, 2, 4, 8, fa.MAX_GROUP) if g >= rep_kv)
            rec["ptxas"] = ptxas_usage(
                ptxas_log, f"decode_kernelILi{d}ELi{dv}ELi{group}E")
        emit(rec)
        if name in ("qwen1.5-4b prefill", "qwen1.5-4b decode",
                    "deepseek-v2-lite prefill", "deepseek-v2-lite decode"):
            rep[row] = rec
    return rep, worst


def record_routes(L, replay=None) -> tuple:
    """Wrap `layers.moe_route` so that each call's `Route` is kept in call
    order; with `replay` (the routes of an earlier run on the same tokens,
    in call order) each call returns the next of those instead of its own
    choice. Returns (the kept routes, a function that takes the wrapper
    off)."""
    seen, inner = [], L.moe_route
    queue = iter(replay) if replay is not None else None

    def wrapped(router, h, m, s):
        route = inner(router, h, m, s) if queue is None else next(queue)
        seen.append(route)
        return route
    L.moe_route = wrapped
    return seen, lambda: setattr(L, "moe_route", inner)


def route_differences(a: list, b: list) -> tuple:
    """(token, layer) routing choices whose sets of experts differ between
    two runs' recorded routes, and all choices compared."""
    differ = total = 0
    for x, y in zip(a, b):
        differ += int((x.top_e.sort(-1).values != y.top_e.sort(-1).values)
                      .any(-1).sum())
        total += x.top_e.shape[0]
    return differ, total


def teacher_forced_gap(torch, L, fa, serve, res, routes=None,
                       replay: bool = False) -> dict:
    """The greedy run `res` (from `serve.serve` or `serve.generate` on the
    flash backend) against the same model fed the same tokens with dense
    attention ("auto", no K8 launch): each logit row's max and mean |d|
    and argmax agreement. For a MoE model, given the flash run's recorded
    `routes` (`record_routes`; its last pass is the one compared): with
    `replay` the dense run takes the flash run's routing choices, so the
    two differ only where attention rounds; without, it routes on its own
    and the share of (token, layer) routing choices that differ is
    reported."""
    from repro_torch.models.common import moe_layer_indices
    model, params, prompt = res["model"], res["params"], res["prompt"]
    g = res["tokens"].shape[1] - 1
    mine = None
    if routes is not None:
        calls = len(moe_layer_indices(model.cfg)) * (g + 1)
        mine = routes[-calls:]
    L.set_attention_backend("auto")
    fa.reset_launches()
    seen, restore = record_routes(L, mine if replay else None) \
        if mine is not None else ([], None)
    try:
        tf = serve.generate(model, params, prompt, g, res["cap"],
                            forced=res["tokens"])
    finally:
        L.set_attention_backend("flash")
        if restore:
            restore()
    check(sum(fa.LAUNCHES.values()) == 0, "the auto backend launched K8")
    steps = []
    for i, (a, r) in enumerate(zip(res["logits"], tf["logits"])):
        diff = (a - r).abs()
        steps.append({"step": i, "max_abs": float(diff.max()),
                      "mean_abs": float(diff.mean()),
                      "argmax_equal": int((a.argmax(-1) == r.argmax(-1))
                                          .sum())})
    out = {"max_abs": max(x["max_abs"] for x in steps),
           "mean_abs": max(x["mean_abs"] for x in steps),
           "argmax_agreement": sum(x["argmax_equal"] for x in steps)
           / (prompt.shape[0] * len(steps)),
           "auto_prefill_seconds": tf["prefill_seconds"],
           "auto_decode_ms_per_token": tf["decode_seconds"] / g * 1e3,
           "steps": steps}
    if mine is not None:
        check(len(seen) == len(mine), "the dense run routed another number "
              "of times than the flash run")
        differ, total = route_differences(mine, seen)
        out.update(routes_replayed=replay, route_choices=total,
                   route_choices_differing=differ,
                   route_differing_share=differ / max(total, 1))
    return out


def serve_phase(torch, kb, sj, fa, path: str, spec: dict,
                tol: tuple) -> dict:
    """Path `path`: the model of `spec` at full width through the serving
    launcher, K8's launches counted and checked (one a layer per prefill
    call and per decode step, K1-K7 none), then the teacher-forced check
    against dense attention within `tol` (max |d|, mean |d|), and a
    profile. For a MoE model the routing choices are recorded in both runs
    and the share that differs is reported. Returns the path's launch
    counts."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.model import Batch
    torch.cuda.empty_cache()
    moe = (get_config if spec["config"] == "full" else get_smoke_config)(
        spec["arch"]).moe is not None
    routes, restore = record_routes(L) if moe else (None, None)
    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = serve.serve(**spec, device="cuda")
    finally:
        if restore:
            restore()
    seconds = time.perf_counter() - t0
    counts = read()                   # just after
    peak = torch.cuda.max_memory_allocated()

    model, params, prompt = res["model"], res["params"], res["prompt"]
    b, s, g = spec["batch"], spec["prompt_len"], spec["gen_tokens"]
    n_layers = res["cfg"].n_layers
    runs = len(res["passes"])
    want = {"flash_prefill": n_layers * runs,
            "flash_decode": n_layers * g * runs}
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"{path} launched {name} {n} times, expected "
              f"{want.get(name, 0)}")
    vocab = res["cfg"].vocab_size
    check(tuple(res["tokens"].shape) == (b, g + 1)
          and int(res["tokens"].min()) >= 0
          and int(res["tokens"].max()) < vocab, f"{path}: bad tokens")
    for lg in res["logits"]:
        check(tuple(lg.shape) == (b, vocab)
              and bool(torch.isfinite(lg).all()), f"{path}: bad logits")
    t_pre, t_dec = res["prefill_seconds"], res["decode_seconds"]
    emit({"phase": "serve", "path": path, "arch": spec["arch"],
          "config": res["cfg"].name, "params": res["cfg"].param_count(),
          "batch": b, "prompt_len": s, "gen_tokens": g, "cap": res["cap"],
          "passes_seconds": res["passes"], "seconds": seconds,
          "prefill_seconds": t_pre, "prefill_tok_s": b * s / t_pre,
          "decode_ms_per_token": t_dec / g * 1e3,
          "decode_tok_s": b * g / t_dec, "peak_memory_bytes": peak,
          "launches": counts, "launches_expected": want,
          "sample": res["tokens"][0, :12].tolist()})

    # the check: the greedy tokens through dense attention; a MoE model's
    # dense run takes the flash run's routing choices (a flipped choice is
    # a discrete jump, not attention's rounding), after a run that routes
    # on its own, reported only, for the share of choices that flip
    if moe:
        free = teacher_forced_gap(torch, L, fa, serve, res, routes)
        free.pop("steps")
        emit({"phase": "serve", "path": path,
              "check": "teacher-forced vs auto, own routing (reported)",
              **free})
    gap = teacher_forced_gap(torch, L, fa, serve, res, routes, replay=moe)
    emit({"phase": "serve", "path": path, "check": "teacher-forced vs auto",
          "tol_max_abs": tol[0], "tol_mean_abs": tol[1], **gap})
    for x in gap["steps"]:
        check(x["max_abs"] <= tol[0] and x["mean_abs"] <= tol[1],
              f"{path} step {x['step']}: flash vs auto logits differ by "
              f"{x['max_abs']} (mean {x['mean_abs']})")

    # one prefill and one decode step under the profiler, uncounted
    cap = res["cap"]
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(
            params, Batch(prompt, prompt), cap=cap)

    def decode():
        tok = state["logits"][:, -1].argmax(-1)[:, None]
        model.decode_step(params, tok, state["caches"], s)
    for step, fn in (("prefill", prefill), ("decode", decode)):
        emit({"phase": "profile", "path": path, "step": step,
              **device_profile(torch, fn)})
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the slice phase")
    ap.add_argument("--phase", choices=("all", "kernels"), default="all",
                    help="kernels: phases 1-4 only, with no kernel table "
                         "and no ok line")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import bloom
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.bloom import ops as kb
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.semijoin import ops as sj

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    info = kbuild.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {name: {"seconds": s, "ptxas": [
              ln.strip() for ln in log.splitlines() if "Used" in ln]}
              for name, (s, log) in info.items()}})

    from repro_torch.tpch import generate
    t0 = time.perf_counter()
    cat = generate(sf=args.sf, seed=7)
    emit({"phase": "slice", "step": "generate", "sf": args.sf,
          "seconds": time.perf_counter() - t0,
          "lineitem_rows": len(cat["lineitem"])})
    api = api_inputs(np, cat)

    # the Bloom cases' device times and the route sweep run with
    # `--phase kernels` only: in a full run, with them, phase 7 read K8's
    # device times at about half their CUDA-event times on the H100
    # (cause not found), and the held cases raised phase 8's peak memory
    later = [] if args.phase == "kernels" else None
    rep, worst = kernel_phase(torch, np, kb, bloom, dev, api, later)
    jrep, jworst = joinmap_phase(torch, np, sj, bloom, dev, api, later)
    if args.phase == "kernels":
        device_times(torch, later)
        route_sweep(torch, np, kb, bloom, dev)
        joinmap_route_sweep(torch, np, sj, bloom, dev)
        probe_rows_sweep(torch, np, kb, bloom, dev)
        transfer_sweep(torch, np, kb, bloom, dev)
        return 0
    rep.update(jrep)
    worst.update(jworst)
    _, counts, oracle = slice_phase(torch, kb, sj, fa, cat, args.sf)
    counts["kernel-api"] = kernel_api_phase(torch, np, kb, sj, fa, bloom,
                                            dev, api)
    counts["serve-tpch"] = serve_tpch_phase(torch, kb, sj, fa, cat, args.sf,
                                            oracle)
    counts["curation"] = curation_phase(torch, np, kb, sj, fa)
    del cat, api
    arep, aworst = attention_phase(torch, fa, dev,
                                   info.get("flashattn", (0.0, ""))[1])
    rep.update(arep)
    worst.update(aworst)
    counts["serve"] = serve_phase(torch, kb, sj, fa, "serve", SERVE,
                                  (TF_MAX_ABS, TF_MEAN_ABS))
    counts["serve-deepseek"] = serve_phase(
        torch, kb, sj, fa, "serve-deepseek", SERVE_MLA,
        (TF_MLA_MAX_ABS, TF_MLA_MEAN_ABS))

    bloom_cu = "src/repro_torch/kernels/bloom/csrc/bloom.cu"
    semijoin_cu = "src/repro_torch/kernels/semijoin/csrc/semijoin.cu"
    flash_cu = "src/repro_torch/kernels/flashattn/csrc/flashattn.cu"
    # kernel: (source, TPU kernel it replaces, the path whose count is
    # its `launches`); every path's count is in `launches_by_path`
    table = {
        "multi_probe": (bloom_cu, "src/repro/kernels/bloom/bloom.py:151",
                        "pred-trans"),
        "bloom_build": (bloom_cu, "src/repro/kernels/bloom/bloom.py:218",
                        "pred-trans"),
        "probe": (bloom_cu, "src/repro/kernels/bloom/bloom.py:99",
                  "pred-trans-plane-off"),
        "joinmap_build": (semijoin_cu,
                          "src/repro/kernels/semijoin/semijoin.py:223",
                          "pred-trans-plane-off"),
        "joinmap_lookup": (semijoin_cu,
                           "src/repro/kernels/semijoin/semijoin.py:274",
                           "pred-trans-plane-off"),
        "semijoin_build": (semijoin_cu,
                           "src/repro/kernels/semijoin/semijoin.py:106",
                           "kernel-api"),
        "semijoin_probe": (semijoin_cu,
                           "src/repro/kernels/semijoin/semijoin.py:299",
                           "kernel-api"),
        "bloom_transfer": (bloom_cu, "src/repro/kernels/bloom/bloom.py:279",
                           "kernel-api"),
        "flash_prefill": (flash_cu,
                          "src/repro/kernels/flashattn/flashattn.py:79",
                          "serve"),
        "flash_decode": (flash_cu,
                         "src/repro/kernels/flashattn/flashattn.py:79",
                         "serve"),
        "flash_prefill_mla": (flash_cu,
                              "src/repro/kernels/flashattn/flashattn.py:79",
                              "serve-deepseek"),
        "flash_decode_mla": (flash_cu,
                             "src/repro/kernels/flashattn/flashattn.py:79",
                             "serve-deepseek"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[path][launched(name)],
         "launches_by_path": {p: c[launched(name)]
                              for p, c in counts.items()},
         "max_abs_err": worst[name], "ms": rep[name]["ms"],
         "plain_ms": rep[name]["plain_ms"],
         "plain_device": rep[name]["plain_device"],
         "bound_ms": rep[name]["bound_ms"],
         "bound_by": rep[name].get("bound_by", "bytes"),
         "library_ms": rep[name]["library_ms"],
         **{key: rep[name][key] for key in
            ("library_call", "device_ms", "library_device_ms")
            if key in rep[name]}}
        for name, (source, replaces, path) in table.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

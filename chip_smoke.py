#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1.0] [--phase all|kernels|train-sharded]

`--phase kernels` runs phases 1-4 only (to iterate on a kernel), then
each Bloom and hash-map case's device time alone, the route sweeps of
K2 and K4, the rows-a-thread sweep of K3 and the plan sweep of K7, and
prints neither the kernel table nor the ok line. `--phase train-sharded`
runs phase 14 alone (no kernel is built), with neither line either.

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
6c. dist   — the distributed runtime (`core/distributed.py`,
             `core/engine_join_dist.py`) on the card over the same
             catalog, four shards of one card (a `DataMesh` of `cuda:0`
             four times), three paths, each its own launch-count window.
             (a) `dist-api`: `BloomEngine.make_distributed_transfer` at
             Q5's first edge, σ(orders, o_orderdate in 1994)'s o_orderkey
             into lineitem's 6,001,215 l_orderkey (sharded 4 ways and
             bucketed by `shard_keys`), the filter sized by the engine for
             the live build keys, with the gather OR and the
             recursive-doubling OR: every shard's all-reduced words must
             equal the plain build (`build_ref`) over all the build keys
             and the mask the plain probe (`probe_ref`) of the whole
             column, bit for bit, and K2 on each shard (its padding mask
             as `valid`) must equal `build_ref` on that shard; then
             `distributed_semi_join` over the same shards must equal
             `torch.isin` and lie inside the Bloom mask. CUDA-event ms of
             a whole call each (host-bound: the shards' Python calls lie
             between the launches), and the transfer call's device ms
             under torch.profiler. It must launch K2 and K3 four times a call
             (one a shard) and never K1 or K4-K8. (b) `dist-exchange`: a
             `DistributedJoinEngine` over a 4-shard `MeshExchange`, its
             local engine the cuda backend with the plane on, joins
             lineitem's l_orderkey against orders' 1,500,000 o_orderkey:
             `broadcast_join_indices` and `shuffle_join_indices`, each
             called directly, must equal `sorted_join_indices` for inner,
             left, semi and anti; each line has each strategy's wire
             bytes, host seconds and `DeviceStats`. It launches no hand
             kernel (the exchange is `.to(device)` copies, the local joins
             the torch segment join). (c) `dist-tpch`: the 20 join
             queries, cold, through `Executor(engine="distributed",
             dist_shards=4)` with the cuda backends; the auto rule
             simulates the exchange unless four cards are visible
             (`report()["dist"]["device_backed"]` must follow it, so False
             on one card). Every result must have phase 5's
             eager-oracle md5; the summary line sums wire bytes, strategy
             counts, round trips and K1/K2 launches, and K1 and K2 must
             launch (K3-K8 never). Then Q5 once more under an
             `exchange.send` fault at one call index drawn by a seeded
             RNG: it must be retried in place (`report()["recoveries"]
             ["retries"]` >= 1, no ladder move) and stay md5-equal.
             (d) `dist-pod`: dist-api's transfer on a (2, 4) ("pod",
             "data") mesh of eight shards of the card (`DIST_POD`, shards
             pod-major), the filter ORed over "pod" and then "data", with
             the gather OR and the recursive-doubling OR: every shard's
             words must equal `build_ref` over all the build keys and the
             1-D mesh's words over the same 8 shards, the mask
             `probe_ref` of the whole column, bit for bit; 8 K2 and 8 K3
             launches a call, K1 and K4-K8 never; CUDA-event ms and
             device ms of a call, beside the card's name and power limit.
6d. torch-tpch — path `torch-tpch`: the 20 join queries through
             `Executor` with the plain-torch `torch` bloom and join
             backends (the reference's `jax` role: torch ops, no hand
             kernel) on the same catalog, the device-resident plane on
             and off, each query cold then warm; every result must have
             phase 5's eager-oracle md5, and no hand kernel (K1-K8) may
             launch in the path's window. Each line sets the warm seconds
             and round trips beside phase 5's cuda-backend run of the same
             query and plane, the summary line sums both. Then, outside
             the window, the largest plane-off map build — the orders
             keys (1,500,000 at SF 1) — timed alone through the plain
             build (`joinmap_build_torch`) and through K4;
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
             decode, each fresh and on a wrapped ring, the same at a
             (2, 2) mesh point's share (B 2, 8 heads: serve-sharded-mla's
             shapes), llava-next-mistral-7b's point (B 2, 16/4 heads,
             serve-sharded-llava's) prefill and decode, and mixtral-8x7b's
             heads (32/8, d 128, window 4096): prefill over 8192
             positions with no cache (the full forward's and the loss's
             shape, where the window masks and tiles wholly outside it
             are skipped) and decode at position 4100 on a wrapped
             4096-slot ring, and whisper-base's heads (8/8, d 64) at
             serve-whisper's shapes: the encoder's non-causal
             self-attention (B 16, 1500 x 1500 frames, its last key tile
             ragged), cross-attention at the prefill's 32 queries and at
             a decode step over the 1500 frames, every position 0, and
             the same three at a (2, 2) mesh point's share (B 8, 4 heads:
             serve-sharded-whisper's shapes). A decode line must
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
             over its device time). Also the shapes of context
             parallelism's mesh points: qwen1.5-4b's point on (1, 8)
             (serve-sharded-cp: 256 query rows of a 2048-token prefill
             against its 2048 keys; decode over a point's 259 slots) and
             on (2, 2) at batch 1 (serve-sharded-b1: decode over 16,384
             slots, 10 heads), and deepseek-v2-lite-16b's point on (2, 2)
             at batch 1 (serve-sharded-b1-mla: 8 heads at (192, 128), the
             32,744-row prefill against its own keys, whose plain version
             is timed on its one call and whose 34 GB of f32 scores keep
             `sdpa_ref` out, its library call SDPA with `is_causal`; decode
             over 16,384 slots), and its last point on (1, 3)
             (serve-sharded-seq-mla: 682 query rows of the 2,046-token
             prefill against every key; decode over its 690 slots, also
             timed with the log-sum-exp as the path runs it, `lse_ms`);
7a. lse    — K8 decode's log-sum-exp (`return_lse`, the merge of context
             parallelism) on the card at (128, 128), (64, 64) and MLA's
             (192, 128) (a batch-1 point's 8 heads over 16,384 slots, a
             (1, 3) point's 16 heads over 690),
             GQA groups 1 and 4: the output and the lse against
             `flash_plain`'s on the same inputs (the output within
             FLASH_TOL and `decode_limit`, the lse within `LSE_TOL`, -inf
             exactly where plain's is), then the cache cut into 2 and 4
             slot ranges whose last holds no valid key (its lse -inf), K8
             on each range, merged by `ops.merge_partials`, against the
             whole-cache K8 call within `decode_limit` (DECODE_ULPS);
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
10. serve-mixtral — path `serve-mixtral`: mixtral-8x7b at its published
             widths (d_model 4096, 32/8 heads of 128, window 4096, 8
             experts top-2 of d_ff 14336) cut from 32 to 16 layers (all 32
             are 93.4 GB of bf16; 16 are 47.0 GB), built here
             (`SERVE_MIXTRAL`) and served through
             `serve.serve_config` at batch 2, a 4080-token prompt and 32
             tokens: the ring holds the window, 4096 slots, and wraps at
             decode step 16. K8 launches 16 times per prefill call and per
             decode step, K1-K7 never; the teacher-forced check against
             "auto" with the flash run's routing choices replayed, within
             `TF_SWA_MAX_ABS` and `TF_SWA_MEAN_ABS`, and the share of
             routing choices that flip when the dense run routes on its
             own. The path's line adds the parameter and cache bytes
             reckoned beside the peak memory;
11. serve-mamba2 — path `serve-mamba2`: mamba2-370m uncut (48 Mamba-2
             layers, no attention) at batch 4, a 2048-token prompt and 32
             tokens: no hand kernel launches; the check is the prefill's
             and every decode step's logits against the full forward over
             the 2080 tokens fed (`full_forward_gap`), within
             `FULL_MAMBA_MAX_ABS` and `FULL_MAMBA_MEAN_ABS`. jamba-1.5-
             large-398b does not run here: one period of its pattern (8
             layers) is 45.1 B parameters, 90.3 GB of bf16;
11a. serve-whisper — path `serve-whisper`: whisper-base uncut (6
             encoder and 6 decoder layers, d_model 512, 8 heads of 64,
             0.097 B parameters) at batch 16, 1500 stub frames a clip
             (f32 N(0, 1), seed 2), a 32-token prompt and 96 tokens: the
             prefill encodes the frames and runs the decoder with its
             cross-attention, `generate` encodes once more for the decode
             steps. K8 launches 24 times per prefill call (6 encoder, 6
             self-attention, 6 cross-attention, 6 from `generate`'s
             encode) and 12 times per decode step (6 self, 6 cross);
             K1-K7 never. The teacher-forced check against "auto" (the
             same frames) within `TF_ENCDEC_MAX_ABS` and
             `TF_ENCDEC_MEAN_ABS`;
11b. serve-llava — path `serve-llava`: llava-next-mistral-7b uncut (32
             layers, d_model 4096, 32/8 heads of 128; 7.26 B parameters,
             14.52 GB of bf16) at batch 4, 576 stub patch positions
             before a 1472-token prompt and 32 tokens: the cache holds
             all 2048 prefill positions (cap 2088) and decode positions
             start at 2048. K8 launches 32 times per prefill call and per
             decode step, K1-K7 never; the teacher-forced check against
             "auto" (the same patches) within `TF_VLM_MAX_ABS` and
             `TF_VLM_MEAN_ABS`;
11c. launch-reports — path `launch-reports`: the launch layer's
             reckonings (`launch.dryrun`, `launch.analytic`) against the
             card for qwen1.5-4b at the serve path's shape
             (`LAUNCH_REPORTS`: batch 4, prompt 2048, cap 2088) on a
             one-device mesh: the dry run's argument bytes of the prefill
             (parameters + batch) and of a decode step (parameters +
             tokens + ring caches) must equal the bytes of the storages
             the model really allocates; `FlopCounterMode`'s count of one
             real prefill call ("auto" attention) over the cost model's
             must lie in `FLOP_RATIO_BOUNDS` (fixed before the first card
             run); the analytic compute and memory times beside the
             measured prefill seconds (K8) and decode device ms, and the
             bound's share of each. K8 launches on the served calls,
             K1-K7 never. Then the dry run's collective fields
             (`collectives`, `collective_bytes_per_device`,
             `collective_received_bytes_per_device`), counted from one
             point's step on the meta device, of qwen1.5-4b x decode_32k
             and deepseek-v2-lite-16b x decode_32k on (32, 8) and (2, 32,
             8), with each count's seconds (`LAUNCH_REPORT_CELLS`);
11d. serve-sharded — path `serve-sharded` (`SERVE_SHARDED`): mixtral-
             8x7b at its published widths cut to 4 layers, sharded over
             a (2, 2) ("data", "model") mesh of four points of the card
             through `serve.serve_config(..., mesh=...)`: the parameters
             drawn straight into their shards, every point on its own
             thread and stream, K8 on its 16 query and 4 kv heads, the
             row-parallel sums and the vocab-parallel embedding
             all-reduced, the logits all-gathered. K8 launches 16 times
             per prefill call and per decode step (4 layers x 4 points),
             K1-K7 never; each point must hold `dryrun.local_bytes` of
             `param_specs` and `cache_spec`'s share of the caches; the
             collective counts and bytes (`spmd.COMM`) must equal one
             point's pass counted on the meta device
             (`collectives.count_serve`) times the points and the passes,
             on every path 11d-11m. The check: the same
             model unsharded (`serve_config` on the same weights and
             tokens, run first under the mesh's abstract twin, so its MoE
             groups are the sharded run's), its greedy tokens fed to the
             sharded model with its routing choices replayed on each
             point, every logit row within `SHARDED_MAX_ABS` and
             `SHARDED_MEAN_ABS`; first the same routing on its own, its
             logits reported and its routing held to the unsharded run's
             (`sharded_route_check`: capacities, groups, the points of a
             data shard alike, a group's queues where its choices agree;
             at most `SHARDED_ROUTE_SHARE` of the choices differing);
11e. serve-sharded-mla — path `serve-sharded-mla` (`SERVE_SHARDED_MLA`):
             deepseek-v2-lite-16b at its published widths cut to 3 of
             27 layers at serve-deepseek's shape on
             (2, 2) of four points of the card, as 11d: MLA's latent and
             rope caches hold each point's columns and are all-gathered
             over "model" before the per-head expansion, K8 (192, 128)
             runs on each point's 8 heads (3 launches a point per
             prefill call and per decode step), 32 of the 64 experts a
             point; the check replays the routing within
             `SHARDED_MLA_MAX_ABS` and `SHARDED_MLA_MEAN_ABS`, its own
             routing consistent and at most `SHARDED_MLA_ROUTE_SHARE` of
             its choices differing;
11f. serve-sharded-llava — path `serve-sharded-llava`
             (`SERVE_SHARDED_LLAVA`): llava-next-mistral-7b cut to 8 of
             32 layers at
             serve-llava's shape on (2, 2) of four points of the card:
             the patches split with the prompt, projected by each point's
             columns of `patch_proj` and all-gathered, K8 (128, 128) on
             each point's 16/4 heads (8 launches a point a call); the
             check within `SHARDED_VLM_MAX_ABS` and `SHARDED_VLM_MEAN_ABS`;
11g. serve-sharded-mamba2 — path `serve-sharded-mamba2`
             (`SERVE_SHARDED_MAMBA`): mamba2-370m cut to 8 of 48 layers
             at serve-mamba2's
             shape on (2, 2) of four points of the card: each point
             projects with its columns of in_proj and all-gathers, runs
             the conv on its 1,152 channels and all-gathers, the SSD and
             the recurrent step on its 16 of 32 heads (its caches hold
             those channels and heads), out_proj's rows all-reduced; no
             hand kernel launches; the check within `SHARDED_SSM_MAX_ABS`
             and `SHARDED_SSM_MEAN_ABS`;
11h. serve-sharded-whisper — path `serve-sharded-whisper`
             (`SERVE_SHARDED_WHISPER`): whisper-base, its encoder whole
             and 2 of its 6 decoder layers, at serve-whisper's shape on
             (2, 2) of four points of the card: the frames split with the
             prompt, projected by each point's columns of `frame_proj`
             and all-gathered, K8 (64, 64) on each point's 4 of 8 heads
             in the encoder, the self-attention and the cross-attention
             (16 launches a point a prefill call, 4 a decode step), the
             vocabulary whole; the check within
             `SHARDED_ENCDEC_MAX_ABS` and `SHARDED_ENCDEC_MEAN_ABS`;
11i. serve-sharded-cp — path `serve-sharded-cp` (`SERVE_SHARDED_CP`):
             qwen1.5-4b at published widths cut to 16 of 40 layers (20
             heads, which 8 does not divide) on a
             (1, 8) mesh of eight points of the card, context parallel:
             the attention weights gathered over "model", each point's
             256 of the prompt's 2048 query rows against the gathered k
             and v (K8 prefill, Sq 256, Skv 2048), its 259 of the 2072
             cache slots, K8 decode on them with their log-sum-exp and
             the eight partials merged; each point's cache bytes held to
             `cache_spec`'s share, `spmd.COMM` to `spmd.serve_comm` (the
             formula of `parallel/spmd.py`'s note) and K8's calls to
             their (Sq, Skv); the check within `SHARDED_CP_MAX_ABS` and
             `SHARDED_CP_MEAN_ABS`;
11j. serve-sharded-b1 — path `serve-sharded-b1` (`SERVE_SHARDED_B1`):
             qwen1.5-4b uncut at batch 1, a 32,744-token prompt, 16
             tokens (cap 32,768, its published context) on (2, 2) of four
             points: the batch whole on each data point, the cache's
             length split over "data" and its kv heads over "model" (K8
             decode over 16,384 slots and 10 heads a point, the two data
             points' partials merged); held as 11i within
             `SHARDED_B1_MAX_ABS` and `SHARDED_B1_MEAN_ABS`;
11k. serve-sharded-b1-mla — path `serve-sharded-b1-mla`
             (`SERVE_SHARDED_B1_MLA`): deepseek-v2-lite-16b at published
             widths cut to 3 layers at batch 1, a 32,744-token prompt, 16
             tokens (cap 32,768) on (2, 2) of four points: MLA's latent
             and rope caches split by their slots over "data" at every
             column (16,384 slots a point), the call's latent gathered
             over "model", K8 (192, 128) prefill on the point's 8 heads
             at (32,744, 32,744) and decode over its 16,384 slots with
             the log-sum-exp, the data points' partials merged; `COMM`
             held to `spmd.serve_comm`, K8's calls to their (Sq, Skv), the
             check as 11e's within `SHARDED_B1_MLA_MAX_ABS` and
             `SHARDED_B1_MLA_MEAN_ABS`;
11l. serve-sharded-b1-mamba2 — path `serve-sharded-b1-mamba2`
             (`SERVE_SHARDED_B1_MAMBA`): mamba2-370m cut to 8 layers at
             batch 1, a 2,048-token prompt, 32 tokens on (2, 2): the SSM
             state's 16 heads a point by its "data" coordinate, its gated
             output gathered over "data" before out_proj's rows; `COMM`
             held to `spmd.serve_comm`, no hand kernel; the check within
             `SHARDED_B1_SSM_MAX_ABS` and `SHARDED_B1_SSM_MEAN_ABS`;
11m. serve-sharded-seq-mla — path `serve-sharded-seq-mla`
             (`SERVE_SHARDED_SEQ_MLA`): deepseek-v2-lite-16b at published
             widths cut to 3 layers, batch 4, a 2,046-token prompt, 16
             tokens (cap 2,070) on (1, 3) of three points, where 3
             divides none of its 16 heads, r and dr: MLA split by
             sequence, its leaves gathered over "model", K8 (192, 128)
             prefill on each point's 682 query rows against the 2,046
             gathered keys, decode over its 690 of the slots (every
             column) with the log-sum-exp, the three partials merged;
             `COMM` held to `spmd.serve_comm`, K8's calls to their (Sq,
             Skv), each point's cache bytes to a third of the whole, the
             check as 11e's within `SHARDED_SEQ_MLA_MAX_ABS` and
             `SHARDED_SEQ_MLA_MEAN_ABS`;
12. train  — path `train`: qwen1.5-4b at its full config (3.95 B
             parameters, bf16, random weights from seed 0) through
             `train.step.build_train_step` with AdamW (cosine schedule,
             peak 3e-4) and `TrainConfig(microbatches=2, remat=True)`, as
             `launch/train.py` sets it, at batch 4 x 2048 tokens for
             `TRAIN["steps"]` steps on one repeated batch, once the serving
             models are freed. First the bytes reckoned (bf16 params and
             gradients, f32 accumulation, f32 m and v) and, on the same
             weights cast to f32 and the same batch, one f32 step's loss
             and gradient (`GradNorm`, no moments), with two controls
             beside it: accumulation in bf16, and one microbatch's
             gradient dropped. Gates: every loss finite, the last at
             least `TRAIN_LOSS_DROP` under the first, the first bf16 step
             within `TRAIN_ORACLE_LOSS_ABS` and `TRAIN_ORACLE_GNORM_REL`
             of the f32 step, the dropped microbatch outside them (the
             f32 step is the port's own, so this checks precision, not
             the algorithm: the CPU tests do that); no hand kernel
             launches (training runs attention on "auto": K8 has no
             backward). Prints each step's loss, gradient norm and
             seconds, the mean step seconds after the first two, tokens a
             second, the model-FLOP share of 989 TFLOP/s (6 N tokens over
             the step), the peak memory, and one more step under
             torch.profiler (device busy share);
13. train-ft — path `train-ft`: `FaultTolerantTrainer` over a
             `CheckpointManager` (keep 1, a temporary directory removed at
             the end) at the same width with one layer: `TRAIN_FT["steps"]`
             steps straight, then the same run preempted at step
             `TRAIN_FT["preempt"]` and resumed by a new trainer, with
             deterministic algorithms on; the losses and the final
             parameters and optimizer state must be bit-equal. Prints the
             bytes a checkpoint holds and the save and restore seconds.
14. train-sharded — path `train-sharded` (`TRAIN_SHARDED`): qwen1.5-4b
             at its published widths cut to 8 layers through
             `build_train_step(..., mesh=)` on a (2, 2) ("data", "model")
             mesh of four points of the card, FSDP on, the train path's
             TrainConfig and batch. The f32 gate (`sharded_train_gate`):
             one AdamW step from the same f32 weights sharded and
             unsharded, the loss within `SHARDED_TRAIN_LOSS_ABS`, the
             gradient norm within `SHARDED_TRAIN_GNORM_REL`, every leaf's
             gradient within `SHARDED_TRAIN_GRAD_REL`, the parameters
             after the step within `SHARDED_TRAIN_PARAM_REL` and their
             updates within `SHARDED_TRAIN_UPDATE_REL` relative L2; its
             control (the gradient of data shard 0's rows only) outside
             them. Then `TRAIN_SHARDED["steps"]` bf16 steps on one
             repeated batch: every loss finite and each under the one
             before; `spmd.COMM` equal to `spmd.train_comm` (the formula
             of `parallel/spmd.py`'s note) times the steps, and to one
             point's step counted on the meta device
             (`collectives.count`) times the points and steps; each
             point's parameter bytes `dryrun.local_bytes` of the specs; no
             hand kernel launches (attention on "auto"). Prints the step
             seconds, tokens a second and the peak memory beside the
             card's name and power limit, and one more step under
             torch.profiler (the summed device time of the four points'
             streams).
f32 matmuls run with TF32 off (`torch.backends.cuda.matmul.allow_tf32 =
False`) throughout, so the plain versions and oracles sum in f32.

The line before the last is the kernel table (K8's MLA shapes in rows
of their own, `flash_prefill_mla` and `flash_decode_mla`, whose
launches are path `serve-deepseek`'s, and its (64, 64) shapes in
`flash_prefill_d64` and `flash_decode_d64`, at whisper's encoder and
cross decode shapes, whose launches are path `serve-whisper`'s)
`{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "plain_device", "bound_ms", "bound_by",
"library_ms", "launches_by_path"}]}` (`launches_by_path` has every
path's count, the `dist-*` (`dist-pod` too), `launch-reports`,
`torch-tpch`, `serve-mixtral`,
`serve-mamba2`, `serve-whisper`, `serve-llava`, `serve-sharded`,
`serve-sharded-mla`, `serve-sharded-llava`, `serve-sharded-mamba2`,
`serve-sharded-whisper`, `serve-sharded-cp`, `serve-sharded-b1`,
`serve-sharded-b1-mla`, `serve-sharded-b1-mamba2`,
`serve-sharded-seq-mla`, `train`, `train-ft` and `train-sharded` paths'
included (K8's (128, 128) rows count `serve-mixtral`'s, `serve-llava`'s,
`serve-sharded`'s, `serve-sharded-llava`'s, `serve-sharded-cp`'s and
`serve-sharded-b1`'s launches there, its MLA
rows `serve-sharded-mla`'s, `serve-sharded-b1-mla`'s and
`serve-sharded-seq-mla`'s, its (64, 64)
rows `serve-sharded-whisper`'s; every kernel 0 on `torch-tpch`,
`serve-mamba2`, `serve-sharded-mamba2`, `serve-sharded-b1-mamba2`,
`train`, `train-ft` and `train-sharded`); `plain_device` says where
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
import threading
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
#: serve-mixtral: mixtral-8x7b at its published widths (d_model 4096,
#: 32/8 heads of 128, 8 experts top-2 of d_ff 14336, window 4096) cut from
#: 32 to 16 layers: all 32 are 46.70 B parameters, 93.4 GB of bf16, more
#: than one 80 GB card holds; 16 are 23.48 B, 46.96 GB. Batch 2, a
#: 4080-token prompt and 32 greedy tokens: cap 4120 is capped at the
#: window, so the ring wraps at decode step 16 (position 4096) and decode
#: runs on a ring whose positions are not monotone
SERVE_MIXTRAL = {"arch": "mixtral-8x7b", "config": "full", "layers": 16,
                 "batch": 2, "prompt_len": 4080, "gen_tokens": 32}
#: Its teacher-forced check against "auto", the dense run taking the flash
#: run's routing choices, as deepseek's. On the CPU (`tools/tf_gap.py
#: --arch mixtral-8x7b`, flash_plain, full width, batch 2, prompt 256, 6
#: steps) the replayed run lies max |d| 0.0625 / 0.070 / 0.078 and mean
#: 0.0091 / 0.0117 / 0.0124 from the flash run at 1 / 2 / 4 layers; at the
#: deepseek bounds' growth of about x1.25 a doubling, about 0.12 / 0.019 at
#: 16 layers. The bounds leave twice that, the same as qwen1.5-4b's and
#: deepseek's. The logits have std ~1.3 at init (unembed scale 0.02 *
#: sqrt(4096)): a wrong window, ring slot or position moves them by about
#: that. Routing on its own, the dense run flips 0.2% / 0.3% / 2.9% of
#: (token, layer) choices and then lies max 3.77 / mean 0.34 away at 4
#: layers: that run is reported, not gated.
TF_SWA_MAX_ABS = 0.25
TF_SWA_MEAN_ABS = 0.04
#: serve-mamba2: mamba2-370m uncut (48 layers, d_model 1024, d_state 128,
#: head_dim 64, chunk 256; 0.368 B parameters with tied embeddings) at
#: batch 4, a 2048-token prompt and 32 tokens
SERVE_MAMBA = {"arch": "mamba2-370m", "config": "full", "batch": 4,
               "prompt_len": 2048, "gen_tokens": 32}
#: Its check (no attention, so flash against auto would be vacuous): the
#: prefill's and each decode step's logits against the full forward's over
#: the 2080 tokens fed (2080 % 256 = 32: the padded chunk path). The two
#: round at other places in bf16: the prefill's conv is d_conv shifted
#: multiply-adds, the decode step's a dot over the conv window, and the
#: decode's residual stream rounds each step where the full forward's
#: rounds a whole sequence. Measured on the CPU (`tools/tf_gap.py --arch
#: mamba2-370m`, full width, batch 2, prompt 300, 8 tokens): max |d|
#: 0.035 / 0.047 / 0.070 / 0.099 and mean 0.0053 / 0.0071 / 0.012 / 0.017
#: at 2 / 4 / 8 / 16 layers, the same at prompt 2048 (4 and 16 layers);
#: about x1.4 a doubling, so about 0.17 / 0.029 at 48. The bounds leave
#: twice that. The logits have std ~0.64 at init (tied embeddings of
#: scale 0.02 * sqrt(1024)): a conv window or SSM state handed over wrong
#: moves them by about that, far above the bounds.
FULL_MAMBA_MAX_ABS = 0.35
FULL_MAMBA_MEAN_ABS = 0.06
#: serve-whisper: whisper-base uncut (6 encoder and 6 decoder layers,
#: d_model 512, 8 heads of 64; 0.097 B parameters, 0.195 GB of bf16) at
#: batch 16, 1500 stub frames a clip, a 32-token prompt and 96 greedy
#: tokens: cap 32 + 96 + 8 = 136, inside its 448-token decoder context.
#: K8 at (64, 64): the encoder's non-causal 1500 x 1500 calls, the
#: decoder's causal ones on the ring, cross-attention over the 1500
#: frames (Sq 32 at prefill, 1 a step, every position 0)
SERVE_WHISPER = {"arch": "whisper-base", "config": "full", "batch": 16,
                 "prompt_len": 32, "gen_tokens": 96}
#: Its teacher-forced check against "auto", fed the same frames and tokens.
#: On the CPU (`tools/tf_gap.py --arch whisper-base`, flash_plain, full
#: width) the flash run lies max |d| 0.0195 / 0.0166 / 0.0195 and mean
#: 0.0025 / 0.0027 / 0.0028 from the dense run at 2 / 4 / 6 decoder layers
#: (batch 2, prompt 32, 16 tokens), and 0.0234 / 0.0028 uncut at this
#: path's batch 16, prompt 32 and 96 tokens: the gap hardly grows with
#: depth. The bounds leave about 2.5 times that. The logits have std
#: ~0.45 at init (unembed scale 0.02 * sqrt(512)): a wrong mask, position
#: or encoder output moves them by about that
TF_ENCDEC_MAX_ABS = 0.06
TF_ENCDEC_MEAN_ABS = 0.008
#: serve-llava: llava-next-mistral-7b uncut (32 layers, d_model 4096,
#: 32/8 heads of 128, no window; 7.26 B parameters, 14.52 GB of bf16) at
#: batch 4, 576 stub patch positions before a 1472-token prompt (2048
#: positions) and 32 greedy tokens: cap 576 + 1472 + 32 + 8 = 2088, the
#: Skv of qwen1.5-4b's serve path; decode positions start at 2048
SERVE_LLAVA = {"arch": "llava-next-mistral-7b", "config": "full",
               "batch": 4, "prompt_len": 1472, "gen_tokens": 32}
#: Its teacher-forced check against "auto", fed the same patches and
#: tokens. On the CPU (`tools/tf_gap.py --arch llava-next-mistral-7b`,
#: flash_plain, full width, batch 2, the 576 patches and a 256-token
#: prompt, 6 tokens) the flash run lies max |d| 0.047 / 0.064 / 0.098 /
#: 0.154 / 0.172 and mean 0.0082 / 0.0119 / 0.0170 / 0.0231 / 0.0307 from
#: the dense run at 1 / 2 / 4 / 8 / 16 layers: it grows faster than
#: qwen1.5-4b's (likely as the patch rows' residual stream is O(1), the
#: tokens' O(0.02), so attention's output weighs more), x1.12 (max) and x1.33
#: (mean) from 8 to 16, so about 0.23 / 0.041 at 32. The bounds leave
#: about twice that. The logits have std ~1.3 at init (unembed scale
#: 0.02 * sqrt(4096)): patches dropped from the cache, a wrong position
#: or mask move the mean |d| by a share of that, well above 0.08
TF_VLM_MAX_ABS = 0.5
TF_VLM_MEAN_ABS = 0.08
#: phases 8-11b in order: path -> (spec, its check's (max, mean) bounds)
SERVE_PATHS = {
    "serve": (SERVE, (TF_MAX_ABS, TF_MEAN_ABS)),
    "serve-deepseek": (SERVE_MLA, (TF_MLA_MAX_ABS, TF_MLA_MEAN_ABS)),
    "serve-mixtral": (SERVE_MIXTRAL, (TF_SWA_MAX_ABS, TF_SWA_MEAN_ABS)),
    "serve-mamba2": (SERVE_MAMBA, (FULL_MAMBA_MAX_ABS, FULL_MAMBA_MEAN_ABS)),
    "serve-whisper": (SERVE_WHISPER, (TF_ENCDEC_MAX_ABS,
                                      TF_ENCDEC_MEAN_ABS)),
    "serve-llava": (SERVE_LLAVA, (TF_VLM_MAX_ABS, TF_VLM_MEAN_ABS)),
}
#: serve-sharded: mixtral-8x7b at its published widths cut to 4 of its 32
#: layers (5.9 B parameters, 11.8 GB of bf16; 8 layers until the smoke
#: outgrew its time limit), served sharded on a (2, 2) ("data",
#: "model") mesh of four points of the card (`cuda:0` x 4, `spmd.run`: a
#: thread and a stream a point) at serve-mixtral's batch, prompt and
#: tokens. fsdp off (`dryrun.serve_fsdp`): each point holds half the
#: model (its 16 of 32 query heads, 4 of 8 kv heads, 4 of 8 experts,
#: 16,000 of the 32,000 vocabulary rows and columns), so the data axis
#: of 2 holds it twice, the unsharded run's weights freed before
SERVE_SHARDED = {"arch": "mixtral-8x7b", "config": "full", "layers": 4,
                 "batch": 2, "prompt_len": 4080, "gen_tokens": 32,
                 "mesh": (2, 2)}
#: Its check: the sharded run fed the unsharded greedy run's tokens,
#: taking its routing choices, against its logits. They differ where the
#: sharded sums round: wo's, w2's and the combine's partial products are
#: rounded to bf16 on each point before their f32 sum (one rounding
#: unsharded), and K8's decode splits the cache by local heads. On the
#: CPU (`tools/tf_gap.py --arch mixtral-8x7b --mesh 2x2 --device cpu`,
#: K8's plain version, full width, batch 2, prompt 256, 6 steps),
#: replayed: max |d| 0.0469 / 0.0664 / 0.0674 and mean 0.0080 / 0.0110
#: / 0.0114 at 1 / 2 / 4 layers (4 layers served; at 8, as served
#: before, the run read 0.0859 / 0.0136). Routing on its own it lies
#: 0.0547 / 0.1133 / 0.125 and 0.0085 / 0.0158 / 0.0189 away (reported,
#: not gated). The bounds are serve-mixtral's, over twice that; the
#: logits have std ~1.3 at init: a wrong shard, head, expert or sum
#: moves them by about that
SHARDED_MAX_ABS = 0.25
SHARDED_MEAN_ABS = 0.04
#: The sharded run routing on its own: the most of its (token, layer)
#: choices whose experts may differ from the unsharded run's. The sums'
#: rounding moves the residual about as much as K8 against dense
#: attention does (replayed gaps 0.0859 / 0.0136 here against
#: serve-mixtral's 0.0938 / 0.0143), and there 7.55% of mixtral's
#: choices flip at 16 layers; twice that. A fault in the sharded MoE
#: (a wrong expert row, capacity or sum) moves later layers' residual
#: by its own scale, which flips a choice of top-2 of 8 at random
SHARDED_ROUTE_SHARE = 0.15
#: serve-sharded-mla: deepseek-v2-lite-16b uncut (27 layers, d_model 2048,
#: MLA with 16 heads, r 512, dr 64; 64 experts top-6 + 2 shared; 15.7 B
#: parameters, 31.4 GB of bf16) at serve-deepseek's batch, prompt and
#: tokens on a (2, 2) mesh of four points of the card, fsdp off
#: (`dryrun.serve_fsdp`): a point holds 8 of 16 heads, 32 of 64 experts,
#: 13 of the shared experts' 26 stacked layers and half the vocabulary,
#: about 15.7 GB; the data axis of 2 holds it twice, 62.8 GB on the card,
#: about 72 GB at the draws' peak (one full 9.6 GB leaf of stacked
#: experts beside the shards), the unsharded run's 31.4 GB freed first.
#: K8 at (192, 128) on each point's 8 heads, against the whole latent
#: and rope caches gathered over "model". Served cut to 3 of the 27
#: layers (the dense first and 2 MoE layers, whose shared experts'
#: stacked layers split one a point; uncut until the smoke outgrew its
#: time limit): a point then holds about a ninth of the above
SERVE_SHARDED_MLA = {"arch": "deepseek-v2-lite-16b", "config": "full",
                     "layers": 3, "batch": 4, "prompt_len": 2048,
                     "gen_tokens": 32, "mesh": (2, 2)}
#: Its check, set before the path's first card run. On the CPU
#: (`tools/tf_gap.py --arch deepseek-v2-lite-16b --mesh 2x2 --device
#: cpu`, K8's plain version, full width, batch 2, prompt 256, 6 steps),
#: replayed: max |d| 0.0352 / 0.0471 / 0.0612 and mean 0.0056 / 0.0078 /
#: 0.0099 at 1 / 2 / 4 layers; at x1.3 a doubling, about 0.13 / 0.019 at
#: 27. The bounds are serve-deepseek's, about twice the uncut reckoning
SHARDED_MLA_MAX_ABS = 0.25
SHARDED_MLA_MEAN_ABS = 0.04
#: Its own routing: 5.5% / 7.3% of (token, layer) choices differ at 2 / 4
#: layers (one / three MoE layers; 0.0474 / 0.256 max |d|), as the
#: unsharded flash run against "auto" flipped 5% / 8% / 14% at 2 / 4 / 8
#: layers on the CPU and 27% at 27 on the card (path serve-deepseek's
#: reported own-routing run): about 27% here, and the bound about twice
#: that. Top-6 of 64 flips far more than
#: mixtral's top-2 of 8; a fault (a wrong expert, shard or sum) moves the
#: residual by its own scale, which leaves a token's set of six experts
#: as it was only by chance, so nearly every choice differs
SHARDED_MLA_ROUTE_SHARE = 0.5
#: serve-sharded-llava: llava-next-mistral-7b uncut (32 layers, d_model
#: 4096, 32/8 heads of 128; 7.26 B parameters, 14.52 GB of bf16) at
#: serve-llava's batch, patches, prompt and tokens on a (2, 2) mesh of
#: four points of the card, fsdp off: 29 GB of shards on the card. The
#: patch prefix projected by each point's columns of `patch_proj` and
#: all-gathered; K8 at (128, 128) on each point's 16 query and 4 kv
#: heads. Served cut to 8 of the 32 layers (uncut until the smoke
#: outgrew its time limit)
SERVE_SHARDED_LLAVA = {"arch": "llava-next-mistral-7b", "config": "full",
                       "layers": 8, "batch": 4, "prompt_len": 1472,
                       "gen_tokens": 32, "mesh": (2, 2)}
#: Its check, set before the path's first card run. On the CPU
#: (`tools/tf_gap.py --arch llava-next-mistral-7b --mesh 2x2 --device
#: cpu`, full width, batch 2, the 576 patches and a 256-token prompt, 6
#: steps): max |d| 0.0469 / 0.0649 / 0.0938 and mean 0.0078 / 0.0112 /
#: 0.0159 at 1 / 2 / 4 layers; at the x1.44 / x1.42 a doubling from 2 to
#: 4, about 0.28 / 0.045 at 32, an upper reckoning (serve-llava's gap
#: grew x1.12 / x1.33 from 8 to 16). The bounds are serve-llava's. The
#: logits have std ~1.3 at init: a patch column on the wrong point, a
#: wrong shard or sum moves the mean |d| by a share of that
SHARDED_VLM_MAX_ABS = 0.5
SHARDED_VLM_MEAN_ABS = 0.08
#: serve-sharded-mamba2: mamba2-370m uncut (48 layers, d_model 1024, 32
#: heads of 64, state 128; 0.368 B parameters, 0.74 GB of bf16) at
#: serve-mamba2's batch, prompt and tokens on a (2, 2) mesh of four
#: points of the card, fsdp off: a point holds 2,192 of in_proj's 4,384
#: columns, 1,152 of the conv's 2,304 channels, 1,024 of out_proj's 2,048
#: rows (16 heads) and 25,140 of the 50,280 tied embedding rows, about
#: 0.39 GB; its caches 2 rows x (3 x 1,152 conv entries in bf16 + 16 x 64
#: x 128 SSM entries in f32) a layer, 50.9 MB in all. No hand kernel.
#: Served cut to 8 of the 48 layers (uncut until the smoke outgrew its
#: time limit)
SERVE_SHARDED_MAMBA = {"arch": "mamba2-370m", "config": "full",
                       "layers": 8, "batch": 4, "prompt_len": 2048,
                       "gen_tokens": 32, "mesh": (2, 2)}
#: Its check, set before the path's first card run: the sharded run fed
#: the unsharded greedy run's tokens, against its logits. They differ
#: where out_proj's partial products are rounded to bf16 on each point
#: before their f32 sum (the gathers move values unchanged). On the CPU
#: (`tools/tf_gap.py --arch mamba2-370m --mesh 2x2 --device cpu`, full
#: width, batch 2, prompt 256, 6 steps): max |d| 0.0625 / 0.0313 /
#: 0.0391 and mean 0.0018 / 0.0036 / 0.0063 at 1 / 2 / 4 layers, then
#: 0.0752 / 0.102 / 0.182 and 0.0101 / 0.0162 / 0.0296 at 8 / 16 / 48
#: (uncut): the mean about x1.6 a doubling. The bounds are
#: serve-mamba2's, about twice the uncut reading (over four times the
#: 8-layer one, as served); the logits have std
#: ~0.64 at init: a head, channel or state on the wrong point moves them
#: by about that
SHARDED_SSM_MAX_ABS = 0.35
SHARDED_SSM_MEAN_ABS = 0.06
#: serve-sharded-whisper: whisper-base uncut (6 encoder and 6 decoder
#: layers, d_model 512, 8 heads of 64, vocabulary 51,865; 0.097 B
#: parameters, 0.195 GB of bf16) at serve-whisper's batch, frames, prompt
#: and tokens on a (2, 2) mesh of four points of the card, fsdp off: the
#: frames split with the prompt (8 clips a data shard), projected by each
#: point's 256 columns of `frame_proj` and all-gathered; K8 at (64, 64)
#: on each point's 4 of 8 heads in the encoder, the self-attention and
#: the cross-attention; the vocabulary (51,865 divides neither 2 nor 4)
#: whole on every point: the embedding a plain lookup, no logits gather.
#: Served with 2 of its 6 decoder layers (the encoder's 6 whole; uncut
#: until the smoke outgrew its time limit)
SERVE_SHARDED_WHISPER = {"arch": "whisper-base", "config": "full",
                         "layers": 2, "batch": 16, "prompt_len": 32,
                         "gen_tokens": 96, "mesh": (2, 2)}
#: Its check, set before the path's first card run. They differ where
#: the row-parallel sums round (wo's in the encoder, the self- and the
#: cross-attention, w2's) and K8 takes 4 heads a call. On the CPU
#: (`tools/tf_gap.py --arch whisper-base --mesh 2x2 --device cpu
#: --prompt-len 32 --gen-tokens 16`, K8's plain version, full width and
#: encoder, batch 2): max |d| 0.0156 / 0.0156 / 0.0195 / 0.0195 and mean
#: 0.0021 / 0.0025 / 0.0029 / 0.0031 at 1 / 2 / 4 / 6 (uncut) decoder
#: layers: it hardly grows with depth. The bounds are serve-whisper's,
#: about three and two and a half times the uncut reading (the path's
#: batch 16 and 96 tokens give the max more rows); the logits have std
#: ~0.45 at init: a frame column, head or sum on the wrong point moves
#: them by about that
SHARDED_ENCDEC_MAX_ABS = 0.06
SHARDED_ENCDEC_MEAN_ABS = 0.008
#: serve-sharded-cp: qwen1.5-4b uncut (40 layers, d_model 2560, 20/20
#: heads of 128, d_ff 6912, vocabulary 151,936; 3.95 B parameters) at
#: batch 4, a 2048-token prompt and 16 tokens on a (1, 8) mesh of eight
#: points of the card, the production mesh's model axis (ROADMAP, the
#: launch layer: (32, 8)). 8 divides neither 20 heads: the reference lays
#: attention out by sequence ("seq"). fsdp off: a point holds an eighth
#: of every weight (its columns of wq, wk, wv, w1, w3 and the LM head, its
#: rows of wo, w2 and the embedding), about 1 GB; its cache 259 of the
#: 2072 slots, 0.42 GB (the whole cache, which each point held before the
#: sequence split, is 3.39 GB). Served cut to 16 of the 40 layers (uncut
#: until the two batch-1 paths of MLA and Mamba-2 took the smoke past its
#: time budget, this path being the longest sharded one)
SERVE_SHARDED_CP = {"arch": "qwen1.5-4b", "config": "full", "layers": 16,
                    "batch": 4, "prompt_len": 2048, "gen_tokens": 16,
                    "mesh": (1, 8),
                    "k8_shapes": {"prefill": (256, 2048),
                                  "decode": (1, 259)}}
#: Its check, set before the path's first card run. They differ where w2's
#: partial products are rounded to bf16 on each point before their f32
#: sum, and where each point's decode output over its slots is rounded
#: to bf16 before the merge (a point's rows and the gathers move values
#: unchanged). On the CPU (`tools/tf_gap.py --arch qwen1.5-4b --mesh 1x8
#: --batch 2 --prompt-len 256 --gen-tokens 8 --device cpu`, K8's plain
#: version, full width): max |d| 0.0469 / 0.0625 / 0.0706 / 0.0781 /
#: 0.0889 and mean 0.0071 / 0.0095 / 0.0112 / 0.0127 / 0.0137 at 1 / 2 /
#: 4 / 8 / 16 layers: x1.14 and x1.08 a doubling by 16, about 0.10 /
#: 0.015 at 40. The bounds are serve's (`TF_MAX_ABS`), about two and a
#: half times that (the path's batch 4 and 16 tokens give the max more
#: rows); the logits have std ~1.3 at init: a slot range, a row or a
#: merge weight gone wrong moves them by a share of that
SHARDED_CP_MAX_ABS = 0.25
SHARDED_CP_MEAN_ABS = 0.04
#: serve-sharded-b1: qwen1.5-4b uncut at batch 1, which the data axis of 2
#: does not divide, a 32,744-token prompt and 16 tokens (cap 32,768,
#: hf:Qwen/Qwen1.5-4B's max_position_embeddings) on (2, 2) of four points
#: of the card: the batch whole on every point, the cache's length split
#: over "data" (16,384 slots a point) and its 20 kv heads over "model" (10
#: a point): 3.36 GB a point, where the whole batch's cache on each data
#: point held 6.71 GB
SERVE_SHARDED_B1 = {"arch": "qwen1.5-4b", "config": "full", "batch": 1,
                    "prompt_len": 32744, "gen_tokens": 16, "mesh": (2, 2),
                    "k8_shapes": {"prefill": (32744, 32744),
                                  "decode": (1, 16384)}}
#: Its check, set before the path's first card run (`tools/tf_gap.py --arch
#: qwen1.5-4b --mesh 2x2 --batch 1 --prompt-len 256 --gen-tokens 6
#: --device cpu`): max |d| 0.0488 / 0.0625 / 0.0781 / 0.0781 and mean
#: 0.0075 / 0.0098 / 0.0115 / 0.0133 at 1 / 2 / 4 / 8 layers (wo's and
#: w2's sums over "model", the two data points' decode partials merged),
#: about 0.10 / 0.016 at 40 as above. The bounds are serve's, as for
#: serve-sharded-cp: the path's 32,744-token prompt adds no rounding a
#: token (each sum is a token's own), and its decode outputs, averages
#: over more keys, are smaller
SHARDED_B1_MAX_ABS = 0.25
SHARDED_B1_MEAN_ABS = 0.04
#: serve-sharded-b1-mla: deepseek-v2-lite-16b at its published widths (16
#: heads, r 512, dr 64; 64 experts top-6 + 2 shared) cut to 3 layers, as
#: serve-sharded-mla is (the dense first layer and 2 MoE layers), at batch
#: 1, a 32,744-token prompt and 16 tokens (cap 32,768, its published 32k
#: context) on (2, 2) of four points of the card, fsdp off: the batch
#: whole on every point, MLA's latent and rope caches split by their slots
#: over "data" at every column (`cache_spec`'s `P(None, "data", None)`:
#: 16,384 slots x 576 columns a layer a point), the call's latent gathered
#: over "model" instead of the cache, K8 (192, 128) on each point's 8
#: heads over its slots with the log-sum-exp, the two data points'
#: partials merged
SERVE_SHARDED_B1_MLA = {"arch": "deepseek-v2-lite-16b", "config": "full",
                        "layers": 3, "batch": 1, "prompt_len": 32744,
                        "gen_tokens": 16, "mesh": (2, 2),
                        "k8_shapes": {"prefill": (32744, 32744),
                                      "decode": (1, 16384)}}
#: Its check, set before the path's first card run (`tools/tf_gap.py --arch
#: deepseek-v2-lite-16b --mesh 2x2 --batch 1 --prompt-len 256 --gen-tokens
#: 6 --device cpu`, K8's plain version, full width): replayed, max |d|
#: 0.0391 / 0.0508 / 0.0625 and mean 0.0067 / 0.0089 / 0.0102 at 1 / 2 /
#: 3 layers; routing on its own 6.1% / 5.2% of the choices differ at 2 / 3
#: layers. The bounds are serve-sharded-mla's, four times the 3-layer
#: reading (the 32,744-token prompt adds no rounding a token: each sum is
#: a token's own); a slot range, merge weight or head on the wrong point
#: moves the logits (std ~1.3) by a share of their scale
SHARDED_B1_MLA_MAX_ABS = SHARDED_MLA_MAX_ABS
SHARDED_B1_MLA_MEAN_ABS = SHARDED_MLA_MEAN_ABS
#: serve-sharded-b1-mamba2: mamba2-370m at its published widths (32 heads of
#: 64, state 128) cut to 8 layers, as serve-sharded-mamba2 is, at batch 1,
#: a 2,048-token prompt and 32 tokens on (2, 2) of four points of the
#: card: the SSM state's heads split over "data" (16 of the 32 by the
#: point's data coordinate, whole over "model"), the conv window's 1,152
#: of 2,304 channels by its model coordinate (`cache_spec`); a point runs
#: the SSD and the recurrent step on its SSM heads, gathers their gated
#: output over "data" and multiplies its out_proj rows' heads of it. The
#: state does not grow with the prompt: a longer one adds time and nothing
#: to check. No hand kernel
SERVE_SHARDED_B1_MAMBA = {"arch": "mamba2-370m", "config": "full",
                          "layers": 8, "batch": 1, "prompt_len": 2048,
                          "gen_tokens": 32, "mesh": (2, 2), "k8_shapes": {}}
#: Its check, set before the path's first card run: the sharded run fed
#: the unsharded greedy run's tokens, against its logits. They differ
#: where out_proj's partial products are rounded to bf16 on each point
#: before their f32 sum (the gathers move values unchanged). On the CPU
#: (`tools/tf_gap.py --arch mamba2-370m --mesh 2x2 --batch 1 --prompt-len
#: 256 --gen-tokens 6 --device cpu`, full width): max |d| 0.0156 / 0.0234
#: / 0.0342 / 0.0625 and mean 0.0017 / 0.0039 / 0.0063 / 0.0103 at 1 / 2 /
#: 4 / 8 layers, as serve-sharded-mamba2's batch-4 readings. The bounds
#: are serve-sharded-mamba2's, over five times the 8-layer reading; a
#: head's output, state or gate from the wrong point moves the logits
#: (std ~0.64) by about their scale
SHARDED_B1_SSM_MAX_ABS = SHARDED_SSM_MAX_ABS
SHARDED_B1_SSM_MEAN_ABS = SHARDED_SSM_MEAN_ABS
#: serve-sharded-seq-mla: deepseek-v2-lite-16b at its published widths (16
#: heads, r 512, dr 64; 64 experts top-6 + 2 shared) cut to 3 layers, as
#: serve-sharded-mla is (the dense first layer and 2 MoE layers), at batch
#: 4, a 2,046-token prompt and 16 tokens (cap 2,070) on a (1, 3) mesh of
#: three points of the card, fsdp off. 3 divides none of the 16 heads, r
#: and dr, so MLA splits by sequence (the reference's "seq" layout): its
#: leaves gathered over "model" in one gather, each point's 682 query rows
#: (2,046 = 3 x 682) against every row's gathered latent and rope keys (K8
#: (192, 128) prefill at (682, 2046) on 16 heads), its 690 of the 2,070
#: slots at every column, K8 decode over them with the log-sum-exp and the
#: three partials merged. The experts (64), their d_ff (1,408), the shared
#: experts and the vocabulary (102,400) stay whole over "model"
#: (`fit_spec`); the dense FFN's 10,944 splits. A model axis of 3 is the
#: smallest on which published widths reach the split (8 and 16 divide
#: the heads, r and dr); no one deploys deepseek-v2-lite on it: the path
#: runs the split at published widths on one card. `cache_spec` keeps the
#: latent whole on 3, where a point holds a third of the slots
#: (`cache_slot_ways`: its cache bytes are a third of the whole)
SERVE_SHARDED_SEQ_MLA = {"arch": "deepseek-v2-lite-16b", "config": "full",
                         "layers": 3, "batch": 4, "prompt_len": 2046,
                         "gen_tokens": 16, "mesh": (1, 3),
                         "cache_slot_ways": 3,
                         "k8_shapes": {"prefill": (682, 2046),
                                       "decode": (1, 690)}}
#: Its check, set before the path's first card run (`tools/tf_gap.py --arch
#: deepseek-v2-lite-16b --mesh 1x3 --batch 2 --prompt-len 255 --gen-tokens
#: 7 --device cpu`, K8's plain version, full width, 85 rows a point, 90 of
#: the 270 slots): replayed, max |d| 0.0391 / 0.0547 / 0.0625 and mean
#: 0.0061 / 0.0082 / 0.0094 at 1 / 2 / 3 layers, as serve-sharded-mla's
#: on (2, 2); routing on its own 1.3% / 5.2% of the choices differ at 2 /
#: 3 layers. The bounds are serve-sharded-mla's, four times the 3-layer
#: reading (a point's rows and the gathers move values unchanged; the
#: decode partials are rounded to bf16 before the merge and the dense
#: FFN's w2 sums are three); a row, slot range or merge weight on the
#: wrong point moves the logits (std ~1.3) by a share of their scale
SHARDED_SEQ_MLA_MAX_ABS = SHARDED_MLA_MAX_ABS
SHARDED_SEQ_MLA_MEAN_ABS = SHARDED_MLA_MEAN_ABS
#: phases 11d-11m in order: path -> (spec, its check's (max, mean) bounds
#: and, for a MoE, the most of its own routing's choices that may differ)
SERVE_SHARDED_PATHS = {
    "serve-sharded": (SERVE_SHARDED, (SHARDED_MAX_ABS, SHARDED_MEAN_ABS,
                                      SHARDED_ROUTE_SHARE)),
    "serve-sharded-mla": (SERVE_SHARDED_MLA, (SHARDED_MLA_MAX_ABS,
                                              SHARDED_MLA_MEAN_ABS,
                                              SHARDED_MLA_ROUTE_SHARE)),
    "serve-sharded-llava": (SERVE_SHARDED_LLAVA, (SHARDED_VLM_MAX_ABS,
                                                  SHARDED_VLM_MEAN_ABS,
                                                  None)),
    "serve-sharded-mamba2": (SERVE_SHARDED_MAMBA, (SHARDED_SSM_MAX_ABS,
                                                   SHARDED_SSM_MEAN_ABS,
                                                   None)),
    "serve-sharded-whisper": (SERVE_SHARDED_WHISPER, (
        SHARDED_ENCDEC_MAX_ABS, SHARDED_ENCDEC_MEAN_ABS, None)),
    "serve-sharded-cp": (SERVE_SHARDED_CP, (SHARDED_CP_MAX_ABS,
                                            SHARDED_CP_MEAN_ABS, None)),
    "serve-sharded-b1": (SERVE_SHARDED_B1, (SHARDED_B1_MAX_ABS,
                                            SHARDED_B1_MEAN_ABS, None)),
    "serve-sharded-b1-mla": (SERVE_SHARDED_B1_MLA, (
        SHARDED_B1_MLA_MAX_ABS, SHARDED_B1_MLA_MEAN_ABS,
        SHARDED_MLA_ROUTE_SHARE)),
    "serve-sharded-b1-mamba2": (SERVE_SHARDED_B1_MAMBA, (
        SHARDED_B1_SSM_MAX_ABS, SHARDED_B1_SSM_MEAN_ABS, None)),
    "serve-sharded-seq-mla": (SERVE_SHARDED_SEQ_MLA, (
        SHARDED_SEQ_MLA_MAX_ABS, SHARDED_SEQ_MLA_MEAN_ABS,
        SHARDED_MLA_ROUTE_SHARE)),
}
#: phase 7's decode cases also timed with K8's log-sum-exp, as their
#: path runs them (`lse_ms`, `lse_device_ms`)
LSE_TIMED = ("deepseek-v2-lite seq point decode",)
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
#: K8 decode's log-sum-exp against `flash_plain`'s: both are f32 (the
#: kernel sums a split's exp(s - m) in another order and merges the
#: splits), about 1e-6 apart at these magnitudes (10-20); a key left out
#: or counted twice moves the lse by log(1 + exp(s - lse)), which for a
#: typical key of a 2048-slot cache is about 5e-4 and grows with the key's
#: weight
LSE_TOL = 1e-4
FLASH = ("flash_prefill", "flash_decode")
#: query rows of a batch-1 point's 32,744-row prefill that phase 7 holds
#: K8 to `flash_plain` on (the last: they see the most keys)
PLAIN_ROWS = 256
#: train path: qwen1.5-4b at its published config, random weights from
#: seed 0, batch 4 x 2048 tokens in 2 microbatches, remat, AdamW on a
#: cosine schedule (peak 3e-4, 2 warm-up steps), 8 steps on one batch
TRAIN = {"arch": "qwen1.5-4b", "batch": 4, "seq": 2048, "steps": 8,
         "microbatches": 2}
#: The train path's gates, set before its first run. The loss of random
#: init is about ln(151,936) = 11.9; AdamW moves every weight by about the
#: learning rate a step, coherently on a batch it sees again, so 8 steps
#: must take at least half a nat off the repeated batch's loss.
TRAIN_LOSS_DROP = 0.5
#: The bf16 step against the f32 step of the same weights and batch.
#: Both are the port's own step (`build_train_step`, `Model.loss`), so
#: this gate checks precision only: a fault of the algorithm is the same
#: on both sides, and only the CPU tests against the reference's
#: `jax.value_and_grad` (tests/test_torch_train_ref.py) check that. The
#: sound readings were 0.0001 nats and 0.03% of the norm on an NVIDIA
#: H100 80GB HBM3 at 700 W; the limits sit a few times above them.
#: Two controls run beside the gate and are reported (`controls`): the
#: gradient of one microbatch dropped, which the gate must reject, and
#: microbatch gradients accumulated in bf16.
TRAIN_ORACLE_LOSS_ABS = 0.002
TRAIN_ORACLE_GNORM_REL = 0.01
#: train-ft path: the same width with one layer (about 8.8 GB a
#: checkpoint: bf16 params and f32 moments), batch 2 x 2048, 4 steps,
#: preempted at step 2
TRAIN_FT = {"layers": 1, "batch": 2, "steps": 4, "preempt": 2}
#: train-sharded path: qwen1.5-4b at its published widths (d_model 2560,
#: 20/20 heads of 128, d_ff 6912, vocabulary 151,936) with its depth cut
#: to 8 of its 40 layers (0.63 B parameters in the layers and 0.78 B in
#: the two vocabulary tables: 1.41 B), sharded over a (2, 2) ("data",
#: "model") mesh of four points of the card with FSDP on; the train
#: path's TrainConfig and batch (4 x 2048 in 2 microbatches, remat),
#: AdamW on a cosine schedule (peak 3e-4, 2 warm-up steps), 3 bf16 steps
#: on one repeated batch
TRAIN_SHARDED = {"arch": "qwen1.5-4b", "layers": 8, "mesh": (2, 2),
                 "fsdp": True, "batch": 4, "seq": 2048, "microbatches": 2,
                 "steps": 3}
#: The f32 gate of train-sharded: on the same f32 weights and batch, one
#: AdamW step sharded against the same step unsharded (clipping active:
#: the gradient norm is above 1). Set before the path's first card run
#: from CPU readings of `sharded_train_gate` at a narrow width (qwen's
#: block at d_model 256, 4/4 heads of 64, d_ff 704, vocabulary 4096, 2
#: layers, batch 4 x 256, the same mesh, microbatches and schedule):
#: the losses and gradient norms equal to f32's print, the parameters
#: after the step 3.5e-7 relative L2 apart (their updates 1.2e-4). The
#: limits sit far above those (cuBLAS sums in other orders than the CPU,
#: and AdamW's first step, about lr * sign(g), steps an entry whose
#: gradient is at f32 noise otherwise) and far below a fault: the
#: control, the step's gradient taken from data shard 0's rows only (a
#: data-parallel sum left out), read 0.44 relative in the norm and
#: 2.9e-3 in the parameters (0.98 in their updates) on the CPU.
SHARDED_TRAIN_LOSS_ABS = 1e-4
SHARDED_TRAIN_GNORM_REL = 1e-4
SHARDED_TRAIN_PARAM_REL = 1e-4
#: Two more readings of the same step, as AdamW's first step (about lr *
#: sign(g)) hides a fault in one leaf's data-parallel sum from the
#: parameters and dilutes it in the norm: the worst leaf's gradient (each
#: point's slice against the unsharded gradient's, relative L2 a leaf)
#: and the updates' relative L2. Set before the path's first card run
#: from CPU readings of `sharded_train_gate` at the narrow width above
#: (in brackets: d_model 1024, 4/4 heads of 256, d_ff 2816, the rest as
#: above): worst leaf 1.3e-6 (1.7e-6), updates 1.2e-4 (8.0e-5); the control
#: 1.09 (1.02) and 0.98 (1.00). A fault scales some leaf's gradient by
#: 0.5 to 2, a relative L2 of 0.3 or more.
SHARDED_TRAIN_GRAD_REL = 1e-3
SHARDED_TRAIN_UPDATE_REL = 1e-2
#: path `launch-reports`: qwen1.5-4b at the serve path's shape, on a
#: one-device mesh
LAUNCH_REPORTS = {"arch": "qwen1.5-4b", "batch": 4, "prompt_len": 2048,
                  "cap": 2088}
#: path `launch-reports`: the dry run's cells whose collective fields it
#: prints at full width on both production meshes (the sequence split on
#: a model axis of 8; MLA and the expert-parallel MoE)
LAUNCH_REPORT_CELLS = (("qwen1.5-4b", "decode_32k"),
                       ("deepseek-v2-lite-16b", "decode_32k"))
#: bounds of a real prefill's FlopCounterMode count ("auto" attention:
#: K8 is opaque to the counter) over `analytic.prefill_cost(...).flops`,
#: fixed on the CPU before the first card run. A trace of the same call
#: on the meta device counts 58,978,381,332,480 FLOPs against the
#: model's 68,158,824,120,320: 0.8653. The model counts 2 N D with N
#: the embedding table and the LM head too (a lookup and, in a prefill,
#: the head over the last token only) and causal attention at half its
#: scores; the port's dense "auto" attention multiplies every (query,
#: cache slot) pair of the 2088-slot ring. The bounds keep 5% either side
#: of 0.8653: a count outside them is a different computation, not
#: rounding
FLOP_RATIO_BOUNDS = (0.82, 0.91)
#: the kernel table's rows of K8 at MLA's head sizes and at (64, 64)
#: (launched as FLASH)
FLASH_MLA = ("flash_prefill_mla", "flash_decode_mla")
FLASH_D64 = ("flash_prefill_d64", "flash_decode_d64")


def launched(row: str) -> str:
    """The launch counter a kernel-table row reads: an MLA or (64, 64) row
    counts its variant's launches (on its own path)."""
    return row.removesuffix("_mla").removesuffix("_d64")


def k8_row(variant: str, d: int, dv: int) -> str:
    """The kernel-table row of a K8 call at head sizes (d, dv)."""
    return variant + ("_mla" if dv != d else "_d64" if d == 64 else "")
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


#: the script's start on the host clock (`emit` stamps each phase line)
START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line gains `elapsed_s`, the seconds since
    the script started, so the phases' share of the time limit shows."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - START, 1)}
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


#: the distributed runtime's paths: (kernels that must launch, kernels
#: that must not). Its exchange moves blocks with `.to(device)` copies
#: and its local joins take the torch segment join, so `dist-exchange`
#: launches no hand kernel
DIST_PATHS = {
    "dist-api": (("bloom_build", "probe"),
                 ("multi_probe", "joinmap_build", "joinmap_lookup",
                  *API_ONLY, *FLASH)),
    "dist-exchange": ((), ("multi_probe", "bloom_build", "probe",
                           "joinmap_build", "joinmap_lookup", *API_ONLY,
                           *FLASH)),
    "dist-tpch": (("multi_probe", "bloom_build"), SERVE_NEVER),
    "dist-pod": (("bloom_build", "probe"),
                 ("multi_probe", "joinmap_build", "joinmap_lookup",
                  *API_ONLY, *FLASH)),
}
#: the distributed phases' shard count: four shards of one card
DIST_SHARDS = 4


def dist_api_phase(torch, np, kb, sj, fa, bloom, dev, api) -> dict:
    """Path `dist-api`: `BloomEngine.make_distributed_transfer` on a
    4-shard mesh of one card at Q5's first edge, σ(orders, 1994)'s
    o_orderkey into lineitem's l_orderkey (bucketed by `shard_keys`),
    with the gather OR and the recursive-doubling OR; then
    `distributed_semi_join` over the same shards. Each transfer call must
    launch K2 and K3 once a shard. Checked after the window: every
    shard's all-reduced words == `build_ref` over all the build keys,
    the mask == `probe_ref` of the whole column, K2 on each shard (its
    padding mask as `valid`) == `build_ref` on that shard, the semi-join
    == `torch.isin` and a subset of the Bloom mask."""
    from repro_torch.core import distributed
    from repro_torch.core.engine_bloom import get_engine
    from repro_torch.launch.mesh import make_data_mesh

    p = DIST_SHARDS
    mesh = make_data_mesh(p, devices=[dev] * p)
    eng = get_engine("cuda")
    bkeys = api["o_orderkey"][api["q5"]]
    pkeys = api["l_orderkey"]
    n = len(pkeys)
    nblocks = bloom.blocks_for(len(bkeys))
    b = eng.shard_keys(bkeys, mesh)
    pr = eng.shard_keys(pkeys, mesh)

    def key_shards(keys, per):
        padded = np.zeros(p * per, np.int64)
        padded[:len(keys)] = keys
        return [torch.from_numpy(padded[s * per:(s + 1) * per]).to(dev)
                for s in range(p)]
    bk64 = key_shards(bkeys, len(b[0][0]))
    pk64 = key_shards(pkeys, len(pr[0][0]))
    semi = distributed.distributed_semi_join(mesh)

    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    calls = 0
    masks, ms = {}, {}
    for tree in (False, True):
        fn = eng.make_distributed_transfer(mesh, live_keys=len(bkeys),
                                           tree_or=tree)

        def run(fn=fn):
            nonlocal calls
            calls += 1
            return fn(*b, *pr)
        masks[tree] = run()
        ms[tree] = cuda_ms(torch, run, reps=5, warm=1)
    semi_mask = semi(bk64, b[2], pk64, pr[2])
    semi_ms = cuda_ms(torch, lambda: semi(bk64, b[2], pk64, pr[2]), reps=3,
                      warm=1)
    torch.cuda.synchronize()
    counts = read()                   # just after the path
    # the same calls' device time under torch.profiler (the CUDA-event ms
    # above are host-bound: per-shard Python calls between the launches)
    dev_ms = {}
    for tree in (False, True):
        fn = eng.make_distributed_transfer(mesh, live_keys=len(bkeys),
                                           tree_or=tree)
        dev_ms[tree] = device_ms(torch, lambda fn=fn: fn(*b, *pr))

    # the oracles, outside the window: the plain versions over the whole
    # column, and K2 against its plain version on each shard at the
    # path's shape (its padding mask as `valid`)
    blo, bhi = bloom.keys_to_device(bkeys, dev)
    plo, phi = bloom.keys_to_device(pkeys, dev)
    whole = kb.build_ref(blo, bhi, nblocks)
    hit = kb.probe_ref(whole, plo, phi)
    isin = torch.isin(torch.from_numpy(pkeys).to(dev),
                      torch.from_numpy(bkeys).to(dev))
    for s in range(p):
        got = kb.build(b[0][s], b[1][s], nblocks, valid=b[2][s])
        check(torch.equal(got, kb.build_ref(b[0][s], b[1][s], nblocks,
                                            valid=b[2][s])),
              f"dist-api: K2 on shard {s} != build_ref on the same shard")
    for tree in (False, True):
        words = distributed.distributed_bloom_build(*b, nblocks, mesh,
                                                    tree_or=tree)
        check(all(torch.equal(w, whole) for w in words),
              f"dist-api (tree_or={tree}): all-reduced words != build_ref "
              "over all the build keys")
        got = torch.cat(masks[tree])
        check(torch.equal(got[:n], hit) and not bool(got[n:].any()),
              f"dist-api (tree_or={tree}): mask != probe_ref of the "
              "whole column")
    semi_all = torch.cat(semi_mask)
    check(torch.equal(semi_all[:n], isin) and not bool(semi_all[n:].any()),
          "dist-api: distributed_semi_join != torch.isin")
    check(not bool((isin & ~hit).any()),
          "dist-api: the semi-join is not a subset of the Bloom mask")
    emit({"phase": "dist", "path": "dist-api", "shards": p,
          "build_keys": len(bkeys), "probe_rows": n,
          "rows_a_shard": int(pr[0][0].shape[0]), "nblocks": nblocks,
          "ms": {"gather_or": ms[False], "tree_or": ms[True],
                 "semi_join": semi_ms},
          "device_ms": {"gather_or": dev_ms[False], "tree_or": dev_ms[True]},
          "survivors": int(hit.sum()), "exact": int(isin.sum()),
          "false_positives": int((hit & ~isin).sum()),
          "filter_wire_bytes": (p - 1) * nblocks * bloom.LANES * 4,
          "key_wire_bytes": (p - 1) * len(bkeys) * 8,
          "calls": calls, "launches": {k: counts[k] for k in (
              "bloom_build", "probe")},
          "equal": ["build_ref (all keys)", "probe_ref (whole column)",
                    "build_ref (each shard, valid=padding mask)",
                    "torch.isin"]})
    check(counts["bloom_build"] == counts["probe"] == p * calls,
          f"dist-api: {counts['bloom_build']} K2 and {counts['probe']} K3 "
          f"launches in {calls} calls of {p} shards")
    check_path(counts, "dist-api", *DIST_PATHS["dist-api"])
    return counts


#: the multi-pod path's mesh: 2 pods of 4 data shards, all of one card
DIST_POD = (2, 4)


def dist_pod_phase(torch, np, kb, sj, fa, bloom, dev, api, smi: str
                   ) -> dict:
    """Path `dist-pod`: `BloomEngine.make_distributed_transfer` on a
    (2, 4) ("pod", "data") mesh of eight shards of one card at dist-api's
    edge (σ(orders, 1994)'s o_orderkey into lineitem's l_orderkey, SF 1,
    bucketed by `shard_keys` into 8 shards, pod-major), with the gather
    OR and the recursive-doubling OR, each over "pod" and then "data".
    Each call must launch K2 and K3 once a shard (8 each). Checked after
    the window: every shard's all-reduced words (`distributed_bloom_build`
    on the pod mesh) == `build_ref` over all the build keys == the words
    of the 1-D mesh over the same 8 shards, and the mask == `probe_ref`
    of the whole column, bit for bit."""
    from repro_torch.core import distributed
    from repro_torch.core.engine_bloom import get_engine
    from repro_torch.launch.mesh import make_data_mesh, make_test_mesh

    p = DIST_POD[0] * DIST_POD[1]
    mesh = make_test_mesh(DIST_POD, ("pod", "data"), devices=[dev] * p)
    flat = make_data_mesh(p, devices=[dev] * p)
    eng = get_engine("cuda")
    bkeys = api["o_orderkey"][api["q5"]]
    pkeys = api["l_orderkey"]
    n = len(pkeys)
    nblocks = bloom.blocks_for(len(bkeys))
    b = eng.shard_keys(bkeys, mesh)
    pr = eng.shard_keys(pkeys, mesh)

    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    calls = 0
    masks, ms = {}, {}
    for tree in (False, True):
        fn = eng.make_distributed_transfer(mesh, live_keys=len(bkeys),
                                           tree_or=tree)

        def run(fn=fn):
            nonlocal calls
            calls += 1
            return fn(*b, *pr)
        masks[tree] = run()
        ms[tree] = cuda_ms(torch, run, reps=5, warm=1)
    torch.cuda.synchronize()
    counts = read()                   # just after the path
    dev_ms = {}
    for tree in (False, True):
        fn = eng.make_distributed_transfer(mesh, live_keys=len(bkeys),
                                           tree_or=tree)
        dev_ms[tree] = device_ms(torch, lambda fn=fn: fn(*b, *pr))

    # the oracles, outside the window
    blo, bhi = bloom.keys_to_device(bkeys, dev)
    plo, phi = bloom.keys_to_device(pkeys, dev)
    whole = kb.build_ref(blo, bhi, nblocks)
    hit = kb.probe_ref(whole, plo, phi)
    for tree in (False, True):
        words = distributed.distributed_bloom_build(*b, nblocks, mesh,
                                                    tree_or=tree)
        one_d = distributed.distributed_bloom_build(*b, nblocks, flat,
                                                    tree_or=tree)
        check(all(torch.equal(w, whole) for w in words),
              f"dist-pod (tree_or={tree}): all-reduced words != build_ref "
              "over all the build keys")
        check(all(torch.equal(w, v) for w, v in zip(words, one_d)),
              f"dist-pod (tree_or={tree}): words != the 1-D mesh's")
        got = torch.cat(masks[tree])
        check(torch.equal(got[:n], hit) and not bool(got[n:].any()),
              f"dist-pod (tree_or={tree}): mask != probe_ref of the "
              "whole column")
    emit({"phase": "dist", "path": "dist-pod", "mesh": dict(mesh.shape),
          "shards": p, "card": smi, "build_keys": len(bkeys),
          "probe_rows": n, "rows_a_shard": int(pr[0][0].shape[0]),
          "nblocks": nblocks,
          "ms": {"gather_or": ms[False], "tree_or": ms[True]},
          "device_ms": {"gather_or": dev_ms[False], "tree_or": dev_ms[True]},
          "survivors": int(hit.sum()),
          "filter_wire_bytes": {
              "gather_or": (DIST_POD[0] - 1 + DIST_POD[1] - 1) * nblocks
              * bloom.LANES * 4,
              "tree_or": (int(math.log2(DIST_POD[0]))
                          + int(math.log2(DIST_POD[1]))) * nblocks
              * bloom.LANES * 4},
          "calls": calls, "launches": {k: counts[k] for k in (
              "bloom_build", "probe")},
          "equal": ["build_ref (all keys)", "1-D mesh words (8 shards)",
                    "probe_ref (whole column)"]})
    check(counts["bloom_build"] == counts["probe"] == p * calls,
          f"dist-pod: {counts['bloom_build']} K2 and {counts['probe']} K3 "
          f"launches in {calls} calls of {p} shards")
    check_path(counts, "dist-pod", *DIST_PATHS["dist-pod"])
    return counts


def dist_exchange_phase(torch, np, kb, sj, fa, dev, api) -> dict:
    """Path `dist-exchange`: a `DistributedJoinEngine` over a 4-shard
    `MeshExchange` of one card, its local engine the cuda backend (plane
    on: device index vectors), joins lineitem's 6,001,215 l_orderkey
    against orders' 1,500,000 o_orderkey; `broadcast_join_indices` and
    `shuffle_join_indices`, each called directly, must equal
    `sorted_join_indices` for inner, left, semi and anti."""
    from repro_torch.core import device_plane
    from repro_torch.core.engine_join import sorted_join_indices
    from repro_torch.core.engine_join_dist import (
        DistributedJoinEngine, broadcast_join_indices, shuffle_join_indices,
    )
    from repro_torch.launch.mesh import make_data_mesh

    eng = DistributedJoinEngine(
        nshards=DIST_SHARDS, local_backend="cuda",
        mesh=make_data_mesh(DIST_SHARDS, devices=[dev] * DIST_SHARDS))
    check(eng.exchange.device_backed and eng.local.device_resident,
          "dist-exchange: not a device-backed exchange over plane-on joins")
    bk, pk = api["o_orderkey"], api["l_orderkey"]
    strategies = {
        "broadcast": lambda how: broadcast_join_indices(
            bk, pk, how, eng.exchange, eng.local),
        "shuffle": lambda how: shuffle_join_indices(bk, pk, how,
                                                    eng.exchange)}
    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    for how in ("inner", "left", "semi", "anti"):
        rec = {"phase": "dist", "path": "dist-exchange", "how": how,
               "build_rows": len(bk), "probe_rows": len(pk)}
        want = sorted_join_indices(bk, pk, how)
        for name, fn in strategies.items():
            st = device_plane.DeviceStats()
            t = time.perf_counter()
            with device_plane.track(st):
                bidx, pidx, wire = fn(how)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            check(np.array_equal(bidx, want[0])
                  and np.array_equal(pidx, want[1]),
                  f"dist-exchange {name} {how} != sorted_join_indices")
            rec[name] = {"seconds": sec, "wire_bytes": wire,
                         "rows_out": len(pidx), "device": st.report()}
        emit({**rec, "equal": "sorted_join_indices"})
    counts = read()                   # just after the path
    check_path(counts, "dist-exchange", *DIST_PATHS["dist-exchange"])
    return counts


def dist_tpch_phase(torch, kb, sj, fa, cat, sf: float, oracle: dict
                    ) -> dict:
    """Path `dist-tpch`: the 20 join queries, cold, through
    `Executor(engine="distributed", dist_shards=4)` with the cuda
    backends; the exchange is simulated unless four cards are visible
    (so on one card). Every result must
    have phase 5's eager-oracle md5; K1 and K2 must launch. Then Q5 once
    more under an `exchange.send` fault at one call index (seeded), which
    the engine must retry in place, md5-equal."""
    import random

    from repro_torch.core import faultinject
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import QUERIES, build_query

    def cfg():
        return ExecConfig(strategy=make_strategy("pred-trans",
                                                 backend="cuda"),
                          join_backend="cuda", engine="distributed",
                          dist_shards=DIST_SHARDS)

    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    total = {"seconds": 0.0, "shuffle_bytes": 0, "broadcast_bytes": 0,
             "round_trips": 0, "strategies": collections.Counter()}
    q5 = None
    for qn in sorted(QUERIES):
        before = read()
        t = time.perf_counter()
        res, st = Executor(cat, cfg()).execute(build_query(qn, sf=sf))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        after = read()
        check(table_digest(res) == oracle[qn],
              f"dist-tpch Q{qn} differs from the eager oracle")
        rep = st.report()
        d = rep["dist"]
        # the auto rule: a mesh exchange only when the shards fit the cards
        meshed = torch.cuda.device_count() >= DIST_SHARDS
        check(d["nshards"] == DIST_SHARDS and d["device_backed"] == meshed,
              f"dist-tpch Q{qn}: not {DIST_SHARDS} shards with "
              f"device_backed={meshed} ({d})")
        total["seconds"] += sec
        total["shuffle_bytes"] += d["shuffle_bytes"]
        total["broadcast_bytes"] += d["broadcast_bytes"]
        total["round_trips"] += rep["device"]["round_trips"]
        total["strategies"].update(d["strategies"])
        if qn == 5:
            q5 = d["strategies"]
        emit({"phase": "dist", "path": "dist-tpch", "query": qn,
              "seconds": sec, "phase_seconds": rep["phase_seconds"],
              "rows": len(res), "dist": d, "device": rep["device"],
              "launches": {k: after[k] - before[k]
                           for k in ("multi_probe", "bloom_build")},
              "md5_equal": True})
    # an exchange.send fault at one of Q5's collectives: a broadcast
    # gathers once, a shuffle exchanges each side once
    sends = q5.get("broadcast", 0) + 2 * q5.get("shuffle", 0)
    check(sends > 0, f"dist-tpch Q5 made no collective ({q5})")
    at = random.Random(24).randrange(sends)
    t = time.perf_counter()
    with faultinject.inject(faultinject.FaultSchedule(
            {"exchange.send": at})) as sched:
        res, st = Executor(cat, cfg()).execute(build_query(5, sf=sf))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    counts = read()                   # just after the path
    rec = st.report()["recoveries"]
    check(sched.total_fired() == 1 and rec["retries"] >= 1
          and not st.degraded,
          f"dist-tpch Q5: the exchange.send fault was not retried ({rec})")
    check(table_digest(res) == oracle[5],
          "dist-tpch Q5 under the fault differs from the eager oracle")
    emit({"phase": "dist", "path": "dist-tpch", "queries": len(QUERIES),
          **{k: v for k, v in total.items() if k != "strategies"},
          "strategies": dict(total["strategies"]),
          "launches": {k: counts[k] for k in ("multi_probe",
                                              "bloom_build")},
          "fault": {"query": 5, "exchange.send_call": at, "of": sends,
                    "seconds": sec, "retries": rec["retries"],
                    "replays": rec["replays"], "md5_equal": True}})
    check_path(counts, "dist-tpch", *DIST_PATHS["dist-tpch"])
    return counts


def torch_tpch_phase(torch, np, kb, sj, fa, dev, cat, sf: float,
                     oracle: dict, cuda_runs: dict, api) -> dict:
    """Path `torch-tpch`: the 20 join queries through `Executor` with the
    plain-torch `torch` backends (no hand kernel), the device-resident
    plane on and off, each query cold then warm. Every result must have
    phase 5's eager-oracle md5, and no hand kernel may launch in the
    path's window. Each line sets the warm seconds and round trips beside
    phase 5's cuda-backend run of the same query and plane; each plane's
    sums add the plain map's syncs (`MAP_SYNCS`), which the round trips
    leave out. Then, outside
    the window, the largest plane-off map build the path made (the
    orders keys at SF 1) timed alone: the plain-torch build
    (`joinmap_build_torch`) and K4 (`joinmap_build`) on the same keys.
    Returns the path's launch counts."""
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.relational.table import table_digest
    from repro_torch.tpch import QUERIES, build_query

    def cfg(plane: bool):
        return ExecConfig(strategy=make_strategy(
            "pred-trans", backend="torch", device_resident=plane),
            join_backend="torch", device="on" if plane else "off")

    sizes = []                        # padded keys of each map build
    build_rows_torch = sj.build_rows_torch

    def sized(lo, hi, mask, cap):
        sizes.append(int(lo.shape[0]))
        return build_rows_torch(lo, hi, mask, cap)

    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    sums = {}
    sj.build_rows_torch = sized
    try:
        for plane, cuda_path in ((True, "pred-trans"),
                                 (False, "pred-trans-plane-off")):
            tot = {"seconds": 0.0, "round_trips": 0, "cuda_seconds": 0.0,
                   "cuda_round_trips": 0}
            sj.MAP_SYNCS.reset()
            for qn in sorted(QUERIES):
                secs = []
                for _ in range(2):    # cold, then warm
                    t = time.perf_counter()
                    res, st = Executor(cat, cfg(plane)).execute(
                        build_query(qn, sf=sf))
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t)
                check(table_digest(res) == oracle[qn],
                      f"torch-tpch Q{qn} plane "
                      f"{'on' if plane else 'off'} differs from the oracle")
                drep = st.report()["device"]
                cuda = cuda_runs[(cuda_path, qn)]
                tot["seconds"] += secs[1]
                tot["round_trips"] += drep["round_trips"]
                tot["cuda_seconds"] += cuda["seconds"]
                tot["cuda_round_trips"] += cuda["device"]["round_trips"]
                emit({"phase": "torch-tpch", "query": qn,
                      "plane": "on" if plane else "off",
                      "seconds": secs[1], "cold_seconds": secs[0],
                      "rows": len(res), "device": drep,
                      "cuda_seconds": cuda["seconds"],
                      "cuda_round_trips": cuda["device"]["round_trips"],
                      "md5_equal": True})
            # the plain map's own syncs, which DeviceStats leaves out
            tot["map_syncs"] = dict(sj.MAP_SYNCS)
            sums["on" if plane else "off"] = tot
    finally:
        sj.build_rows_torch = build_rows_torch
    counts = read()                   # just after the path
    check_path(counts, "torch-tpch", (), tuple(counts))
    check(len(sizes) > 0, "torch-tpch plane off built no hash map")

    # the largest plane-off build alone, outside the window: the orders
    # keys (1,500,000 at SF 1) through the plain build and through K4
    keys = api["o_orderkey"]

    def build_with(fn):
        def run():
            fn(keys, dev)
            torch.cuda.synchronize()
        run()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            run()
            times.append(time.perf_counter() - t)
        return statistics.median(times)
    emit({"phase": "torch-tpch", "queries": len(QUERIES), "sums": sums,
          "map_builds": len(sizes), "largest_build_padded_keys": max(sizes),
          "largest_build": {"keys": len(keys),
                            "torch_seconds": build_with(
                                sj.joinmap_build_torch),
                            "k4_seconds": build_with(sj.joinmap_build)},
          "launches": counts})
    return counts


class GradNorm:
    """An optimizer that leaves the parameters as they are, reports the
    global norm of the gradient the train step hands it and keeps that
    gradient's leaves (`grads`): the train phase's f32 oracle and its
    controls, with no moments to hold."""

    grads = None

    def init(self, params):
        return None

    def update(self, grads, state, params):
        from repro_torch.train.optim import global_norm
        from repro_torch.train.tree import leaves
        self.grads = leaves(grads)
        return params, state, {"grad_norm": global_norm(grads)}


def grad_rel_err(torch, got, want) -> float:
    """||got - want|| / ||want|| over every leaf, in f32."""
    num = den = 0.0
    for g, w in zip(got, want):
        num += float((g.float() - w).pow(2).sum())
        den += float(w.pow(2).sum())
    return math.sqrt(num / den)


def train_oracle_phase(torch, model, params, batch, tc) -> dict:
    """The train gate's oracle and its controls, on the same weights and
    batch: the f32 step (the weights cast to f32), the sound bf16 step,
    the bf16 step with `accum_dtype=bf16` (control), and the gradient the
    step would hand the optimizer had it dropped the second microbatch
    (control: the first microbatch's gradient over the microbatch count;
    the loss is the sound step's, as only a gradient was dropped). Each
    reading: loss, gradient norm, and the gradient's
    relative L2 distance from the f32 one. Returns
    {"oracle_f32": ..., "bf16": ..., "controls": {...}}."""
    import dataclasses

    from repro_torch.models.model import Batch
    from repro_torch.train.step import build_train_step
    from repro_torch.train.tree import tree_map

    def step(ps, cfg, b=batch):
        opt = GradNorm()
        t = time.perf_counter()
        _, _, m = build_train_step(model, opt, cfg)(ps, None, b)
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "seconds": time.perf_counter() - t}, opt.grads

    p32 = tree_map(lambda t: t.float(), params)
    oracle, g32 = step(p32, tc)
    del p32
    torch.cuda.empty_cache()
    out = {"oracle_f32": oracle, "controls": {}}
    out["bf16"], g = step(params, tc)
    out["bf16"]["grad_rel_err"] = grad_rel_err(torch, g, g32)
    del g
    rec, g = step(params, dataclasses.replace(tc,
                                              accum_dtype=torch.bfloat16))
    rec["grad_rel_err"] = grad_rel_err(torch, g, g32)
    out["controls"]["accum_bf16"] = rec
    del g
    m = tc.microbatches
    first = Batch(batch.tokens[: batch.tokens.shape[0] // m],
                  batch.targets[: batch.targets.shape[0] // m])
    rec, g = step(params, dataclasses.replace(tc, microbatches=1), first)
    for x in g:
        x.div_(m)
    out["controls"]["dropped_microbatch"] = {
        "loss": out["bf16"]["loss"], "grad_norm": rec["grad_norm"] / m,
        "grad_rel_err": grad_rel_err(torch, g, g32),
        "seconds": rec["seconds"]}
    del g, g32
    torch.cuda.empty_cache()
    for rec in (out["bf16"], *out["controls"].values()):
        rec["passes_gate"] = oracle_gate(rec, oracle)
    return out


def oracle_gate(rec: dict, oracle: dict) -> bool:
    """A bf16 step's loss and gradient norm within TRAIN_ORACLE_LOSS_ABS
    and TRAIN_ORACLE_GNORM_REL of the f32 step's."""
    return (abs(rec["loss"] - oracle["loss"]) <= TRAIN_ORACLE_LOSS_ABS
            and abs(rec["grad_norm"] - oracle["grad_norm"])
            <= TRAIN_ORACLE_GNORM_REL * oracle["grad_norm"])


def train_batch(torch, np, vocab: int, batch: int, seq: int, seed: int):
    """Random tokens from numpy, the targets the tokens shifted by one
    (`launch/train.py`'s batches), on the card."""
    from repro_torch.models.model import Batch
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.integers(0, vocab, (batch, seq))).cuda()
    return Batch(t, torch.roll(t, -1, 1))


def train_phase(torch, np, kb, sj, fa) -> dict:
    """Path `train`: qwen1.5-4b at its full config through
    `build_train_step` (AdamW, `TrainConfig(microbatches=2, remat=True)`),
    TRAIN["steps"] steps on one repeated batch. First, on the same batch
    and weights, the oracle and its controls (`train_oracle_phase`).
    Gates: every loss finite, the last loss TRAIN_LOSS_DROP nats under
    the first, the first bf16 step within TRAIN_ORACLE_LOSS_ABS of the
    oracle's loss and TRAIN_ORACLE_GNORM_REL of its gradient norm, the
    dropped-microbatch control outside them; no hand kernel launches.
    Returns the path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train import optim as O
    from repro_torch.train.step import TrainConfig, build_train_step
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN["arch"])
    n = cfg.param_count()
    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    # bf16 params and gradients, f32 accumulation buffers, f32 m and v
    reckoned = n * (2 + 2 + 4 + 8)
    emit({"phase": "train", "step": "reckoning", "arch": TRAIN["arch"],
          "params": n, "bytes_before_activations": reckoned,
          "card_bytes": torch.cuda.get_device_properties(0).total_memory})
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = train_batch(torch, np, cfg.vocab_size, b, s, 0)
    tc = TrainConfig(microbatches=TRAIN["microbatches"], remat=True)

    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    checks = train_oracle_phase(torch, model, params, batch, tc)
    oracle = checks["oracle_f32"]
    emit({"phase": "train", "check": "f32 oracle and controls",
          "tol_loss_abs": TRAIN_ORACLE_LOSS_ABS,
          "tol_grad_norm_rel": TRAIN_ORACLE_GNORM_REL, **checks})
    torch.cuda.reset_peak_memory_stats()

    opt = O.AdamW(lr=O.cosine_schedule(3e-4, 2, steps))
    step = build_train_step(model, opt, tc)
    state = opt.init(params)
    losses, norms, secs = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t)
        norms.append(float(m["grad_norm"]))
        emit({"phase": "train", "step": i + 1, "loss": losses[-1],
              "grad_norm": norms[-1], "lr": float(m["lr"]),
              "seconds": secs[-1]})
    counts = read()                   # just after the path
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.mean(secs[2:])
    tokens = b * s
    prof = device_profile(torch, lambda: step(params, state, batch))
    rec = {"phase": "train", "path": "train", "arch": TRAIN["arch"],
           "config": cfg.name, "params": n, "batch": b, "seq": s,
           "microbatches": tc.microbatches, "remat": tc.remat,
           "steps": steps, "losses": losses, "grad_norms": norms,
           "oracle_f32": oracle, "step_seconds": step_s,
           "step_seconds_all": secs, "tokens_per_second": tokens / step_s,
           "model_flop_share": 6 * n * tokens / step_s / BF16_FLOPS,
           "peak_memory_bytes": peak, "bytes_reckoned": reckoned,
           "profile_one_step": prof, "launches": counts}
    emit(rec)
    check(all(math.isfinite(x) for x in losses + norms),
          f"train: a loss or gradient norm is not finite ({losses})")
    check(losses[-1] <= losses[0] - TRAIN_LOSS_DROP,
          f"train: the loss fell from {losses[0]} to {losses[-1]}, less "
          f"than {TRAIN_LOSS_DROP}")
    check(oracle_gate({"loss": losses[0], "grad_norm": norms[0]}, oracle),
          f"train: first bf16 step (loss {losses[0]}, grad norm "
          f"{norms[0]}) vs f32 {oracle}")
    check(not checks["controls"]["dropped_microbatch"]["passes_gate"],
          f"train: the oracle gate passes a dropped microbatch "
          f"({checks['controls']['dropped_microbatch']})")
    check_path(counts, "train", (), tuple(counts))
    del params, state, step, model
    torch.cuda.empty_cache()
    return counts


def train_ft_phase(torch, np, kb, sj, fa) -> dict:
    """Path `train-ft`: `FaultTolerantTrainer` with a `CheckpointManager`
    (keep=1, under a temporary directory removed at the end), qwen1.5-4b
    at full width with its depth cut to TRAIN_FT["layers"]. A run of
    TRAIN_FT["steps"] steps straight, then the same run preempted at step
    TRAIN_FT["preempt"] and resumed by a new trainer from its checkpoint,
    with deterministic algorithms on: the per-step losses and the final
    parameters and optimizer state must be bit-equal. Prints the bytes a
    checkpoint holds and the save and restore seconds. No hand kernel
    launches. Returns the path's launch counts."""
    import dataclasses
    import itertools
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.ft import FaultTolerantTrainer, Preempted
    from repro_torch.models.model import Model
    from repro_torch.train import optim as O
    from repro_torch.train.step import TrainConfig, build_train_step
    from repro_torch.train.tree import leaves
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=TRAIN_FT["layers"])
    model = Model(cfg)
    opt = O.AdamW(lr=O.cosine_schedule(3e-4, 2, TRAIN_FT["steps"]))
    step = build_train_step(model, opt, TrainConfig(microbatches=2))
    steps, at = TRAIN_FT["steps"], TRAIN_FT["preempt"]

    def fresh():
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        return {"params": params, "opt": opt.init(params), "step": 0}

    def batches():
        for i in itertools.count():
            yield train_batch(torch, np, cfg.vocab_size, TRAIN_FT["batch"],
                              TRAIN["seq"], i)

    def run(trainer, state, gen, losses, times):
        def on(i, m):
            losses.append(m["loss"])
            times.append(m["step_seconds"])
        t = time.perf_counter()
        try:
            return trainer.run(state, gen, max_steps=steps, on_metrics=on)
        finally:
            times.append(time.perf_counter() - t)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want_losses = []
        trainer = FaultTolerantTrainer(step, CheckpointManager(
            f"{tmp}/straight", keep=1), save_every=10 ** 6)
        out = run(trainer, fresh(), batches(), want_losses, [])
        want = [x.cpu() for x in leaves({"p": out["params"],
                                         "o": out["opt"]})]
        del out, trainer
        shutil.rmtree(f"{tmp}/straight")

        got_losses, times = [], []
        mgr = CheckpointManager(f"{tmp}/preempted", keep=1)
        trainer = FaultTolerantTrainer(step, mgr, save_every=10 ** 6)
        gen = batches()

        def interrupting():
            for i, b in enumerate(gen):
                if i == at:
                    trainer.preempt()
                yield b
        preempted = False
        try:
            run(trainer, fresh(), interrupting(), got_losses, times)
        except Preempted:
            preempted = True
        check(preempted and mgr.latest_step() == at,
              f"train-ft: no checkpoint at the preemption ({mgr.all_steps()})")
        save_s = times[-1] - sum(times[:-1])
        step_dir = mgr._step_dir(at)
        nbytes = sum(f.stat().st_size for f in pathlib.Path(step_dir).iterdir())
        del trainer
        torch.cuda.empty_cache()

        trainer = FaultTolerantTrainer(step, CheckpointManager(
            f"{tmp}/preempted", keep=1), save_every=10 ** 6)
        target = fresh()
        t = time.perf_counter()
        resumed = trainer.resume_or_init(target["params"], target["opt"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        del target
        check(resumed["step"] == at, f"train-ft resumed at {resumed['step']}")
        out = run(trainer, resumed, itertools.islice(batches(), at, None),
                  got_losses, [])
        got = leaves({"p": out["params"], "o": out["opt"]})
        diffs = [float((g.cpu().float() - w.float()).abs().max())
                 if g.numel() else 0.0 for g, w in zip(got, want)]
        equal = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    counts = read()                   # just after the path
    emit({"phase": "train-ft", "path": "train-ft", "arch": TRAIN["arch"],
          "layers": cfg.n_layers, "params": cfg.param_count(),
          "steps": steps, "preempt_at": at, "losses_straight": want_losses,
          "losses_resumed": got_losses, "checkpoint_bytes": nbytes,
          "save_seconds": save_s, "restore_seconds": restore_s,
          "bit_equal": equal, "max_abs_diff": max(diffs),
          "launches": counts})
    check(got_losses == want_losses,
          f"train-ft: resumed losses {got_losses} vs {want_losses}")
    check(equal, f"train-ft: resumed state differs (max {max(diffs)})")
    check_path(counts, "train-ft", (), tuple(counts))
    del out, got, want, resumed
    torch.cuda.empty_cache()
    return counts


def tree_rel(torch, got, want, base=None) -> float:
    """||got - want|| / ||want - base|| (base 0) over the leaves of three
    trees of tensors, each pair compared on the card a leaf at a time."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    num = den = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.to(dev).float(), w.to(dev).float()
        num += float((g - w).pow(2).sum())
        ref = w if base is None else w - base[i].to(dev).float()
        den += float(ref.pow(2).sum())
    return math.sqrt(num / den)


class GradRecorder:
    """An optimizer that keeps a host copy of the gradient leaves the
    step hands it, by mesh point (-1 unsharded), then updates with
    `inner`."""

    def __init__(self, inner):
        self.inner, self.grads = inner, {}

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        from repro_torch.parallel import spmd as SP
        from repro_torch.train.tree import leaves
        ctx = SP.context()
        self.grads[-1 if ctx is None else ctx.point] = [
            g.detach().to("cpu", copy=True) for g in leaves(grads)]
        return self.inner.update(grads, state, params)


def leaf_rels(torch, got, want) -> list:
    """Each leaf's ||got - want|| / ||want||, where `got[i]` and `want[i]`
    are lists of the leaf's pieces (a point's slice each), compared on
    the card a piece at a time."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    out = []
    for gs, ws in zip(got, want):
        num = den = 0.0
        for g, w in zip(gs, ws):
            g, w = g.to(dev).float(), w.to(dev).float()
            num += float((g - w).pow(2).sum())
            den += float(w.pow(2).sum())
        out.append(math.sqrt(num / den) if den else
                   (0.0 if num == 0 else math.inf))
    return out


def sharded_train_gate(torch, cfg, mesh, batch, tc, fsdp: bool) -> dict:
    """Path `train-sharded`'s f32 gate: `cfg`'s model in f32 from seed 0,
    one AdamW step (cosine, peak 3e-4) on `batch` unsharded (under the
    mesh's abstract twin) and sharded on `mesh`, from the same weights
    (kept on the host between the runs, so one state is on the card at a
    time; each run's gradients are kept on the host too). Readings: each
    run's loss, gradient norm and seconds; the sharded run's loss and
    norm against the unsharded run's; every leaf's gradient, each point's
    slice against that slice of the unsharded gradient, as a relative L2
    a leaf (the worst leaf's, and its index in `leaves` order); the
    parameters' relative L2 after the step and that of their updates;
    and the control, the unsharded step on data shard 0's rows only (a
    data-parallel sum left out: the loss is the sound run's, only the
    gradient is cut), which the gate must reject."""
    import dataclasses

    from repro_torch.launch.dryrun import opt_shardings
    from repro_torch.launch.mesh import make_test_mesh, set_mesh
    from repro_torch.models.model import Batch, Model
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd as SP
    from repro_torch.train import optim as O
    from repro_torch.train.step import build_train_step
    from repro_torch.train.tree import leaves, tree_map
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = Model(cfg)
    dev = mesh.devices[0]
    cuda = torch.device(dev).type == "cuda"
    init = tree_map(lambda t: t.cpu(), model.init(
        torch.Generator(device=dev).manual_seed(0)))
    opt = GradRecorder(O.AdamW(lr=O.cosine_schedule(3e-4, 2, 3)))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def unsharded(b):
        p = tree_map(lambda t: t.to(dev, copy=True), init)
        state = opt.init(p)
        with set_mesh(make_test_mesh(mesh.axis_sizes, mesh.axis_names)):
            sync()
            t = time.perf_counter()
            p, state, m = build_train_step(model, opt, tc)(p, state, b)
            sync()
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "seconds": time.perf_counter() - t}
        out = [x.cpu() for x in leaves(p)]
        del p, state
        if cuda:
            torch.cuda.empty_cache()
        return rec, out, opt.grads.pop(-1)
    sound, want, full = unsharded(batch)
    rows_b = batch.tokens.shape[0]
    per = rows_b // tc.microbatches
    mine = per // mesh.shape["data"]
    rows = [i * per + j for i in range(tc.microbatches) for j in range(mine)]
    control, cut, grads = unsharded(
        Batch(batch.tokens[rows], batch.targets[rows]))
    control["loss"] = sound["loss"]
    control["leaf_rels"] = leaf_rels(torch, [[g] for g in grads],
                                     [[w] for w in full])
    del grads

    specs = S.param_specs(cfg, mesh, fsdp)
    params = SP.shard_tree(init, specs, mesh)
    state = SP.init_state(opt.init, params, opt_shardings)
    step = build_train_step(model, opt, tc, mesh=mesh)
    sync()
    t = time.perf_counter()
    params, state, m = step(params, state, batch)
    sync()
    sharded = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "seconds": time.perf_counter() - t}
    got = leaves(SP.gather_tree(params, "cpu"))
    del params, state, step
    if cuda:
        torch.cuda.empty_cache()
    points = range(mesh.size)
    sharded["leaf_rels"] = leaf_rels(
        torch, [[opt.grads[p][i] for p in points] for i in range(len(full))],
        [[w[SP.local_slices(w.shape, spec, mesh, p)] for p in points]
         for w, spec in zip(full, S.spec_leaves(specs))])
    opt.grads.clear()
    base = leaves(init)
    out = {"unsharded": sound, "sharded": sharded, "control": control}
    for rec, ps in (("sharded", got), ("control", cut)):
        r = out[rec]
        rels = r.pop("leaf_rels")
        r["loss_abs"] = abs(r["loss"] - sound["loss"])
        r["grad_norm_rel"] = abs(r["grad_norm"] - sound["grad_norm"]) \
            / sound["grad_norm"]
        r["grad_leaf_rel"] = max(rels)
        r["grad_leaf_worst"] = rels.index(max(rels))
        r["param_rel"] = tree_rel(torch, ps, want)
        r["update_rel"] = tree_rel(torch, ps, want, base)
        r["passes_gate"] = (r["loss_abs"] <= SHARDED_TRAIN_LOSS_ABS
                            and r["grad_norm_rel"] <= SHARDED_TRAIN_GNORM_REL
                            and r["grad_leaf_rel"] <= SHARDED_TRAIN_GRAD_REL
                            and r["param_rel"] <= SHARDED_TRAIN_PARAM_REL
                            and r["update_rel"] <= SHARDED_TRAIN_UPDATE_REL)
    return out


def train_sharded_phase(torch, np, kb, sj, fa, dev, smi: str) -> dict:
    """Path `train-sharded`: TRAIN_SHARDED's model through
    `build_train_step(..., mesh=)` on four points of the card. First the
    bytes reckoned; then the f32 gate (`sharded_train_gate`: loss,
    gradient norm and parameters after one step against the unsharded
    step, and its control); then TRAIN_SHARDED["steps"] bf16 steps on
    one repeated batch, whose collectives (`spmd.COMM`) must equal
    `spmd.train_comm` times the steps and `collectives.count` (one
    point's step counted on "meta") times the points and the steps,
    every loss finite and each
    under the one before. No hand kernel launches (attention on
    "auto"). Prints the step seconds, tokens a second and the peak
    memory beside the card's name and power limit. Returns the path's
    launch counts."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import collectives
    from repro_torch.launch.dryrun import local_bytes, opt_shardings
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import abstract_params
    from repro_torch.models.model import Model
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd as SP
    from repro_torch.train import optim as O
    from repro_torch.train.step import TrainConfig, build_train_step
    spec, path = TRAIN_SHARDED, "train-sharded"
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    n = cfg.param_count()
    b, s, steps = spec["batch"], spec["seq"], spec["steps"]
    mesh = make_test_mesh(spec["mesh"], devices=[dev] * 4)
    specs = S.param_specs(cfg, mesh, spec["fsdp"])
    per_point = local_bytes(abstract_params(cfg), specs, mesh)
    tc = TrainConfig(microbatches=spec["microbatches"], remat=True)
    torch.cuda.empty_cache()
    # f32: a copy of the weights, and with the gradient and AdamW's two
    # moments; the gate holds one state at a time on the card
    emit({"phase": path, "step": "reckoning", "arch": spec["arch"],
          "layers": cfg.n_layers, "published_layers": full.n_layers,
          "params": n, "f32_weights_bytes": 4 * n,
          "f32_state_bytes": 16 * n, "bf16_param_bytes_per_point":
          per_point, "mesh": list(spec["mesh"]), "fsdp": spec["fsdp"],
          "card_bytes": torch.cuda.get_device_properties(0).total_memory})
    batch = train_batch(torch, np, cfg.vocab_size, b, s, 0)

    t_path = time.perf_counter()
    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    torch.cuda.reset_peak_memory_stats()
    gate = sharded_train_gate(torch, cfg, mesh, batch, tc, spec["fsdp"])
    gate_peak = torch.cuda.max_memory_allocated()
    emit({"phase": path, "check": "f32 sharded vs unsharded step",
          "tol_loss_abs": SHARDED_TRAIN_LOSS_ABS,
          "tol_grad_norm_rel": SHARDED_TRAIN_GNORM_REL,
          "tol_grad_leaf_rel": SHARDED_TRAIN_GRAD_REL,
          "tol_param_rel": SHARDED_TRAIN_PARAM_REL,
          "tol_update_rel": SHARDED_TRAIN_UPDATE_REL,
          "peak_memory_bytes": gate_peak, "card": smi, **gate})

    model = Model(cfg)
    opt = O.AdamW(lr=O.cosine_schedule(3e-4, 2, steps))
    params = SP.shard_tree(model.init(torch.Generator(
        device=dev).manual_seed(0)), specs, mesh)
    state = SP.init_state(opt.init, params, opt_shardings)
    torch.cuda.empty_cache()
    step = build_train_step(model, opt, tc, mesh=mesh)
    SP.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t)
        norms.append(float(m["grad_norm"]))
        emit({"phase": path, "step": i + 1, "loss": losses[-1],
              "grad_norm": norms[-1], "lr": float(m["lr"]),
              "seconds": secs[-1]})
    comm = dict(SP.COMM)
    peak = torch.cuda.max_memory_allocated()
    counts = read()                   # just after the path
    want = {k: x * steps for k, x in
            SP.train_comm(cfg, mesh, b, s, tc, spec["fsdp"]).items()}
    # one point's step counted on "meta", times the points and steps
    t0 = time.perf_counter()
    one = collectives.count(cfg, ShapeSpec(path, s, b, "train"), mesh,
                            fsdp=spec["fsdp"], tc=tc, optimizer=O.AdamW(
                                lr=O.cosine_schedule(3e-4, 2, steps)))
    count_seconds = time.perf_counter() - t0
    counted = {k: one[k] * mesh.size * steps for k in SP.COMM}
    held = [SP.tree_local_bytes(params, p) for p in range(mesh.size)]
    step_s = statistics.mean(secs[1:])
    # one more step under torch.profiler, outside the path's counts: the
    # four points' streams may overlap, so the summed device time is at
    # most the busy time and the idle share at least the true one
    prof = device_profile(torch, lambda: step(params, state, batch))
    emit({"phase": path, "path": path, "arch": spec["arch"],
          "config": cfg.name, "layers": cfg.n_layers, "params": n,
          "mesh": list(spec["mesh"]), "axes": list(mesh.axis_names),
          "devices": [str(d) for d in mesh.devices], "fsdp": spec["fsdp"],
          "batch": b, "seq": s, "microbatches": tc.microbatches,
          "remat": tc.remat, "steps": steps, "losses": losses,
          "grad_norms": norms, "step_seconds_all": secs,
          "step_seconds": step_s, "tokens_per_second": b * s / step_s,
          "peak_memory_bytes": peak, "param_bytes_per_point": held,
          "param_bytes_per_point_reckoned": per_point,
          "collectives": comm, "collectives_formula": want,
          "collectives_counted": counted,
          "collectives_count_seconds": count_seconds,
          "profile_one_step": prof, "launches": counts,
          "path_seconds": time.perf_counter() - t_path, "card": smi})
    check(gate["sharded"]["passes_gate"],
          f"{path}: the f32 sharded step is off the unsharded one "
          f"({gate['sharded']})")
    check(not gate["control"]["passes_gate"],
          f"{path}: the f32 gate passes a data-parallel sum left out "
          f"({gate['control']})")
    check(all(math.isfinite(x) for x in losses + norms),
          f"{path}: a loss or gradient norm is not finite ({losses})")
    check(all(y < x for x, y in zip(losses, losses[1:])),
          f"{path}: the losses did not fall step by step ({losses})")
    check(comm == want, f"{path}: collectives {comm}, the formula {want}")
    check(comm == counted, f"{path}: collectives {comm}, the count of one "
          f"point on meta {counted}")
    check(held == [per_point] * mesh.size,
          f"{path}: points hold {held} parameter bytes, the specs "
          f"{per_point} each")
    check_path(counts, path, (), tuple(counts))
    del params, state, step, model
    torch.cuda.empty_cache()
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


def attention_phase(torch, fa, dev, ptxas_log: str,
                    whole_plain: bool = False):
    """K8 against `flash_plain` and `sdpa_ref` on the card, one line per
    shape (a mesh point's share of some served shapes too); returns the
    records of the kernel table's rows (qwen1.5-4b's, deepseek-v2-lite's
    and whisper-base's serve shapes: the encoder's and a cross decode
    step's for (64, 64)) and each row's largest error. Every line adds
    the kernel's registers and spills from `ptxas_log`; a prefill line
    its device TFLOP/s (unmasked flops over `device_ms`) and the shared
    memory one of its CTAs takes, a decode line its device GB/s. A case
    whose dense f32 scores pass 8 GB (a batch-1 point's 32,744-row
    prefill) is held to `flash_plain` alone, and, unless `whole_plain`,
    on its last `PLAIN_ROWS` query rows (they see the most keys; its
    plain version over every row took 36 s on the H100), the line
    saying which rows its `plain_ms` covers."""
    import torch.nn.functional as F
    from repro_torch.kernels.flashattn.ref import attend_mask, sdpa_ref
    from repro_torch.models.layers import _ring_positions
    gen = torch.Generator(device=dev).manual_seed(3)

    def rows(b, n, start=0):
        return (torch.arange(start, start + n, dtype=torch.int32,
                             device=dev)[None].expand(b, n).contiguous())

    def ring(index, cap, b, start=0, n=None):   # the model's own cache
        return _ring_positions(index, cap, b, dev, start, n)   # positions

    def zeros(b, n):                  # cross-attention's positions
        return torch.zeros(b, n, dtype=torch.int32, device=dev)

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
        # a mesh point's share on (2, 2) (serve-sharded-mla: 2 of the 4
        # rows, 8 of the 16 heads; decode's split-KV tiling differs)
        ("deepseek-v2-lite point prefill", 2, 2048, 2088, 8, 8, (192, 128),
         True, None, rows(2, 2048), ring(2048, 2088, 2)),
        ("deepseek-v2-lite point prefill, ring wrapped", 2, 2048, 2088, 8,
         8, (192, 128), True, None, rows(2, 2048, 1040),
         ring(3088, 2088, 2)),
        ("deepseek-v2-lite point decode", 2, 1, 2088, 8, 8, (192, 128),
         True, None, rows(2, 1, 2080), ring(2081, 2088, 2)),
        ("deepseek-v2-lite point decode, ring wrapped", 2, 1, 2088, 8, 8,
         (192, 128), True, None, rows(2, 1, 3087), ring(3088, 2088, 2)),
        # llava-next-mistral-7b's point on (2, 2) (serve-sharded-llava: 2
        # rows, 16/4 heads; 576 patches and 1472 tokens in 2088 slots)
        ("llava point prefill", 2, 2048, 2088, 16, 4, (128, 128), True,
         None, rows(2, 2048), ring(2048, 2088, 2)),
        ("llava point decode", 2, 1, 2088, 16, 4, (128, 128), True, None,
         rows(2, 1, 2080), ring(2081, 2088, 2)),
        # mixtral-8x7b (32/8 heads of 128, window 4096): the full forward's
        # and the loss's shape, where the window masks and the tiles wholly
        # outside it are skipped; and decode at position 4100 on its
        # 4096-slot ring, wrapped (the serve path's ring after step 20)
        ("mixtral prefill, window 4096 over 8192", 1, 8192, 8192, 32, 8,
         (128, 128), True, 4096, rows(1, 8192),
         (rows(1, 8192), torch.ones(1, 8192, dtype=torch.bool,
                                    device=dev))),
        ("mixtral decode, window 4096, ring wrapped", 2, 1, 4096, 32, 8,
         (128, 128), True, 4096, rows(2, 1, 4100), ring(4101, 4096, 2)),
        # whisper-base (8 heads of 64) at serve-whisper's shapes: the
        # encoder's self-attention over 1500 frames (non-causal, no tile
        # skipped, the last key tile 92 of 128), cross-attention at the
        # prefill's 32 queries and at a decode step, every position 0
        ("whisper encoder", 16, 1500, 1500, 8, 8, (64, 64), False, None,
         rows(16, 1500), (rows(16, 1500), torch.ones(
             16, 1500, dtype=torch.bool, device=dev))),
        ("whisper cross prefill", 16, 32, 1500, 8, 8, (64, 64), False, None,
         zeros(16, 32), (zeros(16, 1500), torch.ones(
             16, 1500, dtype=torch.bool, device=dev))),
        ("whisper cross decode", 16, 1, 1500, 8, 8, (64, 64), False, None,
         zeros(16, 1), (zeros(16, 1500), torch.ones(
             16, 1500, dtype=torch.bool, device=dev))),
        # whisper-base's point on (2, 2) (serve-sharded-whisper: 8 of the
        # 16 rows, 4 of the 8 heads) at the same three shapes
        ("whisper point encoder", 8, 1500, 1500, 4, 4, (64, 64), False,
         None, rows(8, 1500), (rows(8, 1500), torch.ones(
             8, 1500, dtype=torch.bool, device=dev))),
        ("whisper point cross prefill", 8, 32, 1500, 4, 4, (64, 64), False,
         None, zeros(8, 32), (zeros(8, 1500), torch.ones(
             8, 1500, dtype=torch.bool, device=dev))),
        ("whisper point cross decode", 8, 1, 1500, 4, 4, (64, 64), False,
         None, zeros(8, 1), (zeros(8, 1500), torch.ones(
             8, 1500, dtype=torch.bool, device=dev))),
        # qwen1.5-4b's points under context parallelism: on (1, 8)
        # (serve-sharded-cp) the last point's 256 query rows of the
        # 2048-token prefill against the gathered 2048 keys, and decode at
        # position 2063 over the last point's 259 of the 2072 slots; on
        # (2, 2) at batch 1 (serve-sharded-b1) decode at position 32,759
        # over the first data point's 16,384 slots and 10 of the 20 heads
        ("qwen1.5-4b cp point prefill", 4, 256, 2048, 20, 20, (128, 128),
         True, None, rows(4, 256, 1792), ring(2048, 2048, 4)),
        ("qwen1.5-4b cp point decode", 4, 1, 259, 20, 20, (128, 128), True,
         None, rows(4, 1, 2063), ring(2064, 2072, 4, 1813, 259)),
        ("qwen1.5-4b b1 point decode", 1, 1, 16384, 10, 10, (128, 128),
         True, None, rows(1, 1, 32759), ring(32760, 32768, 1, 0, 16384)),
        # deepseek-v2-lite-16b's point on (2, 2) at batch 1
        # (serve-sharded-b1-mla): its 8 heads of the 32,744-token prefill
        # against the call's own latent, and decode at position 32,759 over
        # the first data point's 16,384 slots
        ("deepseek-v2-lite b1 point prefill", 1, 32744, 32744, 8, 8,
         (192, 128), True, None, rows(1, 32744),
         (rows(1, 32744), torch.ones(1, 32744, dtype=torch.bool,
                                     device=dev))),
        ("deepseek-v2-lite b1 point decode", 1, 1, 16384, 8, 8, (192, 128),
         True, None, rows(1, 1, 32759), ring(32760, 32768, 1, 0, 16384)),
        # deepseek-v2-lite-16b's last point on (1, 3) (serve-sharded-seq-
        # mla: MLA split by sequence): its 682 query rows of the
        # 2,046-token prefill against every row's keys, and decode at
        # position 2,061 over its 690 of the 2,070 slots (the path runs it
        # with the log-sum-exp: `lse_ms`)
        ("deepseek-v2-lite seq point prefill", 4, 682, 2046, 16, 16,
         (192, 128), True, None, rows(4, 682, 1364),
         (rows(4, 2046), torch.ones(4, 2046, dtype=torch.bool,
                                    device=dev))),
        ("deepseek-v2-lite seq point decode", 4, 1, 690, 16, 16, (192, 128),
         True, None, rows(4, 1, 2061), ring(2062, 2070, 4, 1380, 690)),
    )
    worst = dict.fromkeys(FLASH + FLASH_MLA + FLASH_D64, 0.0)
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
        # a batch-1 point's 32,744-row prefill: sdpa_ref's f32 scores would
        # take 34 GB and `flash_plain`'s 65,536 blocks 36 s, so the plain
        # version runs once, on the last rows unless `whole_plain`, and
        # SDPA is asked for the causal mask without a mask tensor (the
        # same mask here)
        big = b * h * sq * skv > 1 << 31
        rows_p = slice(0 if whole_plain or not big else sq - PLAIN_ROWS, sq)
        held = {}

        def plain_call():
            held["plain"] = fa.flash_plain(q[:, rows_p], k, v, qp[:, rows_p],
                                           kp, kval, **kw)
        plain_ms = cuda_ms(torch, plain_call, 1 if big else 3,
                           warm=0 if big else 1)
        plain = held.pop("plain")
        refs = [("flash_plain", plain)]
        rep_kv = h // kvh
        if not big:
            refs.append(("sdpa_ref", sdpa_ref(
                q, k.repeat_interleave(rep_kv, 2),
                v.repeat_interleave(rep_kv, 2), qp, kp, kval, **kw)))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K8 {name}: not finite")
        errs, limits = {}, {}
        for ref_name, ref in refs:
            mine = got[:, rows_p] if ref_name == "flash_plain" else got
            errs[ref_name] = float((mine.float() - ref.float()).abs().max())
            check(torch.allclose(mine.float(), ref.float(), atol=FLASH_TOL,
                                 rtol=FLASH_TOL),
                  f"K8 {name} differs from {ref_name} by "
                  f"{errs[ref_name]}")
            if sq == 1:
                limits[ref_name] = decode_limit(ref)
                check(errs[ref_name] <= limits[ref_name],
                      f"K8 {name} differs from {ref_name} by "
                      f"{errs[ref_name]}, over {limits[ref_name]}")
        variant = "flash_decode" if sq == 1 else "flash_prefill"
        row = k8_row(variant, d, dv)
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
            if big:
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=h != kvh)
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=h != kvh)
        rec = {"phase": "attention", "kernel": variant, "case": name,
               "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "KVH": kvh,
                         "D": d, "Dv": dv},
               "causal": causal, "window": window,
               "unmasked_pairs": pairs, "flops": flops, "bytes": nbytes,
               "ms": cuda_ms(torch, lambda: fa.flash_attention(*args, **kw),
                             10, per=10),
               "plain_ms": plain_ms, "plain_device": "cuda",
               "plain_rows": rows_p.stop - rows_p.start,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": cuda_ms(torch, library, 10, per=10),
               "library_call": "torch.nn.functional."
                               "scaled_dot_product_attention(" + (
                                   "is_causal" if big else "attn_mask=bool")
                               + ", enable_gqa)",
               # device time alone, out of the profiler: at Sq 1 the
               # host's dispatch can outlast both calls' kernels
               "device_ms": device_ms(
                   torch, lambda: fa.flash_attention(*args, **kw)),
               "library_device_ms": device_ms(torch, library),
               "max_abs_err": errs["flash_plain"],
               "max_abs_err_sdpa_ref": errs.get("sdpa_ref"),
               "tol": FLASH_TOL}
        if name in LSE_TIMED:       # as its path calls it
            def lse_call():
                return fa.flash_attention(*args, return_lse=True, **kw)
            rec["lse_ms"] = cuda_ms(torch, lse_call, 10, per=10)
            rec["lse_device_ms"] = device_ms(torch, lse_call)
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
                    "deepseek-v2-lite prefill", "deepseek-v2-lite decode",
                    "whisper encoder", "whisper cross decode"):
            rep[row] = rec
    return rep, worst


def lse_phase(torch, fa, dev) -> dict:
    """Phase 7a: K8 decode's `return_lse` on the card, as the module's note
    says; returns the worst errors (the output's against `flash_plain`,
    the lse's, and the merged ranges' against the whole-cache call, each
    over its limit)."""
    from repro_torch.models.layers import _ring_positions
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {"o": 0.0, "lse": 0.0, "merged_over_limit": 0.0}
    cases = (  # name, b, skv, h, kvh, (d, dv), window, index
        ("qwen1.5-4b cp decode", 4, 2072, 20, 20, (128, 128), None, 2064),
        ("GQA 32/8 decode", 2, 2048, 32, 8, (128, 128), None, 1500),
        ("d64 decode", 4, 1024, 8, 8, (64, 64), None, 1000),
        ("d64 GQA 16/4 window 256", 2, 1024, 16, 4, (64, 64), 256, 1000),
        # deepseek-v2-lite-16b's point at batch 1 on (2, 2)
        # (serve-sharded-b1-mla): 8 heads over a data point's 16,384 slots
        ("MLA b1 point decode", 1, 16384, 8, 8, (192, 128), None, 16000),
        # its point on (1, 3) (serve-sharded-seq-mla): 16 heads over 690
        # slots
        ("MLA seq point decode", 4, 690, 16, 16, (192, 128), None, 600),
    )
    for name, b, skv, h, kvh, (d, dv), window, index in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, k, v = randn(b, 1, h, d), randn(b, skv, kvh, d), \
            randn(b, skv, kvh, dv)
        kp, kval = _ring_positions(index, skv, b, dev)
        qp = torch.full((b, 1), index - 1, dtype=torch.int32, device=dev)
        kw = {"causal": True, "window": window}
        o, lse = fa.flash_attention(q, k, v, qp, kp, kval, return_lse=True,
                                    **kw)
        po, plse = fa.flash_plain(q, k, v, qp, kp, kval, return_lse=True,
                                  **kw)
        torch.cuda.synchronize()
        o_err = float((o.float() - po.float()).abs().max())
        check(o_err <= min(FLASH_TOL, decode_limit(po)),
              f"K8 lse {name}: o differs from flash_plain's by {o_err}")
        check(torch.equal(torch.isinf(lse), torch.isinf(plse)),
              f"K8 lse {name}: -inf where flash_plain's is not")
        live = torch.isfinite(plse)
        lse_err = float((lse[live] - plse[live]).abs().max())
        check(lse_err <= LSE_TOL,
              f"K8 lse {name}: lse differs from flash_plain's by {lse_err}")
        whole = fa.flash_attention(q, k, v, qp, kp, kval, **kw)
        rec = {"phase": "lse", "case": name,
               "shape": {"B": b, "Skv": skv, "H": h, "KVH": kvh, "D": d,
                         "Dv": dv},
               "window": window, "o_err": o_err, "lse_err": lse_err,
               "tol": {"o": min(FLASH_TOL, decode_limit(po)),
                       "lse": LSE_TOL},
               "ms": cuda_ms(torch, lambda: fa.flash_attention(
                   q, k, v, qp, kp, kval, return_lse=True, **kw), 10,
                   per=10),
               "ms_without_lse": cuda_ms(torch, lambda: fa.flash_attention(
                   q, k, v, qp, kp, kval, **kw), 10, per=10)}
        worst["o"] = max(worst["o"], o_err)
        worst["lse"] = max(worst["lse"], lse_err)
        for ranges in (2, 4):
            # the cursor stands before the last range: it holds no valid
            # key (context parallelism's later points early in a decode)
            n = skv // ranges
            pos, valid = _ring_positions((ranges - 1) * n, skv, b, dev)
            qp_r = torch.full((b, 1), (ranges - 1) * n - 1,
                              dtype=torch.int32, device=dev)
            ref = fa.flash_attention(q, k, v, qp_r, pos, valid, **kw)
            outs, lses = [], []
            for r in range(ranges):
                sl = slice(r * n, skv if r == ranges - 1 else (r + 1) * n)
                o_r, l_r = fa.flash_attention(
                    q, k[:, sl].contiguous(), v[:, sl].contiguous(), qp_r,
                    pos[:, sl].contiguous(), valid[:, sl].contiguous(),
                    return_lse=True, **kw)
                outs.append(o_r[:, 0])
                lses.append(l_r)
            check(bool(torch.isneginf(lses[-1]).all()),
                  f"K8 lse {name}: a range with no valid key reports a "
                  f"finite lse")
            merged = fa.merge_partials(torch.stack(outs),
                                        torch.stack(lses)).to(torch.bfloat16)
            err = float((merged.float() - ref[:, 0].float()).abs().max())
            limit = decode_limit(ref)
            check(err <= limit, f"K8 lse {name}: {ranges} ranges merged "
                  f"differ from the whole call by {err}, over {limit}")
            rec[f"merged_{ranges}_err"] = err
            rec[f"merged_{ranges}_limit"] = limit
            worst["merged_over_limit"] = max(worst["merged_over_limit"],
                                             err / limit)
        emit(rec)
    return worst


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind `tensors`."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def param_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from param_tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from param_tensors(v)
    else:
        yield tree


def launch_reports_phase(torch, kb, sj, fa, dev, smi: str) -> dict:
    """Path `launch-reports`: the launch layer's reckonings against the
    card, for qwen1.5-4b at the serve path's shape (`LAUNCH_REPORTS`) on a
    one-device mesh (`make_test_mesh((1, 1))`). Exact check:
    `dryrun.argument_bytes` of the prefill (parameters + batch) and of a
    decode step (parameters + tokens + the ring caches) must equal the
    bytes of the storages the served model really allocates. FLOP check:
    `FlopCounterMode`'s count of one real prefill call on the card, on
    "auto" attention, over `analytic.prefill_cost(...).flops` must lie in
    `FLOP_RATIO_BOUNDS`; the meta device's trace of the same call is
    printed beside it. Prints the analytic compute and memory times
    beside the measured prefill seconds (K8, CUDA events) and a decode
    step's device ms (torch.profiler), and the bound's share of each.
    The served calls run on "flash": K8 must launch, K1-K7 never. Then
    the dry run's collective fields (`launch.collectives.count_cell`, one
    point's step on "meta") of `LAUNCH_REPORT_CELLS` on both production
    meshes, with each count's seconds."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import analytic, collectives, dryrun
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import layers as L
    from repro_torch.models.common import abstract_params
    from repro_torch.models.model import Batch, Model

    spec = LAUNCH_REPORTS
    arch, b, s, cap = spec["arch"], spec["batch"], spec["prompt_len"], \
        spec["cap"]
    cfg = get_config(arch)
    mesh = make_test_mesh((1, 1))
    pre_shape = ShapeSpec("serve-prefill", s, b, "prefill")
    dec_shape = ShapeSpec("serve-decode", cap, b, "decode")
    torch.cuda.empty_cache()
    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    base = torch.cuda.memory_allocated()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _, args, _ = input_specs(arch, pre_shape, mesh, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, tuple(args[0].tokens.shape),
                        generator=gen, device=dev,
                        dtype=args[0].tokens.dtype)
    batch = Batch(tok, tok.clone())
    allocated = torch.cuda.memory_allocated() - base
    p_bytes = storage_bytes(param_tensors(params))
    b_bytes = storage_bytes([batch.tokens]) + storage_bytes([batch.targets])
    want_pre = dryrun.argument_bytes(arch, pre_shape, mesh, cfg)
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(params, batch,
                                                         cap=cap)
    prefill_ms = cuda_ms(torch, prefill, reps=3, warm=1)
    step_tok = state["logits"][:, -1].argmax(-1)[:, None].to(tok.dtype)
    caches = state["caches"]
    c_bytes = storage_bytes(t for c in caches["prefix"] + caches["slots"]
                            for t in (c.k, c.v))
    want_dec = dryrun.argument_bytes(arch, dec_shape, mesh, cfg)
    t_bytes = storage_bytes([step_tok])

    def decode():
        model.decode_step(params, step_tok, caches, s)
    decode_ms = device_ms(torch, decode)
    torch.cuda.synchronize()
    counts = read()                   # just after the path

    check(want_pre["argument_bytes"] == p_bytes + b_bytes,
          f"launch-reports: prefill argument bytes {want_pre} != "
          f"{p_bytes} + {b_bytes} allocated")
    check(want_dec["argument_bytes"] == p_bytes + t_bytes + c_bytes,
          f"launch-reports: decode argument bytes {want_dec} != "
          f"{p_bytes} + {t_bytes} + {c_bytes} allocated")
    with L.attention_backend("auto"), torch.no_grad(), \
            FlopCounterMode(display=False) as fc:
        model.prefill(params, batch, cap=cap)
    flops = fc.get_total_flops()
    meta = torch.empty(tuple(tok.shape), dtype=tok.dtype, device="meta")
    with L.attention_backend("auto"), torch.no_grad(), \
            FlopCounterMode(display=False) as fc:
        model.prefill(abstract_params(cfg), Batch(meta, meta), cap=cap)
    meta_flops = fc.get_total_flops()
    pre_cost = analytic.prefill_cost(cfg, pre_shape, mesh.shape)
    dec_cost = analytic.decode_cost(cfg, dec_shape, mesh.shape)
    ratio = flops / pre_cost.flops
    pre_t, dec_t = pre_cost.terms(), dec_cost.terms()
    emit({"phase": "launch-reports", "path": "launch-reports", "card": smi,
          "arch": arch, "batch": b, "prompt_len": s, "cap": cap,
          "mesh": dict(mesh.shape),
          "argument_bytes": {
              "prefill": want_pre["argument_bytes"],
              "prefill_parts": want_pre["parts"],
              "decode": want_dec["argument_bytes"],
              "decode_parts": want_dec["parts"],
              "allocated_params": p_bytes, "allocated_batch": b_bytes,
              "allocated_step_tokens": t_bytes,
              "allocated_caches": c_bytes,
              "memory_allocated_delta": allocated, "exact": True},
          "flops": {"counted_on_card": flops, "counted_on_meta": meta_flops,
                    "equal": flops == meta_flops,
                    "analytic": pre_cost.flops, "ratio": ratio,
                    "bounds": FLOP_RATIO_BOUNDS, "attention": "auto"},
          "prefill": {"analytic_compute_s": pre_t["compute_s"],
                      "analytic_memory_s": pre_t["memory_s"],
                      "measured_s": prefill_ms / 1e3,
                      "bound_share": max(pre_t["compute_s"],
                                         pre_t["memory_s"])
                      / (prefill_ms / 1e3)},
          "decode": {"analytic_compute_s": dec_t["compute_s"],
                     "analytic_memory_s": dec_t["memory_s"],
                     "measured_device_ms": decode_ms,
                     "bound_share": max(dec_t["compute_s"],
                                        dec_t["memory_s"])
                     / (decode_ms / 1e3)},
          "launches": {k: counts[k] for k in FLASH}})
    cells = []
    for cell_arch, cell_shape in LAUNCH_REPORT_CELLS:
        for multi in (False, True):
            cell_mesh = make_production_mesh(multi_pod=multi)
            t0 = time.perf_counter()
            one = collectives.count_cell(cell_arch, cell_shape, cell_mesh)
            stats = collectives.collective_stats(one)
            cells.append({
                "arch": cell_arch, "shape": cell_shape,
                "mesh": dict(cell_mesh.shape), "collectives": stats,
                "collective_bytes_per_device":
                    collectives.collective_bytes(stats),
                "collective_received_bytes_per_device":
                    collectives.received_bytes(one),
                "collective_trace_seconds": time.perf_counter() - t0})
            check(stats["all-gather"]["count"] > 0
                  and stats["all-reduce"]["count"] > 0,
                  f"launch-reports: {cell_arch} x {cell_shape} on "
                  f"{cell_mesh.shape} counted no collectives ({stats})")
    emit({"phase": "launch-reports", "path": "launch-reports",
          "dry_run_collectives": cells, "card": smi})
    check(FLOP_RATIO_BOUNDS[0] <= ratio <= FLOP_RATIO_BOUNDS[1],
          f"launch-reports: counted prefill FLOPs {flops} are {ratio} of "
          f"the model's {pre_cost.flops}, outside {FLOP_RATIO_BOUNDS}")
    check_path(counts, "launch-reports", FLASH,
               ("multi_probe", "bloom_build", "probe", "joinmap_build",
                "joinmap_lookup", *API_ONLY))
    del model, params, caches, state
    torch.cuda.empty_cache()
    return counts


def record_routes(L, replay=None) -> tuple:
    """Wrap `layers.moe_route` so that each call's `Route` is kept in call
    order; with `replay` (the routes of an earlier run on the same tokens,
    in call order) each call returns the next of those instead of its own
    choice. Returns (the kept routes, a function that takes the wrapper
    off)."""
    seen, inner = [], L.moe_route
    queue = iter(replay) if replay is not None else None

    def wrapped(router, h, m, s, groups=None):
        route = inner(router, h, m, s, groups) if queue is None \
            else next(queue)
        seen.append(route)
        return route
    L.moe_route = wrapped
    return seen, lambda: setattr(L, "moe_route", inner)


def sharded_routes(L, SP, routes: list, replay: bool):
    """Wrap `layers.moe_route` for a sharded run (`spmd.run`): each mesh
    point's n-th call is matched with the n-th of `routes` (an unsharded
    run's on the same tokens, in call order) cut to the point's rows (its
    data shard's tokens: one group of the unsharded run's). With `replay`
    the call returns that cut; without, it routes on its own and the pair
    (its route, the cut) is kept under the point. Returns (the kept pairs
    by point, a function that takes the wrapper off)."""
    inner, calls, kept = L.moe_route, {}, {}

    def wrapped(router, h, m, s, groups=None):
        ctx = SP.context()
        n = calls.get(ctx.point, 0)
        calls[ctx.point] = n + 1
        r, t = routes[n], h.shape[0]
        shard = 0
        if r.top_e.shape[0] != t:       # the batch is split over data
            shard = (ctx.coords.get("pod", 0) * ctx.mesh.shape.get("data", 1)
                     + ctx.coords.get("data", 0))
        rows = slice(shard * t, (shard + 1) * t)
        cut = L.Route(*(x[rows].to(h.device) for x in r[:4]), r.capacity,
                      r.groups * t // r.top_e.shape[0])
        if replay:
            return cut
        own = inner(router, h, m, s, groups)
        kept.setdefault(ctx.point, []).append((own, cut))
        return own
    L.moe_route = wrapped
    return kept, lambda: setattr(L, "moe_route", inner)


def sharded_route_check(torch, SP, kept: dict, mesh, n_moe: int) -> dict:
    """A sharded run's own routing (`sharded_routes`' kept pairs) against
    the unsharded run's, call i being MoE layer i % `n_moe` (prefill
    first). The (token, layer) choices whose experts differ, counted over
    the first point of each data shard (its tokens once): in all, at
    prefill, at decode and by layer. And `routes_consistent`, which holds
    where every call's capacity and group count equal the unsharded
    run's, the points of a data shard route alike (experts, weights,
    positions, kept), and in each group whose experts all agree the
    positions and kept flags equal the unsharded run's (a fault of the
    sharded routing breaks one of these; rounding does not)."""
    faults, shards = [], {}
    for point, pairs in sorted(kept.items()):
        c = SP.point_coords(mesh, point)
        key = tuple(v for a, v in c.items() if a != "model")
        shards.setdefault(key, []).append((point, pairs))
    counts = {"all": [0, 0], "prefill": [0, 0], "decode": [0, 0]}
    layers = [[0, 0] for _ in range(n_moe)]
    compared = 0
    for (first, pairs), *rest in shards.values():
        for point, other in rest:
            if len(other) != len(pairs) or not all(
                    torch.equal(x, y) for (a, _), (b, _) in zip(pairs, other)
                    for x, y in zip(a[:4], b[:4])):
                faults.append(f"points {first} and {point} of one data "
                              "shard route differently")
        for i, (own, cut) in enumerate(pairs):
            if (own.capacity, own.groups) != (cut.capacity, cut.groups):
                faults.append(f"point {first} call {i}: capacity, groups "
                              f"{own.capacity}, {own.groups} against "
                              f"{cut.capacity}, {cut.groups}")
            differ = (own.top_e.sort(-1).values
                      != cut.top_e.sort(-1).values).any(-1)
            n, t = int(differ.sum()), differ.shape[0]
            phase = "prefill" if i < n_moe else "decode"
            for tally in (counts["all"], counts[phase], layers[i % n_moe]):
                tally[0] += n
                tally[1] += t
            same = (own.top_e == cut.top_e).all(-1)
            tg = t // max(own.groups, 1)
            for g0 in range(0, t, tg):
                rows = slice(g0, g0 + tg)
                if not bool(same[rows].all()):
                    continue
                compared += 1
                if not (torch.equal(own.pos[rows], cut.pos[rows])
                        and torch.equal(own.keep[rows], cut.keep[rows])):
                    faults.append(f"point {first} call {i}: a group routed "
                                  "alike queues or drops otherwise")
    return {"route_choices": counts["all"][1],
            "route_choices_differing": counts["all"][0],
            **{"route_differing_share" + ("" if k == "all" else "_" + k):
               n / max(t, 1) for k, (n, t) in counts.items()},
            "route_differing_share_by_layer": [n / max(t, 1)
                                               for n, t in layers],
            "route_groups_compared": compared,
            "routes_consistent": not faults, "route_faults": faults[:4]}


def sharded_gap(torch, L, SP, serve, ref: dict, model, params, mesh,
                routes=None, replay: bool = False) -> dict:
    """The sharded model (`params` on `mesh`) fed the unsharded greedy run
    `ref`'s prompt, stub embeddings (`ref["extra"]`, where it has them)
    and tokens (`serve.generate_sharded`, forced), against
    `ref`'s logits: each logit row's max and mean |d| and argmax
    agreement. Given the unsharded run's recorded `routes` (its last
    pass is the one compared): with `replay` every point routes as it
    did (`sharded_routes`), so the two differ only where the sharded
    sums round; without, every point routes on its own and its routing
    is held against the unsharded run's (`sharded_route_check`)."""
    from repro_torch.models.common import moe_layer_indices
    g = ref["tokens"].shape[1] - 1
    n_moe = len(moe_layer_indices(model.cfg))
    kept, restore = sharded_routes(L, SP, routes[-n_moe * (g + 1):],
                                   replay) if routes is not None \
        else ({}, None)
    try:
        tf = serve.generate_sharded(model, params, ref["prompt"], g,
                                    ref["cap"], mesh, forced=ref["tokens"],
                                    extra=ref.get("extra"))
    finally:
        if restore:
            restore()
    steps = []
    for i, (a, r) in enumerate(zip(tf["logits"], ref["logits"])):
        diff = (a.to(r.device) - r).abs()
        steps.append({"step": i, "max_abs": float(diff.max()),
                      "mean_abs": float(diff.mean()),
                      "argmax_equal": int((a.to(r.device).argmax(-1)
                                           == r.argmax(-1)).sum())})
    out = {"max_abs": max(x["max_abs"] for x in steps),
           "mean_abs": max(x["mean_abs"] for x in steps),
           "argmax_agreement": sum(x["argmax_equal"] for x in steps)
           / (ref["tokens"].shape[0] * len(steps)),
           "routes_replayed": routes is not None and replay,
           "forced_prefill_seconds": tf["prefill_seconds"],
           "forced_decode_ms_per_token": tf["decode_seconds"] / g * 1e3,
           "steps": steps}
    if routes is not None and not replay:
        out.update(sharded_route_check(torch, SP, kept, mesh, n_moe))
    return out


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
    flash backend) against the same model fed the same tokens (and the
    same stub embeddings, `res["extra"]`, where it has them) with dense
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
                            forced=res["tokens"], extra=res.get("extra"))
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


def full_forward_gap(torch, L, res) -> dict:
    """The greedy run `res` against the same model's full forward (no
    cache) over the prompt and the tokens fed after it: the prefill's
    logits and each decode step's against the full forward's at the same
    positions, each row's max and mean |d| and argmax agreement."""
    from repro_torch.models.model import Batch
    model, params, prompt = res["model"], res["params"], res["prompt"]
    b, s = prompt.shape
    g = res["tokens"].shape[1] - 1
    seq = torch.cat([prompt, res["tokens"][:, :g]], dim=1)
    pos = torch.arange(s + g, dtype=torch.int32,
                       device=seq.device)[None].expand(b, s + g)
    t0 = time.perf_counter()
    h, _, _ = model.backbone(params, model.embed_inputs(
        params, Batch(seq, None)), pos)
    full = model.hidden_to_logits(params, L.norm(
        h[:, s - 1:], params["ln_f"], model.cfg.norm))
    if seq.is_cuda:
        torch.cuda.synchronize(seq.device)
    seconds = time.perf_counter() - t0
    steps = []
    for i, a in enumerate(res["logits"]):
        diff = (a - full[:, i]).abs()
        steps.append({"step": i, "max_abs": float(diff.max()),
                      "mean_abs": float(diff.mean()),
                      "argmax_equal": int((a.argmax(-1) == full[:, i]
                                           .argmax(-1)).sum())})
    return {"max_abs": max(x["max_abs"] for x in steps),
            "mean_abs": max(x["mean_abs"] for x in steps),
            "argmax_agreement": sum(x["argmax_equal"] for x in steps)
            / (b * len(steps)),
            "full_forward_tokens": s + g, "full_forward_seconds": seconds,
            "steps": steps}


def spec_config(spec: dict):
    """The config a serve spec names: the registry's full or smoke config
    of its arch, cut to `spec["layers"]` layers where given."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_config if spec["config"] == "full" else get_smoke_config)(
        spec["arch"])
    if "layers" in spec:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    return cfg


def expected_launches(cfg, gen_tokens: int, runs: int) -> dict:
    """K8's launches in `runs` passes of `serve.generate`: one a
    self-attention layer per prefill call and per decode step; whisper
    adds its cross-attention layers to both, and its encoder layers twice
    to the prefill (the prefill encodes, and `generate` encodes once more
    for the decode steps)."""
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)) \
        if cfg.attn is not None else 0
    cross = cfg.n_layers if cfg.n_enc_layers else 0
    return {"flash_prefill": (n_attn + cross + 2 * cfg.n_enc_layers) * runs,
            "flash_decode": (n_attn + cross) * gen_tokens * runs}


def serve_phase(torch, kb, sj, fa, path: str, spec: dict,
                tol: tuple) -> dict:
    """Path `path`: the model of `spec` at full width (its depth cut to
    `spec["layers"]` where given) through the serving launcher
    (`serve.serve_config`), K8's launches counted and checked
    (`expected_launches`, K1-K7 none),
    then the check within `tol` (max |d|, mean |d|): against dense
    attention, teacher-forced, for a model with attention; against the
    full forward for one without (`full_forward_gap`). Then a profile.
    For a MoE model the routing choices are recorded in both runs and the
    share that differs is reported. Returns the path's launch counts."""
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.model import Batch
    torch.cuda.empty_cache()
    cfg = spec_config(spec)
    moe = cfg.moe is not None
    routes, restore = record_routes(L) if moe else (None, None)
    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = serve.serve_config(cfg, spec["batch"], spec["prompt_len"],
                                 spec["gen_tokens"], torch.device("cuda"))
    finally:
        if restore:
            restore()
    seconds = time.perf_counter() - t0
    counts = read()                   # just after
    peak = torch.cuda.max_memory_allocated()

    model, params, prompt = res["model"], res["params"], res["prompt"]
    extra = res["extra"]
    b, s, g = spec["batch"], spec["prompt_len"], spec["gen_tokens"]
    prefix = serve.prefix_len(cfg, extra)
    want = expected_launches(cfg, g, len(res["passes"]))
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
    n_params = cfg.param_count()
    published = spec_config({k: v for k, v in spec.items()
                             if k != "layers"}).n_layers
    emit({"phase": "serve", "path": path, "arch": spec["arch"],
          "config": cfg.name, "layers": cfg.n_layers,
          "published_layers": published, "params": n_params, "batch": b,
          "prompt_len": s, "gen_tokens": g, "prefix_positions": prefix,
          "encoder_positions": cfg.enc_seq_len if cfg.n_enc_layers else 0,
          "cap": res["cap"], "passes_seconds": res["passes"],
          "seconds": seconds, "prefill_seconds": t_pre,
          "prefill_tok_s": b * s / t_pre,
          "decode_ms_per_token": t_dec / g * 1e3,
          "decode_tok_s": b * g / t_dec, "peak_memory_bytes": peak,
          "param_bytes": n_params * res["params"]["embed"].element_size(),
          "cache_bytes": serve.cache_bytes(model.init_cache(
              b, res["cap"], "meta")),
          "launches": counts, "launches_expected": want,
          "sample": res["tokens"][0, :12].tolist()})

    if cfg.attn is None:
        # no attention: the check is decode against the full forward
        gap = full_forward_gap(torch, L, res)
        emit({"phase": "serve", "path": path,
              "check": "decode vs full forward", "tol_max_abs": tol[0],
              "tol_mean_abs": tol[1], **gap})
        what = "decode vs full forward"
    else:
        # the check: the greedy tokens through dense attention; a MoE
        # model's dense run takes the flash run's routing choices (a
        # flipped choice is a discrete jump, not attention's rounding),
        # after a run that routes on its own, reported only, for the share
        # of choices that flip
        if moe:
            free = teacher_forced_gap(torch, L, fa, serve, res, routes)
            free.pop("steps")
            emit({"phase": "serve", "path": path,
                  "check": "teacher-forced vs auto, own routing (reported)",
                  **free})
        gap = teacher_forced_gap(torch, L, fa, serve, res, routes,
                                 replay=moe)
        emit({"phase": "serve", "path": path,
              "check": "teacher-forced vs auto", "tol_max_abs": tol[0],
              "tol_mean_abs": tol[1], **gap})
        what = "flash vs auto"
    for x in gap["steps"]:
        check(x["max_abs"] <= tol[0] and x["mean_abs"] <= tol[1],
              f"{path} step {x['step']}: {what} logits differ by "
              f"{x['max_abs']} (mean {x['mean_abs']})")
    # the peak since the serve call began, the checks' runs included
    peak_all = torch.cuda.max_memory_allocated()
    emit({"phase": "serve", "path": path, "peak_memory_bytes_with_check":
          peak_all})

    # one prefill and one decode step under the profiler, uncounted
    cap = res["cap"]
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(
            params, Batch(prompt, prompt, extra), cap=cap)

    enc_out = model.encode(params, extra) if cfg.n_enc_layers else None

    def decode():
        tok = state["logits"][:, -1].argmax(-1)[:, None]
        model.decode_step(params, tok, state["caches"], prefix + s, enc_out)
    for step, fn in (("prefill", prefill), ("decode", decode)):
        emit({"phase": "profile", "path": path, "step": step,
              **device_profile(torch, fn)})
    return counts


def record_k8_shapes(L) -> tuple:
    """Count the layer library's K8 calls by (Sq, Skv, H, KVH) until
    `restore()` is called: (the counter, restore)."""
    seen = collections.Counter()
    lock = threading.Lock()
    orig = L.flash_attention

    def counted(q, k, *args, **kw):
        with lock:
            seen[(q.shape[1], k.shape[1], q.shape[2], k.shape[2])] += 1
        return orig(q, k, *args, **kw)
    L.flash_attention = counted

    def restore():
        L.flash_attention = orig
    return seen, restore


def serve_sharded_phase(torch, kb, sj, fa, dev, smi: str, path: str,
                        spec: dict, tol: tuple) -> dict:
    """Path `path` (phases 11d-11m, `SERVE_SHARDED_PATHS`): the model of
    `spec` through `serve.serve_config(..., mesh=...)` on a mesh of
    points of the card, its launches and collectives counted (K8's calls
    by shape, held to `spec["k8_shapes"]` and `spmd.COMM` to
    `spmd.serve_comm` where the spec has them, and `spmd.COMM` to
    `collectives.count_serve`, one point's pass counted on "meta", times
    the points and passes), each point's parameter
    and cache bytes held to the specs' shares, then the check against the
    same model unsharded (`sharded_gap`) within `tol` (max |d|, mean |d|,
    and for a MoE the most of its routing choices that may differ on its
    own routing). Returns the path's launch counts."""
    from repro_torch.launch import collectives, serve
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import make_test_mesh, set_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.common import abstract_params
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd as SP
    cfg = spec_config(spec)
    moe = cfg.moe is not None
    max_abs, mean_abs, route_share = tol
    b, s, g = spec["batch"], spec["prompt_len"], spec["gen_tokens"]
    shape = spec["mesh"]
    mesh = make_test_mesh(shape, devices=[dev] * math.prod(shape))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the unsharded run (outside the path's window) under the mesh's
    # abstract twin, so both runs route in the same token groups
    routes, restore = record_routes(L) if moe else (None, None)
    t0 = time.perf_counter()
    try:
        with set_mesh(make_test_mesh(shape)):
            ref = serve.serve_config(cfg, b, s, g, dev)
    finally:
        if restore:
            restore()
    unsharded = {"seconds": time.perf_counter() - t0,
                 "prefill_seconds": ref["prefill_seconds"],
                 "decode_ms_per_token": ref["decode_seconds"] / g * 1e3,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    ref = {k: ref[k] for k in ("tokens", "logits", "prompt", "extra", "cap")}
    torch.cuda.empty_cache()

    read = launch_window(kb, sj, fa)  # the path's counts start at 0 here
    SP.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    shapes, restore = record_k8_shapes(L)
    t0 = time.perf_counter()
    try:
        res = serve.serve_config(cfg, b, s, g, dev, mesh=mesh)
    finally:
        restore()
    seconds = time.perf_counter() - t0
    counts = read()                   # just after
    comm = dict(SP.COMM)
    # one point's pass counted on "meta", times the points and passes
    t0 = time.perf_counter()
    one = collectives.count_serve(cfg, mesh, b, s, g, res["cap"],
                                  res["fsdp"])
    count_seconds = time.perf_counter() - t0
    counted = {k: one[k] * mesh.size * len(res["passes"]) for k in SP.COMM}
    check(comm == counted, f"{path}: collectives {comm}, the count of one "
          f"point on meta {counted}")
    k8_shapes = [{"Sq": sq, "Skv": skv, "H": h, "KVH": kvh, "calls": n}
                 for (sq, skv, h, kvh), n in sorted(shapes.items())]
    if "k8_shapes" in spec:
        n_attn = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.n_layers))
        runs = len(res["passes"]) * mesh.size * n_attn
        want_shapes = {spec["k8_shapes"][k]: n for k, n in (
            ("prefill", runs), ("decode", runs * g))
            if k in spec["k8_shapes"]}
        got_shapes = collections.Counter()
        for (sq, skv, _, _), n in shapes.items():
            got_shapes[(sq, skv)] += n
        check(dict(got_shapes) == want_shapes,
              f"{path}: K8 ran at (Sq, Skv) {dict(got_shapes)}, expected "
              f"{want_shapes}")
        want_comm = SP.serve_comm(cfg, mesh, b, s, g, res["cap"],
                                  len(res["passes"]))
        check(comm == want_comm, f"{path}: collectives {comm}, the "
              f"formula {want_comm}")
    peak = torch.cuda.max_memory_allocated()
    one = expected_launches(cfg, g, len(res["passes"]))
    want = {k: n * mesh.size for k, n in one.items()}
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"{path} launched {name} {n} times, expected "
              f"{want.get(name, 0)}")
    specs = S.param_specs(cfg, mesh, fsdp=res["fsdp"])
    per_point = local_bytes(abstract_params(cfg), specs, mesh)
    held = [SP.tree_local_bytes(res["params"], p) for p in range(mesh.size)]
    check(held == [per_point] * mesh.size,
          f"{path}: points hold {held} parameter bytes, the specs "
          f"{per_point} each")
    whole = res["model"].init_cache(b, res["cap"], "meta")
    cache_share = local_bytes(whole, S.cache_spec(cfg, mesh, b), mesh)
    # where `cache_spec` keeps a cache whole that the port splits by its
    # slots (MLA's sequence split on a model axis that divides neither r
    # nor dr), a point holds its share of the slots
    cache_held = serve.cache_bytes(whole) // spec["cache_slot_ways"] \
        if "cache_slot_ways" in spec else cache_share
    row = res["device_bytes"][str(dev)]
    check(row["caches"] == cache_held * mesh.size,
          f"{path}: caches {row['caches']} bytes, {cache_held} a point "
          f"expected (cache_spec's share {cache_share})")
    vocab = cfg.vocab_size
    check(tuple(res["tokens"].shape) == (b, g + 1)
          and int(res["tokens"].min()) >= 0
          and int(res["tokens"].max()) < vocab, f"{path}: bad tokens")
    for lg in res["logits"]:
        check(tuple(lg.shape) == (b, vocab)
              and bool(torch.isfinite(lg).all()), f"{path}: bad logits")
    t_pre, t_dec = res["prefill_seconds"], res["decode_seconds"]
    published = spec_config({k: v for k, v in spec.items()
                             if k != "layers"}).n_layers
    emit({"phase": "serve", "path": path, "arch": spec["arch"],
          "config": cfg.name, "layers": cfg.n_layers,
          "published_layers": published, "params": cfg.param_count(),
          "mesh": list(shape), "axes": list(mesh.axis_names),
          "devices": [str(d) for d in mesh.devices], "fsdp": res["fsdp"],
          "batch": b, "prompt_len": s, "gen_tokens": g,
          "prefix_positions": serve.prefix_len(cfg, res["extra"]),
          "cap": res["cap"], "card": smi,
          "passes_seconds": res["passes"], "seconds": seconds,
          "prefill_seconds": t_pre, "prefill_tok_s": b * s / t_pre,
          "decode_ms_per_token": t_dec / g * 1e3,
          "decode_tok_s": b * g / t_dec, "peak_memory_bytes": peak,
          "param_bytes_per_point": per_point,
          "cache_bytes_per_point": cache_share,
          "cache_bytes_held_per_point": cache_held,
          "cache_bytes_whole": serve.cache_bytes(whole),
          "k8_shapes": k8_shapes,
          "device_bytes": res["device_bytes"], "collectives": comm,
          "collectives_counted": counted,
          "collectives_count_seconds": count_seconds,
          "launches": counts, "launches_expected": want,
          "greedy_tokens_equal_unsharded": float(
              (res["tokens"] == ref["tokens"]).float().mean()),
          "unsharded": unsharded, "sample": res["tokens"][0, :12].tolist()})

    # the check: the sharded model fed the unsharded run's tokens. A MoE
    # first routes on its own (its logits reported: a flipped choice is a
    # discrete jump; its routing held to the unsharded run's), then takes
    # the unsharded run's routing choices (its logits gated)
    if moe:
        free = sharded_gap(torch, L, SP, serve, ref, res["model"],
                           res["params"], mesh, routes)
        free.pop("steps")
        emit({"phase": "serve", "path": path,
              "check": "sharded vs unsharded, own routing",
              "tol_route_differing_share": route_share, **free})
        check(free["routes_consistent"],
              f"{path}: the sharded routing is not the unsharded run's: "
              f"{free['route_faults']}")
        check(free["route_differing_share"] <= route_share,
              f"{path}: {free['route_differing_share']} of the sharded "
              f"run's routing choices differ from the unsharded run's")
    gap = sharded_gap(torch, L, SP, serve, ref, res["model"], res["params"],
                      mesh, routes, replay=moe)
    emit({"phase": "serve", "path": path, "check": "sharded vs unsharded",
          "tol_max_abs": max_abs, "tol_mean_abs": mean_abs, **gap})
    for x in gap["steps"]:
        check(x["max_abs"] <= max_abs and x["mean_abs"] <= mean_abs,
              f"{path} step {x['step']}: sharded logits differ from the "
              f"unsharded run's by {x['max_abs']} (mean {x['mean_abs']})")
    emit({"phase": "serve", "path": path, "peak_memory_bytes_with_check":
          torch.cuda.max_memory_allocated()})
    del res, ref, routes
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the slice phase")
    ap.add_argument("--phase", choices=("all", "kernels", "train-sharded"),
                    default="all",
                    help="kernels: phases 1-4 only; train-sharded: that "
                         "path only (no kernel is built); either with no "
                         "kernel table and no ok line")
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

    if args.phase == "train-sharded":
        train_sharded_phase(torch, np, kb, sj, fa, dev, smi)
        return 0
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
    cuda_runs, counts, oracle = slice_phase(torch, kb, sj, fa, cat, args.sf)
    counts["kernel-api"] = kernel_api_phase(torch, np, kb, sj, fa, bloom,
                                            dev, api)
    counts["serve-tpch"] = serve_tpch_phase(torch, kb, sj, fa, cat, args.sf,
                                            oracle)
    counts["curation"] = curation_phase(torch, np, kb, sj, fa)
    counts["dist-api"] = dist_api_phase(torch, np, kb, sj, fa, bloom, dev,
                                        api)
    counts["dist-pod"] = dist_pod_phase(torch, np, kb, sj, fa, bloom, dev,
                                        api, smi)
    counts["dist-exchange"] = dist_exchange_phase(torch, np, kb, sj, fa,
                                                  dev, api)
    counts["dist-tpch"] = dist_tpch_phase(torch, kb, sj, fa, cat, args.sf,
                                          oracle)
    counts["torch-tpch"] = torch_tpch_phase(torch, np, kb, sj, fa, dev, cat,
                                            args.sf, oracle, cuda_runs, api)
    del cat, api, cuda_runs
    arep, aworst = attention_phase(torch, fa, dev,
                                   info.get("flashattn", (0.0, ""))[1])
    rep.update(arep)
    worst.update(aworst)
    lse_phase(torch, fa, dev)
    for path, (spec, tol) in SERVE_PATHS.items():
        counts[path] = serve_phase(torch, kb, sj, fa, path, spec, tol)
    for path, (spec, tol) in SERVE_SHARDED_PATHS.items():
        counts[path] = serve_sharded_phase(torch, kb, sj, fa, dev, smi, path,
                                           spec, tol)
    counts["launch-reports"] = launch_reports_phase(torch, kb, sj, fa, dev,
                                                    smi)
    counts["train"] = train_phase(torch, np, kb, sj, fa)
    counts["train-ft"] = train_ft_phase(torch, np, kb, sj, fa)
    counts["train-sharded"] = train_sharded_phase(torch, np, kb, sj, fa, dev,
                                                  smi)

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
        "flash_prefill_d64": (flash_cu,
                              "src/repro/kernels/flashattn/flashattn.py:79",
                              "serve-whisper"),
        "flash_decode_d64": (flash_cu,
                             "src/repro/kernels/flashattn/flashattn.py:79",
                             "serve-whisper"),
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

#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # all phases, one CUDA card

1. device and build: the card's name and power limit; every CUDA kernel
   built from ``src/repro_torch/kernels/csrc`` with nvcc (timed);
2. kernels against their plain PyTorch versions on the card: both
   ``fused_knn`` grids at W=256, TQ=64, D=64, k=10, TV in {32..4096}, ip and
   l2, f32 and bf16, valid density 0.7; D 768 (f32, ip and l2); ``n_live``
   of 0, 1, ragged and every slot at TV 128 and 1024 (slots past it
   (NEG_INF, -1)); the PQ re-rank's units of one query [16384, 1, 40] with a
   padding tail; plus all-invalid and k above the valid count; bit-equal to
   the plain version in f32 and bf16 (its scores are the kernels' fmaf
   chains, ``ref.kernel_order_scores``); kernel, plain version and the
   yardstick (``torch.matmul`` + masked ``torch.topk``) timed with CUDA
   events (median of 25; the plain version, a loop over D in fp64, of 3)
   beside each shape's bound;
3. the main path at real size: ``kg_style(n=1_000_000, d=64,
   queries_per_split=10_000)``, ``HQIIndex.build`` on the card, then
   ``search(nprobe=8)`` (once cold, three times warm); the kernels' launch
   counters are zeroed just before the last warm search and read just after
   it, and both must be > 0 while the plain version's call count stays 0
   (the ``launches`` of the kernels line are per search). Every returned id must pass its
   query's filter with its exact score; recall@10 against the port's
   ``exhaustive_search``; one more search with the tracer on and one under
   ``torch.profiler`` split the time (and must show no
   ``merge_partials_kernel``: a split dispatch is one launch). Then each
   kernel is checked on every bucket the main path gave it, with the live
   slots the engine passes, and timed there (one wrapper call by CUDA
   events, and the launch alone from the profiler) beside its bound and
   real slots, with the sums over the buckets; plain and yardstick on the
   heaviest. Then one search under ``enable_profiler()`` with the h100
   roofline terms: answers equal to the profiler-off search, coverage 1.0,
   per (phase, mode) totals, no ``frac_hbm`` or ``frac_peak`` above 1.05;
   and the search at k = 100 (the f32 kernels in passes of 64): counters
   zeroed and read around one warm search, ids passing their filters with
   exact scores, recall@100 against ``exhaustive_search``, queries/s;
(S4) the sharded engine on phase 3's index: ``HQIConfig.mesh`` set to four
   ranks of the model axis on the one card (``make_test_mesh((4,),
   ("model",), device="cuda")``); the f32 search and, with a codebook
   attached (``pq_m`` 8), the PQ search at ``refine_factor=4`` (segmented),
   each on ``mesh=None`` and on the mesh, interleaved, once cold and three
   times warm, then traced once: bit-equal answers (scores and ids), queries/s of both (warm median),
   counters zeroed and read around the last warm search of each (kernels
   1-2, or kernel 3 and the re-rank, launch; no plain version; the same
   launches and dispatches on both sides, so the same launches per bucket),
   peak device memory of each; ``ShardStats`` against the reference's
   assertions (ranks' units sum to the single plan's, their bytes to the
   single scan's, ``gathered_per_query`` 4·k, and 4·(k′ + k) for PQ); one
   sharded search under the profiler (coverage 1.0, four rank rows); the
   dense merge layout at R 2 on 1,000 queries bit-equal to the segmented
   one (f32 and PQ); 1,000 queries of stream A through ``HQIService`` on the
   mesh index against ``mesh=None`` (``agree_untied``, and whether
   bit-equal); where more than one card is visible, the f32 search on
   ``make_production_mesh()`` (else a line says it did not run);
(S1) the online service at real size on phase 3's index (then dropped):
   ``attach_pq`` a codebook trained on the card (``pq_m`` 8), then
   ``HQIService(k=10, nprobe=8, max_batch=256, deadline_s=0.005)``. Stream
   A (split 1's 10,000 queries, a flush whenever a micro-batch is full);
   32,768 inserts near seeded-random rows (+0.01 noise, their columns) and
   16,384 + 3,277 deletes, so the live delta (29,491) passes the PQ
   threshold of 4096 (buffer TV 32,768); stream B (the delta's ADC scan,
   kernel 4, on every flush); ``refresh()`` (timed; partitions, arena rows
   and encoded rows counted); stream C; a burst of 8,192 queries
   submitted at once with ``overload_queue_depth=4096`` (its first flushes
   shed to the PQ engine, kernel 3, then it recovers). Launch counters are
   zeroed and read around each stream: kernels 1-2 in every stream, kernel
   4 in B only, kernel 3 in the burst, every plain version 0. Every answer
   live, passing its filter, with its exact score (1e-4); A and C equal
   the offline ``index.search`` (1e-4, equal id sets but at ties);
   recall@10 on 1,000 queries against ``exhaustive_search`` over
   ``snapshot_db()``. Queries/s, p50/p99 submit->answer latency per stream,
   insert/delete/refresh seconds, a profiled stream-B flush, and kernel 4
   at each of stream B's shapes (bit-equal to its plain version; a call and
   the launch alone beside its bound); then the flight recorder on that
   service: ``service.flush`` armed once gives exactly one incident bundle
   that ``validate_incident_bundle`` accepts;
(S3) durability and index evolution on the same index as S1 leaves it
   (codebook attached, delta folded), the store in a temporary directory
   under ``--out`` (deleted at the end): ``init_store`` (snapshot seconds
   and bytes); 256 insert batches of 128 rows near seeded-random base rows
   (+0.01 noise, their columns) and 64 delete batches of 64 ids (2,048 base,
   2,048 new) through the WAL with ``sync=True`` (acknowledged rows/s,
   delete seconds, records, fsyncs), the live delta past the PQ threshold;
   1,000 queries of split 1 (answers P: every id live, passing its filter,
   with its exact score; kernels 1, 2 and 4 launch, no plain version); a
   crash (WAL closed, service dropped, CUDA cache emptied) and
   ``open_service`` on the card (snapshot load with its host->device copy
   and WAL replay timed apart): ``live_ids()`` as before, P again (ids
   equal, scores within 1e-4); ``Compactor.compact_once(force=True)``
   (seconds, flush-lock hold and the capture inside it, generation bytes,
   segments pruned) and a reopen that replays 0 records and answers as the
   compacted service; 2,000 queries of split 3, then ``Tuner.tune_once``
   (forced if the shift is below its threshold) while another thread
   submits 1,000 queries (every one answered), build and swap seconds,
   the checks and recall@10 after the swap, ``CURRENT`` on the new
   generation, ``rollback()`` answering as before the swap; and
   ``python -m repro_torch.fault.chaos --smoke --device cuda`` (its child
   writer on the card too): ``ok``, acknowledged ids from the killed writer,
   at least one recovery check, nothing hung, no parity or recovery fault;
4. card against CPU: a 100k-row index built on the card, reloaded from its
   ``to_state()`` on the CPU; both searches must agree (scores within
   1e-4, equal id sets per query), and at k = 100 (id sets equal but at
   ties at the cut), and 256 queries through a service at
   ``ServiceConfig(k=100)`` on each side;
(S2) the service on that index (codebook attached) and on its CPU reload:
   streams A, B (8,192 inserts, 819 + 819 deletes: the PQ delta path on
   both sides), C after ``refresh()`` and a burst past depth 512; every
   stream's answers agree (1e-4, equal id sets); the card's service writes
   through a store (``init_store``), compacted after the burst and given a
   WAL tail, which ``open_service(device="cpu")`` opens: its answers to
   stream C's queries agree with the card's;
5. ADC kernels against their plain versions on the card:
   ``workunit_pq_scan_streamed`` (a [4096, M, 256] resident table read
   through random ``lut_idx``, an eighth of each unit's slots padding at row
   0) and ``workunit_pq_scan`` (the same LUTs expanded, ragged ``n_live``:
   bit-equal to its plain version) at W=256, TQ=64, M in {8, 16}, TV in
   {32..4096}, k in {10, 40}, valid density 0.7;
   plus all-invalid, k above the valid count and 2 valid rows of 1024 at
   k=4 (unfilled slots (NEG_INF, -1)); scores within 1e-4, ids equal where
   untied; kernel, plain version and the yardstick (``torch.gather`` + sum
   + masked ``torch.topk``) timed beside each shape's bound. Then
   ``workunit_pq_scan`` bit-equal at a delta-store shape [16, 128, 32768,
   M 8, k′ 40] (16 MiB of LUTs, rows split over blocks, one launch) and at
   M 181, each beside its bound, plain version and yardstick. Then the
   LUT-stationary kernels, bit-equal to their plain versions: the units
   kernel at the engine's heaviest bucket shape [16384, 64, 64, 8, 40] with
   a quarter of the slots real (the rest -1), the same with every real slot
   on one row, every slot -1, and k′ 64 at TV 4096, each beside its bound,
   plain version, yardstick, work-list time and staged LUT bytes;
   ``pq_scan`` at NV in {10^4, 10^5, 10^6}, M=8, k=40, with its kernel's
   own time from the profiler; then both LUT-stationary kernels at M in
   {8, 110, 128, 190} (past 109 the LUT row passes in slices): the units
   kernel at [4096, 64, 64, M, 40] with a quarter of the slots real and
   ``pq_scan`` at NV 10^5, bit-equal, each beside its bound (a call and the
   launch alone) and its plain version. Then the five scan kernels at k′ in
   {65, 80, 128, 400} (and 64): ceil(k′ / 64) launches a call, every one
   bit-equal, each call timed with its passes; and ``adc_wide_m_kernel`` (a
   LUT row's slices staged once for a tile of rows) through all three
   wrappers at M in {191, 256, 384, 768}, bit-equal, a call and the launch
   alone beside its bytes bound, its lookup bound and its plain version;
6. the compressed (PQ) path at real size: the same data and workload,
   ``HQIConfig(scan_mode="pq")`` built on the card, ``search(nprobe=8)``
   once cold and three times warm; counters zeroed before the last search:
   the resident-LUT ADC kernel and the re-rank grid must launch, every plain
   version's count must stay 0 and no LUT may be expanded
   (``lut_expand_bytes``). Ids pass their filters with exact f32 scores;
   recall@10 against the exhaustive answer and against the f32 engine; a
   traced and a profiled search; then the ADC kernel checked bit for bit on
   every bucket the path gave it (real slots, staged LUT bytes, time and
   bound per bucket, and their sums) and timed on the heaviest; and the
   exact re-rank's one dispatch at its real shape (stage A run as the
   search runs it) checked and timed; a profiled search as in phase 3; and
   the search at ``refine_factor=8`` (k′ 80): counters, checks, recall@10,
   queries/s;
7. PQ card against CPU at 100k rows: segmented and dense layouts (the dense
   one drives ``workunit_pq_scan`` with the engine's ``n_live``; a profiled
   dense search must show ``adc_slot_warps_kernel`` and no
   ``merge_partials_kernel``) and a ``PQIndex`` with 64 queries and
   ``rerank=4`` (``pq_scan``), each against its CPU reload; every dense
   bucket checked bit for bit and timed beside its bound; on the heaviest,
   the LUT-stationary units kernel serving the same bucket (the expanded
   LUTs as a table of W·TQ rows, -1 on the dead slots: the design the dense
   layout did not take) must give the same lists, and is timed; and a
   20k-row index of d 256 at ``pq_m`` 128 (the LUT-stationary kernels'
   sliced rows): a segmented PQ search (kernel 3) and a ``PQIndex.search``
   (kernel 5) on the card, each equal to its CPU reload (the search's id
   sets but at ties at the k-th score: its exact re-rank sums 256-wide
   products in another order on each side); the 100k segmented search also
   at ``refine_factor=8``. Then the wide-M kernel's path: a 20k-row index of
   d 768 at ``pq_m`` 192 (its counters zeroed and read around the segmented
   search: the kernels line's launches), the dense layout and a
   ``PQIndex`` of 64 queries, each equal to its CPU reload; the kernel on
   every bucket of that search, the heaviest timed;
8. ``flash_attention`` against its plain version on the card: gemma3 heads
   (32/16, dh 128, bf16, batch 1) at S in {1024, 4096, 32768} x window in
   {0, 1024}, minicpm (36/36, dh 64) and qwen3 (64/8, dh 128) heads at
   4096, small bf16 shapes (zamba2's dh 80, a dh of 36 that the wrapper
   pads to 40, a GQA group of 8 on one KV head) and small f32 shapes
   (ragged S, not causal, a window below the 64-key tile, S < T); within
   ``ATTN_TOL``: rtol 2e-2, atol 2e-3 and a relative error
   (||got - want|| / ||want||) of 1e-2 in bf16, 1e-4, 1e-4 and 5e-5 in
   f32 (the 3xTF32 kernel: hi/lo TF32 products, sums in another order). The bf16 kernel
   rounds P to bf16 before P·V (up to 2^-9 of each p, ~1e-3 of |o|) and
   adds P's bf16 remainder on tiles whose rows have few effective keys,
   where one rounding could move a near-zero output past atol; the outputs'
   own bf16 rounding (one ulp, at most 2^-7 of |o|) is the rest, which rtol
   covers. Every case also runs the training forward (``return_lse=True``):
   its output bit-equal to the serving call's, its lse within ``LSE_TOL`` of
   the plain version's. Then the wide kernels (bf16 up to 512 on wgmma,
   else the sliced CUDA-core kernel; O in column slices) at dh in {288,
   512, 1024}, S = T = 2048, 8/4 heads, causal, window 0 and 1024, bf16
   and f32, and their
   path: the reduced gemma3 at head width 512 served on the card (one wide
   launch per prefill layer) and the CPU (the same tokens, logits within
   2e-3). Kernel, plain
   version and ``scaled_dot_product_attention``
   (``enable_gqa``, the library yardstick) timed with CUDA events (median
   of 10; 3 at 32k) beside the bound: q, k, v, o bytes once over HBM, or
   4·dh operations per kept (query, key) pair and query head over the bf16
   tensor-core (or f32) peak; each row also gives TFLOP/s and the bound's
   share of the kernel's time;
9. the LM serving path at full width: gemma3-27b (d 5376, 32/16 heads, dh
   128, d_ff 21504, vocab 262144, 1024-token windows on five layers of six)
   in bf16, depth cut 62 -> 12, random weights from a seeded generator on
   the card; ``SlotServer`` with 4 slots serves 8 requests of 1100-4096
   tokens (numpy seed 0), 16 new tokens each. Counters are zeroed before
   the run and read after it: the kernel must launch once per prefill layer
   (8 x 12) and the plain version never. Prefill and decode tokens/s, peak
   memory, a profiled prefill and a profiled decode step; then the first
   request layer by layer, each layer's kernel output held against the
   plain version on that layer's own q/k/v (``ATTN_TOL``; the training
   forward's output bit-equal to it, its lse within ``LSE_TOL``), ending in
   the token the server gave;
10. the reduced gemma3 in f32 with the same weights on the card and the CPU:
   prefill and decode logits within 2e-3, the served tokens equal, one
   kernel launch per prefill layer on the card;
T. training: (a) the attention backward kernels
   (``csrc/flash_attention_bwd.cu``) on the training forward's o and lse
   against their plain version on the card: minicpm heads [2, 2048, 36/36,
   dh 64] causal in bf16 (the wgmma pair) and f32 (the 3xTF32 pair, and
   beside it the f32 forward kernel on the same inputs, then again at [1,
   2048, 8/4, dh 256] and [1, 16384, 4/4, dh 64], each within ``ATTN_TOL``
   and ``LSE_TOL``, with its library time and bound), gemma3 heads [1,
   4096, 32/16, dh 128] at window 0 and 1024 in bf16, [1, 2048, 8/4, dh
   256] causal in bf16 (the split wgmma pair) and f32 (the 3xTF32 pair),
   [1, 2048, 8/4, dh 512] causal in bf16 (the split wgmma pair) and f32
   (the wide pair), f32 [1, 16384, 4/4, dh 64] causal, and
   ``BWD_SMALL`` (ragged S, not causal, a window below the tile, a GQA group
   of 8, dh 16, S < T, S > T with rows that keep no key, dh
   64/128/200/320/520) in f32, five also in bf16 (dh 520: the wide pair); each of
   dq, dk, dv within ``BWD_TOL`` (relative error 2e-2 in bf16, 1e-4 in
   f32); kernels, plain version and the library's backward
   (``torch.autograd.grad`` through ``scaled_dot_product_attention``) timed
   beside the bound (10·dh operations a kept pair and query head at the
   input type's peak; in f32 the lesser of the fp32 peak and three TF32
   passes), and at the seven large shapes the two launches alone by the
   profiler. (b) minicpm-2b at full width, all 40 layers, f32
   masters, bf16 compute, remat; AdamW on its WSD schedule; ``SyntheticLM``
   4 x 2048 in 2 microbatches, 20 steps through ``TrainLoop(...,
   device="cuda")``: the loss falls; counters zeroed and read around the
   last step (forward kernel 2 x 40 x 2 launches, backward 40 x 2, no plain
   call); tokens/s (median step), peak memory, one step under the profiler
   (busy share, the backward kernels' share); ``lm_hidden_embed`` on 65,536
   sequences of 16 tokens with the trained weights (entities/s, finite).
   (c) the reduced minicpm in f32 with the same weights and batches on the
   card and the CPU: gradients, 3 steps' losses and parameters within 1e-4;
   then a ``TrainLoop`` run 10 steps, checkpointed, dropped, restored and
   run 10 more against an uninterrupted 20 (bit for bit, else the record
   says by how much);
11. the ``kernels`` JSON line (all nine kernels; each with its launches in
   S1's streams, S3's first stream and S4's sharded searches), the
   ``nvidia-smi`` line,
   and last the result line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line. It writes its full record (and nvcc's log) under ``--out``
(default ``smoke_out/``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# one 4-byte shared-memory read a bank a clock: 32 banks, 132 SMs, 1.98 GHz boost
SMEM_LOOKUPS_PER_S = 32 * 132 * 1.98e9
FP32_FLOPS_PER_S = 67e12  # H100 SXM, CUDA cores (no tensor cores)
# H100 SXM, dense TF32 tensor cores: f32 work at f32 accuracy takes three TF32
# passes (hi·hi + hi·lo + lo·hi), so an f32 product's floor is the lesser of
# the fp32 peak and three passes at this rate (165 TFLOP/s of f32 work)
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
MAIN_ROWS, MAIN_QUERIES = 1_000_000, 10_000  # the main path's kg_style size
# the online service's writes on that index (S1): rows inserted, base rows
# and inserted rows deleted (a tenth), the burst (the default queue bound)
# and the queue depth it sheds at, the recall subsample
SERVICE_INSERTS, SERVICE_BASE_DELETES, SERVICE_DELTA_DELETES = 32_768, 16_384, 3_277
SERVICE_BURST, SERVICE_SHED_DEPTH, SERVICE_RECALL_QUERIES = 8_192, 4_096, 1_000
# durability and evolution on that index (S3): insert batches x rows, delete
# batches x ids (half base, half new), the queries answered before and after
# the crash, the later-split queries streamed before the tune
STORE_INSERTS, STORE_DELETES, STORE_QUERIES, STORE_SHIFT_QUERIES = (256, 128), (64, 64), 1_000, 2_000
# the sharded engine on that index (S4): ranks on the one card, the queries
# of the dense-layout and service checks
SHARDED_RANKS, SHARDED_LAYOUT_QUERIES = 4, 1_000
# the LUT-stationary kernels past M 109 (the row in slices), M 8 beside them
WIDE_M = (8, 110, 128, 190)
KERNELS = ("fused_knn", "fused_knn_db_stationary", "workunit_pq_scan_streamed",
           "workunit_pq_scan", "pq_scan", "flash_attention", "adc_wide_m", "flash_attention_wide",
           "flash_attention_backward")
# the shapes the card once refused: k′ past the 64-entry lists (floor passes),
# M past the staged ADC kernels' 190 (adc_wide_m_kernel), dh past 256
# (flash_attention_wide); the engine's k and refine_factor for them
LIMIT_KPRIMES = (65, 80, 128, 400)
WIDE_MS = (191, 256, 384, 768)
WIDE_DHS = (288, 512, 1024)
ENGINE_K, ENGINE_REFINE = 100, 8
# the LM serving phase: gemma3-27b at full width, depth cut 62 -> 12 (two 5:1 cycles)
LM_LAYERS, LM_SLOTS, LM_NEW = 12, 4, 16
LM_PROMPTS = (1100, 1536, 2048, 2500, 3000, 3500, 4000, 4096)
# the training phase (T): minicpm-2b at full width, all 40 layers; global
# batch x sequence in microbatches (8,192 tokens a step), steps; then
# lm_hidden_embed on entities of a few tokens, in chunks of sequences
TRAIN_ARCH, TRAIN_LAYERS = "minicpm-2b", 40
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 20
EMBED_SEQS, EMBED_LEN, EMBED_CHUNK = 65_536, 16, 4_096
# the backward kernel's small shapes (b, s, t, hq, hkv, dh, causal, window),
# f32 (those in BWD_SMALL_BF16 in bf16 too); tests/test_torch_cuda.py runs them
BWD_SMALL = (
    ("f32-ragged", 2, 77, 77, 4, 2, 16, True, 0),
    ("f32-not-causal", 2, 50, 50, 4, 4, 16, False, 0),
    ("f32-window-below-tile", 1, 90, 90, 4, 2, 16, True, 7),
    ("f32-gqa8-one-kv-head", 1, 40, 40, 8, 1, 16, True, 0),
    ("f32-s-below-t", 1, 30, 60, 4, 2, 16, True, 0),
    ("f32-s-above-t-no-key-rows", 1, 90, 30, 4, 2, 16, False, 8),
    ("f32-dh64-window", 1, 300, 300, 4, 2, 64, True, 100),
    ("f32-dh128", 2, 200, 200, 4, 2, 128, True, 0),
    ("f32-dh200-two-slices", 1, 130, 130, 2, 1, 200, True, 0),
    ("f32-dh320-wide", 1, 130, 130, 4, 2, 320, True, 0),
    ("f32-dh520-wide", 1, 130, 130, 4, 2, 520, True, 0),
)
BWD_SMALL_BF16 = ("f32-ragged", "f32-dh128", "f32-dh200-two-slices", "f32-dh320-wide", "f32-dh520-wide")
SOURCE = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "fused_knn": "src/repro_torch/kernels/csrc/fused_knn.cu",
    "fused_knn_db_stationary": "src/repro_torch/kernels/csrc/fused_knn.cu",
    "workunit_pq_scan_streamed": "src/repro_torch/kernels/csrc/pq_scan.cu",
    "workunit_pq_scan": "src/repro_torch/kernels/csrc/pq_scan.cu",
    "pq_scan": "src/repro_torch/kernels/csrc/pq_scan.cu",
    "adc_wide_m": "src/repro_torch/kernels/csrc/pq_scan.cu",
    "flash_attention_wide": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_backward": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:84",
    "fused_knn": "src/repro/kernels/fused_knn.py:224",
    "fused_knn_db_stationary": "src/repro/kernels/fused_knn.py:165",
    "workunit_pq_scan_streamed": "src/repro/kernels/pq_scan.py:299",
    "workunit_pq_scan": "src/repro/kernels/pq_scan.py:180",
    "pq_scan": "src/repro/kernels/pq_scan.py:86",
    # past M 190 all three ADC wrappers take it; its path is the segmented PQ search (kernel 3)
    "adc_wide_m": "src/repro/kernels/pq_scan.py:299",
    "flash_attention_wide": "src/repro/kernels/flash_attention.py:84",
    # no Pallas backward: the reference differentiates its chunked online softmax
    "flash_attention_backward": "src/repro/models/attention.py:90",
}
# each kernel's design: the kernels line marks the redesigned ones
DESIGN = {
    "flash_attention": "redesigned: bf16 wgmma products fed by a TMA ring",
    "fused_knn": "redesigned: live slots and valid rows only, 4x4 register tiles, count-ranked keys",
    "fused_knn_db_stationary": "redesigned: rows split over blocks, the last block merges in the same launch",
    "workunit_pq_scan_streamed": "redesigned: LUT-stationary, slots sorted by LUT row, warp select",
    "workunit_pq_scan": "redesigned: a warp per live slot, codes shared through a cp.async ring, one launch",
    "pq_scan": "redesigned: LUT-stationary, one launch, last block merges",
    "adc_wide_m": "redesigned: a block owns a LUT row and a tile of rows, the row's slices staged once "
                  "by cp.async, sums carried in registers; M past 190 in all three wrappers",
    "flash_attention_wide": "redesigned: O in column slices, logits summed over dh in slices; bf16 to 512 "
                            "on wgmma + TMA, else register-tiled CUDA cores; dh past 256",
    "flash_attention_backward": "redesigned: lse from the training forward, no statistics sweep; dQ per query "
                                "tile, dK/dV per key tile over the GQA group, no atomics; bf16 to dh 128 on "
                                "wgmma fed by a TMA ring, 129-512 on wgmma with the two consumer warpgroups "
                                "splitting the products; f32 to 256 on the tensor cores in three TF32 passes "
                                "(mma.sync, hi/lo split, a cp.async ring); f32 past 256 and bf16 past "
                                "512 on CUDA cores with S and dP once a tile for up to 512 output columns, the "
                                "stationary rows staged once, the rest streamed by cp.async",
}
NEG_INF = -3.4e38
PROFILER_PAD = 64  # throwaway launches opening each device_ms trace
PROFILER_POST = 16  # throwaway launches queued behind the trace's device sleep
PROFILER_LEADS_MS = (20.0, 200.0, 2000.0)  # the device sleep ahead of the measured calls, by attempt
SLEEP_CYCLES_PER_MS = 2.0e6  # torch.cuda._sleep cycles a ms at 2 GHz, at or above the H100's SM clock
PROFILER_TRACES: list = []  # each device_ms trace: lead, pad launches lost before and after it, launches seen
# flash_attention kernel vs plain, by element size: (rtol, atol, limit on
# ||got - want|| / ||want||); in bf16, P's rounding (~1e-3 of |o|, with its
# remainder added where rows have few keys) and one ulp of the output (2^-7)
ATTN_TOL = {2: (2e-2, 2e-3, 1e-2), 4: (1e-4, 1e-4, 5e-5)}
# the training forward's lse vs the plain version's, by element size: atol
# (rtol 1e-5); both sum exp of the same f32 logits, the bf16 kernel in log2
# units with ex2.approx (~2^-22 a term) and log2f, converted back
LSE_TOL = {2: 2e-3, 4: 1e-4}
# flash_attention_backward vs plain, by element size: the limit on ||got -
# want|| / ||want|| of each of dq, dk and dv. Both sum in f32 from the same
# inputs; in f32 they differ in the order of the sums (over dh, keys,
# queries and the GQA group); in bf16 the tensor-core kernels also round P
# and dS to bf16 before their products (up to 2^-9 of each weight, ~1e-3 of
# a gradient's norm) and each output is rounded to bf16 once (2^-9)
BWD_TOL = {2: 2e-2, 4: 1e-4}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 10) -> float:
    """The device time (ms) of the one launch whose name holds ``kernel`` in
    each call of ``fn``, from ``torch.profiler`` (a call's own host time,
    which CUDA events around one small call also see, left out): the mean
    over the launches the trace holds.

    Once the process has run for a while, the profiler drops the device
    records at the start of every trace: those whose device timestamp falls
    before the trace's window opens, by an offset that grows with the
    process's age and differs from card to card. So each trace opens with
    ``PROFILER_PAD`` launches of a small ``bitwise_not`` kernel, then holds
    the card in a sleep of ``lead`` ms (``torch.cuda._sleep``) while the host
    queues ``PROFILER_POST`` ``logical_not`` launches and the calls behind it:
    their device timestamps lie ``lead`` ms past the window's opening. A
    trace holding fewer than half of ``reps`` is taken again with a ten
    times longer lead, three leads in all (``PROFILER_LEADS_MS``). Each
    trace's record (``PROFILER_TRACES``) keeps the lead, the pad launches
    lost before and after it, and the launches seen."""
    import torch

    for _ in range(3):
        fn()
    pad = torch.zeros(1024, dtype=torch.int32, device="cuda")
    post = torch.zeros(1024, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    seen = []
    for lead in PROFILER_LEADS_MS:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_PAD):
                pad.bitwise_not_()
            torch.cuda._sleep(int(lead * SLEEP_CYCLES_PER_MS))
            for _ in range(PROFILER_POST):
                post.logical_not_()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()

        def count(name):
            return sum(e.count for e in events if name in e.key and not e.key.startswith("aten::"))

        hits = [e for e in events if kernel in e.key]
        launches = sum(e.count for e in hits)
        PROFILER_TRACES.append({"kernel": kernel, "lead_ms": lead, "pad_lost": PROFILER_PAD - count("bitwise_not"),
                                "post_lost": PROFILER_POST - count("logical_not"), "launches": launches,
                                "reps": reps})
        if 2 * launches >= reps:
            return sum(e.device_time_total for e in hits) / launches / 1e3
        seen.append(launches)
    raise AssertionError(f"the profiler saw {seen} launches of {kernel} in three traces of {reps} calls "
                         f"behind leads of {PROFILER_LEADS_MS} ms: {PROFILER_TRACES[-3:]}")


def bound(q, v, valid, k: int, metric: str, q_live=None) -> tuple[float, str]:
    """Least time (ms) for the function on these inputs, counting only what
    this data needs. Bytes over HBM: the vectors of the real query slots
    (``q_live``, bool [W, TQ]; every slot by default) and of the valid rows
    read once, the mask of each unit holding a real query read once, the
    real slots' top-k written once. Operations over the fp32 peak: each
    unit's real queries against its valid rows (and the l2 norms). The larger
    of the two."""
    import torch

    W, TQ, D = q.shape
    TV = v.shape[1]
    if q_live is None:
        q_live = torch.ones((W, TQ), dtype=torch.bool, device=q.device)
    nq_w = q_live.sum(1).double()
    nv_w = valid.sum(1).double()
    n_q, n_v = float(nq_w.sum()), float(nv_w.sum())
    n_units = int((nq_w > 0).sum())
    nbytes = (n_q * D * q.element_size() + n_v * D * v.element_size()
              + n_units * TV * valid.element_size() + n_q * k * 8)
    flops = 2.0 * D * float((nq_w * nv_w).sum())
    if metric == "l2":
        flops += 2.0 * D * (n_q + n_v)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def yardstick(q, v, valid, k: int, metric: str):
    """``torch.matmul`` + masked ``torch.topk``: the library's way to the same
    top-k (tie order aside), timed beside the kernels and used nowhere else."""
    import torch

    qf, vf = q.float(), v.float()
    s = torch.matmul(qf, vf.transpose(1, 2))
    if metric == "l2":
        s = 2.0 * s - (qf * qf).sum(-1, keepdim=True) - (vf * vf).sum(-1)[:, None, :]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    return torch.topk(s, k, dim=-1)


def compare(got, want, tol: float) -> float:
    """Scores within rtol/atol ``tol``; ids equal at every untied position;
    the same slots absent (-1). Returns the largest absolute score error."""
    gs = got[0].cpu().numpy().astype(np.float64)
    gi = got[1].cpu().numpy()
    ws = want[0].cpu().numpy().astype(np.float64)
    wi = want[1].cpu().numpy()
    if gs.shape != ws.shape or gi.shape != wi.shape:
        raise AssertionError(f"shape {gs.shape} vs {ws.shape}")
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    if not np.array_equal(gi < 0, wi < 0):
        raise AssertionError("absent slots differ")
    gap = tol * (1.0 + np.abs(ws))
    near_prev = np.zeros(ws.shape, bool)
    near_prev[..., 1:] = np.abs(ws[..., 1:] - ws[..., :-1]) <= gap[..., 1:]
    near_next = np.zeros(ws.shape, bool)
    near_next[..., :-1] = near_prev[..., 1:]
    # the last slot may tie with the first row left out: treat it as tied
    untied = ~(near_prev | near_next) & (wi >= 0)
    untied[..., -1] = False
    bad = untied & (gi != wi)
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} untied ids differ")
    live = wi >= 0
    return float(np.abs(gs - ws)[live].max()) if live.any() else 0.0


# ---------------------------------------------------------------- phases


def phase_build(rec: dict, out_dir: str) -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    rec["build_seconds"] = time.perf_counter() - t0
    log(f"[build] kernels built in {rec['build_seconds']:.3f} s")
    with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
        for name, text in _build.build_log.items():
            f.write(f"== {name}\n{text}\n")
    rec["ptxas"] = ptxas_usage(_build.build_log)
    for kernel, use in rec["ptxas"].items():
        log(f"[build] {kernel}: {json.dumps(use)}")


def ptxas_usage(build_log: dict) -> dict:
    """Registers and spill bytes of every kernel in nvcc's ``-Xptxas -v``
    output, by kernel name (demangled by ``c++filt`` where the host has it,
    argument list cut)."""
    out, name = {}, None
    for text in build_log.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                try:
                    name = subprocess.run(["c++filt", name], capture_output=True, text=True,
                                          check=True).stdout.strip()
                except (OSError, subprocess.CalledProcessError):
                    pass
                name = name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
                out[name] = {}
            elif name and "spill" in line:
                st = re.search(r"(\d+) bytes spill stores", line)
                ld = re.search(r"(\d+) bytes spill loads", line)
                out[name]["spill_bytes"] = int(st.group(1)) + int(ld.group(1))
            elif name and "Used" in line:
                out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def phase_kernels(rec: dict, max_err: dict) -> None:
    import torch

    from repro_torch.kernels.fused_knn import fused_knn, fused_knn_db_stationary, fused_knn_plain

    kernels = {"fused_knn": fused_knn, "fused_knn_db_stationary": fused_knn_db_stationary}
    gen = torch.Generator(device="cuda").manual_seed(0)
    W, TQ, D, K = 256, 64, 64, 10
    rows = []

    def run_case(label, q, v, valid, k, metric, tol, timed, n_live=None):
        kw = dict(k=k, metric=metric, n_live=n_live)
        want = fused_knn_plain(q, v, valid, **kw)
        row = {"case": label, "W": q.shape[0], "TQ": q.shape[1], "TV": v.shape[1],
               "D": q.shape[2], "k": k, "metric": metric, "dtype": str(q.dtype)}
        for name, fn in kernels.items():
            got = fn(q, v, valid, **kw)
            torch.cuda.synchronize()
            exact(got, want, f"{name} {label} [{q.shape[0]}, {q.shape[1]}, {v.shape[1]}, {q.shape[2]}] "
                             f"{metric} {q.dtype}")
            err = compare(got, want, tol)
            max_err[name] = max(max_err[name], err)
            row[f"{name}_err"] = err
            if timed:
                row[f"{name}_ms"] = cuda_ms(lambda: fn(q, v, valid, **kw))
        if n_live is not None:
            dead = torch.arange(q.shape[1], device="cuda")[None, :] >= n_live[:, None]
            for name, fn in kernels.items():
                s, i = fn(q, v, valid, **kw)
                if not ((i[dead] == -1).all() and (s[dead] == np.float32(NEG_INF)).all()):
                    raise AssertionError(f"{name} {label}: a slot past n_live is not (NEG_INF, -1)")
        if timed:
            q_live = None if n_live is None else torch.arange(q.shape[1], device="cuda")[None, :] < n_live[:, None]
            row["plain_ms"] = cuda_ms(lambda: fused_knn_plain(q, v, valid, **kw), reps=3, warmup=1)
            row["yardstick_ms"] = cuda_ms(lambda: yardstick(q, v, valid, k, metric))
            row["bound_ms"], row["bound_by"] = bound(q, v, valid, k, metric, q_live)
        rows.append(row)
        log("[kernels] " + json.dumps(row))

    for tv in (32, 128, 256, 1024, 4096):
        for metric in ("ip", "l2"):
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                q = torch.randn((W, TQ, D), generator=gen, device="cuda").to(dtype)
                v = torch.randn((W, tv, D), generator=gen, device="cuda").to(dtype)
                valid = torch.rand((W, tv), generator=gen, device="cuda") < 0.7
                run_case("sweep", q, v, valid, K, metric, tol, timed=True)
    # text-encoder widths: D in chunks of 64, f32
    for metric in ("ip", "l2"):
        q = torch.randn((W, TQ, 768), generator=gen, device="cuda")
        v = torch.randn((W, 256, 768), generator=gen, device="cuda")
        valid = torch.rand((W, 256), generator=gen, device="cuda") < 0.7
        run_case("d768", q, v, valid, K, metric, 1e-4, timed=True)
    # n_live: no live slot, one, a ragged count per unit, every slot
    for tv in (128, 1024):
        q = torch.randn((W, TQ, D), generator=gen, device="cuda")
        v = torch.randn((W, tv, D), generator=gen, device="cuda")
        valid = torch.rand((W, tv), generator=gen, device="cuda") < 0.4
        for label, n_live in (("n_live_zero", torch.zeros(W, dtype=torch.int32, device="cuda")),
                              ("n_live_one", torch.ones(W, dtype=torch.int32, device="cuda")),
                              ("n_live_ragged", torch.randint(0, TQ + 1, (W,), generator=gen, device="cuda",
                                                              dtype=torch.int32)),
                              ("n_live_full", torch.full((W,), TQ, dtype=torch.int32, device="cuda"))):
            run_case(label, q, v, valid, K, "l2", 1e-4, timed=label == "n_live_ragged", n_live=n_live)
    # the PQ path's re-rank: units of one query, 40 candidates, a padding tail
    Wr = 16384
    q = torch.randn((Wr, 1, D), generator=gen, device="cuda")
    v = torch.randn((Wr, 40, D), generator=gen, device="cuda")
    valid = torch.rand((Wr, 40), generator=gen, device="cuda") < 0.9
    n_live = (torch.arange(Wr, device="cuda") < 10_000).to(torch.int32)
    run_case("one_query_units", q, v, valid, K, "ip", 1e-4, timed=True, n_live=n_live)
    q = torch.randn((W, TQ, D), generator=gen, device="cuda")
    v = torch.randn((W, 256, D), generator=gen, device="cuda")
    run_case("all_invalid", q, v, torch.zeros((W, 256), dtype=torch.bool, device="cuda"),
             K, "ip", 1e-4, timed=False)
    v = torch.randn((W, 1024, D), generator=gen, device="cuda")
    few = torch.zeros((W, 1024), dtype=torch.bool, device="cuda")
    few[:, [3, 700, 1001]] = True
    run_case("k_above_valid", q, v, few, K, "l2", 1e-4, timed=False)
    # a unit with 2 valid rows of 1024 and k=4: the unfilled slots are (NEG_INF, -1)
    two = torch.zeros((W, 1024), dtype=torch.bool, device="cuda")
    two[:, [3, 700]] = True
    for name, fn in kernels.items():
        s, i = fn(q, v, two, k=4, metric="ip")
        ids = i.cpu().numpy()
        if not ((ids[..., 2:] == -1).all() and (s[..., 2:].cpu().numpy() == np.float32(NEG_INF)).all()
                and set(np.unique(ids[..., :2]).tolist()) == {3, 700}):
            raise AssertionError(f"{name}: unfilled slots are not (NEG_INF, -1)")
    rec["kernel_cases"] = rows


def phase_main_path(rec: dict) -> dict:
    import torch

    from repro_torch.core import HQIConfig, HQIIndex, exhaustive_search, kg_style, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_knn import fused_knn, fused_knn_db_stationary, fused_knn_plain

    n, queries = MAIN_ROWS, MAIN_QUERIES
    t0 = time.perf_counter()
    kg = kg_style(n=n, d=64, queries_per_split=queries, seed=0)
    wl = kg.splits[1]
    log(f"[main] kg_style(n={n}, d=64, queries_per_split={queries}) made in "
        f"{time.perf_counter() - t0:.3f} s; vectors {kg.db.vectors.nbytes / 2**20:.1f} MiB")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    times = []
    for i in range(4):  # one cold (arena upload), three warm; the last one is counted
        if i == 3:
            fused_knn.launches = fused_knn_db_stationary.launches = fused_knn_plain.calls = 0
            ops.reset_dispatch_stats()
        t0 = time.perf_counter()
        res = index.search(wl, nprobe=8)
        times.append(time.perf_counter() - t0)
    counts = {"fused_knn": fused_knn.launches,
              "fused_knn_db_stationary": fused_knn_db_stationary.launches,
              "plain": fused_knn_plain.calls}
    st = ops.dispatch_stats().snapshot()
    warm_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] build {build_s:.3f} s ({index.build_info}); {len(index.partitions)} partitions")
    log(f"[main] search cold {times[0]:.3f} s, warm {[round(t, 4) for t in times[1:]]} s: "
        f"{wl.m / warm_s:.1f} queries/s warm (median)")
    log(f"[main] one warm search: launches {counts}; dispatch knn_calls={st.knn_calls} "
        f"merge_calls={st.merge_calls} shapes={sorted(st.shapes)} "
        f"peak_candidate_bytes={st.peak_candidate_bytes}; peak device memory {peak / 2**30:.2f} GiB")
    if counts["fused_knn"] <= 0 or counts["fused_knn_db_stationary"] <= 0:
        raise AssertionError(f"a kernel of the main path was never launched: {counts}")
    if counts["plain"] != 0:
        raise AssertionError(f"the plain version ran on the main path: {counts}")
    check_results(kg, wl, res)

    t0 = time.perf_counter()
    truth = exhaustive_search(kg.db, wl, device="cuda")
    exh_s = time.perf_counter() - t0
    recall = recall_at_k(res, truth)
    log(f"[main] recall@10 {recall:.4f} against exhaustive_search ({exh_s:.3f} s)")
    traced_s, spans = traced_search(index, wl, "main")
    prof_s, busy_s, top, device_us = profiled_search(index, wl, "main")
    scan_us = {key: us for key, us in device_us.items() if "fused_knn" in key or "merge_partials" in key}
    log(f"[main] profiled search's scan kernels (us): " + json.dumps(scan_us))
    if any("merge_partials" in key for key in device_us):
        raise AssertionError("the f32 search launched merge_partials_kernel: a split dispatch "
                             "must be one launch")

    rec["main_path"] = {
        "n": n, "d": 64, "queries": wl.m, "partitions": len(index.partitions),
        "build_seconds": build_s, "build_info": str(index.build_info),
        "search_seconds_cold": times[0], "search_seconds_warm": times[1:],
        "qps_warm": wl.m / warm_s, "recall_at_10": recall,
        "exhaustive_seconds": exh_s, "launches": counts,
        "knn_calls": st.knn_calls, "merge_calls": st.merge_calls,
        "shapes": sorted(st.shapes), "peak_candidate_bytes": st.peak_candidate_bytes,
        "peak_device_bytes": peak, "traced_search_seconds": traced_s, "span_ms": spans,
        "profiled_search_seconds": prof_s, "device_busy_seconds": busy_s,
        "device_ops_ms": top, "scan_kernels_us": scan_us,
    }
    return {"index": index, "wl": wl, "counts": counts, "kg": kg, "truth": truth}


def check_results(kg, wl, res) -> None:
    """Every returned id passes its query's filter and carries its exact f32
    score; no duplicates; scores finite exactly where ids are present."""
    check_answers(kg.db, wl, res.ids, res.scores)


def check_answers(db, wl, ids, scores, live_rows=None) -> None:
    """``check_results`` for ids into ``db``, and, with ``live_rows`` (bool
    [db.n]), every returned id live."""
    from repro_torch.core.predicates import evaluate_filter

    if ids.shape != (wl.m, wl.k) or scores.shape != (wl.m, wl.k):
        raise AssertionError(f"result shape {ids.shape}")
    live = ids >= 0
    if not np.isfinite(scores[live]).all() or np.isfinite(scores[~live]).any():
        raise AssertionError("scores not finite exactly where ids are present")
    if live_rows is not None and not live_rows[ids[live]].all():
        raise AssertionError("a returned id is not live")
    ok = np.zeros_like(live)
    for ti, filt in enumerate(wl.templates):
        qi = wl.queries_for_template(ti)
        bm = evaluate_filter(filt, db)
        ok[qi] = bm[np.maximum(ids[qi], 0)]
    if not ok[live].all():
        raise AssertionError("a returned id fails its query's filter")
    rows = db.vectors[np.maximum(ids, 0)]  # [m, k, d]
    exact = np.einsum("qd,qkd->qk", wl.vectors, rows)
    if db.metric == "l2":
        exact = 2.0 * exact - (wl.vectors ** 2).sum(1)[:, None] - (rows ** 2).sum(2)
    np.testing.assert_allclose(scores[live], exact[live], rtol=1e-4, atol=1e-4)
    for r in range(wl.m):
        row = ids[r][ids[r] >= 0]
        if len(np.unique(row)) != len(row):
            raise AssertionError(f"duplicate ids in row {r}")


def traced_search(index, wl, tag: str, **kw):
    """One search with the tracer on (fenced spans): (seconds, ms per span)."""
    from repro_torch.obs import trace

    tracer = trace.enable()
    t0 = time.perf_counter()
    index.search(wl, nprobe=8, **kw)
    traced_s = time.perf_counter() - t0
    trace.disable()
    spans: dict = {}
    for ev in tracer.events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    log(f"[{tag}] traced search {traced_s:.3f} s; span ms {json.dumps(spans)}")
    return traced_s, spans


def device_split(prof, width: int = 70, n: int = 8) -> tuple[float, dict, dict]:
    """Device-side events of a torch.profiler run (kernels, copies, memsets):
    (busy seconds, the ``n`` largest items in ms by name cut to ``width``
    characters, summed where cut names collide; every item in us by full
    name)."""
    device_us: dict = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            device_us[ev.key] = ev.self_device_time_total
    short: dict = {}
    for k, v in device_us.items():
        short[k[:width]] = short.get(k[:width], 0.0) + v / 1e3
    top = dict(sorted(short.items(), key=lambda kv: -kv[1])[:n])
    return sum(device_us.values()) / 1e6, top, device_us


def profiled_search(index, wl, tag: str, **kw):
    """One search under torch.profiler: (seconds, device busy seconds, the
    largest device items in ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(wl, nprobe=8, **kw)
        prof_s = time.perf_counter() - t0
    busy_s, top, device_us = device_split(prof, width=60)
    log(f"[{tag}] profiled search {prof_s:.3f} s, device busy {busy_s * 1e3:.3f} ms "
        f"({busy_s / prof_s:.2%}); top device ops (ms) " + json.dumps(top))
    return prof_s, busy_s, top, device_us


def phase_main_shapes(rec: dict, main: dict, max_err: dict) -> dict:
    """Each kernel on every bucket the main path gave it, with the live
    slots the engine passes: checked against the plain version, timed (one
    wrapper call by CUDA events, and the launch alone from the profiler)
    beside its bound and real slots, summed over the buckets, and timed
    plain and by the yardstick on its heaviest."""
    import torch

    from repro_torch.core.ivf import ScanStats
    from repro_torch.core.plan import build_plan
    from repro_torch.core.planner import bucket_operands, live_slots
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_knn import fused_knn, fused_knn_db_stationary, fused_knn_plain

    index, wl = main["index"], main["wl"]
    tasks, _, _ = index._engine_tasks(wl, nprobe=8, batch_vec=True, stats=ScanStats())
    plan = build_plan(index.arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan)
    q_dev = torch.from_numpy(wl.vectors).cuda()
    metric = index.arena.metric
    per_kernel: dict = {}
    buckets = []
    for lp in sorted(plan.buckets):
        qrow_of, _, _, Q, V, valid = bucket_operands(plan, index.arena, q_dev, lp)
        n_live = live_slots(qrow_of, "cuda")
        q_live = torch.from_numpy(qrow_of >= 0).cuda()
        k = min(wl.k, lp)
        kw = dict(k=k, metric=metric, n_live=n_live)
        name = "fused_knn_db_stationary" if ops.use_db_stationary(Q.shape[1], lp) else "fused_knn"
        fn = fused_knn_db_stationary if name == "fused_knn_db_stationary" else fused_knn
        got = fn(Q, V, valid, **kw)
        want = fused_knn_plain(Q, V, valid, **kw)
        exact(got, want, f"{name} on the main path's bucket of lists padded to {lp}")
        err = compare(got, want, 1e-4)
        max_err[name] = max(max_err[name], err)
        ms = cuda_ms(lambda: fn(Q, V, valid, **kw), reps=21)
        b_ms, b_by = bound(Q, V, valid, k, metric, q_live)
        row = {"kernel": name, "shape": [Q.shape[0], Q.shape[1], lp, k], "ms": ms,
               "device_ms": device_ms(lambda: fn(Q, V, valid, **kw), "fused_knn"),
               "bound_ms": b_ms, "bound_by": b_by, "ms_over_bound": ms / b_ms,
               "max_abs_err": err, "valid_rows": int(valid.sum().item()),
               "real_query_slots": int(q_live.sum().item()), "query_slots": int(q_live.numel())}
        buckets.append(row)
        log("[shapes] " + json.dumps(row))
        work = Q.shape[0] * lp
        if name not in per_kernel or work > per_kernel[name]["work"]:
            per_kernel[name] = {"work": work, "Q": Q, "V": V, "valid": valid, "kw": kw, "row": row}
        else:
            del Q, V, valid, q_live
    out = {}
    for name, sel in per_kernel.items():
        Q, V, valid, kw = sel["Q"], sel["V"], sel["valid"], sel["kw"]
        row = dict(sel["row"])
        row["plain_ms"] = cuda_ms(lambda: fused_knn_plain(Q, V, valid, **kw), reps=3, warmup=1)
        row["yardstick_ms"] = cuda_ms(lambda: yardstick(Q, V, valid, kw["k"], metric), reps=21)
        mine = [b for b in buckets if b["kernel"] == name]
        row["summed_over_buckets"] = {key: sum(b[key] for b in mine)
                                      for key in ("ms", "device_ms", "bound_ms")}
        out[name] = row
        log("[heaviest] " + json.dumps(row))
    total = {key: sum(b[key] for b in buckets) for key in ("ms", "device_ms", "bound_ms")}
    log(f"[shapes] summed over the search's {len(buckets)} buckets: " + json.dumps(total))
    rec["main_path_buckets"] = buckets
    rec["main_path_buckets_summed"] = total
    rec["main_path_heaviest"] = out
    return out


def agree(a, b, what: str) -> None:
    """Two searches agree: scores within 1e-4, equal id sets per query."""
    np.testing.assert_allclose(
        np.where(np.isfinite(a.scores), a.scores, -1e30),
        np.where(np.isfinite(b.scores), b.scores, -1e30), rtol=1e-4, atol=1e-4,
    )
    for r in range(a.ids.shape[0]):
        if set(a.ids[r][a.ids[r] >= 0].tolist()) != set(b.ids[r][b.ids[r] >= 0].tolist()):
            raise AssertionError(f"{what}: disagree on query {r}")


def phase_card_vs_cpu(rec: dict):
    import dataclasses

    from repro_torch.core import HQIConfig, HQIIndex, kg_style

    kg = kg_style(n=100_000, d=64, seed=0)
    wl = kg.splits[1]
    gpu = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device="cuda")
    cpu = HQIIndex.from_state(gpu.to_state(), device="cpu")
    a = gpu.search(wl, nprobe=8)
    t0 = time.perf_counter()
    b = cpu.search(wl, nprobe=8)
    cpu_s = time.perf_counter() - t0
    agree(a, b, "card and CPU")
    wl100 = dataclasses.replace(wl, k=ENGINE_K)
    tied = agree_untied(*_search_pair(gpu, wl100), *_search_pair(cpu, wl100), f"k={ENGINE_K}, card and CPU")
    svc = service_k100(gpu, cpu, wl)
    rec["card_vs_cpu"] = {"n": 100_000, "queries": wl.m, "cpu_search_seconds": cpu_s,
                          "agree": True, "k100_tied_queries": tied, "service_k100": svc}
    log(f"[card-vs-cpu] {wl.m} queries on a 100k-row index agree (CPU search {cpu_s:.3f} s); "
        f"at k={ENGINE_K} too ({tied} tied at the cut); the service at k={ENGINE_K}: " + json.dumps(svc))
    return kg, gpu


# ------------------------------------------------------------ sharded engine


def sharded_searches(index, wl, mesh, tag: str, **kw) -> dict:
    """The same search on ``mesh=None`` and on ``mesh``, interleaved (each
    side once cold, then three warm rounds of one search each, so a drift of
    the host's speed falls on both): queries/s from each side's warm
    median, counters zeroed and read around each side's last warm search,
    peak device memory over each side's searches, then one traced search
    each (ms per span). The answers must be bit-equal (scores and ids); the
    kernels' launches and the dispatches equal on both sides (so the
    launches per bucket); no plain version run."""
    import torch

    from repro_torch.kernels import ops

    sides = (("single", None), ("sharded", mesh))
    out: dict = {side: {"times": [], "peak": 0} for side, _ in sides}
    res = {}
    for i in range(4):  # one cold round, three warm; the last one is counted
        for side, m in sides:
            index.cfg.mesh = m
            if i == 3:
                zero_counters()
                before = ops.dispatch_stats().snapshot()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res[side] = index.search(wl, nprobe=8, **kw)
            out[side]["times"].append(time.perf_counter() - t0)
            out[side]["peak"] = max(out[side]["peak"], torch.cuda.max_memory_allocated())
            if i == 3:
                out[side]["counts"] = read_counters()
                out[side]["delta"] = ops.dispatch_stats().delta_since(before)
    for side, m in sides:
        index.cfg.mesh = m
        o = out[side]
        times, counts, delta = o.pop("times"), o.pop("counts"), o.pop("delta")
        plain = {n: c for n, c in counts.items() if n.endswith("_plain") and c}
        if plain:
            raise AssertionError(f"[sharded {tag}] {side}: a plain version ran: {plain}")
        traced_s, spans = traced_search(index, wl, f"sharded {tag} {side}", **kw)
        out[side] = {"search_seconds_cold": times[0], "search_seconds_warm": times[1:],
                     "traced_search_seconds": traced_s, "span_ms": spans,
                     "qps_warm": wl.m / statistics.median(times[1:]),
                     "launches": {n: c for n, c in counts.items() if c},
                     "knn_calls": delta.knn_calls, "merge_calls": delta.merge_calls,
                     "shapes": sorted(delta.shapes, key=str),
                     "peak_device_bytes": o["peak"], "bytes_scanned": res[side].bytes_scanned}
    index.cfg.mesh = None
    a, b = res["single"], res["sharded"]
    if not (np.array_equal(a.scores, b.scores) and np.array_equal(a.ids, b.ids)):
        bad = int((~((a.ids == b.ids).all(1) & (a.scores == b.scores).all(1))).sum())
        raise AssertionError(f"[sharded {tag}] not bit-equal to mesh=None: {bad} queries differ")
    kern = [n for n in out["single"]["launches"] if not n.endswith("_plain")]
    per_bucket = {s: sum(out[s]["launches"].get(n, 0) for n in kern) / max(out[s]["knn_calls"], 1)
                  for s in out}
    if (out["single"]["launches"] != out["sharded"]["launches"]
            or out["single"]["knn_calls"] != out["sharded"]["knn_calls"]):
        raise AssertionError(f"[sharded {tag}] launches or dispatches differ: {out}")
    out["launches_per_bucket"] = per_bucket
    out["result"] = b
    log(f"[sharded {tag}] " + json.dumps({s: {key: v for key, v in out[s].items()
                                              if key not in ("shapes", "span_ms")}
                                          for s in ("single", "sharded")}, default=str))
    return out


def phase_sharded(rec: dict, main: dict) -> dict:
    """(S4) The sharded engine on phase 3's index: four ranks of the model
    axis on the one card (``make_test_mesh((4,), ("model",), "cuda")``).
    The f32 search, then the same index with a codebook (``pq_m`` 8,
    ``refine_factor`` 4, segmented), each bit-equal to ``mesh=None`` and
    timed beside it (``sharded_searches``); ``ShardStats`` held to the
    reference's assertions (the ranks' units partition the single plan's,
    their scan bytes sum to the single scan's, ``gathered_per_query`` 4·k);
    one f32 search under the profiler (coverage 1.0, four rank rows); the
    dense merge layout at R 2 on 1,000 queries bit-equal to the segmented
    one (f32 and PQ); 1,000 queries of stream A through ``HQIService`` on
    the mesh index against ``mesh=None``; and, where more than one card is
    visible, the f32 search on ``make_production_mesh()``."""
    import torch

    from repro_torch.core.ivf import ScanStats
    from repro_torch.core.plan import build_plan
    from repro_torch.core.pq import train_pq
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.obs.metrics import get_registry
    from repro_torch.service import HQIService, ServiceConfig

    index, kg, wl = main["index"], main["kg"], main["wl"]
    t_phase = time.perf_counter()
    mesh = make_test_mesh((SHARDED_RANKS,), ("model",), device="cuda")
    out: dict = {"ranks": SHARDED_RANKS, "n": index.db.n, "queries": wl.m,
                 "devices": [str(d) for d in mesh.axis_devices("model")]}

    f32 = sharded_searches(index, wl, mesh, "f32")
    st = f32["result"].shard_stats
    tasks, _, _ = index._engine_tasks(wl, nprobe=8, batch_vec=True, stats=ScanStats())
    n_units = build_plan(index.arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan).n_units
    if (st.n_shards != SHARDED_RANKS or int(st.per_rank_units.sum()) != n_units
            or int(st.per_rank_bytes.sum()) != f32["single"]["bytes_scanned"]
            or st.gathered_per_query != SHARDED_RANKS * wl.k):
        raise AssertionError(f"[sharded f32] ShardStats {st} against {n_units} units, "
                             f"{f32['single']['bytes_scanned']} bytes")
    if f32["sharded"]["launches"].get("fused_knn", 0) <= 0 or \
            f32["sharded"]["launches"].get("fused_knn_db_stationary", 0) <= 0:
        raise AssertionError(f"[sharded f32] kernels 1-2 did not both launch: {f32['sharded']}")
    out["shard_stats_f32"] = {"per_rank_units": st.per_rank_units.tolist(),
                              "per_rank_bytes": st.per_rank_bytes.tolist(),
                              "per_rank_dispatches": st.per_rank_dispatches.tolist(),
                              "gathered_per_query": st.gathered_per_query,
                              "single_plan_units": n_units}
    index.cfg.mesh = mesh
    try:
        prof = profiled_engine(index, wl, "sharded-f32")
    finally:
        index.cfg.mesh = None
    if sorted(prof["ranks"]) != [str(r) for r in range(SHARDED_RANKS)]:
        raise AssertionError(f"[sharded] profiler rank rows {prof['ranks']}")
    out["profile_f32"] = prof

    t0 = time.perf_counter()
    index.attach_pq(train_pq(kg.db.vectors, 8, metric=kg.db.metric, seed=0, device="cuda"))
    torch.cuda.synchronize()
    out["attach_pq_seconds"] = time.perf_counter() - t0
    pq = sharded_searches(index, wl, mesh, "pq", scan_mode="pq", refine_factor=4)
    pst = pq["result"].shard_stats
    if pq["sharded"]["launches"].get("workunit_pq_scan_streamed", 0) <= 0 or \
            pq["sharded"]["launches"].get("fused_knn_db_stationary", 0) <= 0:
        raise AssertionError(f"[sharded pq] kernel 3 or the re-rank did not launch: {pq['sharded']}")
    if pst.gathered_per_query != SHARDED_RANKS * (4 * wl.k + wl.k):
        raise AssertionError(f"[sharded pq] gathered {pst.gathered_per_query} a query")
    out["shard_stats_pq"] = {"per_rank_units": pst.per_rank_units.tolist(),
                             "per_rank_bytes": pst.per_rank_bytes.tolist(),
                             "gathered_per_query": pst.gathered_per_query}
    for tag, r in (("f32", f32), ("pq", pq)):
        del r["result"]
        out[tag] = r

    # the dense merge layout at R 2 on 1,000 queries, bit-equal to the segmented one
    sub = wl.subset(np.arange(SHARDED_LAYOUT_QUERIES))
    index.cfg.mesh = make_test_mesh((2,), ("model",), device="cuda")
    layouts: dict = {}
    try:
        for kw in ({}, {"scan_mode": "pq"}):
            got = {}
            for layout in ("segmented", "dense"):
                index.cfg.plan.merge_layout = layout
                got[layout] = index.search(sub, nprobe=8, **kw)
            a, b = got["segmented"], got["dense"]
            if not (np.array_equal(a.scores, b.scores) and np.array_equal(a.ids, b.ids)):
                raise AssertionError(f"[sharded] dense layout differs from segmented {kw}")
            layouts[kw.get("scan_mode", "f32")] = {"peak_candidate_bytes": {
                "segmented": a.peak_candidate_bytes, "dense": b.peak_candidate_bytes}}
    finally:
        index.cfg.plan.merge_layout = "segmented"
        index.cfg.mesh = None
    out["dense_layout_r2"] = layouts

    # 1,000 queries of stream A through the service, mesh against mesh=None
    streams = {}
    try:
        for side, m in (("single", None), ("sharded", mesh)):
            index.cfg.mesh = m
            svc = HQIService(index, ServiceConfig(k=10, nprobe=8, max_batch=256, deadline_s=0.005))
            streams[side] = service_stream(svc, sub)
            del svc
    finally:
        index.cfg.mesh = None
        get_registry().detach_source("service")
        get_registry().detach_source("health")
    a, b = streams["single"], streams["sharded"]
    tied = agree_untied(a["scores"], a["ids"], b["scores"], b["ids"], "service mesh vs mesh=None")
    out["service"] = {side: {key: streams[side][key] for key in ("seconds", "qps", "p50_s", "p99_s")}
                      for side in streams}
    out["service"]["tied_queries"] = tied
    out["service"]["bit_equal"] = bool(np.array_equal(a["ids"], b["ids"])
                                       and np.array_equal(a["scores"], b["scores"]))

    if torch.cuda.device_count() > 1:
        prod = make_production_mesh()
        index.cfg.mesh = prod
        try:
            got = index.search(wl, nprobe=8)
        finally:
            index.cfg.mesh = None
        ref = index.search(wl, nprobe=8)
        if not (np.array_equal(got.scores, ref.scores) and np.array_equal(got.ids, ref.ids)):
            raise AssertionError("[sharded] make_production_mesh() search differs from mesh=None")
        out["production_mesh"] = {"cards": prod.shape["model"], "bit_equal": True}
    else:
        log("[sharded] one card visible: the make_production_mesh() step did not run")
        out["production_mesh"] = "not run: one card visible"
    out["seconds"] = time.perf_counter() - t_phase
    log("[sharded] " + json.dumps({key: v for key, v in out.items() if key not in ("f32", "pq", "profile_f32")},
                                  default=str))
    rec["sharded"] = out
    return {"f32": f32["sharded"]["launches"], "pq": pq["sharded"]["launches"]}


# ------------------------------------------------------------ online service


def service_stream(svc, wl, *, burst: bool = False) -> dict:
    """Drive one stream of ``wl`` through ``svc``: queries are submitted one
    by one and a flush runs whenever a full micro-batch waits (the size
    trigger); a ``burst`` submits them all first. Then drain. Returns the
    stacked answers, the degraded flags, the stream's wall seconds and its
    submit->answer latencies."""
    import torch

    t0 = time.perf_counter()
    handles = []
    for i in range(wl.m):
        handles.append(svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]))
        if not burst and len(svc.scheduler) >= svc.cfg.max_batch:
            svc.tick()
    svc.drain()
    if svc.index.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not all(h.ok for h in handles):
        raise AssertionError(f"{sum(not h.ok for h in handles)} queries failed: "
                             f"{next(h.error for h in handles if not h.ok)!r}")
    lat = np.array([h.latency_s for h in handles])
    return {"ids": np.stack([h.ids for h in handles]), "scores": np.stack([h.scores for h in handles]),
            "degraded": np.array([h.degraded for h in handles]), "seconds": seconds,
            "qps": wl.m / seconds, "p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99))}


def service_db(svc):
    """The service's full DB (indexed rows and the delta's, dead included,
    in global-id order) and its live rows."""
    from repro_torch.core.types import VectorDatabase

    delta_db, _ = svc.delta.snapshot()
    full = svc.index.db if delta_db is None else VectorDatabase.concat(svc.index.db, delta_db)
    live = np.zeros(full.n, dtype=bool)
    live[svc.live_ids()] = True
    return full, live


def agree_untied(a_s, a_i, b_s, b_i, what: str, tol: float = 1e-4) -> int:
    """Scores within ``tol``; per query, an id on one side only must score
    within ``tol`` of that side's last kept score (a tie at the cut).
    Returns the count of queries whose id sets differ at such a tie."""
    fin = lambda s: np.where(np.isfinite(s), s, -1e30)  # noqa: E731
    np.testing.assert_allclose(fin(a_s), fin(b_s), rtol=tol, atol=tol)
    tied = 0
    for r in range(a_i.shape[0]):
        sa, sb = set(a_i[r][a_i[r] >= 0].tolist()), set(b_i[r][b_i[r] >= 0].tolist())
        if sa == sb:
            continue
        for ids, s, other in ((a_i[r], a_s[r], sb), (b_i[r], b_s[r], sa)):
            last = s[ids >= 0].min()
            for j in np.nonzero(ids >= 0)[0]:
                if ids[j] not in other and s[j] - last > tol * (1 + abs(last)):
                    raise AssertionError(f"{what}: query {r} id {ids[j]} untied and missing")
        tied += 1
    return tied


def stream_recall(svc, wl, got: dict, sub: np.ndarray) -> float:
    """recall@k of a stream's answers on the queries ``sub`` against the
    exhaustive answer over ``snapshot_db()`` (positions mapped through
    ``live_ids()``), on the service's device."""
    from repro_torch.core import SearchResult, exhaustive_search, recall_at_k

    swl = wl.subset(sub)
    truth = exhaustive_search(svc.snapshot_db(), swl, device=svc.index.device)
    live = svc.live_ids()
    truth.ids = np.where(truth.ids >= 0, live[np.maximum(truth.ids, 0)], -1)
    return recall_at_k(SearchResult(ids=got["ids"][sub], scores=got["scores"][sub]), truth)


def phase_service(rec: dict, main: dict) -> dict:
    """(S1) The online service at real size on phase 3's index: streams A
    (empty delta), B (32,768 inserts and 19,661 deletes live: the PQ delta
    scan, kernel 4, on every flush), C (after ``refresh()``) and an overload
    burst (its first flushes shed to the PQ engine, kernel 3), counters
    zeroed and read around each; every answer live, passing its filter, with
    its exact score; A and C equal the offline search; kernel 4 bit-equal to
    its plain version and timed at every shape stream B gave it."""
    import torch

    from repro_torch.core import arena as arena_mod
    from repro_torch.core.pq import train_pq
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import get_registry
    from repro_torch.service import HQIService, ServiceConfig

    index, kg, wl = main["index"], main["kg"], main["wl"]
    n0, n_parts = index.db.n, len(index.partitions)
    t_phase = t0 = time.perf_counter()
    index.attach_pq(train_pq(kg.db.vectors, 8, metric=kg.db.metric, seed=0, device="cuda"))
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t0
    svc = HQIService(index, ServiceConfig(k=10, nprobe=8, max_batch=256, deadline_s=0.005))
    if svc.cfg.batch_vec is not True:
        raise AssertionError(f"the service on the card kept batch_vec={svc.cfg.batch_vec!r}")
    sub = np.random.default_rng(2).choice(wl.m, SERVICE_RECALL_QUERIES, replace=False)
    out: dict = {"n": n0, "queries": wl.m, "partitions": n_parts, "attach_pq_seconds": pq_s,
                 "config": {"k": 10, "nprobe": 8, "max_batch": 256, "deadline_s": 0.005,
                            "delta_pq_threshold": svc.cfg.delta_pq_threshold,
                            "batch_vec": svc.cfg.batch_vec}}
    streams: dict = {}

    def run(tag, wl, burst=False, capture=None):
        zero_counters()
        before = ops.dispatch_stats().snapshot()
        real = ops.workunit_pq_topk
        if capture is not None:
            def spy(luts, codes, valid, k, *, n_live=None):
                capture.setdefault((luts.shape[0], luts.shape[1], codes.shape[1]),
                                   (luts, codes, valid, k, n_live))
                return real(luts, codes, valid, k, n_live=n_live)
            ops.workunit_pq_topk = spy
        try:
            got = service_stream(svc, wl, burst=burst)
        finally:
            ops.workunit_pq_topk = real
        counts = read_counters()
        delta = ops.dispatch_stats().delta_since(before)
        plain = {n: c for n, c in counts.items() if n.endswith("_plain") and c}
        if plain:
            raise AssertionError(f"stream {tag}: a plain version ran: {plain}")
        if counts["fused_knn"] <= 0 or counts["fused_knn_db_stationary"] <= 0:
            raise AssertionError(f"stream {tag}: kernels 1-2 did not both launch: {counts}")
        full, live = service_db(svc)
        check_answers(full, wl, got["ids"], got["scores"], live_rows=live)
        got["recall_at_10"] = stream_recall(svc, wl, got, sub[sub < wl.m])
        row = {key: got[key] for key in ("seconds", "qps", "p50_s", "p99_s", "recall_at_10")}
        row.update(launches=counts, knn_calls=delta.knn_calls, merge_calls=delta.merge_calls,
                   degraded_queries=int(got["degraded"].sum()), delta_rows=svc.delta.n,
                   delta_live=svc.delta.n_live)
        streams[tag] = row
        log(f"[service {tag}] " + json.dumps(row))
        return got

    def offline(tag, got):
        res = index.search(wl, nprobe=8, batch_vec=svc.cfg.batch_vec, live_mask=svc._live.copy())
        tied = agree_untied(got["scores"], got["ids"], res.scores, res.ids, f"stream {tag} vs offline")
        streams[tag]["offline_tied_queries"] = tied
        log(f"[service {tag}] equals the offline search ({tied} queries differ only at a tie)")

    a = run("A", wl)
    offline("A", a)
    if streams["A"]["launches"]["workunit_pq_scan"] != 0:
        raise AssertionError("stream A ran the delta's ADC scan with an empty delta")

    rng = np.random.default_rng(1)
    n_new = SERVICE_INSERTS
    src = rng.integers(0, n0, n_new)
    vecs = kg.db.vectors[src] + 0.01 * rng.normal(size=(n_new, kg.db.d)).astype(np.float32)
    cols = {name: c.values[src] for name, c in kg.db.columns.items()}
    nulls = {name: c.null_mask[src] for name, c in kg.db.columns.items() if c.kind != "setcat"}
    t0 = time.perf_counter()
    ids = svc.insert(vecs, cols, nulls)
    torch.cuda.synchronize()
    out["insert_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_del = svc.delete(rng.choice(n0, SERVICE_BASE_DELETES, replace=False))
    n_del += svc.delete(rng.choice(ids, SERVICE_DELTA_DELETES, replace=False))
    out["delete_seconds"] = time.perf_counter() - t0
    out.update(inserted=n_new, deleted=n_del, delta_live=svc.delta.n_live)
    log(f"[service] inserted {n_new} rows in {out['insert_seconds']:.3f} s, deleted {n_del} in "
        f"{out['delete_seconds']:.3f} s; live delta {svc.delta.n_live} rows")

    shapes: dict = {}
    run("B", wl, capture=shapes)
    nb = streams["B"]["launches"]["workunit_pq_scan"]
    if nb <= 0 or not shapes or any(tv != SERVICE_INSERTS for _, _, tv in shapes):
        raise AssertionError(f"stream B: kernel 4 launches {nb}, shapes {sorted(shapes)}")
    out["kernel4_shapes"] = kernel4_shapes(shapes)

    # one more stream-B flush, profiled
    for i in range(svc.cfg.max_batch):
        svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # a CPU trace would add nothing read here
        t0 = time.perf_counter()
        svc.flush()
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
    busy_s, top, _ = device_split(prof, width=60)
    out["profiled_flush"] = {"seconds": flush_s, "device_busy_seconds": busy_s,
                             "busy_share": busy_s / flush_s, "device_ops_ms": top}
    log(f"[service B] profiled flush {flush_s:.4f} s, device busy {busy_s * 1e3:.3f} ms "
        f"({busy_s / flush_s:.2%}); top device ops (ms) " + json.dumps(top))
    # and one traced (fenced spans): where the flush's host time goes
    for i in range(svc.cfg.max_batch):
        svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]])
    tracer = trace.enable()
    t0 = time.perf_counter()
    svc.flush()
    traced_s = time.perf_counter() - t0
    trace.disable()
    spans: dict = {}
    for ev in tracer.events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    out["traced_flush"] = {"seconds": traced_s, "span_ms": spans}
    log(f"[service B] traced flush {traced_s:.4f} s; span ms {json.dumps(spans)}")

    encoded = []
    real_encode = arena_mod.encode_pq_tensor

    def count_encode(cb, rows, device="cuda"):
        encoded.append(rows.shape[0])
        return real_encode(cb, rows, device=device)

    sizes = [p.ivf.n for p in index.partitions]
    arena_mod.encode_pq_tensor = count_encode
    try:
        t0 = time.perf_counter()
        folded = svc.refresh()
        torch.cuda.synchronize()
        out["refresh_seconds"] = time.perf_counter() - t0
    finally:
        arena_mod.encode_pq_tensor = real_encode
    changed = [i for i, p in enumerate(index.partitions) if p.ivf.n != sizes[i]]
    if (folded != n_new or len(index.partitions) != n_parts or index.arena.n != n0 + n_new
            or sum(encoded) != n_new):
        raise AssertionError(f"refresh: folded {folded}, {len(index.partitions)} partitions, "
                             f"arena {index.arena.n} rows, encoded {sum(encoded)}")
    out.update(refresh_folded=folded, arena_rows=index.arena.n, changed_partitions=len(changed),
               encoded_rows=sum(encoded))
    log(f"[service] refresh {out['refresh_seconds']:.3f} s: {folded} rows folded, "
        f"{len(changed)} of {n_parts} partitions changed, {sum(encoded)} appended rows encoded; "
        f"arena {index.arena.n} rows")

    c = run("C", wl)
    offline("C", c)
    if streams["C"]["launches"]["workunit_pq_scan"] != 0:
        raise AssertionError("stream C ran the delta's ADC scan after the fold")

    svc.cfg.overload_queue_depth = SERVICE_SHED_DEPTH
    d = run("burst", wl.subset(np.arange(SERVICE_BURST)), burst=True)
    row = streams["burst"]
    row["degraded_flushes"] = int(svc.telemetry.summary()["degraded_flushes"])
    if (row["launches"]["workunit_pq_scan_streamed"] <= 0 or not d["degraded"].any()
            or d["degraded"][-1] or svc.health().status != "ok"):
        raise AssertionError(f"burst: no shed to PQ, or no recovery: {row}")
    out["streams"] = streams
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[service] S1 done in {out['seconds']:.1f} s; {row['degraded_flushes']} degraded flushes")
    rec["service"] = out
    get_registry().detach_source("service")  # the registry's sources hold the service
    get_registry().detach_source("health")
    return {"kernel4": out["kernel4_shapes"], "launches": {t: s["launches"] for t, s in streams.items()},
            "svc": svc}


def kernel4_shapes(shapes: dict) -> list:
    """Kernel 4 (``workunit_pq_scan``) on each shape stream B gave it, with
    the flush's operands and ``n_live``: bit-equal to its plain version;
    one wrapper call timed by CUDA events and the launch alone by the
    profiler, beside the bound counted as row 4 of PERF.md's table (the
    live slots' LUT rows, the valid rows' codes, the masks, the output);
    plain version and yardstick on the heaviest."""
    import torch

    from repro_torch.kernels import pq_scan as adc

    rows, heavy = [], None
    for (W, TQ, TV), (luts, codes, valid, k, n_live) in sorted(shapes.items()):
        kw = {"k": k, "n_live": n_live}
        exact(adc.workunit_pq_scan(luts, codes, valid, **kw),
              adc.workunit_pq_scan_plain(luts, codes, valid, **kw),
              f"kernel 4 on stream B's flush [{W}, {TQ}, {TV}]")
        q_live = torch.arange(TQ, device=luts.device)[None, :] < n_live[:, None]
        row = {"shape": [W, TQ, TV, codes.shape[2], k], "n_live": n_live.tolist(),
               "ms": cuda_ms(lambda: adc.workunit_pq_scan(luts, codes, valid, **kw), reps=21),
               "device_ms": device_ms(lambda: adc.workunit_pq_scan(luts, codes, valid, **kw),
                                      "adc_slot_warps_kernel"),
               "launch_shape": adc.launch_shape(W, TQ, TV, codes.shape[2], k), "bit_equal": True}
        row.update(adc_bound(codes, valid, k, q_live, int(q_live.sum())))
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
        rows.append(row)
        log("[service kernel 4] " + json.dumps(row))
        if heavy is None or int(q_live.sum()) > heavy[0]:
            heavy = (int(q_live.sum()), row, luts, codes, valid, kw)
    _, row, luts, codes, valid, kw = heavy
    row["plain_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_plain(luts, codes, valid, **kw), reps=5)
    row["yardstick_ms"] = cuda_ms(lambda: adc_yardstick(luts, codes, valid, kw["k"]), reps=5)
    log("[service kernel 4 heaviest] " + json.dumps(row))
    return rows


def dir_bytes(path: str) -> int:
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def same_answers(a: dict, b: dict, what: str) -> float:
    """Two streams' answers: ids equal, scores within 1e-4. Returns the
    largest score difference."""
    if not np.array_equal(a["ids"], b["ids"]):
        raise AssertionError(f"{what}: the ids differ in {int((a['ids'] != b['ids']).any(1).sum())} queries")
    fin = lambda x: np.where(np.isfinite(x), x, 0.0)  # noqa: E731
    np.testing.assert_allclose(fin(a["scores"]), fin(b["scores"]), rtol=1e-4, atol=1e-4)
    return float(np.abs(fin(a["scores"]) - fin(b["scores"])).max())


def phase_store(rec: dict, index, kg, wl, out_dir: str, *, inserts=STORE_INSERTS,
                deletes=STORE_DELETES, queries: int = STORE_QUERIES,
                shift_queries: int = STORE_SHIFT_QUERIES) -> dict:
    """(S3) Durability and index evolution on ``index`` (a codebook
    attached): a store under ``out_dir``, writes acknowledged through the
    WAL, answers P, a crash and ``open_service`` on the card (P again, the
    same live ids), a compaction and a reopen that replays nothing, a forced
    or triggered tune beside a thread of queries, its rollback, and the
    chaos harness on the card in a subprocess. Returns the kernels' launches
    in the first stream."""
    import gc
    import shutil
    import tempfile
    import threading

    import torch

    from repro_torch.obs import trace
    from repro_torch.obs.metrics import get_registry
    from repro_torch.service import ServiceConfig
    from repro_torch.store import Compactor, init_store, list_generations, open_service
    from repro_torch.store.snapshot import current_generation
    from repro_torch.tuner import Tuner, TunerConfig

    t_phase = time.perf_counter()
    cfg = dict(k=10, nprobe=8, max_batch=256, deadline_s=0.005)
    wl1 = wl.subset(np.arange(queries))
    registry = get_registry()
    root = tempfile.mkdtemp(prefix="store-", dir=out_dir)
    out: dict = {"n": index.db.n, "config": cfg}

    def stream(svc, tag, expect=("fused_knn", "fused_knn_db_stationary")):
        zero_counters()
        got = service_stream(svc, wl1)
        counts = read_counters()
        plain = {n: c for n, c in counts.items() if n.endswith("_plain") and c}
        if plain or any(counts[n] <= 0 for n in expect):
            raise AssertionError(f"S3 {tag}: launches {counts}")
        full, live = service_db(svc)
        check_answers(full, wl1, got["ids"], got["scores"], live_rows=live)
        got["launches"] = counts
        return got

    try:
        # 1. the store around the index: a generation and an empty WAL
        t0 = time.perf_counter()
        svc = init_store(root, index, cfg=ServiceConfig(**cfg))
        out["init_store_seconds"] = time.perf_counter() - t0
        out["snapshot_bytes"] = dir_bytes(os.path.join(root, list_generations(root)[-1]))
        log(f"[store] init_store {out['init_store_seconds']:.3f} s (the snapshot's write); "
            f"generation {out['snapshot_bytes']} bytes")

        # 2. writes acknowledged through the WAL (sync), the way callers write
        rng = np.random.default_rng(3)
        (n_batches, rows), (n_del, del_ids) = inserts, deletes
        fsyncs = registry.histogram("wal.fsync_s")
        fsync0, seq0 = fsyncs.count, svc.wal.last_seq
        new_ids = []
        t0 = time.perf_counter()
        for _ in range(n_batches):
            src = rng.integers(0, kg.db.n, rows)
            vecs = kg.db.vectors[src] + 0.01 * rng.normal(size=(rows, kg.db.d)).astype(np.float32)
            cols = {name: c.values[src] for name, c in kg.db.columns.items()}
            nulls = {name: c.null_mask[src] for name, c in kg.db.columns.items() if c.kind != "setcat"}
            new_ids.append(svc.insert(vecs, cols, nulls))
        torch.cuda.synchronize()
        insert_s = time.perf_counter() - t0
        new_ids = np.concatenate(new_ids)
        half = n_del * del_ids // 2
        doomed = np.concatenate([rng.choice(index.db.n, half, replace=False),
                                 rng.choice(new_ids, half, replace=False)])
        t0 = time.perf_counter()
        deleted = sum(svc.delete(b) for b in np.split(doomed, n_del))
        delete_s = time.perf_counter() - t0
        if deleted != len(doomed) or svc.delta.n_live <= svc.cfg.delta_pq_threshold:
            raise AssertionError(f"S3 writes: {deleted} deleted, live delta {svc.delta.n_live}")
        out["writes"] = {"inserted": int(len(new_ids)), "insert_seconds": insert_s,
                         "acked_rows_per_s": len(new_ids) / insert_s, "deleted": deleted,
                         "delete_seconds": delete_s, "wal_records": svc.wal.last_seq - seq0,
                         "fsyncs": fsyncs.count - fsync0, "live_delta": svc.delta.n_live}
        log("[store] writes through the WAL: " + json.dumps(out["writes"]))

        # 3. answers P (the delta's PQ scan: kernel 4)
        p = stream(svc, "P", expect=("fused_knn", "fused_knn_db_stationary", "workunit_pq_scan"))
        out["P"] = {"seconds": p["seconds"], "qps": p["qps"], "launches": p["launches"]}
        live_before = svc.live_ids()

        # 4. crash, then recover on the card: the load and the replay apart
        svc.wal.close()
        registry.detach_source("service")  # the registry's sources hold the service
        registry.detach_source("health")
        del svc
        gc.collect()
        torch.cuda.empty_cache()
        tracer = trace.enable()
        t0 = time.perf_counter()
        svc = open_service(root, cfg=ServiceConfig(**cfg))
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        trace.disable()
        load_s = sum(ev["dur"] for ev in tracer.events() if ev.get("name") == "snapshot.load") / 1e6
        if svc.index.device.type != "cuda" or not np.array_equal(svc.live_ids(), live_before):
            raise AssertionError("S3 recovery: not on the card, or live_ids() changed")
        again = stream(svc, "P after recovery",
                       expect=("fused_knn", "fused_knn_db_stationary", "workunit_pq_scan"))
        out["recovery"] = {"seconds": recover_s, "snapshot_load_seconds": load_s,
                           "replay_seconds": recover_s - load_s,
                           "replayed_records": svc._applied_seq - svc._wal_folded_seq,
                           "replayed_rows": svc.delta.n,
                           "max_score_diff": same_answers(p, again, "P after recovery")}
        log("[store] recovered: " + json.dumps(out["recovery"]))

        # 5. compaction, then a reopen with nothing to replay
        segs = set(svc.wal.segments())
        comp = Compactor(svc, root, keep_generations=1)
        t0 = time.perf_counter()
        name = comp.compact_once(force=True)
        compact_s = time.perf_counter() - t0
        q = stream(svc, "after compaction")
        reopened = open_service(root, cfg=ServiceConfig(**cfg))
        replayed = reopened._applied_seq - reopened._wal_folded_seq
        if replayed or reopened.delta.n:
            raise AssertionError(f"S3 reopen after compaction replayed {replayed} records")
        diff = same_answers(q, stream(reopened, "reopened after compaction"), "reopen after compaction")
        del reopened
        out["compaction"] = {"seconds": compact_s, "flush_lock_seconds": comp.last_lock_s,
                             "capture_seconds": comp.last_capture_s, "generation": name,
                             "generation_bytes": dir_bytes(os.path.join(root, name)),
                             "segments_pruned": len(segs - set(svc.wal.segments())),
                             "reopen_replayed_records": replayed, "reopen_max_score_diff": diff}
        log("[store] compacted: " + json.dumps(out["compaction"]))

        # 6. evolution: shifted traffic, a tune beside a thread of queries, rollback
        service_stream(svc, kg.splits[3].subset(np.arange(shift_queries)))
        drift = svc.drift_report()
        tuner = Tuner(svc, root, cfg=TunerConfig(share_shift=0.2, min_window=32, retune_nprobe=False))
        force = tuner.should_rebuild(drift) is None
        handles: list = []

        def submit_during_tune():
            for i in range(wl1.m):
                handles.append(svc.submit(wl1.vectors[i], wl1.templates[wl1.template_of[i]]))
                time.sleep(0.002)

        svc.start(poll_s=0.001)
        side = threading.Thread(target=submit_during_tune, name="S3-queries")
        side.start()
        try:
            swap = tuner.tune_once(force=force)
        finally:
            side.join(timeout=300)
            hung = sum(not h.wait(timeout=120) for h in handles)
            svc.stop()
        failed = sum(h.done and not h.ok for h in handles)
        if side.is_alive() or hung or failed or len(handles) != wl1.m:
            raise AssertionError(f"S3 tune: {len(handles)} submitted, {hung} hung, {failed} failed")
        after = stream(svc, "after the swap")
        recall = stream_recall(svc, wl1, after, np.arange(wl1.m))
        if current_generation(root) != swap.generation:
            raise AssertionError(f"S3 tune: CURRENT is {current_generation(root)}, not {swap.generation}")
        tuner.rollback()
        back = same_answers(q, stream(svc, "after the rollback"), "rollback")
        out["evolution"] = {"share_shift": drift.share_shift, "forced": force,
                            "reason": swap.reason, "generation": swap.generation,
                            "covered_seq": swap.covered_seq, "n_rows": swap.n_rows,
                            "replayed": swap.replayed, "build_seconds": swap.build_s,
                            "swap_seconds": swap.swap_s, "queries_during_tune": len(handles),
                            "recall_at_10_after_swap": recall, "rollback_max_score_diff": back}
        log("[store] evolved: " + json.dumps(out["evolution"]))
        svc.wal.close()
        registry.detach_source("service")
        registry.detach_source("health")
        registry.detach_source("compactor")
        registry.detach_source("tuner")
        del svc, tuner, comp
        gc.collect()
        torch.cuda.empty_cache()

        # 7. the chaos harness on the card, its child writer too
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src")] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.fault.chaos", "--smoke", "--device", "cuda",
             "--root", os.path.join(root, "chaos")],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
        )
        if proc.returncode != 0:
            raise AssertionError(f"S3 chaos exited {proc.returncode}: {proc.stdout[-2000:]} "
                                 f"{proc.stderr[-2000:]}")
        chaos = json.loads(proc.stdout)
        if not (chaos["ok"] and chaos["killed_writer_acks"] > 0 and chaos["recovery_checks"] >= 1
                and chaos["hung"] == 0 and chaos["parity_mismatches"] == 0
                and chaos["recovery_violations"] == 0):
            raise AssertionError(f"S3 chaos: {chaos}")
        chaos["seconds"] = time.perf_counter() - t0
        out["chaos"] = chaos
        log("[store] chaos on the card: " + json.dumps(chaos))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    rec["store"] = out
    log(f"[store] S3 done in {out['seconds']:.1f} s")
    return {"launches": out["P"]["launches"]}


def phase_service_card_vs_cpu(rec: dict, kg, gpu, *, inserts: int = 8192,
                              burst_depth: int = 512, out_dir=None) -> None:
    """(S2) The service on the card and on a CPU reload of the same index
    (its ``to_state()``, codebook included), driven by the same streams and
    writes: A, then ``inserts`` rows near existing ones and deletes (a tenth
    of the inserts and of as many base rows) with the live delta past the
    default threshold (the PQ delta scan on both sides), B, ``refresh()``,
    C and a burst past ``burst_depth``. Every stream's answers agree: scores
    within 1e-4, equal id sets. The card's service writes through a store
    (a temporary directory under ``out_dir``): after the burst a compaction
    writes a generation, a few writes leave a WAL tail, and the store opened
    on the CPU (``open_service(device="cpu")``) answers stream C's queries
    as the card does."""
    import shutil
    import tempfile

    from repro_torch.core import HQIIndex, SearchResult
    from repro_torch.core.pq import train_pq
    from repro_torch.obs.metrics import get_registry
    from repro_torch.service import HQIService, ServiceConfig
    from repro_torch.store import Compactor, init_store, open_service

    t_phase = time.perf_counter()
    wl = kg.splits[1]
    gpu.attach_pq(train_pq(kg.db.vectors, 8, metric=kg.db.metric, seed=0, device="cuda"))
    # both sides take the engine for every group, as the card's "auto" does
    cfg = dict(k=10, nprobe=8, max_batch=256, deadline_s=0.005, batch_vec=True)
    cpu = HQIIndex.from_state(gpu.to_state(), device="cpu")
    root = tempfile.mkdtemp(prefix="store-", dir=out_dir)
    svcs = [init_store(root, gpu, cfg=ServiceConfig(**cfg)), HQIService(cpu, ServiceConfig(**cfg))]
    if inserts - inserts // 10 <= svcs[0].cfg.delta_pq_threshold:
        raise AssertionError("the live delta must exceed the PQ threshold")
    rng = np.random.default_rng(1)
    src = rng.integers(0, kg.db.n, inserts)
    vecs = kg.db.vectors[src] + 0.01 * rng.normal(size=(inserts, kg.db.d)).astype(np.float32)
    cols = {name: c.values[src] for name, c in kg.db.columns.items()}
    nulls = {name: c.null_mask[src] for name, c in kg.db.columns.items() if c.kind != "setcat"}
    dead_base = rng.choice(kg.db.n, inserts // 10, replace=False)
    row: dict = {"n": kg.db.n, "queries": wl.m, "inserts": inserts}

    def both(tag, burst=False):
        got = [service_stream(s, wl, burst=burst) for s in svcs]
        agree(SearchResult(ids=got[0]["ids"], scores=got[0]["scores"]),
              SearchResult(ids=got[1]["ids"], scores=got[1]["scores"]), f"service stream {tag}")
        if not np.array_equal(got[0]["degraded"], got[1]["degraded"]):
            raise AssertionError(f"service stream {tag}: the two sides shed different flushes")
        row[tag] = {"card_seconds": got[0]["seconds"], "cpu_seconds": got[1]["seconds"],
                    "degraded_queries": int(got[0]["degraded"].sum())}

    both("A")
    for s in svcs:
        ids = s.insert(vecs, cols, nulls)
        s.delete(dead_base)
        s.delete(np.random.default_rng(2).choice(ids, inserts // 10, replace=False))
    both("B")
    if svcs[0].refresh() != svcs[1].refresh():
        raise AssertionError("refresh folded different row counts")
    both("C")
    for s in svcs:
        s.cfg.overload_queue_depth = burst_depth
    both("burst", burst=True)
    if not row["burst"]["degraded_queries"]:
        raise AssertionError("the burst did not shed to PQ")

    card = svcs[0]
    card.cfg.overload_queue_depth = None  # exact from here on
    try:
        Compactor(card, root, keep_generations=1).compact_once(force=True)
        tail = rng.integers(0, kg.db.n, 256)
        card.insert(kg.db.vectors[tail] + 0.01, {name: c.values[tail] for name, c in kg.db.columns.items()})
        card.delete(rng.choice(kg.db.n, 64, replace=False))
        records = card.wal.last_seq - card._wal_folded_seq
        opened = open_service(root, cfg=ServiceConfig(**cfg), device="cpu")
        got = [service_stream(s, wl) for s in (card, opened)]
        agree(SearchResult(ids=got[0]["ids"], scores=got[0]["scores"]),
              SearchResult(ids=got[1]["ids"], scores=got[1]["scores"]), "the store opened on the CPU")
        card.wal.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["store_opened_on_cpu"] = {"wal_tail_records": records, "delta_rows": opened.delta.n,
                                  "cpu_seconds": got[1]["seconds"]}
    get_registry().detach_source("service")  # the registry's sources hold the services
    get_registry().detach_source("health")
    get_registry().detach_source("compactor")
    row["seconds"] = time.perf_counter() - t_phase
    rec["service_card_vs_cpu"] = row
    log("[service card-vs-cpu] every stream agrees: " + json.dumps(row))


# ------------------------------------------------------------ ADC kernels


def adc_bound(codes, valid, k: int, q_live, lut_rows: int) -> dict:
    """Least time (ms) of an ADC scan on these inputs, counting only what
    this data needs. Bytes over HBM: the codes of the valid rows (M bytes
    each), the mask of each unit holding a real query, each distinct LUT row
    the real slots index read once (M·1 KiB; ``lut_rows`` of them), and the
    output the function writes: every slot's top-k (W·TQ·k·8 bytes, padding
    slots included). Operations over the fp32 peak: M adds per (real query,
    valid row of its unit). Beside it, the LUT bytes streamed per (unit,
    real slot), the count of the reference's profiler, and the lookup bound:
    the M lookups a (real query, valid row) at one 4-byte shared-memory read
    a bank a clock (``SMEM_LOOKUPS_PER_S``), what a design that gathers from
    a staged LUT can reach."""
    W, TV, M = codes.shape
    nq_w = q_live.sum(1).double()
    nv_w = valid.sum(1).double()
    n_q, n_v = float(nq_w.sum()), float(nv_w.sum())
    n_units = int((nq_w > 0).sum())
    lut_row_bytes = M * 256 * 4
    nbytes = n_v * M + n_units * TV + lut_rows * lut_row_bytes + q_live.numel() * k * 8
    ops_ = float(M) * float((nq_w * nv_w).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "lut_streamed_bytes": n_q * lut_row_bytes,
            "lookup_bound_ms": ops_ / SMEM_LOOKUPS_PER_S * 1e3,
            "valid_rows": int(n_v), "real_query_slots": int(n_q), "lut_rows": int(lut_rows)}


def lut_staging(lut_idx, table_rows: int, tv: int, m: int) -> dict:
    """What the LUT-stationary units kernel stages for these slots: one LUT
    row per (block, run of one row), M·1 KiB each."""
    from repro_torch.kernels import pq_scan as adc

    p, g = adc.units_split(tv)
    rows = adc.staged_lut_rows(adc.slot_order(lut_idx)[0], table_rows, p)
    return {"slots_per_block": p, "warps_per_slot": g, "blocks": -(-lut_idx.numel() // p),
            "staged_lut_rows": rows, "staged_lut_bytes": rows * m * 256 * 4}


def adc_yardstick(luts, codes, valid, k: int):
    """``torch.gather`` + sum + masked ``torch.topk`` over expanded LUTs
    [W, TQ, M, 256]: the library's way to the same top-k (tie order aside),
    timed beside the kernels and used nowhere else."""
    import torch

    W, TQ, M, _ = luts.shape
    idx = codes.permute(0, 2, 1).long()[:, None].expand(W, TQ, M, codes.shape[1])
    s = torch.gather(luts, 3, idx).sum(2)
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    return torch.topk(s, k, dim=-1)


def adc_yardstick_one(lut, codes, valid, k: int):
    """The one-query yardstick: gather + sum + masked ``torch.topk``."""
    import torch

    s = torch.gather(lut, 1, codes.t().long()).sum(0)
    return torch.topk(s.masked_fill(~valid, NEG_INF), k)


def exact(got, want, what: str) -> None:
    """The card and the plain version agree bit for bit (same sums in the
    same order, same ranks)."""
    import torch

    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{what}: the kernel and its plain version differ")


def lut_stationary_cases(gen, check) -> list:
    """The LUT-stationary units kernel (``workunit_pq_scan_streamed``) on the
    engine's heaviest bucket shape [16384, 64, 64, 8, 40] with a quarter of
    the slots real (rows drawn from 10,000 queries' tables), the same with
    every real slot on one row, every slot padding (-1), and k′ 64 at TV
    4096: bit-equal to the plain version, timed beside the bound, the plain
    version and the yardstick."""
    import torch

    from repro_torch.kernels import pq_scan as adc

    rows = []
    U = 10_000
    for label, W, TV, k in (("heavy", 16384, 64, 40), ("hot_row", 16384, 64, 40),
                            ("all_padding", 16384, 64, 40), ("k64_tv4096", 256, 4096, 64)):
        TQ, M = 64, 8
        table = torch.randn((U, M, 256), generator=gen, device="cuda")
        lut_idx = torch.randint(0, U, (W, TQ), generator=gen, device="cuda", dtype=torch.int32)
        if label == "hot_row":
            lut_idx[:] = 7
        lut_idx[torch.rand((W, TQ), generator=gen, device="cuda") >= 0.25] = -1
        if label == "all_padding":
            lut_idx[:] = -1
        codes = torch.randint(0, 256, (W, TV, M), generator=gen, device="cuda", dtype=torch.uint8)
        valid = torch.rand((W, TV), generator=gen, device="cuda") < 0.7
        q_live = lut_idx >= 0
        args = (table, lut_idx, codes, valid)
        got = adc.workunit_pq_scan_streamed(*args, k=k)
        want = adc.workunit_pq_scan_streamed_plain(*args, k=k)
        row = {"case": f"lut_stationary_{label}", "W": W, "TQ": TQ, "TV": TV, "M": M, "k": k,
               "err": check("workunit_pq_scan_streamed", got, want)}
        exact(got, want, f"workunit_pq_scan_streamed, {label}")
        del got, want
        row["ms"] = cuda_ms(lambda: adc.workunit_pq_scan_streamed(*args, k=k), reps=21)
        row["work_list_ms"] = cuda_ms(lambda: adc.slot_order(lut_idx), reps=21)
        row["plain_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_streamed_plain(*args, k=k), reps=5)
        row["yardstick_ms"] = cuda_ms(lambda: adc_yardstick(table[lut_idx.clamp(min=0).long()], codes,
                                                            valid, k), reps=5)
        row["bound"] = adc_bound(codes, valid, k, q_live, int(torch.unique(lut_idx[q_live]).numel()))
        row.update(lut_staging(lut_idx, U, TV, M))
        rows.append(row)
        log("[adc] " + json.dumps(row))
        del table, lut_idx, codes, valid, args
        torch.cuda.empty_cache()
    return rows


def dense_cases(gen, check) -> list:
    """``workunit_pq_scan`` at a delta-store shape [16, 128, 32768, M 8, k′
    40] (16 MiB of LUTs; each unit's rows split over blocks, the last block
    merging their lists in the same launch) and at M 181 [64, 64, 256, k′
    40] (one slot and one warp a block), with a ragged ``n_live`` and zero
    LUTs on the dead slots: bit-equal to the plain version, timed beside the
    bound, the launch alone, the plain version and the yardstick."""
    import torch

    from repro_torch.kernels import pq_scan as adc

    rows = []
    for label, W, TQ, TV, M in (("delta_store", 16, 128, 32768, 8), ("m181", 64, 64, 256, 181)):
        k = 40
        luts = torch.randn((W, TQ, M, 256), generator=gen, device="cuda")
        n_live = torch.randint(1, TQ + 1, (W,), generator=gen, device="cuda", dtype=torch.int32)
        live = torch.arange(TQ, device="cuda")[None, :] < n_live[:, None]
        luts[~live] = 0.0
        codes = torch.randint(0, 256, (W, TV, M), generator=gen, device="cuda", dtype=torch.uint8)
        valid = torch.rand((W, TV), generator=gen, device="cuda") < 0.7
        args = (luts, codes, valid)
        got = adc.workunit_pq_scan(*args, k=k, n_live=n_live)
        want = adc.workunit_pq_scan_plain(*args, k=k, n_live=n_live)
        row = {"case": f"dense_{label}", "W": W, "TQ": TQ, "TV": TV, "M": M, "k": k,
               "launch_shape": adc.launch_shape(W, TQ, TV, M, k),
               "err": check("workunit_pq_scan", got, want)}
        exact(got, want, f"workunit_pq_scan, {label}")
        del got, want
        row["ms"] = cuda_ms(lambda: adc.workunit_pq_scan(*args, k=k, n_live=n_live), reps=11)
        row["device_ms"] = device_ms(lambda: adc.workunit_pq_scan(*args, k=k, n_live=n_live),
                                     "adc_slot_warps_kernel")
        row["plain_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_plain(*args, k=k, n_live=n_live), reps=3)
        row["yardstick_ms"] = cuda_ms(lambda: adc_yardstick(*args, k), reps=3)
        row["bound"] = adc_bound(codes, valid, k, live, int(live.sum()))
        rows.append(row)
        log("[adc] " + json.dumps(row))
        del luts, codes, valid, args
        torch.cuda.empty_cache()
    return rows


def wide_m_cases(gen, check) -> list:
    """Both LUT-stationary kernels at M in ``WIDE_M``: past 109 the LUT row
    passes through shared memory in slices (``lut_stationary_slice``). The
    units kernel at [4096, 64, 64, M, 40] (a quarter of the slots real, rows
    from a 1,000-row table) and ``pq_scan`` at NV 10^5, k 40: bit-equal to
    their plain versions, a call (CUDA events) and the launch alone
    (profiler) beside the bound and the plain version; M 8 is the same
    shapes' yardstick for the slicing's cost."""
    import torch

    from repro_torch.kernels import pq_scan as adc

    rows = []
    W, TQ, TV, U, NV, k = 4096, 64, 64, 1000, 100_000, 40
    for M in WIDE_M:
        table = torch.randn((U, M, 256), generator=gen, device="cuda")
        lut_idx = torch.randint(0, U, (W, TQ), generator=gen, device="cuda", dtype=torch.int32)
        lut_idx[torch.rand((W, TQ), generator=gen, device="cuda") >= 0.25] = -1
        codes = torch.randint(0, 256, (W, TV, M), generator=gen, device="cuda", dtype=torch.uint8)
        valid = torch.rand((W, TV), generator=gen, device="cuda") < 0.7
        args = (table, lut_idx, codes, valid)
        got = adc.workunit_pq_scan_streamed(*args, k=k)
        want = adc.workunit_pq_scan_streamed_plain(*args, k=k)
        row = {"case": f"wide_m_units_m{M}", "W": W, "TQ": TQ, "TV": TV, "M": M, "k": k,
               "lut_slice": adc.lut_stationary_slice(M),
               "err": check("workunit_pq_scan_streamed", got, want)}
        exact(got, want, f"workunit_pq_scan_streamed at M {M}")
        del got, want
        row["ms"] = cuda_ms(lambda: adc.workunit_pq_scan_streamed(*args, k=k), reps=11)
        row["device_ms"] = device_ms(lambda: adc.workunit_pq_scan_streamed(*args, k=k),
                                     "lut_stationary_units_kernel")
        row["plain_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_streamed_plain(*args, k=k), reps=3)
        q_live = lut_idx >= 0
        row["bound"] = adc_bound(codes, valid, k, q_live, int(torch.unique(lut_idx[q_live]).numel()))
        row["ms_over_bound"] = row["ms"] / row["bound"]["bound_ms"]
        rows.append(row)
        log("[adc wide M] " + json.dumps(row))
        del table, lut_idx, codes, valid, args

        lut = torch.randn((M, 256), generator=gen, device="cuda")
        codes = torch.randint(0, 256, (NV, M), generator=gen, device="cuda", dtype=torch.uint8)
        valid = torch.rand((NV,), generator=gen, device="cuda") < 0.7
        got, want = adc.pq_scan(lut, codes, valid, k=k), adc.pq_scan_plain(lut, codes, valid, k=k)
        row = {"case": f"wide_m_rows_m{M}", "NV": NV, "M": M, "k": k,
               "lut_slice": adc.lut_stationary_slice(M), "err": check("pq_scan", got, want)}
        exact(got, want, f"pq_scan at M {M}")
        row["ms"] = cuda_ms(lambda: adc.pq_scan(lut, codes, valid, k=k))
        row["device_ms"] = device_ms(lambda: adc.pq_scan(lut, codes, valid, k=k), "lut_stationary_rows_kernel")
        row["plain_ms"] = cuda_ms(lambda: adc.pq_scan_plain(lut, codes, valid, k=k), reps=5)
        row["bound"] = adc_bound(codes[None], valid[None], k, torch.ones((1, 1), dtype=torch.bool,
                                 device="cuda"), 1)
        row["ms_over_bound"] = row["ms"] / row["bound"]["bound_ms"]
        rows.append(row)
        log("[adc wide M] " + json.dumps(row))
        del lut, codes, valid
        torch.cuda.empty_cache()
    return rows


def phase_adc_kernels(rec: dict, max_err: dict) -> None:
    import torch

    from repro_torch.kernels import pq_scan as adc

    gen = torch.Generator(device="cuda").manual_seed(1)
    W, TQ, U = 256, 64, 4096
    pad = TQ // 8  # the last eighth of each unit's slots is padding (LUT row 0)
    q_live = torch.ones((W, TQ), dtype=torch.bool, device="cuda")
    q_live[:, TQ - pad:] = False
    rows = []

    def check(name, got, want):
        torch.cuda.synchronize()
        err = compare(got, want, 1e-4)
        max_err[name] = max(max_err[name], err)
        return err

    for M in (8, 16):
        table = torch.randn((U, M, 256), generator=gen, device="cuda")
        for tv in (32, 128, 512, 1024, 4096):
            codes = torch.randint(0, 256, (W, tv, M), generator=gen, device="cuda", dtype=torch.uint8)
            valid = torch.rand((W, tv), generator=gen, device="cuda") < 0.7
            lut_idx = torch.randint(0, U, (W, TQ), generator=gen, device="cuda", dtype=torch.int32)
            lut_idx[:, TQ - pad:] = 0
            luts = table[lut_idx.long()]
            distinct = int(torch.unique(lut_idx[q_live]).numel())
            # the expanded LUTs' live slots: a ragged count per unit
            n_live = torch.randint(0, TQ + 1, (W,), generator=gen, device="cuda", dtype=torch.int32)
            live = torch.arange(TQ, device="cuda")[None, :] < n_live[:, None]
            for k in sorted({10, min(40, tv)}):  # k <= TV
                want = adc.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k)
                row = {"case": "sweep", "W": W, "TQ": TQ, "TV": tv, "M": M, "k": k}
                row["streamed_err"] = check("workunit_pq_scan_streamed",
                                            adc.workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=k), want)
                got = adc.workunit_pq_scan(luts, codes, valid, k=k, n_live=n_live)
                want = adc.workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
                row["expanded_err"] = check("workunit_pq_scan", got, want)
                exact(got, want, f"workunit_pq_scan at TV {tv}, M {M}, k {k}, ragged n_live")
                del got, want
                row["streamed_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=k), reps=15)
                row["expanded_ms"] = cuda_ms(lambda: adc.workunit_pq_scan(luts, codes, valid, k=k, n_live=n_live), reps=15)
                row["streamed_plain_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k), reps=15)
                row["expanded_plain_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live), reps=15)
                row["streamed_yardstick_ms"] = cuda_ms(lambda: adc_yardstick(table[lut_idx.long()], codes, valid, k), reps=15)
                row["expanded_yardstick_ms"] = cuda_ms(lambda: adc_yardstick(luts, codes, valid, k), reps=15)
                row["streamed_bound"] = adc_bound(codes, valid, k, q_live, distinct)
                row["expanded_bound"] = adc_bound(codes, valid, k, live, int(live.sum()))
                rows.append(row)
                log("[adc] " + json.dumps(row))
            del luts

    # masks the kernels must get exactly right, for all three wrappers
    table = torch.randn((U, 8, 256), generator=gen, device="cuda")
    lut_idx = torch.randint(0, U, (W, TQ), generator=gen, device="cuda", dtype=torch.int32)
    codes = torch.randint(0, 256, (W, 1024, 8), generator=gen, device="cuda", dtype=torch.uint8)
    luts = table[lut_idx.long()]
    none = torch.zeros((W, 1024), dtype=torch.bool, device="cuda")
    few = none.clone()
    few[:, [3, 700, 1001]] = True
    two = none.clone()
    two[:, [3, 700]] = True
    for label, valid, k in (("all_invalid", none, 10), ("k_above_valid", few, 40), ("two_valid", two, 4)):
        want = adc.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k)
        outs = {
            "workunit_pq_scan_streamed": adc.workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=k),
            "workunit_pq_scan": adc.workunit_pq_scan(luts, codes, valid, k=k),
        }
        for name, got in outs.items():
            check(name, got, want)
        lut0 = table[int(lut_idx[0, 0])]
        got5 = adc.pq_scan(lut0, codes[0], valid[0], k=k)
        check("pq_scan", got5, adc.pq_scan_plain(lut0, codes[0], valid[0], k=k))
        if label == "two_valid":
            for name, (s, i) in list(outs.items()) + [("pq_scan", got5)]:
                ids = i.cpu().numpy()
                if not ((ids[..., 2:] == -1).all()
                        and (s[..., 2:].cpu().numpy() == np.float32(NEG_INF)).all()
                        and set(np.unique(ids[..., :2]).tolist()) == {3, 700}):
                    raise AssertionError(f"{name}: unfilled slots are not (NEG_INF, -1)")
        log(f"[adc] {label}: all three ADC wrappers match their plain versions")
    del luts

    rows += lut_stationary_cases(gen, check)
    rows += dense_cases(gen, check)
    rows += wide_m_cases(gen, check)

    for nv in (10_000, 100_000, 1_000_000):
        lut = torch.randn((8, 256), generator=gen, device="cuda")
        codes = torch.randint(0, 256, (nv, 8), generator=gen, device="cuda", dtype=torch.uint8)
        valid = torch.rand((nv,), generator=gen, device="cuda") < 0.7
        k = 40
        row = {"case": "one_query", "NV": nv, "M": 8, "k": k}
        got, want = adc.pq_scan(lut, codes, valid, k=k), adc.pq_scan_plain(lut, codes, valid, k=k)
        row["err"] = check("pq_scan", got, want)
        exact(got, want, f"pq_scan at NV {nv}")
        row["ms"] = cuda_ms(lambda: adc.pq_scan(lut, codes, valid, k=k))
        row["device_ms"] = device_ms(lambda: adc.pq_scan(lut, codes, valid, k=k), "lut_stationary_rows_kernel")
        row["plain_ms"] = cuda_ms(lambda: adc.pq_scan_plain(lut, codes, valid, k=k))
        row["yardstick_ms"] = cuda_ms(lambda: adc_yardstick_one(lut, codes, valid, k))
        row["bound"] = adc_bound(codes[None], valid[None], k, torch.ones((1, 1), dtype=torch.bool,
                                 device="cuda"), 1)
        rows.append(row)
        log("[adc] " + json.dumps(row))
    rec["adc_kernel_cases"] = rows


# ------------------------------------------------------- compressed path


def counters():
    """Every kernel wrapper's launch count and every plain version's call
    count, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_knn as fk
    from repro_torch.kernels import pq_scan as adc

    return {
        "fused_knn": fk.fused_knn, "fused_knn_db_stationary": fk.fused_knn_db_stationary,
        "workunit_pq_scan_streamed": adc.workunit_pq_scan_streamed,
        "workunit_pq_scan": adc.workunit_pq_scan, "pq_scan": adc.pq_scan,
        "flash_attention": fa.flash_attention, "adc_wide_m": adc.adc_wide_m,
        "flash_attention_wide": fa.flash_attention_wide,
        "flash_attention_backward": fa.flash_attention_backward,
    }, {
        "fused_knn_plain": fk.fused_knn_plain,
        "workunit_pq_scan_streamed_plain": adc.workunit_pq_scan_streamed_plain,
        "workunit_pq_scan_plain": adc.workunit_pq_scan_plain, "pq_scan_plain": adc.pq_scan_plain,
        "flash_attention_plain": fa.flash_attention_plain,
        "flash_attention_backward_plain": fa.flash_attention_backward_plain,
    }


def zero_counters() -> None:
    kernels, plains = counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains.values():
        fn.calls = 0


def read_counters() -> dict:
    kernels, plains = counters()
    out = {n: fn.launches for n, fn in kernels.items()}
    out.update({n: fn.calls for n, fn in plains.items()})
    return out


def phase_pq_main(rec: dict, main: dict) -> dict:
    import torch

    from repro_torch.core import HQIConfig, HQIIndex, recall_at_k
    from repro_torch.kernels import ops

    kg, wl, truth = main["kg"], main["wl"], main["truth"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(scan_mode="pq"), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    times = []
    for i in range(4):  # one cold (arena upload + encode), three warm; the last one is counted
        if i == 3:
            zero_counters()
            before = ops.dispatch_stats().snapshot()
        t0 = time.perf_counter()
        res = index.search(wl, nprobe=8)
        times.append(time.perf_counter() - t0)
    counts = read_counters()
    delta = ops.dispatch_stats().delta_since(before)
    warm_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    log(f"[pq] build {build_s:.3f} s ({index.build_info}); {len(index.partitions)} partitions")
    log(f"[pq] search cold {times[0]:.3f} s, warm {[round(t, 4) for t in times[1:]]} s: "
        f"{wl.m / warm_s:.1f} queries/s warm (median)")
    log(f"[pq] one warm search: counts {counts}; dispatch knn_calls={delta.knn_calls} "
        f"merge_calls={delta.merge_calls} shapes={sorted(delta.shapes, key=str)} "
        f"lut_expand_bytes={delta.lut_expand_bytes} lut_bytes={res.lut_bytes} "
        f"bytes_scanned={res.bytes_scanned} peak_candidate_bytes={res.peak_candidate_bytes}; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if counts["workunit_pq_scan_streamed"] <= 0 or counts["fused_knn_db_stationary"] <= 0:
        raise AssertionError(f"a kernel of the PQ path was never launched: {counts}")
    plain = {n: c for n, c in counts.items() if n.endswith("_plain") and c}
    if plain:
        raise AssertionError(f"a plain version ran on the PQ path: {plain}")
    if delta.lut_expand_bytes != 0:
        raise AssertionError(f"the segmented PQ path expanded LUTs: {delta.lut_expand_bytes} bytes")
    check_results(kg, wl, res)
    recall = recall_at_k(res, truth)
    t0 = time.perf_counter()
    exact = index.search(wl, nprobe=8, scan_mode="f32")
    f32_s = time.perf_counter() - t0
    recall_f32 = recall_at_k(res, exact)
    log(f"[pq] recall@10 {recall:.4f} against exhaustive_search, {recall_f32:.4f} against "
        f"the same index searched with scan_mode='f32' ({f32_s:.3f} s)")
    traced_s, spans = traced_search(index, wl, "pq")
    prof_s, busy_s, top, _ = profiled_search(index, wl, "pq")
    rec["pq_path"] = {
        "n": MAIN_ROWS, "d": 64, "queries": wl.m, "partitions": len(index.partitions),
        "build_seconds": build_s, "build_info": str(index.build_info),
        "search_seconds_cold": times[0], "search_seconds_warm": times[1:],
        "qps_warm": wl.m / warm_s, "recall_at_10": recall, "recall_at_10_vs_f32": recall_f32,
        "f32_search_seconds": f32_s, "counts": counts, "knn_calls": delta.knn_calls,
        "merge_calls": delta.merge_calls, "shapes": sorted(delta.shapes, key=str),
        "lut_expand_bytes": delta.lut_expand_bytes, "lut_bytes": res.lut_bytes,
        "bytes_scanned": res.bytes_scanned, "peak_candidate_bytes": res.peak_candidate_bytes,
        "peak_device_bytes": peak, "traced_search_seconds": traced_s, "span_ms": spans,
        "profiled_search_seconds": prof_s, "device_busy_seconds": busy_s, "device_ops_ms": top,
    }
    return {"index": index, "wl": wl, "counts": counts}


def adc_buckets(index, wl, *, resident: bool, max_err: dict, tag: str, refine_factor=None) -> dict:
    """The ADC kernel on every bucket a search gives it (resident table, or
    the dense layout's expanded LUTs with the engine's ``n_live``): checked
    against its plain version bit for bit and timed; the heaviest bucket is
    also timed plain, by the yardstick and by the profiler. On the heaviest
    dense bucket the LUT-stationary units kernel serves the same work (the
    expanded LUTs as a table of W·TQ rows, -1 on the dead slots): a second
    kernel that must give the same lists, and the time of the design the
    dense layout did not take."""
    import torch

    from repro_torch.core.ivf import ScanStats
    from repro_torch.core.plan import build_plan
    from repro_torch.core.planner import live_slots, pq_bucket_operands, resident_luts
    from repro_torch.kernels import pq_scan as adc

    name = "workunit_pq_scan_streamed" if resident else "workunit_pq_scan"
    kernel = getattr(adc, name)
    plain = getattr(adc, name + "_plain")
    wide = adc.wide_m(index.arena.pq.m)  # the wrappers hand M past 190 to adc_wide_m_kernel
    err_key = "adc_wide_m" if wide else name
    arena = index.arena
    tasks, _, _ = index._engine_tasks(wl, nprobe=8, batch_vec=True, stats=ScanStats())
    plan = build_plan(arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan)
    table, lut_pos = resident_luts(plan, arena, wl.vectors)
    kprime = (refine_factor or index.cfg.plan.refine_factor) * wl.k
    M = arena.pq.m
    buckets, heavy = [], None
    for lp in sorted(plan.buckets):
        qrow_of, _, _, lut_idx, codes, valid = pq_bucket_operands(plan, arena, lut_pos, lp)
        q_live = torch.from_numpy(qrow_of >= 0).to(arena.device)
        k = min(kprime, lp)
        kw = {"k": k}
        if resident:
            args = (table, lut_idx, codes, valid)
            lut_rows = int(torch.unique(lut_idx[q_live]).numel())
        else:  # padding slots expand row 0, as the engine's dense layout does
            luts = table.index_select(0, lut_idx.clamp(min=0).reshape(-1)).reshape(*lut_idx.shape, M, 256)
            args = (luts, codes, valid)
            kw["n_live"] = live_slots(qrow_of, arena.device)
            lut_rows = int(q_live.sum())
        got, want = kernel(*args, **kw), plain(*args, **kw)
        err = compare(got, want, 1e-4)
        exact(got, want, f"{name} on the bucket of lists padded to {lp}")
        max_err[err_key] = max(max_err[err_key], err)
        row = {"kernel": "adc_wide_m" if wide else name, "shape": [lut_idx.shape[0], lut_idx.shape[1], lp, M, k],
               "ms": cuda_ms(lambda: kernel(*args, **kw), reps=21), "max_abs_err": err}
        if not resident:
            row["launch_shape"] = adc.launch_shape(*lut_idx.shape, lp, M, k)
        del got, want
        row.update(adc_bound(codes, valid, k, q_live, lut_rows))
        if resident and not wide:
            row.update(lut_staging(lut_idx, table.shape[0], lp, M))
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
        buckets.append(row)
        log(f"[{tag}] " + json.dumps(row))
        work = lut_idx.shape[0] * lp
        if heavy is None or work > heavy[0]:
            heavy = (work, row, args, kw, q_live)
        del args
    _, row, args, kw, q_live = heavy
    row = dict(row)
    row["device_ms"] = device_ms(lambda: kernel(*args, **kw), "adc_wide_m_kernel" if wide else
                                 "lut_stationary_units_kernel" if resident else "adc_slot_warps_kernel")
    if resident:  # both units kernels sort their slots by table row first
        row["work_list_ms"] = cuda_ms(lambda: adc.slot_order(args[1]), reps=21)
    elif not resident:
        W, TQ = q_live.shape
        slots = torch.arange(W * TQ, device=arena.device, dtype=torch.int32).reshape(W, TQ)
        vargs = (args[0].reshape(W * TQ, M, 256), torch.where(q_live, slots, -1), *args[1:])
        exact(adc.workunit_pq_scan_streamed(*vargs, k=kw["k"]), kernel(*args, **kw),
              "the units kernel serving the heaviest dense bucket")
        row["variant_ms"] = cuda_ms(lambda: adc.workunit_pq_scan_streamed(*vargs, k=kw["k"]), reps=21)
    row["plain_ms"] = cuda_ms(lambda: plain(*args, **kw), reps=11)
    row["yardstick_ms"] = cuda_ms(
        lambda: adc_yardstick(args[0] if not resident else args[0][args[1].clamp(min=0).long()],
                              args[-2], args[-1], kw["k"]), reps=11)
    log(f"[{tag} heaviest] " + json.dumps(row))
    total = {"ms": sum(b["ms"] for b in buckets), "bound_ms": sum(b["bound_ms"] for b in buckets)}
    log(f"[{tag}] summed over the search's {len(buckets)} buckets: " + json.dumps(total))
    return {"heaviest": row, "buckets": buckets, "summed": total}


def rerank_dispatch(index, wl, max_err: dict) -> dict:
    """The PQ path's exact re-rank at its real shape: stage A run as the
    search runs it, then the one ``fused_knn_db_stationary`` dispatch over
    units of one query (``planner.rerank_operands``), checked against the
    plain version and timed beside its bound."""
    import torch

    from repro_torch.core.ivf import ScanStats
    from repro_torch.core.plan import build_plan
    from repro_torch.core.planner import _pq_stage_a_segmented, rerank_operands, resident_luts
    from repro_torch.kernels.fused_knn import fused_knn_db_stationary, fused_knn_plain

    arena = index.arena
    tasks, _, _ = index._engine_tasks(wl, nprobe=8, batch_vec=True, stats=ScanStats())
    plan = build_plan(arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan)
    kprime = index.cfg.plan.refine_factor * wl.k
    luts, lut_pos = resident_luts(plan, arena, wl.vectors)
    rows = _pq_stage_a_segmented(plan, arena, luts, lut_pos, kprime, stats=None)
    Q, V, valid, n_live = rerank_operands(arena, wl.vectors, rows, kprime)
    kw = dict(k=min(wl.k, kprime), metric=arena.metric, n_live=n_live)
    got, want = fused_knn_db_stationary(Q, V, valid, **kw), fused_knn_plain(Q, V, valid, **kw)
    exact(got, want, "the PQ re-rank dispatch")
    err = compare(got, want, 1e-4)
    max_err["fused_knn_db_stationary"] = max(max_err["fused_knn_db_stationary"], err)
    b_ms, b_by = bound(Q, V, valid, kw["k"], arena.metric, (n_live > 0)[:, None])
    row = {"shape": [Q.shape[0], 1, kprime, kw["k"]], "real_units": int((n_live > 0).sum()),
           "valid_rows": int(valid.sum()), "max_abs_err": err,
           "ms": cuda_ms(lambda: fused_knn_db_stationary(Q, V, valid, **kw), reps=21),
           "device_ms": device_ms(lambda: fused_knn_db_stationary(Q, V, valid, **kw), "fused_knn"),
           "plain_ms": cuda_ms(lambda: fused_knn_plain(Q, V, valid, **kw), reps=3, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by}
    log("[pq rerank] " + json.dumps(row))
    return row


def wide_pq_index() -> dict:
    """A 20k-row index of d 256 at ``pq_m`` 128 (the LUT-stationary kernels'
    row in slices): a segmented PQ search must launch kernel 3 and a
    ``PQIndex.search`` kernel 5, no plain version, each equal to the same
    index reloaded on the CPU: scores within 1e-4 and equal id sets, in the
    search but at ties at the k-th score (its exact re-rank sums 256-wide
    products in the kernel's order on the card and in torch's on the CPU,
    so two candidates a few ulps apart may trade places at the cut); the
    ADC-only ``PQIndex`` answers are bit-equal on both sides, so equal id
    sets without exception."""
    import dataclasses

    from repro_torch.core import HQIConfig, HQIIndex, PQIndex, SearchResult, kg_style
    from repro_torch.kernels import pq_scan as adc

    kg = kg_style(n=20_000, d=256, queries_per_split=1_000, seed=4)
    wl = kg.splits[1]
    gpu = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(scan_mode="pq", pq_m=128), device="cuda")
    zero_counters()
    a = gpu.search(wl, nprobe=8)
    counts = read_counters()
    b = HQIIndex.from_state(gpu.to_state(), device="cpu").search(wl, nprobe=8)
    tied = agree_untied(a.scores, a.ids, b.scores, b.ids, "d 256, pq_m 128, segmented PQ, card and CPU")
    pq_gpu = PQIndex.build(kg.db.vectors, m=128, metric=kg.db.metric, device="cuda")
    q = wl.vectors[:64]
    zero_counters()
    sa, ia = pq_gpu.search(q, 10)
    counts5 = read_counters()
    sb, ib = dataclasses.replace(pq_gpu, codes=pq_gpu.codes.cpu()).search(q, 10)
    agree(SearchResult(ids=ia, scores=sa), SearchResult(ids=ib, scores=sb), "d 256, PQIndex m 128, card and CPU")
    plain = {n: c for n, c in {**counts, **counts5}.items() if n.endswith("_plain") and c}
    if counts["workunit_pq_scan_streamed"] <= 0 or counts5["pq_scan"] != len(q) or plain:
        raise AssertionError(f"the d-256 index at M 128: kernel 3 {counts['workunit_pq_scan_streamed']}, "
                             f"kernel 5 {counts5['pq_scan']}, plain {plain}")
    out = {"n": kg.db.n, "d": 256, "pq_m": 128, "lut_slice": adc.lut_stationary_slice(128),
           "queries": wl.m, "tied_queries": tied,
           "kernel3_launches": counts["workunit_pq_scan_streamed"],
           "pq_index_queries": len(q), "kernel5_launches": counts5["pq_scan"]}
    log("[pq-card-vs-cpu] d 256 at pq_m 128 agrees: " + json.dumps(out))
    return out


def phase_pq_card_vs_cpu(rec: dict, max_err: dict) -> dict:
    """PQ at 100k rows on the card against its CPU reload: both layouts, and
    a PQIndex (one pq_scan launch per query). The dense layout's search is
    also profiled: it must launch ``adc_slot_warps_kernel`` and no merge
    kernel."""
    import torch

    from repro_torch.core import HQIConfig, HQIIndex, PQIndex, kg_style
    from repro_torch.core.pq import adc_tables
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_scan as adc

    kg = kg_style(n=100_000, d=64, seed=0)
    wl = kg.splits[1]
    gpu = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(scan_mode="pq"), device="cuda")
    state = gpu.to_state()
    a = gpu.search(wl, nprobe=8)
    cpu = HQIIndex.from_state(state, device="cpu")
    agree(a, cpu.search(wl, nprobe=8), "PQ segmented, card and CPU")
    tied8 = agree_untied(*_search_pair(gpu, wl, refine_factor=ENGINE_REFINE),
                         *_search_pair(cpu, wl, refine_factor=ENGINE_REFINE),
                         f"PQ segmented at refine_factor {ENGINE_REFINE}, card and CPU")
    del cpu
    log(f"[pq-card-vs-cpu] segmented: {wl.m} queries on a 100k-row PQ index agree; at refine_factor "
        f"{ENGINE_REFINE} too ({tied8} tied at the cut)")

    dense = dict(state, cfg=dict(state["cfg"], plan=dict(state["cfg"]["plan"], merge_layout="dense")))
    gpu_d = HQIIndex.from_state(dense, device="cuda")
    adc.workunit_pq_scan.launches = 0
    before = ops.dispatch_stats().snapshot()
    a_d = gpu_d.search(wl, nprobe=8)
    launches4 = adc.workunit_pq_scan.launches
    expand = ops.dispatch_stats().delta_since(before).lut_expand_bytes
    if launches4 <= 0 or expand <= 0:
        raise AssertionError(f"the dense layout did not run workunit_pq_scan ({launches4}, {expand})")
    agree(a_d, HQIIndex.from_state(dense, device="cpu").search(wl, nprobe=8), "PQ dense, card and CPU")
    agree(a_d, a, "PQ dense and segmented on the card")
    log(f"[pq-card-vs-cpu] dense: agree; workunit_pq_scan launched {launches4} times, "
        f"{expand} LUT bytes expanded")
    for _ in range(3):  # the profiler now and then drops a trace's launches: trace again
        _, dense_busy_s, _, dense_device_us = profiled_search(gpu_d, wl, "dense")
        names = list(dense_device_us)
        if any("adc_slot_warps_kernel" in n for n in names):
            break
    if any("merge_partials" in n for n in names) or not any("adc_slot_warps_kernel" in n for n in names):
        raise AssertionError(f"the dense search's kernels: {names}")
    dense_scan_ms = sum(us for n, us in dense_device_us.items() if "adc_slot_warps_kernel" in n) / 1e3
    dense_run = adc_buckets(gpu_d, wl, resident=False, max_err=max_err, tag="dense")
    dense_run["heaviest"]["summed_over_buckets"] = dense_run["summed"]
    del gpu_d
    torch.cuda.empty_cache()

    vecs = kg.db.vectors
    q = wl.vectors[:64]
    pq_gpu = PQIndex.build(vecs, m=8, metric=kg.db.metric, device="cuda")
    pq_cpu = PQIndex(cb=pq_gpu.cb, codes=pq_gpu.codes.cpu(), vectors=vecs)
    adc.pq_scan.launches = 0
    sa, ia = pq_gpu.search(q, 10, rerank=4)
    launches5 = adc.pq_scan.launches
    sb, ib = pq_cpu.search(q, 10, rerank=4)
    np.testing.assert_allclose(np.where(np.isfinite(sa), sa, -1e30), np.where(np.isfinite(sb), sb, -1e30),
                               rtol=1e-4, atol=1e-4)
    for r in range(len(q)):
        if set(ia[r][ia[r] >= 0].tolist()) != set(ib[r][ib[r] >= 0].tolist()):
            raise AssertionError(f"PQIndex: card and CPU disagree on query {r}")
    if launches5 != len(q):
        raise AssertionError(f"PQIndex.search launched pq_scan {launches5} times for {len(q)} queries")
    log(f"[pq-card-vs-cpu] PQIndex: {len(q)} queries (rerank=4) agree; pq_scan launched {launches5} times")
    wide = wide_pq_index()

    lut = torch.from_numpy(adc_tables(pq_gpu.cb, q[:1])[0]).cuda()
    valid = torch.ones(vecs.shape[0], dtype=torch.bool, device="cuda")
    codes, k = pq_gpu.codes, 40
    err = compare(adc.pq_scan(lut, codes, valid, k=k), adc.pq_scan_plain(lut, codes, valid, k=k), 1e-4)
    max_err["pq_scan"] = max(max_err["pq_scan"], err)
    one = {"kernel": "pq_scan", "shape": [vecs.shape[0], 8, k], "max_abs_err": err,
           "ms": cuda_ms(lambda: adc.pq_scan(lut, codes, valid, k=k)),
           "device_ms": device_ms(lambda: adc.pq_scan(lut, codes, valid, k=k), "lut_stationary_rows_kernel"),
           "plain_ms": cuda_ms(lambda: adc.pq_scan_plain(lut, codes, valid, k=k)),
           "yardstick_ms": cuda_ms(lambda: adc_yardstick_one(lut, codes, valid, k))}
    one.update(adc_bound(codes[None], valid[None], k, torch.ones((1, 1), dtype=torch.bool, device="cuda"), 1))
    one["ms_over_bound"] = one["ms"] / one["bound_ms"]
    # the scan of one 64-query PQIndex.search (rerank=4): 64 launches back to back
    luts = torch.from_numpy(adc_tables(pq_gpu.cb, q)).cuda()
    one["ms_64_queries"] = cuda_ms(lambda: [adc.pq_scan(luts[r], codes, valid, k=k) for r in range(len(q))],
                                   reps=11)
    log("[pq_scan heaviest] " + json.dumps(one))
    rec["pq_card_vs_cpu"] = {"n": 100_000, "queries": wl.m, "agree": True,
                             "dense_launches": launches4, "dense_lut_expand_bytes": expand,
                             "dense_device_busy_ms": dense_busy_s * 1e3,
                             "dense_scan_device_ms": dense_scan_ms,
                             "pq_index_queries": len(q), "pq_scan_launches": launches5,
                             "refine8_tied_queries": tied8,
                             "dense_buckets": dense_run["buckets"],
                             "dense_buckets_summed": dense_run["summed"], "wide_pq_index": wide}
    return {"workunit_pq_scan": (launches4, dense_run["heaviest"]), "pq_scan": (launches5, one)}

# ------------------------------------------------------- flash attention


def kept_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: row i (left-aligned) keeps keys in
    [max(0, i - window + 1), min(i, T - 1)] (window > 0, causal)."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(s, dtype=np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def ops_ms(flops: float, elem_size: int) -> float:
    """Least time (ms) for ``flops`` operations of products in the input
    type: bf16 at the bf16 tensor-core peak; f32 at the lesser of the fp32
    CUDA-core peak and three TF32 tensor-core passes (the f32-accurate split
    a kernel can use), TF32_FLOPS_PER_S / 3."""
    if elem_size == 2:
        return flops / BF16_FLOPS_PER_S * 1e3
    return min(flops / FP32_FLOPS_PER_S, 3.0 * flops / TF32_FLOPS_PER_S) * 1e3


def fp32_core_bound(t_bytes: float, flops: float, q):
    """The bound as priced before the TF32 rate (f32 at the fp32 CUDA-core
    peak), kept beside the bound of an f32 case; None in bf16."""
    return max(t_bytes, flops / FP32_FLOPS_PER_S * 1e3) if q.element_size() == 4 else None


def attn_bound(q, k, causal: bool, window: int) -> dict:
    """Least time (ms): q, k, v read once and o written once over HBM, or
    4·dh operations per kept pair and query head at the input type's rate
    (``ops_ms``), the larger of the two."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    nbytes = (2 * b * s * hq * dh + 2 * b * t * hkv * dh) * q.element_size()
    flops = 4.0 * dh * hq * b * kept_pairs(s, t, causal, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ms(flops, q.element_size())
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "flops": flops, "fp32_core_bound_ms": fp32_core_bound(t_bytes, flops, q)}


def sdpa(q, k, v, causal: bool, window: int):
    """``scaled_dot_product_attention`` with ``enable_gqa``: the library's one
    call for the same function (a boolean mask where a window applies),
    timed beside the kernel and used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window > 0:
        s, t = q.shape[1], k.shape[1]
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(t, device=q.device)[None, :]
        mask = j > i - window
        if causal:
            mask &= j <= i
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)


def attn_agree(got, want, label: str, max_err: dict, name: str = "flash_attention") -> tuple[float, float]:
    """The kernel's output against its plain version's: finite, elementwise
    within ATTN_TOL of the input type, and within its relative error
    ||got - want|| / ||want||. In f32 both compute in f32 and differ only in
    the order of the sums. In bf16 the kernel rounds P to bf16 before P·V,
    up to 2^-9 of each p (~1e-3 of |o| on average, so the relative error
    stays near 1e-3 against its 1e-2 limit); where a row has few effective
    keys it adds P's bf16 remainder, since one rounding of a few large
    weights could move an output that cancels to near 0 past atol. The rest
    is the outputs' own bf16 rounding, one ulp (at most 2^-7 of |o|), which
    rtol covers. Returns (max |got - want|, relative error)."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention {label}: non-finite output")
    rtol, atol, rel_tol = ATTN_TOL[got.element_size()]
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    err = float((g - w).abs().max())
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))
    if rel > rel_tol:
        raise AssertionError(f"flash_attention {label}: relative error {rel:.3e} above {rel_tol}")
    max_err[name] = max(max_err[name], err)
    return err, rel


def forward_lse_check(got, want_lse, q, k, v, causal: bool, window: int, label: str) -> float:
    """The training forward (``return_lse=True``) on the same inputs: its
    output bit-equal to the serving call's ``got`` (the lse pointer changes
    nothing else), its lse within LSE_TOL of the plain version's. Returns
    max |lse - plain lse| over the rows that keep a key."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    if not torch.equal(o, got):
        raise AssertionError(f"flash_attention {label}: the output with lse differs from the serving output")
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=LSE_TOL[q.element_size()])
    live = want_lse > fa.NEG_INF / 2
    return float((lse - want_lse).abs()[live].max()) if live.any() else 0.0


def attn_case(rec_rows, max_err, label, q, k, v, causal, window, reps):
    """Kernel against its plain version on the same card inputs, then kernel,
    plain and the library call timed (median of ``reps``) beside the bound.
    Past dh 256 the wrapper takes the wide kernels: one launch of them, none
    of the tiled kernels."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    name = "flash_attention_wide" if fa.wide_head(q.shape[-1]) else "flash_attention"
    fn = getattr(fa, name)
    n0, t0 = fn.launches, fa.flash_attention.launches + fa.flash_attention_wide.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if fn.launches != n0 + 1 or fa.flash_attention.launches + fa.flash_attention_wide.launches != t0 + 1:
        raise AssertionError(f"flash_attention {label}: {name} was not the one launch")
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    err, rel = attn_agree(got, want, label, max_err, name)
    lse_err = forward_lse_check(got, want_lse, q, k, v, causal, window, label)
    want_abs = want.float().abs()
    median_abs = float(want_abs.flatten()[:: max(1, want_abs.numel() // (1 << 24))].median())
    del got, want, want_abs
    b, s, hq, dh = q.shape
    row = {"case": label, "shape": [b, s, k.shape[1], hq, k.shape[2], dh], "dtype": str(q.dtype),
           "causal": causal, "window": window, "max_abs_err": err, "rel_err": rel,
           "median_abs_out": median_abs, "lse_max_abs_err": lse_err,
           "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
                         reps=reps, warmup=1),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window),
                               reps=reps, warmup=1)}
    try:
        row["library_ms"] = cuda_ms(lambda: sdpa(q, k, v, causal, window), reps=reps, warmup=1)
    except (RuntimeError, torch.OutOfMemoryError) as e:  # a shape the library cannot run
        row["library_ms"] = None
        row["library_note"] = f"scaled_dot_product_attention failed: {type(e).__name__}: {str(e)[:160]}"
        torch.cuda.empty_cache()
    row.update(attn_bound(q, k, causal, window))
    row["ms_over_bound"] = row["ms"] / row["bound_ms"]
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    if row["library_ms"]:
        row["ms_over_library"] = row["ms"] / row["library_ms"]
    rec_rows.append(row)
    log("[attn] " + json.dumps(row))
    return row


def phase_attention_kernels(rec: dict, max_err: dict) -> dict:
    """The sweep: gemma3 heads (32/16, dh 128, bf16) at S in {1024, 4096,
    32768} x window in {0, 1024}; minicpm (36/36, dh 64) and qwen3 (64/8, dh
    128) heads at 4096; small bf16 shapes: dh 80, dh 36 (padded to 40 by the
    wrapper), a GQA group of 8 on one KV head; small f32 shapes: ragged S,
    not causal, a window below the 64-key tile. Returns the rows by label."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)

    def qkv(b, s, hq, hkv, dh, dtype, t=None):
        t = s if t is None else t
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh)))

    rows: list = []
    out = {}
    for s in (1024, 4096, 32768):
        q, k, v = qkv(1, s, 32, 16, 128, torch.bfloat16)
        for w in (0, 1024):
            out[f"gemma3-s{s}-w{w}"] = attn_case(rows, max_err, f"gemma3-s{s}-w{w}", q, k, v, True, w,
                                                 3 if s > 4096 else 10)
            if s == 4096:  # the launch alone, from the profiler (the kernels line's row)
                out[f"gemma3-s{s}-w{w}"]["device_ms"] = device_ms(
                    lambda: fa.flash_attention(q, k, v, causal=True, window=w), "flash_fwd_wgmma_kernel")
        del q, k, v
        torch.cuda.empty_cache()
    for label, hq, hkv, dh in (("minicpm", 36, 36, 64), ("qwen3", 64, 8, 128)):
        q, k, v = qkv(1, 4096, hq, hkv, dh, torch.bfloat16)
        out[f"{label}-s4096"] = attn_case(rows, max_err, f"{label}-s4096-w0", q, k, v, True, 0, 10)
    for label, b, s, t, hq, hkv, dh, causal, w in (
        ("bf16-dh80-window", 1, 1000, 1000, 8, 2, 80, True, 100),
        ("bf16-dh36-ragged", 2, 777, 777, 4, 4, 36, True, 0),
        ("bf16-gqa8-one-kv-head", 1, 1030, 1030, 8, 1, 128, True, 0),
    ):
        q, k, v = qkv(b, s, hq, hkv, dh, torch.bfloat16, t)
        attn_case(rows, max_err, label, q, k, v, causal, w, 5)
    for label, b, s, t, hq, hkv, dh, causal, w in (
        ("f32-ragged", 2, 1000, 1000, 8, 2, 128, True, 0),
        ("f32-ragged-window", 1, 777, 777, 4, 4, 64, True, 100),
        ("f32-not-causal", 2, 300, 300, 8, 4, 64, False, 0),
        ("f32-window-below-tile", 1, 2000, 2000, 8, 2, 128, True, 16),
        ("f32-s-below-t", 1, 200, 500, 4, 2, 64, True, 0),
    ):
        q, k, v = qkv(b, s, hq, hkv, dh, torch.float32, t)
        attn_case(rows, max_err, label, q, k, v, causal, w, 5)
    rec["attention_kernel_cases"] = rows
    return out


def profiled_prefill(params, cfg, prompt) -> dict:
    """One prefill under torch.profiler: device busy share and the largest
    device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    toks = torch.as_tensor(prompt[None], device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = api.serve_prefill(params, cfg, {"tokens": toks})
        logits.sum().item()
        wall = time.perf_counter() - t0
    busy, top, device_us = device_split(prof, n=10)
    # both kernels' symbols: flash_fwd_wgmma_kernel (bf16), flash_fwd_tf32x3_kernel (f32)
    flash_ms = sum(v for k, v in device_us.items() if "flash_fwd" in k) / 1e3
    if flash_ms <= 0:
        raise AssertionError("profiled prefill: no flash_fwd kernel in the device trace")
    out = {"tokens": len(prompt), "wall_seconds": wall, "device_busy_seconds": busy,
           "busy_share": busy / wall, "flash_kernel_ms": flash_ms,
           "flash_share_of_busy": flash_ms / 1e3 / busy, "device_ops_ms": top}
    log(f"[serve] profiled prefill of {len(prompt)} tokens: {wall:.3f} s, device busy "
        f"{busy * 1e3:.1f} ms ({busy / wall:.2%}); flash kernel {flash_ms:.1f} ms "
        f"({out['flash_share_of_busy']:.2%} of busy); top device ops (ms) " + json.dumps(top))
    return out


def profiled_decode(params, cfg, cache) -> dict:
    """One full-slot decode step on the server's cache under torch.profiler:
    wall time, device busy share and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    toks = torch.full((cache["len"].shape[0],), 2, dtype=torch.int32, device="cuda")
    cache = dict(cache, len=torch.full_like(cache["len"], cache["k"].shape[2] - 1))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = api.serve_decode(params, cfg, toks, cache)
        logits.sum().item()
        wall = time.perf_counter() - t0
    busy, top, _ = device_split(prof)
    log(f"[serve] profiled decode step ({cache['len'].shape[0]} slots at {cache['k'].shape[2]} "
        f"cached positions): {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
        f"({busy / wall:.2%}); top device ops (ms) " + json.dumps(top))
    return {"wall_seconds": wall, "device_busy_seconds": busy, "busy_share": busy / wall,
            "device_ops_ms": top}


def phase_serving(rec: dict, max_err: dict) -> dict:
    """gemma3-27b at full width (d 5376, 32/16 heads, dh 128, d_ff 21504,
    vocab 262144, 1024-token windows on five of six layers) in bf16, depth
    cut to 12 layers, random weights from a seeded generator on the card:
    SlotServer with 4 slots serves 8 requests of 1100-4096 tokens, 16 new
    tokens each. Counters are zeroed before the run and read after it: one
    kernel launch per prefill layer, no plain call."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.attention import qkv_project
    from repro_torch.models.layers import mlp, rmsnorm
    from repro_torch.models.transformer import embed_tokens, logits_of
    from repro_torch.serve.server import Request, SlotServer

    cfg = dataclasses.replace(get_config("gemma3-27b"), n_layers=LM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.count_params(params)
    log(f"[serve] gemma3-27b, {LM_LAYERS} of 62 layers, {n_params / 1e9:.2f} B parameters "
        f"drawn in {init_s:.1f} s; windows {cfg.layer_windows()}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=LM_NEW) for i, n in enumerate(LM_PROMPTS)]
    srv = SlotServer(params, cfg, n_slots=LM_SLOTS, max_len=max(LM_PROMPTS) + LM_NEW)
    spent = {"admit": 0.0, "tick": 0.0, "ticks": 0, "decoded": 0}
    admit, tick = srv.admit, srv.tick

    def timed_admit(req):
        t = time.perf_counter()
        ok = admit(req)  # ends in a host read of the first token
        spent["admit"] += time.perf_counter() - t
        return ok

    def timed_tick():
        busy = sum(r is not None for r in srv.slot_req)
        t = time.perf_counter()
        tick()  # ends in a host read of the next tokens
        spent["tick"] += time.perf_counter() - t
        spent["ticks"] += 1
        spent["decoded"] += busy

    srv.admit, srv.tick = timed_admit, timed_tick
    zero_counters()
    t0 = time.perf_counter()
    srv.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()
    want = len(reqs) * LM_LAYERS
    if counts["flash_attention"] != want or counts["flash_attention_plain"] != 0:
        raise AssertionError(f"serving: flash_attention launched {counts['flash_attention']} "
                             f"times (want {want}), plain called {counts['flash_attention_plain']}")
    for r in reqs:
        if not (r.done and len(r.out_tokens) == LM_NEW
                and all(0 <= t < cfg.vocab for t in r.out_tokens)):
            raise AssertionError(f"request {r.rid}: {len(r.out_tokens)} tokens {r.out_tokens}")
    prompt_tokens = sum(LM_PROMPTS)
    serve = {
        "arch": "gemma3-27b", "layers": LM_LAYERS, "params": n_params, "init_seconds": init_s,
        "slots": LM_SLOTS, "requests": len(reqs), "prompt_tokens": prompt_tokens,
        "new_tokens_per_request": LM_NEW, "run_seconds": run_s,
        "prefill_seconds": spent["admit"], "prefill_tokens_per_s": prompt_tokens / spent["admit"],
        "decode_seconds": spent["tick"], "decode_ticks": spent["ticks"],
        "decoded_tokens": spent["decoded"], "decode_tokens_per_s": spent["decoded"] / spent["tick"],
        "peak_device_bytes": peak, "launches": counts["flash_attention"],
        "out_tokens_first": reqs[0].out_tokens,
    }
    log(f"[serve] {len(reqs)} requests in {run_s:.2f} s: prefill {prompt_tokens} tokens in "
        f"{spent['admit']:.3f} s ({serve['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{spent['decoded']} tokens in {spent['ticks']} ticks, {spent['tick']:.3f} s "
        f"({serve['decode_tokens_per_s']:.1f} tokens/s); flash launches {counts['flash_attention']}, "
        f"plain calls {counts['flash_attention_plain']}; peak device memory {peak / 2**30:.2f} GiB")
    serve["profile"] = profiled_prefill(params, cfg, reqs[-1].prompt)
    serve["decode_profile"] = profiled_decode(params, cfg, srv.cache)
    del srv
    torch.cuda.empty_cache()

    # Layer by layer on the first request at full width: each layer's kernel
    # output against its plain version on that layer's own q/k/v, continuing
    # with the kernel's output; the last logits give the served first token.
    toks = torch.as_tensor(reqs[0].prompt[None], device="cuda")
    x = embed_tokens(params, cfg, toks)
    s = toks.shape[1]
    positions = torch.arange(s, device="cuda")[None]
    acfg = cfg.attn_cfg()
    layers = []
    for i, (lp, w) in enumerate(zip(params["layers"], cfg.layer_windows())):
        q, k, v = qkv_project(lp["attn"], rmsnorm(x, lp["attn_norm"]), acfg, positions)
        got = fa.flash_attention(q, k, v, window=w)
        want, want_lse = fa.flash_attention_plain(q, k, v, window=w, return_lse=True)
        err, rel = attn_agree(got, want, f"layer {i}", max_err)
        forward_lse_check(got, want_lse, q, k, v, True, w, f"layer {i}")
        layers.append({"layer": i, "window": w, "max_abs_err": err, "rel_err": rel,
                       "median_abs_out": float(want.float().abs().median())})
        x = x + got.reshape(1, s, -1) @ lp["attn"]["wo"]
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["mlp_norm"]))
    first = int(torch.argmax(logits_of(params, cfg, x[:, -1:])[0, 0]))
    if first != reqs[0].out_tokens[0]:
        raise AssertionError(f"layer-by-layer prefill gives token {first}, the server "
                             f"{reqs[0].out_tokens[0]}")
    serve["layer_by_layer"] = layers
    log(f"[serve] layer by layer at {s} tokens: kernel = plain within ATTN_TOL on all "
        f"{len(layers)} layers (max |err| {max(r['max_abs_err'] for r in layers):.2e}); "
        f"first token {first} as served")
    rec["serving"] = serve
    del params, x
    torch.cuda.empty_cache()
    return serve


def phase_lm_card_vs_cpu(rec: dict) -> None:
    """Reduced gemma3 in f32, the same weights on the card and the CPU:
    prefill and decode logits within 2e-3, and the same served tokens; the
    card's server launches the kernel once per prefill layer.
    ``tests/test_torch_cuda.py`` runs this phase as a card test."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.serve.server import Request, SlotServer

    cfg = dataclasses.replace(get_reduced("gemma3-27b"), dtype=torch.float32)
    gpu = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(3))
    cpu = api.params_to(gpu, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(2, cfg.vocab, (2, 57)))
    lg, cg = api.serve_prefill(gpu, cfg, {"tokens": toks.cuda()}, max_len=64)
    lc, cc = api.serve_prefill(cpu, cfg, {"tokens": toks}, max_len=64)
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
    err = float((lg.cpu() - lc).abs().max())
    for i in range(3):
        lg, cg = api.serve_decode(gpu, cfg, toks[:, i].cuda(), cg)
        lc, cc = api.serve_decode(cpu, cfg, toks[:, i], cc)
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
        err = max(err, float((lg.cpu() - lc).abs().max()))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in (20, 60, 33, 47, 25)]
    served = []
    for params in (gpu, cpu):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        n0 = fa.flash_attention.launches
        SlotServer(params, cfg, n_slots=3, max_len=66).run(reqs)
        launched = fa.flash_attention.launches - n0
        want = len(prompts) * cfg.n_layers if params is gpu else 0
        if launched != want:
            raise AssertionError(f"reduced gemma3: {launched} kernel launches, want {want}")
        served.append([r.out_tokens for r in reqs])
    if served[0] != served[1]:
        raise AssertionError(f"reduced gemma3: card tokens {served[0]} != CPU tokens {served[1]}")
    rec["lm_card_vs_cpu"] = {"max_abs_logit_err": err, "tokens": served[0]}
    log(f"[lm-card-vs-cpu] reduced gemma3 f32: logits within {err:.2e}, 5 requests' tokens equal")


# ------------------------------------------------------ phase T: training


def bwd_bound(q, k, causal: bool, window: int) -> dict:
    """Least time (ms) of the attention backward: q, o, dO read and dq
    written ([B, S, Hq, dh] each), k, v read and dk, dv written ([B, T, Hkv,
    dh] each) over HBM; or 10·dh operations per kept pair and query head
    (five products: S recomputed, dP, dV, dQ, dK) at the input type's rate
    (``ops_ms``: in f32 the lesser of the fp32 peak and three TF32 passes).
    The larger of the two."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    nbytes = (4 * b * s * hq * dh + 4 * b * t * hkv * dh) * q.element_size()
    flops = 10.0 * dh * hq * b * kept_pairs(s, t, causal, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ms(flops, q.element_size())
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "flops": flops, "fp32_core_bound_ms": fp32_core_bound(t_bytes, flops, q)}


def bwd_rel_errors(got, want, label: str) -> list:
    """||got - want|| / ||want|| of each of dq, dk, dv; each finite and
    within BWD_TOL of the input type."""
    import torch

    rels = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"flash_attention_backward {label}: non-finite {name}")
        g, w = g.float(), w.float()
        rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))
        if rel > BWD_TOL[got[0].element_size()]:
            raise AssertionError(f"flash_attention_backward {label}: {name} relative error {rel:.3e} "
                                 f"above {BWD_TOL[got[0].element_size()]}")
        rels.append(rel)
    return rels


def bwd_case(rows, max_err, label, q, k, v, causal, window, reps, kernel_alone=False):
    """The backward kernels against their plain version on the same card
    inputs (q, k, v, the forward kernel's o and lse, a random dO): one
    launch, each gradient within BWD_TOL; then kernels, plain and the
    library's backward (``torch.autograd.grad`` through ``sdpa``, the graph
    built once) timed beside the bound; with ``kernel_alone`` also the two
    launches alone from the profiler (``device_ms``, summed)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(q.shape[1] + q.shape[-1])
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    n0, c0 = fa.flash_attention_backward.launches, fa.flash_attention_backward_plain.calls
    got = fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    if fa.flash_attention_backward.launches != n0 + 1 or fa.flash_attention_backward_plain.calls != c0:
        raise AssertionError(f"flash_attention_backward {label}: not one kernel launch")
    want = fa.flash_attention_backward_plain(q, k, v, o, do, lse, causal=causal, window=window)
    rels = bwd_rel_errors(got, want, label)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    max_err["flash_attention_backward"] = max(max_err["flash_attention_backward"], err)
    del got, want
    b, s, hq, dh = q.shape
    row = {"case": label, "shape": [b, s, k.shape[1], hq, k.shape[2], dh], "dtype": str(q.dtype),
           "causal": causal, "window": window, "max_abs_err": err, "rel_err": dict(zip(("dq", "dk", "dv"), rels)),
           "ms": cuda_ms(lambda: fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=window),
                         reps=reps, warmup=1),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_backward_plain(q, k, v, o, do, lse, causal=causal,
                                                                         window=window), reps=min(reps, 3),
                               warmup=1)}
    if kernel_alone:  # the dQ and the dK/dV launch, whichever design ran
        for name in ("bwd_dq", "bwd_dkdv"):
            row[f"{name}_device_ms"] = device_ms(
                lambda: fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=window), name, reps=5)
        row["device_ms"] = row["bwd_dq_device_ms"] + row["bwd_dkdv_device_ms"]
    try:
        leaves_ = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = sdpa(*leaves_, causal, window)
        dot = do.transpose(1, 2)
        row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves_, dot, retain_graph=True),
                                    reps=reps, warmup=1)
        del out, leaves_
    except (RuntimeError, torch.OutOfMemoryError) as e:  # a shape the library cannot run
        row["library_ms"] = None
        row["library_note"] = f"sdpa backward failed: {type(e).__name__}: {str(e)[:160]}"
    torch.cuda.empty_cache()
    row.update(bwd_bound(q, k, causal, window))
    row["ms_over_bound"] = row["ms"] / row["bound_ms"]
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    if row["library_ms"]:
        row["ms_over_library"] = row["ms"] / row["library_ms"]
    rows.append(row)
    log("[train-bwd] " + json.dumps(row))
    return row


def phase_backward_kernels(rec: dict, max_err: dict) -> dict:
    """Phase T(a): the backward kernels at minicpm's heads [2, 2048, 36/36,
    dh 64] and gemma3's [1, 4096, 32/16, dh 128] at windows 0 and 1024 in
    bf16 (the wgmma pair), minicpm's heads in f32 (the 3xTF32 pair), [1,
    2048, 8/4, dh 256] causal in bf16 (the split wgmma pair) and f32 (the
    3xTF32 pair at DH 256), row 8's shape [1, 2048, 8/4, dh 512] causal in
    bf16 (the split wgmma pair) and f32 (the wide pair), each with its
    launches alone from the profiler; f32 [1, 16384, 4/4, dh 64] causal
    (``"f32-long"``); and at BWD_SMALL in f32 (and five small bf16 widths).
    Beside minicpm's f32 backward, the f32 forward that runs with it in
    every f32 training step (``flash_fwd_tf32x3_kernel``, row 6b) on the
    same inputs: call, launch alone, plain, library, bound (its row under
    ``"f32-forward"``, in ``rec["training_forward_f32"]``); the same kernel
    at [1, 2048, 8/4, dh 256] causal (``"f32-forward-dh256"``: 16-key tiles
    beside Q's split fragments) and at [1, 16384, 4/4, dh 64] causal
    (``"f32-forward-long"``: its P·V sums over 16,384 keys), each within
    ``ATTN_TOL[4]`` and ``LSE_TOL[4]``. Returns the rows by label."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)

    def qkv(b, s, t, hq, hkv, dh, dtype):
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh)))

    rows: list = []
    out = {}
    for label, b, s, hq, hkv, dh, w in (("minicpm-s2048", 2, 2048, 36, 36, 64, 0),
                                        ("gemma3-s4096-w0", 1, 4096, 32, 16, 128, 0),
                                        ("gemma3-s4096-w1024", 1, 4096, 32, 16, 128, 1024)):
        q, k, v = qkv(b, s, s, hq, hkv, dh, torch.bfloat16)
        out[label] = bwd_case(rows, max_err, label, q, k, v, True, w, 10, kernel_alone=True)
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = qkv(2, 2048, 2048, 36, 36, 64, torch.float32)
    out["minicpm-s2048-f32"] = bwd_case(rows, max_err, "minicpm-s2048-f32", q, k, v, True, 0, 5, kernel_alone=True)
    fwd_rows: list = []
    fwd = attn_case(fwd_rows, max_err, "minicpm-s2048-f32-forward", q, k, v, True, 0, 10)
    fwd["device_ms"] = device_ms(lambda: fa.flash_attention(q, k, v, causal=True), "flash_fwd_tf32x3_kernel")
    rec["training_forward_f32"] = out["f32-forward"] = fwd
    log(f"[train-fwd] f32 forward at minicpm's heads: {fwd['ms']:.3f} ms a call, {fwd['device_ms']:.3f} the launch "
        f"alone, library {fwd['library_ms']}, bound {fwd['bound_ms']:.4f}")
    del q, k, v
    torch.cuda.empty_cache()
    for label, b, s, hq, hkv, dh in (("f32-forward-dh256", 1, 2048, 8, 4, 256), ("f32-forward-long", 1, 16384, 4, 4, 64)):
        q, k, v = qkv(b, s, s, hq, hkv, dh, torch.float32)
        row = attn_case(fwd_rows, max_err, label, q, k, v, True, 0, 10 if s <= 2048 else 5)
        row["device_ms"] = device_ms(lambda: fa.flash_attention(q, k, v, causal=True), "flash_fwd_tf32x3_kernel",
                                     reps=10 if s <= 2048 else 5)
        out[label] = row
        log(f"[train-fwd] {label}: {row['ms']:.3f} ms a call, {row['device_ms']:.3f} the launch alone, library "
            f"{row['library_ms']}, bound {row['bound_ms']:.4f}, error {row['max_abs_err']:.2e}, lse error "
            f"{row['lse_max_abs_err']:.2e}")
        del q, k, v
        torch.cuda.empty_cache()
    rec["training_forward_f32_shapes"] = fwd_rows
    for dtype, tag, dh in ((torch.bfloat16, "bf16", 256), (torch.float32, "f32", 256), (torch.bfloat16, "bf16", 512),
                           (torch.float32, "f32", 512)):
        q, k, v = qkv(1, 2048, 2048, 8, 4, dh, dtype)
        label = f"dh{dh}-{tag}"
        out[label] = bwd_case(rows, max_err, label, q, k, v, True, 0, 5 if tag == "bf16" else 3, kernel_alone=True)
        del q, k, v
        torch.cuda.empty_cache()
    # f32 at T 16384: the 3xTF32 pair's sums over keys run 2,048 k8 steps (their error grew with T while the
    # tensor core's accumulator chained them)
    q, k, v = qkv(1, 16384, 16384, 4, 4, 64, torch.float32)
    out["f32-long"] = bwd_case(rows, max_err, "f32-long", q, k, v, True, 0, 3)
    del q, k, v
    torch.cuda.empty_cache()
    for label, b, s, t, hq, hkv, dh, causal, w in BWD_SMALL:
        for dtype in (torch.float32, torch.bfloat16) if label in BWD_SMALL_BF16 else (torch.float32,):
            q, k, v = qkv(b, s, t, hq, hkv, dh, dtype)
            tag = label if dtype == torch.float32 else label.replace("f32", "bf16")
            bwd_case(rows, max_err, tag, q, k, v, causal, w, 5)
    rec["backward_kernel_cases"] = rows
    return out


def phase_training(rec: dict) -> dict:
    """Phase T(b): minicpm-2b at full width (d 2304, 36/36 heads, dh 64,
    d_ff 5760, vocab 122753), TRAIN_LAYERS layers, f32 masters, bf16
    compute, remat; AdamW on its WSD schedule as ``launch/train.py`` sets it
    for TRAIN_STEPS steps; ``SyntheticLM`` batches of TRAIN_BATCH x
    TRAIN_SEQ in TRAIN_MICRO microbatches through ``TrainLoop(...,
    device="cuda")``, one step a ``run(1)`` (its metrics read back, so the
    host clock holds the step's device work). Counters zeroed and read
    around the last step: the forward kernel 2 x layers x microbatches
    launches (remat), the backward layers x microbatches, no plain call.
    Then one step under the profiler, and ``lm_hidden_embed`` on
    EMBED_SEQS sequences of EMBED_LEN tokens with the trained weights."""
    import dataclasses
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, optimizer_for, schedule_for
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import api
    from repro_torch.models.transformer import lm_hidden_embed
    from repro_torch.train.fault_tolerance import LoopConfig, TrainLoop
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    opt = OptConfig(name=optimizer_for(TRAIN_ARCH), schedule=schedule_for(TRAIN_ARCH), peak_lr=3e-4,
                    warmup_steps=max(10, TRAIN_STEPS // 20), total_steps=TRAIN_STEPS)
    tcfg = TrainConfig(opt=opt, microbatches=TRAIN_MICRO)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    loop = TrainLoop(cfg, tcfg, dcfg, LoopConfig(ckpt_dir=tempfile.mkdtemp(), ckpt_every=0, log_every=1),
                     seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.count_params(loop.state["params"])
    log(f"[train] {TRAIN_ARCH}, {TRAIN_LAYERS} layers, {n_params / 1e9:.3f} B f32 master parameters and "
        f"AdamW state in {init_s:.1f} s; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    step_s = []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:
            zero_counters()
        t = time.perf_counter()
        loop.run(1)  # ends in a host read of the step's metrics
        step_s.append(time.perf_counter() - t)
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in loop.metrics_history]
    want_fwd = 2 * TRAIN_LAYERS * TRAIN_MICRO if cfg.remat else TRAIN_LAYERS * TRAIN_MICRO
    want_bwd = TRAIN_LAYERS * TRAIN_MICRO
    if (counts["flash_attention"] != want_fwd or counts["flash_attention_backward"] != want_bwd
            or counts["flash_attention_plain"] or counts["flash_attention_backward_plain"]):
        raise AssertionError(f"training step: forward launches {counts['flash_attention']} (want {want_fwd}), "
                             f"backward {counts['flash_attention_backward']} (want {want_bwd}), plain calls "
                             f"{counts['flash_attention_plain']}, {counts['flash_attention_backward_plain']}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: the loss did not fall: {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_s[1:])
    train = {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "params": n_params, "init_seconds": init_s,
             "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
             "optimizer": opt.name, "schedule": opt.schedule, "remat": cfg.remat,
             "losses": losses, "grad_norms": [h["grad_norm"] for h in loop.metrics_history],
             "step_seconds": step_s, "median_step_seconds": med, "tokens_per_s": tokens / med,
             "peak_device_bytes": peak, "baseline_device_bytes": base, "peak_above_baseline_bytes": peak - base,
             "launches": counts["flash_attention_backward"],
             "forward_launches": counts["flash_attention"]}
    log(f"[train] {TRAIN_STEPS} steps of {tokens} tokens: loss {losses[0]:.4f} -> {losses[-1]:.4f}; median "
        f"step {med:.3f} s ({train['tokens_per_s']:.0f} tokens/s; first {step_s[0]:.2f} s); peak device "
        f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} GiB earlier "
        f"phases hold); one step: forward kernel {counts['flash_attention']} launches, "
        f"backward {counts['flash_attention_backward']}, plain calls 0")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loop.run(1)
        wall = time.perf_counter() - t
    busy, top, device_us = device_split(prof, n=10)
    bwd_us = sum(v for name, v in device_us.items() if "bwd_dq" in name or "bwd_dkdv" in name)
    fwd_us = sum(v for name, v in device_us.items() if "flash_fwd" in name)
    if bwd_us <= 0:
        raise AssertionError("profiled training step: no backward kernel in the device trace")
    train["profile"] = {"wall_seconds": wall, "device_busy_seconds": busy, "busy_share": busy / wall,
                        "backward_kernel_ms": bwd_us / 1e3, "backward_share_of_busy": bwd_us / 1e6 / busy,
                        "forward_kernel_ms": fwd_us / 1e3, "device_ops_ms": top}
    log(f"[train] profiled step: {wall:.3f} s, device busy {busy:.3f} s ({busy / wall:.2%}); backward "
        f"kernels {bwd_us / 1e3:.1f} ms ({train['profile']['backward_share_of_busy']:.2%} of busy), forward "
        f"{fwd_us / 1e3:.1f} ms; top device ops (ms) " + json.dumps(top))

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (EMBED_SEQS, EMBED_LEN)).astype(np.int32)).cuda()
    torch.cuda.synchronize()
    t = time.perf_counter()
    vecs = torch.cat([lm_hidden_embed(loop.state["params"], cfg, toks[i:i + EMBED_CHUNK])
                      for i in range(0, EMBED_SEQS, EMBED_CHUNK)])
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t
    if vecs.shape != (EMBED_SEQS, cfg.d_model) or vecs.dtype != torch.float32 or not torch.isfinite(vecs).all():
        raise AssertionError(f"lm_hidden_embed: {tuple(vecs.shape)} {vecs.dtype}, finite "
                             f"{bool(torch.isfinite(vecs).all())}")
    train["hidden_embed"] = {"sequences": EMBED_SEQS, "tokens_each": EMBED_LEN, "chunk": EMBED_CHUNK,
                             "seconds": embed_s, "entities_per_s": EMBED_SEQS / embed_s,
                             "mean_norm": float(vecs.norm(dim=1).mean())}
    log(f"[train] lm_hidden_embed: {EMBED_SEQS} entities of {EMBED_LEN} tokens in {embed_s:.2f} s "
        f"({EMBED_SEQS / embed_s:.0f} entities/s), finite, mean norm {train['hidden_embed']['mean_norm']:.3f}")
    rec["training"] = train
    del loop, vecs, toks
    torch.cuda.empty_cache()
    return train


def phase_train_card_vs_cpu(rec: dict, out_dir: str) -> None:
    """Phase T(c), on the reduced minicpm in f32: the same master weights
    and batches on the card and the CPU give the same gradients (each leaf
    within 1e-4 of its norm: a gradient that never reached attention would
    leave wq, wk, wv at 0) and, over 3 train steps, losses within 1e-4
    relative and parameters within 1e-4. Then a ``TrainLoop`` on the card
    runs 10 steps and checkpoints, is dropped, and a new loop restores and
    runs 10 more: its losses against an uninterrupted 20-step run's (bit
    for bit, or the record says by how much)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import api
    from repro_torch.train.fault_tolerance import LoopConfig, TrainLoop
    from repro_torch.train.optimizer import OptConfig, init_opt
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.models.tree import leaves, leaves_with_paths, path_key, tree_map

    cfg = dataclasses.replace(get_reduced(TRAIN_ARCH), dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    gpu, _ = init_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(5))
    cpu = tree_map(lambda p: p.detach().cpu().requires_grad_(True), gpu)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
    on = lambda b, dev: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    grad_rel = {}
    for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
        loss, _ = api.loss_fn(params, cfg, on(data.batch(0), dev))
        loss.backward()
    for (path, g), c in zip(leaves_with_paths(gpu), leaves(cpu)):
        a, b = g.grad.cpu(), c.grad
        grad_rel[path_key(path)] = float((a - b).norm() / b.norm().clamp_min(1e-30))
        if not grad_rel[path_key(path)] <= 1e-4:
            raise AssertionError(f"train card vs CPU: gradient of {path_key(path)} off by "
                                 f"{grad_rel[path_key(path)]:.3e} of its norm")
    step = make_train_step(cfg, tcfg)
    sg, sc = init_opt(gpu, tcfg.opt), init_opt(cpu, tcfg.opt)
    losses = []
    for s in range(3):
        gpu, sg, mg = step(gpu, sg, on(data.batch(s), "cuda"))
        cpu, sc, mc = step(cpu, sc, on(data.batch(s), "cpu"))
        losses.append((float(mg["loss"]), float(mc["loss"])))
        if abs(losses[-1][0] - losses[-1][1]) > 1e-4 * abs(losses[-1][1]):
            raise AssertionError(f"train card vs CPU: step {s} loss {losses[-1]}")
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in zip(leaves(gpu), leaves(cpu)))
    if param_err > 1e-4:
        raise AssertionError(f"train card vs CPU: parameters differ by {param_err:.3e} after 3 steps")
    log(f"[train-card-vs-cpu] reduced {TRAIN_ARCH} f32: gradients within "
        f"{max(grad_rel.values()):.2e} of their norms, losses {losses}, parameters within {param_err:.2e}")

    root = os.path.join(out_dir, "train_restart")
    shutil.rmtree(root, ignore_errors=True)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    rcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=40))

    def loop(name, every):
        return TrainLoop(cfg, rcfg, dcfg, LoopConfig(ckpt_dir=os.path.join(root, name), ckpt_every=every,
                                                     log_every=1), seed=3, device="cuda")

    loop("a", 10).run(10)
    resumed = loop("a", 10)
    if not resumed.maybe_restore() or resumed.state["step"] != 10:
        raise AssertionError("train restart: no checkpoint at step 10")
    h_b = [h["loss"] for h in resumed.run(10)]
    h_c = [h["loss"] for h in loop("b", 0).run(20)][10:]
    diff = max(abs(a - b) / abs(b) for a, b in zip(h_b, h_c))
    shutil.rmtree(root, ignore_errors=True)
    rec["train_card_vs_cpu"] = {"grad_rel_max": max(grad_rel.values()), "losses_card_cpu": losses,
                                "param_max_abs_err": param_err, "restart_losses": h_b,
                                "uninterrupted_losses": h_c, "restart_bit_equal": h_b == h_c,
                                "restart_max_rel_diff": diff}
    log(f"[train-restart] 10 + restore + 10 steps against 20 uninterrupted: "
        f"{'bit-equal' if h_b == h_c else f'max relative difference {diff:.3e}'} ({h_b[-1]} vs {h_c[-1]})")
    if diff > 1e-4:
        raise AssertionError(f"train restart: losses differ by {diff:.3e} relative: {h_b} vs {h_c}")


# ------------------------------------------ the shapes the card once refused


def phase_limit_kernels(rec: dict, max_err: dict) -> None:
    """The five scan kernels past their 64-entry lists: at k′ in
    ``LIMIT_KPRIMES`` (and 64, one pass, beside them) each wrapper launches
    ceil(k′ / 64) times, each pass admitting only what ranks after the one
    before, and holds its plain version bit for bit. Shapes: both f32 entries at [1024, 64,
    512, D 64] (valid 0.4, ragged ``n_live``), the re-rank's units of one
    query [16384, 1, 400, 64] (``fused_knn_unit_warps_kernel``), the units
    kernel at [2048, 64, 512, M 8] with a quarter of the slots real, the
    dense kernel at [1024, 64, 512, 8] (ragged ``n_live``), ``pq_scan`` at NV
    10^5. A call is timed by CUDA events with all its passes; its ratio to
    the same shape's k′ 64 call is the cost of the passes."""
    import torch

    from repro_torch.kernels import fused_knn as fk
    from repro_torch.kernels import pq_scan as adc

    gen = torch.Generator(device="cuda").manual_seed(21)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def mask(*shape, p):
        return torch.rand(shape, generator=gen, device="cuda") < p

    def counts(hi, n):
        return torch.randint(0, hi + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)

    W, TQ, TV, D, M = 1024, 64, 512, 64, 8
    q, v, valid = randn(W, TQ, D), randn(W, TV, D), mask(W, TV, p=0.4)
    n_live = counts(TQ, W)
    Wr, TVr = 16384, 400
    qr, vr, valid_r = randn(Wr, 1, D), randn(Wr, TVr, D), mask(Wr, TVr, p=0.9)
    n_live_r = (torch.arange(Wr, device="cuda") < 10_000).to(torch.int32)
    Wu, U = 2048, 8192
    table = randn(U, M, 256)
    lut_idx = torch.randint(0, U, (Wu, TQ), generator=gen, device="cuda", dtype=torch.int32)
    lut_idx[:, TQ // 4:] = -1
    codes = torch.randint(0, 256, (Wu, TV, M), generator=gen, device="cuda", dtype=torch.uint8)
    valid_u = mask(Wu, TV, p=0.4)
    luts = table[lut_idx[:W].clamp(min=0).long()].contiguous()
    NV = 100_000
    lut1 = randn(M, 256)
    codes1 = torch.randint(0, 256, (NV, M), generator=gen, device="cuda", dtype=torch.uint8)
    valid1 = mask(NV, p=0.7)
    cases = (  # label, wrapper, plain, args, kwargs, bit-equal, shape
        ("fused_knn", fk.fused_knn, fk.fused_knn_plain, (q, v, valid), dict(n_live=n_live), True,
         [W, TQ, TV, D]),
        ("fused_knn_db_stationary", fk.fused_knn_db_stationary, fk.fused_knn_plain, (q, v, valid),
         dict(n_live=n_live), True, [W, TQ, TV, D]),
        ("fused_knn_db_stationary-tq1", fk.fused_knn_db_stationary, fk.fused_knn_plain, (qr, vr, valid_r),
         dict(n_live=n_live_r), True, [Wr, 1, TVr, D]),
        ("workunit_pq_scan_streamed", adc.workunit_pq_scan_streamed, adc.workunit_pq_scan_streamed_plain,
         (table, lut_idx, codes, valid_u), {}, True, [Wu, TQ, TV, M]),
        ("workunit_pq_scan", adc.workunit_pq_scan, adc.workunit_pq_scan_plain,
         (luts, codes[:W], valid_u[:W]), dict(n_live=n_live), True, [W, TQ, TV, M]),
        ("pq_scan", adc.pq_scan, adc.pq_scan_plain, (lut1, codes1, valid1), {}, True, [NV, M]),
    )
    rows = []
    for label, fn, plain, args, kw, bit_equal, shape in cases:
        one_pass_ms = None
        for kp in (64,) + LIMIT_KPRIMES:
            n0 = fn.launches
            got = fn(*args, k=kp, **kw)
            torch.cuda.synchronize()
            passes = fn.launches - n0
            if passes != fk.kernel_passes(kp):
                raise AssertionError(f"{label} at k′ {kp}: {passes} launches, want {fk.kernel_passes(kp)}")
            want = plain(*args, k=kp, **kw)
            if bit_equal:
                exact(got, want, f"{label} at k′ {kp}")
            err = compare(got, want, 1e-4)
            name = label.split("-")[0]
            max_err[name] = max(max_err[name], err)
            del got, want
            ms = cuda_ms(lambda: fn(*args, k=kp, **kw), reps=5, warmup=1)
            one_pass_ms = ms if kp == 64 else one_pass_ms
            row = {"kernel": label, "shape": shape + [kp], "k": kp, "passes": passes, "ms": ms, "over_k64": ms / one_pass_ms, "max_abs_err": err}
            rows.append(row)
            log("[limits] " + json.dumps(row))
    rec["limit_kernels"] = rows


def phase_wide_m(rec: dict, max_err: dict) -> None:
    """``adc_wide_m_kernel`` through all three wrappers at M in ``WIDE_MS``
    (k′ 40): the resident table [64, M, 256] read through ``lut_idx`` [256,
    64] (a quarter of the slots real, the rest -1) over codes [256, 256, M];
    expanded LUTs [32, 16, M, 256] with ragged ``n_live``; ``pq_scan`` over
    NV 20,000. Each is one launch of the wide kernel and none of the staged
    kernels, bit-equal to its plain version, timed (a call by CUDA events,
    the launch alone by the profiler) beside its bytes bound, its lookup
    bound and its plain version."""
    import torch

    from repro_torch.kernels import pq_scan as adc

    gen = torch.Generator(device="cuda").manual_seed(22)
    k, rows = 40, []
    for M in WIDE_MS:
        table = torch.randn((64, M, 256), generator=gen, device="cuda")
        lut_idx = torch.randint(0, 64, (256, 64), generator=gen, device="cuda", dtype=torch.int32)
        lut_idx[:, 16:] = -1
        codes = torch.randint(0, 256, (256, 256, M), generator=gen, device="cuda", dtype=torch.uint8)
        valid = torch.rand((256, 256), generator=gen, device="cuda") < 0.7
        luts = table[torch.randint(0, 64, (32, 16), generator=gen, device="cuda")].contiguous()
        n_live = torch.randint(0, 17, (32,), generator=gen, device="cuda", dtype=torch.int32)
        codes1 = torch.randint(0, 256, (20_000, M), generator=gen, device="cuda", dtype=torch.uint8)
        valid1 = torch.rand(20_000, generator=gen, device="cuda") < 0.7
        live_u, live_d = lut_idx >= 0, torch.arange(16, device="cuda")[None, :] < n_live[:, None]
        one = torch.ones((1, 1), dtype=torch.bool, device="cuda")
        cases = (
            ("workunit_pq_scan_streamed", (table, lut_idx, codes, valid), {}, [256, 64, 256, M],
             adc_bound(codes, valid, k, live_u, int(torch.unique(lut_idx[live_u]).numel()))),
            ("workunit_pq_scan", (luts, codes[:32], valid[:32]), dict(n_live=n_live), [32, 16, 256, M],
             adc_bound(codes[:32], valid[:32], k, live_d, int(live_d.sum()))),
            ("pq_scan", (table[0], codes1, valid1), {}, [20_000, M],
             adc_bound(codes1[None], valid1[None], k, one, 1)),
        )
        for name, args, kw, shape, bnd in cases:
            fn, plain = getattr(adc, name), getattr(adc, name + "_plain")
            w0, f0 = adc.adc_wide_m.launches, fn.launches
            got = fn(*args, k=k, **kw)
            torch.cuda.synchronize()
            if adc.adc_wide_m.launches != w0 + 1 or fn.launches != f0:
                raise AssertionError(f"{name} at M {M}: not one launch of adc_wide_m_kernel")
            want = plain(*args, k=k, **kw)
            exact(got, want, f"{name} at M {M} (adc_wide_m_kernel)")
            err = compare(got, want, 1e-4)
            max_err["adc_wide_m"] = max(max_err["adc_wide_m"], err)
            del got, want
            row = {"wrapper": name, "M": M, "shape": shape + [k], "max_abs_err": err,
                   "ms": cuda_ms(lambda: fn(*args, k=k, **kw), reps=5, warmup=1),
                   "device_ms": device_ms(lambda: fn(*args, k=k, **kw), "adc_wide_m_kernel", reps=5),
                   "plain_ms": cuda_ms(lambda: plain(*args, k=k, **kw), reps=3, warmup=1), **bnd}
            row["ms_over_bound"] = row["ms"] / row["bound_ms"]
            rows.append(row)
            log("[wide-m] " + json.dumps(row))
        del table, codes, luts, codes1
        torch.cuda.empty_cache()
    rec["wide_m_kernel"] = rows


def phase_wide_m_engine(rec: dict, max_err: dict) -> dict:
    """The wide-M kernel's path: a d-768 index at ``pq_m`` 192 (20,000
    ``kg_style`` rows, 1,000 queries) built on the card. Its counters are
    zeroed just before the segmented PQ search and read just after: the
    kernels line's launches (kernel 3's wrapper hands every bucket to
    ``adc_wide_m_kernel``; no plain version runs). That search, the dense
    layout's and a ``PQIndex.search`` of 64 queries each equal the same
    index reloaded on the CPU (the searches' id sets but at ties at the k-th
    score of the exact re-rank, whose products are summed in another order
    on each side; ``PQIndex``'s ADC answers exactly); then the kernel on
    every bucket of the segmented search, the heaviest timed."""
    import dataclasses

    from repro_torch.core import HQIConfig, HQIIndex, PQIndex, SearchResult, kg_style

    t0 = time.perf_counter()
    kg = kg_style(n=20_000, d=768, queries_per_split=1_000, seed=5)
    wl = kg.splits[1]
    gpu = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(scan_mode="pq", pq_m=192), device="cuda")
    state = gpu.to_state()
    zero_counters()
    a = gpu.search(wl, nprobe=8)
    counts = read_counters()
    plain = {n: c for n, c in counts.items() if n.endswith("_plain") and c}
    if counts["adc_wide_m"] <= 0 or counts["workunit_pq_scan_streamed"] != 0 or plain:
        raise AssertionError(f"the d-768 index at pq_m 192: {counts}")
    tied = agree_untied(a.scores, a.ids, *_search_pair(HQIIndex.from_state(state, device="cpu"), wl),
                        "d 768, pq_m 192, segmented PQ, card and CPU")
    dense = dict(state, cfg=dict(state["cfg"], plan=dict(state["cfg"]["plan"], merge_layout="dense")))
    zero_counters()
    a_d = HQIIndex.from_state(dense, device="cuda").search(wl, nprobe=8)
    counts_d = read_counters()
    if counts_d["adc_wide_m"] <= 0 or counts_d["workunit_pq_scan"] != 0:
        raise AssertionError(f"the d-768 index's dense layout: {counts_d}")
    tied_d = agree_untied(a_d.scores, a_d.ids, *_search_pair(HQIIndex.from_state(dense, device="cpu"), wl),
                          "d 768, pq_m 192, dense PQ, card and CPU")
    pq_gpu = PQIndex.build(kg.db.vectors, m=192, metric=kg.db.metric, device="cuda")
    q = wl.vectors[:64]
    zero_counters()
    sa, ia = pq_gpu.search(q, 10)
    counts5 = read_counters()
    if counts5["adc_wide_m"] != len(q) or counts5["pq_scan"] != 0:
        raise AssertionError(f"PQIndex at m 192: {counts5}")
    sb, ib = dataclasses.replace(pq_gpu, codes=pq_gpu.codes.cpu()).search(q, 10)
    agree(SearchResult(ids=ia, scores=sa), SearchResult(ids=ib, scores=sb), "d 768, PQIndex m 192, card and CPU")
    heavy = adc_buckets(gpu, wl, resident=True, max_err=max_err, tag="wide-m path")
    out = {"n": kg.db.n, "d": 768, "pq_m": 192, "queries": wl.m, "launches": counts["adc_wide_m"],
           "dense_launches": counts_d["adc_wide_m"], "pq_index_queries": len(q),
           "tied_queries": tied, "tied_queries_dense": tied_d, "buckets_summed": heavy["summed"],
           "seconds": time.perf_counter() - t0}
    log("[wide-m path] " + json.dumps(out))
    rec["wide_m_path"] = out
    return {"launches": counts["adc_wide_m"], "heaviest": dict(heavy["heaviest"], summed_over_buckets=heavy["summed"])}


def _search_pair(index, wl, **kw) -> tuple:
    r = index.search(wl, nprobe=8, **kw)
    return r.scores, r.ids


def phase_wide_dh(rec: dict, max_err: dict) -> dict:
    """``flash_attention_wide`` at dh in ``WIDE_DHS``: S = T = 2048, 8/4
    heads, causal, window 0 and 1024, bf16 (up to 512 ``flash_fwd_wgmma_kernel``
    at DH 384 / 512 in column slices, past it ``flash_sliced_kernel``) and
    f32 (``flash_sliced_kernel``), against the plain version (``ATTN_TOL``),
    timed beside its bound and ``scaled_dot_product_attention``; at dh 512
    without a window each type's launch also by the profiler. Then its
    path: the reduced gemma3 at head width 512 (f32, random weights from a
    seeded generator) served by ``SlotServer`` on the card and on the CPU,
    its counter zeroed before the card's run and read after: one wide launch
    per prefill layer and none of the tiled kernels, the same tokens,
    prefill and decode logits within 2e-3."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.serve.server import Request, SlotServer

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows, out = [], {}
    for dh in WIDE_DHS:
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q = torch.randn((1, 2048, 8, dh), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((1, 2048, 4, dh), generator=gen, device="cuda").to(dtype) for _ in range(2))
            for w in (0, 1024):
                label = f"dh{dh}-{tag}-w{w}"
                out[label] = attn_case(rows, max_err, label, q, k, v, True, w, 5)
                if dh == 512 and w == 0:
                    kernel = "flash_fwd_wgmma_kernel" if tag == "bf16" else "flash_sliced_kernel"
                    out[label]["device_ms"] = device_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                                                        kernel, reps=5)
    rec["wide_dh_cases"] = rows

    cfg = dataclasses.replace(get_reduced("gemma3-27b"), head_dim=512, dtype=torch.float32)
    gpu = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(5))
    cpu = api.params_to(gpu, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(2, cfg.vocab, (2, 57)))
    lg, cg = api.serve_prefill(gpu, cfg, {"tokens": toks.cuda()}, max_len=64)
    lc, cc = api.serve_prefill(cpu, cfg, {"tokens": toks}, max_len=64)
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
    err = float((lg.cpu() - lc).abs().max())
    for i in range(3):
        lg, cg = api.serve_decode(gpu, cfg, toks[:, i].cuda(), cg)
        lc, cc = api.serve_decode(cpu, cfg, toks[:, i], cc)
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
        err = max(err, float((lg.cpu() - lc).abs().max()))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in (20, 60, 33, 47, 25)]
    served = []
    for params in (gpu, cpu):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        zero_counters()
        SlotServer(params, cfg, n_slots=3, max_len=66).run(reqs)
        counts = read_counters()
        if params is gpu:
            launches = counts["flash_attention_wide"]
            if launches != len(prompts) * cfg.n_layers or counts["flash_attention"] != 0:
                raise AssertionError(f"reduced gemma3 at dh 512: launches {counts}")
        served.append([r.out_tokens for r in reqs])
    if served[0] != served[1]:
        raise AssertionError(f"reduced gemma3 at dh 512: card tokens {served[0]} != CPU tokens {served[1]}")
    rec["wide_dh_path"] = {"head_dim": 512, "layers": cfg.n_layers, "requests": len(prompts),
                           "launches": launches, "max_abs_logit_err": err, "tokens": served[0]}
    log("[wide-dh path] " + json.dumps(rec["wide_dh_path"]))
    return {"launches": launches, "heaviest": out["dh512-bf16-w0"], "f32": out["dh512-f32-w0"]}


def profiled_engine(index, wl, tag: str, **kw) -> dict:
    """One search under ``enable_profiler()`` with the h100 terms
    (``launch.roofline.current_hardware`` on this card): its answers equal
    the same search with the profiler off; coverage 1.0 (every dispatch and
    merge attributed); per (phase, mode) totals with ``frac_hbm`` and
    ``frac_peak``, neither above 1.05 (a byte count or a timing would be
    wrong)."""
    from repro_torch.launch.roofline import current_hardware
    from repro_torch.obs.profile import disable_profiler, enable_profiler

    hw = current_hardware()
    if hw.name != "h100":
        raise AssertionError(f"the profiler's terms on this card are {hw.name!r}, not h100")
    off = index.search(wl, nprobe=8, **kw)
    prof = enable_profiler()
    try:
        t0 = time.perf_counter()
        on = index.search(wl, nprobe=8, **kw)
        seconds = time.perf_counter() - t0
        rep = prof.report()
        pairs = sorted({tuple(key.split("/")[:2]) for key in rep["phases"]})
        totals = {f"{p}/{m}": prof.totals(phase=p, mode=m) for p, m in pairs}
    finally:
        disable_profiler()
    if not (np.array_equal(off.ids, on.ids) and np.array_equal(off.scores, on.scores)):
        raise AssertionError(f"{tag}: the answers differ with the profiler on")
    if rep["coverage"] != 1.0:
        raise AssertionError(f"{tag}: profiler coverage {rep['coverage']} ({rep['issued']} issued)")
    keep = ("dispatches", "device_s", "bytes", "flops", "gbps", "gflops", "frac_hbm", "frac_peak",
            "row_occupancy")
    out = {"hardware": rep["hardware"], "coverage": rep["coverage"], "issued": rep["issued"],
           "attributed": rep["attributed"], "search_seconds": seconds, "ranks": rep["ranks"],
           "totals": {pm: {key: t[key] for key in keep} for pm, t in totals.items()}}
    for pm, t in totals.items():
        if t["frac_hbm"] > 1.05 or t["frac_peak"] > 1.05:
            raise AssertionError(f"{tag} {pm}: a roofline share above 1.05: {t}")
    log(f"[profile {tag}] " + json.dumps(out))
    return out


def phase_limits_f32(rec: dict, main: dict) -> None:
    """The f32 search at k = 100 on phase 3's index: its counters zeroed and
    read around one warm search (the f32 grids launch, in passes; no plain
    version), every id passing its filter with its exact score, recall@100
    against ``exhaustive_search`` at k = 100 on the card, queries/s (median
    of two warm searches)."""
    import dataclasses

    from repro_torch.core import exhaustive_search, recall_at_k

    index, kg = main["index"], main["kg"]
    wl = dataclasses.replace(main["wl"], k=ENGINE_K)
    index.search(wl, nprobe=8)  # warm
    times = []
    for i in range(2):
        if i == 1:
            zero_counters()
        t0 = time.perf_counter()
        res = index.search(wl, nprobe=8)
        times.append(time.perf_counter() - t0)
    counts = read_counters()
    if counts["fused_knn"] + counts["fused_knn_db_stationary"] <= 0 or counts["fused_knn_plain"]:
        raise AssertionError(f"k = {ENGINE_K}: {counts}")
    check_results(kg, wl, res)
    truth = exhaustive_search(kg.db, wl, device="cuda")
    out = {"k": ENGINE_K, "queries": wl.m, "search_seconds": times,
           "qps": wl.m / statistics.median(times), "recall_at_100": recall_at_k(res, truth),
           "launches": {n: c for n, c in counts.items() if c}}
    log("[limits f32] " + json.dumps(out))
    rec["limits_f32"] = out


def phase_limits_pq(rec: dict, index, main: dict) -> None:
    """The PQ search at ``refine_factor=8`` (k′ 80) on phase 6's index: one
    warm search with its counters zeroed and read (the ADC kernel in passes
    where a bucket holds more than 64 rows, the re-rank), every id passing
    its filter with its exact score, recall@10 against the exhaustive answer,
    queries/s (median of two warm searches)."""
    from repro_torch.core import recall_at_k

    kg, wl = main["kg"], main["wl"]
    index.search(wl, nprobe=8, refine_factor=ENGINE_REFINE)  # warm
    times = []
    for i in range(2):
        if i == 1:
            zero_counters()
        t0 = time.perf_counter()
        res = index.search(wl, nprobe=8, refine_factor=ENGINE_REFINE)
        times.append(time.perf_counter() - t0)
    counts = read_counters()
    plain = {n: c for n, c in counts.items() if n.endswith("_plain") and c}
    if counts["workunit_pq_scan_streamed"] <= 0 or counts["fused_knn_db_stationary"] <= 0 or plain:
        raise AssertionError(f"refine_factor {ENGINE_REFINE}: {counts}")
    check_results(kg, wl, res)
    out = {"refine_factor": ENGINE_REFINE, "kprime": ENGINE_REFINE * wl.k, "queries": wl.m,
           "search_seconds": times, "qps": wl.m / statistics.median(times),
           "recall_at_10": recall_at_k(res, main["truth"]),
           "launches": {n: c for n, c in counts.items() if c}}
    log("[limits pq] " + json.dumps(out))
    rec["limits_pq"] = out


def service_k100(gpu, cpu, wl) -> dict:
    """256 queries of ``wl`` at ``ServiceConfig(k=100)`` through a service on
    the card index and one on its CPU reload: the same answers (scores
    within 1e-4, id sets equal but at ties at the cut)."""
    from repro_torch.service import HQIService, ServiceConfig

    sub = wl.subset(np.arange(256))
    got = []
    for index in (gpu, cpu):
        svc = HQIService(index, ServiceConfig(k=ENGINE_K, nprobe=8, max_batch=256, deadline_s=0.005))
        try:
            got.append(service_stream(svc, sub))
        finally:
            svc.stop(drain=False)
    a, b = got
    if a["ids"].shape != (256, ENGINE_K):
        raise AssertionError(f"service k={ENGINE_K}: answers {a['ids'].shape}")
    tied = agree_untied(a["scores"], a["ids"], b["scores"], b["ids"], f"service k={ENGINE_K}, card and CPU")
    return {"queries": 256, "k": ENGINE_K, "qps_card": a["qps"], "tied_queries": tied}


def phase_flight(rec: dict, svc, wl, out_dir: str) -> None:
    """The flight recorder on the S1 service, on the card: a baseline
    sample, 8 queries, ``service.flush`` armed once and a flush (its crash
    contained by the service), then exactly one incident bundle, accepted
    by ``validate_incident_bundle``, and no second one for the same crash.
    The bundles live in a temporary directory under ``out_dir``, deleted."""
    import shutil
    import tempfile

    from repro_torch.fault import failpoints
    from repro_torch.obs import trace
    from repro_torch.obs.flight import FlightRecorder, validate_incident_bundle

    root = tempfile.mkdtemp(prefix="incidents-", dir=out_dir)
    trace.enable(capacity=8192)
    recorder = FlightRecorder(svc, root, max_incidents=4)
    try:
        if recorder.observe() is not None:
            raise AssertionError("flight: the baseline sample dumped a bundle")
        for i in range(8):
            svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]])
        failpoints.arm("service.flush", count=1)
        svc.flush()
        path = recorder.observe()
        if path is None:
            raise AssertionError("flight: the armed flush crash produced no incident")
        manifest = validate_incident_bundle(path)
        if recorder.observe() is not None or len(recorder.incidents()) != 1:
            raise AssertionError(f"flight: {len(recorder.incidents())} bundles for one crash")
        out = {"bundles": len(recorder.incidents()), "rules": manifest["rules"],
               "flush_failures": manifest["health"]["flush_failures"],
               "files": sorted(os.listdir(path))}
    finally:
        trace.disable()
        failpoints.disarm_all()
        shutil.rmtree(root, ignore_errors=True)
    log("[flight] " + json.dumps(out))
    rec["flight"] = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"), help="record directory")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if "jax" in sys.modules or "repro" in sys.modules:
        raise AssertionError("the port pulled in jax or the reference package")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    rec: dict = {"nvidia_smi": smi, "torch": torch.__version__}
    max_err = {name: 0.0 for name in KERNELS}

    phase_build(rec, args.out)
    phase_kernels(rec, max_err)
    main_run = phase_main_path(rec)
    heaviest = phase_main_shapes(rec, main_run, max_err)
    rec["profile_f32"] = profiled_engine(main_run["index"], main_run["wl"], "f32")
    phase_limits_f32(rec, main_run)
    sharded = phase_sharded(rec, main_run)
    service = phase_service(rec, main_run)
    phase_flight(rec, service.pop("svc"), main_run["wl"], args.out)
    store = phase_store(rec, main_run["index"], main_run["kg"], main_run["wl"], args.out)
    del main_run["index"]
    torch.cuda.empty_cache()
    kg_100k, index_100k = phase_card_vs_cpu(rec)
    phase_service_card_vs_cpu(rec, kg_100k, index_100k, out_dir=args.out)
    del kg_100k, index_100k
    torch.cuda.empty_cache()
    phase_adc_kernels(rec, max_err)
    torch.cuda.empty_cache()
    phase_limit_kernels(rec, max_err)
    torch.cuda.empty_cache()
    phase_wide_m(rec, max_err)
    torch.cuda.empty_cache()
    pq_run = phase_pq_main(rec, main_run)
    rec["profile_pq"] = profiled_engine(pq_run["index"], pq_run["wl"], "pq")
    phase_limits_pq(rec, pq_run["index"], main_run)
    pq_heavy = adc_buckets(pq_run["index"], pq_run["wl"], resident=True, max_err=max_err, tag="pq")
    rec["pq_path_buckets"] = pq_heavy["buckets"]
    rec["pq_path_buckets_summed"] = pq_heavy["summed"]
    rec["pq_rerank"] = rerank = rerank_dispatch(pq_run["index"], pq_run["wl"], max_err)
    del pq_run["index"], main_run["kg"]
    torch.cuda.empty_cache()
    per_phase = phase_pq_card_vs_cpu(rec, max_err)
    torch.cuda.empty_cache()
    wide_m_run = phase_wide_m_engine(rec, max_err)
    torch.cuda.empty_cache()
    attn = phase_attention_kernels(rec, max_err)
    wide_dh = phase_wide_dh(rec, max_err)
    serve = phase_serving(rec, max_err)
    phase_lm_card_vs_cpu(rec)
    t_train = time.perf_counter()
    bwd = phase_backward_kernels(rec, max_err)
    train = phase_training(rec)
    phase_train_card_vs_cpu(rec, args.out)
    rec["training_phase_seconds"] = time.perf_counter() - t_train
    log(f"[train] phase T in {rec['training_phase_seconds']:.1f} s")

    timed = {
        "fused_knn": (main_run["counts"]["fused_knn"], heaviest["fused_knn"]),
        "fused_knn_db_stationary": (main_run["counts"]["fused_knn_db_stationary"],
                                    heaviest["fused_knn_db_stationary"]),
        "workunit_pq_scan_streamed": (pq_run["counts"]["workunit_pq_scan_streamed"],
                                      pq_heavy["heaviest"]),
        **per_phase,
        # the serving run's local layers (5 of 6) at its longest prompt
        "flash_attention": (serve["launches"], attn["gemma3-s4096-w1024"]),
        # the d-768 index's segmented search at pq_m 192, its heaviest bucket
        "adc_wide_m": (wide_m_run["launches"], wide_m_run["heaviest"]),
        # the reduced gemma3 at dh 512 served on the card; dh 512, bf16, global
        "flash_attention_wide": (wide_dh["launches"], wide_dh["heaviest"]),
        # one step of minicpm-2b training (phase T); minicpm's heads, bf16, causal
        "flash_attention_backward": (train["launches"], bwd["minicpm-s2048"]),
    }
    kernels = []
    for name in KERNELS:
        launches, h = timed[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "design": DESIGN[name],
            "launches": launches, "max_abs_err": max_err[name],
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h.get("library_ms"),
            "ms_over_bound": h["ms_over_bound"], "yardstick_ms": h.get("yardstick_ms"),
            "bound_share": h.get("bound_share", h["bound_ms"] / h["ms"]),
            "shape": h["shape"],
        }
        if name == "flash_attention_wide":  # the same shape in f32 (flash_sliced_kernel)
            entry["f32"] = {key: wide_dh["f32"][key] for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                                   "library_ms", "ms_over_bound")}
        if name == "flash_attention_backward":
            entry["tflops"] = h["tflops"]
            # gemma3's heads (the wgmma pair at DH 128), minicpm's and dh 256 in f32 (the 3xTF32 pair), dh 256
            # and row 8's shape in bf16 (the split wgmma pair), dh 512 in f32 (the wide pair)
            entry["more_shapes"] = {
                w: {key: bwd[w].get(key) for key in ("shape", "ms", "device_ms", "bwd_dq_device_ms",
                                                       "bwd_dkdv_device_ms", "plain_ms", "bound_ms",
                                                       "fp32_core_bound_ms", "library_ms", "tflops")}
                for w in ("gemma3-s4096-w0", "gemma3-s4096-w1024", "minicpm-s2048-f32", "dh256-bf16", "dh256-f32",
                          "dh512-bf16", "dh512-f32")}
            # ptxas registers and spills of the 3xTF32 kernels: the backward pair and the f32 forward (phase 1's
            # nvcc log)
            entry["ptxas_tf32x3"] = {k: v for k, v in rec["ptxas"].items() if "tf32x3" in k}
        if name == "flash_attention":
            g = attn["gemma3-s4096-w0"]  # the global layers at the same prompt
            entry["tflops"] = h["tflops"]
            entry["global_layer"] = {key: g[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                              "tflops", "bound_share")}
            # row 6b: flash_fwd_tf32x3_kernel (f32) at minicpm's heads, as every f32 training step runs it, and at
            # dh 256 and T 16384
            keys = ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "fp32_core_bound_ms", "library_ms", "tflops",
                    "max_abs_err", "lse_max_abs_err")
            f = bwd["f32-forward"]
            entry["f32_training_forward"] = {key: f[key] for key in keys}
            entry["f32_training_forward"]["more_shapes"] = {
                w: {key: bwd[w][key] for key in keys} for w in ("f32-forward-dh256", "f32-forward-long")}
        for key in ("bound_bytes", "lut_streamed_bytes", "staged_lut_bytes", "real_query_slots",
                    "device_ms", "work_list_ms", "ms_64_queries", "summed_over_buckets", "lookup_bound_ms",
                    "bwd_dq_device_ms", "bwd_dkdv_device_ms"):
            if key in h:
                entry[key] = h[key]
        if name == "fused_knn_db_stationary":
            entry["pq_rerank"] = {key: rerank[key] for key in ("shape", "ms", "device_ms", "bound_ms")}
        if name == "workunit_pq_scan_streamed":
            entry["summed_over_buckets"] = pq_heavy["summed"]
        # launches in each stream of the online service (S1)
        entry["service_launches"] = {tag: c[name] for tag, c in service["launches"].items()}
        # launches in S3's first stream (answers P, the delta past the PQ threshold)
        entry["store_launches"] = store["launches"][name]
        # launches in S4's warm sharded searches (four ranks on the card), f32 and PQ
        entry["sharded_launches"] = {tag: c.get(name, 0) for tag, c in sharded.items()}
        if name == "workunit_pq_scan":
            entry["delta_store_shapes"] = [
                {key: s[key] for key in ("shape", "ms", "device_ms", "bound_ms", "bound_by")}
                for s in service["kernel4"]]
        if launches <= 0:
            raise AssertionError(f"{name}: no launch on its path")
        kernels.append(entry)
    rec["kernels"] = kernels
    rec["profiler_traces"] = PROFILER_TRACES
    pad_lost = [t["pad_lost"] for t in PROFILER_TRACES]
    post_lost = [t["post_lost"] for t in PROFILER_TRACES]
    log(f"[profiler] device_ms traces {len(PROFILER_TRACES)}, {sum(t['lead_ms'] > PROFILER_LEADS_MS[0] for t in PROFILER_TRACES)} "
        f"of them retaken with a longer lead; pad launches lost ahead of the device sleep: max "
        f"{max(pad_lost, default=0)}, in {sum(d > 0 for d in pad_lost)} traces; behind it: max "
        f"{max(post_lost, default=0)}, in {sum(d > 0 for d in post_lost)} traces")
    rec["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    log(f"[done] all phases passed in {rec['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

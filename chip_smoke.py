#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vsc2022_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # needs one CUDA GPU
    python3 chip_smoke.py --keep   # leave the corpus in build/smoke/

Phases (any failure exits non-zero):
  1. Build the hand kernels from vsc2022_torch/ops/csrc with nvcc; print
     the resident blocks per SM of row_max, count_above and fused_topk,
     fused_topk's grid and pieces per row (S) at the serving and DnS
     shapes, and the plans of the tensor-core product (wgmma_gemm.cuh):
     row_max.bf16's at its shapes, pool_writer.bf16's and
     count_above.bf16's at the SSCD shapes, count_above.bf16's and
     fused_topk.bf16's at the serving and DnS shapes (grid, S, corpus
     passes, shared-memory bytes, where the kappa-sets live).
  2. Hold each kernel against its plain PyTorch version on the card:
     first at small ragged shapes, then (after phase 4) on the very
     inputs the main path gave it, plus integer-valued inputs of the same
     shape. Exact on integers, within the stated tolerance on floats.
     Times the kernel, the plain version, one PyTorch library yardstick
     (timed here only, never called by the port) and the card's bound.
     On each path's float inputs of row_max, count_above and fused_topk,
     the kernels are also held against the pool_writer kernel bit for
     bit: fused_topk is the pool's winners ordered best-first, row_max is
     the pool's best winner, and with tau the global k-th pool value (k =
     20 per query row, 1200 per video) count_above equals the pool count
     >= tau on every row where no segment holds two entries >= tau.
     The bf16 variants of the four retrieval kernels, first at small
     ragged shapes (D = 511, 512, 513, 1025; rows 16-byte and 2-byte
     aligned), then on the bf16 paths' inputs (4b; 6b, its forced pooled
     search's pool too) and on the DnS path's inputs rounded to bf16:
     exact against their plain versions on integers. All four run on one
     product, the tensor cores' (their own summation order): on floats
     within BF16_TC_ATOL of their plain versions (pool_writer.bf16's and
     fused_topk.bf16's ids equal the plain ones wherever no winner lies
     within twice that of its runner-up or of the kappa boundary), and
     bit for bit against each other, as the f32 kernels: on the inputs of
     every row_max, count_above and pool_writer call, the pool's best
     winner is row_max.bf16, its winners ordered are fused_topk.bf16's
     (kappa 32), count_above.bf16 equals its count >= tau on every row
     with amb == 0, and on the other rows alone (the pooled collection's
     count) it counts what it counts for them in the full call; on
     fused_topk.bf16's inputs, its best value is row_max.bf16, and with
     tau the global k-th candidate (k = 20 per row) count_above.bf16
     equals the candidates >= tau on every row whose set is not full at
     tau and where no segment holds more than two entries >= tau (found
     with the plain version and a margin). scores_above.bf16, the corpus
     re-search (the entries at or above each row's floor on the same
     product), at small shapes on 133 rows with mixed floors (-inf, +inf,
     ties on the floor) and with capacity 1 (it launches again for the
     same set), then on the rows, floors and capacity each bf16 path
     re-searches with: SSCD (4b), serving (6b, both collections) and the
     DnS bf16 search (6b, in process): exact against its plain version
     on integers, and on floats its entries are nonzero(scores.bf16 >=
     floor), each once, its scores the dense kernel's bit for bit, within
     BF16_TC_ATOL of the plain scores. It is timed through its wrapper
     (its one sync included) and alone, beside its plain version,
     torch.mm with f32 output (the same scores: its library call), the
     library route to the same entries (mm, >= floor, nonzero, gather)
     and the dense route it replaced (scores.bf16 chunks, then nonzero),
     also on the first 512 rows where there are more; its peak device
     memory is read beside the dense route's. scores.bf16,
     the same product written out (off every path), is held against its
     plain version, and its segments' best 2 against the pool bit for bit,
     on the same rows. Each other bf16 variant
     is timed beside the f32 kernel on the widened inputs. Their bound
     takes the bf16 tensor-core peak, their library call a cuBLAS bf16
     product (scores.bf16's: bf16 in, f32 out, where torch has it).
     The int8 (SQ8) variants of all six (f32 queries, int8 codes and
     per-row scales, on the tensor-core product with its int8 corpus
     policy: the queries split into three exact bf16 terms, three passes
     over the codes widened in shared memory, the scale after the
     product), first at small ragged shapes (D = 511, 512, 1025), then on
     the int8 paths' inputs (4c; 6c, its forced pooled search too; the DnS
     int8 search in process): exact against their plain versions on
     integer queries with power-of-two scales, within FLOAT_ATOL on
     floats, bit for bit against each other (pool_identity: the pool's
     best winner is row_max.int8, its winners ordered fused_topk.int8's,
     its segments scores.int8's best 2, count_above.int8 its count, also
     on the ambiguous rows alone; scores_above.int8's entries
     nonzero(scores.int8 >= floor), each once, with capacity 1 launching
     again for the same set) and, with every scale 1 and the queries
     rounded to bf16, against the bf16 kernel on the widened codes (the
     mid and lo passes add zeros). Each is timed beside the f32 kernel on
     the widened codes (their earlier route); the bound is three bf16
     passes at the tensor-core peak, the library call cuBLAS f32 over the
     widened codes, times the scales. scores_above.int8 is held and timed
     on the rows, floors and capacity each int8 path re-searches with, as
     scores_above.bf16.
  3. global_topk against a dense brute-force oracle at
     1,000 x 100,000 x 512, forced to each collection mode (stream, the
     default at this size, and pooled), over an f32, a bf16 and an int8
     corpus (the oracle: the widened bf16 inputs; cuBLAS over the widened
     codes times the scales, the dequantized corpus): identical on integer-valued
     inputs, and on unit-norm floats all k pairs, with the oracle's scores
     within the stated tolerance.
  4. The main path, through the sscd_baseline entry point with
     --score_norm_features and --ground_truth, on a planted synthetic
     corpus made with numpy from a seed: 150 query videos x 60 frames,
     16,667 reference videos x 60 frames (1,000,020 frames), 250,020 noise
     frames, D = 512; then the descriptor_eval entry point on the same
     files. The kernels' launch counts are zeroed just before the run and
     read just after; every kernel of the path must have launched. Each
     wrapper's first inputs in that run are kept for phase 2.
 4b. The same two entry points with --bf16 on the same files: the
     noise-NN and the retrieval over bf16 corpora; row_max.bf16,
     pool_writer.bf16, count_above.bf16 (the ambiguous rows' count, over
     the pool's own operands) and scores_above.bf16 (the re-searched rows)
     must launch, and no f32 kernel and no scores.bf16.
     Stage seconds, last_stats and quality are logged beside phase 4's.
 4c. The same two entry points with --int8: both corpora as int8 codes
     and per-row scales, the queries f32; row_max.int8, pool_writer.int8,
     count_above.int8 (over the pool's own operands) and scores_above.int8
     must launch, and no other kernel (no scores.int8); every searched
     corpus holds its codes and scales only (staged bytes logged beside
     the f32 corpus's). Here and in 4b, 6b, 6c and the DnS searches in
     process, the re-search's rows per launch are logged and checked: one
     scores_above launch of the corpus's dtype per re-search over all its
     rows, with its capacity.
  5. The DnS track, through its entry points: dns_index for the coarse
     student with --score_norm_features, dns_index for the fine attention
     student, then dns_baseline with --ground_truth, on raw L3-iMAC rows
     at full width (9 x 3840, stored fp16) made with numpy from a seed:
     100 query, 400 reference and 100 noise videos of 24-128 frames, 50
     queries carrying a planted copy of 10-40 frames; student weights are
     npz variable trees made from the seed (--checkpoint_path). First the
     same entry points on a small corpus on the card and on the CPU (same rows,
     scores within the tolerance). Counts are zeroed just before the path
     and read just after; chamfer, row_max, fused_topk and count_above must
     launch (the 31,004-row coarse corpus streams). The chamfer kernel is
     then held against its plain version on every input the path gave it
     and on integer-valued inputs of the largest call's shape, and the
     path's row_max, fused_topk and count_above calls (D = 1024 and 1025)
     as in phase 2.
 5d. The DnS fine similarity at precision "default". chamfer.bf16
     (TMA and wgmma on the tensor cores, persistent; its plan, resident
     blocks, registers and spill logged) on every chamfer input of phase 5
     rounded to bf16, within BF16_TC_ATOL of its plain version, and on
     integer inputs of the largest call's shape with zero-pad frames,
     exactly; kernel, plain, library (one bf16 bmm with f32 output, then
     amax and mean), f32-chamfer (the same rounded rows) and bound ms on
     the largest call and summed over the calls. Then the path function,
     `dns_baseline._gathered_dns_sims(..., precision="default")`, on
     phase 5's staged tables and each of its batches' index matrices:
     counts zeroed just before and read just after (chamfer.bf16 once a
     batch, nothing else), held against the same function on the plain
     chamfer; its largest difference from the "highest" sims is logged,
     not checked. The entry points stay at "highest" (as JAX's
     DnSLocalization does) and launch chamfer.bf16 0 times.

  6. Serving, through `python -m vsc2022_torch.retrieval.serve --f32
     --score_norm_features ... --matches` driven by the port's client: a
     catalogue of 4,000 reference videos x 60 frames (240,000 frames, under
     the 262,144-row pool floor, so every search streams through
     fused_topk and count_above), 150 query videos, 60,000 noise frames,
     D = 512, 100 planted copies. Requests: (a) all 150 query videos by
     path, (b) the same in-band (byte-identical CSVs), (c) one video, (d)
     add 100 videos, (e) remove 100, (f) save, (g) (a) again, (h) stats;
     a fresh server on the snapshot answers (g) byte for byte; the
     server's candidates equal an in-process ScoreNormalizedVideoIndex
     over the same live corpus, and (a) forced to the pooled collection
     gives the same pairs. The server's launch counts are zeroed just
     before (a) and read after (h). Then one DnS two-file request over
     phase 5's files must equal dns_baseline's output. fused_topk and
     count_above are held against their plain versions and timed on the
     serving search's inputs (and on the DnS path's), with row_max on the
     bias of the same search, and both collection modes are timed at the
     serving and DnS corpora. Each path logs its searches' last_stats
     (mode, tau, flagged, ambiguous and re-searched rows).
 6b. The same server with no dtype flag (the JAX package's default: bf16
     corpus, noise corpus and localizer tables) on the same catalogue,
     requests (a)-(h): stats says bfloat16, the snapshot restart answers
     (g) byte for byte, the candidates equal an in-process
     ScoreNormalizedVideoIndex(dtype="bfloat16"), pooled equals stream
     (one product, the re-searched rows' scores included: the same pairs,
     scores equal), and row_max.bf16,
     fused_topk.bf16 and count_above.bf16 launch on the tensor cores (no
     f32 kernel). Then one DnS two-file request with bf16 tables over
     phase 5's files (fused_topk.bf16, count_above.bf16 and
     scores_above.bf16 at D = 1025 over the searcher's 1,032-column copy,
     the f32 chamfer over
     widened rows); its quality is logged. Its search, repeated in process
     on phase 5's inputs rounded to bf16 in both collection modes, gives
     the same arrays either way and re-searches as the server did.
 6c. The same server with --int8 (search and noise corpora as SQ8 codes,
     localizer tables bf16), requests (a)-(h): stats says int8, the
     snapshot restart answers (g) byte for byte, the candidates equal an
     in-process ScoreNormalizedVideoIndex(dtype="int8"), pooled equals
     stream (scores included), only int8 kernels launch, and each
     collection re-searches in one scores_above.int8 launch; then one DnS
     two-file request with the 1,025-wide coarse corpus in int8 (1,040
     columns of codes), its quality logged, and its search repeated in
     process on phase 5's inputs in both collection modes.
  7. The small search modes. 7a: every L2 variant (row_max, count_above,
     pool_writer, fused_topk in f32 and bf16; scores_above in bf16)
     against its plain version at small ragged shapes (D = 33, 512, 1025;
     exact on integers, within FLOAT_ATOL / BF16_TC_ATOL on unit-norm
     floats) and the L2 kernels of each collection against each other bit
     for bit (the pool's best winner is row_max, its winners ordered
     fused_topk's, its count count_above's on rows with amb == 0 and on
     the ambiguous rows alone; scores_above's entries the goodness of
     scores.bf16). 7b: VideoIndex(metric="L2") over phase 6's catalogue
     (240,000 frames, 150 query videos, k = 180,000) in f32 and bf16, its
     search forced to each collection plus the searcher's row_nn, launch
     counts zeroed just before and read after: pooled == stream (ids and
     distances), both against a dense oracle; each L2 kernel then held
     against its plain version on those inputs (and integers of their
     shape) and timed beside its IP kernel, its plain version, torch.mm
     with the same epilogue and reduction, and its bound. 7c: precision
     "default": an f32 searcher == a bf16 searcher on the same rows, an
     int8 one == a bf16 searcher over its unit-scale codes (the one-pass
     product), bit for bit in both collections; L2 at "default" against
     the dense oracle of bf16 products and f32 norms. 7d: per-query KNN,
     VideoIndex.search(global_k=-5), against the dense per-row top-k.
     7e: python -m vsc2022_torch.matching_eval on phase 4's matches.csv
     prints the segment AP phase 4 reported.
  8. Descriptor extraction at full width: stub ffmpeg / ffprobe decode 40
     synthetic videos (640x360, fps 1; 24 references, 8 queries of which 4
     hold a 15-frame copy, 8 noise videos). The inference CLI (in process;
     the queries once through `python -m vsc2022_torch.inference.cli`),
     batch 32: SSCD ResNet-50 -> 512 at RESIZE_320_CENTER in f32 (weights:
     the port's seeded model as TorchScript), bf16 and f32 --fold_bn; DINO
     ViT-S/16 at RESIZE_224_SQUARE and RESIZE_320_CENTER; L3-iMAC at
     RESIZE_320_CENTER (both from the CLI's seeded init). Each f32 run held
     against the port's CPU forward of the same model on 8 frames
     (EXTRACT_REL_TOL of the largest value), --fold_bn against the
     unfolded run, bf16 against f32 by cosine. Then serve --baseline sscd
     --f32 --score_norm_features --matches on the CLI's reference npz:
     extract of the query directory gives the CLI's npz arrays byte for
     byte, searchv (launch counts zeroed just before: row_max, fused_topk,
     count_above) gives search's CSVs of that npz byte for byte; the
     planted copies' µAP. Logged: each CLI run's stage seconds (decode in
     the prefetch thread, extraction, waits, store) and device peak; the
     forward alone in frames per second over 1,024 pre-decoded frames, f32
     and bf16, for each model.

  9. The corpus sharded over the devices of this process (Mesh([dev] *
     n)): 9a phase 4's corpus (its first SHARD_REF_VIDEOS reference
     videos) on 2 shards (pooled) and 4 (stream) in f32, bf16 and int8, bit for bit with the single device, each shard's
     launches checked; f32's 4 shards each an allocation of its own (the
     f32 re-search's cuBLAS calls have one shape, ops/similarity.py
     _f32_scores; its 4 shards in one allocation are not run: its 2 are);
     9b descriptor_eval --sharded (subprocess, alongside the in-process
     run on 2 shards and 9c); 9c serve --f32 --sharded through the
     client, requests (a)-(g) byte for byte with phase 6; 9d the serving
     index and its row-sharded localizer tables on 4 shards through
     serve_request, add and remove; 9e DnSLocalization on 4 shards; 9f
     the extractor on 2 shards.
 10. A pod: two ranks, each a process of its own on this card, in one
     torch.distributed group over gloo (NCCL refuses two ranks on one
     card; every collective stages through the host). 10a: 9a's corpus
     as a pod ScoreNormalizedVideoIndex in f32, bf16 and int8 (one
     270,336-row shard a rank, pooled): 9a's single-device arrays bit
     for bit, both ranks equal, each rank launching once what 9a's two
     shards launch twice. 10c: DnSLocalization over the pod with
     row-sharded tables on phase 5's pairs: dns_baseline's rows on both
     ranks. 10b: serve --sharded as a pod (leader driven by the client,
     follower relayed over --control) at its bf16 default on phase 6's
     catalogue, requests (a)-(g): phase 6b's replies and files byte for
     byte, each rank launching what 6b's server launched. 10d: the
     inference CLI as a two-rank --coordinator job on phase 8's query
     videos: the merged shards equal phase 8's npz bit for bit.
 11. The IVF pruned tier (vsc2022_torch/ops/ivf.py). 11a: the block-subset
     kernels (count_above and fused_topk, .blocks, in f32, bf16 and int8)
     at small shapes, exact on integers against their plain versions and
     bit for bit the full-corpus kernels on the listed rows; then on 11b's
     batch and its probed blocks (the records: kernel, plain, library and
     bound ms). 11b: a clustered corpus of 1,000,000 rows at D = 512 made
     on the card (50 centres, spread 0.35, seed 11), IVFSimilaritySearcher
     against SimilaritySearcher in f32, bf16 and int8, a focused 64-frame
     video (pruned, its scans on the .blocks kernels) and 150 videos from
     5 centres: exactly equal; stats, build and search seconds logged.
     11c: serve --ivf 0 at its bf16 default on phase 6's catalogue,
     requests (a), (d), (e), (g): candidates.csv byte for byte with 6b's,
     matches within IVF_BIAS_ATOL (the bias the localizer reads is
     unrounded beside an IVF searcher, as in JAX).
 12. Training (vsc2022_torch/train), no hand kernel on its path (the
     launch counts are zeroed before it and must read 0 after). 12a: one
     step of a small SSCD (one block a stage, 16-128 wide, 64-d; batch 32
     of 64 x 64 views): the views on the card within TRAIN_VIEW_ATOL of
     the CPU's; the step in float64 on the card from the CPU's views
     against the CPU's float64 step within TRAIN_F64_TOL (loss,
     gradients, running statistics: the same function); the card's
     float32 step against that float64 step within float32's reach
     (TRAIN_LOSS_RTOL, TRAIN_STATS_ATOL, TRAIN_GRAD_NORM_TOL in norm:
     BatchNorm's batch statistics make the gradient ill-conditioned in
     float32). 12b: the training CLI's main (--synthetic 256 --steps 10
     --batch_size 64 --image_size 224) at full width (ResNet-50): every
     loss finite, frames/s after the first step and the device's peak
     memory on lines of their own, and the checkpoint through the
     inference CLI's --checkpoint_path into the extractor, whose
     descriptors equal the trained model's eval forward within
     TRAIN_DESC_TOL. 12c: distillation of fg att, fg bin and cg at full
     width (64 pairs of 4 x 9 x 3840): the CLI (pairs/s, peak), the loss
     falling on a fixed batch, the checkpoint through dns_index's
     --checkpoint_path. 12d: two gloo ranks on this card, each a process
     (train_mesh), half the batch each: both ranks bit for bit alike; the
     SSCD step in float64 equal to 12a's within TRAIN_F64_TOL, the fg bin
     and cg distillation steps equal to one card's (gradients within
     TRAIN_GRAD_TOL of their largest value).

 13. The last entry points (python -m vsc2022_torch, adapt_model, parity,
     serve's probe) and the space-to-depth stem. 13a: python -m
     vsc2022_torch --help exits 0, an unknown command 2. 13b: adapt-model
     --probe, then --verify --output_checkpoint on phase 8's TorchScript
     (--device cuda): the inference CLI's descriptors from
     --checkpoint_path <that npz> equal phase 8's from --torchscript_path
     bit for bit. 13c: python -m vsc2022_torch parity --device cuda on
     phase 4's npz files and GT (1,000,020 references, 250,020 noise
     frames, 150 query videos, D = 512): sn_faithful/candidates.csv is
     phase 4's byte for byte (its kernels' launches counted there),
     sn_tuned's candidates sn_faithful's, the four metrics finite (the
     tuned segment AP and the descriptor uAP above 0.5), each stage's
     seconds logged (its first run starts before phase 12 and runs
     alongside 12, 13a and 13b); a second invocation reruns no stage and
     writes the same summary. 13d (in phases 6, 6b, 6c, 9c and 11c): probe after
     a --matches search: 0 < search_s < that request's wall time, tn_s >
     0, the probe's launches the search's kernels; the sharded (9c) and
     IVF (11c) servers answer the typed error. 13e: the s2d stem
     (fold.s2d_stem, SSCDModel(stem_s2d=True)) on the card: within
     S2D_REL_TOL of the standard stem on phase 8's frames, its forward's
     frames/s logged.

The last lines are the card's name and power limit (nvidia-smi), one
JSON object with each kernel's numbers, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SMOKE_DIR = REPO / "build" / "smoke"

# Published H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores,
# dense bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLOAT_ATOL = 1e-5  # f32 sums of unit-norm products in another order
# The bf16 kernels, all on the tensor cores, against their plain versions
# (the widened f32 product): the tensor cores add the exact bf16 products
# in f32 in their own order. The error grows with D and with the norms: on
# an H100 at most 6.0e-7 on unit-norm rows at D <= 1025, 1.37e-6 on the
# serving search, 1.49e-6 (pool_writer.bf16) and 1.25e-6 (scores.bf16) on
# the SSCD --bf16 search and 2.92e-6 on the DnS bf16 request (D = 1025),
# whose queries carry score normalization's bias column (|q| > 1). 1e-5
# sits 3.4x above the largest reading. It is an empirical
# tolerance: the worst case, 4 D u |q| |r| (u = 2^-24; 2.5e-4 |q| |r| at
# D = 1032), is what the searcher's re-search margin covers
# (ops/similarity.py _corpus_above), not this check.
BF16_TC_ATOL = 1e-5

# The main path's corpus: SSCD's D = 512, 60-frame videos.
FRAMES, DIM = 60, 512
N_QUERY_VIDEOS, N_REF_VIDEOS, N_NOISE_FRAMES = 150, 16_667, 250_000

# The DnS path's corpus: raw L3-iMAC rows of 9 regions x 3840 per frame.
DNS_REGIONS, DNS_RAW_DIM = 9, 3840
DNS_QUERIES, DNS_REFS, DNS_NOISE = 100, 400, 100
DNS_FRAMES = (24, 128)  # video lengths, inclusive: buckets 32, 64 and 128
DNS_PLANTED, DNS_COPY = 50, (10, 40)

# The serving catalogue: under POOL_MIN_CORPUS (262,144 rows), so it streams.
SERVE_REF_VIDEOS, SERVE_NOISE_FRAMES, SERVE_ADD, SERVE_REMOVE = 4_000, 60_000, 100, 100

# The searches' k per query row (1200 per 60-frame video): pool_identity
# takes tau as the pooled collection would for the rows it is given.
K_PER_ROW = 1200 // FRAMES
# Query rows whose scores.bf16 pool_identity holds against the pool (256 MB
# of scores at the SSCD corpus).
SCORES_ROWS = 64

KERNEL_META = {
    "row_max": ("vsc2022_torch/ops/csrc/row_max.cu",
                "vsc2022_tpu/ops/pallas_kernels.py:89"),
    "count_above": ("vsc2022_torch/ops/csrc/count_above.cu",
                    "vsc2022_tpu/ops/pallas_kernels.py:146"),
    "pool_writer": ("vsc2022_torch/ops/csrc/pool_writer.cu",
                    "vsc2022_tpu/ops/pallas_kernels.py:298"),
    "fused_topk": ("vsc2022_torch/ops/csrc/fused_topk.cu",
                   "vsc2022_tpu/ops/pallas_kernels.py:618"),
    "chamfer": ("vsc2022_torch/ops/csrc/chamfer.cu",
                "vsc2022_tpu/ops/pallas_kernels.py:729"),
    # Not a Pallas kernel: the block product (XLA) the JAX searcher's
    # corpus re-search shares with its streaming collection, and that
    # re-search (a per-row top-k of the flagged rows).
    "scores": ("vsc2022_torch/ops/csrc/scores.cu",
               "vsc2022_tpu/ops/similarity.py:259"),
    "scores_above": ("vsc2022_torch/ops/csrc/scores.cu",
                     "vsc2022_tpu/ops/similarity.py:1162"),
}
# The TPU kernel each bf16 variant replaces: pool_writer's bf16 branch; the
# other three have none (the JAX searcher computes them over a bf16 corpus
# with XLA, similarity.py:271, 464), so their Pallas function stands.
BF16_REPLACES = {"pool_writer": "vsc2022_tpu/ops/pallas_kernels.py:228",
                 "chamfer": "vsc2022_tpu/ops/pallas_kernels.py:700"}
# The block-subset variants replace no Pallas kernel: the JAX IVF tier scans
# its block subset with XLA (the Pallas gate excludes block_ids).
BLOCKS_REPLACES = {"count_above": "vsc2022_tpu/ops/similarity.py:427",
                   "fused_topk": "vsc2022_tpu/ops/similarity.py:191"}
# A bf16 variant in a source of its own.
BF16_SOURCES = {"chamfer": "vsc2022_torch/ops/csrc/chamfer_bf16.cu"}
# Each kernel's wrapper in vsc2022_torch.ops.kernels.
WRAPPERS = {"row_max": "row_max", "count_above": "count_above",
            "pool_writer": "pool_writer", "fused_topk": "fused_topk",
            "scores": "scores", "scores_above": "scores_above",
            "chamfer": "chamfer_fine_sims"}
# The kernels each path must launch: the SSCD corpus (1,000,020 rows) is
# pooled; the DnS and serving corpora stream.
SSCD_KERNELS = ("row_max", "count_above", "pool_writer")
DNS_KERNELS = ("row_max", "fused_topk", "count_above", "chamfer")
SERVE_KERNELS = ("row_max", "fused_topk", "count_above")
DNS_SERVE_KERNELS = ("fused_topk", "count_above", "chamfer")  # cg npz is normalized
# The same paths in bf16 (sscd_baseline --bf16, the server's default): the
# bf16 variants, and on the SSCD path the re-search's scores_above.bf16
# (the dense scores.bf16 is off every path); the DnS server's chamfer
# stays f32 (its bf16 tables widen).
BF16 = ".bf16"
SCORES_ABOVE = "scores_above" + BF16
SSCD_BF16_KERNELS = tuple(k + BF16 for k in SSCD_KERNELS) + (SCORES_ABOVE,)
SERVE_BF16_KERNELS = tuple(k + BF16 for k in SERVE_KERNELS)
DNS_SERVE_BF16_KERNELS = ("fused_topk.bf16", "count_above.bf16", "chamfer")
# And in int8 (SQ8: sscd_baseline --int8, serve --int8): the int8 variants,
# the re-search's scores_above.int8 included (scores.int8 is off every
# path); the DnS server's chamfer stays f32 (its tables are bf16, widened).
INT8 = ".int8"
SCORES_ABOVE_INT8 = "scores_above" + INT8
SSCD_INT8_KERNELS = tuple(k + INT8 for k in SSCD_KERNELS) + (SCORES_ABOVE_INT8,)
SERVE_INT8_KERNELS = tuple(k + INT8 for k in SERVE_KERNELS)
# The block-subset variants (the IVF tier's scans, phase 11):
# <name>[.bf16|.int8].blocks.
BLOCKS = ".blocks"
DNS_SERVE_INT8_KERNELS = ("fused_topk.int8", "count_above.int8", "chamfer")


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---- timing and bounds -------------------------------------------------------


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(m: int, n_valid: int, n: int, d: int, out_bytes: int, bf16: bool = False,
          int8: bool = False):
    """Least time for the work: max(flops / peak, bytes / HBM peak), each
    input read once and each output written once. f32 operands: the f32
    CUDA-core peak; bf16 operands (2 bytes each): the bf16 tensor-core
    peak, the least time the card could take for bf16 products. int8
    codes (1 byte a value, 4 bytes of scale a row) against f32 queries:
    the three bf16 passes of the split queries at the tensor-core peak
    (each product of a code with a query term exact)."""
    flops = 2.0 * m * n_valid * d
    if int8:
        moved = 4.0 * m * d + (d + 4.0) * n + out_bytes
        flops *= 3
    else:
        moved = (2.0 if bf16 else 4.0) * (m * d + n * d) + out_bytes
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 or int8 else PEAK_F32_FLOPS)
    t_bytes = moved / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---- library yardsticks (one PyTorch call per chunk; timing only) ----------


def _lib_chunk(n: int) -> int:
    return max(1, (1 << 30) // max(n, 1))


def _lib_operands(q, refs, scale):
    """The library's operands: int8 codes (those with a ``scale``) widened
    to f32 (in the timed call: the library path has no int8 x f32
    product), without pad columns past q's width."""
    r = refs[:, :q.shape[1]]
    return r.float() if scale is not None else r


def _lib_scores(torch, q, r, scale, n):
    """One cuBLAS product of a query chunk, times the scales of an int8
    corpus's first ``n`` rows."""
    s = torch.matmul(q, r.T)
    return s if scale is None else s * scale[:n]


def row_max_library(torch, q, refs, n_valid, scale=None):
    r = _lib_operands(q, refs[:n_valid], scale)
    step = _lib_chunk(n_valid)
    return torch.cat([
        _lib_scores(torch, q[s:s + step], r, scale, n_valid).amax(1)
        for s in range(0, q.shape[0], step)
    ])


def count_above_library(torch, q, refs, tau, n_valid, scale=None):
    r = _lib_operands(q, refs[:n_valid], scale)
    step = _lib_chunk(n_valid)
    return torch.cat([
        (_lib_scores(torch, q[s:s + step], r, scale, n_valid) >= tau).sum(1)
        for s in range(0, q.shape[0], step)
    ])


def chamfer_library(torch, qf, rf, symmetric, **kw):
    """One torch.bmm over frame-major rows, then amax and mean; ``kw``
    (``out_dtype``) goes to the product."""
    b, nq, r, d = qf.shape
    nr = rf.shape[1]
    p = torch.bmm(qf.view(b, nq * r, d), rf.view(b, nr * r, d).transpose(1, 2), **kw)
    p = p.view(b, nq, r, nr, r)  # [b, i, a, j, c]
    fg = p.amax(4).mean(2)
    if symmetric:
        fg = (fg + p.amax(2).mean(3)) / 2
    return fg


def pool_library(torch, q, refs, n_valid, scale=None):
    n = refs.shape[0]
    r = _lib_operands(q, refs, scale)
    step = _lib_chunk(n)
    outs = []
    for s in range(0, q.shape[0], step):
        sc = _lib_scores(torch, q[s:s + step], r, scale, n)
        sc[:, n_valid:] = float("-inf")
        outs.append(torch.topk(sc.view(sc.shape[0], -1, 128), 2, dim=2).values)
    return torch.cat(outs)


def topk_library(torch, q, refs, n_valid, kappa, scale=None):
    """Chunked torch.matmul, per-segment topk(2), then topk(κ) per row."""
    n = refs.shape[0]
    r = _lib_operands(q, refs, scale)
    step = _lib_chunk(n)
    outs = []
    for s in range(0, q.shape[0], step):
        sc = _lib_scores(torch, q[s:s + step], r, scale, n)
        sc[:, n_valid:] = float("-inf")
        seg = torch.topk(sc.view(sc.shape[0], -1, 128), 2, dim=2).values
        seg = seg.reshape(sc.shape[0], -1)
        outs.append(torch.topk(seg, min(kappa, seg.shape[1]), dim=1).values)
    return torch.cat(outs)


def scores_library_f32(torch, q, refs, n_valid, floor=None):
    """Milliseconds of one bf16 product with f32 output (``torch.mm`` with
    ``out_dtype``, the same function as scores.bf16), or None where this
    torch has no such call on the card (logged). With a ``floor`` [M],
    (the product's ms, the ms of the library route to scores_above.bf16's
    result: the product, ``>= floor``, ``nonzero`` and the gather)."""
    r = refs[:n_valid, :q.shape[1]]
    try:
        torch.mm(q[:1], r[:1].T, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        log(f"phase 2: torch {torch.__version__} has no bf16 product with f32 "
            f"output on the card ({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        return None if floor is None else (None, None)
    mm_ms = cuda_ms(torch, lambda: torch.mm(q, r.T, out_dtype=torch.float32), 1)
    if floor is None:
        return mm_ms

    def route():
        s = torch.mm(q, r.T, out_dtype=torch.float32)
        rr, cc = torch.nonzero(s >= floor[:, None], as_tuple=True)
        return s[rr, cc], rr, cc

    return mm_ms, cuda_ms(torch, route, 1)


# ---- phase 2: kernels against their plain versions -------------------------


def make_inputs(torch, kind, m, n, d, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if kind == "int":
        q = torch.randint(-3, 4, (m, d), generator=g, device=dev).float()
        r = torch.randint(-3, 4, (n, d), generator=g, device=dev).float()
    else:
        q = torch.randn((m, d), generator=g, device=dev)
        r = torch.randn((n, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        r /= r.norm(dim=1, keepdim=True)
    return q, r


def compare_row_max(torch, kernels, q, r, n_valid, kind, **kw):
    """``kw``: an int8 corpus's ``scale`` (as for every compare_*)."""
    got = kernels.row_max(q, r, n_valid, **kw)
    want = kernels.row_max_plain(q, r, n_valid, **kw)
    finite = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), finite), "row_max: -inf rows differ")
    err = float((got[finite] - want[finite]).abs().max()) if finite.any() else 0.0
    tol = 0.0 if kind == "int" else (
        BF16_TC_ATOL if q.dtype == torch.bfloat16 else FLOAT_ATOL)
    check(err <= tol, f"row_max {kind} [{q.shape[0]}x{n_valid}x{q.shape[1]}]: "
          f"max abs err {err} > {tol}")
    return err


def compare_count_above(torch, kernels, q, r, tau, n_valid, kind, **kw):
    got = kernels.count_above(q, r, tau, n_valid, **kw)
    want = kernels.count_above_plain(q, r, tau, n_valid, **kw)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    # Floats: a score within an ULP of τ may count on one side only.
    tol = 0.0 if kind == "int" else 2.0
    check(err <= tol, f"count_above {kind}: max count diff {err} > {tol}")
    return err


def compare_scores(torch, kernels, q, r, n_valid, kind, **kw):
    """scores.bf16 (scores.int8) against its plain version: exact on
    integers, within BF16_TC_ATOL (FLOAT_ATOL) on floats. Returns the
    largest error."""
    got = kernels.scores(q, r, n_valid, **kw)
    want = kernels.scores_plain(q, r, n_valid, **kw)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = 0.0 if kind == "int" else (
        BF16_TC_ATOL if q.dtype == torch.bfloat16 else FLOAT_ATOL)
    check(err <= tol, f"scores {kind} [{q.shape[0]}x{n_valid}x{q.shape[1]}]: max abs "
          f"err {err} > {tol}")
    return err


def above_entries(torch, out):
    """scores_above's (scores, rows, cols) ordered by (row, col), indices
    int64; fails unless each (row, col) appears once."""
    s, rr, cc = out
    key, order = torch.sort(rr.long() * (1 << 32) + cc.long())
    check(bool((key[1:] != key[:-1]).all()), "scores_above: an entry appears twice")
    return s[order], rr[order].long(), cc[order].long()


def int_floors(torch, m, d, dev, sigma=4.0):
    """Per-row floors over integer scores (randint(-3, 4) rows: sigma 4
    sqrt(D); int8_int_queries against int8_rows' integer codes at scale 1:
    sigma 146.6 sqrt(D)): 4 sigma, -inf on every 97th row, +inf on every
    89th from the 1st."""
    floor = torch.full((m,), 4.0 * sigma * math.sqrt(d), device=dev)
    floor[::97] = float("-inf")
    floor[1::89] = float("inf")
    return floor


def compare_scores_above(torch, kernels, q, r, n_valid, floor, kind, capacity=None,
                         **kw):
    """scores_above.bf16 (scores_above.int8: int8 codes r with their
    ``scale`` in ``kw``) with ``capacity`` against its plain version, each
    entry once. Integers: the same entries, bit for bit. Floats: the same
    entries as nonzero(scores >= floor), each score the dense kernel's
    (scores.bf16, scores.int8) at its (row, col) bit for bit; against the
    plain version, every score within BF16_TC_ATOL of the plain score at
    its (row, col), every plain entry >= floor + that tolerance emitted and
    every emitted one's plain score >= floor - it. Returns the largest
    error against the plain scores."""
    got = above_entries(torch, kernels.scores_above(q, r, n_valid, floor,
                                                    capacity=capacity, **kw))
    shape = f"[{q.shape[0]}x{n_valid}x{q.shape[1]}]"
    if kind == "int":
        want = above_entries(torch, kernels.scores_above_plain(q, r, n_valid, floor,
                                                               **kw))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"scores_above int {shape}: differs from the plain version")
        return 0.0
    s, rr, cc = got
    dense = kernels.scores(q, r, n_valid, **kw)
    wr, wc = torch.nonzero(dense >= floor[:, None], as_tuple=True)
    check(torch.equal(rr, wr) and torch.equal(cc, wc)
          and torch.equal(s.view(torch.int32), dense[rr, cc].view(torch.int32)),
          f"scores_above float {shape}: differs from nonzero(scores >= floor)")
    del dense, wr, wc
    plain = kernels.scores_plain(q, r, n_valid, **kw)
    err = float((s - plain[rr, cc]).abs().max()) if s.numel() else 0.0
    tol = BF16_TC_ATOL
    emitted = torch.zeros(plain.shape, dtype=torch.bool, device=q.device)
    emitted[rr, cc] = True
    missed = int(((plain >= floor[:, None] + tol) & ~emitted).sum())
    low = int((plain[rr, cc] < floor[rr] - tol).sum())
    del plain, emitted
    check(err <= tol and missed == 0 and low == 0,
          f"scores_above float {shape}: max abs err {err} (tolerance {tol}), "
          f"{missed} plain entries >= floor + tol missed, {low} emitted below "
          "floor - tol")
    return err


def scores_above_small(torch, kernels, q, r, n_valid, kind, **kw):
    """scores_above.bf16 (scores_above.int8 over codes r with their
    ``scale`` in ``kw``) at a small shape: on the first 133 rows (no
    multiple of 128) with mixed floors (int_floors; on floats a score of
    each row, so ties sit on the floor), against its plain version; with
    capacity 1 it launches twice and returns the same set."""
    q = q[:133]
    key = SCORES_ABOVE_INT8 if kw else SCORES_ABOVE
    if kind == "int":
        floor = int_floors(torch, q.shape[0], q.shape[1], q.device,
                           sigma=146.6 if kw else 4.0)
    else:
        dense = kernels.scores(q, r, n_valid, **kw)
        floor = torch.sort(dense, dim=1, descending=True).values[:, 40].contiguous()
        floor[::17] = float("-inf")
        del dense
    err = compare_scores_above(torch, kernels, q, r, n_valid, floor, kind, **kw)
    full = above_entries(torch, kernels.scores_above(q, r, n_valid, floor, **kw))
    before = kernels.launches[key]
    exact = above_entries(torch, kernels.scores_above(q, r, n_valid, floor,
                                                      capacity=full[0].numel(), **kw))
    again = above_entries(torch, kernels.scores_above(q, r, n_valid, floor, capacity=1,
                                                      **kw))
    check(full[0].numel() > 1 and kernels.launches[key] - before == 3
          and all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(full, exact, again)),
          f"scores_above {kind}: the exact capacity took other than one launch, or "
          "capacity 1 other than two, or they returned other entries")
    return err


def compare_pool(torch, kernels, q, r, n_valid, kind, check_ids_dense=False, **kw):
    """Integers: the kernel's pool equals the plain version's exactly (ids
    wherever the value is finite). Floats: the -inf slots agree, every
    value lies within the tolerance (bf16: BF16_TC_ATOL) of the plain
    version's, and the ids agree wherever no winner lies within twice that
    of its runner-up (``check_ids_dense``: also every id's plain score is
    within the tolerance of its value). Returns the largest value error."""
    pv, pi = kernels.pool_writer(q, r, n_valid, **kw)
    ev, ei = kernels.pool_writer_plain(q, r, n_valid, **kw)
    finite = torch.isfinite(ev)
    check(bool((torch.isfinite(pv) == finite).all()), "pool_writer: -inf slots differ")
    err = float((pv[finite] - ev[finite]).abs().max()) if finite.any() else 0.0
    shape = f"[{q.shape[0]}x{n_valid}x{q.shape[1]}]"
    if kind == "int":
        check(err == 0.0, f"pool_writer int {shape}: value err {err}")
        check(bool((pi[finite] == ei[finite]).all()),
              f"pool_writer int {shape}: ids differ (tie rule: lowest column)")
        return err
    tol = BF16_TC_ATOL if q.dtype == torch.bfloat16 else FLOAT_ATOL
    check(err <= tol, f"pool_writer float {shape}: value err {err} > {tol}")
    top3, _ = plain_segments(torch, q, r, n_valid, **kw)
    first = top3[:, :, 0] - top3[:, :, 1] > 2 * tol
    second = first & (top3[:, :, 1] - top3[:, :, 2] > 2 * tol)
    del top3
    check(torch.equal(pi[:, :, 0][first], ei[:, :, 0][first])
          and torch.equal(pi[:, :, 1][second], ei[:, :, 1][second]),
          f"pool_writer float {shape}: ids differ from the plain version where the "
          "winners lie apart")
    if check_ids_dense:
        scores = torch.matmul(q.float(), r[:, :q.shape[1]].float().T)
        if kw:
            scores *= kw["scale"]
        rows = torch.arange(q.shape[0], device=q.device)[:, None, None].expand_as(pi)
        at = scores[rows[finite], pi[finite].long()]
        id_err = float((at - pv[finite]).abs().max())
        check(id_err <= tol, f"pool_writer float {shape}: ids off by {id_err}")
    del pv, pi, ev, ei
    return err


def plain_segments(torch, q, r, n_valid, ids=None, scale=None):
    """The plain scores (the widened f32 product, times an int8 corpus's
    ``scale``, columns >= n_valid at -inf) per row: the best three of each
    128-column segment, [M, N/128, 3]; with ``ids`` [M, K], also the
    scores at those columns. Chunked over rows; r may carry pad columns
    past q's width."""
    m, d = q.shape
    rr = r[:, :d].float()
    pad = -rr.shape[0] % 128
    step = max(1, (1 << 27) // (rr.shape[0] + pad))
    top3, at = [], []
    for s0 in range(0, m, step):
        sc = torch.matmul(q[s0:s0 + step].float(), rr.T)
        if scale is not None:
            sc *= scale
        sc[:, n_valid:] = float("-inf")
        if ids is not None:
            at.append(sc.gather(1, ids[s0:s0 + step].long()))
        if pad:
            sc = torch.nn.functional.pad(sc, (0, pad), value=float("-inf"))
        top3.append(torch.topk(sc.view(sc.shape[0], -1, 128), 3, dim=2).values)
        del sc
    return torch.cat(top3), (torch.cat(at) if ids is not None else None)


def compare_topk(torch, kernels, q, r, n_valid, kappa, kind, **kw):
    """Integers: the kernel equals the plain version exactly (values, ids
    and order). f32 and int8 floats: the kernel's ids equal those of the
    pool_writer kernel's winners ordered best-first, and its values are
    bit-identical to pool_writer's at the same (row, id); 0 is returned as
    the error. bf16 floats (the tensor cores): compare_topk_tc."""
    if kind == "float" and q.dtype == torch.bfloat16:
        return compare_topk_tc(torch, kernels, q, r, n_valid, kappa)
    got_v, got_i = kernels.fused_topk(q, r, n_valid, kappa, **kw)
    if kind == "int":
        want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa, **kw)
    else:
        if r.shape[0] % 128:  # the pool takes whole segments
            pad = 128 - r.shape[0] % 128
            r = torch.cat([r, r.new_zeros((pad, r.shape[1]))])
            if kw:
                kw = {"scale": torch.cat([kw["scale"], kw["scale"].new_zeros(pad)])}
        pv, pi = kernels.pool_writer(q, r, n_valid, **kw)
        want_v, want_i = kernels.ordered_topk(pv.view(q.shape[0], -1),
                                              pi.view(q.shape[0], -1), kappa)
        del pv, pi
    check(torch.equal(got_v, want_v) and torch.equal(got_i, want_i),
          f"fused_topk {kind} [{q.shape[0]}x{n_valid}x{q.shape[1]}] kappa={kappa}: "
          f"differs from the {'plain version' if kind == 'int' else 'pool_writer winners'}")
    return 0.0


def compare_topk_tc(torch, kernels, q, r, n_valid, kappa):
    """fused_topk.bf16 on floats against its plain version: every value
    within BF16_TC_ATOL of the plain score at its (row, id) and of the
    plain version's value in the same place (order statistics of scores
    that move at most tol move at most tol), and the same ids on every row
    where the plain kappa-th and (kappa+1)-th winners lie more than twice
    that apart and no segment's second winner above that boundary has a
    third entry within twice that (the only ways a set can change).
    Returns the largest value error."""
    tol, m = BF16_TC_ATOL, q.shape[0]
    got_v, got_i = kernels.fused_topk(q, r, n_valid, kappa)
    want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
    finite = torch.isfinite(got_v)
    check(torch.equal(finite, torch.isfinite(want_v)),
          f"fused_topk.bf16 [{m}x{n_valid}]: -inf slots differ from the plain version")
    top3, at = plain_segments(torch, q, r, n_valid, got_i)
    err = 0.0
    if finite.any():
        err = max(float((at[finite] - got_v[finite]).abs().max()),
                  float((want_v[finite] - got_v[finite]).abs().max()))
    check(err <= tol, f"fused_topk.bf16 [{m}x{n_valid}x{q.shape[1]}] kappa={kappa}: "
          f"values off the plain scores by {err} > {tol}")
    winners = torch.sort(top3[:, :, :2].reshape(m, -1), dim=1, descending=True).values
    last = winners[:, min(kappa, winners.shape[1]) - 1]
    after = (winners[:, kappa] if winners.shape[1] > kappa
             else torch.full_like(last, float("-inf")))
    swap = ((top3[:, :, 1] - top3[:, :, 2] <= 2 * tol)
            & (top3[:, :, 1] >= last[:, None] - 2 * tol)).any(1)
    clear = (last - after > 2 * tol) & ~swap
    got_ids = torch.sort(torch.where(finite, got_i, -1), dim=1).values
    want_ids = torch.sort(torch.where(finite, want_i, -1), dim=1).values
    check(torch.equal(got_ids[clear], want_ids[clear]),
          f"fused_topk.bf16 [{m}x{n_valid}] kappa={kappa}: ids differ from the plain "
          "version on a row clear of the boundary")
    check(bool(clear.any()), f"fused_topk.bf16 [{m}x{n_valid}]: no row clear of the boundary")
    del top3, at
    return err


def stream_pair_identity(torch, kernels, q, r, n_valid, kappa, label):
    """The streaming pair and row_max.bf16 on the tensor-core copy of r,
    bit for bit: fused_topk.bf16's best value is row_max.bf16, and with
    tau the global k-th candidate (k = K_PER_ROW per query row, as the
    streaming collection takes it), count_above.bf16 equals the candidates
    >= tau on every row whose kappa-set is not full at tau and where no
    segment holds more than two plain scores >= tau - 2 BF16_TC_ATOL (the
    pool then holds every entry >= tau), and no less elsewhere."""
    m = q.shape[0]
    rt = kernels.pad_columns(r)
    top_v, _ = kernels.fused_topk(q, rt, n_valid, kappa)
    best = kernels.row_max(q, rt, n_valid)
    check(torch.equal(top_v[:, 0].view(torch.int32), best.view(torch.int32)),
          f"{label}: row_max.bf16 differs from fused_topk.bf16's best value on "
          f"{int((top_v[:, 0] != best).sum())} rows")
    finite = int(torch.isfinite(top_v).sum())
    tau = float(torch.topk(top_v.reshape(-1), min(K_PER_ROW * m, finite)).values[-1])
    kept = (top_v >= tau).sum(1)
    counts = kernels.count_above(q, rt, tau, n_valid).long()
    top3, _ = plain_segments(torch, q, r, n_valid)
    clean = (top3[:, :, 2] < tau - 2 * BF16_TC_ATOL).all(1) & (top_v[:, -1] < tau)
    del top3, rt
    check(bool(clean.any()), f"{label}: no row clear of tau")
    check(torch.equal(counts[clean], kept[clean]),
          f"{label}: count_above.bf16 differs from fused_topk.bf16's candidates >= "
          f"tau on {int((counts[clean] != kept[clean]).sum())} clean rows")
    check(bool((counts >= kept).all()), f"{label}: count_above.bf16 below the candidates")
    log(f"phase 2: {label} [{m} x {n_valid} x {q.shape[1]}]: row_max.bf16 == "
        f"fused_topk.bf16's best value bit for bit on all {m} rows; tau {tau!r} "
        f"(k = {K_PER_ROW * m}): count_above.bf16 == candidates >= tau on "
        f"{int(clean.sum())} clean rows, >= on the {int((~clean).sum())} others")


def pool_identity(torch, kernels, q, r, n_valid, label, kappa=32, **kw):
    """The other kernels of the operands' dtype against the pool_writer
    kernel on the same float inputs, bit for bit, as the searcher hands
    them over (bf16: the queries and r padded to a multiple of 8 columns;
    int8: codes r with their ``scale`` in ``kw``): the row max is the
    pool's best winner; fused_topk is the pool's winners ordered and each
    segment's best 2 of scores are the pool (bf16 and int8; the f32
    kernels are held so by compare_topk); and with tau the
    global k-th pool value, k = K_PER_ROW per query row (as the pooled
    collection takes it), the count equals the pool count >= tau on every
    row with amb == 0 (no segment holding two entries >= tau), is no
    smaller elsewhere, and on those other rows alone (the pooled
    collection's count of its ambiguous rows, each at another place in
    its query tile) equals the full call's counts."""
    m, d = q.shape
    k = K_PER_ROW * m
    if r.shape[0] % 128:
        pad = 128 - r.shape[0] % 128
        r = torch.cat([r, r.new_zeros((pad, r.shape[1]))])
        if kw:
            kw = {"scale": torch.cat([kw["scale"], kw["scale"].new_zeros(pad)])}
    bf16, int8 = q.dtype == torch.bfloat16, r.dtype == torch.int8
    if bf16:
        q, r = kernels.pad_columns(q), kernels.pad_columns(r)
    pv, pi = kernels.pool_writer(q, r, n_valid, **kw)
    best = pv.view(m, -1).amax(1)
    got = kernels.row_max(q, r, n_valid, **kw)
    check(torch.equal(got.view(torch.int32), best.view(torch.int32)),
          f"{label}: row_max differs from pool_writer's best winner "
          f"on {int((got != best).sum())} rows")
    suffix = BF16 if bf16 else INT8 if int8 else ""
    if bf16 or int8:
        want = kernels.ordered_topk(pv.view(m, -1), pi.view(m, -1), kappa)
        top = kernels.fused_topk(q, r, n_valid, kappa, **kw)
        check(all(torch.equal(a, b) for a, b in zip(top, want)),
              f"{label}: fused_topk{suffix} (kappa {kappa}) differs from the pool's "
              "winners ordered")
        del want, top
        # The re-search's scores of the first rows: each segment's best 2
        # values are the pool's, and the pool's ids score its values.
        h = min(m, SCORES_ROWS)
        sc = torch.full((h, r.shape[0]), float("-inf"), device=q.device)
        sc[:, :n_valid] = kernels.scores(q[:h], r, n_valid, **kw)
        best2 = torch.topk(sc.view(h, -1, 128), 2, dim=2).values
        ids = pi[:h].view(h, -1).long().clamp(max=r.shape[0] - 1)  # -inf slots
        at = sc.gather(1, ids).view(h, -1, 2)
        finite = torch.isfinite(pv[:h])
        check(torch.equal(best2.view(torch.int32), pv[:h].view(torch.int32))
              and torch.equal(at[finite].view(torch.int32), pv[:h][finite].view(torch.int32)),
              f"{label}: scores{suffix} of the first {h} rows differ from the pool")
        del sc, best2, ids, at
    del pi
    finite = int(torch.isfinite(pv).sum())
    tau = float(torch.topk(pv.reshape(-1), min(k, finite)).values[-1])
    above = pv >= tau
    pool_counts = above.view(m, -1).sum(1)
    amb = above.all(2).sum(1)
    del pv, above
    counts = kernels.count_above(q, r, tau, n_valid, **kw).long()
    clean = amb == 0
    check(torch.equal(counts[clean], pool_counts[clean]),
          f"{label}: count_above differs from the pool count on "
          f"{int((counts[clean] != pool_counts[clean]).sum())} rows with amb == 0")
    check(bool((counts >= pool_counts).all()),
          f"{label}: count_above below the pool count")
    amb_rows = torch.nonzero(~clean, as_tuple=True)[0]
    if amb_rows.numel():
        sub = kernels.count_above(q[amb_rows], r, tau, n_valid, **kw).long()
        check(torch.equal(sub, counts[amb_rows]),
              f"{label}: count_above on the {amb_rows.numel()} rows with amb > 0 "
              "alone differs from the full call's")
    log(f"phase 2: {label} [{m} x {n_valid} x {d}]: row_max{suffix} == "
        f"pool_writer{suffix}'s best winner bit for bit on all {m} rows"
        + (f"; fused_topk{suffix} == its winners ordered (kappa {kappa}); the "
           f"segments' best 2 of scores{suffix} == the pool on the first "
           f"{min(m, SCORES_ROWS)} rows" if bf16 or int8 else "")
        + f"; tau {tau!r} (k = {k}): count_above{suffix} == pool count on "
        f"{int(clean.sum())} rows with amb == 0, >= on the {amb_rows.numel()} "
        "others, and on those rows alone == the full call's")


def phase_kernels_small(torch, kernels, dev):
    """Ragged small shapes, integer-valued and float, ties in a segment."""
    for kind in ("int", "float"):
        q, r = make_inputs(torch, kind, 70, 1000, 33, seed=1, dev=dev)
        compare_row_max(torch, kernels, q, r, 999, kind)
        compare_count_above(torch, kernels, q, r, 4.0 if kind == "int" else 0.2, 999, kind)
        q, r = make_inputs(torch, kind, 200, 4096, 64, seed=2, dev=dev)
        r[[5, 7, 40]] = r[7].clone()  # exact ties inside segment 0
        compare_pool(torch, kernels, q, r, 3000, kind, check_ids_dense=True)
        for kappa in (7, 32, 300):  # 300: more than some blocks' winners
            compare_topk(torch, kernels, q, r, 3000, kappa, kind)
    log("phase 2: small shapes agree (ints exact, floats within "
        f"{FLOAT_ATOL}; fused_topk bit-identical to pool_writer's winners)")


def bf16_rows(torch, kind, n, d, seed, dev, offset=0):
    """[n, d] bf16 rows on the card (integer-valued, or unit-norm floats
    rounded to bf16), ``offset`` elements into their storage: 1 leaves the
    rows 2-byte aligned, so the kernels take 2-byte loads."""
    q, _ = make_inputs(torch, kind, n, 1, d, seed, dev)
    flat = torch.zeros(n * d + offset, dtype=torch.bfloat16, device=dev)
    flat[offset:] = q.reshape(-1)
    return flat[offset:].view(n, d)


def phase_kernels_bf16_small(torch, kernels, dev):
    """The bf16 variants at small ragged shapes, D in {511, 512, 513, 1025},
    rows 16-byte aligned and 2-byte aligned: exact against their plain
    versions on integers; on floats within BF16_TC_ATOL of their plain
    versions and bit for bit against each other (pool_identity,
    stream_pair_identity). Returns their largest float error."""
    tc_err = 0.0
    m, n, n_valid = 150, 5120, 4990
    for d in (511, 512, 513, 1025):
        for offset in (0, 1):
            label = f"bf16 D={d} {'2-byte' if offset else '16-byte'} aligned"
            for kind in ("int", "float"):
                q = bf16_rows(torch, kind, m, d, 20 + d, dev, offset)
                r = bf16_rows(torch, kind, n, d, 21 + d, dev, offset)
                r[n_valid + 10:] = 0
                r[8:14] = r[7]  # exact ties in segment 0, copied by rows 0-2
                q[:3] = r[7]
                if kind == "int":
                    compare_row_max(torch, kernels, q, r, n_valid, "int")
                    for tau in (4.0 * math.isqrt(d), float("-inf")):
                        compare_count_above(torch, kernels, q, r, tau, n_valid, "int")
                    compare_pool(torch, kernels, q, r, n_valid, "int")
                    for kappa in (7, 32, 300):
                        compare_topk(torch, kernels, q, r, n_valid, kappa, "int")
                    scores_above_small(torch, kernels, q, r, n_valid, "int")
                else:
                    tc_err = max(tc_err, compare_row_max(
                        torch, kernels, q, r, n_valid, "float"))
                    tc_err = max(tc_err, compare_pool(
                        torch, kernels, q, r, n_valid, "float", check_ids_dense=True))
                    pool_identity(torch, kernels, q, r, n_valid, label)
                    tc_err = max(tc_err, compare_topk(
                        torch, kernels, q, r, n_valid, 32, "float"))
                    stream_pair_identity(torch, kernels, q, r, n_valid, 32, label)
                    tc_err = max(tc_err, scores_above_small(
                        torch, kernels, q, r, n_valid, "float"))
    log("phase 2: bf16 variants at small shapes: exact on integers; on floats "
        f"within {tc_err} of their plain versions (tolerance {BF16_TC_ATOL}) and "
        "bit for bit against each other (scores_above.bf16: the entries of "
        "nonzero(scores.bf16 >= floor), each once, its scores bit for bit; "
        "capacity 1 launches again for the same set), at D = 511, 512, 513, "
        "1025, 16-byte and 2-byte aligned")
    return tc_err


def kernel_key(torch, name, args):
    """The launch-count key of a wrapper call: <name>[.bf16|.int8]."""
    if args[1].dtype == torch.int8:
        return name + INT8
    return name + (BF16 if args[0].dtype == torch.bfloat16 else "")


def int8_rows(torch, kind, n, d, seed, dev):
    """int8 codes [n, padded_width(d, 16)] (zero pad columns, as the
    searchers stage them) and scales [n] on the card: integer codes with
    power-of-two scales (every score of integer queries exact), or the
    quantized unit-norm rows (quantize_rows_int8)."""
    import numpy as np

    from vsc2022_torch.ops import kernels
    from vsc2022_torch.ops.similarity import quantize_rows_int8

    rng = np.random.default_rng(seed)
    codes = np.zeros((n, kernels.padded_width(d, kernels.I8_ROW_ALIGN)), np.int8)
    if kind == "int":
        codes[:, :d] = rng.integers(-127, 128, (n, d))
        scale = (2.0 ** -rng.integers(0, 8, n)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d), dtype=np.float32)
        codes[:, :d], scale = quantize_rows_int8(x / np.linalg.norm(x, axis=1,
                                                                   keepdims=True))
    return torch.from_numpy(codes).to(dev), torch.from_numpy(scale).to(dev)


def int8_int_queries(torch, m, d, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(-3, 4, (m, d), generator=g, device=dev).float()


def plane_split(torch, plane):
    """A stand-in for kernels.split_bf16x3 on integer rows in [-3, 3]
    (int8_int_queries): the row in one plane (1 mid, 2 lo; 0 hi is the true
    split's (q, 0, 0)) and zeros in the other two, or (plane 3) three
    nonzero integer parts, one a plane, that sum to it. Exact scores then
    prove that a kernel loads and sums every plane: on floats the mid and
    lo planes' share of a score lies below every tolerance."""
    def split(x):
        check(torch.equal(x, x.round()) and float(x.abs().max()) <= 3,
              "plane_split takes integer rows in [-3, 3]")
        terms = torch.zeros((3,) + tuple(x.shape), dtype=torch.bfloat16, device=x.device)
        if plane < 3:
            terms[plane] = x
        else:
            a = x.clamp(-1, 1)
            b = (x - a).clamp(-1, 1)
            terms[0], terms[1], terms[2] = a, b, x - a - b
            check(all(bool(t.any()) for t in terms), "plane_split: an empty part")
        return terms
    return split


def unit_scale_identity(torch, kernels, name, args, label):
    """An int8 kernel on a path's codes with every scale 1 and the queries
    rounded to bf16 against its bf16 kernel on the widened codes, bit for
    bit: the split of a bf16-exact row is (q, 0, 0), so the mid and lo
    passes add exact zeros and the hi pass is the bf16 product."""
    qb = args[0].to(torch.bfloat16)
    q, codes = qb.float(), args[1]
    d = q.shape[1]
    kw = {"scale": torch.ones(codes.shape[0], device=codes.device)}
    wide = codes[:, :d].to(torch.bfloat16).contiguous()
    if name == "row_max":
        n_valid = int(args[2])
        a, b = kernels.row_max(q, codes, n_valid, **kw), kernels.row_max(qb, wide, n_valid)
    elif name == "count_above":
        tau, n_valid = float(args[2]), int(args[3])
        a = kernels.count_above(q, codes, tau, n_valid, **kw)
        b = kernels.count_above(qb, wide, tau, n_valid)
    elif name == "fused_topk":
        n_valid, kappa = int(args[2]), int(args[3])
        a = torch.cat(kernels.fused_topk(q, codes, n_valid, kappa, **kw), 1)
        b = torch.cat(kernels.fused_topk(qb, wide, n_valid, kappa), 1)
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif name == "pool_writer":
        n_valid = int(args[2])
        (av, ai), (bv, bi) = (kernels.pool_writer(q, codes, n_valid, **kw),
                              kernels.pool_writer(qb, wide, n_valid))
        a = torch.cat([av.view(torch.int32).reshape(-1), ai.reshape(-1)])
        b = torch.cat([bv.view(torch.int32).reshape(-1), bi.reshape(-1)])
    elif name == "scores":
        n_valid = int(args[2])
        a, b = kernels.scores(q, codes, n_valid, **kw), kernels.scores(qb, wide, n_valid)
    else:  # scores_above: its entries are scores' (compare_scores_above)
        return
    check(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                      b.view(torch.int32) if b.dtype == torch.float32 else b),
          f"{label}: {name}.int8 with unit scales and bf16-exact queries differs "
          f"from {name}.bf16 on the widened codes")
    log(f"phase 2: {label}: {name}.int8 with unit scales and bf16-exact queries == "
        f"{name}.bf16 on the widened codes, bit for bit [{q.shape[0]} x "
        f"{codes.shape[0]} x {d}]")


def phase_kernels_int8_small(torch, kernels, dev):
    """The int8 variants at small ragged shapes, D in {511, 512, 1025}:
    exact against their plain versions on integer queries and power-of-two
    scales, also with the queries' split replaced by plane_split's (each
    plane alone, then all three); on quantized unit rows within FLOAT_ATOL of their plain
    versions, bit for bit against each other (pool_identity,
    scores_above_small) and, with unit scales and bf16-exact queries,
    against their bf16 kernels. Returns the largest float error."""
    err = 0.0
    m, n, n_valid = 150, 5120, 4990
    for d in (511, 512, 1025):
        label = f"int8 D={d}"
        for kind in ("int", "float"):
            codes, scale = int8_rows(torch, kind, n, d, 30 + d, dev)
            codes[n_valid + 10:], scale[n_valid + 10:] = 0, 0.0
            codes[8:14], scale[8:14] = codes[7], scale[7]  # ties in segment 0
            if kind == "int":
                q = int8_int_queries(torch, m, d, 31 + d, dev)
            else:
                q, _ = make_inputs(torch, "float", m, 1, d, 31 + d, dev)
            kw = {"scale": scale}
            if kind == "int":
                split = kernels.split_bf16x3
                for plane in (None, 1, 2, 3):
                    if plane is not None:
                        kernels.split_bf16x3 = plane_split(torch, plane)
                    try:
                        compare_row_max(torch, kernels, q, codes, n_valid, "int", **kw)
                        for tau in (40.0, float("-inf")):
                            compare_count_above(torch, kernels, q, codes, tau, n_valid,
                                                "int", **kw)
                        compare_pool(torch, kernels, q, codes, n_valid, "int", **kw)
                        for kappa in (7, 32, 300):
                            compare_topk(torch, kernels, q, codes, n_valid, kappa, "int",
                                         **kw)
                        compare_scores(torch, kernels, q, codes, n_valid, "int", **kw)
                        scores_above_small(torch, kernels, q, codes, n_valid, "int", **kw)
                    finally:
                        kernels.split_bf16x3 = split
                log(f"phase 2: {label}: the six int8 kernels exact on integer queries "
                    "split as (q, 0, 0), as (0, q, 0), as (0, 0, q) and as three "
                    "nonzero integer parts: every query plane is loaded and summed")
                continue
            err = max(err, compare_row_max(torch, kernels, q, codes, n_valid, "float", **kw),
                      compare_pool(torch, kernels, q, codes, n_valid, "float",
                                   check_ids_dense=True, **kw),
                      compare_scores(torch, kernels, q, codes, n_valid, "float", **kw),
                      scores_above_small(torch, kernels, q, codes, n_valid, "float", **kw))
            compare_topk(torch, kernels, q, codes, n_valid, 32, "float", **kw)
            pool_identity(torch, kernels, q, codes, n_valid, label, **kw)
            for name, args in (("row_max", (q, codes, n_valid)),
                               ("count_above", (q, codes, 0.3, n_valid)),
                               ("fused_topk", (q, codes, n_valid, 32)),
                               ("pool_writer", (q, codes, n_valid)),
                               ("scores", (q, codes, n_valid))):
                unit_scale_identity(torch, kernels, name, args, label)
    log("phase 2: int8 variants at small shapes: exact on integers; on floats "
        f"within {err} of their plain versions (tolerance {FLOAT_ATOL}), bit for "
        "bit against each other (scores_above.int8: the entries of "
        "nonzero(scores.int8 >= floor), each once; capacity 1 launches again for "
        "the same set) and, with unit scales and bf16-exact queries, against the "
        "bf16 kernels, at D = 511, 512, 1025")
    return err


def dense_route(torch, kernels, q, r, n_valid, floor, **kw):
    """The re-search before scores_above.bf16 (.int8): dense scores.bf16
    (scores.int8) in chunks of PLAIN_CHUNK_ELEMENTS scores (whole 128-row
    items), then ``>= floor``, ``nonzero`` and the gather, chunk by chunk."""
    budget = kernels.PLAIN_CHUNK_ELEMENTS // n_valid
    step = budget - budget % kernels.REDUCE_TILE if budget >= kernels.REDUCE_TILE else budget
    parts = []
    for s0 in range(0, q.shape[0], max(step, 1)):
        sc = kernels.scores(q[s0:s0 + step], r, n_valid, **kw)
        rr, cc = torch.nonzero(sc >= floor[s0:s0 + step, None], as_tuple=True)
        parts.append((sc[rr, cc], rr + s0, cc))
    return parts


def scores_above_kernel_ms(torch, kernels, q, r, n_valid, floor, capacity, scale=None):
    """Milliseconds of scores_above.bf16's (over int8 codes with their
    ``scale``: scores_above.int8's) kernel alone: back-to-back launches
    into one preallocated capacity that holds every entry, with no counter
    read (the wrapper's one sync left out; the int8 queries split once,
    outside). Launched through the library, so they count nowhere."""
    from vsc2022_torch.ops import _build

    m = q.shape[0]
    if scale is None:
        q, r = kernels.pad_columns(q), kernels.pad_columns(r)
        cname, operands = "scores_above_bf16", (q, r)
    else:
        terms = kernels.split_bf16x3(kernels.pad_columns(q, kernels.I8_ROW_ALIGN))
        cname, operands = "scores_above_int8", (terms, r, scale)
    grid = kernels.wgmma_grid(m, n_valid, kernels._wgmma_slots(q, cname))
    out = [torch.empty(max(capacity, 1), dtype=t, device=q.device)
           for t in (torch.float32, torch.int32, torch.int32)]
    count = torch.empty(1, dtype=torch.int64, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch():
        rc = getattr(_build.library(), f"vsc_{cname}")(
            q.device.index, *(t.data_ptr() for t in operands), floor.data_ptr(), m,
            r.shape[0], r.shape[1], n_valid, grid, capacity,
            *(t.data_ptr() for t in out), count.data_ptr(), stream)
        check(rc == 0, f"vsc_{cname} failed to launch ({rc})")

    return cuda_ms(torch, launch, 5)


def peak_bytes(torch, fn) -> int:
    """Device memory ``fn`` allocates at its peak beyond what was
    allocated before (``torch.cuda.max_memory_allocated``)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - before


def scores_above_records(torch, kernels, dev, args, path):
    """scores_above.bf16 (scores_above.int8) on the inputs a path's
    re-search gave it (q, refs, n_valid, floor, capacity[, scale]): exact
    against its plain version on integer inputs of the same shape
    (int_floors), and on the path's inputs held against dense scores.bf16
    (scores.int8) bit for bit and its plain version within BF16_TC_ATOL
    (compare_scores_above). Timed with the path's capacity beside its
    plain version, the library product (bf16: ``torch.mm`` with f32 out;
    int8: cuBLAS f32 over the widened codes, times the scales: the same
    scores, ``library_ms``), the library route to the same entries (the
    product, ``>= floor``, ``nonzero``, the gather) and the dense route it
    replaced (``dense_route``); where the re-search took more than 512
    rows, also on the first 512 (the dense route's first chunk at
    serving). Bound: operations against bytes (operands once, the floor,
    12 bytes an emitted entry). Then the dense kernel's own record on the
    same operands (phase_kernels_main). Returns {key: record}."""
    q, r, n_valid, floor, capacity = args[0], args[1], int(args[2]), args[3], args[4]
    int8 = r.dtype == torch.int8
    kw = {"scale": args[5]} if int8 else {}
    key = SCORES_ABOVE_INT8 if int8 else SCORES_ABOVE
    (m, d), n = q.shape, r.shape[0]
    if int8:
        ri, sci = int8_rows(torch, "int", n, d, 3, dev)
        qi, kwi = int8_int_queries(torch, m, d, 3, dev), {"scale": sci}
        compare_scores_above(torch, kernels, qi, ri, n_valid,
                             int_floors(torch, m, d, dev, sigma=146.6), "int", **kwi)
        del sci, kwi
    else:
        qi, ri = make_inputs(torch, "int", m, n, d, seed=3, dev=dev)
        compare_scores_above(torch, kernels, qi.bfloat16(), ri.bfloat16(), n_valid,
                             int_floors(torch, m, d, dev), "int")
    del qi, ri
    torch.cuda.empty_cache()
    err = compare_scores_above(torch, kernels, q, r, n_valid, floor, "float", capacity,
                               **kw)
    torch.cuda.empty_cache()
    entries = kernels.scores_above(q, r, n_valid, floor, capacity=capacity, **kw)[0].numel()
    ms = cuda_ms(torch, lambda: kernels.scores_above(q, r, n_valid, floor,
                                                     capacity=capacity, **kw), 3)
    kernel_ms = scores_above_kernel_ms(torch, kernels, q, r, n_valid, floor,
                                       max(capacity, entries), kw.get("scale"))
    plain_ms = cuda_ms(torch, lambda: kernels.scores_above_plain(q, r, n_valid, floor,
                                                                 **kw), 1)
    torch.cuda.empty_cache()
    if int8:
        sc = kw["scale"]

        def product():
            return torch.matmul(q, r[:n_valid, :d].float().T) * sc[:n_valid]

        def lib_route():
            s_ = product()
            rr, cc = torch.nonzero(s_ >= floor[:, None], as_tuple=True)
            return s_[rr, cc], rr, cc

        library_ms, route_ms = cuda_ms(torch, product, 1), cuda_ms(torch, lib_route, 1)
    else:
        library_ms, route_ms = scores_library_f32(torch, q, r, n_valid, floor)
    torch.cuda.empty_cache()
    dense_ms = cuda_ms(torch, lambda: dense_route(torch, kernels, q, r, n_valid, floor,
                                                  **kw), 1)
    torch.cuda.empty_cache()
    peak = peak_bytes(torch, lambda: kernels.scores_above(q, r, n_valid, floor,
                                                         capacity=capacity, **kw))
    dense_peak = peak_bytes(torch, lambda: dense_route(torch, kernels, q, r, n_valid,
                                                       floor, **kw))
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound(m, n_valid, n, d, 4 * m + 12 * entries, bf16=not int8,
                               int8=int8)
    rec = {"shape": [m, n_valid, d], "max_abs_err": err, "ms": ms,
           "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_route_ms": route_ms,
           "dense_route_ms": dense_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "entries": entries, "capacity": capacity, "peak_bytes": peak,
           "dense_route_peak_bytes": dense_peak}
    extra = ""
    if m > 512:
        h = 512
        h_cap = kernels.scores_above(q[:h], r, n_valid, floor[:h], **kw)[0].numel()
        h_lib = (cuda_ms(torch, lambda: torch.matmul(q[:h], r[:n_valid, :d].float().T)
                         * kw["scale"][:n_valid], 1) if int8
                 else scores_library_f32(torch, q[:h], r, n_valid))
        rec["head"] = {
            "rows": h,
            "ms": cuda_ms(torch, lambda: kernels.scores_above(
                q[:h], r, n_valid, floor[:h], capacity=h_cap, **kw), 3),
            "library_ms": h_lib,
            "dense_ms": cuda_ms(torch, lambda: kernels.scores(q[:h], r, n_valid, **kw), 3),
            "bound_ms": bound(h, n_valid, n, d, 4 * h + 12 * h_cap, bf16=not int8,
                              int8=int8)[0],
        }
        extra = f"; the first {h} rows: {json.dumps(rec['head'])}"
        torch.cuda.empty_cache()
    log(f"phase 2: {key} on the {path} path's inputs [{m} x {n_valid} x {d}]: "
        f"{entries} entries (capacity {capacity}) kernel_ms={ms:.3f} (the wrapper, "
        f"its sync included; the kernel alone {kernel_ms:.3f}) "
        f"plain_ms={plain_ms:.3f} library_ms={library_ms} ("
        + ("cuBLAS f32 over the widened codes x scales" if int8 else "torch.mm, f32 out")
        + f") library_route_ms={route_ms} dense_route_ms={dense_ms:.3f} (scores"
        f"{INT8 if int8 else BF16} chunks + nonzero) bound_ms={bound_ms:.3f} "
        f"({bound_by}) max_abs_err={err}; peak device memory {peak} bytes (the dense "
        f"route {dense_peak})" + extra)
    records = {key: rec}
    records.update(phase_kernels_main(torch, kernels, dev,
                                      {"scores": (q, r, n_valid) + tuple(kw.values())},
                                      path))
    return records


def phase_kernels_main(torch, kernels, dev, captured, path="sscd"):
    """Each retrieval kernel on the inputs a path gave it (its first call
    there), and on integer-valued inputs of the same shape; the kernels of
    one dtype against each other on the inputs of row_max, count_above and
    pool_writer (pool_identity) and, in bf16, of fused_topk
    (stream_pair_identity); timings and bounds from those inputs. bf16
    inputs run the bf16 variants, each timed beside its f32 kernel on the
    widened inputs (f32_ms); their library call is a cuBLAS bf16 product.
    int8 inputs (codes with their scale) run the int8 variants, timed
    beside the f32 kernel on the widened codes (f32_ms) and the bf16 kernel
    on the widened codes and the queries rounded to bf16 (bf16_ms: one
    pass where they take three); their library call is cuBLAS f32 over the
    widened codes, times the scales. Their refs may carry the searcher's
    zero pad columns; their timed calls pad the queries (no copy when the
    path padded them). Returns {key: record}, keyed as the launch counts."""
    records = {}
    for name, args in captured.items():
        if name == "chamfer":
            continue
        if name == "scores_above":
            records.update(scores_above_records(torch, kernels, dev, args, path))
            continue
        q, r = args[0], args[1]
        bf16, int8 = q.dtype == torch.bfloat16, r.dtype == torch.int8
        # An int8 call's scale came as its last (keyword) argument.
        kw = {"scale": args[-1]} if int8 else {}
        sc = kw.get("scale")
        n_valid = int(args[3] if name == "count_above" else args[2])
        key = kernel_key(torch, name, args)
        (m, dd), n = q.shape, r.shape[0]
        if int8:
            ri, sci = int8_rows(torch, "int", n, dd, 3, dev)
            qi, kwi = int8_int_queries(torch, m, dd, 3, dev), {"scale": sci}
        else:
            qi, ri = make_inputs(torch, "int", m, n, dd, seed=3, dev=dev)
            kwi = {}
        if bf16:
            qi, ri = qi.to(torch.bfloat16), ri.to(torch.bfloat16)
        if name == "row_max":
            compare_row_max(torch, kernels, qi, ri, n_valid, "int", **kwi)
        elif name == "count_above":
            compare_count_above(torch, kernels, qi, ri, 40.0, n_valid, "int", **kwi)
        elif name == "fused_topk":
            compare_topk(torch, kernels, qi, ri, n_valid, int(args[3]), "int", **kwi)
        elif name == "scores":
            compare_scores(torch, kernels, qi, ri, n_valid, "int", **kwi)
        else:
            compare_pool(torch, kernels, qi, ri, n_valid, "int", **kwi)
        del qi, ri, kwi
        torch.cuda.empty_cache()
        label = f"{path} {key} inputs"
        if name != "fused_topk" or int8:
            pool_identity(torch, kernels, q, r, n_valid, label, **kw)
            torch.cuda.empty_cache()
        if name == "fused_topk" and bf16:
            stream_pair_identity(torch, kernels, q, r, n_valid, int(args[3]), label)
            torch.cuda.empty_cache()
        if int8:
            unit_scale_identity(torch, kernels, name, args, label)
            torch.cuda.empty_cache()
        if name == "row_max":
            err = compare_row_max(torch, kernels, q, r, n_valid, "float", **kw)
            call = lambda a, b, **k: kernels.row_max(a, b, n_valid, **k)  # noqa: E731
            plain = lambda: kernels.row_max_plain(q, r, n_valid, **kw)  # noqa: E731
            lib = lambda: row_max_library(torch, q, r, n_valid, sc)  # noqa: E731
            out_bytes = 4 * m
        elif name == "count_above":
            tau = float(args[2])
            err = compare_count_above(torch, kernels, q, r, tau, n_valid, "float", **kw)
            call = lambda a, b, **k: kernels.count_above(a, b, tau, n_valid, **k)  # noqa: E731
            plain = lambda: kernels.count_above_plain(q, r, tau, n_valid, **kw)  # noqa: E731
            lib = lambda: count_above_library(torch, q, r, tau, n_valid, sc)  # noqa: E731
            out_bytes = 4 * m
        elif name == "fused_topk":
            kappa = int(args[3])
            err = compare_topk(torch, kernels, q, r, n_valid, kappa, "float", **kw)
            call = lambda a, b, **k: kernels.fused_topk(a, b, n_valid, kappa, **k)  # noqa: E731
            plain = lambda: kernels.fused_topk_plain(q, r, n_valid, kappa, **kw)  # noqa: E731
            lib = lambda: topk_library(torch, q, r, n_valid, kappa, sc)  # noqa: E731
            out_bytes = 8 * m * kappa
        elif name == "scores":
            err = compare_scores(torch, kernels, q, r, n_valid, "float", **kw)
            call = lambda a, b, **k: kernels.scores(a, b, n_valid, **k)  # noqa: E731
            plain = lambda: kernels.scores_plain(q, r, n_valid, **kw)  # noqa: E731
            if int8:  # cuBLAS f32 over the widened codes, then the scales
                lib = lambda: (torch.matmul(q, r[:n_valid, :dd].float().T)  # noqa: E731
                               * sc[:n_valid])
            else:  # cuBLAS bf16 with bf16 output (f32 output: scores_library_f32)
                lib = lambda: torch.matmul(q, r[:n_valid, :dd].T)  # noqa: E731
            out_bytes = 4 * m * n_valid
        else:
            err = compare_pool(torch, kernels, q, r, n_valid, "float", **kw)
            call = lambda a, b, **k: kernels.pool_writer(a, b, n_valid, **k)  # noqa: E731
            plain = lambda: kernels.pool_writer_plain(q, r, n_valid, **kw)  # noqa: E731
            lib = lambda: pool_library(torch, q, r, n_valid, sc)  # noqa: E731
            out_bytes = 8 * m * (n // 128) * 2
        torch.cuda.empty_cache()
        kernel_ms = cuda_ms(torch, lambda: call(q, r, **kw), 3)
        plain_ms = cuda_ms(torch, plain, 1)
        library_ms = cuda_ms(torch, lib, 1)
        bound_ms, bound_by = bound(m, n_valid, n, dd, out_bytes, bf16=bf16, int8=int8)
        records[key] = {
            "shape": [m, n_valid, dd] + ([int(args[3])] if name == "fused_topk" else []),
            "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        extra = ""
        if name == "scores" and bf16:
            f32_out = scores_library_f32(torch, q, r, n_valid)
            if f32_out is not None:
                # The same function as scores.bf16: the library column.
                records[key]["library_bf16_out_ms"] = library_ms
                records[key]["library_ms"] = f32_out
                extra = (f" library f32-out {f32_out:.3f} ms (bf16-out "
                         f"{library_ms:.3f} ms)")
        if (bf16 or int8) and name != "scores":  # scores has no f32 kernel
            # Without the tensor-core kernels' pad columns; int8 codes
            # widened, without their scales (the f32 kernel's work on the
            # same values).
            qf, rf = q[:, :r.shape[1]].float(), r[:, :q.shape[1]].float().contiguous()
            records[key]["f32_ms"] = cuda_ms(torch, lambda: call(qf, rf), 3)
            extra = (f" f32_ms={records[key]['f32_ms']:.3f} (the f32 kernel on the "
                     "widened inputs)")
            del qf, rf
            torch.cuda.empty_cache()
        if int8:  # one bf16 pass where the int8 kernel takes three
            qb, rb = q.to(torch.bfloat16), r[:, :dd].to(torch.bfloat16).contiguous()
            records[key]["bf16_ms"] = cuda_ms(torch, lambda: call(qb, rb), 3)
            extra += (f" bf16_ms={records[key]['bf16_ms']:.3f} (the bf16 kernel on the "
                      "widened codes, the queries rounded)")
            del qb, rb
            torch.cuda.empty_cache()
        log(f"phase 2: {key} on the {path} path's inputs [{m} x {n_valid} x {dd}] "
            f"kernel_ms={kernel_ms:.3f} plain_ms={plain_ms:.3f} "
            f"library_ms={library_ms:.3f} bound_ms={bound_ms:.3f} ({bound_by}) "
            f"max_abs_err={err}{extra}")
    return records


# ---- phase 3: global_topk against a dense oracle ---------------------------


@contextlib.contextmanager
def collection_mode(mode):
    """Force global_topk's collection mode while the block runs."""
    import os

    from vsc2022_torch.ops.similarity import COLLECTION_ENV

    old = os.environ.get(COLLECTION_ENV)
    os.environ[COLLECTION_ENV] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ[COLLECTION_ENV]
        else:
            os.environ[COLLECTION_ENV] = old


def phase_search(torch, np, dev, m, n, d, k):
    for dtype in ("float32", "bfloat16", "int8"):
        for mode in ("stream", "pooled"):
            with collection_mode(mode):
                search_vs_oracle(torch, np, dev, m, n, d, k, mode, dtype)


def search_vs_oracle(torch, np, dev, m, n, d, k, mode, dtype):
    """The oracle scores the inputs as the searcher stages them (bf16:
    rounded to nearest even, then widened; int8: cuBLAS f32 over the
    widened codes, times the scales: the dequantized corpus)."""
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    for kind in ("int", "float"):
        q, r = make_inputs(torch, kind, m, n, d, seed=5, dev=dev)
        # Planted near-duplicate columns inside one segment, copied by the
        # first queries: ambiguous rows, counted and re-searched.
        if kind == "int":
            r[256:276] = 3.0
            q[:8] = 3.0
        else:
            g = torch.Generator(device=dev)
            g.manual_seed(6)
            dup = r[256] + 0.01 * torch.randn((20, d), generator=g, device=dev)
            r[256:276] = dup / dup.norm(dim=1, keepdim=True)
            q[:8] = r[256]
        searcher = SimilaritySearcher(r.cpu().numpy(), dtype=dtype, device=dev)
        t0 = time.perf_counter()
        qi, ri, s = searcher.global_topk(q.cpu().numpy(), k)
        t_search = time.perf_counter() - t0
        if dtype == "bfloat16":
            q, r = q.bfloat16().float(), r.bfloat16().float()
        if dtype == "int8":
            check(searcher._refs.dtype == torch.int8 and searcher._tc_copy is None,
                  "the int8 searcher staged another corpus than its codes")
            scores = (torch.matmul(q, searcher._refs[:n, :d].float().T)
                      * searcher._scale[:n])
        else:
            scores = torch.matmul(q, r.T)
        kth = torch.topk(scores.reshape(-1), k).values[-1]
        rr, cc = torch.nonzero(scores >= kth, as_tuple=True)
        vals = scores[rr, cc].cpu().numpy()
        rr, cc = rr.cpu().numpy(), cc.cpu().numpy()
        order = np.lexsort((cc, rr, -vals))[:k]
        oq, orr, os_ = rr[order], cc[order], vals[order]
        del scores
        if kind == "int":
            check(np.array_equal(qi, oq) and np.array_equal(ri, orr)
                  and np.array_equal(s, os_),
                  "global_topk differs from the dense oracle on integer inputs")
            verdict = "identical to the dense oracle (tie order included)"
        else:
            check(len(qi) == k, f"global_topk float: {len(qi)} pairs, not {k}")
            check(bool((np.diff(s) <= 0).all()), "global_topk float: not sorted")
            err = float(np.abs(s - os_).max())
            check(err <= FLOAT_ATOL, f"global_topk float: scores off by {err}")
            # Pairs within the tolerance of the k-th score may swap members;
            # every pair clear of it on either side is in the other's set.
            edge = float(os_[-1]) + 2 * FLOAT_ATOL
            got, want = set(zip(qi, ri)), set(zip(oq, orr))
            check({(a, b) for a, b, v in zip(oq, orr, os_) if v > edge} <= got
                  and {(a, b) for a, b, v in zip(qi, ri, s) if v > edge} <= want,
                  "global_topk float: pair set differs from the oracle")
            verdict = (f"all {k} pairs, scores within {err} of the dense oracle, "
                       f"same pairs above the k-th score + {2 * FLOAT_ATOL}")
        check(searcher.last_stats["mode"] == mode,
              f"global_topk ran {searcher.last_stats['mode']}, not {mode}")
        log(f"phase 3: global_topk {dtype} {mode} {kind} [{m} x {n} x {d}] k={k} "
            f"{verdict}; {t_search:.3f} s; {searcher.last_stats}")
        del searcher, q, r
        torch.cuda.empty_cache()


# ---- phase 4: the main path on a planted synthetic corpus ------------------


def build_corpus(np, out_dir: Path, n_q, n_ref, n_noise_frames, frames, d, seed):
    """Planted-copy corpus. Query videos copy a segment of a reference
    video with noise; some copies come from near-static reference
    segments, whose frames crowd one pool segment (ambiguous rows)."""
    from vsc2022_torch.metrics import Dataset, Match
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature

    rng = np.random.default_rng(seed)

    def unit_rows(n):
        x = rng.standard_normal((n, d), dtype=np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return x

    ts = np.arange(frames, dtype=np.float64)
    refs = unit_rows(n_ref * frames).reshape(n_ref, frames, d)
    queries = unit_rows(n_q * frames).reshape(n_q, frames, d)
    n_copies = (2 * n_q) // 3
    n_static = max(1, n_copies // 4)
    gt = []
    src = rng.choice(n_ref, size=n_copies, replace=False)
    for i in range(n_copies):
        j = int(src[i])
        length = int(rng.integers(12, 30))
        a = int(rng.integers(0, frames - length))
        b = int(rng.integers(0, frames - length))
        if i < n_static:
            base = refs[j, a]
            static = base + 0.02 * rng.standard_normal((length, d), dtype=np.float32)
            refs[j, a:a + length] = static / np.linalg.norm(static, axis=1, keepdims=True)
        noisy = refs[j, a:a + length] + (0.4 / math.sqrt(d)) * rng.standard_normal(
            (length, d), dtype=np.float32)
        queries[i, b:b + length] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
        gt.append(Match(f"Q{i:06d}", f"R{j:06d}", 1.0, float(b), float(b + length),
                        float(a), float(a + length)))
    n_noise = -(-n_noise_frames // frames)
    noise = unit_rows(n_noise * frames).reshape(n_noise, frames, d)

    def videos(arr, offset=0):
        return [VideoFeature(video_id=offset + i, timestamps=ts, feature=arr[i])
                for i in range(arr.shape[0])]

    paths = {k: str(out_dir / f"{k}.npz") for k in ("queries", "refs", "noise")}
    store_features(paths["queries"], videos(queries), Dataset.QUERIES)
    store_features(paths["refs"], videos(refs), Dataset.REFS)
    store_features(paths["noise"], videos(noise, offset=n_ref + 1000), Dataset.REFS)
    paths["gt"] = str(out_dir / "gt.csv")
    Match.write_csv(gt, paths["gt"])
    return paths, n_noise * frames


def small_cuda_vs_cpu(np, out_dir: Path):
    """The whole driver on a small integer-valued corpus, on the card and
    on the CPU: exact scores, so the candidate and match files agree byte
    for byte."""
    from vsc2022_torch.baseline import sscd_baseline
    from vsc2022_torch.metrics import Dataset
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature

    rng = np.random.default_rng(7)
    d = 64

    def vids(n_vid, offset=0):
        return [VideoFeature(video_id=offset + i,
                             timestamps=np.arange(40, dtype=np.float64),
                             feature=rng.integers(-3, 4, (40, d)).astype(np.float32))
                for i in range(n_vid)]

    refs = vids(300)
    queries = vids(12)
    for i in range(6):
        queries[i].feature[10:25] = refs[i * 7].feature[5:20]
    store_features(str(out_dir / "sq.npz"), queries, Dataset.QUERIES)
    store_features(str(out_dir / "sr.npz"), refs, Dataset.REFS)
    outs = {}
    for device in ("cuda", "cpu"):
        out = out_dir / f"small_{device}"
        sscd_baseline.main(sscd_baseline.parser.parse_args([
            "--query_features", str(out_dir / "sq.npz"),
            "--ref_features", str(out_dir / "sr.npz"),
            "--output_path", str(out), "--overwrite", "--device", device,
        ]))
        outs[device] = [(out / f).read_bytes() for f in ("candidates.csv", "matches.csv")]
    n_cand = outs["cuda"][0].count(b"\n") - 1
    check(n_cand > 0 and outs["cuda"][0] == outs["cpu"][0],
          "small integer corpus: cuda and cpu candidates.csv differ")
    # The matches localize on L2-normalized features, whose similarities
    # cuBLAS and the CPU may round differently: reported, not required.
    same = outs["cuda"][1] == outs["cpu"][1]
    log(f"phase 4: small integer corpus: candidates.csv cuda == cpu byte for "
        f"byte ({n_cand} rows); matches.csv "
        + ("identical" if same else "differs (float rounding in TN sims)"))


@contextlib.contextmanager
def capture_inputs(kernels, keep_all=()):
    """Keep the arguments of each kernel wrapper's first non-empty call
    while the block runs, {name: args}, or of all of them for the kernels
    in ``keep_all``, {name: [args, ...]}; keyword arguments follow the
    positional ones. The wrappers' launch counts are untouched."""
    seen = {}
    originals = {name: getattr(kernels, fn) for name, fn in WRAPPERS.items()}

    def keep(name, fn):
        def call(*args, **kwargs):
            if args[0].shape[0]:
                full = args + tuple(kwargs.values())
                if name in keep_all:
                    seen.setdefault(name, []).append(full)
                else:
                    seen.setdefault(name, full)
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(kernels, WRAPPERS[name], keep(name, fn))
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(kernels, WRAPPERS[name], fn)


@contextlib.contextmanager
def search_stats():
    """The last_stats of every SimilaritySearcher.global_topk call while
    the block runs, in call order, with the staged corpus it searched:
    its dtype, its device bytes (``staged_bytes``) and whether a second
    (tensor-core) copy is held."""
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    seen = []
    original = SimilaritySearcher.global_topk

    def global_topk(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        seen.append({k: v for k, v in self.last_stats.items() if k != "seconds"})
        seen[-1]["corpus"] = {"dtype": str(self._refs.dtype).split(".")[-1],
                              "rows": int(self._refs.shape[0]),
                              "bytes": self.staged_bytes(),
                              "copy": self._tc_copy is not None}
        return out

    SimilaritySearcher.global_topk = global_topk
    try:
        yield seen
    finally:
        SimilaritySearcher.global_topk = original


@contextlib.contextmanager
def capture_dns_batches():
    """The arguments of every ``dns_baseline._gathered_dns_sims`` call while
    the block runs, [(args, kwargs), ...] in call order: the staged device
    tables, each batch's index matrices, the bias and ``symmetric``."""
    from vsc2022_torch.baseline import dns_baseline

    seen = []
    original = dns_baseline._gathered_dns_sims

    def gathered(*args, **kwargs):
        seen.append((args, kwargs))
        return original(*args, **kwargs)

    dns_baseline._gathered_dns_sims = gathered
    try:
        yield seen
    finally:
        dns_baseline._gathered_dns_sims = original


def log_research_chunks(phase, label, stats, args, launches, key):
    """The re-search's rows per launch, logged before phase 2 times its
    kernel on its first call (``args``). ``stats``: the last_stats of the
    path's searches in call order; ``launches``: the path's launches of
    ``key``, the scores_above kernel of the corpus's dtype (bf16 or int8).
    Each re-search is one launch over all its rows, so the first launch
    takes the first search's re-searched rows and the launches are the
    searches that re-searched."""
    rows = [st["corpus_rows"] for st in stats if st.get("corpus_rows")]
    check(args is not None and bool(rows), f"{label}: no row was re-searched")
    n, first = int(args[2]), args[0].shape[0]
    check(first == rows[0] and launches == len(rows),
          f"{label}: the first re-search launch took {first} of {rows[0]} rows; "
          f"{launches} launches for {len(rows)} re-searches")
    log(f"phase {phase}: {label}: one {key} launch per re-search "
        f"({launches}), the first over all its {first} rows x {n} corpus rows "
        f"(capacity {args[4]}); {sum(rows)} rows re-searched")


def phase_main_path(torch, np, kernels):
    """Returns the launch counts of the main path's run, the inputs each
    kernel was first given there, the corpus paths and the driver's
    result."""
    from vsc2022_torch import descriptor_eval
    from vsc2022_torch.baseline import sscd_baseline
    from vsc2022_torch.metrics import CandidatePair, Match

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    small_cuda_vs_cpu(np, SMOKE_DIR)

    t0 = time.perf_counter()
    paths, n_noise = build_corpus(np, SMOKE_DIR, N_QUERY_VIDEOS, N_REF_VIDEOS,
                                  N_NOISE_FRAMES, FRAMES, DIM, seed=0)
    log(f"phase 4: corpus {N_QUERY_VIDEOS} query videos "
        f"({N_QUERY_VIDEOS * FRAMES} frames), {N_REF_VIDEOS} ref videos "
        f"({N_REF_VIDEOS * FRAMES} frames), {n_noise} noise frames, D={DIM}; "
        f"made in {time.perf_counter() - t0:.1f} s")

    out = SMOKE_DIR / "out"
    argv = ["--query_features", paths["queries"], "--ref_features", paths["refs"],
            "--score_norm_features", paths["noise"], "--ground_truth", paths["gt"],
            "--output_path", str(out), "--overwrite", "--device", "cuda"]
    args = sscd_baseline.parser.parse_args(argv)
    with capture_inputs(kernels) as captured, search_stats() as stats:
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = sscd_baseline.main(args)
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    log(f"phase 4: sscd_baseline {wall:.2f} s; stages (s): "
        + json.dumps({k: round(v, 3) for k, v in result["stages"].items()}))
    log(f"phase 4: global_topk last_stats: {json.dumps(stats)}")
    log(f"phase 4: kernel launches on the main path: {json.dumps(launches)}")
    log("phase 4: first inputs per kernel: " + json.dumps({
        name: [list(args[0].shape), list(args[1].shape)] for name, args in captured.items()
    }))
    log(f"phase 4: candidate uAP {result['candidate_uap']:.4f}, "
        f"segment AP {result['segment_ap']:.4f}")
    for name in SSCD_KERNELS:
        check(launches[name] > 0 and name in captured,
              f"kernel {name} never launched on the main path")

    cands = CandidatePair.read_csv(str(out / "candidates.csv"))
    matches = Match.read_csv(str(out / "matches.csv"))
    check(0 < len(cands) <= 25 * N_QUERY_VIDEOS, f"{len(cands)} candidates")
    check(len(matches) > 0, "no matches")
    check(all(math.isfinite(c.score) for c in cands), "non-finite candidate score")
    check(all(math.isfinite(m.score) for m in matches), "non-finite match score")
    check(result["candidate_uap"] > 0.5, f"candidate uAP {result['candidate_uap']}")
    check(result["segment_ap"] > 0.2, f"segment AP {result['segment_ap']}")

    t0 = time.perf_counter()
    uap = descriptor_eval.main(descriptor_eval.parser.parse_args([
        "--query_features", paths["queries"], "--ref_features", paths["refs"],
        "--ground_truth", paths["gt"], "--candidates_output",
        str(out / "descriptor_candidates.csv"), "--device", "cuda",
    ]))
    log(f"phase 4: descriptor_eval {time.perf_counter() - t0:.2f} s, "
        f"uAP {uap:.4f} (raw descriptors, no score normalization)")
    check(uap is not None and uap > 0.3, f"descriptor_eval uAP {uap}")
    return launches, captured, paths, dict(result, descriptor_uap=uap, stats=stats)


def phase_main_path_bf16(torch, np, kernels, paths, f32):
    """Phase 4b: the same entry points with --bf16 on phase 4's corpus (the
    noise-NN and the retrieval over bf16 corpora; localization f32). Logs
    stage seconds, last_stats and quality beside the f32 run's (``f32``,
    phase 4's result); returns the launch counts and the bf16 kernels'
    first inputs."""
    from vsc2022_torch import descriptor_eval
    from vsc2022_torch.baseline import sscd_baseline

    out = SMOKE_DIR / "out_bf16"
    args = sscd_baseline.parser.parse_args([
        "--query_features", paths["queries"], "--ref_features", paths["refs"],
        "--score_norm_features", paths["noise"], "--ground_truth", paths["gt"],
        "--output_path", str(out), "--overwrite", "--device", "cuda", "--bf16"])
    with capture_inputs(kernels) as captured, search_stats() as stats:
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = sscd_baseline.main(args)
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    log(f"phase 4b: sscd_baseline --bf16 {wall:.2f} s; stages (s): "
        + json.dumps({k: round(v, 3) for k, v in result["stages"].items()})
        + "; f32 (phase 4): "
        + json.dumps({k: round(v, 3) for k, v in f32["stages"].items()}))
    log(f"phase 4b: global_topk last_stats: {json.dumps(stats)}; f32: "
        f"{json.dumps(f32['stats'])}")
    log(f"phase 4b: kernel launches on the bf16 path: {json.dumps(launches)}")
    log_research_chunks("4b", "sscd_baseline --bf16", stats,
                        captured.get("scores_above"), launches[SCORES_ABOVE], SCORES_ABOVE)
    check(launches["scores" + BF16] == 0, "the bf16 path launched the dense scores.bf16")
    log(f"phase 4b: candidate uAP {result['candidate_uap']:.4f}, segment AP "
        f"{result['segment_ap']:.4f}; f32: {f32['candidate_uap']:.4f}, "
        f"{f32['segment_ap']:.4f}")
    for name in SSCD_BF16_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the bf16 path")
    for name in SSCD_KERNELS:
        check(captured[name][0].dtype == torch.bfloat16,
              f"the bf16 path handed {name} {captured[name][0].dtype} operands")
    f32_launched = [k for k in kernels.RETRIEVAL_KERNELS + ("chamfer",) if launches[k]]
    check(not f32_launched, f"the bf16 path reached the f32 kernels {f32_launched}")
    # The pooled count reads the pool's own operands: the padded queries'
    # rows and the same corpus tensor.
    pool_args, count_args = captured["pool_writer"], captured["count_above"]
    check(count_args[1] is pool_args[1] and count_args[0].shape[1] == pool_args[0].shape[1],
          "the pooled count and the pool read different operands")
    check(result["candidate_uap"] > 0.5, f"bf16 candidate uAP {result['candidate_uap']}")
    check(result["segment_ap"] > 0.2, f"bf16 segment AP {result['segment_ap']}")
    t0 = time.perf_counter()
    uap = descriptor_eval.main(descriptor_eval.parser.parse_args([
        "--query_features", paths["queries"], "--ref_features", paths["refs"],
        "--ground_truth", paths["gt"], "--candidates_output",
        str(out / "descriptor_candidates.csv"), "--device", "cuda", "--bf16",
    ]))
    log(f"phase 4b: descriptor_eval --bf16 {time.perf_counter() - t0:.2f} s, uAP "
        f"{uap:.4f}; f32: {f32['descriptor_uap']:.4f}")
    check(uap is not None and uap > 0.3, f"descriptor_eval --bf16 uAP {uap}")
    return launches, captured, dict(result, descriptor_uap=uap)


def numpy_sq8(np, rows):
    """SQ8 codes and scales of f32 rows in numpy (the JAX package's
    formula): the plain version of the searchers' device quantization."""
    scale = (np.abs(rows).max(axis=1) / 127.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = np.where(scale > 0, 1.0 / scale, 0.0).astype(np.float32)
    return np.clip(np.rint(rows * inv[:, None]), -127, 127).astype(np.int8), scale


def device_quantization_is_numpys(torch, np, sn_refs):
    """The int8 searcher's quantization on the card against numpy's, bit
    for bit, on every fourth score-normalized reference row of phase 4c
    (the rows its search corpus quantized, ones column included)."""
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    with np.load(sn_refs) as z:
        rows = np.ascontiguousarray(z["features"][::4], dtype=np.float32)
    searcher = SimilaritySearcher(rows, dtype="int8", device="cuda")
    codes, scale = numpy_sq8(np, rows)
    n, d = rows.shape
    check(np.array_equal(searcher._refs[:n, :d].cpu().numpy(), codes)
          and np.array_equal(searcher._scale[:n].cpu().numpy().view(np.uint32),
                             scale.view(np.uint32)),
          "the searcher's quantization on the card differs from numpy's")
    log(f"phase 4c: the searcher's quantization on the card == numpy's, bit for "
        f"bit, on {n} x {d} score-normalized reference rows")


def phase_main_path_int8(torch, np, kernels, paths, f32, bf16):
    """Phase 4c: the same entry points with --int8 on phase 4's corpus (the
    noise-NN and the retrieval over int8 codes with per-row scales, the
    queries f32; localization f32). Logs stage seconds, last_stats, the
    staged corpus bytes and quality beside the f32 and bf16 runs' (``f32``,
    ``bf16``: phase 4's and 4b's results); checks that every searched
    corpus is int8 codes and scales only. Returns the launch counts, the
    int8 kernels' first inputs and sscd_baseline's result."""
    from vsc2022_torch import descriptor_eval
    from vsc2022_torch.baseline import sscd_baseline

    out = SMOKE_DIR / "out_int8"
    args = sscd_baseline.parser.parse_args([
        "--query_features", paths["queries"], "--ref_features", paths["refs"],
        "--score_norm_features", paths["noise"], "--ground_truth", paths["gt"],
        "--output_path", str(out), "--overwrite", "--device", "cuda", "--int8"])
    with capture_inputs(kernels) as captured, search_stats() as stats:
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = sscd_baseline.main(args)
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    log(f"phase 4c: sscd_baseline --int8 {wall:.2f} s; stages (s): "
        + json.dumps({k: round(v, 3) for k, v in result["stages"].items()})
        + "; f32 (phase 4): "
        + json.dumps({k: round(v, 3) for k, v in f32["stages"].items()})
        + "; bf16 (phase 4b): "
        + json.dumps({k: round(v, 3) for k, v in bf16["stages"].items()}))
    log(f"phase 4c: global_topk last_stats: {json.dumps(stats)}; f32: "
        f"{json.dumps(f32['stats'])}")
    log(f"phase 4c: kernel launches on the int8 path: {json.dumps(launches)}")
    log_research_chunks("4c", "sscd_baseline --int8", stats,
                        captured.get("scores_above"), launches[SCORES_ABOVE_INT8],
                        SCORES_ABOVE_INT8)
    check(launches["scores" + INT8] == 0, "the int8 path launched the dense scores.int8")
    log(f"phase 4c: candidate uAP {result['candidate_uap']:.4f}, segment AP "
        f"{result['segment_ap']:.4f}; f32: {f32['candidate_uap']:.4f}, "
        f"{f32['segment_ap']:.4f}; bf16: {bf16['candidate_uap']:.4f}, "
        f"{bf16['segment_ap']:.4f}")
    for name in SSCD_INT8_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the int8 path")
    for name in SSCD_KERNELS:
        check(captured[name][1].dtype == torch.int8
              and captured[name][0].dtype == torch.float32,
              f"the int8 path handed {name} {captured[name][0].dtype} queries and "
              f"{captured[name][1].dtype} refs")
    other = [k for k, c in launches.items() if c and not k.endswith(INT8)]
    check(not other, f"the int8 path reached the kernels {other}")
    pool_args, count_args = captured["pool_writer"], captured["count_above"]
    check(count_args[1] is pool_args[1] and count_args[-1] is pool_args[-1]
          and count_args[0].shape[1] == pool_args[0].shape[1],
          "the pooled count and the pool read different operands")
    # The searched corpus: codes and scales only (no f32 or padded copy).
    corpus = stats[0]["corpus"]
    f32_bytes = f32["stats"][0]["corpus"]["bytes"]
    check(all(st["corpus"]["dtype"] == "int8" and not st["corpus"]["copy"]
              for st in stats), f"an int8 search read another corpus: {stats}")
    codes = pool_args[1]
    check(corpus["bytes"] == codes.numel() + 4 * codes.shape[0],
          f"the int8 corpus holds {corpus['bytes']} bytes, not its codes and scales")
    log(f"phase 4c: the staged search corpus: {corpus['rows']} x {codes.shape[1]} "
        f"int8 codes + {corpus['rows']} f32 scales = {corpus['bytes']} bytes "
        f"({corpus['bytes'] / f32_bytes:.3f} of the f32 corpus's {f32_bytes}); "
        f"the noise corpus: {captured['row_max'][1].shape[0]} x "
        f"{captured['row_max'][1].shape[1]} {captured['row_max'][1].dtype}")
    check(result["candidate_uap"] > 0.5, f"int8 candidate uAP {result['candidate_uap']}")
    check(result["segment_ap"] > 0.2, f"int8 segment AP {result['segment_ap']}")
    device_quantization_is_numpys(torch, np, out / "sn_refs.npz")
    t0 = time.perf_counter()
    uap = descriptor_eval.main(descriptor_eval.parser.parse_args([
        "--query_features", paths["queries"], "--ref_features", paths["refs"],
        "--ground_truth", paths["gt"], "--candidates_output",
        str(out / "descriptor_candidates.csv"), "--device", "cuda", "--int8",
    ]))
    log(f"phase 4c: descriptor_eval --int8 {time.perf_counter() - t0:.2f} s, uAP "
        f"{uap:.4f}; f32: {f32['descriptor_uap']:.4f}")
    check(uap is not None and uap > 0.3, f"descriptor_eval --int8 uAP {uap}")
    return launches, captured, dict(result, descriptor_uap=uap)


# ---- phase 5: the DnS track ---------------------------------------------------


def dns_raw_rows(np, rng, n):
    """[n, 9 * 3840] fp16 raw L3-iMAC rows, each region at unit norm."""
    x = rng.standard_normal((n, DNS_REGIONS, DNS_RAW_DIM), dtype=np.float32)
    x /= np.linalg.norm(x, axis=2, keepdims=True)
    return x.reshape(n, -1).astype(np.float16)


def dns_student_variables(np, rng, student):
    """A student's Flax variable tree (the names dns_student_from_jax
    reads), lecun-scaled normal kernels and context, zero biases."""
    def kernel(fan_in, fan_out):
        return (rng.standard_normal((fan_in, fan_out), dtype=np.float32)
                * np.float32(math.sqrt(1.0 / fan_in)))

    params = {
        "reduction": {"kernel": kernel(DNS_RAW_DIM, 512),
                      "bias": np.zeros(512, np.float32)},
        "attention": {"context": kernel(512, 1)},
    }
    if student == "cg":
        params["project"] = {"kernel": kernel(512, 1024),
                             "bias": np.zeros(1024, np.float32)}
    return {"params": params}


def build_dns_corpus(np, out_dir: Path, n_q, n_ref, n_noise, n_planted, seed):
    """Raw-row corpus with planted copies (a reference segment, each
    region with noise at a 0.3 ratio) and the two students' weights."""
    from vsc2022_torch.metrics import Dataset, Match
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature
    from vsc2022_torch.utils.checkpoint import save_variables

    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(DNS_FRAMES[0], DNS_FRAMES[1] + 1, size=n_q + n_ref + n_noise)
    videos = [dns_raw_rows(np, rng, int(n)) for n in lengths]
    queries, refs, noise = videos[:n_q], videos[n_q:n_q + n_ref], videos[n_q + n_ref:]
    gt = []
    for i, j in enumerate(rng.choice(n_ref, size=n_planted, replace=False)):
        q, r = queries[i], refs[int(j)]
        length = min(int(rng.integers(DNS_COPY[0], DNS_COPY[1] + 1)), len(q), len(r))
        a = int(rng.integers(0, len(r) - length + 1))
        b = int(rng.integers(0, len(q) - length + 1))
        seg = r[a:a + length].astype(np.float32).reshape(length, DNS_REGIONS, -1)
        seg += (0.3 / math.sqrt(DNS_RAW_DIM)) * rng.standard_normal(
            seg.shape, dtype=np.float32)
        seg /= np.linalg.norm(seg, axis=2, keepdims=True)
        q[b:b + length] = seg.reshape(length, -1).astype(np.float16)
        gt.append(Match(f"Q{i:06d}", f"R{int(j):06d}", 1.0, float(b),
                        float(b + length), float(a), float(a + length)))

    def vids(rows, offset=0):
        return [VideoFeature(video_id=offset + i,
                             timestamps=np.arange(len(x), dtype=np.float64), feature=x)
                for i, x in enumerate(rows)]

    paths = {k: str(out_dir / f"{k}_raw.npz") for k in ("queries", "refs", "noise")}
    store_features(paths["queries"], vids(queries), Dataset.QUERIES)
    store_features(paths["refs"], vids(refs), Dataset.REFS)
    store_features(paths["noise"], vids(noise, offset=n_ref + 1000), Dataset.REFS)
    paths["gt"] = str(out_dir / "gt.csv")
    Match.write_csv(gt, paths["gt"])
    for student in ("cg", "fg"):
        paths[student] = str(out_dir / f"{student}_student.npz")
        save_variables(paths[student], dns_student_variables(np, rng, student))
    return paths, int(lengths.sum())


def run_dns(paths, work: Path, device: str):
    """dns_index (cg with score normalization, fg att), then dns_baseline
    with --ground_truth. Returns each entry point's result and the output
    directory."""
    from vsc2022_torch.baseline import dns_baseline, dns_index

    idx, out = work / "idx", work / "out"
    common = ["--query_features", paths["queries"], "--ref_features", paths["refs"],
              "--output_path", str(idx), "--device", device]
    results = {
        "dns_index cg": dns_index.main(dns_index.parser.parse_args(common + [
            "--student", "cg", "--checkpoint_path", paths["cg"],
            "--score_norm_features", paths["noise"]])),
        "dns_index fg": dns_index.main(dns_index.parser.parse_args(common + [
            "--student", "fg", "--fg_type", "att", "--checkpoint_path", paths["fg"]])),
    }
    results["dns_baseline"] = dns_baseline.main(dns_baseline.parser.parse_args([
        "--query_coarse_features", str(idx / "queries_cg_student_sn.npz"),
        "--ref_coarse_features", str(idx / "refs_cg_student_sn.npz"),
        "--query_fine_features", str(idx / "queries_fg_att_student.npz"),
        "--ref_fine_features", str(idx / "refs_fg_att_student.npz"),
        "--ground_truth", paths["gt"], "--output_path", str(out), "--overwrite",
        "--device", device,
    ]))
    return results, out


def _csv_rows(path: Path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def small_dns_cuda_vs_cpu(np, work: Path):
    """The DnS entry points on a small corpus on the card and on the CPU: the
    same candidate and match rows, scores within FLOAT_ATOL."""
    paths, _ = build_dns_corpus(np, work, 6, 24, 6, 4, seed=11)
    outs = {d: run_dns(paths, work / d, d)[1] for d in ("cuda", "cpu")}
    for name in ("candidates.csv", "matches.csv"):
        a, b = _csv_rows(outs["cuda"] / name), _csv_rows(outs["cpu"] / name)
        check(len(a) == len(b) and len(a) > 1 and a[0] == b[0],
              f"small DnS corpus: {name} has {len(a)} rows on cuda, {len(b)} on cpu")
        score = a[0].index("score")
        for x, y in zip(a[1:], b[1:]):
            check(x[:score] + x[score + 1:] == y[:score] + y[score + 1:]
                  and abs(float(x[score]) - float(y[score])) <= FLOAT_ATOL,
                  f"small DnS corpus: {name} differs: {x} vs {y}")
    log(f"phase 5: small DnS corpus: candidates.csv and matches.csv agree on "
        f"cuda and cpu ({len(_csv_rows(outs['cuda'] / 'matches.csv')) - 1} "
        f"matches, scores within {FLOAT_ATOL})")


def phase_dns_path(torch, np, kernels):
    """Returns the DnS path's launch counts, the inputs its kernels were
    given there (every chamfer call; the first call of the others) and the
    arguments of its fused similarity batches (``_gathered_dns_sims``)."""
    from vsc2022_torch.metrics import CandidatePair, Match

    work = SMOKE_DIR / "dns"
    work.mkdir(parents=True, exist_ok=True)
    small_dns_cuda_vs_cpu(np, work / "small")

    t0 = time.perf_counter()
    paths, frames = build_dns_corpus(np, work, DNS_QUERIES, DNS_REFS, DNS_NOISE,
                                     DNS_PLANTED, seed=1)
    log(f"phase 5: corpus {DNS_QUERIES} query, {DNS_REFS} ref, {DNS_NOISE} noise "
        f"videos of {DNS_FRAMES[0]}-{DNS_FRAMES[1]} frames ({frames} frames, raw "
        f"rows {DNS_REGIONS} x {DNS_RAW_DIM} fp16, "
        f"{frames * DNS_REGIONS * DNS_RAW_DIM * 2 / 1e9:.2f} GB), {DNS_PLANTED} "
        f"planted copies; made in {time.perf_counter() - t0:.1f} s")

    with capture_inputs(kernels, keep_all=("chamfer",)) as captured, \
            search_stats() as stats, capture_dns_batches() as batches:
        kernels.reset_launches()
        t0 = time.perf_counter()
        results, out = run_dns(paths, work, "cuda")
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    log(f"phase 5: global_topk last_stats: {json.dumps(stats)}")
    for name, res in results.items():
        log(f"phase 5: {name} stages (s): "
            + json.dumps({k: round(v, 3) for k, v in res["stages"].items()}))
    log(f"phase 5: DnS path {wall:.2f} s; kernel launches: {json.dumps(launches)}")
    calls = captured.get("chamfer", [])
    log("phase 5: chamfer calls [B, NQ, NR]: " + json.dumps(
        [[a[0].shape[0], a[0].shape[1], a[1].shape[1]] for a in calls]))
    res = results["dns_baseline"]
    log(f"phase 5: candidate uAP {res['candidate_uap']:.4f}, "
        f"segment AP {res['segment_ap']:.4f}")
    for name in DNS_KERNELS:
        check(launches[name] > 0 and name in captured,
              f"kernel {name} never launched on the DnS path")
    # DnSLocalization stays at precision "highest", as JAX's: one f32
    # chamfer per batch, no chamfer.bf16 (phase 5d drives that one).
    check(len(batches) == launches["chamfer"] and launches["chamfer.bf16"] == 0,
          f"{len(batches)} similarity batches, launches {launches}")

    with np.load(work / "idx" / "queries_cg_student_sn.npz") as z:
        check(z["features"].shape[1] == 1025 and z["features"].dtype == np.float32,
              f"coarse features {z['features'].shape} {z['features'].dtype}")
        check(bool(np.isfinite(z["features"]).all()), "non-finite coarse features")
    with np.load(work / "idx" / "refs_fg_att_student.npz") as z:
        check(z["features"].shape[1] == DNS_REGIONS * 512
              and z["features"].dtype == np.float16,
              f"fine features {z['features'].shape} {z['features'].dtype}")
    cands = CandidatePair.read_csv(str(out / "candidates.csv"))
    matches = Match.read_csv(str(out / "matches.csv"))
    check(0 < len(cands) <= 25 * DNS_QUERIES, f"{len(cands)} DnS candidates")
    check(len(matches) > 0, "no DnS matches")
    check(all(math.isfinite(c.score) for c in cands + matches), "non-finite DnS score")
    check(res["candidate_uap"] >= 0.9, f"DnS candidate uAP {res['candidate_uap']}")
    check(res["segment_ap"] > 0, f"DnS segment AP {res['segment_ap']}")
    return launches, captured, batches


def chamfer_bound(b, nq, nr, d, bf16=False):
    """f32 operands at the f32 CUDA-core peak; bf16 ones (2 bytes a value)
    at the bf16 tensor-core peak. The output is f32."""
    flops = 2.0 * b * (nq * DNS_REGIONS) * (nr * DNS_REGIONS) * d
    moved = (2.0 if bf16 else 4.0) * b * (nq + nr) * DNS_REGIONS * d + 4.0 * b * nq * nr
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, moved / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_chamfer(torch, kernels, dev, calls):
    """The chamfer kernel on every input the DnS path gave it (within
    FLOAT_ATOL of the plain version) and on integer-valued inputs of the
    largest call's shape (exact); times on the largest call, and the
    kernel's, plain version's and library call's times and the bound
    summed over all the path's calls."""
    err = 0.0
    total_ms = total_plain = total_lib = total_bound = 0.0
    for qf, rf, sym in calls:
        got = kernels.chamfer_fine_sims(qf, rf, sym)
        want = kernels.chamfer_fine_sims_plain(qf, rf, sym)
        err = max(err, float((got - want).abs().max()))
        total_ms += cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qf, rf, sym), 3)
        total_plain += cuda_ms(torch, lambda: kernels.chamfer_fine_sims_plain(qf, rf, sym), 1)
        total_lib += cuda_ms(torch, lambda: chamfer_library(torch, qf, rf, sym), 1)
        total_bound += chamfer_bound(qf.shape[0], qf.shape[1], rf.shape[1], qf.shape[3])[0]
    check(err <= FLOAT_ATOL, f"chamfer on the DnS path's inputs: max abs err {err}")
    qf, rf, sym = max(calls, key=lambda a: a[0].shape[0] * a[0].shape[1] * a[1].shape[1])
    (b, nq, _, d), nr = qf.shape, rf.shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    qi = torch.randint(-3, 4, qf.shape, generator=g, device=dev).float()
    ri = torch.randint(-3, 4, rf.shape, generator=g, device=dev).float()
    qi[:, nq // 2:] = 0.0  # zero-pad frames
    int_err = float((kernels.chamfer_fine_sims(qi, ri, sym)
                     - kernels.chamfer_fine_sims_plain(qi, ri, sym)).abs().max())
    check(int_err == 0.0, f"chamfer on integer inputs [{b}, {nq}, {nr}]: err {int_err}")
    del qi, ri
    kernel_ms = cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qf, rf, sym), 5)
    plain_ms = cuda_ms(torch, lambda: kernels.chamfer_fine_sims_plain(qf, rf, sym), 2)
    library_ms = cuda_ms(torch, lambda: chamfer_library(torch, qf, rf, sym), 2)
    lib_err = float((chamfer_library(torch, qf, rf, sym)
                     - kernels.chamfer_fine_sims_plain(qf, rf, sym)).abs().max())
    check(lib_err <= FLOAT_ATOL, f"chamfer library yardstick off by {lib_err}")
    bound_ms, bound_by = chamfer_bound(b, nq, nr, d)
    log(f"phase 5: chamfer on the DnS path's largest call [B={b}, NQ={nq}, NR={nr}, "
        f"D={d}] kernel_ms={kernel_ms:.3f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.3f} bound_ms={bound_ms:.3f} ({bound_by}); "
        f"all {len(calls)} calls: kernel {total_ms:.3f} ms, plain {total_plain:.3f} ms, "
        f"library {total_lib:.3f} ms, bound {total_bound:.3f} ms; "
        f"max_abs_err={err} (floats), 0 (integers)")
    return {
        "shape": [b, nq, nr, d], "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
        "path_total": {"calls": len(calls), "ms": total_ms, "plain_ms": total_plain,
                       "library_ms": total_lib, "bound_ms": total_bound},
    }


# ---- phase 5d: the DnS fine similarity at precision "default" ----------------


def chamfer_library_bf16_kw(torch, dev):
    """The bf16 chamfer's library yardstick: one bf16 torch.bmm with an f32
    result (``out_dtype``), the same function as chamfer.bf16; where this
    torch has no such call on the card, the bf16-output product stands in
    (logged). Returns (bmm keywords, what ran)."""
    x = torch.ones((1, 8, 8), dtype=torch.bfloat16, device=dev)
    try:
        torch.bmm(x, x, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        log(f"phase 5d: torch {torch.__version__} has no bf16 bmm with f32 output on "
            f"the card ({type(e).__name__}: {str(e).splitlines()[0][:120]}); the "
            "bf16-output bmm stands in")
        return {}, "bf16 bmm with bf16 output"
    return {"out_dtype": torch.float32}, "bf16 bmm with f32 output"


def chamfer_bf16_launch_plan(torch, kernels, dev, b, nq, nr, d) -> dict:
    """chamfer.bf16's plan of a call (kernels.chamfer_bf16_plan) with the
    kernel's resident blocks per SM, registers and local (spill) bytes a
    thread at the plan's ref slices."""
    import ctypes

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = kernels.chamfer_bf16_plan(b, nq, nr, d, sms)
    blocks, regs, local = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = kernels._build.library().vsc_chamfer_bf16_attributes(
        dev.index, plan.slots, ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(local))
    check(rc == 0 and blocks.value >= 1,
          f"chamfer.bf16 attributes query failed (cudaError {rc}, {blocks.value} blocks)")
    return dict(plan._asdict(), blocks_per_sm=blocks.value, registers=regs.value,
                local_bytes=local.value)


def phase_chamfer_bf16(torch, kernels, dev, calls, batches, entry_launches):
    """Phase 5d: chamfer.bf16 on every chamfer input of phase 5 rounded to
    bf16 (within BF16_TC_ATOL of its plain version), on integer inputs of
    the largest call's shape with zero-pad frames (exact), timed beside
    the plain version, the library call and the f32 kernel on the same
    rounded rows (f32_ms); then the path function, the port's
    ``_gathered_dns_sims(..., precision="default")`` on phase 5's staged
    tables and each of its batches' index matrices, with the launch counts
    zeroed just before and read just after, held against the same
    function on the plain chamfer. Returns (record, launches)."""
    from vsc2022_torch.baseline import dns_baseline

    bf16 = torch.bfloat16
    lib_kw, lib_what = chamfer_library_bf16_kw(torch, dev)
    err = 0.0
    totals = dict.fromkeys(("ms", "plain_ms", "library_ms", "f32_ms", "bound_ms"), 0.0)
    for qf, rf, sym in calls:
        qb, rb = qf.to(bf16), rf.to(bf16)
        got = kernels.chamfer_fine_sims(qb, rb, sym)
        err = max(err, float((got - kernels.chamfer_fine_sims_plain(qb, rb, sym)).abs().max()))
        del got
        totals["ms"] += cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qb, rb, sym), 3)
        totals["plain_ms"] += cuda_ms(
            torch, lambda: kernels.chamfer_fine_sims_plain(qb, rb, sym), 1)
        totals["library_ms"] += cuda_ms(
            torch, lambda: chamfer_library(torch, qb, rb, sym, **lib_kw), 1)
        qw, rw = qb.float(), rb.float()
        totals["f32_ms"] += cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qw, rw, sym), 3)
        totals["bound_ms"] += chamfer_bound(qb.shape[0], qb.shape[1], rb.shape[1],
                                            qb.shape[3], bf16=True)[0]
        del qb, rb, qw, rw
    check(err <= BF16_TC_ATOL, f"chamfer.bf16 on the DnS path's inputs: max abs err {err}")
    torch.cuda.empty_cache()

    qf, rf, sym = max(calls, key=lambda a: a[0].shape[0] * a[0].shape[1] * a[1].shape[1])
    (b, nq, _, d), nr = qf.shape, rf.shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    qi = torch.randint(-3, 4, qf.shape, generator=g, device=dev).to(bf16)
    ri = torch.randint(-3, 4, rf.shape, generator=g, device=dev).to(bf16)
    qi[:, nq // 2:] = 0.0  # zero-pad frames on both sides
    ri[:, nr - nr // 4:] = 0.0
    for s_ in (sym, not sym):
        got = kernels.chamfer_fine_sims(qi, ri, s_)
        int_err = float((got - kernels.chamfer_fine_sims_plain(qi, ri, s_)).abs().max())
        check(int_err == 0.0, f"chamfer.bf16 on integer inputs [{b}, {nq}, {nr}] "
              f"symmetric={s_}: err {int_err}")
        check(bool((got[:, nq // 2:] == 0).all() and (got[:, :, nr - nr // 4:] == 0).all()),
              "chamfer.bf16: a zero-pad frame scored non-zero")
    del qi, ri, got
    torch.cuda.empty_cache()

    qb, rb = qf.to(bf16), rf.to(bf16)
    kernel_ms = cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qb, rb, sym), 5)
    plain_ms = cuda_ms(torch, lambda: kernels.chamfer_fine_sims_plain(qb, rb, sym), 2)
    library_ms = cuda_ms(torch, lambda: chamfer_library(torch, qb, rb, sym, **lib_kw), 2)
    lib_err = float((chamfer_library(torch, qb, rb, sym, **lib_kw)
                     - kernels.chamfer_fine_sims_plain(qb, rb, sym)).abs().max())
    if lib_kw:
        check(lib_err <= BF16_TC_ATOL, f"chamfer.bf16 library yardstick off by {lib_err}")
    qw, rw = qb.float(), rb.float()
    f32_ms = cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qw, rw, sym), 5)
    del qb, rb, qw, rw
    torch.cuda.empty_cache()
    bound_ms, bound_by = chamfer_bound(b, nq, nr, d, bf16=True)
    plan = chamfer_bf16_launch_plan(torch, kernels, dev, b, nq, nr, d)
    log(f"phase 5d: chamfer.bf16 (TMA + wgmma.m64n144k16, RT={plan['rt']} ref frames an "
        f"item, ref tile {'resident' if plan['resident'] else 'streamed'} in "
        f"{plan['slots']} slices, {plan['items']} items on a persistent grid of "
        f"{plan['grid']}, {plan['blocks_per_sm']} block(s) per SM, {plan['smem_bytes']} B "
        f"shared, {plan['registers']} registers, {plan['local_bytes']} local bytes a "
        f"thread) on the DnS path's largest call rounded "
        f"to bf16 [B={b}, NQ={nq}, NR={nr}, D={d}] kernel_ms={kernel_ms:.3f} "
        f"plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} ({lib_what}; max abs "
        f"err {lib_err}) f32_ms={f32_ms:.3f} (the f32 chamfer on the same rows) "
        f"bound_ms={bound_ms:.3f} ({bound_by}); all {len(calls)} calls: kernel "
        f"{totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, library "
        f"{totals['library_ms']:.3f} ms, f32 {totals['f32_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.3f} ms; max_abs_err={err} (floats), 0 (integers)")

    def run(precision):
        return [dns_baseline._gathered_dns_sims(*args, **dict(kw, precision=precision))
                for args, kw in batches]

    kernels.reset_launches()
    sims = run("default")
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches["chamfer.bf16"] == len(batches) > 0
          and sum(launches.values()) == len(batches),
          f"the path function at default over {len(batches)} batches launched {launches}")
    highest = run("highest")
    original = kernels.chamfer_fine_sims
    kernels.chamfer_fine_sims = kernels.chamfer_fine_sims_plain
    try:
        plain = run("default")
    finally:
        kernels.chamfer_fine_sims = original
    path_err = vs_highest = 0.0
    for got, want, hi in zip(sims, plain, highest):
        check(got.shape == want.shape == hi.shape and bool(torch.isfinite(got).all()),
              f"path function at default: {tuple(got.shape)} vs {tuple(hi.shape)}")
        path_err = max(path_err, float((got - want).abs().max()))
        vs_highest = max(vs_highest, float((got - hi).abs().max()))
    check(path_err <= BF16_TC_ATOL,
          f"_gathered_dns_sims at default: {path_err} from the plain chamfer's")
    default_ms = cuda_ms(torch, lambda: run("default"), 1)
    highest_ms = cuda_ms(torch, lambda: run("highest"), 1)
    del sims, plain, highest
    torch.cuda.empty_cache()
    log(f"phase 5d: _gathered_dns_sims(precision='default') over phase 5's "
        f"{len(batches)} batches: launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"the entry points (phase 5) launched chamfer.bf16 "
        f"{entry_launches['chamfer.bf16']} times (DnSLocalization stays at 'highest'); "
        f"max abs err against the plain chamfer {path_err}; largest difference from "
        f"the 'highest' sims {vs_highest} (reported, not checked); all batches "
        f"{default_ms:.3f} ms at default, {highest_ms:.3f} ms at highest")
    record = {
        "shape": [b, nq, nr, d], "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "f32_ms": f32_ms, "plan": plan,
        "path_total": dict(totals, calls=len(calls)),
        "path_function": {"batches": len(batches), "max_abs_err": path_err,
                          "max_diff_from_highest": vs_highest, "ms": default_ms,
                          "highest_ms": highest_ms},
    }
    return record, launches["chamfer.bf16"]


# ---- phase 6: the resident server ---------------------------------------------


def extra_refs(np, n_videos, frames, d, first_id, seed):
    """Unit-norm random reference videos with ids from ``first_id``."""
    from vsc2022_torch.types import VideoFeature

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_videos, frames, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=2, keepdims=True)
    ts = np.arange(frames, dtype=np.float64)
    return [VideoFeature(video_id=first_id + i, timestamps=ts, feature=x[i])
            for i in range(n_videos)]


def check_same_candidates(got, want, what, tol=1e-6):
    """Identical (query, ref) rows in the same order, scores within tol."""
    check(len(got) > 0 and [(c.query_id, c.ref_id) for c in got]
          == [(c.query_id, c.ref_id) for c in want],
          f"{what}: candidate pairs differ ({len(got)} vs {len(want)} rows)")
    err = max(abs(a.score - b.score) for a, b in zip(got, want))
    check(err <= tol, f"{what}: scores differ by {err} > {tol}")
    return err


def check_same_rows(a_path, b_path, what, tol=FLOAT_ATOL):
    """Two CSVs with identical rows apart from scores within tol."""
    a, b = _csv_rows(a_path), _csv_rows(b_path)
    check(len(a) == len(b) and len(a) > 1 and a[0] == b[0],
          f"{what}: {len(a)} rows against {len(b)}")
    score = a[0].index("score")
    for x, y in zip(a[1:], b[1:]):
        check(x[:score] + x[score + 1:] == y[:score] + y[score + 1:]
              and abs(float(x[score]) - float(y[score])) <= tol,
              f"{what}: {x} vs {y}")
    return len(a) - 1


def spawn_server(ref_path, log_file, **kw):
    import os

    from vsc2022_torch.retrieval.client import ServeClient

    env = dict(os.environ, PYTHONPATH=str(REPO))
    return ServeClient.spawn(ref_path, device="cuda", env=env, cwd=str(REPO),
                             stderr=log_file, **kw)


def timed(label, fn, phase="6"):
    """fn()'s result, its wall seconds logged (and the server's own)."""
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    server = getattr(out, "seconds", None)
    log(f"phase {phase}: ({label}) {wall:.3f} s"
        + (f" (server {server:.3f} s)" if server else ""))
    return out


def serve_corpus(np):
    """Phase 6's catalogue files and features, shared by both dtypes."""
    from vsc2022_torch.metrics import Dataset, Match
    from vsc2022_torch.storage import load_features, store_features

    work = SMOKE_DIR / "serve"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths, n_noise = build_corpus(np, work, N_QUERY_VIDEOS, SERVE_REF_VIDEOS,
                                  SERVE_NOISE_FRAMES, FRAMES, DIM, seed=2)
    store_features(str(work / "add.npz"),
                   extra_refs(np, SERVE_ADD, FRAMES, DIM, first_id=20_000, seed=3),
                   Dataset.REFS)
    c = {"work": work, "paths": paths,
         "queries": load_features(paths["queries"], Dataset.QUERIES),
         "refs": load_features(paths["refs"], Dataset.REFS),
         "noise": load_features(paths["noise"], Dataset.REFS),
         "added": load_features(str(work / "add.npz"), Dataset.REFS)}
    gt_refs = {m.ref_id for m in Match.read_csv(paths["gt"], is_gt=True)}
    c["removed"] = [vf.video_id for vf in c["refs"]
                    if vf.video_id not in gt_refs][:SERVE_REMOVE]
    store_features(str(work / "q1.npz"), c["queries"][:1], Dataset.QUERIES)
    log(f"phase 6: catalogue {SERVE_REF_VIDEOS} ref videos ({SERVE_REF_VIDEOS * FRAMES} "
        f"frames), {N_QUERY_VIDEOS} query videos, {n_noise} noise frames, D={DIM}; "
        f"made in {time.perf_counter() - t0:.1f} s")
    return c


SERVE_DTYPES = {  # dtype: (tag, phase, server flags, kernels of a search)
    "float32": ("f32", "6", {"f32": True}, SERVE_KERNELS),
    "bfloat16": ("bf16", "6b", {}, SERVE_BF16_KERNELS),
    "int8": ("int8", "6c", {"int8": True}, SERVE_INT8_KERNELS),
}


def phase_serve(torch, np, kernels, dev, corpus, dtype="float32"):
    """Drives the server through requests (a)-(h) and checks them against
    an in-process ScoreNormalizedVideoIndex over the same live corpus.
    ``dtype``: "float32" (--f32, phase 6), "bfloat16" (no dtype flag, the
    JAX package's default, phase 6b) or "int8" (--int8, phase 6c). Returns
    the server's launch counts over (a)-(h), the kernel inputs of the same
    search run in-process (bf16 and int8: the re-search's scores too), the
    launch counts and the inputs of pool_writer (and scores) of that search
    forced to the pool, and (a)'s quality (with 13d's probe after (g))."""
    import logging

    from vsc2022_torch.baseline import pipeline
    from vsc2022_torch.metrics import CandidatePair
    from vsc2022_torch.retrieval.candidates import MaxScoreAggregation, rank_candidates
    from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex

    tag, phase, flags, search_kernels = SERVE_DTYPES[dtype]
    suffix = {"bfloat16": BF16, "int8": INT8}.get(dtype, "")
    work, paths = corpus["work"], corpus["paths"]
    queries, refs, removed = corpus["queries"], corpus["refs"], corpus["removed"]
    csv = {x: (str(work / f"{tag}_{x}_c.csv"), str(work / f"{tag}_{x}_m.csv"))
           for x in ("a", "c", "g", "fresh")}
    snap = str(work / f"{tag}_snap.npz")

    def step(label, fn):
        return timed(label, fn, phase)

    with open(work / f"server_{tag}.log", "w") as server_log:
        with spawn_server(paths["refs"], server_log, score_norm_features=paths["noise"],
                          matches=True, **flags) as client:
            log(f"phase {phase}: server ready, {client.n_ref_videos} videos staged in "
                f"{client.stage_seconds:.1f} s")
            client.launches(reset=True)
            step(f"a: {N_QUERY_VIDEOS} query videos by path", lambda: client.search(
                paths["queries"], candidates_csv=csv["a"][0], matches_csv=csv["a"][1]))
            b = step("b: the same in-band", lambda: client.search_bytes(
                Path(paths["queries"]).read_bytes()))
            check(b.candidates_csv == Path(csv["a"][0]).read_bytes()
                  and b.matches_csv == Path(csv["a"][1]).read_bytes(),
                  "in-band CSV bytes differ from the path request's")
            step("c: one query video", lambda: client.search(
                str(work / "q1.npz"), candidates_csv=csv["c"][0], matches_csv=csv["c"][1]))
            n = step(f"d: add {SERVE_ADD} videos",
                      lambda: client.add(str(work / "add.npz")))
            check(n == SERVE_ADD, f"added {n} videos")
            n = step(f"e: remove {SERVE_REMOVE} videos", lambda: client.remove(removed))
            check(n == (SERVE_REMOVE, SERVE_REMOVE * FRAMES), f"removed {n}")
            n = step("f: save", lambda: client.save(snap))
            check(n == SERVE_REF_VIDEOS, f"saved {n} videos")
            before_g = client.launches()
            t0 = time.perf_counter()
            step("g: (a) again", lambda: client.search(
                paths["queries"], candidates_csv=csv["g"][0], matches_csv=csv["g"][1]))
            g_wall = time.perf_counter() - t0
            g_launches = launched_since(before_g, client.launches())
            stats = step("h: stats", client.stats)
            check((stats.n_videos, stats.n_frames, stats.dtype)
                  == (SERVE_REF_VIDEOS, SERVE_REF_VIDEOS * FRAMES, dtype),
                  f"stats {stats}")
            launches = client.launches()
            probe = probe_request(client, paths["queries"], g_wall, g_launches, phase)
        log(f"phase {phase}: server kernel launches over (a)-(h): {json.dumps(launches)}")
        for name in search_kernels:
            check(launches[name] > 0, f"kernel {name} never launched by the server")
        other = [k for k, c in launches.items() if c and not k.endswith(suffix)]
        check(not suffix or not other, f"the {tag} server reached the kernels {other}")
        with spawn_server(snap, server_log, score_norm_features=paths["noise"],
                          matches=True, **flags) as client:
            step("fresh server on the snapshot: (a)'s queries", lambda: client.search(
                paths["queries"], candidates_csv=csv["fresh"][0],
                matches_csv=csv["fresh"][1]))
        for i in (0, 1):
            check(Path(csv["fresh"][i]).read_bytes() == Path(csv["g"][i]).read_bytes(),
                  "a fresh server on the snapshot answers (g) differently")
        log(f"phase {phase}: (b) == (a) and fresh server on the snapshot == (g), "
            "byte for byte; stats: " + stats.dtype)

    # The same searches in-process, over the same live corpus.
    index = ScoreNormalizedVideoIndex(DIM, corpus["noise"], beta=1.2, dtype=dtype,
                                      device=dev)
    index.add(refs)
    staged = index._get_searcher().searcher  # staged before the timed searches
    log(f"phase {phase}: in-process index: the staged search corpus holds "
        f"{staged.staged_bytes()} bytes ({staged._refs.shape[0]} x "
        f"{staged._refs.shape[1]} {staged._refs.dtype}"
        + (" + f32 scales" if staged._scale is not None else "") + ")")
    k, keep = 1200 * N_QUERY_VIDEOS, 25 * N_QUERY_VIDEOS

    def search():
        t0 = time.perf_counter()
        out = rank_candidates(index.search(queries, global_k=k), MaxScoreAggregation())
        return out[:keep], time.perf_counter() - t0

    with capture_inputs(kernels) as captured:
        kernels.reset_launches()
        cands, t_stream = search()
        stream_launches = dict(kernels.launches)
    stream_stats = dict(index._searcher.searcher.last_stats)
    mode = stream_stats["mode"]
    check(mode == "stream", f"the serving catalogue ran {mode}")
    err = check_same_candidates(CandidatePair.read_csv(csv["a"][0]), cands,
                                "server (a) vs in-process index")
    # Forced to the pool: its kernels score on the stream's product, so
    # the candidates are the same, scores included.
    with collection_mode("pooled"), capture_inputs(kernels) as pooled_captured:
        kernels.reset_launches()
        pooled, t_pooled = search()
        pooled_launches = dict(kernels.launches)
    pooled_stats = dict(index._searcher.searcher.last_stats)
    check(pooled_stats["mode"] == "pooled", "pooled not taken")
    check_same_candidates(pooled, cands, "(a) pooled vs stream", tol=0.0)
    log(f"phase {phase}: (a) forced pooled, kernel launches: "
        f"{json.dumps(pooled_launches)}")
    for stats in (stream_stats, pooled_stats):
        stats.pop("seconds", None)
        log(f"phase {phase}: (a) in-process global_topk last_stats: {json.dumps(stats)}")
    research = "scores_above"
    if suffix:
        for mode, st, cap, counts in (("stream", stream_stats, captured, stream_launches),
                                      ("pooled", pooled_stats, pooled_captured,
                                       pooled_launches)):
            log_research_chunks(phase, f"(a) in process, {mode}", [st],
                                cap.get(research), counts[research + suffix],
                                research + suffix)
    log(f"phase {phase}: (a) in-process: stream {t_stream:.3f} s, pooled "
        f"{t_pooled:.3f} s, {len(cands)} pairs each, the same; server vs "
        f"in-process scores within {err}")
    index.add(corpus["added"])
    index.remove(removed)
    cands_g, _ = search()
    check_same_candidates(CandidatePair.read_csv(csv["g"][0]), cands_g,
                          "server (g) vs in-process index after add/remove")
    quality = pipeline.report_metrics(paths["gt"], csv["a"][0], csv["a"][1],
                                      logging.getLogger("chip_smoke"))
    quality["probe"] = probe
    log(f"phase {phase}: (a) candidate uAP {quality['candidate_uap']:.4f}, "
        f"segment AP {quality['segment_ap']:.4f}")
    check(quality["candidate_uap"] > 0.5, f"serving uAP {quality['candidate_uap']}")
    del index
    torch.cuda.empty_cache()
    # The re-search (scores_above of the corpus's dtype) on both
    # collections' re-searched rows.
    if suffix:
        check(research in captured and research in pooled_captured,
              f"the {tag} (a) search re-searched no row in one of its collections")
    path_kernels = ("row_max", "fused_topk", "count_above", "scores", "scores_above")
    pooled_captured = {n: pooled_captured[n] for n in ("pool_writer", "scores",
                                                       "scores_above")
                       if n in pooled_captured}
    return (launches, {n: captured[n] for n in path_kernels if n in captured},
            (pooled_launches, pooled_captured), quality)


def serve_dns_request(dtype="float32"):
    """One DnS two-file request against phase 5's files. f32 (--f32): the
    same rows as dns_baseline's output, scores within FLOAT_ATOL. bf16 (no
    dtype flag: bf16 corpus and tables, the f32 chamfer over widened rows)
    and int8 (--int8: the 1,025-wide coarse corpus as int8 codes padded to
    1,040 columns, bf16 tables): its quality on phase 5's ground truth,
    logged."""
    import logging

    from vsc2022_torch.baseline import pipeline

    tag, phase, flags, _ = SERVE_DTYPES[dtype]
    work = SMOKE_DIR / "dns"
    idx, out = work / "idx", work / "out"
    c_csv, m_csv = str(work / f"serve_{tag}_c.csv"), str(work / f"serve_{tag}_m.csv")
    with open(work / f"server_{tag}.log", "w") as server_log:
        with spawn_server(str(idx / "refs_cg_student_sn.npz"), server_log,
                          ref_fine_features=str(idx / "refs_fg_att_student.npz"),
                          **flags) as client:
            client.launches(reset=True)
            timed(f"DnS two-file request ({tag})", lambda: client.search(
                str(idx / "queries_cg_student_sn.npz"),
                query_fine_features=str(idx / "queries_fg_att_student.npz"),
                candidates_csv=c_csv, matches_csv=m_csv), phase)
            launches = client.launches()
    for name in {"float32": DNS_SERVE_KERNELS, "bfloat16": DNS_SERVE_BF16_KERNELS,
                 "int8": DNS_SERVE_INT8_KERNELS}[dtype]:
        check(launches[name] > 0, f"kernel {name} never launched by the DnS server")
    if dtype != "float32":
        quality = pipeline.report_metrics(str(work / "gt.csv"), c_csv, m_csv,
                                          logging.getLogger("chip_smoke"))
        log(f"phase {phase}: DnS request ({tag} corpus, bf16 tables): candidate uAP "
            f"{quality['candidate_uap']:.4f}, segment AP {quality['segment_ap']:.4f}; "
            f"server launches {json.dumps(launches)}")
        check(quality["candidate_uap"] > 0.5, f"{tag} DnS uAP {quality['candidate_uap']}")
        return launches
    n_c = check_same_rows(c_csv, out / "candidates.csv", "DnS server candidates")
    n_m = check_same_rows(m_csv, out / "matches.csv", "DnS server matches")
    log(f"phase 6: DnS request == dns_baseline ({n_c} candidates, {n_m} matches, "
        f"scores within {FLOAT_ATOL}); server launches {json.dumps(launches)}")
    return launches


def time_collection_modes(torch, np, args, k, label):
    """global_topk over a path's own fused_topk input in both collection
    modes (warm, second call timed): the same (q, r, score) arrays."""
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    q, refs, n_valid = args[0], args[1], int(args[2])
    searcher = SimilaritySearcher(refs[:n_valid].cpu().numpy(), device=q.device)
    out, secs = {}, {}
    for mode in ("stream", "pooled", "stream", "pooled"):
        with collection_mode(mode):
            t0 = time.perf_counter()
            out[mode] = searcher.global_topk(q, k)
            secs[mode] = time.perf_counter() - t0
            check(searcher.last_stats["mode"] == mode, f"{label}: {mode} not taken")
    check(all(np.array_equal(a, b) for a, b in zip(out["stream"], out["pooled"])),
          f"{label}: stream and pooled global_topk differ")
    log(f"phase 6: global_topk at the {label} corpus [{q.shape[0]} x {n_valid} x "
        f"{q.shape[1]}] k={k}: stream {secs['stream']:.3f} s, pooled "
        f"{secs['pooled']:.3f} s, identical results")
    return secs


def dns_search(torch, np, kernels, args, k, server_launches, dtype):
    """The DnS bf16 or int8 request's search in process: the DnS path's
    corpus and queries (fused_topk's input) staged as that server stages
    them (bf16: both rounded; int8: the corpus quantized, the queries f32),
    searched in both collection modes (the same arrays). The stream search
    must re-search as the server's did (its scores_above.bf16 or
    scores_above.int8 launches). Returns the first inputs there of
    scores_above (and, int8, of fused_topk and count_above: the DnS widths
    of the int8 kernels), the pad columns of the queries dropped (their
    timed calls pad them)."""
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    tag, phase, _, _ = SERVE_DTYPES[dtype]
    research = "scores_above"
    key = research + (INT8 if dtype == "int8" else BF16)
    q, refs, n_valid = args[0], args[1], int(args[2])
    searcher = SimilaritySearcher(refs[:n_valid].cpu().numpy(), dtype=dtype,
                                  device=q.device)
    out, launches = {}, {}
    for mode in ("stream", "pooled"):
        with collection_mode(mode), capture_inputs(kernels) as captured:
            kernels.reset_launches()
            out[mode] = searcher.global_topk(q, k)
            launches[mode] = {n: c for n, c in kernels.launches.items() if c}
            check(searcher.last_stats["mode"] == mode, f"DnS {tag}: {mode} not taken")
        if mode == "stream":
            stream_captured = captured
            if research in captured:
                log_research_chunks(phase, f"DnS {tag} search in process, stream",
                                    [searcher.last_stats], captured[research],
                                    launches["stream"].get(key, 0), key)
    check(all(np.array_equal(a, b) for a, b in zip(out["stream"], out["pooled"])),
          f"DnS {tag}: stream and pooled global_topk differ")
    log(f"phase {phase}: DnS {tag} search in process [{q.shape[0]} x {n_valid} x "
        f"{q.shape[1]}] k={k}: stream and pooled identical; launches "
        f"{json.dumps(launches)}; the server's {key} launches: "
        f"{server_launches.get(key, 0)}")
    check(launches["stream"].get(key, 0) == server_launches.get(key, 0),
          f"DnS {tag}: the in-process stream search re-searched otherwise than the server")
    names = ("fused_topk", "count_above", research) if dtype == "int8" else (research,)
    return {name: (stream_captured[name][0][:, :q.shape[1]].contiguous(),)
            + stream_captured[name][1:] for name in names if name in stream_captured}


def log_pool_plans(kernels, lib, probe, sms):
    """Phase 1: the plans of pool_writer.bf16 over the SSCD corpus and of
    count_above.bf16 over its ambiguous rows (about 890 of the 9,000), with
    each block's shared memory as the library reports it."""
    n_valid = N_REF_VIDEOS * FRAMES
    n = -(-n_valid // 8192) * 8192  # the staged corpus's rows
    for name, m, smem in (
            ("pool_writer", N_QUERY_VIDEOS * FRAMES, lib.vsc_pool_writer_bf16_smem_bytes()),
            ("count_above", 890, lib.vsc_count_above_bf16_smem_bytes())):
        slots = kernels._wgmma_slots(probe, name + "_bf16")
        grid = kernels.wgmma_grid(m, n_valid, slots)
        q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
        extra = ""
        if name == "pool_writer":
            written = kernels.pool_segments(n, n_valid)
            extra = (f"; the kernel writes {written} of the {n // 128} segments a "
                     f"row, the wrapper fills {n // 128 - written}")
        log(f"phase 1: {name}.bf16 (wgmma_gemm.cuh) at the SSCD shape [{m} x {n_valid}]"
            f": {slots // sms} block(s) per SM, grid {grid}, {q_tiles} x {c_tiles} "
            f"tiles in groups of {kernels.WGMMA_GROUP}, corpus read "
            f"{kernels.wgmma_corpus_passes(m, n_valid, grid):.2f} times, {smem} bytes "
            f"of shared memory a block{extra}")


def log_stream_pair_plans(kernels, lib, probe, sms, label, m, n_valid, kappa):
    """Phase 1: the plans of count_above.bf16 and fused_topk.bf16 (both
    placements of the kappa-sets; the searcher's is marked) at a path's
    shape, with each block's shared memory as the library reports it."""
    count_slots = kernels._wgmma_slots(probe, "count_above_bf16")
    grid = kernels.wgmma_grid(m, n_valid, count_slots)
    log(f"phase 1: count_above.bf16 (wgmma_gemm.cuh) at the {label} shape "
        f"[{m} x {n_valid}]: {count_slots // sms} block(s) per SM, grid {grid}, "
        f"corpus read {kernels.wgmma_corpus_passes(m, n_valid, grid):.2f} times, "
        f"{lib.vsc_count_above_bf16_smem_bytes()} bytes of shared memory a block")
    for smem_sets in (0, 1):
        group = kernels.WGMMA_SMEM_SETS_GROUP if smem_sets else kernels.WGMMA_GROUP
        slots = kernels._wgmma_slots(probe, "fused_topk_bf16", smem_sets,
                                     kappa if smem_sets else 0)
        grid, pieces = kernels.wgmma_topk_grid(
            m, n_valid, kappa, kernels.wgmma_grid(m, n_valid, slots), group)
        smem = lib.vsc_fused_topk_bf16_smem_bytes(smem_sets, kappa)
        check(smem > 0, f"fused_topk.bf16 with sets in shared memory: {smem_sets} "
                        f"takes no kappa {kappa}")
        where = ("shared memory (3-stage ring, groups of 2)" if smem_sets
                 else f"the [M, S, kappa] output ({8 * m * pieces * kappa} bytes)")
        kept = smem_sets == int(kappa <= kernels.WGMMA_SMEM_SETS_KAPPA_MAX)
        log(f"phase 1: fused_topk.bf16 (wgmma_gemm.cuh) at the {label} shape "
            f"[{m} x {n_valid}], kappa {kappa}, sets in {where}"
            f"{' [the searcher' + chr(39) + 's]' if kept else ''}: "
            f"{slots // sms} block(s) per SM, grid {grid}, S = {pieces}, group of "
            f"{group} query tiles, corpus read "
            f"{kernels.wgmma_corpus_passes(m, n_valid, grid, group):.2f} times, "
            f"{smem} bytes of shared memory a block")


# ---- phase 7: the small search modes (metric L2, precision "default", KNN) --


# The per-query KNN of 7d: frames per query frame.
KNN_K = 5


def l2_norms(q, r):
    """The squared norms the searchers stage: {ref_sq [N], q_sq [M]}."""
    from vsc2022_torch.ops.similarity import _row_sq

    return {"ref_sq": _row_sq(r), "q_sq": _row_sq(q)}


def l2_plain_rows(torch, kernels, q, r, n_valid, kw):
    """The plain goodness of q's rows over the first n_valid corpus rows
    ([M, n_valid]: the widened product, then (2 s - ref_sq) - q_sq)."""
    s = kernels.scores_plain(q, r, n_valid)
    return s.mul_(2.0).sub_(kw["ref_sq"][:n_valid]).sub_(kw["q_sq"][:, None])


def l2_check(torch, kernels, name, q, r, n_valid, kw, kind, arg=None):
    """One L2 variant against its plain version (``kw``: ref_sq and q_sq;
    ``arg``: tau, kappa or the floors): integers exactly, tie order
    included; floats within the dtype's tolerance (counts within 2, the
    entries of scores_above as compare_scores_above holds them). Returns
    the largest error."""
    bf16 = q.dtype == torch.bfloat16
    tol = 0.0 if kind == "int" else BF16_TC_ATOL if bf16 else FLOAT_ATOL
    what = f"{name}{BF16 if bf16 else ''}{kernels.L2} {kind} [{q.shape[0]}x{n_valid}x{q.shape[1]}]"
    if name == "row_max":
        got = kernels.row_max(q, r, n_valid, **kw)
        want = kernels.row_max_plain(q, r, n_valid, **kw)
        err = float((got - want).abs().max()) if got.numel() else 0.0
    elif name == "count_above":
        got = kernels.count_above(q, r, arg, n_valid, **kw)
        want = kernels.count_above_plain(q, r, arg, n_valid, **kw)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(err <= (0.0 if kind == "int" else 2.0), f"{what}: count diff {err}")
        return err
    elif name in ("pool_writer", "fused_topk"):
        extra = () if name == "pool_writer" else (arg,)
        gv, gi = getattr(kernels, name)(q, r, n_valid, *extra, **kw)
        wv, wi = getattr(kernels, name + "_plain")(q, r, n_valid, *extra, **kw)
        finite = torch.isfinite(wv)
        check(torch.equal(torch.isfinite(gv), finite), f"{what}: -inf slots differ")
        err = float((gv[finite] - wv[finite]).abs().max()) if finite.any() else 0.0
        if kind == "int":
            check(torch.equal(gi[finite], wi[finite]), f"{what}: ids differ")
    else:  # scores_above: arg are the floors
        s, rr, cc = above_entries(torch, kernels.scores_above(q, r, n_valid, arg, **kw))
        plain = l2_plain_rows(torch, kernels, q, r, n_valid, kw)
        if kind == "int":
            wr, wc = torch.nonzero(plain >= arg[:, None], as_tuple=True)
            check(torch.equal(rr, wr) and torch.equal(cc, wc)
                  and torch.equal(s, plain[wr, wc]), f"{what}: differs from the plain version")
            return 0.0
        err = float((s - plain[rr, cc]).abs().max()) if s.numel() else 0.0
        emitted = torch.zeros(plain.shape, dtype=torch.bool, device=q.device)
        emitted[rr, cc] = True
        missed = int(((plain >= arg[:, None] + tol) & ~emitted).sum())
        low = int((plain[rr, cc] < arg[rr] - tol).sum())
        check(missed == 0 and low == 0, f"{what}: {missed} plain entries >= floor + tol "
              f"missed, {low} emitted below floor - tol")
    check(err <= tol, f"{what}: max abs err {err} > {tol}")
    return err


def l2_floors(torch, kernels, q, r, n_valid, kw, depth=40):
    """Per-row floors: each row's plain goodness at ``depth`` (its ties sit
    on the floor), -inf on every 17th row."""
    plain = l2_plain_rows(torch, kernels, q, r, n_valid, kw)
    floor = torch.sort(plain, dim=1, descending=True).values[:, min(depth, n_valid - 1)]
    floor[::17] = float("-inf")
    return floor.contiguous()


def l2_identity(torch, kernels, q, r, n_valid, label, kappa=32):
    """The L2 kernels of q's dtype against each other on the same inputs, as
    the collections compare them (r: whole 128-row segments): the pool's
    best winner is row_max, its winners ordered fused_topk's (the stream's
    candidates), and with tau the global k-th pool value the count is the
    pool count on every row with amb == 0, no less elsewhere, and on the
    amb > 0 rows alone (the pooled collection's count of its ambiguous
    rows) the full call's; over bf16, scores_above's entries are the
    goodness of scores.bf16 (torch's elementwise f32 epilogue) bit for bit,
    on the first SCORES_ROWS rows. Bit for bit throughout."""
    m = q.shape[0]
    kw = l2_norms(q, r)
    pv, pi = kernels.pool_writer(q, r, n_valid, **kw)
    best = kernels.row_max(q, r, n_valid, **kw)
    check(torch.equal(pv.view(m, -1).amax(1).view(torch.int32), best.view(torch.int32)),
          f"{label}: row_max.l2 differs from pool_writer.l2's best winner")
    want = kernels.ordered_topk(pv.view(m, -1), pi.view(m, -1), kappa)
    check(all(torch.equal(a, b) for a, b in zip(
        kernels.fused_topk(q, r, n_valid, kappa, **kw), want)),
        f"{label}: fused_topk.l2 differs from the pool's winners ordered")
    finite = int(torch.isfinite(pv).sum())
    tau = float(torch.topk(pv.reshape(-1), min(K_PER_ROW * m, finite)).values[-1])
    above = pv >= tau
    pool_counts, amb = above.view(m, -1).sum(1), above.all(2).sum(1)
    counts = kernels.count_above(q, r, tau, n_valid, **kw).long()
    clean = amb == 0
    check(torch.equal(counts[clean], pool_counts[clean])
          and bool((counts >= pool_counts).all()),
          f"{label}: count_above.l2 differs from the pool count on rows with amb == 0")
    rows = torch.nonzero(~clean, as_tuple=True)[0]
    if rows.numel():
        sub = kernels.count_above(q[rows], r, tau, n_valid, ref_sq=kw["ref_sq"],
                                  q_sq=kw["q_sq"][rows]).long()
        check(torch.equal(sub, counts[rows]),
              f"{label}: count_above.l2 on the amb > 0 rows alone differs")
    if q.dtype == torch.bfloat16:
        h = min(m, SCORES_ROWS)
        sub = {"ref_sq": kw["ref_sq"], "q_sq": kw["q_sq"][:h]}
        dense = ((2 * kernels.scores(q[:h], r, n_valid) - kw["ref_sq"][:n_valid])
                 - kw["q_sq"][:h, None])
        floor = torch.sort(dense, dim=1, descending=True).values[:, 40].contiguous()
        s, rr, cc = above_entries(torch, kernels.scores_above(q[:h], r, n_valid, floor,
                                                              **sub))
        wr, wc = torch.nonzero(dense >= floor[:, None], as_tuple=True)
        check(torch.equal(rr, wr) and torch.equal(cc, wc)
              and torch.equal(s.view(torch.int32), dense[wr, wc].view(torch.int32)),
              f"{label}: scores_above.bf16.l2 differs from the dense goodness")
    log(f"phase 7: {label} [{m} x {n_valid} x {q.shape[1]}]: L2 row_max == the pool's "
        f"best winner, fused_topk == its winners ordered (kappa {kappa}), count_above "
        f"== the pool count on {int(clean.sum())} rows with amb == 0 (tau {tau!r}) and "
        f"on the {rows.numel()} others alone == the full call"
        + (", scores_above == the dense goodness" if q.dtype == torch.bfloat16 else "")
        + ", bit for bit")


def phase_l2_small(torch, kernels, dev):
    """7a: every L2 variant against its plain version at small ragged
    shapes (exact on integers, within the tolerance on unit-norm floats),
    and the kernels of each collection against each other."""
    m, n = 300, 5120
    for dt in (torch.float32, torch.bfloat16):
        for d in (33, 512, 1025):
            for kind in ("int", "float"):
                q, r = make_inputs(torch, kind, m, n, d, seed=70 + d, dev=dev)
                r[[5, 7, 40]] = r[7].clone()  # exact ties inside segment 0
                q[0] = r[7]
                q, r = q.to(dt), r.to(dt)
                n_valid = n - 120
                kw = l2_norms(q, r)
                for name, arg in (("row_max", None), ("count_above", -40.0 if kind == "int"
                                                      else -1.5),
                                  ("count_above", float("-inf")), ("pool_writer", None),
                                  ("fused_topk", 7), ("fused_topk", 100)):
                    l2_check(torch, kernels, name, q, r, n_valid, kw, kind, arg)
                if dt == torch.bfloat16:
                    l2_check(torch, kernels, "scores_above", q, r, n_valid, kw, kind,
                             l2_floors(torch, kernels, q, r, n_valid, kw))
                if kind == "float":
                    l2_identity(torch, kernels, q, r, n_valid,
                                f"small {str(dt).split('.')[-1]} D={d}")
    log("phase 7a: every L2 variant equals its plain version on integers and lies "
        f"within {FLOAT_ATOL} (f32) / {BF16_TC_ATOL} (bf16) of it on unit-norm floats")


@contextlib.contextmanager
def topk_results():
    """The (query_idx, ref_idx, score) of every SimilaritySearcher.global_topk
    call while the block runs, with its mode."""
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    seen = []
    original = SimilaritySearcher.global_topk

    def global_topk(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        seen.append((out, self.last_stats["mode"]))
        return out

    SimilaritySearcher.global_topk = global_topk
    try:
        yield seen
    finally:
        SimilaritySearcher.global_topk = original


def l2_oracle(torch, np, q, r, k, q_sq, ref_sq):
    """The dense L2 search: (query_idx, ref_idx, squared distance) of the
    k best pairs, ties by (q, r), and each row's nearest distance, from
    cuBLAS f32 products of q and r as the searcher's product takes them
    and its squared norms; chunked over query rows."""
    step = max(1, (1 << 28) // r.shape[0])
    top, nearest = [], []
    for s0 in range(0, q.shape[0], step):
        g = (2 * (q[s0:s0 + step] @ r.T) - ref_sq) - q_sq[s0:s0 + step, None]
        top.append(torch.topk(g.reshape(-1), min(k, g.numel())).values)
        nearest.append(g.amax(1))
    kth = torch.topk(torch.cat(top), k).values[-1]
    vals, rows, cols = [], [], []
    for s0 in range(0, q.shape[0], step):
        g = (2 * (q[s0:s0 + step] @ r.T) - ref_sq) - q_sq[s0:s0 + step, None]
        rr, cc = torch.nonzero(g >= kth, as_tuple=True)
        vals.append(g[rr, cc].cpu().numpy())
        rows.append((rr + s0).cpu().numpy())
        cols.append(cc.cpu().numpy())
    vals, rows, cols = np.concatenate(vals), np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows, -vals))[:k]
    return rows[order], cols[order], -vals[order], -torch.cat(nearest).cpu().numpy()


def check_vs_oracle(np, got, want, tol, what):
    """A float search against the dense oracle: k pairs, sorted, distances
    within tol, the same pairs wherever clear of the k-th distance by 2
    tol. Returns the largest distance error."""
    (qi, ri, s), (oq, orr, os_) = got, want
    check(len(qi) == len(oq), f"{what}: {len(qi)} pairs, not {len(oq)}")
    check(bool((np.diff(s) >= 0).all()), f"{what}: distances not ascending")
    err = float(np.abs(s - os_).max())
    check(err <= tol, f"{what}: distances off the oracle's by {err} > {tol}")
    edge = float(os_[-1]) - 2 * tol
    check({(a, b) for a, b, v in zip(oq, orr, os_) if v < edge} <= set(zip(qi, ri))
          and {(a, b) for a, b, v in zip(qi, ri, s) if v < edge} <= set(zip(oq, orr)),
          f"{what}: pair set differs from the oracle's")
    return err


def l2_library(torch, name, q, r, n_valid, kw, arg):
    """One PyTorch route to an L2 kernel's result (timing only): torch.mm
    (bf16 with f32 output where torch has it), the same epilogue, and the
    kernel's reduction, chunked over query rows."""
    n = r.shape[0] if name in ("pool_writer", "fused_topk") else n_valid
    rr = r[:n, :q.shape[1]]
    out_kw = ({"out_dtype": torch.float32}
              if q.dtype == torch.bfloat16 and mm_out_f32(torch, q.device) else {})
    step = _lib_chunk(n)
    outs = []
    for s0 in range(0, q.shape[0], step):
        s = torch.mm(q[s0:s0 + step], rr.T, **out_kw).float()
        s = (2 * s - kw["ref_sq"][:n]) - kw["q_sq"][s0:s0 + step, None]
        if name == "row_max":
            outs.append(s.amax(1))
        elif name == "count_above":
            outs.append((s >= arg).sum(1))
        elif name == "scores_above":
            r_, c_ = torch.nonzero(s >= arg[s0:s0 + step, None], as_tuple=True)
            outs.append(s[r_, c_])
        else:
            s[:, n_valid:] = float("-inf")
            seg = torch.topk(s.view(s.shape[0], -1, 128), 2, dim=2).values
            if name == "fused_topk":
                seg = seg.reshape(s.shape[0], -1)
                seg = torch.topk(seg, min(arg, seg.shape[1]), dim=1).values
            outs.append(seg)
    return outs


def mm_out_f32(torch, dev) -> bool:
    """Whether this torch has torch.mm(bf16, bf16, out_dtype=f32) on ``dev``
    (else the library route takes cuBLAS's bf16 output, widened)."""
    try:
        a = torch.zeros((1, 8), dtype=torch.bfloat16, device=dev)
        torch.mm(a, a.T, out_dtype=torch.float32)
        return True
    except (TypeError, RuntimeError, NotImplementedError):
        return False


def l2_records(torch, kernels, captured, launches, path):
    """Each L2 kernel on the inputs the path gave it (its first call):
    against its plain version on those floats and on integers of the same
    shape, then timed beside its IP kernel on the same inputs (ip_ms;
    scores_above at the floors of about as many entries), its plain
    version, one PyTorch route (l2_library) and the bound (the IP
    kernel's operations; bytes add the two norms). Returns {key: record}."""
    records = {}
    for name, args in captured.items():
        if name not in kernels.RETRIEVAL_KERNELS + ("scores_above",):
            continue
        q, r = args[0], args[1]
        kw = {"ref_sq": args[-2], "q_sq": args[-1]}
        bf16 = q.dtype == torch.bfloat16
        key = name + (BF16 if bf16 else "") + kernels.L2
        n_valid = int(args[3] if name == "count_above" else args[2])
        arg = {"count_above": lambda: float(args[2]), "fused_topk": lambda: int(args[3]),
               "scores_above": lambda: args[3]}.get(name, lambda: None)()
        (m, d), n = q.shape, r.shape[0]
        err = l2_check(torch, kernels, name, q, r, n_valid, kw, "float", arg)
        qi, ri = make_inputs(torch, "int", m, n, d, seed=7, dev=q.device)
        qi, ri = qi.to(q.dtype), ri.to(q.dtype)
        kwi = l2_norms(qi, ri)
        arg_i = {"count_above": -8.0 * d, "fused_topk": arg, "scores_above":
                 (l2_floors(torch, kernels, qi, ri, n_valid, kwi, depth=n_valid // 1000)
                  if name == "scores_above" else None)}.get(name)
        l2_check(torch, kernels, name, qi, ri, n_valid, kwi, "int", arg_i)
        del qi, ri, kwi, arg_i
        torch.cuda.empty_cache()
        extra = () if arg is None else (arg,)
        if name == "count_above":
            call = lambda **k: kernels.count_above(q, r, arg, n_valid, **k)  # noqa: E731
            plain = lambda: kernels.count_above_plain(q, r, arg, n_valid, **kw)  # noqa: E731
        else:
            fn, pfn = getattr(kernels, name), getattr(kernels, name + "_plain")
            call = lambda **k: fn(q, r, n_valid, *extra, **k)  # noqa: E731
            plain = lambda: pfn(q, r, n_valid, *extra, **kw)  # noqa: E731
        ms = cuda_ms(torch, lambda: call(**kw), 3)
        if name == "scores_above":
            # The IP kernel's floors: g >= f is s >= (f + |q|^2 + |r|^2) / 2,
            # with |r|^2 at its mean (so about as many entries pass).
            ip_floor = ((arg + kw["q_sq"] + kw["ref_sq"][:n_valid].mean()) / 2).contiguous()
            ip_ms = cuda_ms(torch, lambda: kernels.scores_above(q, r, n_valid, ip_floor), 3)
        else:
            ip_ms = cuda_ms(torch, lambda: call(), 3)
        plain_ms = cuda_ms(torch, plain, 1)
        library_ms = cuda_ms(torch, lambda: l2_library(torch, name, q, r, n_valid, kw, arg), 1)
        if name == "pool_writer":
            out_bytes = 8 * m * (n // 128) * 2
        elif name == "fused_topk":
            out_bytes = 8 * m * arg
        elif name == "scores_above":  # the entries this call emits
            out_bytes = 12 * int(call(**kw)[0].numel())
        else:
            out_bytes = 4 * m
        bound_ms, bound_by = bound(m, n_valid, n, d, out_bytes + 4 * (m + n), bf16=bf16)
        records[key] = {"shape": [m, n_valid, d] + ([arg] if name == "fused_topk" else []),
                        "max_abs_err": err, "ms": ms, "ip_ms": ip_ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "path": path}
        log(f"phase 7b: {key} on the {path} inputs [{m} x {n_valid} x {d}] kernel_ms={ms:.3f} "
            f"ip_ms={ip_ms:.3f} plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} "
            f"bound_ms={bound_ms:.3f} ({bound_by}) max_abs_err={err}; launches "
            f"{launches.get(key, 0)}")
    return records


def phase_l2_search(torch, np, kernels, dev, corpus):
    """7b: VideoIndex(metric="L2") over phase 6's serving catalogue in f32
    and bf16, its search (k = 1200 a query video) forced to each collection
    and the searcher's nearest-row distances (row_nn): launch counts zeroed
    just before and read just after; pooled and stream identical, both
    against the dense oracle; each L2 kernel then held and timed on the
    inputs that run gave it. Returns (records, launches)."""
    from vsc2022_torch.ops.similarity import _row_sq
    from vsc2022_torch.retrieval.index import VideoIndex

    queries, refs = corpus["queries"], corpus["refs"]
    q_np = np.concatenate([v.feature for v in queries])
    k = 1200 * len(queries)
    records, launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        index = VideoIndex(DIM, metric="L2", dtype=dtype, device=dev)
        index.add(refs)
        searcher = index._get_searcher()
        out, secs = {}, {}
        with capture_inputs(kernels) as captured:
            kernels.reset_launches()
            for mode in ("stream", "pooled"):
                with collection_mode(mode), topk_results() as res:
                    t0 = time.perf_counter()
                    pairs = index.search(queries, global_k=k)
                    secs[mode] = time.perf_counter() - t0
                (out[mode], ran), = res
                check(ran == mode, f"L2 {dtype}: {ran} ran, not {mode}")
                check(sum(len(p.matches) for p in pairs) == k, f"L2 {dtype}: matches lost")
            nearest = searcher.row_nn(q_np)
            counts = dict(kernels.launches)
        sfx = BF16 if dtype == "bfloat16" else ""
        used = {name + sfx + kernels.L2 for name in kernels.RETRIEVAL_KERNELS} | (
            {SCORES_ABOVE + kernels.L2} if dtype == "bfloat16" else set())
        check({key for key, v in counts.items() if v} == used,
              f"L2 {dtype} search launched {json.dumps(counts)}, not {sorted(used)}")
        check(all(np.array_equal(a, b) for a, b in zip(out["stream"], out["pooled"])),
              f"L2 {dtype}: stream and pooled differ")
        qt = torch.from_numpy(q_np).to(dev).to(searcher.query_dtype).float()
        rt = searcher._refs[: searcher.n_refs].float()
        oracle = l2_oracle(torch, np, qt, rt, k, _row_sq(qt), searcher._ref_sq[: searcher.n_refs])
        tol = BF16_TC_ATOL if dtype == "bfloat16" else FLOAT_ATOL
        err = check_vs_oracle(np, out["stream"], oracle[:3], tol, f"L2 {dtype} search")
        nn_err = float(np.abs(nearest - oracle[3]).max())
        check(nn_err <= tol, f"L2 {dtype} row_nn off the oracle by {nn_err}")
        log(f"phase 7b: VideoIndex(metric=\"L2\", dtype={dtype}) [{len(q_np)} x "
            f"{searcher.n_refs} x {DIM}] k={k}: stream {secs['stream']:.3f} s, pooled "
            f"{secs['pooled']:.3f} s, identical ids and distances; within {err} of the "
            f"dense oracle (same pairs clear of the k-th distance), row_nn within "
            f"{nn_err}; launches {json.dumps({k_: v for k_, v in counts.items() if v})}")
        launches.update({key: counts[key] for key in used})
        records.update(l2_records(torch, kernels, captured, counts, "serving L2"))
        del index, searcher, captured, qt, rt
        torch.cuda.empty_cache()
    return records, launches


def phase_default(torch, np, kernels, dev, corpus):
    """7c: precision "default". IP over an f32 corpus is a bf16 searcher on
    the same rows, ids and scores bit for bit, through the bf16 kernels
    alone; an int8 corpus at "default" is the one-pass product (codes at
    unit scale: a bf16 searcher over the codes, bit for bit); L2 at
    "default" against the dense oracle of bf16 products and f32 norms."""
    from vsc2022_torch.ops.similarity import SimilaritySearcher, _row_sq

    q_np = np.concatenate([v.feature for v in corpus["queries"]])
    r_np = np.concatenate([v.feature for v in corpus["refs"]])
    k = 1200 * len(corpus["queries"])
    # Integer rows of max |code| 127: SQ8 scale 1, codes the rows themselves.
    codes = np.round(r_np * (127.0 / np.abs(r_np).max(1, keepdims=True)))
    bf16_kernels = {n + BF16 for n in kernels.TENSOR_CORE_KERNELS}
    for label, a, b in (
        ("f32", SimilaritySearcher(r_np, precision="default", device=dev),
         SimilaritySearcher(r_np, dtype="bfloat16", device=dev)),
        ("int8", SimilaritySearcher(codes, dtype="int8", precision="default", device=dev),
         SimilaritySearcher(codes, dtype="bfloat16", device=dev)),
    ):
        if label == "int8":
            check(bool((a._scale[: a.n_refs] == 1.0).all()), "the int8 codes' scales are not 1")
        for mode in ("stream", "pooled"):
            with collection_mode(mode):
                kernels.reset_launches()
                got = a.global_topk(q_np, k)
                ran = {key for key, v in kernels.launches.items() if v}
                want = b.global_topk(q_np, k)
            check(all(np.array_equal(x, y) for x, y in zip(got, want)),
                  f"{label} at precision default ({mode}) differs from the bf16 searcher")
            check(ran <= (bf16_kernels if label == "f32" else set(kernels.INT8_KERNELS)),
                  f"{label} at precision default launched {sorted(ran)}")
        log(f"phase 7c: {label} corpus at precision \"default\" == a bf16 searcher over "
            f"{'the same rows' if label == 'f32' else 'the codes (unit scales)'} "
            f"[{len(q_np)} x {a.n_refs}], k={k}, both collections, ids and scores bit "
            f"for bit; kernels {sorted(ran)}")
        del a, b
        torch.cuda.empty_cache()
    s = SimilaritySearcher(r_np, metric="L2", precision="default", device=dev)
    got = s.global_topk(q_np, k)
    qf = torch.from_numpy(q_np).to(dev)
    oracle = l2_oracle(torch, np, qf.bfloat16().float(), s._refs[: s.n_refs].float(), k,
                       _row_sq(qf), s._ref_sq[: s.n_refs])
    err = check_vs_oracle(np, got, oracle[:3], BF16_TC_ATOL, "L2 at precision default")
    log(f"phase 7c: L2 at precision \"default\" within {err} of the dense oracle of bf16 "
        "products and f32 norms")


def phase_knn(torch, np, dev, corpus):
    """7d: VideoIndex.search(global_k=-KNN_K) (per-query KNN) against the
    dense per-row top-k: the index regroups the searcher's row_topk, whose
    scores lie within FLOAT_ATOL of the oracle's, with the same ids on
    every row whose k + 1 best scores are 2 FLOAT_ATOL apart."""
    from vsc2022_torch.retrieval.index import VideoIndex

    queries, refs = corpus["queries"], corpus["refs"]
    index = VideoIndex(DIM, device=dev)
    index.add(refs)
    t0 = time.perf_counter()
    pairs = index.search(queries, global_k=-KNN_K)
    secs = time.perf_counter() - t0
    q = torch.from_numpy(np.concatenate([v.feature for v in queries])).to(dev)
    r = torch.from_numpy(np.concatenate([v.feature for v in refs])).to(dev)
    step = max(1, (1 << 28) // r.shape[0])
    vals, ids = zip(*(torch.topk(q[s0:s0 + step] @ r.T, KNN_K + 1, dim=1)
                      for s0 in range(0, q.shape[0], step)))
    vals, ids = torch.cat(vals).cpu().numpy(), torch.cat(ids).cpu().numpy()
    s, i = index._get_searcher().row_topk(q.cpu().numpy(), KNN_K)
    err = float(np.abs(s - vals[:, :KNN_K]).max())
    clear = (np.diff(-vals, axis=1) > 2 * FLOAT_ATOL).all(1)
    check(err <= FLOAT_ATOL and np.array_equal(i[clear], ids[clear, :KNN_K]),
          f"KNN row_topk: scores off by {err} or ids differ on rows clear of ties")
    n_q = sum(len(v) for v in queries)
    got = sorted((p.query_id, p.ref_id, m.score) for p in pairs for m in p.matches)
    qid = np.concatenate([[v.video_id] * len(v) for v in queries])
    rid = np.concatenate([[v.video_id] * len(v) for v in refs])
    want = sorted((qid[a], rid[b], float(v)) for a, row, vrow in zip(range(n_q), i, s)
                  for b, v in zip(row, vrow))
    check(got == want, "KNN search: the pairs do not regroup row_topk's results")
    log(f"phase 7d: VideoIndex.search(global_k=-{KNN_K}) [{n_q} x {r.shape[0]} x {DIM}] "
        f"{secs:.3f} s: {len(got)} frame matches in {len(pairs)} pairs, row_topk within "
        f"{err} of the dense top-{KNN_K}, same ids on {int(clear.sum())} of {n_q} rows "
        "clear of ties")


def phase_matching_eval(paths, out_dir, segment_ap):
    """7e: python -m vsc2022_torch.matching_eval on phase 4's matches.csv
    prints the segment AP that phase 4's sscd_baseline reported, in the root
    script's line."""
    run = subprocess.run(
        [sys.executable, "-m", "vsc2022_torch.matching_eval", "--predictions",
         str(out_dir / "matches.csv"), "--ground_truth", paths["gt"]],
        cwd=str(REPO), capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"matching_eval failed: {run.stderr[-2000:]}")
    want = f"Matching track segment AP: {segment_ap:.4f}"
    check(run.stdout.splitlines() == [want],
          f"matching_eval printed {run.stdout!r}, not {want!r}")
    log(f"phase 7e: python -m vsc2022_torch.matching_eval printed \"{want}\"")


# ---- phase 8: descriptor extraction at full width ----------------------------

# The synthetic videos: 640x360 RGB frames at fps 1 from stub ffmpeg /
# ffprobe executables (the card's machine has no ffmpeg). A "video" file is
# a JSON recipe of (seed, j) frames; a frame is a function of (seed, j)
# alone, so a query listing a reference's entries holds an exact copy.
VIDEO_W, VIDEO_H = 640, 360
EXTRACT_REFS, EXTRACT_REF_FRAMES = 24, (30, 60)
EXTRACT_QUERIES, EXTRACT_QUERY_FRAMES = 8, (20, 40)
EXTRACT_NOISE, EXTRACT_NOISE_FRAMES = 8, 30
EXTRACT_COPIES, EXTRACT_COPY_FRAMES = 4, 15
EXTRACT_BATCH = 32
FORWARD_FRAMES = 1024
CPU_CHECK_FRAMES = 8
# f32 on the card against the port's f32 forward on the CPU (the same
# weights and frames; cuDNN's and oneDNN's sums in other orders), as a share
# of the descriptors' largest magnitude. On an H100 at most 1.4e-6 (DINO at
# 320 px); 1e-5 sits 7x above. The folded model against the unfolded one on
# the card is held to the same.
EXTRACT_REL_TOL = 1e-5
# bf16 (parameters and images) against f32 on the card, per frame: the
# lowest cosine read on an H100 is 0.99996.
BF16_COSINE_MIN = 0.999
# The searchv path's kernels: score normalization's bias (row_max) and the
# streaming collection (a catalogue far under POOL_MIN_CORPUS).
SEARCHV_KERNELS = ("row_max", "fused_topk", "count_above")

# Pure Python (no numpy import: the stub starts once per video).
STUB_FRAME = """
import random


def frame_bytes(seed, j, h=%d, w=%d):
    # 8x8 blocks of random colours, row-major RGB24.
    px = random.Random(seed * 1000 + j).randbytes((h // 8) * (w // 8) * 3)
    rows = []
    for r in range(h // 8):
        row = b"".join(px[3 * (r * (w // 8) + c):3 * (r * (w // 8) + c) + 3] * 8
                       for c in range(w // 8))
        rows.append(row * 8)
    return b"".join(rows)
""" % (VIDEO_H, VIDEO_W)

STUB_FFMPEG = """#!%s
import json, sys
""" + STUB_FRAME + """
spec = json.load(open(sys.argv[sys.argv.index("-i") + 1]))
for seed, j in spec["frames"]:
    sys.stdout.buffer.write(frame_bytes(seed, j))
"""

STUB_FFPROBE = """#!/bin/sh
echo '{"streams": [{"width": %d, "height": %d}]}'
""" % (VIDEO_W, VIDEO_H)


def stub_frame_fn(np):
    """The stub's frame (seed, j) as a uint8 [H, W, 3] array."""
    scope = {}
    exec(STUB_FRAME, scope)
    return lambda seed, j: np.frombuffer(scope["frame_bytes"](seed, j), np.uint8).reshape(
        VIDEO_H, VIDEO_W, 3)


def make_videos(np, work: Path):
    """Stub tools, the reference, query and noise video directories and
    the ground truth of the planted copies. Returns their paths."""
    import os
    import stat

    from vsc2022_torch.metrics import Match

    tools = work / "tools"
    tools.mkdir(parents=True, exist_ok=True)
    for name, text in (("ffmpeg", STUB_FFMPEG % sys.executable), ("ffprobe", STUB_FFPROBE)):
        (tools / name).write_text(text)
        os.chmod(tools / name, os.stat(tools / name).st_mode | stat.S_IEXEC)
    rng = np.random.RandomState(8)
    dirs = {k: work / k for k in ("refs", "queries", "noise")}
    for d in dirs.values():
        d.mkdir(exist_ok=True)

    def write(path, frames):
        path.write_text(json.dumps({"frames": [list(f) for f in frames]}))

    refs = []
    for i in range(EXTRACT_REFS):
        n = int(rng.randint(EXTRACT_REF_FRAMES[0], EXTRACT_REF_FRAMES[1] + 1))
        refs.append([(1000 + i, j) for j in range(n)])
        write(dirs["refs"] / f"R{i:06d}.mp4", refs[-1])
    for i in range(EXTRACT_NOISE):
        write(dirs["noise"] / f"R{1000 + i:06d}.mp4",
              [(3000 + i, j) for j in range(EXTRACT_NOISE_FRAMES)])
    gt = []
    sources = rng.choice(EXTRACT_REFS, EXTRACT_COPIES, replace=False)
    for i in range(EXTRACT_QUERIES):
        n = int(rng.randint(EXTRACT_QUERY_FRAMES[0], EXTRACT_QUERY_FRAMES[1] + 1))
        frames = [(2000 + i, j) for j in range(n)]
        if i < EXTRACT_COPIES:
            r = int(sources[i])
            qs = int(rng.randint(0, n - EXTRACT_COPY_FRAMES + 1))
            rs = int(rng.randint(0, len(refs[r]) - EXTRACT_COPY_FRAMES + 1))
            frames[qs:qs + EXTRACT_COPY_FRAMES] = refs[r][rs:rs + EXTRACT_COPY_FRAMES]
            gt.append(Match(f"Q{i:06d}", f"R{r:06d}", 1.0, float(qs),
                            float(qs + EXTRACT_COPY_FRAMES), float(rs),
                            float(rs + EXTRACT_COPY_FRAMES)))
        write(dirs["queries"] / f"Q{i:06d}.mp4", frames)
    Match.write_csv(gt, str(work / "gt.csv"))
    n_ref_frames = sum(len(r) for r in refs)
    return dict({k: str(v) for k, v in dirs.items()}, ffmpeg=str(tools / "ffmpeg"),
                gt=str(work / "gt.csv"), ref_frames=n_ref_frames)


def extraction_weights(torch, work: Path) -> str:
    """The SSCD weights of phase 8 (``seeded_sscd``), written by the port as
    TorchScript."""
    path = str(work / "sscd.torchscript.pt")
    torch.jit.save(torch.jit.trace(seeded_sscd(torch), torch.zeros(1, 3, 64, 64)), path)
    return path


def seeded_sscd(torch):
    """The port's SSCD ResNet-50 → 512 in eval mode: Flax's distributions
    from a seed, with BatchNorm statistics and affines drawn too, so that
    every norm (and --fold_bn) does real work."""
    from vsc2022_torch.models.init import init_flax_like
    from vsc2022_torch.models.sscd import SSCDModel

    g = torch.Generator().manual_seed(8)
    model = SSCDModel()
    init_flax_like(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.normal_(1.0, 0.1, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model.eval()


def npz_arrays(np, path):
    with np.load(path) as a:
        return {k: a[k] for k in a.files}


def same_arrays(np, a, b) -> bool:
    """The same npz arrays: names, dtypes, shapes and bytes."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def cli_argv(videos, dataset, out, *flags):
    return ["--dataset_path", videos[dataset], "--output_file", str(out),
            "--ffmpeg_path", videos["ffmpeg"], "--batch_size", str(EXTRACT_BATCH),
            "--device", "cuda", *flags]


def peak_mib_from(torch, base: int) -> float:
    """The device's peak allocation since the last reset, above ``base``
    bytes (what earlier phases still hold)."""
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def run_cli(torch, label, argv):
    """``vsc2022_torch.inference.cli.main`` in this process; logs its
    stage seconds and its device peak (above what was allocated before)."""
    from vsc2022_torch.inference import cli

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = cli.main(cli.parser.parse_args(argv))
    wall = time.perf_counter() - t0
    peak = peak_mib_from(torch, base)
    torch.cuda.empty_cache()
    log(f"phase 8: CLI {label}: {wall:.2f} s wall; stages (s): " + json.dumps(
        {k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()})
        + f"; device peak {peak:.0f} MiB")


def cpu_reference(torch, np, videos, argv, video="Q000000"):
    """The first CPU_CHECK_FRAMES frames of one query video through the
    port's plain CPU forward of the same model (``build_model`` of the same
    flags): (frames' descriptors, the frames' row indices in the npz)."""
    from vsc2022_torch.inference import cli
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import InferenceTransforms
    from vsc2022_torch.inference.video_reader import FFMpegVideoReader

    args = cli.parser.parse_args(argv)
    reader = FFMpegVideoReader(str(Path(videos["queries"]) / f"{video}.mp4"), 1.0,
                               ffmpeg_path=videos["ffmpeg"])
    frames = np.stack([f for _, _, f in reader.frames()][:CPU_CHECK_FRAMES])
    extractor = DescriptorExtractor(cli.build_model(args),
                                    InferenceTransforms[args.transforms],
                                    batch_size=CPU_CHECK_FRAMES, device="cpu")
    return extractor.forward(torch.from_numpy(frames)).numpy()


def rel_err(np, got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def cosines(np, a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def forward_rates(torch, np, dev, weights):
    """Frames per second of the forward alone (preprocess and model on the
    card, from uint8 frames already there) over FORWARD_FRAMES pre-decoded
    640x360 frames in batches of EXTRACT_BATCH, f32 and bf16, with the
    device's peak memory above the model and the frames."""
    from vsc2022_torch.inference import cli
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import InferenceTransforms

    frame = stub_frame_fn(np)
    frames = torch.from_numpy(np.stack([frame(1000 + i // 40, i % 40)
                                        for i in range(FORWARD_FRAMES)])).to(dev)
    rates = {}
    for label, baseline, transform, extra in (
        ("sscd", "sscd", "RESIZE_320_CENTER", ["--torchscript_path", weights]),
        ("dino224", "dino", "RESIZE_224_SQUARE", []),
        ("dino320", "dino", "RESIZE_320_CENTER", []),
        ("l3imac", "dns", "RESIZE_320_CENTER", []),
    ):
        args = cli.parser.parse_args(["--baseline", baseline, "--dataset_path", "-",
                                      "--output_file", "-", *extra])
        for dtype in ("float32", "bfloat16"):
            extractor = DescriptorExtractor(cli.build_model(args),
                                            InferenceTransforms[transform],
                                            batch_size=EXTRACT_BATCH,
                                            compute_dtype=dtype, device=dev)
            extractor.forward(frames[:EXTRACT_BATCH])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(0, FORWARD_FRAMES, EXTRACT_BATCH):
                extractor.forward(frames[i:i + EXTRACT_BATCH])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rates[f"{label}.{dtype}"] = {
                "fps": FORWARD_FRAMES / seconds,
                "peak_mib": peak_mib_from(torch, base)}
            del extractor
            torch.cuda.empty_cache()
    log("phase 8: forward alone, frames per second (and device peak MiB) over "
        f"{FORWARD_FRAMES} pre-decoded {VIDEO_W}x{VIDEO_H} frames, batch "
        f"{EXTRACT_BATCH}: " + json.dumps(rates))


def phase_extraction(torch, np, kernels, dev):
    """Phase 8: the inference CLI at full width on synthetic videos (SSCD
    f32, bf16 and --fold_bn; DINO at 224 and 320 px; L3-iMAC), each held
    against the port's CPU forward (bf16 against f32 by cosine, --fold_bn
    against the unfolded model); then serve --baseline sscd: extract ≡
    the CLI's npz and searchv ≡ search of it, byte for byte, with the
    searchv path's kernel launches counted; the µAP of the planted copies;
    the forward's frames per second. Returns searchv's launch counts."""
    import logging
    import shutil as sh

    from vsc2022_torch.baseline import pipeline

    work = SMOKE_DIR / "extract"
    work.mkdir(parents=True, exist_ok=True)
    log(f"phase 8: ffmpeg on this machine: {sh.which('ffmpeg')}; the videos are "
        "decoded by stub ffmpeg / ffprobe executables")
    t0 = time.perf_counter()
    videos = make_videos(np, work)
    weights = extraction_weights(torch, work)
    log(f"phase 8: {EXTRACT_REFS} reference videos ({videos['ref_frames']} frames), "
        f"{EXTRACT_QUERIES} query videos ({EXTRACT_COPIES} with a "
        f"{EXTRACT_COPY_FRAMES}-frame copy), {EXTRACT_NOISE} noise videos, "
        f"{VIDEO_W}x{VIDEO_H} at fps 1; weights and recipes in "
        f"{time.perf_counter() - t0:.1f} s")
    sscd = ["--baseline", "sscd", "--torchscript_path", weights,
            "--transforms", "RESIZE_320_CENTER"]
    out = {k: work / f"{k}.npz" for k in ("refs", "noise", "q", "q_bf16", "q_fold",
                                          "q_dino224", "q_dino320", "q_l3imac")}
    run_cli(torch, "SSCD f32, references", cli_argv(videos, "refs", out["refs"], *sscd))
    run_cli(torch, "SSCD f32, noise", cli_argv(videos, "noise", out["noise"], *sscd))
    # The queries through `python -m`, as a user runs it.
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "vsc2022_torch.inference.cli",
                          *cli_argv(videos, "queries", out["q"], *sscd)],
                         cwd=str(REPO), capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"the inference CLI failed: {run.stderr[-3000:]}")
    stage_line = [ln for ln in run.stderr.splitlines() if "stages:" in ln]
    check(bool(stage_line), "the inference CLI logged no stage seconds")
    log(f"phase 8: python -m vsc2022_torch.inference.cli, SSCD f32, queries: "
        f"{time.perf_counter() - t0:.2f} s wall; {stage_line[-1].split('INFO')[-1].strip()}")
    variants = {
        "q_bf16": ("SSCD bf16", sscd + ["--compute_dtype", "bfloat16"]),
        "q_fold": ("SSCD f32 --fold_bn", sscd + ["--fold_bn"]),
        "q_dino224": ("DINO ViT-S/16 f32, RESIZE_224_SQUARE",
                      ["--baseline", "dino", "--transforms", "RESIZE_224_SQUARE"]),
        "q_dino320": ("DINO ViT-S/16 f32, RESIZE_320_CENTER",
                      ["--baseline", "dino", "--transforms", "RESIZE_320_CENTER"]),
        "q_l3imac": ("L3-iMAC f32, RESIZE_320_CENTER",
                     ["--baseline", "dns", "--transforms", "RESIZE_320_CENTER"]),
    }
    for key, (label, flags) in variants.items():
        run_cli(torch, label + ", queries", cli_argv(videos, "queries", out[key], *flags))
    arrays = {k: npz_arrays(np, v) for k, v in out.items()}
    n_query_frames = arrays["q"]["features"].shape[0]
    widths = {"q": 512, "q_bf16": 512, "q_fold": 512, "q_dino224": 768,
              "q_dino320": 768, "q_l3imac": 9 * 3840}
    for key, width in widths.items():
        f = arrays[key]["features"]
        check(f.shape == (n_query_frames, width) and f.dtype == np.float32
              and bool(np.isfinite(f).all()), f"{key}: features {f.shape} {f.dtype}")
        check(list(arrays[key]["video_ids"]) == list(arrays["q"]["video_ids"]),
              f"{key}: video ids differ from the f32 run's")

    # The card against the port's plain CPU forward, same weights.
    errs = {}
    for key, flags in (("q", sscd), ("q_fold", variants["q_fold"][1]),
                       ("q_dino224", variants["q_dino224"][1]),
                       ("q_dino320", variants["q_dino320"][1]),
                       ("q_l3imac", variants["q_l3imac"][1])):
        want = cpu_reference(torch, np, videos,
                             cli_argv(videos, "queries", "-", *flags))
        errs[key] = rel_err(np, arrays[key]["features"][:CPU_CHECK_FRAMES], want)
        check(errs[key] <= EXTRACT_REL_TOL,
              f"{key}: card vs CPU forward {errs[key]:.3g} of the largest value")
    errs["q_fold vs q"] = rel_err(np, arrays["q_fold"]["features"], arrays["q"]["features"])
    check(errs["q_fold vs q"] <= EXTRACT_REL_TOL,
          f"--fold_bn vs unfolded: {errs['q_fold vs q']:.3g}")
    cos = cosines(np, arrays["q_bf16"]["features"], arrays["q"]["features"])
    check(float(cos.min()) >= BF16_COSINE_MIN, f"bf16 vs f32: cosine {cos.min()}")
    log(f"phase 8: card vs the port's CPU forward on {CPU_CHECK_FRAMES} frames "
        f"(max |diff| / max |value|, tolerance {EXTRACT_REL_TOL}): " + json.dumps(
            {k: float(f"{v:.3g}") for k, v in errs.items()})
        + f"; bf16 vs f32 cosine min {cos.min():.6f} (>= {BF16_COSINE_MIN})")

    # serve --baseline sscd: extract and searchv on the resident model.
    csv = {k: str(work / f"{k}.csv") for k in ("c", "m", "vc", "vm")}
    extra = ["--baseline", "sscd", "--torchscript_path", weights,
             "--ffmpeg_path", videos["ffmpeg"], "--extract_batch_size", str(EXTRACT_BATCH),
             "--extract_transforms", "RESIZE_320_CENTER"]
    with open(work / "server.log", "w") as server_log:
        with spawn_server(str(out["refs"]), server_log, score_norm_features=str(out["noise"]),
                          matches=True, f32=True, extra_args=extra) as client:
            log(f"phase 8: server --baseline sscd ready, {client.n_ref_videos} videos "
                f"staged in {client.stage_seconds:.1f} s")
            served = work / "served_q.npz"
            n = timed("extract", lambda: client.extract(videos["queries"], str(served)),
                      phase="8")
            check(n == (EXTRACT_QUERIES, n_query_frames), f"extract: {n}")
            check(same_arrays(np, npz_arrays(np, served), arrays["q"]),
                  "server extract: the npz arrays differ from the CLI's")
            timed("search of the CLI's npz", lambda: client.search(
                str(out["q"]), candidates_csv=csv["c"], matches_csv=csv["m"]), phase="8")
            client.launches(reset=True)
            video = timed("searchv", lambda: client.search_videos(
                videos["queries"], candidates_csv=csv["vc"], matches_csv=csv["vm"]),
                phase="8")
            launches = client.launches()
    log(f"phase 8: server kernel launches over searchv: {json.dumps(launches)}")
    for name in SEARCHV_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched by searchv")
    for a, b in (("c", "vc"), ("m", "vm")):
        check(Path(csv[a]).read_bytes() == Path(csv[b]).read_bytes(),
              f"searchv's {b}.csv differs from search's {a}.csv")
    quality = pipeline.report_metrics(videos["gt"], csv["vc"], csv["vm"],
                                      logging.getLogger("chip_smoke"))
    log(f"phase 8: extract == the CLI's npz and searchv == search of it, byte for "
        f"byte; {video.n_candidates} candidates, {video.n_matches} matches; "
        f"µAP of the {EXTRACT_COPIES} planted copies {quality['candidate_uap']:.4f}, "
        f"segment AP {quality['segment_ap']:.4f}")
    check(quality["candidate_uap"] > 0.5, f"searchv uAP {quality['candidate_uap']}")
    forward_rates(torch, np, dev, weights)
    return launches, {"videos": videos, "weights": weights, "q": out["q"]}


# ---- phase 9: the corpus sharded over one card ---------------------------------

# 9a and 10a search the first SHARD_REF_VIDEOS of phase 4's 16,667 reference
# videos (540,000 rows; cut to keep the script in its time): over 2 shards
# shard_rows 270,336 (>= POOL_MIN_CORPUS: pooled), over 4 shards 139,264
# (below it: the stream), with no mode forced.
SHARD_REF_VIDEOS = 9000
SHARD_MODES = {2: "pooled", 4: "stream"}
# 9a's separate allocations, 9d's serving index and its localizer, and 9e's
# DnSLocalization: over this many shards.
SHARDED_TABLES = 4
# The kernels of an f32 search that streams (the SN bias, then the stream).
STREAM_KERNELS = ("row_max", "fused_topk", "count_above")


def _sharded_launches(kernels, fn):
    """fn()'s result and the kernel launches it made (the counts set to 0
    just before)."""
    kernels.reset_launches()
    out = fn()
    return out, {k: v for k, v in kernels.launches.items() if v}


def _same_topk(np, got, want, what):
    """One global_topk each, equal bit for bit."""
    check(len(got) == len(want) == 1, f"{what}: {len(got)} and {len(want)} searches")
    (g, _), (w, _) = got[0], want[0]
    check(g[0].size > 0 and all(a.dtype == b.dtype for a, b in zip(g, w)),
          f"{what}: global_topk gave {g[0].size} pairs")
    check(all(np.array_equal(a, b) for a, b in zip(g, w)),
          f"{what}: global_topk differs from the single-device searcher's")


def _check_per_shard(counts, n, mode, what, single=None):
    """Each of the n shards launched every kernel alike (each count a
    multiple of n): the SN bias's row_max and the collection's kernels
    (pooled: pool_writer; stream: fused_topk and count_above) once a
    shard. ``single``: the launches of a single-device search in the same
    mode, each of which every shard made."""
    by_kernel = {name.split(".")[0]: v for name, v in counts.items()}
    need = ("row_max", "pool_writer") if mode == "pooled" else STREAM_KERNELS
    check(all(v % n == 0 for v in counts.values())
          and all(by_kernel.get(name) == n for name in need)
          and (single is None or counts == {name: n * v for name, v in single.items()}),
          f"{what}: launches {counts}, not {need} once on each of {n} shards"
          + ("" if single is None else f" and {n} x the single device's {single}"))


def phase_sharded_search(torch, np, kernels, dev, paths):
    """9a: ScoreNormalizedVideoIndex(mesh=Mesh([dev] * n)) over phase 4's
    queries and noise and its first SHARD_REF_VIDEOS reference videos, n =
    2 (pooled) and 4 (stream), in f32, bf16 and int8:
    global_topk's arrays equal the single-device index's bit for bit, the
    ranked candidates exactly, and each shard launches every kernel the
    single device launches, as often. f32's 4 shards of this card are
    each its own allocation (as on separate cards; its 2 shards are one
    allocation), and f32 runs one shard per card where there are several,
    bit for bit too: the f32 re-search runs an allocation at a time on the
    single-device searcher's cuBLAS calls of one shape (``_f32_scores``).
    Logs each index's staging and search seconds and its steps; saves the
    single device's arrays for phase 10a. Returns {label: launches of its
    search}."""
    from unittest import mock

    from vsc2022_torch.metrics import Dataset
    from vsc2022_torch.parallel import Mesh
    from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher
    from vsc2022_torch.retrieval.candidates import MaxScoreAggregation, rank_candidates
    from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex
    from vsc2022_torch.storage import load_features

    t0 = time.perf_counter()
    queries = load_features(paths["queries"], Dataset.QUERIES)
    refs = load_features(paths["refs"], Dataset.REFS)[:SHARD_REF_VIDEOS]
    noise = load_features(paths["noise"], Dataset.REFS)
    log(f"phase 9a: phase 4's corpus loaded in {time.perf_counter() - t0:.1f} s; its "
        f"first {len(refs)} reference videos ({sum(len(r) for r in refs)} rows) searched")
    k = 1200 * len(queries)
    # (label, shards, mesh, one allocation a shard). f32 runs its 4 shards
    # each in an allocation of its own only (its 2 shards are one).
    meshes = [(f"{n} shards", n, Mesh([dev] * n), False) for n in SHARD_MODES]
    meshes.append((f"{SHARDED_TABLES} shards, one allocation each", SHARDED_TABLES,
                   Mesh([dev] * SHARDED_TABLES), True))
    cards = torch.cuda.device_count()
    if cards > 1:
        meshes.append((f"{cards} shards, one a card", cards,
                       Mesh([torch.device("cuda", i) for i in range(cards)]), True))
    else:
        log("phase 9a: one card: one shard per card is one shard, not run")
    launches, walls = {}, {}

    def run(label, mesh, dtype, apart=False):
        index = ScoreNormalizedVideoIndex(DIM, noise, beta=1.2, dtype=dtype, device=dev,
                                          mesh=mesh)
        index.add(refs)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with mock.patch.object(ShardedSimilaritySearcher, "_allocations",
                               lambda self: [[s] for s in range(self.n_dev)]) \
                if apart else contextlib.nullcontext():
            searcher = index._get_searcher().searcher
        torch.cuda.synchronize(dev)
        stage = time.perf_counter() - t0
        with topk_results() as seen:
            t0 = time.perf_counter()
            cands, counts = _sharded_launches(kernels, lambda: rank_candidates(
                index.search(queries, global_k=k), MaxScoreAggregation()))
            search = time.perf_counter() - t0
        st = dict(searcher.last_stats)
        walls[label] = {"stage_s": round(stage, 3), "search_s": round(search, 3),
                        "mode": st["mode"], "steps_s": st.pop("seconds"),
                        "staged_bytes": searcher.staged_bytes(),
                        "shard_rows": getattr(searcher, "shard_rows", None)}
        log(f"phase 9a: {label}: staged {stage:.3f} s, search {search:.3f} s, "
            f"{json.dumps(walls[label])}; launches {json.dumps(counts)}")
        del index, searcher
        return cands, seen, counts

    for dtype in ("float32", "bfloat16", "int8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        want, want_topk, single = run(f"{dtype} 1 shard (SimilaritySearcher)", None, dtype)
        save_single_topk(np, dtype, want_topk)
        single_mode = want_topk[0][1]
        for name, n, mesh, apart in meshes:
            if (dtype != "float32" and apart) or (
                    dtype == "float32" and n == SHARDED_TABLES and not apart):
                continue
            label = f"{dtype} {name}"
            got, got_topk, counts = run(label, mesh, dtype, apart)
            _same_topk(np, got_topk, want_topk, f"9a {label}")
            check_same_candidates(got, want, f"9a {label}", tol=0.0)
            mode = walls[label]["mode"]
            check(n not in SHARD_MODES or mode == SHARD_MODES[n],
                  f"9a {label}: ran {mode}, not {SHARD_MODES.get(n)}")
            _check_per_shard(counts, n, mode, f"9a {label}",
                             single if mode == single_mode else None)
            launches[f"9a {label}"] = counts
        log(f"phase 9a: {dtype}: every shard count == one device bit for bit "
            f"({len(want)} pairs); device peak "
            f"{(torch.cuda.max_memory_allocated(dev) - base) / 2**20:.0f} MiB above "
            "the phase's start")
    return launches


def start_sharded_descriptor_eval(paths):
    """9b: ``python -m vsc2022_torch.descriptor_eval --sharded`` (one shard
    a card, through corpus_mesh()) on phase 4's files, started in the
    background; ``finish_sharded_descriptor_eval`` checks it. It runs
    alongside the in-process 9b and 9c, which share the card with it
    (their times are logged, not checked). Returns (process, log path,
    start time)."""
    out = SMOKE_DIR / "out"
    log_path = SMOKE_DIR / "descriptor_eval_sharded.log"
    argv = ["--query_features", paths["queries"], "--ref_features", paths["refs"],
            "--ground_truth", paths["gt"], "--device", "cuda", "--sharded",
            "--candidates_output", str(out / "descriptor_candidates_sharded.csv")]
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "vsc2022_torch.descriptor_eval",
                                 *argv], cwd=str(REPO), stdout=f, stderr=subprocess.STDOUT)
    return proc, log_path, time.perf_counter()


def finish_sharded_descriptor_eval(torch, started):
    """9b: waits for ``start_sharded_descriptor_eval``'s process; its
    candidates.csv must be phase 4's unsharded run's, byte for byte."""
    proc, log_path, t0 = started
    out = SMOKE_DIR / "out"
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0, f"descriptor_eval --sharded failed: {log_path.read_text()[-3000:]}")
    check((out / "descriptor_candidates_sharded.csv").read_bytes()
          == (out / "descriptor_candidates.csv").read_bytes(),
          "9b: descriptor_eval --sharded wrote other candidates than phase 4")
    log(f"phase 9b: python -m vsc2022_torch.descriptor_eval --sharded "
        f"({torch.cuda.device_count()} card(s), one shard each): "
        f"{time.perf_counter() - t0:.2f} s wall (alongside 9b in process and 9c); "
        "candidates.csv == phase 4's, byte for byte")


def phase_sharded_entry_points(torch, np, kernels, dev, paths):
    """9b: ``vsc2022_torch.descriptor_eval --sharded``'s main in process on
    a 2-shard mesh of this card: candidates.csv byte-identical to phase
    4's unsharded run (its ``python -m`` run: ``start_sharded_descriptor_eval``)."""
    from unittest import mock

    import vsc2022_torch.parallel as parallel
    from vsc2022_torch import descriptor_eval
    from vsc2022_torch.parallel import Mesh

    out = SMOKE_DIR / "out"
    want = (out / "descriptor_candidates.csv").read_bytes()
    argv = ["--query_features", paths["queries"], "--ref_features", paths["refs"],
            "--ground_truth", paths["gt"], "--device", "cuda", "--sharded",
            "--candidates_output"]
    two = Mesh([dev] * 2)
    with mock.patch.object(parallel, "corpus_mesh", lambda *a, **kw: two), \
            topk_results() as seen:
        t0 = time.perf_counter()
        _, counts = _sharded_launches(kernels, lambda: descriptor_eval.main(
            descriptor_eval.parser.parse_args(
                argv + [str(out / "descriptor_candidates_2.csv")])))
    check((out / "descriptor_candidates_2.csv").read_bytes() == want,
          "9b: descriptor_eval --sharded over 2 shards wrote other candidates")
    check(counts.get("pool_writer") == 2 and all(v % 2 == 0 for v in counts.values()),
          f"9b: launches {counts}: not each kernel once a shard")
    log(f"phase 9b: descriptor_eval --sharded in process over 2 shards of this card: "
        f"{time.perf_counter() - t0:.2f} s, mode {seen[0][1]}; candidates.csv == "
        f"phase 4's, byte for byte; launches {json.dumps(counts)}")
    return {"9b descriptor_eval, 2 shards": counts}


def phase_sharded_serve(torch, np, kernels, dev, corpus):
    """9c: serve --f32 --sharded --score_norm_features --matches over phase
    6's catalogue (corpus_mesh(): one shard a card), requests (a)-(g): the
    replies and files of the unsharded server (phase 6), byte for byte;
    stats says sharded. 9d: the same requests in process through
    serve_request, on the serving index and its localizer (shard_ref_table)
    over SHARDED_TABLES shards of this card: phase 6's files, byte for
    byte."""
    from vsc2022_torch.parallel import Mesh
    from vsc2022_torch.retrieval import serve
    from vsc2022_torch.retrieval.candidates import MaxScoreAggregation
    from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex

    work, paths, removed = corpus["work"], corpus["paths"], corpus["removed"]

    def same_files(tag, x, what):
        for i, suffix in enumerate(("c", "m")):
            got = (work / f"{tag}_{x}_{suffix}.csv").read_bytes()
            check(got == (work / f"f32_{x}_{suffix}.csv").read_bytes() and got.count(b"\n") > 1,
                  f"{what}: ({x}) {suffix}.csv differs from phase 6's")

    def csvs(tag, x):
        return dict(candidates_csv=str(work / f"{tag}_{x}_c.csv"),
                    matches_csv=str(work / f"{tag}_{x}_m.csv"))

    with open(work / "server_sharded.log", "w") as server_log:
        with spawn_server(paths["refs"], server_log, score_norm_features=paths["noise"],
                          matches=True, f32=True, sharded=True) as client:
            log(f"phase 9c: server --sharded ready, {client.n_ref_videos} videos staged "
                f"in {client.stage_seconds:.1f} s")
            client.launches(reset=True)
            timed("a", lambda: client.search(paths["queries"], **csvs("sh", "a")), "9c")
            b = timed("b", lambda: client.search_bytes(Path(paths["queries"]).read_bytes()),
                      "9c")
            check(b.candidates_csv == (work / "f32_a_c.csv").read_bytes()
                  and b.matches_csv == (work / "f32_a_m.csv").read_bytes(),
                  "9c: (b) in-band differs from phase 6's (a)")
            timed("c", lambda: client.search(str(work / "q1.npz"), **csvs("sh", "c")), "9c")
            n_add = timed("d", lambda: client.add(str(work / "add.npz")), "9c")
            n_rm = timed("e", lambda: client.remove(removed), "9c")
            n_save = timed("f", lambda: client.save(str(work / "sh_snap.npz")), "9c")
            timed("g", lambda: client.search(paths["queries"], **csvs("sh", "g")), "9c")
            stats = client.stats()
            counts = client.launches()
            probe_refused(client, paths["queries"], "9c (serve --sharded)")
    check((n_add, n_rm, n_save) == (SERVE_ADD, (SERVE_REMOVE, SERVE_REMOVE * FRAMES),
                                    SERVE_REF_VIDEOS), f"9c: add/remove/save {n_add} "
          f"{n_rm} {n_save}")
    check(stats.sharded and stats.dtype == "float32"
          and stats.n_frames == SERVE_REF_VIDEOS * FRAMES, f"9c: stats {stats}")
    # Four searches, (a), (b), (c) and (g), each streaming on every card's shard.
    cards = torch.cuda.device_count()
    check({k: v for k, v in counts.items() if v} == {name: 4 * cards for name in STREAM_KERNELS},
          f"9c: launches {counts}, not {STREAM_KERNELS} once a search and a card")
    for x in ("a", "c", "g"):
        same_files("sh", x, "9c")
    with np.load(work / "sh_snap.npz") as a, np.load(work / "f32_snap.npz") as b:
        check(all(np.array_equal(a[key], b[key]) for key in b.files),
              "9c: the snapshot differs from phase 6's")
    log(f"phase 9c: requests (a)-(g) == phase 6's replies and files, byte for byte; "
        f"stats: sharded {stats.sharded}; launches {json.dumps({k: v for k, v in counts.items() if v})}")

    args = serve.parser.parse_args(["--ref_features", paths["refs"], "--score_norm_features",
                                    paths["noise"], "--matches", "--f32"])
    mesh = Mesh([dev] * SHARDED_TABLES)
    index = ScoreNormalizedVideoIndex(DIM, corpus["noise"], beta=args.beta,
                                      dtype="float32", device=dev, mesh=mesh)
    index.add(corpus["refs"])
    localizer = serve.build_localizer(index, corpus["refs"], args, dev)
    check(localizer._shard_ref_table and localizer.mesh is mesh, "9d: tables not sharded")
    agg = MaxScoreAggregation()

    def request(line):
        return serve.serve_request(index, agg, localizer, line, args)

    def search(x):
        c = csvs("sh4", x)
        return request(f"{paths['queries']}\t{c['candidates_csv']}\t{c['matches_csv']}")

    t0 = time.perf_counter()
    _, counts_a = _sharded_launches(kernels, lambda: search("a"))
    table = localizer._tables["ref"][0]
    request(f"add\t{work / 'add.npz'}")
    request("remove\t" + "\t".join(str(v) for v in removed))
    _, counts_g = _sharded_launches(kernels, lambda: search("g"))
    for x in ("a", "g"):
        same_files("sh4", x, f"9d ({SHARDED_TABLES} shards)")
    mode = index._searcher.searcher.last_stats["mode"]
    for x, counts_x in (("a", counts_a), ("g", counts_g)):
        _check_per_shard(counts_x, SHARDED_TABLES, mode, f"9d ({x})")
    log(f"phase 9d: serving index + localizer over {SHARDED_TABLES} shards "
        f"(ref table {table.rows} rows, {table.shard_rows} a shard), (a), add, remove, "
        f"(g) in process: {time.perf_counter() - t0:.2f} s; (a) and (g) == phase 6's "
        f"files, byte for byte; search mode {mode}; launches (a) "
        f"{json.dumps(counts_a)}")
    del index, localizer
    torch.cuda.empty_cache()
    return {"9c serve --sharded (one shard), requests (a)-(g)": {k: v for k, v in counts.items() if v},
            f"9d serving, {SHARDED_TABLES} shards": counts_a}


def phase_sharded_dns(torch, np, kernels, dev):
    """9e: DnSLocalization with row-sharded coarse and fine tables over
    SHARDED_TABLES shards, on phase 5's candidates: its matches the rows of
    dns_baseline's (phase 5), scores within FLOAT_ATOL; the chamfer kernel
    runs per pair tile."""
    from vsc2022_torch.baseline import dns_baseline, pipeline
    from vsc2022_torch.metrics import CandidatePair, Dataset, Match
    from vsc2022_torch.parallel import Mesh
    from vsc2022_torch.storage import load_features

    work = SMOKE_DIR / "dns"
    idx, out = work / "idx", work / "out"

    def by_id(name, ds):
        return {vf.video_id: vf for vf in load_features(str(idx / name), ds)}

    queries_fine = by_id("queries_fg_att_student.npz", Dataset.QUERIES)
    refs_fine = by_id("refs_fg_att_student.npz", Dataset.REFS)
    queries = load_features(str(idx / "queries_cg_student_sn.npz"), Dataset.QUERIES)
    refs = load_features(str(idx / "refs_cg_student_sn.npz"), Dataset.REFS)
    cands = CandidatePair.read_csv(str(out / "candidates.csv"))
    cands = cands[: int(len(queries_fine) * pipeline.LOCALIZE_PER_QUERY)]
    loc = dns_baseline.DnSLocalization(
        queries_fine, refs_fine, queries, refs, model_type="TN", fg_type="att",
        tn_max_step=5, min_length=4, similarity_bias=0.5, device=dev,
        mesh=Mesh([dev] * SHARDED_TABLES), shard_ref_table=True)
    t0 = time.perf_counter()
    matches, counts = _sharded_launches(kernels, lambda: loc.localize_all(cands))
    wall = time.perf_counter() - t0
    path = work / "matches_sharded.csv"
    Match.write_csv(matches, str(path))
    n = check_same_rows(path, out / "matches.csv", "9e: sharded DnS matches")
    tables = {name: loc._tables[name][0].shard_rows for name in ("ref", "ref_fine")}
    log(f"phase 9e: DnSLocalization over {SHARDED_TABLES} shards (shard rows "
        f"{json.dumps(tables)}), {len(cands)} pairs: {wall:.2f} s; {n} matches == "
        f"dns_baseline's rows, scores within {FLOAT_ATOL}; launches {json.dumps(counts)}")
    check(counts.get("chamfer", 0) >= SHARDED_TABLES, f"9e: chamfer launches {counts}")
    return {f"9e DnS, {SHARDED_TABLES} shards": counts}


def phase_sharded_extraction(torch, np, dev):
    """9f: DescriptorExtractor over 2 shards of this card against the
    unsharded extractor, SSCD at full width on random 640x360 frames:
    within EXTRACT_REL_TOL (1e-5) of the largest value."""
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import InferenceTransforms
    from vsc2022_torch.parallel import Mesh

    rng = np.random.default_rng(9)
    videos = {f"Q{i:06d}": rng.integers(0, 256, (n, VIDEO_H, VIDEO_W, 3), dtype=np.uint8)
              for i, n in enumerate((40, 25, 33))}

    class Frames:
        def iter_decoded(self):
            for name, frames in videos.items():
                yield name, frames, np.stack([np.arange(len(frames)),
                                              np.arange(len(frames)) + 1.0], axis=1)

    model = seeded_sscd(torch)
    feats, walls = {}, {}
    for label, kw in (("1 device", {"device": dev}), ("2 shards", {"mesh": Mesh([dev] * 2)})):
        ex = DescriptorExtractor(model, InferenceTransforms.RESIZE_320_CENTER,
                                 batch_size=EXTRACT_BATCH, **kw)
        t0 = time.perf_counter()
        feats[label] = {vf.video_id: vf.feature for vf in ex.extract(Frames())}
        walls[label] = round(time.perf_counter() - t0, 3)
    want = np.concatenate([feats["1 device"][v] for v in videos])
    got = np.concatenate([feats["2 shards"][v] for v in videos])
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape == (98, 512) and np.isfinite(got).all(),
          f"9f: descriptors {got.shape}")
    check(err <= EXTRACT_REL_TOL * float(np.abs(want).max()),
          f"9f: 2 shards off the unsharded forward by {err}")
    log(f"phase 9f: DescriptorExtractor over 2 shards == 1 device within {err:.3g} "
        f"(largest value {np.abs(want).max():.3g}); 98 frames, batch {EXTRACT_BATCH}: "
        f"{json.dumps(walls)} s")


def phase_sharded(torch, np, kernels, dev, paths, corpus):
    """Phase 9: the corpus-sharded paths (9a-9f). Returns {label: kernel
    launches} of each sharded path's run."""
    t0 = time.perf_counter()
    launches = phase_sharded_search(torch, np, kernels, dev, paths)
    torch.cuda.empty_cache()
    started = start_sharded_descriptor_eval(paths)
    try:
        launches.update(phase_sharded_entry_points(torch, np, kernels, dev, paths))
        launches.update(phase_sharded_serve(torch, np, kernels, dev, corpus))
    except BaseException:
        started[0].kill()
        started[0].wait()
        raise
    finish_sharded_descriptor_eval(torch, started)
    launches.update(phase_sharded_dns(torch, np, kernels, dev))
    phase_sharded_extraction(torch, np, dev)
    torch.cuda.empty_cache()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return launches



# ---- phase 10: a pod of two ranks on one card -----------------------------------

# The pod: two processes (ranks) in one torch.distributed group. On the
# one-card machine both ranks take cuda:0, so the group is gloo (NCCL
# refuses two ranks on one card): each collective stages its tensors on
# the host, while every kernel runs on the card.
POD_RANKS = 2
POD_BACKEND = "gloo"
POD_TIMEOUT = 600  # seconds a rank process may take
POD_DTYPES = ("float32", "bfloat16", "int8")


def _pod_single_path(dtype):
    return SMOKE_DIR / "pod" / f"single_{dtype}.npz"


def save_single_topk(np, dtype, topk):
    """9a's single-device global_topk arrays of ``dtype``, for phase 10a."""
    path = _pod_single_path(dtype)
    path.parent.mkdir(parents=True, exist_ok=True)
    (arrays, mode), = topk
    np.savez(path, q=arrays[0], r=arrays[1], s=arrays[2], mode=np.array(mode))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pod_rank_main(rank: int, port: int, out: Path) -> int:
    """One rank of phase 10's pod, run as ``chip_smoke.py --pod-rank R
    --pod-port P --pod-dir D``: 10a, 9a's corpus searched by a
    ScoreNormalizedVideoIndex over the pod mesh in each dtype, and 10c,
    DnSLocalization with row-sharded tables over the pod on phase 5's
    candidates. Writes its results, launches and seconds under ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from vsc2022_torch.baseline import dns_baseline, pipeline
    from vsc2022_torch.metrics import CandidatePair, Dataset, Match
    from vsc2022_torch.ops import _build, kernels
    from vsc2022_torch.parallel import corpus_mesh, initialize_distributed
    from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex
    from vsc2022_torch.storage import load_features

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dev = initialize_distributed(f"localhost:{port}", POD_RANKS, rank,
                                 backend=POD_BACKEND, device="cuda")
    _build.library()
    mesh = corpus_mesh(device=dev)
    report = {"device": str(dev), "mesh": repr(mesh), "join_s": time.perf_counter() - t0}
    paths = {k: str(SMOKE_DIR / f"{k}.npz") for k in ("queries", "refs", "noise")}
    t0 = time.perf_counter()
    queries = load_features(paths["queries"], Dataset.QUERIES)
    refs = load_features(paths["refs"], Dataset.REFS)[:SHARD_REF_VIDEOS]  # 9a's
    noise = load_features(paths["noise"], Dataset.REFS)
    report["load_s"] = time.perf_counter() - t0
    k = 1200 * len(queries)
    for dtype in POD_DTYPES:
        index = ScoreNormalizedVideoIndex(DIM, noise, beta=1.2, dtype=dtype, device=dev,
                                          mesh=mesh)
        index.add(refs)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        searcher = index._get_searcher().searcher
        torch.cuda.synchronize(dev)
        stage = time.perf_counter() - t0
        with topk_results() as seen:
            t0 = time.perf_counter()
            _, counts = _sharded_launches(kernels, lambda: index.search(queries, global_k=k))
            search = time.perf_counter() - t0
        (q, r, s), mode = seen[0]
        np.savez(out / f"rank{rank}_{dtype}.npz", q=q, r=r, s=s, mode=np.array(mode))
        st = dict(searcher.last_stats)
        report[dtype] = {"stage_s": stage, "search_s": search, "mode": mode,
                         "steps_s": st.pop("seconds"), "launches": counts,
                         "staged_bytes": searcher.staged_bytes(),
                         "shard_rows": searcher.shard_rows,
                         "local_shards": len(mesh.local)}
        del index, searcher
        torch.cuda.empty_cache()
    del refs, noise
    # 10c: the DnS localizer over the pod (phase 9e's run, one tile a rank).
    work = SMOKE_DIR / "dns"
    idx = work / "idx"

    def by_id(name, ds):
        return {vf.video_id: vf for vf in load_features(str(idx / name), ds)}

    queries_fine = by_id("queries_fg_att_student.npz", Dataset.QUERIES)
    cands = CandidatePair.read_csv(str(work / "out" / "candidates.csv"))
    cands = cands[: int(len(queries_fine) * pipeline.LOCALIZE_PER_QUERY)]
    loc = dns_baseline.DnSLocalization(
        queries_fine, by_id("refs_fg_att_student.npz", Dataset.REFS),
        load_features(str(idx / "queries_cg_student_sn.npz"), Dataset.QUERIES),
        load_features(str(idx / "refs_cg_student_sn.npz"), Dataset.REFS),
        model_type="TN", fg_type="att", tn_max_step=5, min_length=4,
        similarity_bias=0.5, device=dev, mesh=mesh, shard_ref_table=True)
    t0 = time.perf_counter()
    matches, counts = _sharded_launches(kernels, lambda: loc.localize_all(cands))
    Match.write_csv(matches, str(out / f"rank{rank}_dns_matches.csv"))
    report["dns"] = {"seconds": time.perf_counter() - t0, "pairs": len(cands),
                     "launches": counts,
                     "shard_rows": {n: loc._tables[n][0].shard_rows
                                    for n in ("ref", "ref_fine")}}
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    return 0


def _run_pod_ranks(out: Path):
    """Start the two rank processes of 10a/10c and wait for both (each
    killed on failure or time-out). Returns each rank's report."""
    from vsc2022_torch.utils.procs import die_with_parent

    out.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    for rank in range(POD_RANKS):
        logs.append(open(out / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--pod-rank", str(rank),
             "--pod-port", str(port), "--pod-dir", str(out)],
            cwd=str(REPO), stdout=logs[-1], stderr=subprocess.STDOUT,
            preexec_fn=die_with_parent))
    try:
        deadline = time.monotonic() + POD_TIMEOUT
        for rank, p in enumerate(procs):
            try:
                code = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = "timed out"
            if code != 0:
                tail = (out / f"rank{rank}.log").read_text()[-3000:]
                raise PhaseError(f"phase 10: pod rank {rank} failed ({code}):\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(POD_RANKS)]


def _check_rank_launches(counts, want, what):
    """Each rank launched each kernel of ``want`` (a one-process run's
    counts over its n shards, divided by n: once a shard) as often."""
    check(counts == want and all(v > 0 for v in want.values()),
          f"{what}: launches {counts}, not {want}")


def phase_pod_search_dns(np, kernels, sharded_launches):
    """10a and 10c, in one pair of rank processes. 10a: 9a's corpus as a
    pod ShardedSimilaritySearcher (two ranks, one shard each: 270,336
    rows, pooled) in f32, bf16 and int8 against 9a's single device, bit for
    bit in every dtype (each rank's shard is its own allocation: the f32
    re-search's calls have the single device's shape); both
    ranks' arrays equal; each rank launches each kernel of 9a's 2-shard
    search once. 10c: DnSLocalization over the pod on phase 5's pairs:
    both ranks hold dns_baseline's matches (phase 5), scores within
    FLOAT_ATOL; each rank launches the chamfer kernel on its tiles."""
    out = SMOKE_DIR / "pod" / "ranks"
    t0 = time.perf_counter()
    reports = _run_pod_ranks(out)
    wall = time.perf_counter() - t0
    log(f"phase 10a: {POD_RANKS} rank processes ({POD_BACKEND}): {reports[0]['mesh']}; "
        f"joined in {reports[0]['join_s']:.1f} s, phase 4's corpus loaded in "
        f"{reports[0]['load_s']:.1f} s; {wall:.1f} s for 10a and 10c")
    launches = {}
    for dtype in POD_DTYPES:
        with np.load(_pod_single_path(dtype)) as w:
            want = [((w["q"], w["r"], w["s"]), str(w["mode"]))]
        got = []
        for rank in range(POD_RANKS):
            with np.load(out / f"rank{rank}_{dtype}.npz") as g:
                got.append([((g["q"], g["r"], g["s"]), str(g["mode"]))])
        check(all(np.array_equal(a, b) for a, b in zip(got[0][0][0], got[1][0][0])),
              f"10a {dtype}: the ranks' global_topk differ")
        _same_topk(np, got[0], want, f"10a {dtype}")
        reps = [r[dtype] for r in reports]
        mode = reps[0]["mode"]
        check(mode == SHARD_MODES[POD_RANKS], f"10a {dtype}: ran {mode}")
        two = sharded_launches[f"9a {dtype} 2 shards"]
        for rank, rep in enumerate(reps):
            _check_rank_launches(rep["launches"], {k: v // POD_RANKS for k, v in two.items()},
                                 f"10a {dtype} rank {rank}")
            launches[f"10a {dtype} rank {rank}"] = rep["launches"]
        n = got[0][0][0][2].size
        log(f"phase 10a: {dtype}: == the single device bit for bit ({n} pairs)"
            + f" on both ranks; mode {mode}, shard rows {reps[0]['shard_rows']}; "
            + "; ".join(f"rank {i}: staged {r['stage_s']:.3f} s ({r['staged_bytes']} bytes), "
                        f"search {r['search_s']:.3f} s, steps {json.dumps(r['steps_s'])}, "
                        f"launches {json.dumps(r['launches'])}"
                        for i, r in enumerate(reps)))
    want = SMOKE_DIR / "dns" / "out" / "matches.csv"
    rows = [check_same_rows(out / f"rank{r}_dns_matches.csv", want, f"10c rank {r}")
            for r in range(POD_RANKS)]
    check((out / "rank0_dns_matches.csv").read_bytes()
          == (out / "rank1_dns_matches.csv").read_bytes(), "10c: the ranks' matches differ")
    for rank, rep in enumerate(reports):
        chamfer = rep["dns"]["launches"].get("chamfer", 0)
        check(chamfer > 0, f"10c rank {rank}: chamfer launches {rep['dns']['launches']}")
        launches[f"10c DnS rank {rank}"] = rep["dns"]["launches"]
    log(f"phase 10c: DnSLocalization over the pod (shard rows "
        f"{json.dumps(reports[0]['dns']['shard_rows'])}), {reports[0]['dns']['pairs']} "
        f"pairs: {rows[0]} matches on each rank == dns_baseline's rows (scores within "
        f"{FLOAT_ATOL}), the ranks' CSVs byte for byte; " + "; ".join(
            f"rank {i} {r['dns']['seconds']:.2f} s, launches {json.dumps(r['dns']['launches'])}"
            for i, r in enumerate(reports)))
    return launches


def _follower_launches(log_path: Path) -> dict:
    """The follower's launch counts: its reply to the last relayed
    ``launches`` request, from its log."""
    replies = [ln.split("Follower reply: ok\tlaunches\t", 1)[1]
               for ln in log_path.read_text().splitlines()
               if "Follower reply: ok\tlaunches\t" in ln]
    check(bool(replies), f"10b: the follower logged no launches reply ({log_path})")
    return {k: v for k, v in json.loads(replies[-1]).items() if v}


def phase_pod_serve(np, corpus, serve_launches):
    """10b: the serving pod on phase 6's catalogue at the server's default
    (bf16): rank 0 (the leader, driven by the client) and rank 1 (its
    follower), --sharded over the pod, requests (a)-(g): phase 6b's replies
    and files, byte for byte; each rank launches what phase 6b's server
    launched (one shard a rank)."""
    from vsc2022_torch.utils.procs import die_with_parent

    work, paths, removed = corpus["work"], corpus["paths"], corpus["removed"]
    coord, control = _free_port(), _free_port()
    pod = ["--sharded", "--coordinator", f"localhost:{coord}", "--num_processes",
           str(POD_RANKS), "--control", f"localhost:{control}", "--dist_backend", POD_BACKEND]
    follower_log = work / "server_pod_follower.log"

    def csvs(x):
        return dict(candidates_csv=str(work / f"pod_{x}_c.csv"),
                    matches_csv=str(work / f"pod_{x}_m.csv"))

    t0 = time.perf_counter()
    with open(follower_log, "w") as flog, open(work / "server_pod.log", "w") as llog:
        follower = subprocess.Popen(
            [sys.executable, "-m", "vsc2022_torch.retrieval.serve", "--ref_features",
             paths["refs"], "--score_norm_features", paths["noise"], "--matches",
             "--device", "cuda", *pod, "--process_id", "1"],
            cwd=str(REPO), stdout=flog, stderr=subprocess.STDOUT, preexec_fn=die_with_parent)
        try:
            with spawn_server(paths["refs"], llog, score_norm_features=paths["noise"],
                              matches=True, extra_args=[*pod, "--process_id", "0"]) as client:
                log(f"phase 10b: serving pod ready ({POD_RANKS} ranks, {POD_BACKEND}), "
                    f"{client.n_ref_videos} videos staged in {client.stage_seconds:.1f} s "
                    f"({time.perf_counter() - t0:.1f} s wall)")
                client.launches(reset=True)
                timed("a", lambda: client.search(paths["queries"], **csvs("a")), "10b")
                b = timed("b", lambda: client.search_bytes(
                    Path(paths["queries"]).read_bytes()), "10b")
                check(b.candidates_csv == (work / "bf16_a_c.csv").read_bytes()
                      and b.matches_csv == (work / "bf16_a_m.csv").read_bytes(),
                      "10b: (b) in-band differs from phase 6b's (a)")
                timed("c", lambda: client.search(str(work / "q1.npz"), **csvs("c")), "10b")
                n_add = timed("d", lambda: client.add(str(work / "add.npz")), "10b")
                n_rm = timed("e", lambda: client.remove(removed), "10b")
                n_save = timed("f", lambda: client.save(str(work / "pod_snap.npz")), "10b")
                timed("g", lambda: client.search(paths["queries"], **csvs("g")), "10b")
                stats = client.stats()
                leader = {k: v for k, v in client.launches().items() if v}
            code = follower.wait(timeout=120)  # the leader's quit releases it
            check(code == 0, f"10b: the follower exited with {code}")
        finally:
            if follower.poll() is None:
                follower.kill()
            follower.wait()
    check((n_add, n_rm, n_save) == (SERVE_ADD, (SERVE_REMOVE, SERVE_REMOVE * FRAMES),
                                    SERVE_REF_VIDEOS), f"10b: add/remove/save {n_add} "
          f"{n_rm} {n_save}")
    check(stats.sharded and stats.dtype == "bfloat16", f"10b: stats {stats}")
    for x in ("a", "c", "g"):
        for suffix in ("c", "m"):
            got = (work / f"pod_{x}_{suffix}.csv").read_bytes()
            check(got == (work / f"bf16_{x}_{suffix}.csv").read_bytes()
                  and got.count(b"\n") > 1, f"10b: ({x}) {suffix}.csv differs from 6b's")
    check(same_arrays(np, npz_arrays(np, work / "pod_snap.npz"),
                      npz_arrays(np, work / "bf16_snap.npz")),
          "10b: the snapshot differs from phase 6b's")
    follower = _follower_launches(follower_log)
    want = {k: v for k, v in serve_launches.items() if v}
    for rank, counts in enumerate((leader, follower)):
        _check_rank_launches(counts, want, f"10b rank {rank}")
    log(f"phase 10b: requests (a)-(g) == phase 6b's replies and files, byte for byte; "
        f"stats: sharded {stats.sharded}, {stats.dtype}; launches: leader "
        f"{json.dumps(leader)}, follower {json.dumps(follower)} (6b's server: the same)")
    return {"10b serving pod (bf16) rank 0": leader, "10b serving pod (bf16) rank 1": follower}


def phase_pod_cli(np, extraction):
    """10d: the inference CLI as a two-rank job (--coordinator; each rank
    takes the round-robin shard of phase 8's query videos on this card and
    writes its own npz): the merged shards equal phase 8's one-process
    npz bit for bit."""
    from vsc2022_torch.inference.pipeline import merge_feature_files
    from vsc2022_torch.storage import load_features
    from vsc2022_torch.utils.procs import die_with_parent

    work = SMOKE_DIR / "pod" / "cli"
    work.mkdir(parents=True, exist_ok=True)
    videos, weights = extraction["videos"], extraction["weights"]
    sscd = ["--baseline", "sscd", "--torchscript_path", weights,
            "--transforms", "RESIZE_320_CENTER"]
    port = _free_port()
    shards = [work / f"shard{r}.npz" for r in range(POD_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vsc2022_torch.inference.cli",
         *cli_argv(videos, "queries", shards[r], *sscd), "--coordinator",
         f"localhost:{port}", "--num_processes", str(POD_RANKS), "--process_id", str(r)],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=die_with_parent) for r in range(POD_RANKS)]
    try:
        outs = [p.communicate(timeout=POD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and "Inference succeeded" in text,
              f"10d: rank {r} failed:\n{text[-3000:]}")
    wall = time.perf_counter() - t0
    merged = work / "merged.npz"
    n = merge_feature_files([str(s) for s in shards], str(merged))
    want = {vf.video_id: vf for vf in load_features(str(extraction["q"]))}
    got = {vf.video_id: vf for vf in load_features(str(merged))}
    check(n == len(want) and got.keys() == want.keys(), f"10d: merged {sorted(got)}")
    check(all(np.array_equal(got[v].feature, want[v].feature)
              and np.array_equal(got[v].timestamps, want[v].timestamps) for v in want),
          "10d: the merged shards differ from phase 8's npz")
    split = [len(load_features(str(s))) for s in shards]
    log(f"phase 10d: python -m vsc2022_torch.inference.cli on {POD_RANKS} ranks "
        f"(--coordinator; {split} videos a rank), {wall:.2f} s wall: the merged "
        f"shards == phase 8's npz bit for bit ({n} videos)")


def phase_pod(torch, np, kernels, corpus, extraction, sharded_launches, serve_launches):
    """Phase 10: a pod of two ranks on this card (10a-10d). Returns {label:
    kernel launches} of each rank's run."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"phase 10: a pod of {POD_RANKS} ranks, each a process on cuda:0 "
        f"({torch.cuda.device_count()} card(s)), over {POD_BACKEND}: NCCL refuses two "
        "ranks on one card, so each collective stages through the host")
    launches = phase_pod_search_dns(np, kernels, sharded_launches)
    launches.update(phase_pod_serve(np, corpus, serve_launches))
    phase_pod_cli(np, extraction)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return launches


# ---- phase 11: the IVF pruned tier ----------------------------------------------

# 11b's clustered corpus: unit-norm centres, each with rows at the unit
# vector of the centre plus IVF_SPREAD times a random unit vector, the rows
# shuffled; a focused query video near one centre, and a batch of
# N_QUERY_VIDEOS videos of FRAMES frames near IVF_BATCH_CENTRES centres.
IVF_CENTRES, IVF_PER_CENTRE, IVF_SPREAD = 50, 20_000, 0.35
IVF_FOCUSED, IVF_BATCH_CENTRES = 64, 5
IVF_DTYPES = {"float32": "", "bfloat16": BF16, "int8": INT8}
# The bias column of a score-normalized query, as the localizer reads it:
# bf16-rounded beside a plain searcher, unrounded beside an IVF one (the
# JAX tier's rule). |bias| <= beta |sim| <= 1.2 here, so the rounding moves
# a similarity by at most 2^-9 * 1.2 < 2^-8: tests/test_torch_ivf.py
# (IVF_BIAS_ATOL) holds the matches of serve --ivf to the plain server's
# within it. Over phase 6's catalogue such a move also tips a few weak
# alignments of pairs that are no planted copy across the localizer's
# thresholds (3 of 122 rows on an H100, scores -0.08 to 0.004), so 11c
# holds the rows both servers write within IVF_BIAS_ATOL and requires every
# row one server writes alone to lie off the planted pairs.
IVF_BIAS_ATOL = 2.0 ** -8


def ivf_data(torch, np, dev):
    """11b's corpus [IVF_CENTRES * IVF_PER_CENTRE, DIM], the focused video
    [IVF_FOCUSED, DIM] and the batch [N_QUERY_VIDEOS * FRAMES, DIM], f32 on
    the host, made on the card from a seeded generator."""
    g = torch.Generator(device=dev)
    g.manual_seed(11)

    def unit(x):
        return x / x.norm(dim=1, keepdim=True)

    def near(centres):
        e = unit(torch.randn(centres.shape, generator=g, device=dev))
        return unit(centres + IVF_SPREAD * e)

    centres = unit(torch.randn((IVF_CENTRES, DIM), generator=g, device=dev))
    n = IVF_CENTRES * IVF_PER_CENTRE
    rows = near(centres.repeat_interleave(IVF_PER_CENTRE, 0))
    rows = rows[torch.randperm(n, generator=g, device=dev)].cpu().numpy()
    focused = near(centres[7].expand(IVF_FOCUSED, DIM)).cpu().numpy()
    picked = torch.arange(N_QUERY_VIDEOS, device=dev) % IVF_BATCH_CENTRES * 9 + 3
    batch = near(centres[picked].repeat_interleave(FRAMES, 0)).cpu().numpy()
    return rows, focused, batch


def ivf_listed(torch, kernels, refs, scale, n_valid, ids, col_block):
    """The listed blocks' valid rows and their refs as one corpus (the
    check's copy; the kernels read the staged corpus in place)."""
    rows = kernels.block_rows(ids, col_block, n_valid)
    return rows, refs.index_select(0, rows), None if scale is None else scale[rows]


def ivf_block_records(torch, kernels, searcher, q, ids, path):
    """The block-subset kernels of the searcher's dtype (count_above and
    fused_topk) on staged queries q, the searcher's staged corpus and the
    block list ids: bit for bit the full-corpus kernel on the listed rows
    (ids mapped back), against the plain version with the same list (on
    these floats: counts between the plain counts at tau + tol and tau -
    tol, values within tol, the dtype's tolerance),
    then timed beside the plain version, the library route (gather the
    listed rows, cuBLAS, then the count, or per-segment topk(2) and
    topk(kappa)) and the bound over the listed blocks' valid columns, with
    tau the (K_PER_ROW * m)-th candidate. Returns {key: record}."""
    cb, n_valid, dd = searcher.col_block, searcher.n_refs, searcher.dim
    q_k, _ = searcher._query_operands(q)
    refs, kw = searcher.tensor_core_refs(), searcher._corpus_kw()
    scale = kw.get("scale")
    blocks = {"blocks": ids, "col_block": cb}
    m = q_k.shape[0]
    bf16, int8 = q_k.dtype == torch.bfloat16, refs.dtype == torch.int8
    sfx = BF16 if bf16 else INT8 if int8 else ""
    tol = BF16_TC_ATOL if bf16 or int8 else FLOAT_ATOL
    kappa = 32
    count = lambda: kernels.count_above(q_k, refs, tau, n_valid, **kw, **blocks)  # noqa: E731
    topk = lambda: kernels.fused_topk(q_k, refs, n_valid, kappa, **kw, **blocks)  # noqa: E731
    gv, gi = topk()
    tau = float(torch.topk(gv.reshape(-1), K_PER_ROW * m).values[-1])
    got = count()
    rows, sub, sub_scale = ivf_listed(torch, kernels, refs, scale, n_valid, ids, cb)
    sub_kw = {} if scale is None else {"scale": sub_scale}
    fv, fi = kernels.fused_topk(q_k, sub, rows.numel(), kappa, **sub_kw)
    mapped = torch.where(torch.isfinite(fv), rows[fi.long()], 0).int()
    check(torch.equal(gv.view(torch.int32), fv.view(torch.int32)) and torch.equal(gi, mapped)
          and torch.equal(got, kernels.count_above(q_k, sub, tau, rows.numel(), **sub_kw)),
          f"11a: fused_topk{sfx}{BLOCKS} or count_above{sfx}{BLOCKS} != the full-corpus "
          "kernel on the listed rows")
    del sub, fv, fi, mapped
    torch.cuda.empty_cache()
    # Floats: an entry within tol of tau may count on one side only, so the
    # count lies between the plain counts at tau + tol and tau - tol.
    counts = {t: kernels.count_above_plain(q_k, refs, t, n_valid, **kw, **blocks)
              for t in (tau + tol, tau, tau - tol)}
    count_err = float((got - counts[tau]).abs().max())
    check(bool(((counts[tau + tol] <= got) & (got <= counts[tau - tol])).all()),
          f"11a: count_above{sfx}{BLOCKS}: counts outside the plain counts at tau "
          f"+- {tol} (off by {count_err} at tau)")
    del counts
    wv, _ = kernels.fused_topk_plain(q_k, refs, n_valid, kappa, **kw, **blocks)
    finite = torch.isfinite(wv)
    check(torch.equal(finite, torch.isfinite(gv)),
          f"11a: fused_topk{sfx}{BLOCKS}: -inf slots differ from the plain version")
    topk_err = float((gv[finite] - wv[finite]).abs().max()) if finite.any() else 0.0
    check(topk_err <= tol, f"11a: fused_topk{sfx}{BLOCKS}: values off the plain "
          f"version's by {topk_err} > {tol}")
    del gv, gi, wv, finite
    torch.cuda.empty_cache()
    lq, cols = q_k[:, :dd], int(rows.numel())

    def listed():
        return refs.index_select(0, rows)

    records = {}
    for name, call, plain, lib, out_bytes, err in (
        ("count_above", count,
         lambda: kernels.count_above_plain(q_k, refs, tau, n_valid, **kw, **blocks),
         lambda: count_above_library(torch, lq, listed(), tau, cols, sub_scale),
         4 * m, count_err),
        ("fused_topk", topk,
         lambda: kernels.fused_topk_plain(q_k, refs, n_valid, kappa, **kw, **blocks),
         lambda: topk_library(torch, lq, listed(), cols, kappa, sub_scale),
         8 * m * kappa, topk_err),
    ):
        kernel_ms = cuda_ms(torch, call, 3)
        plain_ms = cuda_ms(torch, plain, 1)
        library_ms = cuda_ms(torch, lib, 1)
        torch.cuda.empty_cache()
        bound_ms, bound_by = bound(m, cols, cols, dd, out_bytes, bf16=bf16, int8=int8)
        key = name + sfx + BLOCKS
        records[key] = {
            "shape": [m, cols, dd] + ([kappa] if name == "fused_topk" else []),
            "blocks": int(ids.numel()), "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        log(f"phase 11a: {key} on {path} [{m} x {cols} listed columns ({ids.numel()} "
            f"blocks of {cb}) x {dd}] kernel_ms={kernel_ms:.3f} plain_ms={plain_ms:.3f} "
            f"library_ms={library_ms:.3f} bound_ms={bound_ms:.3f} ({bound_by}) "
            f"max_abs_err={err}")
    return records


def ivf_small(torch, kernels, dev):
    """11a at small shapes: six blocks of 512 rows (the last partial), every
    dtype, integer rows: each subset kernel equals the full-corpus kernel
    on the listed rows bit for bit and its plain version exactly; an empty
    list counts 0 and gives -inf sets."""
    n, d, n_valid, cb = 6 * 512, 64, 2900, 512
    for dtype, sfx in IVF_DTYPES.items():
        if dtype == "int8":
            refs, scale = int8_rows(torch, "int", n, d, 41, dev)
            q, kw = int8_int_queries(torch, 300, d, 42, dev), {"scale": scale}
        else:
            q, refs = make_inputs(torch, "int", 300, n, d, seed=43, dev=dev)
            if dtype == "bfloat16":
                q, refs = q.to(torch.bfloat16), refs.to(torch.bfloat16)
            scale, kw = None, {}
        for listed in ([0], [5], [0, 2, 5], [1, 2, 3, 4, 5], []):
            ids = torch.tensor(listed, dtype=torch.int32, device=dev)
            blocks = {"blocks": ids, "col_block": cb}
            rows, sub, sub_scale = ivf_listed(torch, kernels, refs, scale, n_valid, ids, cb)
            sub_kw = {} if scale is None else {"scale": sub_scale}
            for tau in (6.0, float("-inf")):
                got = kernels.count_above(q, refs, tau, n_valid, **kw, **blocks)
                check(torch.equal(got, kernels.count_above_plain(
                    q, refs, tau, n_valid, **kw, **blocks)),
                    f"11a: count_above{sfx}{BLOCKS} {listed} != its plain version")
                if listed:
                    check(torch.equal(got, kernels.count_above(q, sub, tau, rows.numel(),
                                                               **sub_kw)),
                          f"11a: count_above{sfx}{BLOCKS} {listed} != the full kernel")
            gv, gi = kernels.fused_topk(q, refs, n_valid, 32, **kw, **blocks)
            wv, wi = kernels.fused_topk_plain(q, refs, n_valid, 32, **kw, **blocks)
            check(torch.equal(gv, wv) and torch.equal(gi, wi),
                  f"11a: fused_topk{sfx}{BLOCKS} {listed} != its plain version")
            if listed:
                fv, fi = kernels.fused_topk(q, sub, rows.numel(), 32, **sub_kw)
                check(torch.equal(gv, fv) and torch.equal(
                    gi, torch.where(torch.isfinite(fv), rows[fi.long()], 0).int()),
                    f"11a: fused_topk{sfx}{BLOCKS} {listed} != the full kernel")
            else:
                check(bool(torch.isneginf(gv).all()), "11a: an empty list's sets")
    log("phase 11a: count_above and fused_topk .blocks (f32, bf16, int8) at small shapes "
        "[300 x 6 blocks of 512 x 64]: == the full-corpus kernels on the listed rows bit "
        "for bit, == their plain versions exactly (integers); empty lists give 0 and -inf")


def phase_ivf(torch, np, kernels, dev, corpus):
    """Phase 11: the IVF pruned tier on the card. 11a: the block-subset
    kernels at small shapes, then on the batch's probed blocks of 11b's
    corpus (records). 11b: IVFSimilaritySearcher over a clustered corpus of
    1,000,000 rows at D = 512 in f32, bf16 and int8 against the plain
    SimilaritySearcher: the focused video (pruned in every dtype) and the
    batch, exactly equal; stats, build seconds (k-means, the rest of the
    stage), both arms' search seconds and the launches logged. 11c: serve
    --ivf 0 --score_norm_features --matches at its bf16 default on phase
    6's catalogue, requests (a), (d), (e), (g): candidates.csv byte for
    byte with 6b's, the matches' rows both write within IVF_BIAS_ATOL, the
    rows one writes alone off the planted pairs. Returns the records and
    11b's launches of the subset kernels."""
    from vsc2022_torch.ops import ivf
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    t_phase = time.perf_counter()
    ivf_small(torch, kernels, dev)
    t0 = time.perf_counter()
    rows, focused, batch = ivf_data(torch, np, dev)
    log(f"phase 11b: corpus {rows.shape[0]} x {DIM} ({IVF_CENTRES} centres x "
        f"{IVF_PER_CENTRE} rows, spread {IVF_SPREAD}), focused video {IVF_FOCUSED} "
        f"frames, batch {batch.shape[0]} frames from {IVF_BATCH_CENTRES} centres; made in "
        f"{time.perf_counter() - t0:.1f} s")
    kmeans_seconds = []
    original = ivf.kmeans_assign

    def timed_kmeans(*a, **k):
        t = time.perf_counter()
        out = original(*a, **k)
        kmeans_seconds.append(time.perf_counter() - t)
        return out

    records, launches = {}, {}
    ivf.kmeans_assign = timed_kmeans
    try:
        for dtype, sfx in IVF_DTYPES.items():
            t0 = time.perf_counter()
            searcher = ivf.IVFSimilaritySearcher(rows, dtype=dtype, device=dev)
            torch.cuda.synchronize()
            build = time.perf_counter() - t0
            plain = SimilaritySearcher(rows, dtype=dtype, device=dev)
            counts = {k: 0 for k in kernels.BLOCK_KERNELS}
            for label, q, k in (("focused", focused, 1200),
                                ("batch", batch, 1200 * N_QUERY_VIDEOS)):
                kernels.reset_launches()
                t0 = time.perf_counter()
                got = searcher.global_topk(q, k)
                t_ivf = time.perf_counter() - t0
                run = dict(kernels.launches)
                stats = dict(searcher.last_search_stats or {})
                t0 = time.perf_counter()
                want = plain.global_topk(q, k)
                t_plain = time.perf_counter() - t0
                check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                      f"11b {dtype} {label}: IVF != the plain searcher")
                for key in counts:
                    counts[key] += run.get(key, 0)
                if label == "focused":
                    check(stats.get("pruned") is True, f"11b {dtype}: the focused "
                          f"video did not prune: {stats}")
                    check(run[f"fused_topk{sfx}{BLOCKS}"] == 1
                          and run[f"count_above{sfx}{BLOCKS}"] == 1
                          and run[f"fused_topk{sfx}"] == 0,
                          f"11b {dtype}: the focused search's launches {run}")
                log(f"phase 11b: {dtype} {label} [{q.shape[0]} x {rows.shape[0]}] k={k}: "
                    f"IVF == plain exactly; stats {json.dumps(stats)}; IVF "
                    f"{t_ivf:.3f} s ({searcher.last_stats['mode']}), plain {t_plain:.3f} s "
                    f"({plain.last_stats['mode']}); launches "
                    f"{json.dumps({k: v for k, v in run.items() if v})}")
            log(f"phase 11b: {dtype} IVFSimilaritySearcher built in {build:.2f} s "
                f"(k-means {kmeans_seconds[-1]:.2f} s, nlist {searcher.nlist}, "
                f"col_block {searcher.col_block}, the rest of the stage "
                f"{build - kmeans_seconds[-1]:.2f} s)")
            for name in ("count_above", "fused_topk"):
                launches[name + sfx + BLOCKS] = counts[name + sfx + BLOCKS]
            # 11a on the main path's shape: the batch's probed blocks.
            q = searcher._stage_queries(batch)
            n_blocks = searcher._refs.shape[0] // searcher.col_block
            mask, _ = searcher._probe(q, n_blocks)
            ids = torch.from_numpy(np.nonzero(mask)[0].astype(np.int32)).to(dev)
            records.update(ivf_block_records(torch, kernels, searcher, q, ids,
                                             f"11b's batch, {dtype}"))
            del searcher, plain, q
            torch.cuda.empty_cache()
    finally:
        ivf.kmeans_assign = original
    del rows
    ivf_serve(corpus)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return records, launches


def ivf_serve(corpus):
    """11c: serve --ivf 0 (the default nlist) --score_norm_features
    --matches at its bf16 default on phase 6's catalogue, requests (a),
    (d), (e), (g), against phase 6b's files (IVF_BIAS_ATOL)."""
    from vsc2022_torch.metrics import Match

    work, paths, removed = corpus["work"], corpus["paths"], corpus["removed"]
    csv = {x: (str(work / f"ivf_{x}_c.csv"), str(work / f"ivf_{x}_m.csv")) for x in "ag"}
    with open(work / "server_ivf.log", "w") as server_log:
        t0 = time.perf_counter()
        with spawn_server(paths["refs"], server_log, score_norm_features=paths["noise"],
                          matches=True, extra_args=["--ivf", "0"]) as client:
            log(f"phase 11c: serve --ivf 0 ready, {client.n_ref_videos} videos staged "
                f"in {client.stage_seconds:.1f} s ({time.perf_counter() - t0:.1f} s wall)")
            client.launches(reset=True)
            timed("a", lambda: client.search(paths["queries"], candidates_csv=csv["a"][0],
                                             matches_csv=csv["a"][1]), "11c")
            n_add = timed("d", lambda: client.add(str(work / "add.npz")), "11c")
            n_rm = timed("e", lambda: client.remove(removed), "11c")
            timed("g", lambda: client.search(paths["queries"], candidates_csv=csv["g"][0],
                                             matches_csv=csv["g"][1]), "11c")
            stats, counts = client.stats(), client.launches()
            probe_refused(client, paths["queries"], "11c (serve --ivf)")
    check((n_add, n_rm) == (SERVE_ADD, (SERVE_REMOVE, SERVE_REMOVE * FRAMES))
          and stats.dtype == "bfloat16", f"11c: add {n_add}, remove {n_rm}, {stats}")
    planted = {(m.query_id, m.ref_id) for m in Match.read_csv(paths["gt"], is_gt=True)}
    report = []
    for x in "ag":
        got, want = Path(csv[x][0]).read_bytes(), (work / f"bf16_{x}_c.csv").read_bytes()
        check(got == want and got.count(b"\n") > 1,
              f"11c: ({x}) candidates.csv differs from phase 6b's")
        ivf_rows, plain_rows = match_rows(csv[x][1]), match_rows(work / f"bf16_{x}_m.csv")
        shared = ivf_rows.keys() & plain_rows.keys()
        err = max(abs(ivf_rows[k] - plain_rows[k]) for k in shared)
        check(err <= IVF_BIAS_ATOL, f"11c ({x}) matches: scores differ by {err}")
        alone = {k: v for rows, other in ((ivf_rows, plain_rows), (plain_rows, ivf_rows))
                 for k, v in rows.items() if k not in other}
        copies = [v for k, v in plain_rows.items() if k[:2] in planted]
        check(copies and all(k[:2] not in planted for k in alone),
              f"11c ({x}) matches: rows of planted pairs one server writes alone {alone}")
        report.append(f"({x}) {len(shared)} rows within {err:.3g}, {len(alone)} alone, "
                      f"off the planted pairs (scores "
                      f"{sorted(round(v, 4) for v in alone.values())}; the planted "
                      f"pairs' rows score {min(copies):.4f} to {max(copies):.4f})")
    log(f"phase 11c: (a), (d), (e), (g): candidates.csv == phase 6b's byte for byte; "
        f"matches against 6b's: {'; '.join(report)}; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")


# ---- phase 12: training ----------------------------------------------------------

# 12a and 12d hold a small SSCD (a one-block-a-stage trunk, 16-128 wide,
# 64-d descriptors) at batch 32 of 64 x 64 views. The gradient of a
# network trained through BatchNorm's batch statistics is ill-conditioned
# in float32 (a bias's gradient is the small rest of sums that nearly
# cancel): the card's float32 gradients lie 1.2e-3 off a float64 step in
# norm and up to 2.2e-2 of one tensor's largest value, with cuDNN or
# without; a CPU's float32 ones 6.1e-6 to 4.6e-4 in norm. So the step is
# held in float64 from the same views (the same function: within
# TRAIN_F64_TOL), and the card's float32 step against the float64 one
# within float32's reach (TRAIN_LOSS_RTOL, TRAIN_STATS_ATOL,
# TRAIN_GRAD_NORM_TOL).
TRAIN_SMALL = dict(stage_sizes=(1, 1, 1, 1), stage_features=(16, 32, 64, 128), dims=64)
TRAIN_CHECK_BATCH = 32
TRAIN_CHECK_HW = 64
TRAIN_VIEW_ATOL = 4e-6  # the views on the card against the CPU's (the CPU tests' limit)
TRAIN_F64_TOL = 1e-9  # float64 steps: loss (relative), gradients (of their largest), statistics
TRAIN_LOSS_RTOL = 1e-5  # float32 against float64
TRAIN_STATS_ATOL = 1e-4
TRAIN_GRAD_NORM_TOL = 1e-2  # float32 gradients against float64, in norm
TRAIN_GRAD_TOL = 1e-3  # distillation (well conditioned): of each tensor's largest gradient
TRAIN_DESC_TOL = 1e-5  # of the largest descriptor value
TRAIN_RANKS = 2
TRAIN_RANK_TIMEOUT = 300  # seconds a rank process may take
# 12b: the CLI at full width (ResNet-50, 224 x 224, batch 64).
TRAIN_CLI_ARGS = ("--synthetic", "256", "--steps", "10", "--batch_size", "64",
                  "--image_size", "224", "--log_every", "1")
# 12c: each student at full width (9 x 3840 → 512), 64 pairs of 4 frames.
DISTILL_STUDENTS = (("fg", "att"), ("fg", "bin"), ("cg", "att"))
DISTILL_STEPS = 12
DISTILL_RANK_PAIRS = 8  # 12d's batch, split over the ranks


def train_frames(np):
    """12a / 12d's uint8 frames: 32 of 80 x 96 (seed 12)."""
    rng = np.random.RandomState(12)
    return (rng.rand(TRAIN_CHECK_BATCH, 80, 96, 3) * 255).astype(np.uint8)


def small_views(torch, frames, device, rows=None):
    """12a / 12d's two views (seed 13's draws of the whole batch) of
    ``rows`` of ``frames`` (a rank's slice; all by default), made on
    ``device``."""
    from vsc2022_torch.train.augment import augment, draw_views

    b, h, w, _ = frames.shape
    g = torch.Generator().manual_seed(13)
    draws = [draw_views(g, b, h, w) for _ in range(2)]
    lo, hi = rows or (0, b)
    x = torch.from_numpy(frames[lo:hi]).to(device)
    return {k: augment(x, d.rows(lo, hi), TRAIN_CHECK_HW)
            for k, d in zip(("view_a", "view_b"), draws)}


def small_sscd_step(torch, np, frames, device, mesh=None, rows=None, dtype=None,
                    views_on=None):
    """One step of the small SSCD (seed 12, AdamW lr 1e-4) on ``device``, in
    ``dtype`` (float32 by default), on ``small_views`` made on ``views_on``
    (``device`` by default). Returns the loss, every gradient and the
    running statistics, as numpy."""
    from vsc2022_torch.models.sscd import SSCDModel
    from vsc2022_torch.train import create_train_state, make_train_step

    dtype = dtype or torch.float32
    model = SSCDModel(**TRAIN_SMALL)
    state = create_train_state(model, 1e-4, 1e-2, seed=12, device=device)
    model.to(dtype)
    views = small_views(torch, frames, views_on or device, rows)
    state, loss = make_train_step(model, mesh)(
        state, {k: v.to(device, dtype) for k, v in views.items()})
    return {"loss": float(loss),
            **{"grad/" + n: p.grad.cpu().numpy() for n, p in model.named_parameters()},
            **{"buf/" + n: b.cpu().numpy() for n, b in model.named_buffers()
               if "running" in n}}


def distill_rank_batch(np):
    """12d's distillation batch: 8 pairs of 3 frames (seed 21)."""
    rng = np.random.RandomState(21)
    q = rng.randn(DISTILL_RANK_PAIRS, 3, 9, 3840).astype(np.float32)
    r = rng.randn(DISTILL_RANK_PAIRS, 3, 9, 3840).astype(np.float32)
    return {"q_regions": q, "r_regions": r,
            "teacher_sim": rng.rand(DISTILL_RANK_PAIRS).astype(np.float32)}


def distill_step_grads(torch, np, student, fg_type, device, mesh=None, rows=None):
    """One distillation step (seed 5, Adam lr 1e-3) on ``rows`` of 12d's
    batch: the loss and every gradient, as numpy."""
    from vsc2022_torch.train import dns_distill

    batch = distill_rank_batch(np)
    lo, hi = rows or (0, DISTILL_RANK_PAIRS)
    module = dns_distill.build_student_module(student, fg_type)
    state = dns_distill.create_distill_state(module, 1e-3, seed=5, device=device)
    qw = 0.1 if (student, fg_type) == ("fg", "bin") else 0.0
    state, loss = dns_distill.make_distill_step(module, student, qw, mesh=mesh)(
        state, {k: v[lo:hi] for k, v in batch.items()})
    return {"loss": float(loss),
            **{"grad/" + n: p.grad.cpu().numpy() for n, p in module.named_parameters()}}


def compare_steps(np, got, want, what, loss_rtol, stats_atol, grad_tol=None,
                  grad_norm_tol=None):
    """``got`` against ``want`` (small_sscd_step / distill_step_grads
    results): the loss within ``loss_rtol``, the running statistics within
    ``stats_atol``, each gradient within ``grad_tol`` of its largest value
    and all of them within ``grad_norm_tol`` in norm, where given. Returns
    the errors read."""
    check(got.keys() == want.keys(), f"{what}: other tensors {sorted(got)[:4]}")
    grads = [k for k in want if k.startswith("grad/")]
    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum()) for k in grads)
    den = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in grads)
    each = {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
            for k in grads}
    worst = max(each, key=each.get)
    errs = {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "stats_abs": max([float(np.abs(got[k] - want[k]).max())
                              for k in want if k.startswith("buf/")] or [0.0]),
            "grad_norm_rel": (num / den) ** 0.5, "grad_max_rel": each[worst],
            "grad_worst": worst}
    check(np.isfinite(got["loss"]) and errs["loss_rel"] <= loss_rtol,
          f"{what}: loss {got['loss']} against {want['loss']}")
    check(errs["stats_abs"] <= stats_atol,
          f"{what}: running statistics {errs['stats_abs']:.3g} off")
    check(grad_tol is None or each[worst] <= grad_tol,
          f"{what}: {worst} lies {each[worst]:.3g} of its largest value off")
    check(grad_norm_tol is None or errs["grad_norm_rel"] <= grad_norm_tol,
          f"{what}: the gradients lie {errs['grad_norm_rel']:.3g} off in norm")
    return errs


def train_step_vs_cpu(torch, np, dev):
    """12a: the small SSCD step on the card against the CPU's: the views
    (TRAIN_VIEW_ATOL), the float64 step from the CPU's views (TRAIN_F64_TOL)
    and the card's float32 step from its own views against the float64
    one (float32's limits). Returns the CPU's float64 step (12d's
    reference)."""
    frames = train_frames(np)
    card_views = small_views(torch, frames, dev)
    cpu_views = small_views(torch, frames, "cpu")
    view_err = max(float((card_views[k].cpu() - cpu_views[k]).abs().max()) for k in cpu_views)
    check(view_err <= TRAIN_VIEW_ATOL, f"12a: the views lie {view_err:.3g} off the CPU's")
    f64 = torch.float64
    ref64 = small_sscd_step(torch, np, frames, "cpu", dtype=f64)
    t0 = time.perf_counter()
    card64 = small_sscd_step(torch, np, frames, dev, dtype=f64, views_on="cpu")
    seconds = time.perf_counter() - t0
    e64 = compare_steps(np, card64, ref64, "12a: the float64 step on the card against the "
                        "CPU's", TRAIN_F64_TOL, TRAIN_F64_TOL, grad_tol=TRAIN_F64_TOL)
    e32 = compare_steps(np, small_sscd_step(torch, np, frames, dev), ref64,
                        "12a: the card's float32 step against the CPU's float64 step",
                        TRAIN_LOSS_RTOL, TRAIN_STATS_ATOL, grad_norm_tol=TRAIN_GRAD_NORM_TOL)
    e_cpu = compare_steps(np, small_sscd_step(torch, np, frames, "cpu"), ref64,
                          "12a: the CPU's float32 step against its float64 step",
                          TRAIN_LOSS_RTOL, TRAIN_STATS_ATOL, grad_norm_tol=TRAIN_GRAD_NORM_TOL)
    log(f"phase 12a: one SSCD step (trunk {TRAIN_SMALL['stage_features']}, batch "
        f"{TRAIN_CHECK_BATCH}, {TRAIN_CHECK_HW} x {TRAIN_CHECK_HW}): the views on the card "
        f"within {view_err:.3g} of the CPU's (limit {TRAIN_VIEW_ATOL}); float64 on the card "
        f"({seconds:.2f} s with its first cuDNN plans) against the CPU from the same views: "
        + json.dumps(e64) + f" (limit {TRAIN_F64_TOL}); the card's float32 step against the "
        "CPU's float64 one: " + json.dumps(e32) + f" (limits: loss {TRAIN_LOSS_RTOL}, "
        f"statistics {TRAIN_STATS_ATOL}, gradients {TRAIN_GRAD_NORM_TOL} in norm); the CPU's "
        "float32 step against it: " + json.dumps(e_cpu))
    return ref64


def train_cli(torch, np, dev, work: Path):
    """12b: python -m vsc2022_torch.train.cli's main in process at full width
    on the card: every loss finite, frames/s and peak memory on their own
    lines; its checkpoint through the inference CLI's --checkpoint_path
    into the extractor, whose descriptors equal the trained model's eval
    forward."""
    from vsc2022_torch.inference import cli as inference_cli
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import InferenceTransforms
    from vsc2022_torch.train import cli

    ckpt = str(work / "sscd.npz")
    torch.cuda.empty_cache()
    out = cli.main(cli.parser.parse_args([*TRAIN_CLI_ARGS, "--checkpoint_out", ckpt,
                                          "--device", str(dev)]))
    losses = out["losses"]
    steps = int(TRAIN_CLI_ARGS[TRAIN_CLI_ARGS.index("--steps") + 1])
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"12b: the CLI's losses {losses}")
    log(f"phase 12b: train.cli {' '.join(TRAIN_CLI_ARGS)}: losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; {out['seconds']:.2f} s")
    log(f"phase 12b: SSCD training (ResNet-50, 224 x 224, batch 64, f32): "
        f"{out['steady_frames_per_s']:.1f} frames/s over steps 2-{steps} "
        f"({out['frames_per_s']:.1f} with the first)")
    log(f"phase 12b: SSCD training device peak {out['peak_mib']:.0f} MiB")
    args = inference_cli.parser.parse_args([
        "--baseline", "sscd", "--checkpoint_path", ckpt, "--dataset_path", "-",
        "--output_file", "-", "--device", str(dev)])
    rng = np.random.RandomState(14)
    frames = torch.from_numpy((rng.rand(16, 360, 640, 3) * 255).astype(np.uint8)).to(dev)
    transform = InferenceTransforms[args.transforms]
    got = DescriptorExtractor(inference_cli.build_model(args), transform,
                              device=dev).forward(frames).cpu().numpy()
    want = DescriptorExtractor(out["state"].model, transform,
                               device=dev).forward(frames).cpu().numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    check(np.isfinite(got).all() and err <= TRAIN_DESC_TOL,
          f"12b: the checkpoint's descriptors lie {err:.3g} off the trained model's")
    log(f"phase 12b: the checkpoint through --checkpoint_path into the extractor: 16 "
        f"frames' descriptors within {err:.3g} of the trained model's eval forward "
        f"(limit {TRAIN_DESC_TOL})")
    return {"frames_per_s": out["steady_frames_per_s"], "peak_mib": out["peak_mib"]}


def distill_students(torch, np, dev, work: Path):
    """12c: each student at full width: the CLI's main in process (64
    synthetic pairs of 4 frames, batch 64, 12 steps: losses finite, pairs/s
    and peak memory), the loss falling on its first batch held fixed (12
    steps from seed 0, lr 3e-3: the last under 0.75 of the larger of the
    first two, as the JAX package's test), and its checkpoint through
    dns_index's --checkpoint_path into a DnSStudent on the card, equal to
    the trained module's forward."""
    from vsc2022_torch.baseline import dns_index
    from vsc2022_torch.train import cli, dns_distill

    rates = {}
    for student, fg_type in DISTILL_STUDENTS:
        name = student if student == "cg" else f"fg_{fg_type}"
        ckpt = str(work / f"{name}.npz")
        argv = ["--objective", "dns_distill", "--student", student, "--fg_type", fg_type,
                "--synthetic", "64", "--batch_size", "64", "--steps", str(DISTILL_STEPS),
                "--log_every", str(DISTILL_STEPS), "--checkpoint_out", ckpt,
                "--device", str(dev)]
        args = cli.parser.parse_args(argv)
        out = cli.main(args)
        check(all(math.isfinite(x) for x in out["losses"]), f"12c {name}: {out['losses']}")
        module = dns_distill.build_student_module(student, fg_type)
        state = dns_distill.create_distill_state(module, 3e-3, seed=0, device=dev)
        step = dns_distill.make_distill_step(module, student,
                                             0.1 if name == "fg_bin" else 0.0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 next(cli.distill_batches(args)).items()}
        sync(torch, dev)
        t0 = time.perf_counter()
        fixed = [step(state, batch)[1] for _ in range(DISTILL_STEPS)]
        fixed = [float(x) for x in fixed]
        resident = DISTILL_STEPS * args.batch_size / (time.perf_counter() - t0)
        check(fixed[-1] < 0.75 * max(fixed[:2]), f"12c {name}: the loss did not fall {fixed}")
        ix = dns_index.parser.parse_args([
            "--query_features", "-", "--ref_features", "-", "--output_path", "-",
            "--student", student, "--fg_type", fg_type, "--checkpoint_path", ckpt,
            "--device", str(dev)])
        regions = batch["q_regions"][0]  # [4, 9, 3840]
        got = dns_index._build_student(ix, dev).index_video(
            regions.reshape(4, -1).cpu().numpy())
        trained = out["state"].module.eval()
        with torch.no_grad():
            want = trained(regions).reshape(4, -1).cpu().numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        check(err <= TRAIN_DESC_TOL, f"12c {name}: the checkpoint's codes lie {err:.3g} off")
        rates[name] = {"pairs_per_s": out["steady_pairs_per_s"], "peak_mib": out["peak_mib"],
                       "resident_pairs_per_s": resident}
        log(f"phase 12c: {name} at full width (64 pairs of 4 x 9 x 3840, batch 64): CLI "
            f"losses {out['losses'][0]:.4f} → {out['losses'][-1]:.4f}; on a fixed batch "
            + " ".join(f"{x:.4f}" for x in fixed) + f"; the checkpoint through dns_index "
            f"--checkpoint_path within {err:.3g} of the trained module")
        log(f"phase 12c: {name} distillation {out['steady_pairs_per_s']:.1f} pairs/s over "
            f"steps 2-{DISTILL_STEPS} (the CLI: batches gathered on the host and copied in); "
            f"{resident:.1f} pairs/s on a batch already on the card; device peak "
            f"{out['peak_mib']:.0f} MiB")
    return rates


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_rank_main(rank: int, port: int, out: Path, device: str = "cuda") -> int:
    """One rank of 12d, run as ``chip_smoke.py --train-rank R --train-port
    P --train-dir D``: joins a gloo group of TRAIN_RANKS on this card and
    takes its slice of 12a's SSCD step and of 12d's distillation steps
    over ``train_mesh``; writes its results under ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from vsc2022_torch.parallel import initialize_distributed, shutdown_distributed
    from vsc2022_torch.parallel.mesh import train_mesh

    dev = initialize_distributed(f"localhost:{port}", TRAIN_RANKS, rank, backend="gloo",
                                 device=device)
    try:
        mesh = train_mesh(device=dev)
        b = TRAIN_CHECK_BATCH // TRAIN_RANKS
        np.savez(out / f"sscd{rank}.npz", **small_sscd_step(
            torch, np, train_frames(np), dev, mesh, rows=(rank * b, (rank + 1) * b),
            dtype=torch.float64, views_on="cpu"))
        p = DISTILL_RANK_PAIRS // TRAIN_RANKS
        for student, fg_type in (("fg", "bin"), ("cg", "att")):
            np.savez(out / f"{student}{rank}.npz", **distill_step_grads(
                torch, np, student, fg_type, dev, mesh, rows=(rank * p, (rank + 1) * p)))
    finally:
        shutdown_distributed()
    return 0


def train_ranks(torch, np, dev, ref64, work: Path):
    """12d: TRAIN_RANKS gloo ranks on this card (one process each, as phase
    10's pod) against one process: both ranks bit for bit alike; the SSCD
    step in float64 (12a's views from the CPU, half a rank) against 12a's
    float64 step within TRAIN_F64_TOL; the distillation steps (float32)
    against one card's, the gradients within TRAIN_GRAD_TOL of their
    largest value."""
    from vsc2022_torch.utils.procs import die_with_parent

    out = work / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    t0 = time.perf_counter()
    procs, logs = [], []
    for rank in range(TRAIN_RANKS):
        logs.append(open(out / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--train-rank", str(rank),
             "--train-port", str(port), "--train-dir", str(out)],
            cwd=str(REPO), stdout=logs[-1], stderr=subprocess.STDOUT,
            preexec_fn=die_with_parent))
    try:
        deadline = time.monotonic() + TRAIN_RANK_TIMEOUT
        for rank, p in enumerate(procs):
            try:
                code = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = "timed out"
            if code != 0:
                tail = (out / f"rank{rank}.log").read_text()[-3000:]
                raise PhaseError(f"phase 12d: training rank {rank} failed ({code}):\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    single = {"sscd": ref64}
    for student, fg_type in (("fg", "bin"), ("cg", "att")):
        single[student] = distill_step_grads(torch, np, student, fg_type, dev)
    errs = {}
    for name, want in single.items():
        ranks = [dict(np.load(out / f"{name}{r}.npz")) for r in range(TRAIN_RANKS)]
        for k in ranks[0]:
            check(np.array_equal(ranks[0][k], ranks[1][k]), f"12d {name}: ranks differ on {k}")
        got = dict(ranks[0], loss=float(ranks[0]["loss"]))
        if name == "sscd":
            errs[name] = compare_steps(np, got, want, "12d sscd: two ranks (float64) against "
                                       "one process", TRAIN_F64_TOL, TRAIN_F64_TOL,
                                       grad_tol=TRAIN_F64_TOL)
        else:
            errs[name] = compare_steps(np, got, want, f"12d {name}: two ranks against one "
                                       "card", TRAIN_LOSS_RTOL, 0.0, grad_tol=TRAIN_GRAD_TOL)
    log(f"phase 12d: {TRAIN_RANKS} gloo ranks on this card ({seconds:.1f} s with their "
        "start): the SSCD step (float64) and the fg bin / cg distillation steps equal on "
        "both ranks bit for bit; against one process: " + json.dumps(errs))


def phase_train(torch, np, kernels, dev):
    """Phase 12: training on the card (12a-12d). The kernels' launch counts
    are zeroed first and read last: training runs none of them. Returns
    the counts and the figures."""
    work = SMOKE_DIR / "train"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    kernels.reset_launches()
    ref64 = train_step_vs_cpu(torch, np, dev)
    figures = {"sscd": train_cli(torch, np, dev, work)}
    figures.update(distill_students(torch, np, dev, work))
    train_ranks(torch, np, dev, ref64, work)
    launches = dict(kernels.launches)
    check(not any(launches.values()),
          f"12: training launched retrieval kernels: {({k: v for k, v in launches.items() if v})}")
    log(f"phase 12: training took {time.perf_counter() - t0:.1f} s; no hand kernel "
        "launched (the training path is plain PyTorch: JAX trains with XLA alone)")
    return launches, figures


# ---- phase 13: the last entry points and the space-to-depth stem ------------------

# The s2d stem's SSCD descriptors against the standard stem's on the card
# (f32, the same weights and frames: the same products summed in another
# order), as a share of the descriptors' largest magnitude; and the frames
# it runs over (phase 8's pre-decoded 640x360 frames).
S2D_REL_TOL = 1e-5
S2D_FRAMES = 256


def launched_since(before, after):
    """{kernel: launches} a server made between two of its launch counts."""
    return {k: after[k] - before.get(k, 0) for k in after if after[k] > before.get(k, 0)}


def probe_request(client, queries, request_wall, search_launches, phase):
    """13d: ``probe`` of the query file after a --matches search of it:
    0 < search_s < that request's wall seconds, tn_s > 0, and the probe's
    searches launch the search's kernels (each one warm-up and 3 timed
    searches). Returns the figures and the probe's launches."""
    before = client.launches()
    t0 = time.perf_counter()
    search_s, tn_s = client.probe(queries)
    wall = time.perf_counter() - t0
    counts = launched_since(before, client.launches())
    check(0 < search_s < request_wall,
          f"13d ({phase}): probe search_s {search_s} not in (0, {request_wall})")
    check(tn_s > 0, f"13d ({phase}): probe tn_s {tn_s}")
    check(set(counts) == set(search_launches),
          f"13d ({phase}): probe launched {counts}, the search {search_launches}")
    log(f"phase 13d ({phase}'s server): probe search_s {search_s:.6f} s (device time of "
        f"the kernels of one warm search, CUDA events, median of 3), tn_s {tn_s:.6f} s "
        f"(the TN batches of request (g) at their geometries); request (g) "
        f"{request_wall:.3f} s wall, launching {json.dumps(search_launches)}; the probe "
        f"request {wall:.3f} s wall, launching {json.dumps(counts)}")
    dtype = {"6": "float32", "6b": "bfloat16", "6c": "int8"}[phase]
    return {"dtype": dtype, "search_s": search_s, "tn_s": tn_s,
            "request_s": request_wall, "launches": counts}


def probe_refused(client, queries, what):
    """13d: a sharded or IVF server answers probe with the JAX server's
    typed error, and goes on serving."""
    from vsc2022_torch.retrieval.client import ServeError

    try:
        client.probe(queries)
    except ServeError as e:
        check("unsharded corpora only" in str(e), f"13d {what}: probe error {e}")
        check(client.stats().n_videos > 0, f"13d {what}: the server stopped serving")
        log(f"phase 13d ({what}): probe refused with the typed error: {e}")
        return
    check(False, f"13d {what}: probe answered on a sharded or IVF corpus")


def umbrella_exit_codes():
    """13a: python -m vsc2022_torch --help exits 0, an unknown command 2."""
    codes = {}
    for argv in (["--help"], ["no-such-command"]):
        proc = subprocess.run([sys.executable, "-m", "vsc2022_torch", *argv],
                              cwd=str(REPO), capture_output=True, text=True, timeout=120)
        codes[argv[0]] = proc.returncode
        check("adapt-model" in proc.stdout and "parity" in proc.stdout,
              f"13a: {argv}: the command list is missing")
    check(codes == {"--help": 0, "no-such-command": 2}, f"13a: exit codes {codes}")
    log(f"phase 13a: python -m vsc2022_torch: exit codes {json.dumps(codes)}")


def adapt_model_checkpoint(torch, np, extraction):
    """13b: adapt-model --probe, then --verify --output_checkpoint, on phase
    8's SSCD TorchScript (--device cuda), through the umbrella's routing;
    the inference CLI on phase 8's query videos from --checkpoint_path
    <that npz> gives phase 8's npz (from --torchscript_path) bit for bit."""
    import io

    from vsc2022_torch import __main__ as umbrella

    work = SMOKE_DIR / "adapt"
    work.mkdir(parents=True, exist_ok=True)
    weights, videos = extraction["weights"], extraction["videos"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            umbrella.main(["adapt-model", "--input_torchscript", weights, "--model", "sscd",
                           "--probe", "--device", "cuda"])
            code = None
        except SystemExit as e:
            code = e.code
    check(code == 0 and "OK: all" in out.getvalue(),
          f"13b: adapt-model --probe exit {code}: {out.getvalue()[-2000:]}")
    probe_s = time.perf_counter() - t0
    ckpt = work / "sscd_flax.npz"
    t0 = time.perf_counter()
    umbrella.main(["adapt-model", "--input_torchscript", weights, "--model", "sscd",
                   "--verify", "--output_checkpoint", str(ckpt), "--device", "cuda"])
    verify_s = time.perf_counter() - t0
    q = work / "q_checkpoint.npz"
    t0 = time.perf_counter()
    from vsc2022_torch.inference import cli
    cli.main(cli.parser.parse_args(cli_argv(
        videos, "queries", q, "--baseline", "sscd", "--checkpoint_path", str(ckpt),
        "--transforms", "RESIZE_320_CENTER")))
    cli_s = time.perf_counter() - t0
    check(same_arrays(np, npz_arrays(np, q), npz_arrays(np, extraction["q"])),
          "13b: descriptors from the adapt-model checkpoint differ from the TorchScript's")
    log(f"phase 13b: adapt-model --probe OK ({probe_s:.2f} s), --verify on cuda and the "
        f"checkpoint ({verify_s:.2f} s); the inference CLI from --checkpoint_path "
        f"({cli_s:.2f} s) == from --torchscript_path (phase 8), bit for bit")


def parity_command(paths):
    """13c's command: python -m vsc2022_torch parity --device cuda on phase
    4's npz files and GT. Returns (its output path, the command)."""
    out = SMOKE_DIR / "parity"
    return out, [sys.executable, "-m", "vsc2022_torch", "parity", "--device", "cuda",
                 "--output_path", str(out), "--query_features", paths["queries"],
                 "--ref_features", paths["refs"], "--noise_features", paths["noise"],
                 "--ground_truth", paths["gt"]]


def start_parity(paths):
    """13c's first parity run, started in the background before phase 12:
    it runs alongside phase 12, 13a and 13b, which share the card and the
    host with it (their logged times and its stage seconds include that).
    Returns (process, its stdout and stderr files, start time)."""
    _, cmd = parity_command(paths)
    files = (SMOKE_DIR / "parity_run1.out", SMOKE_DIR / "parity_run1.err")
    with open(files[0], "w") as out, open(files[1], "w") as err:
        proc = subprocess.Popen(cmd, cwd=str(REPO), stdout=out, stderr=err)
    return proc, files, time.perf_counter()


def parity_rehearsal(np, paths, phase4_candidates, started):
    """13c: the parity run ``start_parity`` started, then a second one: the
    checks of phase 13 in the module docstring; each stage's seconds
    logged. Returns the summary."""
    from vsc2022_torch.metrics import CandidatePair

    out, cmd = parity_command(paths)
    runs = []
    for i in range(2):
        if i == 0:
            proc, files, t0 = started
            try:
                rc = proc.wait(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            stdout, stderr = (f.read_text() for f in files)
        else:
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True,
                                  timeout=900)
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        wall = time.perf_counter() - t0
        text = stdout + stderr
        (SMOKE_DIR / f"parity_run{i + 1}.log").write_text(text)
        check(rc == 0, f"13c: parity run {i + 1} exited {rc}: {text[-3000:]}")
        stages = [ln.split("stage ", 1)[1] for ln in text.splitlines()
                  if "INFO     stage vsc2022_torch." in ln]
        runs.append((text, json.loads(stdout.strip().splitlines()[-1])))
        log(f"phase 13c: parity run {i + 1}: {wall:.2f} s wall"
            + (" (alongside phases 12, 13a, 13b)" if i == 0 else "") + "; stages: "
            + "; ".join(stages))
    (first, summary), (second, again) = runs
    faithful = (out / "sn_faithful" / "candidates.csv").read_bytes()
    check(faithful == phase4_candidates,
          "13c: sn_faithful/candidates.csv differs from phase 4's candidates.csv")
    tuned = [(c.query_id, c.ref_id, c.score)
             for c in CandidatePair.read_csv(str(out / "sn_tuned" / "candidates.csv"))]
    check(tuned == [(c.query_id, c.ref_id, c.score)
                    for c in CandidatePair.read_csv(str(out / "sn_faithful" / "candidates.csv"))],
          "13c: sn_tuned's candidates differ from sn_faithful's")
    metrics = summary["metrics"]
    check(set(metrics) == {"descriptor_uap", "segment_ap_sn_faithful", "segment_ap_sn_tuned",
                           "segment_ap_raw"}
          and all(math.isfinite(v) for v in metrics.values()), f"13c: metrics {metrics}")
    check(metrics["segment_ap_sn_tuned"] > 0.5 and metrics["descriptor_uap"] > 0.5,
          f"13c: metrics {metrics}")
    check(second.count("Reusing existing artifact") == 3 and "sscd_baseline" not in second,
          "13c: the second parity run reran a stage")
    check(again == summary, "13c: the second parity run wrote another summary")
    n_pairs = faithful.count(b"\n") - 1
    log(f"phase 13c: sn_faithful/candidates.csv == phase 4's byte for byte "
        f"({n_pairs} pairs), sn_tuned's the same; metrics "
        f"{json.dumps(metrics)}; deltas {json.dumps(summary['delta_vs_reference'])}; the "
        "second run reused every stage and wrote the same summary")
    return summary


def s2d_stem_on_card(torch, np, dev, weights):
    """13e: phase 8's SSCD weights with the space-to-depth stem
    (fold.s2d_stem, SSCDModel(stem_s2d=True)) against the standard stem,
    f32 through DescriptorExtractor on S2D_FRAMES of phase 8's frames:
    within S2D_REL_TOL; each forward's frames/s logged (report only)."""
    from vsc2022_torch.inference import cli
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import InferenceTransforms
    from vsc2022_torch.models.fold import s2d_stem
    from vsc2022_torch.models.sscd import SSCDModel

    args = cli.parser.parse_args(["--baseline", "sscd", "--dataset_path", "-",
                                  "--output_file", "-", "--torchscript_path", weights])
    standard = cli.build_model(args)
    s2d = SSCDModel(stem_s2d=True)
    s2d.load_state_dict(s2d_stem(standard.state_dict()))
    frame = stub_frame_fn(np)
    frames = torch.from_numpy(np.stack([frame(1000 + i // 40, i % 40)
                                        for i in range(S2D_FRAMES)])).to(dev)
    out, fps = {}, {}
    for label, model in (("standard", standard), ("s2d", s2d)):
        extractor = DescriptorExtractor(model, InferenceTransforms["RESIZE_320_CENTER"],
                                        batch_size=EXTRACT_BATCH, device=dev)
        extractor.forward(frames[:EXTRACT_BATCH])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = [extractor.forward(frames[i:i + EXTRACT_BATCH])
                 for i in range(0, S2D_FRAMES, EXTRACT_BATCH)]
        torch.cuda.synchronize()
        fps[label] = round(S2D_FRAMES / (time.perf_counter() - t0), 1)
        out[label] = torch.cat(parts).cpu().numpy()
        del extractor
    err = rel_err(np, out["s2d"], out["standard"])
    check(err <= S2D_REL_TOL, f"13e: the s2d stem lies {err:.3g} off the standard stem")
    log(f"phase 13e: SSCD ResNet-50 f32 with the s2d stem == the standard stem within "
        f"{err:.3g} of the largest value (tolerance {S2D_REL_TOL}) on {S2D_FRAMES} "
        f"frames; forward frames/s (batch {EXTRACT_BATCH}): {json.dumps(fps)}")


def phase_last_entry_points(torch, np, dev, paths, phase4_candidates, extraction,
                            parity):
    """Phase 13 (13d runs inside phases 6, 6b, 6c, 9c and 11c; 13c's first
    parity run, ``parity``, started before phase 12)."""
    t0 = time.perf_counter()
    umbrella_exit_codes()
    adapt_model_checkpoint(torch, np, extraction)
    torch.cuda.empty_cache()
    parity_rehearsal(np, paths, phase4_candidates, parity)
    s2d_stem_on_card(torch, np, dev, extraction["weights"])
    log(f"phase 13: {time.perf_counter() - t0:.1f} s after phase 12 (13d inside phases 6, "
        "9c and 11c; 13c's first run began before phase 12)")


def match_rows(path):
    """{(query, ref, segment bounds): score} of a matches CSV."""
    rows = _csv_rows(path)
    score = rows[0].index("score")
    return {tuple(r[:score] + r[score + 1:]): float(r[score]) for r in rows[1:]}


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keep", action="store_true",
                    help="keep the synthetic corpus under build/smoke")
    # Phase 10 starts this script again as each rank of its pod.
    ap.add_argument("--pod-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--pod-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--pod-dir", help=argparse.SUPPRESS)
    # Phase 12d starts it as each rank of its training group.
    ap.add_argument("--train-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--train-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--train-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not (REPO / "vsc2022_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(vsc2022_torch/ not found beside it)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if args.pod_rank is not None:
        return pod_rank_main(args.pod_rank, args.pod_port, Path(args.pod_dir))
    if args.train_rank is not None:
        return train_rank_main(args.train_rank, args.train_port, Path(args.train_dir))
    sys.path.insert(0, str(REPO))
    from vsc2022_torch.ops import _build, kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().name})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    probe = torch.empty(0, device=dev)
    log("phase 1: resident blocks per SM (narrow / 16-byte copies): " + ", ".join(
        f"{name} {kernels._reduce_slots(probe, name, 0) // sms} / "
        f"{kernels._reduce_slots(probe, name, 1) // sms}"
        for name in ("row_max", "count_above", "fused_topk")))
    log_pool_plans(kernels, _build.library(), probe, sms)
    slots = kernels._wgmma_slots(probe)
    for label, m, n_valid in (("SSCD", 9000, 250_020), ("serving bias", 9000, 60_000)):
        q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
        grid = kernels.wgmma_grid(m, n_valid, slots)
        log(f"phase 1: row_max.bf16 (wgmma_gemm.cuh) at the {label} shape "
            f"[{m} x {n_valid}]: {slots // sms} block(s) per SM, grid {grid}; tile "
            f"{kernels.WGMMA_ROWS} x {kernels.WGMMA_COLS}, {q_tiles} x {c_tiles} "
            f"tiles in groups of {kernels.WGMMA_GROUP} query tiles; the corpus read "
            f"{kernels.wgmma_corpus_passes(m, n_valid, grid):.2f} times (row-tile "
            f"order: {kernels.reduce_tiles(m, n_valid)[0]})")
    for label, m, n_valid, vec in (("serving", 9000, 240_000, 1),
                                   ("DnS", 7682, 31_004, 0)):
        grid, pieces = kernels.topk_grid(m, n_valid, 32, kernels.reduce_grid(
            m, n_valid, kernels._reduce_slots(probe, "fused_topk", vec)))
        log(f"phase 1: fused_topk at the {label} shape [{m} x {n_valid}], kappa 32: "
            f"grid {grid}, S = {pieces} pieces per row")
        log_stream_pair_plans(kernels, _build.library(), probe, sms, label, m,
                              n_valid, 32)

    try:
        phase_kernels_small(torch, kernels, dev)
        phase_kernels_bf16_small(torch, kernels, dev)
        phase_kernels_int8_small(torch, kernels, dev)
        phase_search(torch, np, dev, 1000, 100_000, DIM, 20_000)
        launches, captured, paths, sscd_f32 = phase_main_path(torch, np, kernels)
        # Kept for 13c: parity's faithful arm must write these bytes.
        phase4_candidates = (SMOKE_DIR / "out" / "candidates.csv").read_bytes()
        records = phase_kernels_main(torch, kernels, dev, captured)
        del captured
        torch.cuda.empty_cache()
        bf16_launches, bf16_captured, sscd_bf16 = phase_main_path_bf16(
            torch, np, kernels, paths, sscd_f32)
        records.update(phase_kernels_main(torch, kernels, dev, bf16_captured))
        launches.update({k: bf16_launches[k] for k in SSCD_BF16_KERNELS + ("scores" + BF16,)})
        del bf16_captured
        torch.cuda.empty_cache()
        int8_launches, int8_captured, _ = phase_main_path_int8(
            torch, np, kernels, paths, sscd_f32, sscd_bf16)
        records.update(phase_kernels_main(torch, kernels, dev, int8_captured))
        launches.update({k: int8_launches[k] for k in SSCD_INT8_KERNELS + ("scores" + INT8,)})
        del int8_captured
        torch.cuda.empty_cache()
        dns_launches, dns_captured, dns_batches = phase_dns_path(torch, np, kernels)
        corpus = serve_corpus(np)
        serve_launches, serve_captured, _, serve_quality = phase_serve(
            torch, np, kernels, dev, corpus)
        serve_dns_request()
        (serve_bf16_launches, serve_bf16_captured, (pooled_launches, pooled_captured),
         serve_bf16_quality) = phase_serve(torch, np, kernels, dev, corpus, dtype="bfloat16")
        dns_bf16_launches = serve_dns_request("bfloat16")
        serve_int8_launches, serve_int8_captured, pooled_int8, serve_int8_quality = phase_serve(
            torch, np, kernels, dev, corpus, dtype="int8")
        dns_int8_launches = serve_dns_request("int8")
        phase_l2_small(torch, kernels, dev)
        l2_recs, l2_launches = phase_l2_search(torch, np, kernels, dev, corpus)
        phase_default(torch, np, kernels, dev, corpus)
        phase_knn(torch, np, dev, corpus)
        phase_matching_eval(paths, SMOKE_DIR / "out", sscd_f32["segment_ap"])
        searchv_launches, extraction = phase_extraction(torch, np, kernels, dev)
        sharded_launches = phase_sharded(torch, np, kernels, dev, paths, corpus)
        pod_launches = phase_pod(torch, np, kernels, corpus, extraction, sharded_launches,
                                 serve_bf16_launches)
        ivf_records, ivf_launches = phase_ivf(torch, np, kernels, dev, corpus)
        del corpus
        torch.cuda.empty_cache()
        parity = start_parity(paths)
        try:
            train_launches, _ = phase_train(torch, np, kernels, dev)
            phase_last_entry_points(torch, np, dev, paths, phase4_candidates, extraction,
                                    parity)
        finally:
            if parity[0].poll() is None:
                parity[0].kill()
                parity[0].wait()
    finally:
        if not args.keep:
            shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    time_collection_modes(torch, np, serve_captured["fused_topk"],
                          1200 * N_QUERY_VIDEOS, "serving")
    time_collection_modes(torch, np, dns_captured["fused_topk"],
                          1200 * DNS_QUERIES, "DnS")
    dns_bf16_captured = dns_search(torch, np, kernels, dns_captured["fused_topk"],
                                   1200 * DNS_QUERIES, dns_bf16_launches, "bfloat16")
    dns_int8_captured = dns_search(torch, np, kernels, dns_captured["fused_topk"],
                                   1200 * DNS_QUERIES, dns_int8_launches, "int8")
    chamfer_calls = dns_captured.pop("chamfer")
    records["chamfer"] = phase_chamfer(torch, kernels, dev, chamfer_calls)
    launches["chamfer"] = dns_launches["chamfer"]
    records["chamfer.bf16"], launches["chamfer.bf16"] = phase_chamfer_bf16(
        torch, kernels, dev, chamfer_calls, dns_batches, dns_launches)
    del chamfer_calls, dns_batches
    torch.cuda.empty_cache()
    dns_records = phase_kernels_main(torch, kernels, dev, dns_captured, path="DnS")
    # The bf16 variants at the DnS widths (D = 1024, 1025), on the DnS
    # path's inputs rounded to bf16; their launches are the bf16 DnS
    # server request's.
    dns_records.update(phase_kernels_main(torch, kernels, dev, {
        name: tuple(a.to(torch.bfloat16) if isinstance(a, torch.Tensor) else a
                    for a in call)
        for name, call in dns_captured.items()}, path="DnS"))
    # scores_above.bf16 (and scores.bf16) on the rows the DnS bf16 search
    # re-searches.
    dns_records.update(phase_kernels_main(torch, kernels, dev, dns_bf16_captured,
                                          path="DnS bf16 search"))
    # The int8 variants at the DnS width (D = 1025, codes of 1,040 columns)
    # on the DnS int8 search's own inputs; their launches are the int8 DnS
    # server request's.
    dns_records.update(phase_kernels_main(torch, kernels, dev, dns_int8_captured,
                                          path="DnS int8 search"))
    del dns_captured, dns_bf16_captured, dns_int8_captured
    serve_records = phase_kernels_main(torch, kernels, dev, serve_captured,
                                       path="serving")
    del serve_captured
    serve_records.update(phase_kernels_main(torch, kernels, dev, serve_bf16_captured,
                                            path="serving"))
    del serve_bf16_captured
    serve_records.update(phase_kernels_main(torch, kernels, dev, serve_int8_captured,
                                            path="serving"))
    del serve_int8_captured
    # pool_writer and the re-search of the bf16 and int8 serving searches
    # forced to the pool.
    pooled_launches.update({k: v for k, v in pooled_int8[0].items() if k.endswith(INT8)})
    pooled_records = phase_kernels_main(torch, kernels, dev, pooled_captured,
                                        path="serving (forced pooled)")
    pooled_records.update(phase_kernels_main(torch, kernels, dev, pooled_int8[1],
                                             path="serving (forced pooled)"))
    del pooled_captured, pooled_int8
    # The streaming kernels' main record is the serving path's (the SSCD
    # path pools).
    for name, counts in (("fused_topk", serve_launches),
                         ("fused_topk.bf16", serve_bf16_launches),
                         ("fused_topk.int8", serve_int8_launches)):
        records[name] = serve_records.pop(name)
        launches[name] = counts[name]
    # The L2 variants: phase 7b's search over the serving catalogue.
    records.update(l2_recs)
    launches.update(l2_launches)
    # The block subsets: phase 11b's IVF searches (timed on the batch's
    # probed blocks, 11a).
    records.update(ivf_records)
    launches.update(ivf_launches)
    path_of = {"chamfer": "dns", "chamfer.bf16": "dns, precision default (phase 5d)",
               "fused_topk": "serving", "fused_topk.bf16": "serving",
               "fused_topk.int8": "serving",
               **{name: "serving, metric L2 (phase 7b)" for name in kernels.L2_KERNELS},
               **{name: "IVF tier (phase 11b)" for name in kernels.BLOCK_KERNELS}}

    def by_dtype(name, f32, bf16, int8):
        return bf16 if name.endswith(BF16) else int8 if name.endswith(INT8) else f32

    rows = []
    for name, rec in records.items():
        base = name.split(".")[0]
        source, replaces = KERNEL_META[base]
        if name.endswith(BF16):
            replaces = BF16_REPLACES.get(base, replaces)
            source = BF16_SOURCES.get(base, source)
        if name.endswith(BLOCKS):
            replaces = BLOCKS_REPLACES[base]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "path": path_of.get(name, "sscd"),
        }
        for key in ("path_total", "f32_ms", "bf16_ms", "ip_ms", "library_bf16_out_ms",
                    "path_function",
                    "plan",
                    "kernel_only_ms", "library_route_ms", "dense_route_ms", "entries",
                    "capacity", "peak_bytes", "dense_route_peak_bytes", "head", "blocks"):
            if key in rec:
                row[key] = rec[key]
        if name in dns_records:  # the same kernel on the DnS path
            counts = by_dtype(name, dns_launches, dns_bf16_launches, dns_int8_launches)
            row["dns"] = dict(dns_records[name], launches=counts.get(name, 0))
        if name in serve_records:  # and on the serving path
            counts = by_dtype(name, serve_launches, serve_bf16_launches,
                              serve_int8_launches)
            row["serving"] = dict(serve_records[name], launches=counts[name])
        if name in pooled_records:  # and its search forced to the pool
            row["serving_pooled"] = dict(pooled_records[name],
                                         launches=pooled_launches[name])
        if name in SEARCHV_KERNELS:  # phase 8's searchv (the f32 server)
            row["searchv_launches"] = searchv_launches[name]
        # Phase 9's sharded runs: every shard launches its kernel.
        sharded = {label: counts[name] for label, counts in sharded_launches.items()
                   if counts.get(name)}
        if sharded:
            row["sharded_launches"] = sharded
        # Phase 10's pod: each rank launches its kernels on its shard.
        pod = {label: counts[name] for label, counts in pod_launches.items()
               if counts.get(name)}
        if pod:
            row["pod_launches"] = pod
        row["train_launches"] = train_launches.get(name, 0)  # phase 12: none
        # 13d: serve's probe, a warm search's kernels (warm-up + 3 searches).
        probe_launches = {q["probe"]["dtype"]: q["probe"]["launches"][name]
                          for q in (serve_quality, serve_bf16_quality, serve_int8_quality)
                          if name in q["probe"]["launches"]}
        if probe_launches:
            row["probe_launches"] = probe_launches
        rows.append(row)
    log(nvidia_smi_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)

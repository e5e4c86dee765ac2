#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port of PI (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--profile WINDOWS]

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives
the index at a real data size: 2^24 YCSB keys over a 2^30 key space in one
PI shard (capacity 2^25, pending capacity 2^22, fanout 8) and in 8
fence-routed shards, windows of 8192 operations.  Phases:

1. build the kernels and the index; print the card's name and power limit;
   ``[pilint]``: the port's analyzer (``repro_torch.analysis``) over
   ``src/repro_torch`` against ``pilint-baseline.json`` on the card's
   host, which must report no new finding, its time and the CLI's
   start-up time (``python -m repro_torch.analysis --list-rules`` in a
   process of its own beside phase 2, most of it importing torch)
   printed;
2. hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the main paths' shapes, and time both: ``pi_probe`` and
   ``pi_search`` in int32 and float32 on the fresh and the pending-filled
   index, on mixed lanes and on a window's keys sorted (both timed, beside
   one query's probe, an empty kernel and ``torch.searchsorted`` over the
   pending buffer, a partial yardstick for the probe), ``pi_range``
   on the fresh index and on the pending-filled one with deletes (storage
   and pending tombstones), with YCSB-E scans, empty and inert lanes,
   ranges below the minimum or up to INT_MAX - 1 and spans beyond the
   ``max_span`` budget, and on one window of the YCSB-E stream's own
   ranges on both indexes; ``bitonic_sort`` on a window's keys, on keys
   with many ties, sorted, reversed, with sentinel keys, on float32 keys, at
   2^15 and 2^20 keys, and over every B = 2^1 .. 2^22 in int32 and
   float32 (ties, all equal, sorted, reversed, organ pipe, 1/8 sentinels,
   int32 limits in both lanes, +-inf) against ``bitonic_sort_ref`` (and
   the plain version up to 2^17); ``bitonic_argsort``, the ``cuda``
   engine's batch sort, against its plain version and, at ragged batches
   up to 2^22, against ``torch.argsort(stable=True)``; device time and
   launches of a sort at 2^13, 2^15, 2^20 and 2^22 beside the argsort's,
   the bound and an empty kernel's time;
3. the point-op path: windows (write ratio 0.5, zipf theta 0.9) through
   ``step_single``, a two-tier ``rebuild`` (incremental), a ``repack``,
   then ``lookup`` and ``traverse``, with the ``cuda`` backend, checked
   against the ``RefIndex`` oracle and against the ``torch`` backend, bit
   for bit;
4. the serving path: a YCSB workload E stream (95 % scans of 1..100
   records, 5 % inserts, zipf theta 0.9) through ``Dispatcher.run`` at
   depth 1, every RANGE checked against an oracle of the pre-window state
   and every point result against ``RefIndex``, and the same stream with
   the ``torch`` backend, bit for bit; then a mixed stream (30 % scans,
   write ratio 0.5) on an index with a small pending buffer, so that
   rebuilds run inside the dispatcher, against the same oracles;
5. the durable path: the mixed stream through ``Dispatcher.run`` with a
   ``Durability`` (WAL append at seal with a per-window fsync, a snapshot
   every 8 windows) under ``build/durability/``: ``recover`` after a clean
   close gives the live state bit for bit, on the ``cuda`` and on the
   ``torch`` backend; a crash injected at each of the five fault points
   recovers to the state of a dispatcher without durability over exactly
   the recovered windows, which hold every acknowledged one; a new
   ``Durability`` over one recovered index finishes the stream at the
   crash-free state.  Prints the WAL append and fsync times, snapshot and
   recover times and arrivals/s with and without durability;
6. ``[sharded]``: the same 2^24 keys as 8 fence-routed shards on the card,
   each of ``benchmarks/fig8_scalability.py``'s per-shard geometry
   (capacity 2N/S = 2^22, pending capacity N/S/4 = 2^19, fanout 8);
   windows of 8192 with capacity factor 2.0, so a send bucket holds 256
   lanes and each shard executes 2048.  ``pi_probe``,
   ``bitonic_argsort`` and ``pi_range`` against their plain versions at a
   shard's shapes; 32 point windows (write ratio 0.5, zipf 0.9, the
   collector's windows) through the sharded ``Dispatcher``, against
   ``RefIndex`` and the ``torch`` backend bit for bit, then
   ``collect_pairs`` after the windows and after ``rebuild_sharded``
   against the oracle's live set; a YCSB-E stream through
   ``Dispatcher.run`` against the pre-window oracle and the ``torch``
   backend; a zipfian burst whose per-shard load re-cuts the fences
   (``rebalance_from_load``), the rebuilt index showing a lower
   ``load_imbalance``; a capacity factor of 0.25 that raises
   ``DispatchOverflowError`` and a mostly padded window that does not;
   durability of the sharded kind (recover after a clean close and after
   a crash at each fault point, bit for bit).  Prints ops/s, window p50
   and p99 beside the single shard's, the per-shard load and imbalance,
   and with ``--profile`` device time by kernel and the busy share;
6b. ``[mesh]``: the sharded index and the reference's other
   ``shard_map`` parts across ranks, one process a rank
   (``torch.multiprocessing`` spawns them; they meet through a
   ``FileStore`` under ``build/``, every process group with a timeout;
   the kernels are built before, so the ranks only load them; a rank
   that fails or hangs fails the script).  ``[mesh:index]``: 4 ranks
   sharing the card over ``gloo`` (2 shards a rank) run ``[sharded]``'s
   32 point windows, its YCSB-E stream and its fence re-cut; every
   rank's results equal ``[sharded]``'s bit for bit and the digests of
   every leaf of every shard equal its states'; each rank's launches of
   ``pi_probe``, ``bitonic_argsort`` and ``pi_range`` are printed, and
   the window p50 beside ``[sharded]``'s (ranks that share one card
   through ``gloo`` are no multi-card figure).  ``[mesh:durable]``: the
   four ranks run the durable mixed stream (rank 0 writes, the snapshots
   gathered from every rank) and crash at ``ckpt.pre_rename``; ``recover``
   in this process equals a crash-free dispatcher over the recovered
   windows.  ``[mesh:moe]``: granite-moe-3b-a800m's expert layer at full
   width through ``moe_apply_shardmap`` on a (2, 2) ("data", "model")
   mesh, 8 x 2048 tokens in float32 without TF32, drop-free, within 1e-5
   of the largest |y| of one process's ``moe_apply`` (``lb_loss`` 1e-6).
   ``[mesh:psum]``: ``compressed_psum`` over the 4 ranks against the same
   arithmetic on the CPU (``q`` bit for bit, the mean and the error
   within 1e-6).  ``[mesh:pipe]``: ``pipelined_forward`` over a 4-stage
   axis against the stages in sequence within 1e-5.
   ``[mesh:index:nccl]``: 1 rank over NCCL repeats ``[mesh:index]``'s
   checks (NCCL refuses two ranks on one card: NCCL with more ranks is
   not run);
7. ``[overload]``: a bursty stream (write ratio 0.6, zipf 0.9) through
   ``OverloadController.run`` on the ``cuda`` backend at the 2^24-key
   index with a pending capacity of 2^14, so that the pending fill passes
   the shed thresholds: it must shed, retry and end with the breaker
   closed; the admitted subsequence replays exactly against ``RefIndex``
   (zero acknowledged loss) and the ``torch`` backend gives an identical
   ``RunReport``;
8. ``[kernels:flash]``: ``flash_attention_fwd`` against its plain
   version on the card at phi3-mini's prefill shape (8 x 2048 tokens, 32
   heads of 96, bfloat16, causal), granite-moe's (24 heads over 8 KV
   heads of 64; and in float32 at (2, 512)), yi-34b's heads (56 over 8
   KV heads),
   MQA with a window of 64, a softcap of 50, a ragged length of 1000 at
   head dim 256, head dims 16, 32 and 64, lengths of 17 and 1 (below one
   key tile), no causal mask, q/k/v views whose base is not 16-byte
   aligned, and in float32 (2, 512, 32, 32, 96) and the same paths (GQA,
   MQA with a window, softcap, S = 1000 at D = 16 and 256, S = 17 and 1,
   not causal, unaligned views), within ``CARD_TOL`` of
   ``kernels/flash_attention.py`` (1e-3 + 2^-6 |plain| in bfloat16, 1e-5
   in float32: what the two can differ by), each case's share of its limit
   printed; device time and TFLOP/s of the tensor-core kernel at phi3's
   shape and of the float32 kernel at (2, 512, 32, 32, 96), each against
   its bound, the plain version and ``F.scaled_dot_product_attention`` in
   its dtype (timed only); recurrentgemma's shapes in bfloat16, (8,
   2048, 16, 1, 256) with a window of 2048 (timed: the window does not
   bind at 2048, so SDPA's causal mask computes the same function) and
   (2, 4096, 16, 1, 256) where it binds, and in float32 (2, 256, 16, 1,
   256);
9. ``[lm]``: phi3-mini-3.8b at its full width (32 layers, d 3072, 32
   heads of 96, d_ff 8192, vocab 32064), weights from ``init_params``
   on a CPU generator seeded with ``SEED`` (the same weights as on the
   CPU), drawn once for phases 9 to 11, cast once to bfloat16: a
   prefill of 8 prompts of 2048 tokens (the flash kernel once a layer,
   checked by its count, and ``forward`` likewise), 64 greedy decode
   steps from its cache; then the same config in float32, whose prefill
   of 2 x 256 tokens must agree with 256 token-by-token decode steps
   (attention by plain einsums) in its last logits and every cache leaf;
   device time of a prefill and of a decode step by kernel;
10. ``[serve:lm]``: the LM ``Server`` at that width (8 slots, 128
   positions, the ``cuda`` session table, a WAL under
   ``build/serve_wal``) serves 16 requests with prompts of 16-48 tokens
   and 16 new tokens each until drained, with ``session_range`` checked
   midway against the host's view; ``recover`` of its directory equals
   its table bit for bit;
11. ``[train]``, with the weights of 9 and 10 freed: (a)
   ``FlashAttention`` at phi3's heads (2, 512, 32, 32, 96) in bfloat16
   and float32, its forward within ``CARD_TOL`` of the plain version and
   its dq, dk, dv equal bit for bit to autograd through the plain version
   at the model's chunk of 1024, and one layer's attention forward and
   backward timed at (4, 2048, 32, 32, 96); (b) phi3-mini-3.8b at full
   width and depth, the float32 parameters of 9, bfloat16 compute,
   ``remat`` on, AdamW
   with bfloat16 moments: ``TRAIN_STEPS`` steps of ``make_train_step`` on
   ``lm_batch`` of 4 x 2048 tokens, every loss and gradient norm finite,
   the last loss below the first, the flash kernel launched twice a
   layer a step (the forward and its rematerialization); step time p50,
   tokens/s, peak memory and, with ``--profile``, one step's device time
   by phase and kernel class; (c) one AdamW step of phi3's widths at 2
   layers in float32 on the card and on the CPU, from the same weights
   and batch of 1 x 256 tokens: loss, every gradient leaf and every
   parameter of the card's step from the CPU's gradients within
   ``CARD_CPU_TOL``; (d)
   ``launch/train.py::train`` at 2 layers with bfloat16 moments under
   ``build/train_ckpt`` (removed at the end): a slow step flagged by the
   watchdog, a failure injected after a checkpoint, the resumed run's
   loss against an uninterrupted run's;
11b. ``[mesh:train]``: the language model across ranks.  4 ranks
   (``mesh_rank``, spawned as ``[mesh]``'s, ``cpu_count // 4`` threads
   each) share the card over ``gloo`` on a (2, 2) ("data", "model") mesh,
   the state placed by ``sharding.DEFAULT_RULES`` as DTensors: (a)
   phi3-mini-3.8b at its full width and depth (``LM_LAYERS``),
   bfloat16, AdamW with bfloat16 moments, drawn from ``SEED`` onto the
   mesh (every rank draws each leaf on the host and keeps its block),
   ``MESH_TRAIN_STEPS`` steps of 4 x 2048 tokens: every rank's losses
   equal, the first within ``MESH_TRAIN_TOL`` of ``[train]``'s
   one-process first loss, the flash kernel launched on each rank's
   local heads twice a layer a step; each rank's peak memory and the
   p50 of the steps after the first; (b) phi3's widths at 2 layers in
   float32 on the 4 ranks against one process on the card under
   ``CARD_CPU_TOL`` (loss, gradients, one AdamW step), the placing of the
   state timed; (c) ``launch/train.py::train`` over the 4 ranks at 1
   layer, 4 steps, checkpoints after the last two; 1 NCCL rank restores
   the last one bit for bit (leaf digests against the state the ranks
   gathered) and resumes from the one before it for the last step, its
   loss within ``MESH_TRAIN_TOL`` of the ranks'; (d) granite-moe's
   widths at 2 layers in float32, drop-free (capacity factor 64): the
   gradients of ``loss_fn`` through ``moe_apply_shardmap`` (24 experts a
   rank) within 1e-5 of each leaf's largest of one process's
   ``moe_apply``; (e) 1 NCCL rank: (a)'s step at 2 layers through a
   one-rank mesh equals the step without one bit for bit
   (deterministic algorithms on: the embedding's backward adds without
   atomics).  A one-rank mesh runs the one-card program on its blocks
   (``steps.loss_and_grad``), so (e) holds the placing, the optimizer
   and the NCCL group of one rank, not the DTensor path of (a)-(d);
12. ``[lm:moe]`` and ``[serve:lm:moe]``: 9 and 10 for granite-moe-3b-a800m
   at its published widths and depth (32 layers, d 1536, 24 heads over 8
   KV heads of 64, 40 experts padded to 48, top 8 of width 512, vocab
   49155 padded to 49408, tied embeddings; 3,903,161,856 parameters by
   its layout): the prefill's copies dropped at capacity factor 1.25 and
   its device time by ``moe_apply``'s spans (route, dispatch, expert
   products, combine) beside the flash kernel's, the float32 check at a
   capacity factor of E / K = 5.0 (an expert takes every token: no copy
   dropped);
13. ``[train:moe]``: 11 (b) and (c) for granite, from the float32
   weights of 12; every loss, ``lb_loss`` and gradient norm finite;
14. ``[lm:mla]``: deepseek-v3-671b (~683 B parameters) fits no card, so
   (i) one MLA layer at its published widths (128 heads, q_lora 1536,
   kv_lora 512, nope 128 + rope 64, v 128; 187,107,328 parameters) in
   bfloat16: a prefill of 2 x 512 through the plain chunked attention,
   16 decode steps over the compressed cache, and in float32 the
   prefill against 512 decode steps; (ii) its ``smoke()`` config (MLA, a
   dense first layer, a shared expert, MTP) in float32 on the card and
   on the CPU: ``forward``, ``prefill``, three decode steps, ``loss_fn``
   with every gradient and one AdamW step within ``CARD_CPU_TOL``;
15. ``[lm:ssm]``, ``[serve:lm:ssm]`` and ``[train:ssm]``: 9, 10 and 11
   (b), (c) for mamba2-2.7b at its published widths, 16 of its 64 layers
   (``LM_DEPTH``; d 2560, state 128, 80 heads of 64, conv 4, chunk 128,
   vocab 50280 padded to 50432, tied; 772,573,440 parameters by its
   layout at that depth):
   no attention, so no flash launch; the float32 prefill of 2 x 200
   tokens (no multiple of the chunk: the prefill pads with dt = 0)
   against 200 decode steps in its last logits, its float32 ``ssm``
   states and its ``conv`` tails; the prefill's device time by span
   (``in_proj``, ``conv``, the SSD's intra-chunk products, the loop over
   chunks, ``out_proj``); every train loss finite, the last below the
   first;
16. ``[lm:griffin]``, ``[serve:lm:griffin]`` and ``[train:griffin]``:
   recurrentgemma-9b at its published widths, 8 of its 38 layers
   (``LM_DEPTH``: 2 groups of (rec, rec, attn) and the tail of 2 rec, d
   4096, 16 heads of 256 over 1 KV head, window 2048, lru 4096, GeGLU
   d_ff 12288, vocab 256000, tied and scaled embeddings; 2,630,144,000
   parameters at that depth): the 8 x 2048 prefill (the flash kernel
   once an attention layer, 2), its
   ring cache quantized to int8 and back by ``models/kvquant.py`` within
   ``tests/test_kvquant.py``'s bound, with ``cache_bytes`` equal to the
   tensors' bytes, 64 decode steps, a prefill of 2 x 4096 (the window
   binds; the ring keeps the last 2048 positions) and a decode step onto
   the wrapped ring, the float32 prefill of 2 x 256 against 256 decode
   steps; a 5-layer smoke config (a group and a tail of 2) card vs CPU
   as 14 (ii) does, at 2 x 40 tokens (the ring of 16 wraps); the server;
   train steps as 11 (b) at a cut depth of 3 x ``GRIFFIN_TRAIN_GROUPS``
   + 2 = 5 layers (the full depth's float32 state needs ~102 GB; 8
   layers peaked at 72 GiB), from the first group and the tail of the
   float32 draw;
17. ``[examples]``: the seven examples of ``examples_torch/`` through
   their ``main`` in this process on the card, at the reference's sizes
   but ``train_lm``'s steps (``EXAMPLE_TRAIN_STEPS``, 60 of its 300), its
   checkpoints under ``build/example_train_ckpt`` (removed at the end):
   each example's own checks hold (durable's bit-identical recovery,
   overload's every acknowledged op, train_lm's falling loss), quickstart's
   results equal its run on the CPU in this script bit for bit, and each
   reaches its kernels (``pi_probe`` and ``bitonic_sort`` every index
   example and the LM server's table, ``pi_range`` quickstart, the float32
   flash kernel train_lm, ``pi_probe`` 8 a window distributed_index);
18. ``[roofline]``, on the host with no card work: the census
   (``roofline/census.py``, on ``meta`` tensors) of each step the LM
   phases timed (the prefill and a decode step of ``[lm]``, ``[lm:moe]``,
   ``[lm:ssm]``, ``[lm:griffin]`` and the step of each ``[train*]``, at
   the configs and shapes they ran), priced by ``roofline/model.py``:
   roofline time, bottleneck, MFU and the share, roofline time over
   measured time, which must not pass ``ROOFLINE_SHARE_MAX`` (1.05: no
   program beats its card's roofline); the census's peak bytes beside
   ``max_memory_allocated``, within ``PEAK_TOL`` (25 %) either way for
   phi3's prefill and train step; and the production dry-run cell
   phi3-mini-3.8b train_4k over a fake process group of 256 ranks
   (``launch/dryrun.py``).  17 and 18 take at most 120 s together;
19. check that each path launched its kernels, read from the launch
   guards (``repro_torch.analysis.runtime``), which every served loop of
   3-6 also holds to the one-launch-a-window contract through
   ``launch_guard(...).expect``: ``pi_probe`` once a window and once for
   the lookup, ``pi_search`` once (the traverse) and ``bitonic_sort`` and
   ``core.execute`` once a window on the point path; ``pi_probe``,
   ``bitonic_sort`` and ``core.execute`` once a window and ``pi_range``
   and ``pipeline.ranges`` once a range-bearing window on the serving and
   the durable paths and on every LM server's session table, each of
   them S = 8 times a window on the sharded path; on the overload path at
   least once (its window count follows shedding and a breaker's
   replays), on ``[mesh]``'s ranks together S times a window,
   ``flash_attention_fwd``
   once an attention layer of every GQA prefill and forward (griffin's
   2 of 8) and twice one of every train step (MLA takes the plain
   attention, mamba2 has none).  The script prints its own time.

``--profile N`` adds device time by kernel over N point windows, N
serving windows and N sharded windows, and one train step's by phase.  The line before the last is a JSON object with one
entry per kernel; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result;
so does a machine without a CUDA card, or a directory without the rest of
the repository.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks, from the port's roofline model (NVIDIA data sheet): HBM
# bandwidth, the non-tensor float32 rate, taken as the rate of the int32
# compares these kernels do, and the dense bfloat16 tensor-core rate
# (attention's operations)
from repro_torch.roofline.model import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.roofline.model import \
    PEAK_FLOPS_BF16 as BF16_OPS_PER_S  # noqa: E402
from repro_torch.roofline.model import \
    PEAK_FLOPS_F32 as SCALAR_OPS_PER_S  # noqa: E402

DEVICE = "cuda"
N_KEYS = 1 << 24     # YCSB dataset size (paper: 2M..256M)
WINDOWS = 32         # windows of 8192 operations on the point path
SERVE_WINDOWS = 32   # windows' worth of YCSB-E arrivals through the dispatcher
MIXED_WINDOWS = 16   # windows' worth of the mixed stream
MIXED_PC = 1 << 14   # its pending capacity: rebuilds inside the run
MAX_SPAN = 1024      # occupied-key budget of a RANGE
ITERS = 200          # launches a kernel is timed over (plain version: 1/10)
SWEEP_LOG_B = 22     # [kernels:bitonic] sorts every B = 2^1 .. 2^22
SWEEP_PLAIN_LOG_B = 17   # ... and holds B <= 2^17 to the plain version too
BITONIC_SIZES = (1 << 13, 1 << 15, 1 << 20, 1 << 22)   # ... and times these
SEED = 0
SNAPSHOT_EVERY = 8   # windows between snapshots on the durable path
DURABLE_DIR = os.path.join(ROOT, "build", "durability")
SHARDS = 8           # [sharded]: fig8_scalability's shards of N/S keys
CAPACITY_FACTOR = 2.0    # its routing: a send bucket of cap = 256 lanes
SHARD_CAP = 256
SHARD_WINDOWS = 32   # point windows through the sharded dispatcher
SHARD_SERVE_WINDOWS = 16   # windows' worth of YCSB-E arrivals there
SHARD_DURABLE = 12   # windows' worth of the mixed stream, durable
OVERLOAD_WINDOWS = 16    # [overload]: windows' worth of the burst
MESH_RANKS = 4       # [mesh]: gloo ranks sharing the card
MESH_TIMEOUT = 900   # seconds a spawn of ranks may take
MESH_PG_TIMEOUT = 240    # every process group's collective timeout
MESH_CRASH = ("ckpt.pre_rename", 2)   # [mesh:durable]'s fault point, pass
MESH_MOE_B, MESH_MOE_S = 8, 2048      # [mesh:moe]'s tokens
MESH_MOE_CF = 6.0    # Ep / K: a capacity of every local token, drop-free
MESH_PSUM_N = 1 << 20
MESH_PIPE = dict(L=8, M=8, mb=256, d=1024)
# [mesh:train]: the LM over a (2, 2) ("data", "model") mesh of gloo ranks
MESH_TRAIN_SHAPE = (2, 2)
# (a): steps of phi3 at its full width and depth on 4 x 2048 tokens, the
# first a warm-up (its loss held to [train]'s first; the p50 is the later
# steps').  A third step would take the phase past 300 s (317 s measured
# with three on one H100)
MESH_TRAIN_STEPS = 2
MESH_TRAIN_TOL = 2e-2            # (a), (c): bf16 losses, relative
MESH_CHECK_B, MESH_CHECK_S = 2, 256      # (b): the float32 strict check
MESH_TRAIN_MOE_B, MESH_TRAIN_MOE_S = 4, 512   # (d): granite's gradients
MESH_ELASTIC_STEPS = 4           # (c): checkpoints after steps 2 and 3
MESH_ELASTIC_LAYERS = 1          # ... of phi3 at full width
CRASH_POINTS = ("wal.mid_append", "wal.after_append", "wal.pre_sync",
                "ckpt.mid_write", "ckpt.pre_rename")
LM_ARCH = "phi3-mini-3.8b"
MOE_ARCH = "granite-moe-3b-a800m"
MLA_ARCH = "deepseek-v3-671b"
SSM_ARCH = "mamba2-2.7b"
GRIFFIN_ARCH = "recurrentgemma-9b"
# the LM phases' depths where cut from the published ones, to keep the
# script inside 1100 s with [mesh:train] at phi3's full depth and the
# [examples] and [roofline] phases: mamba2's 64 layers cut to 16,
# recurrentgemma's 38 to 2 groups and the tail of 2 (the draw on the
# host and the host-bound decode steps are near proportional to the
# layers).  Measured on one H100: before the two phases the script
# took 983.7 s with mamba2 at 32 and recurrentgemma at 14 and 1096.5 s
# with mamba2 at 64; with them, at 32 and 14, 1113.7 s (34.0 s of it
# theirs; the phases before them took 1079.7 s there against 983.7 s:
# one machine has run the same script 13 % slower than another);
# mamba2's phases took 82.0 s at 32 layers, recurrentgemma's 58.9 s at
# 14.  granite-moe keeps
# its 32: at 16 layers, another draw, its float32 prefill-vs-decode
# check missed its bar by a routing near-tie (the cache's k 0.0472 apart
# against 0.00496)
LM_DEPTH = {SSM_ARCH: 16, GRIFFIN_ARCH: 8}
# the full-width models' parameters by their layouts at those depths:
# phi3's vocab padded to 32256; granite's vocab padded to 49408 and its
# 48 padded experts; mamba2's vocab padded to 50432 (2,702,968,320 at 64
# layers); recurrentgemma's 2 groups and 2 tail layers (8,524,206,080 at
# its 12 groups)
LM_PARAMS = {LM_ARCH: 3_822_259_200, MOE_ARCH: 3_903_161_856,
             SSM_ARCH: 772_573_440, GRIFFIN_ARCH: 2_630_144_000}
MLA_LAYER_PARAMS = 187_107_328   # [lm:mla] (i): one MLA layer of deepseek
MLA_B, MLA_S = 2, 512            # ... its prefill
MLA_DECODE = 16                  # ... and decode steps over its cache
# the spans by which a profile splits a layer's time: moe_apply's, the
# mamba2 block's (ssm.intra: the intra-chunk products and the chunk
# states; ssm.inter: the loop over chunks and the off-diagonal product),
# griffin's recurrent block and, within it, its LRU scan
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
SSM_SPANS = ("ssm.in_proj", "ssm.conv", "ssm.intra", "ssm.inter",
             "ssm.out_proj")
GRIFFIN_SPANS = ("griffin.rec", "griffin.lru")
ALL_SPANS = MOE_SPANS + SSM_SPANS + GRIFFIN_SPANS
SSM_CHECK_S = 200                # mamba2's float32 check: not a chunk multiple
GRIFFIN_LONG_S = 4096            # [lm:griffin]: 2 x 4096, the ring wraps
SMOKE_S = {MLA_ARCH: 64, GRIFFIN_ARCH: 40}   # the smoke configs card vs CPU
GRIFFIN_SMOKE_LAYERS = 5         # recurrentgemma's smoke: a group + 2 tail
# [train:griffin]: 3 g + 2 layers.  Full depth needs ~102 GB of float32
# parameters and gradients and bfloat16 moments; g = 2 (8 layers, 2.63 B
# parameters) peaked at 72.053 GiB on the card, over the ~70 GiB aimed
# at (the step's float32 logits of 4 x 2048 x 256000 and their gradient
# take ~25 GB), so g = 1: 5 layers, 2.04 B parameters, one group and the
# tail
GRIFFIN_TRAIN_GROUPS = 1
PREFILL_B, PREFILL_S = 8, 2048   # the [lm] prefill: 8 prompts of 2048
DECODE_STEPS = 64                # greedy steps from the prefill's cache
CHECK_B, CHECK_S = 2, 256        # the float32 prefill-vs-decode check
SERVE_REQUESTS = 16              # [serve:lm] requests, 16-48 prompt tokens
SERVE_DIR = os.path.join(ROOT, "build", "serve_wal")
LM_LAYERS = 32
# [train]: phi3-mini's heads for the gradient check, the full-width steps
FLASH_GRAD_SHAPE = (2, 512, 32, 32, 96)
TRAIN_B, TRAIN_S = 4, 2048       # a step's tokens (4 x 2048)
TRAIN_STEPS = 4
CHECK_LAYERS = 2                 # (c) card vs CPU and (d) the train loop
CHECK_TRAIN_S = 256              # (c): 1 x 256 tokens
DRIVER_B, DRIVER_S = 2, 512      # (d)
TRAIN_FAIL_AT = 5                # (d): checkpoint at 4, failure at 5
TRAIN_DIR = os.path.join(ROOT, "build", "train_ckpt")
# (c)'s bars: relative loss, gradient error over its leaf's largest
# |value|, updated parameters in units of the learning rate
# (measured on the card: 0, 1.17e-6, 0.0497 lr); a parameter may
# also round to the next float32 either side (at lr 1.5e-7 one ulp of the
# largest weights is 0.05 lr), so its bar adds one ulp.  AdamW's first
# step moves a parameter by lr g / (|g| + eps) of its clipped gradient g:
# where both sides' clipped gradients lie within NEAR_ZERO_EPS eps of 0,
# two gradients within the gradient bar may step up to 2 lr apart
# (mamba2-2.7b: 9.24e-9 against 5.25e-8 in one in_proj element, unclipped,
# 1.18 of the bar), so those elements are held to 2 lr and one ulp.
CARD_CPU_TOL = {"loss": 1e-6, "grad": 1e-5, "param": 0.1}
NEAR_ZERO_EPS = 2
# (d): the resumed loss against the clean run's, relative; the embedding's
# backward adds with atomics, so the two runs' weights differ in the last
# bits (measured: 7.7e-5)
DRIVER_TOL = 1e-3
# the optimizer of (b)-(d): the JAX package's AdamW (lr 3e-4) with
# bfloat16 moments, its choice for models whose float32 moments do not
# fit, warmed up over 2000 steps: 1.5e-7 at step 1.  Adam's first steps
# move every weight by ~lr, which moves phi3's loss by ~lr times the L1
# norm of its gradient: from lr 1e-4 at step 1, or after the default 100
# warmup steps, the loss rose back above 10 within 4 steps.
TRAIN_OPT_ARGS = dict(moment_dtype="bfloat16", warmup_steps=2000)
# [examples]: train_lm's steps (the reference's default is 300) and its
# checkpoints
EXAMPLE_TRAIN_STEPS = 60
EXAMPLE_CKPT = os.path.join(ROOT, "build", "example_train_ckpt")
# [roofline]: no step may beat its roofline by more than this share of
# its measured time, and the census's peak bytes must lie within PEAK_TOL
# of max_memory_allocated for the steps of PEAK_CHECKED; the production
# dry-run cell it also counts
ROOFLINE_SHARE_MAX = 1.05
PEAK_TOL = 0.25
PEAK_CHECKED = (("[lm]", "prefill"), ("[train]", "train"))
ROOFLINE_CELL = ("phi3-mini-3.8b", "train_4k", "single")
# [kernels:flash]: (name, (B, S, H, KV, D), dtype, options); "phi3" is
# phi3's prefill, the one timed with the bfloat16 kernel (and
# recurrentgemma's prefill beside it), "float32" the case timed with the
# float32 kernel, and the float32 cases after it hold that kernel to its
# bar on every path it has
_BF = torch.bfloat16
_F32 = torch.float32
FLASH_CASES = [
    ("phi3", (PREFILL_B, PREFILL_S, 32, 32, 96), _BF, {}),
    ("granite-moe prefill", (PREFILL_B, PREFILL_S, 24, 8, 64), _BF, {}),
    ("recurrentgemma prefill", (PREFILL_B, PREFILL_S, 16, 1, 256), _BF,
     dict(window=2048)),
    ("recurrentgemma 2 x 4096", (2, GRIFFIN_LONG_S, 16, 1, 256), _BF,
     dict(window=2048)),
    ("yi-34b GQA", (1, 1024, 56, 8, 128), _BF, {}),
    ("MQA window 64", (2, 1024, 16, 1, 128), _BF, dict(window=64)),
    ("softcap 50", (2, 1024, 32, 32, 96), _BF, dict(softcap=50.0)),
    ("ragged S=1000 D=256", (1, 1000, 16, 16, 256), _BF, {}),
    ("D=16", (2, 512, 16, 4, 16), _BF, {}),
    ("D=32", (2, 512, 16, 4, 32), _BF, {}),
    ("D=64", (2, 512, 16, 16, 64), _BF, {}),
    ("S=17", (4, 17, 32, 32, 96), _BF, {}),
    ("S=1", (8, 1, 32, 32, 96), _BF, {}),
    ("not causal", (2, 1024, 32, 32, 96), _BF, dict(causal=False)),
    ("unaligned views", (2, 300, 32, 32, 96), _BF, dict(unaligned=True)),
    ("float32", (2, 512, 32, 32, 96), _F32, {}),
    ("float32 granite-moe", (2, 512, 24, 8, 64), _F32, {}),
    ("float32 recurrentgemma", (CHECK_B, CHECK_S, 16, 1, 256), _F32,
     dict(window=2048)),
    ("float32 yi-34b GQA", (1, 1024, 56, 8, 128), _F32, {}),
    ("float32 MQA window 64", (2, 1024, 16, 1, 128), _F32, dict(window=64)),
    ("float32 softcap 50", (2, 1024, 32, 32, 96), _F32, dict(softcap=50.0)),
    ("float32 S=1000 D=16", (1, 1000, 16, 16, 16), _F32, {}),
    ("float32 S=1000 D=256", (1, 1000, 16, 16, 256), _F32, {}),
    ("float32 S=17", (4, 17, 32, 32, 96), _F32, {}),
    ("float32 S=1", (8, 1, 32, 32, 96), _F32, {}),
    ("float32 not causal", (2, 1024, 32, 32, 96), _F32, dict(causal=False)),
    ("float32 unaligned views", (2, 300, 32, 32, 96), _F32,
     dict(unaligned=True))]


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def busy_us(events, kernel: str = "") -> float:
    """The time the card spends in the device events (kernels, copies)
    among ``events`` whose name holds ``kernel``: the union of their
    intervals, so that grids that overlap (the bfloat16 flash kernel's
    two, one a programmatic dependent of the other) count once."""
    from torch.autograd import DeviceType
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events
                       if e.device_type == DeviceType.CUDA
                       and e.name not in ALL_SPANS and kernel in e.name):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_events(fn, iters: int, operators: bool = True, spans=None,
                  busy=None):
    """The device-side events (kernels, copies) of ``iters`` calls of
    ``fn``, from ``torch.profiler``, and the CPU-side operators (none
    unless ``operators``):
    ([(name, self device us, count)], [(operator, self device us, count)]).
    ``spans``: a dict of ``record_function`` names, whose values become
    the device us of the kernels within each (``operators`` on); the
    spans' own device-side ranges are left out of the events.  ``busy``:
    a dict of kernel-name parts, whose values become ``busy_us`` of the
    events whose name holds each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if operators else [])) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev, ops = [], []
    for e in prof.key_averages():
        if e.key in ALL_SPANS:
            if spans is not None and e.key in spans and \
                    e.device_type != DeviceType.CUDA:
                spans[e.key] = e.device_time_total
            continue
        row = (e.key, e.self_device_time_total, e.count)
        (dev if e.device_type == DeviceType.CUDA else ops).append(row)
    for kernel in busy or ():
        busy[kernel] = busy_us(prof.events(), kernel)
    return dev, ops


def device_ms(fn, iters: int, kernel: str = "", grids=None) -> float:
    """Mean device time per call of ``fn``: the time the card spends in
    the kernels whose name holds ``kernel`` (in all its device work
    without one), from the first grid's start to the last grid's end
    where grids overlap.  Free of the host's launch overhead, which the
    CUDA-event time of a launch loop includes; that time is the fallback
    where the profiler sees no device activity.  ``grids``: a dict that
    takes each such kernel's own time per call, by its short name (its
    template arguments, not its parameters), from the same calls."""
    busy = {kernel: 0.0}
    dev, _ = device_events(fn, iters, operators=False, busy=busy)
    if not busy[kernel]:
        log(f"[timing] the profiler saw no device time for "
            f"{kernel or 'the call'}: CUDA-event time of the launch loop")
        return time_ms(fn, iters)
    if grids is not None:
        grids.update({name.split("(")[0].removeprefix("void "):
                      t / iters / 1e3 for name, t, _ in dev if kernel in name})
    return busy[kernel] / iters / 1e3


# ---------------------------------------------------------------------------
# the least work the kernels must do, from this run's data
# ---------------------------------------------------------------------------

def _unique(x: torch.Tensor, n: int) -> int:
    x = x[(x >= 0) & (x < n)]
    return int(torch.unique(x).numel())


def descent_touch(levels, storage, q, fanout):
    """(distinct key bytes read by the descent, compares) for queries q.

    Bottom-up ``levels`` as on ``PIIndex.levels``: the top level is read
    whole, then one F-key child group per lower level and per storage;
    each distinct group is counted once.
    """
    from repro_torch.kernels.pi_search import gather_fill, sentinel_for
    sent = sentinel_for(storage.dtype)
    top = levels[-1] if levels else storage
    nbytes = 4 * top.numel()
    ops = q.numel() * top.numel()
    rank = (top[None, :] <= q[:, None]).sum(1) - 1
    pos = rank.clamp_min(0)
    lanes = torch.arange(fanout, device=q.device)
    for arr in list(levels[:-1])[::-1] + [storage]:
        n_groups = -(-arr.numel() // fanout)
        nbytes += 4 * fanout * _unique(pos, n_groups)
        ops += q.numel() * fanout
        ck = gather_fill(arr, pos[:, None] * fanout + lanes[None, :], sent)
        pos = pos * fanout + ((ck <= q[:, None]).sum(1) - 1).clamp_min(0)
    return nbytes, ops


def bound_reads(pending, q, right=False):
    """The pending slots the branchless bound reads for queries q (a flat
    index tensor), its result, and its compares per query."""
    from repro_torch.kernels.pi_search import gather_fill, sentinel_for
    n = pending.numel()
    sent = sentinel_for(pending.dtype)
    below = torch.le if right else torch.lt
    p2 = 1 << max(0, (n - 1).bit_length())
    count = torch.zeros_like(q, dtype=torch.int64)
    read = []
    step = p2 >> 1
    while step:
        cand = count + step
        read.append(cand - 1)
        count = torch.where(below(gather_fill(pending, cand - 1, sent), q),
                            cand, count)
        step >>= 1
    read.append(count)
    pos = (count + below(gather_fill(pending, count, sent), q)).clamp_max(n)
    return torch.cat(read), pos, len(read)


def lower_bound_touch(pending, q):
    """(distinct pending bytes read by the branchless lower bound, compares)."""
    n = pending.numel()
    read, ppos, steps = bound_reads(pending, q)
    read = torch.cat([read, ppos.clamp_max(n - 1)])
    return 4 * _unique(read, n), q.numel() * (steps + 2)


def range_touch(idx, tables, lo, hi, max_span):
    """(distinct bytes pi_range reads and writes, compares, lanes whose
    walk spends the whole budget) for this run's ranges.  Bytes: the
    descent's groups and the floor's rank entry, the walked ranks'
    dense2slot entries and slots' key/live/val entries (up to the first
    key above hi or the budget), the two bounds' pending keys and prefix
    entries, 16 B of bounds and outputs a lane.  Empty lanes (lo > hi)
    read only their bounds."""
    from repro_torch.kernels.pi_search import (gather_fill, pi_search_plain,
                                               sentinel_for)
    _, rank, d2s, _ = tables
    keys, F = idx.keys, idx.config.fanout
    C, PC = keys.numel(), idx.pkeys.numel()
    act = lo <= hi
    lo, hi = lo[act], hi[act]
    nbytes, ops = descent_touch(idx.levels, keys, lo, F)
    pos = pi_search_plain(keys, lo, fanout=F, levels=idx.levels).long()
    nbytes += 4 * _unique(pos, C)
    r0 = torch.where(pos >= 0, rank[pos.clamp(0, C - 1)].long(), 0)
    r = r0.clamp_min(0)[:, None] + torch.arange(max_span, device=lo.device)
    slot = gather_fill(d2s, r, C).long()
    ks = gather_fill(keys, slot, sentinel_for(keys.dtype))
    stop = (r >= C) | (slot >= C) | (ks > hi[:, None])
    walked = (torch.cumsum(stop, 1) - stop.long() == 0) & (r < C)
    read = walked & (slot < C)
    gated = read & (ks >= lo[:, None]) & (ks <= hi[:, None])
    nbytes += 4 * _unique(r[walked], C) + 4 * _unique(slot[read], C) + \
        8 * _unique(slot[gated], C)
    ops += 3 * int(walked.sum())
    pend, prefix = [], []
    for q, right in ((lo, False), (hi, True)):
        reads, pos_p, steps = bound_reads(idx.pkeys, q, right)
        pend.append(reads)
        prefix.append(pos_p)
        ops += q.numel() * (steps + 1)
    nbytes += 4 * _unique(torch.cat(pend), PC) + \
        8 * _unique(torch.cat(prefix), PC + 1)
    return nbytes + 16 * act.numel(), ops, int((walked.sum(1) ==
                                               max_span).sum())


def bound(nbytes: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def mixed_queries(rng, keys, extra, n, key_space):
    """Stored keys, duplicates, misses, keys below the minimum, sentinels."""
    kmax = np.iinfo(np.int32)
    stored = rng.choice(keys, n // 4)
    parts = [stored, stored[: n // 8], rng.choice(extra, n // 8),
             rng.integers(0, key_space, n // 4).astype(np.int32),
             np.array([keys.min() - 1, kmax.min, -1, 0], np.int32),
             np.full(8, kmax.max, np.int32)]
    q = np.concatenate(parts)
    q = np.concatenate([q, rng.integers(0, key_space, n - q.size)])
    return torch.from_numpy(rng.permutation(q).astype(np.int32)).to(DEVICE)


def empty_kernel_ms(iters: int) -> float:
    """Device time of an empty kernel (``launch_floor``), the least a
    launch of this card takes."""
    from repro_torch.kernels import bitonic_sort as KB
    lib = KB.load_library("bitonic_sort")
    return device_ms(
        lambda: lib.launch_floor(torch.cuda.current_stream().cuda_stream),
        iters, "launch_floor")


def check_kernels(idx, q, window_keys, tag, iters):
    """Each kernel against its plain version at these shapes, in int32 and
    float32, on q and on a window's keys sorted (as ``execute`` probes
    them); timings."""
    from repro_torch.kernels import pi_search as K
    F = idx.config.fanout
    lv, st, pk = idx.levels, idx.keys, idx.pkeys
    # float32 keys: the kernels' second instantiation, on the cast keys
    lvf, stf, pkf = tuple(x.float() for x in lv), st.float(), pk.float()
    sorted_q = torch.sort(window_keys).values

    def probe(lanes=q):
        return K.pi_probe(st, pk, lanes, fanout=F, levels=lv)

    def probe_plain():
        return K.pi_probe_plain(st, pk, q, fanout=F, levels=lv)

    def search(lanes=q):
        return K.pi_search(st, lanes, fanout=F, levels=lv)

    def search_plain():
        return K.pi_search_plain(st, q, fanout=F, levels=lv)

    pairs = []
    for sfx, keys, pend, levels, lanes in (
            ("", st, pk, lv, q), (" f32", stf, pkf, lvf, q.float()),
            (" sorted window", st, pk, lv, sorted_q),
            (" f32 sorted window", stf, pkf, lvf, sorted_q.float())):
        kw = dict(fanout=F, levels=levels)
        pairs += [("pi_probe" + sfx, K.pi_probe(keys, pend, lanes, **kw),
                   K.pi_probe_plain(keys, pend, lanes, **kw)),
                  ("pi_search" + sfx, (K.pi_search(keys, lanes, **kw),),
                   (K.pi_search_plain(keys, lanes, **kw),))]
    got = pairs[0][1]
    torch.cuda.synchronize()
    probe_err = search_err = 0
    for name, gs, ws in pairs:
        for a, b in zip(gs, ws):
            err = int((a.long() - b.long()).abs().max())
            if name.startswith("pi_probe"):
                probe_err = max(probe_err, err)
            else:
                search_err = max(search_err, err)
            assert torch.equal(a, b), f"{name} != plain ({tag})"
    hits = int(((got[0] >= 0) & ((got[2] & 1) > 0)).sum())
    p_hits = int(((got[2] & 2) > 0).sum())

    d_bytes, d_ops = descent_touch(lv, st, q, F)
    p_bytes, p_ops = lower_bound_touch(pk, q)
    B = q.numel()
    probe_bound = bound(d_bytes + p_bytes + 4 * B + 12 * B, d_ops + p_ops)
    search_bound = bound(d_bytes + 4 * B + 4 * B, d_ops)
    plain_iters = max(iters // 10, 5)
    t = dict(
        probe_ms=device_ms(probe, iters, "pi_probe_kernel"),
        probe_call_ms=time_ms(probe, iters),
        probe_plain_ms=device_ms(probe_plain, plain_iters),
        probe_plain_call_ms=time_ms(probe_plain, plain_iters),
        search_ms=device_ms(search, iters, "pi_search_kernel"),
        search_call_ms=time_ms(search, iters),
        search_plain_ms=device_ms(search_plain, plain_iters),
        search_plain_call_ms=time_ms(search_plain, plain_iters),
        probe_sorted_ms=device_ms(lambda: probe(sorted_q), iters,
                                  "pi_probe_kernel"),
        search_sorted_ms=device_ms(lambda: search(sorted_q), iters,
                                   "pi_search_kernel"),
        probe_one_query_ms=device_ms(lambda: probe(q[:1]), iters,
                                     "pi_probe_kernel"),
        empty_kernel_ms=empty_kernel_ms(iters),
        searchsorted_pending_ms=device_ms(
            lambda: torch.searchsorted(pk, q), iters))
    log(f"[kernels:{tag}] B={B} pn={int(idx.pn)} main hits={hits} "
        f"pending hits={p_hits}; pi_probe and pi_search equal to their "
        f"plain versions in int32 and float32 on these lanes and on a "
        f"window's {sorted_q.numel()} keys sorted: max_abs_err probe "
        f"{probe_err} search {search_err}; {d_bytes + p_bytes} B of keys "
        f"touched")
    for name in ("probe", "search"):
        b = probe_bound if name == "probe" else search_bound
        log(f"[kernels:{tag}] pi_{name}: device {t[name + '_ms']:.6f} ms "
            f"(per call with the host's launch {t[name + '_call_ms']:.6f}"
            f" ms), on the sorted window {t[name + '_sorted_ms']:.6f} ms "
            f"| plain version device {t[name + '_plain_ms']:.6f} ms "
            f"(per call {t[name + '_plain_call_ms']:.6f} ms) | bound "
            f"{b[0]:.6f} ms by {b[1]} | empty kernel "
            f"{t['empty_kernel_ms']:.6f} ms")
    log(f"[kernels:{tag}] pi_probe of one query: device "
        f"{t['probe_one_query_ms']:.6f} ms | empty kernel device "
        f"{t['empty_kernel_ms']:.6f} ms | bound {probe_bound[0]:.6f} ms | "
        f"partial yardstick (the pending half alone) searchsorted(pending):"
        f" device {t['searchsorted_pending_ms']:.6f} ms")
    return dict(t, probe_err=probe_err, search_err=search_err,
                probe_bound=probe_bound, search_bound=search_bound)


def range_queries(rng, keys, n, key_space):
    """(lo, hi) lanes: YCSB-E scans (1..100 records: spans of 1..6400 key
    units at 2^24 keys over 2^30), empty ranges (lo > hi), inert lanes
    (lo = sentinel, hi = 0), ranges from below the minimum, ranges up to
    INT_MAX - 1 and spans far beyond the ``max_span`` budget."""
    from repro_torch.kernels.pi_search import sentinel_for
    top = sentinel_for(torch.int32) - 1
    lo = np.concatenate([
        rng.choice(keys, n // 2).astype(np.int64),
        rng.integers(0, key_space, n // 4),
        rng.integers(0, key_space, 256),                        # lo > hi
        np.full(256, top + 1),                                  # inert
        np.iinfo(np.int32).min + rng.integers(0, 1 << 20, 64),  # below min
        rng.integers(key_space - (1 << 16), key_space, 64),     # to the top
        rng.integers(0, key_space, 256)])                       # budget
    m = lo.size - 896
    hi = np.concatenate([
        lo[:m] + rng.integers(1, 6401, m) - 1,
        lo[m:m + 256] - rng.integers(1, 1 << 16, 256),
        np.zeros(256, np.int64),
        keys.min() + rng.integers(0, 1 << 16, 64),
        np.full(64, top),
        lo[m + 640:] + rng.integers(1 << 18, 1 << 22, 256)])
    lo = np.concatenate([lo, rng.integers(0, key_space, n - lo.size)])
    hi = np.concatenate([hi, lo[hi.size:] + rng.integers(0, 6400,
                                                         n - hi.size)])
    order = rng.permutation(n)
    lo = np.clip(lo[order], np.iinfo(np.int32).min, top + 1)
    hi = np.clip(hi[order], np.iinfo(np.int32).min, top)
    return tuple(torch.from_numpy(x.astype(np.int32)).to(DEVICE)
                 for x in (lo, hi))


def ycsb_e_stream(ycfg, keys_np, n_windows, seed):
    """YCSB workload E: scanproportion 0.95, insertproportion 0.05, scan
    lengths uniform in 1..100 records (1..6400 key units at 2^24 keys over
    2^30), zipfian requests; ``n_windows`` windows' worth of arrivals."""
    import dataclasses
    from repro_torch.pipeline import ArrivalConfig, make_arrivals
    return make_arrivals(
        ArrivalConfig(process="poisson", rate=1e6,
                      n_arrivals=n_windows * ycfg.batch, range_frac=0.95,
                      span_min=1, span_max=6400, seed=seed),
        dataclasses.replace(ycfg, write_ratio=1.0), keys_np)


def ycsb_e_lanes(ycfg, keys_np, seed):
    """The (lo, hi) lanes ``execute_ranges`` gives ``pi_range`` for one
    window of the YCSB-E stream: its ranges, and inert lanes for its
    inserts."""
    from repro_torch.pipeline.ranges import _range_lanes
    st = ycsb_e_stream(ycfg, keys_np, 1, seed)
    return _range_lanes(*(torch.from_numpy(x[:ycfg.batch]).to(DEVICE)
                          for x in (st.ops, st.keys, st.keys2)), torch.int32)


def check_range_kernel(idx, lo, hi, tag, iters):
    """pi_range against its plain version at these shapes, bit for bit;
    device times of the kernel, of the plain version and of the tables a
    call builds (the keys-only ones come from ``KEY_TABLES``); the
    bound."""
    from repro_torch.core.engine import range_tables
    from repro_torch.kernels import pi_range as KR
    F = idx.config.fanout
    tables = range_tables(idx)
    live, rank, d2s, plive = tables
    args = (idx.keys, live, idx.vals, rank, d2s, idx.pkeys, idx.pvals,
            plive, lo, hi)

    def kernel():
        return KR.pi_range(*args, fanout=F, max_span=MAX_SPAN,
                           levels=idx.levels)

    def plain():
        return KR.pi_range_plain(*args, fanout=F, max_span=MAX_SPAN,
                                 levels=idx.levels)

    def build_tables():
        t = range_tables(idx)
        return KR.pending_prefix(idx.pvals, t[3])

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    for name, a, b in zip(("count", "sum"), got, want):
        assert torch.equal(a, b), f"pi_range {name} != plain ({tag})"
    cnt = want[0]
    n_tomb = int(idx.tomb.sum()), int((idx.ptomb & (torch.arange(
        idx.ptomb.numel(), device=DEVICE) < idx.pn)).sum())
    nbytes, ops, budget = range_touch(idx, tables, lo, hi, MAX_SPAN)
    rb = bound(nbytes, ops)
    plain_iters = max(iters // 10, 5)
    t = dict(ms=device_ms(kernel, iters, "pi_range_group_kernel"),
             call_ms=time_ms(kernel, iters),
             plain_ms=device_ms(plain, plain_iters),
             tables_ms=device_ms(build_tables, iters))
    log(f"[kernels:{tag}] pi_range: B={lo.numel()} pn={int(idx.pn)} "
        f"tombstones storage/pending {n_tomb}; empty lanes "
        f"{int((lo > hi).sum())}; keys counted {int(cnt.sum())}, walks "
        f"spending the budget {budget}; equal to the plain version, "
        f"max_abs_err {err}; {nbytes} B touched")
    log(f"[kernels:{tag}] pi_range: device {t['ms']:.6f} ms at "
        f"{KR.RANGE_GROUP} lanes a query (per call with the host's launch "
        f"{t['call_ms']:.6f} ms) | a call's live, plive and prefix "
        f"tables (rank, dense2slot held in KEY_TABLES): device "
        f"{t['tables_ms']:.6f} ms | plain version device "
        f"{t['plain_ms']:.6f} ms | bound {rb[0]:.6f} ms by {rb[1]}")
    assert int(cnt.sum()) > 0, "ranges too narrow"
    return dict(t, err=err, bound=rb, budget=budget)


def bitonic_bound(B: int):
    """The least time of a (key, value) sort of B int32 pairs: each pair
    read and written once; one compare-exchange for each pair of each of
    the network's log2(B)(log2(B)+1)/2 stages."""
    log_b = B.bit_length() - 1
    return bound(16 * B, log_b * (log_b + 1) // 2 * (B // 2))


def sweep_inputs(rng, B, dt, sent):
    """(name, keys, vals) of the size sweep at B lanes (numpy): ties, all
    equal, sorted, reversed, organ pipe, 1/8 sentinel keys, int32 limits in
    both lanes, and +-inf keys in float32."""
    i32 = np.iinfo(np.int32)
    ties = rng.integers(-B // 8, max(2, B // 4), B).astype(dt)
    asc = np.sort(ties)
    with_sent = ties.copy()
    with_sent[rng.random(B) < 0.125] = sent
    limits = np.array([i32.min, i32.min + 1, -1, 0, i32.max - 1, i32.max])
    cases = [("ties", ties, None), ("equal", np.full(B, 7, dt), None),
             ("sorted", asc, None), ("reversed", asc[::-1], None),
             ("organ pipe", np.concatenate([asc[::2], asc[1::2][::-1]]),
              None),
             ("sentinels", with_sent, None),
             ("limits", rng.choice(limits, B).astype(dt),
              rng.choice(limits, B).astype(np.int32))]
    if dt == np.float32:
        inf = ties.copy()
        inf[rng.random(B) < 0.25] = np.inf
        inf[rng.random(B) < 0.25] = -np.inf
        cases.append(("inf", inf, None))
    return [(name, k, rng.permutation(B).astype(np.int32) if v is None
             else v) for name, k, v in cases]


def sort_device(fn, iters):
    """(device ms, kernel launches) per call of ``fn``: the kernels whose
    name holds ``bitonic``."""
    dev, _ = device_events(fn, iters, operators=False)
    rows = [(t, n) for name, t, n in dev if "bitonic" in name]
    assert rows, "the profiler saw no bitonic kernel"
    return (sum(t for t, _ in rows) / iters / 1e3,
            sum(n for _, n in rows) / iters)


def check_bitonic(rng, window_keys, iters):
    """bitonic_sort against its plain version and the oracle on the card,
    bit for bit: a window's keys with arrival values, then random values
    with many ties, sorted, reversed, with sentinel and INT_MIN keys,
    float32 keys, and 2^15 and 2^20 pairs; then the size sweep, every
    B = 2^1 .. 2^22 in int32 and float32 on the inputs of
    ``sweep_inputs``, against ``bitonic_sort_ref`` and, up to 2^17, the
    plain version.  ``bitonic_argsort`` (the ``cuda`` engine's batch sort)
    against its plain version at the window and against
    ``torch.argsort(stable=True)`` at ragged B, and ``sort_queries_kernel``.
    Device times of the kernel, its plain version and ``torch.argsort`` on
    the window's keys; at each of ``BITONIC_SIZES`` the kernel's device
    time and launches a sort beside the argsort's, the bound, and the
    device time of an empty kernel (the launch floor)."""
    from repro_torch.core.engine import SearchEngine
    from repro_torch.kernels import bitonic_sort as KB
    from repro_torch.kernels.ops import sort_queries_kernel
    from repro_torch.kernels.ref import bitonic_sort_ref
    from repro_torch.kernels.pi_search import sentinel_for
    B = window_keys.numel()
    sent = sentinel_for(torch.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    def ties(n):
        return rng.integers(0, n // 4, n).astype(np.int32)

    def check(name, k, v, plain=True):
        got = KB.bitonic_sort(k, v)
        wants = [bitonic_sort_ref(k, v)] + \
            ([KB.bitonic_sort_plain(k, v)] if plain else [])
        torch.cuda.synchronize()
        err = 0
        for want, what in zip(wants, ("oracle", "plain")):
            as_int = [x.view(torch.int32).long() for x in got + want]
            err = max(err, max(int((a - b).abs().max()) for a, b in
                               zip(as_int[:2], as_int[2:])))
            for a, b, lane in zip(got, want, ("keys", "vals")):
                assert torch.equal(a, b), \
                    f"bitonic_sort {lane} != {what} ({name})"
        return err

    with_sent = ties(B)
    with_sent[rng.random(B) < 0.125] = sent
    with_sent[:16] = np.iinfo(np.int32).min
    floats = ties(B).astype(np.float32)
    floats[rng.random(B) < 0.125] = np.inf
    cases = [("window", window_keys, torch.arange(B, dtype=torch.int32,
                                                  device=DEVICE)),
             ("ties", dev(ties(B)), None),
             ("sorted", dev(np.sort(ties(B))), None),
             ("reversed", dev(np.sort(ties(B))[::-1]), None),
             ("sentinels", dev(with_sent), None),
             ("float32", dev(floats), None),
             ("2^15", dev(ties(1 << 15)), None),
             ("2^20", dev(ties(1 << 20)), None)]
    err = 0
    for name, k, v in cases:
        if v is None:
            v = dev(rng.permutation(k.numel()).astype(np.int32))
        err = max(err, check(name, k, v))
    n_sweep = 0
    for log_b in range(1, SWEEP_LOG_B + 1):
        for dt in (np.int32, np.float32):
            for name, k, v in sweep_inputs(rng, 1 << log_b, dt,
                                           sentinel_for(dt)):
                err = max(err, check(f"2^{log_b} {dt.__name__} {name}",
                                     dev(k), dev(v),
                                     plain=log_b <= SWEEP_PLAIN_LOG_B))
                n_sweep += 1
    keys = dev(with_sent[:8000])
    ops = torch.arange(8000, dtype=torch.int32, device=DEVICE)
    perm = SearchEngine("cuda").sort_queries(ops, keys, ops)[0]
    assert torch.equal(perm, torch.argsort(keys, stable=True)), \
        "cuda engine sort != stable argsort at B = 8000"
    assert torch.equal(KB.bitonic_argsort(window_keys),
                       KB.bitonic_argsort_plain(window_keys)), \
        "bitonic_argsort != its plain version at the window"
    ragged = tuple(n for n in (3, 100, 1000, 8191, 8193, 100_000,
                               1_000_000, (1 << 22) - 5)
                   if n < 1 << SWEEP_LOG_B)
    for n in ragged:
        for dt in (np.int32, np.float32):
            k = dev(sweep_inputs(rng, n, dt, sentinel_for(dt))[5][1])
            assert torch.equal(KB.bitonic_argsort(k),
                               torch.argsort(k, stable=True)), \
                f"bitonic_argsort != stable argsort at B = {n} ({dt})"
    perm32 = sort_queries_kernel(ops[:B // 2], keys[:B // 2], ops[:B // 2])[0]
    assert torch.equal(perm32.long(), torch.argsort(keys[:B // 2],
                                                    stable=True))

    v = cases[0][2]
    plain_iters = max(iters // 10, 5)
    ms, launches = sort_device(lambda: KB.bitonic_sort(window_keys, v), iters)
    t = dict(
        ms=ms,
        call_ms=time_ms(lambda: KB.bitonic_sort(window_keys, v), iters),
        argsort_ms=sort_device(lambda: KB.bitonic_argsort(window_keys),
                               iters)[0],
        plain_ms=device_ms(lambda: KB.bitonic_sort_plain(window_keys, v),
                           plain_iters),
        library_ms=device_ms(lambda: torch.argsort(window_keys, stable=True),
                             iters))
    floor_ms = empty_kernel_ms(iters)
    rb = bitonic_bound(B)
    log(f"[kernels:bitonic] {len(cases)} cases (B = {B}, 2^15, 2^20; int32 "
        f"and float32 keys), the size sweep ({n_sweep} cases, B = 2^1 .. "
        f"2^{SWEEP_LOG_B}, int32 and float32; against the plain version up "
        f"to 2^{SWEEP_PLAIN_LOG_B}), "
        f"bitonic_argsort at the window and at B = "
        f"{', '.join(map(str, ragged))}, the engine's batch sort at "
        f"B = 8000: bit-identical to the plain version, the oracle and the "
        f"stable argsort; max_abs_err {err}")
    log(f"[kernels:bitonic] bitonic_sort B={B}: device {t['ms']:.6f} ms in "
        f"{launches:g} launch (per call with the host's launch "
        f"{t['call_ms']:.6f} ms) | bitonic_argsort (the engine's call) "
        f"device {t['argsort_ms']:.6f} ms | plain version device "
        f"{t['plain_ms']:.6f} ms | torch.argsort(stable) device "
        f"{t['library_ms']:.6f} ms | bound {rb[0]:.6f} ms by {rb[1]} | "
        f"empty kernel device {floor_ms:.6f} ms")
    sizes = {}
    for n in BITONIC_SIZES:
        k = dev(ties(n))
        vn = dev(np.arange(n, dtype=np.int32))
        reps = iters if n <= 1 << 15 else 20
        ms, launches = sort_device(lambda: KB.bitonic_sort(k, vn), reps)
        lib_ms = device_ms(lambda: torch.argsort(k, stable=True), reps)
        bn = bitonic_bound(n)
        sizes[n] = (ms, launches, lib_ms)
        log(f"[kernels:bitonic] B=2^{n.bit_length() - 1}: device {ms:.6f} ms "
            f"in {launches:g} launches | torch.argsort(stable) device "
            f"{lib_ms:.6f} ms | bound {bn[0]:.6f} ms by {bn[1]} | empty "
            f"kernel {floor_ms:.6f} ms")
    return dict(t, err=err, bound=rb, floor_ms=floor_ms, sizes=sizes)


class Oracle:
    """The pre-window answer of every operation of a stream.

    ``RefIndex`` gives the point results.  ``RefIndex.range`` sorts the
    whole map on every call, far too slow at 2^24 keys, so ranges are
    answered from the initial keys as a sorted array with int64 prefix
    sums of their values, plus the same for the (few) keys the stream has
    changed since: per changed key, its change in count and in value.
    """

    def __init__(self, base, k0, v0):
        from repro_torch.core import RefIndex
        self.ref = RefIndex(dict(base))
        self.k0, self.v0 = k0, v0
        self.p0 = np.concatenate([[0], np.cumsum(v0)])
        self.delta = {}          # key -> (count change, value change)
        self.dk = np.zeros(0, np.int64)
        self.dc = self.ds = np.zeros(1, np.int64)

    def _base(self, keys):
        """(in the initial keys, initial value) per key."""
        pos = np.minimum(np.searchsorted(self.k0, keys), self.k0.size - 1)
        has = self.k0[pos] == keys
        return has, np.where(has, self.v0[pos], 0)

    def ranges(self, lo, hi):
        """(count, int32-wrapped sum) of the live keys in [lo, hi]."""
        cnt, sm = 0, 0
        for k, c, v in ((self.k0, None, self.p0),
                        (self.dk, self.dc, self.ds)):
            a = np.searchsorted(k, lo, side="left")
            b = np.maximum(np.searchsorted(k, hi, side="right"), a)
            cnt = cnt + (b - a if c is None else c[b] - c[a])
            sm = sm + v[b] - v[a]
        return cnt, (sm + 2 ** 31) % 2 ** 32 - 2 ** 31

    def execute(self, ops, keys, vals):
        """Apply a window's point ops; returns RefIndex's (found, val)."""
        from repro_torch.core import DELETE, INSERT
        res = self.ref.execute(ops, keys, vals)
        wk = np.unique(keys[(ops == INSERT) | (ops == DELETE)]) \
            .astype(np.int64)
        if wk.size:
            has, v0 = self._base(wk)
            for k, h, v in zip(wk.tolist(), has.tolist(), v0.tolist()):
                now = self.ref.data.get(k)
                change = (int(now is not None) - h,
                          (0 if now is None else now) - v)
                if change == (0, 0):
                    self.delta.pop(k, None)
                else:
                    self.delta[k] = change
            self.dk = np.array(sorted(self.delta), np.int64)
            ch = np.array([self.delta[k] for k in self.dk.tolist()],
                          np.int64).reshape(-1, 2)
            self.dc, self.ds = (np.concatenate([[0], np.cumsum(x)])
                                for x in ch.T)
        return (np.array([r is not None for r in res]),
                np.array([0 if r is None else r for r in res], np.int64))

    def live(self):
        """The live (key, value) pairs, sorted by key."""
        gone = np.isin(self.k0, self.dk)
        k = np.concatenate([self.k0[~gone], self.dk])
        v = np.concatenate([self.v0[~gone], np.array(
            [self.ref.data.get(x, 0) for x in self.dk.tolist()], np.int64)])
        keep = np.concatenate([np.ones((~gone).sum(), bool), np.array(
            [x in self.ref.data for x in self.dk.tolist()], bool)])
        order = np.argsort(k[keep], kind="stable")
        return k[keep][order], v[keep][order]


def check_stream(oracle, retired, tag):
    """Every window in retirement order: its RANGE results against the
    pre-window state, then its point results against ``RefIndex``."""
    from repro_torch.core import RANGE
    n_ranges = n_points = 0
    for k, res in enumerate(retired):
        w = res.window
        occ = w.occupancy
        ops, keys = w.ops[:occ], w.keys[:occ]
        is_r = ops == RANGE
        if is_r.any():
            cnt, sm = oracle.ranges(keys[is_r], w.keys2[:occ][is_r])
            assert np.array_equal(res.rcnt[:occ][is_r], cnt), \
                f"{tag} window {k}: RANGE count != pre-window oracle"
            assert np.array_equal(res.rsum[:occ][is_r], sm), \
                f"{tag} window {k}: RANGE sum != pre-window oracle"
            assert not res.rcnt[:occ][~is_r].any(), f"{tag} window {k}"
            n_ranges += int(is_r.sum())
        found, val = oracle.execute(ops, keys, w.vals[:occ])
        assert np.array_equal(res.found[:occ][~is_r], found[~is_r]), \
            f"{tag} window {k}: found != RefIndex"
        assert np.array_equal(res.val[:occ][~is_r].astype(np.int64),
                              val[~is_r]), f"{tag} window {k}: val != ref"
        n_points += int((~is_r).sum())
    return n_ranges, n_points


def serve(idx, stream, batch, metrics=None, **kw):
    """One stream through ``Dispatcher.run`` at depth 1 on the wall clock
    (``kw``: the sharded path's ``mesh`` and ``capacity_factor``); returns
    (dispatcher, retired windows, seconds)."""
    from repro_torch.pipeline import Dispatcher, WindowConfig
    disp = Dispatcher(idx, depth=1, max_span=MAX_SPAN, metrics=metrics,
                      clock=time.perf_counter, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if metrics is not None:
        metrics.start(t0)
    retired = disp.run(stream, WindowConfig(batch=batch),
                       clock=time.perf_counter)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if metrics is not None:
        metrics.stop(t1)
    return disp, retired, t1 - t0


def same_windows(a, b):
    fields = ("found", "val", "rcnt", "rsum", "rebuilt",
              "rebuilt_incremental", "pending_fill")
    return len(a) == len(b) and all(
        np.array_equal(getattr(x, f), getattr(y, f))
        for x, y in zip(a, b) for f in fields)


# the kernels' launch guards, and the windows' (one execute through the
# kernels, one range aggregation through pi_range)
KERNEL_GUARDS = ("pi_search", "pi_probe", "pi_range", "bitonic_sort",
                 "flash_attention_fwd")
WINDOW_GUARDS = ("core.execute", "pipeline.ranges")
_LAUNCH_BASE = {}


def guard_counts() -> dict:
    from repro_torch.analysis import launch_guard
    return {n: launch_guard(n).count() for n in KERNEL_GUARDS + WINDOW_GUARDS}


def reset_launches():
    """Set every count to 0: the guards' counts now become the base that
    ``launch_counts`` and ``expect_launches`` read from."""
    _LAUNCH_BASE.clear()
    _LAUNCH_BASE.update(guard_counts())


def launch_counts() -> dict:
    """Every kernel's launches since the last ``reset_launches``, read
    from the launch guards (``repro_torch.analysis.runtime``)."""
    now = guard_counts()
    return {n: now[n] - _LAUNCH_BASE.get(n, 0) for n in KERNEL_GUARDS}


def expect_launches(what: str, want: dict) -> None:
    """Each guard of ``want`` launched exactly its count since the last
    ``reset_launches``: the one-launch-a-window contract."""
    from repro_torch.analysis import launch_guard
    for name, n in want.items():
        launch_guard(name).expect(_LAUNCH_BASE.get(name, 0), n, what)


def window_launches(n_win: int, n_range_win: int, shards: int = 1) -> dict:
    """What a served run of ``n_win`` windows, ``n_range_win`` of them
    with a RANGE, launches on ``shards`` shards: each window's execute
    once a shard (one ``pi_probe``, one ``bitonic_sort`` of up to 8192
    pairs), its ranges once a shard, and no traverse."""
    return {"core.execute": shards * n_win, "pi_probe": shards * n_win,
            "bitonic_sort": shards * n_win, "pi_search": 0,
            "pipeline.ranges": shards * n_range_win,
            "pi_range": shards * n_range_win, "flash_attention_fwd": 0}


def run_pilint():
    """Phase [pilint]: the port's analyzer over its tree against the
    committed baseline, as ``python -m repro_torch.analysis src/repro_torch
    --baseline pilint-baseline.json`` runs it from the root.  Then the
    CLI's start-up, timed in a process of its own while the kernel checks
    run beside it (they keep one host core of 8 busy): the returned
    function waits for it, checks it and prints its time."""
    import contextlib
    import io
    import threading
    from repro_torch.analysis.cli import main as pilint_main
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.chdir(ROOT), contextlib.redirect_stdout(out):
        rc = pilint_main(["src/repro_torch", "--baseline",
                          "pilint-baseline.json"])
    t_lint = time.perf_counter() - t0
    report = out.getvalue()
    assert rc == 0, report
    summary = report.strip().splitlines()[-1]
    n = int(re.match(r"pilint: (\d+) finding", summary).group(1))
    log(f"[pilint] src/repro_torch against pilint-baseline.json: exit "
        f"{rc}, {n} finding(s) ({summary}) in {t_lint:.3f} s")

    cli = {}

    def list_rules():
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        try:
            cli["run"] = subprocess.run(
                [sys.executable, "-m", "repro_torch.analysis",
                 "--list-rules"], cwd=ROOT, env=env, check=True,
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            cli["error"] = e
        cli["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=list_rules)
    thread.start()

    def finish():
        thread.join()
        if "error" in cli:
            raise cli["error"]
        rules = [line.split()[0] for line in cli["run"].stdout.splitlines()]
        assert rules == [f"PI00{i}" for i in range(1, 7)], rules
        log(f"[pilint] the CLI (--list-rules, {len(rules)} rules) in a "
            f"process of its own: {cli['seconds']:.3f} s, most of it "
            f"importing torch")
    return finish


def profile_serving(idx, windows, window_ms, top=12):
    """Device time by kernel and by operator over windows through
    ``Dispatcher.submit`` (ranges + point execute), from ``torch.profiler``;
    the busy share is over ``window_ms``, the unprofiled mean window."""
    from repro_torch.pipeline import Dispatcher
    disp = Dispatcher(idx, depth=1, max_span=MAX_SPAN)
    it = iter(windows)
    dev, ops = device_events(lambda: disp.submit(next(it)), len(windows) - 1)
    disp.flush()
    n = len(windows) - 1
    busy = sum(t for _, t, _ in dev) / n / 1e3
    log(f"[profile:serve] {n} windows: device {busy:.6f} ms a window, "
        f"{100 * busy / window_ms:.2f}% of the unprofiled mean window "
        f"{window_ms:.6f} ms")
    rng_us = sum(t for name, t, _ in dev if "pi_range_group_kernel" in name)
    log(f"[profile:serve] pi_range: {rng_us / n / 1e3:.6f} ms a window, "
        f"{100 * rng_us / n / 1e3 / busy:.2f}% of its device time")
    for title, rows in (("kernel", dev), ("operator", ops)):
        for name, t, count in sorted(rows, key=lambda r: -r[1])[:top]:
            log(f"[profile:serve] {title} {t / n / 1e3:10.6f} ms a window "
                f"({count / n:.1f}x) {name[:90]}")


def run_main_path(idx0, batches, lookup_q):
    """The main path from ``idx0``: windows, rebuild, repack, reads.

    Returns the per-window outputs (on the host), the states after the
    windows / the rebuild / the repack, the read results and timings.
    """
    from repro_torch import core as pi
    from repro_torch.pipeline import step_single
    idx, outs, lat = idx0, [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for ops, keys, vals in batches:
        t0 = time.perf_counter()
        idx, found, val, ovf, due, incr, pn = step_single(idx, ops, keys, vals)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append((found, val, ovf, due, incr, pn))
    t_windows = time.perf_counter() - t_all
    after_windows = idx
    t0 = time.perf_counter()
    after_rebuild, incremental = pi.rebuild_tier(idx)
    torch.cuda.synchronize()
    t_rebuild = time.perf_counter() - t0
    t0 = time.perf_counter()
    after_repack = pi.repack(after_rebuild)
    torch.cuda.synchronize()
    t_repack = time.perf_counter() - t0
    found, val = pi.lookup(after_repack, lookup_q)
    floor = pi.traverse(after_repack, lookup_q)
    torch.cuda.synchronize()
    outs = [tuple(x.cpu().numpy() for x in o) for o in outs]
    return dict(outs=outs, lat=lat, t_windows=t_windows,
                t_rebuild=t_rebuild, t_repack=t_repack,
                incremental=incremental, states=(after_windows,
                                                 after_rebuild,
                                                 after_repack),
                reads=(found, val, floor))


def same_state(a, b) -> bool:
    """Two indexes equal leaf for leaf (a ``ShardedPIIndex``: its stacked
    shards and its fences)."""
    if hasattr(a, "fences"):
        return torch.equal(a.fences, b.fences) and \
            same_state(a.shards, b.shards)
    la, lb = a.leaves(), b.leaves()
    return all(
        len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))
        if isinstance(x, tuple) else torch.equal(x, y)
        for x, y in zip(la, lb))


def check_against_ref(ref, batches_np, run, q):
    """Every window's results, the live set after both rebuild tiers, and
    the reads, against the RefIndex oracle."""
    from repro_torch import core as pi
    for w, ((ops, ks, vs), out) in enumerate(zip(batches_np, run["outs"])):
        want = ref.execute(ops, ks, vs)
        found = np.array([r is not None for r in want])
        val = np.array([0 if r is None else r for r in want], np.int64)
        assert np.array_equal(out[0], found), f"window {w}: found != ref"
        assert np.array_equal(out[1].astype(np.int64), val), \
            f"window {w}: val != ref"
        assert not bool(out[2]), f"window {w}: pending overflow"
    rk = np.fromiter(ref.data.keys(), np.int64, len(ref.data))
    rv = np.fromiter(ref.data.values(), np.int64, len(ref.data))
    order = np.argsort(rk)
    rk, rv = rk[order], rv[order]
    for name, state in zip(("rebuild", "repack"), run["states"][1:]):
        k, v = pi.live_items(state)
        assert np.array_equal(k.astype(np.int64), rk), f"{name}: keys != ref"
        assert np.array_equal(v.astype(np.int64), rv), f"{name}: vals != ref"
        assert pi.validate_layout(state)
    found, val, floor = (x.cpu().numpy() for x in run["reads"])
    pos = np.searchsorted(rk, q, side="right") - 1
    hit = (pos >= 0) & (rk[np.clip(pos, 0, None)] == q)
    assert np.array_equal(found, hit), "lookup found != ref"
    assert np.array_equal(val[hit].astype(np.int64), rv[pos[hit]]), \
        "lookup val != ref"
    slots = run["states"][2].keys.cpu().numpy().astype(np.int64)
    below = floor < 0
    assert np.array_equal(below, pos < 0), "traverse underflow != ref"
    assert np.array_equal(slots[floor[~below]], rk[pos[~below]]), \
        "traverse floor key != ref"


def summarize(tag, run, batch):
    lat = np.array(run["lat"]) * 1e3
    n = len(lat)
    log(f"[main:{tag}] {n} windows in {run['t_windows']:.6f} s: "
        f"{n / run['t_windows']:.3f} windows/s, "
        f"{n * batch / run['t_windows']:.1f} ops/s, window latency "
        f"p50 {np.percentile(lat, 50):.6f} ms p99 "
        f"{np.percentile(lat, 99):.6f} ms; rebuild "
        f"({'incremental' if run['incremental'] else 'repack'}) "
        f"{run['t_rebuild'] * 1e3:.6f} ms; repack "
        f"{run['t_repack'] * 1e3:.6f} ms")


def profile_windows(idx, batches, window_ms, top=12):
    """Device time by kernel and by operator over windows through
    ``step_single``, from ``torch.profiler``.  The busy share divides the
    device time per window by ``window_ms``, the mean window latency of
    the run without the profiler (which slows the host)."""
    from repro_torch.pipeline import step_single
    it = iter(batches)

    def window():
        nonlocal idx
        idx = step_single(idx, *next(it))[0]

    dev, ops = device_events(window, len(batches) - 1)
    n = len(batches) - 1
    busy = sum(t for _, t, _ in dev) / n / 1e3
    log(f"[profile] {n} windows: device {busy:.6f} ms a window, "
        f"{100 * busy / window_ms:.2f}% of the unprofiled mean window "
        f"{window_ms:.6f} ms")
    for title, rows in (("kernel", dev), ("operator", ops)):
        for name, t, count in sorted(rows, key=lambda r: -r[1])[:top]:
            log(f"[profile] {title} {t / n / 1e3:10.6f} ms a window "
                f"({count / n:.1f}x) {name[:90]}")


def mixed_setup(cfg, keys_np, vals_np, ycfg):
    """The mixed stream (30 % scans, write ratio 0.5) and its index, with a
    pending capacity of MIXED_PC so that rebuilds run inside the stream."""
    import dataclasses
    from repro_torch import core as pi
    from repro_torch.pipeline import ArrivalConfig, make_arrivals
    idx_m = pi.build(dataclasses.replace(cfg, pending_capacity=MIXED_PC),
                     keys_np, vals_np, device=DEVICE)
    stream = make_arrivals(
        ArrivalConfig(process="poisson", rate=1e6,
                      n_arrivals=MIXED_WINDOWS * ycfg.batch, range_frac=0.3,
                      span_min=1, span_max=6400, seed=SEED + 2),
        ycfg, keys_np)
    return idx_m, stream


def run_serving(args, idx0, keys_np, ycfg, base, idx_m, mixed):
    """Phase 4: the YCSB-E stream and the ``mixed`` one (from ``idx_m``)
    through ``Dispatcher.run``, each checked against the pre-window
    oracle; the YCSB-E stream again with the ``torch`` backend.  Returns
    the YCSB-E run's launch counts."""
    from repro_torch import core as pi
    from repro_torch.pipeline import Collector, PipelineMetrics, WindowConfig
    B = ycfg.batch

    def ycsb_e(n_windows, seed):
        return ycsb_e_stream(ycfg, keys_np, n_windows, seed)

    for backend in ("cuda", "torch"):   # warm-up: first-call costs
        serve(pi.with_backend(idx0, backend), ycsb_e(2, SEED + 9), B)

    stream = ycsb_e(SERVE_WINDOWS, SEED)
    met = PipelineMetrics()
    reset_launches()
    disp, retired, wall = serve(idx0, stream, B, met)
    launches = launch_counts()
    n_win = len(retired)
    n_range_win = sum(r.rcnt is not None for r in retired)
    summ = met.summary()
    log(f"[serve:cuda] YCSB-E {len(stream)} arrivals in {n_win} windows "
        f"({n_range_win} with ranges) in {wall:.6f} s: "
        f"{len(stream) / wall:.1f} arrivals/s; latency p50 "
        f"{summ['p50_ms']:.6f} ms p99 {summ['p99_ms']:.6f} ms; "
        f"range_coalesce_hits {summ['range_coalesce_hits']}, range slots "
        f"{summ['range_slots']}, rebuilds {summ['rebuilds']}; kernel "
        f"launches {launches}")
    assert n_range_win > 0, launches
    expect_launches("[serve:cuda]", window_launches(n_win, n_range_win))

    col = Collector(WindowConfig(batch=B))
    t0 = time.perf_counter()
    for s in range(0, len(stream), B):
        col.offer_many(stream.t[s:s + B], stream.ops[s:s + B],
                       stream.keys[s:s + B], stream.vals[s:s + B],
                       np.arange(s, min(len(stream), s + B)),
                       stream.keys2[s:s + B])
    log(f"[serve:host] admission alone (Collector.offer_many, nothing "
        f"dispatched): {1e3 * B * (time.perf_counter() - t0) / len(stream):.6f}"
        f" ms for {B} arrivals")

    t0 = time.perf_counter()
    oracle = Oracle(*base)
    n_r, n_p = check_stream(oracle, retired, "YCSB-E")
    log(f"[serve:cuda] {n_r} RANGE results agree with the pre-window "
        f"oracle and {n_p} point results with RefIndex (checked in "
        f"{time.perf_counter() - t0:.3f} s)")
    del oracle

    tdisp, t_retired, t_wall = serve(pi.with_backend(idx0, "torch"), stream,
                                     B)
    log(f"[serve:torch] YCSB-E {len(stream)} arrivals in {t_wall:.6f} s: "
        f"{len(stream) / t_wall:.1f} arrivals/s")
    assert same_windows(retired, t_retired), "cuda and torch windows differ"
    assert same_state(disp.index, tdisp.index), "final states differ"
    log("[serve] cuda and torch backends bit-identical: every window's "
        "point and range results and the final state")
    del tdisp, t_retired

    if args.profile:
        extra = ycsb_e(args.profile + 1, SEED + 7)
        col = Collector(WindowConfig(batch=B))
        windows = col.offer_many(extra.t, extra.ops, extra.keys, extra.vals,
                                 np.arange(len(extra)), extra.keys2)[1]
        profile_serving(disp.index, windows[:args.profile + 1],
                        1e3 * wall / n_win)
    del disp, retired

    # a mixed stream on a small pending buffer: rebuilds inside the run
    stream = mixed
    met = PipelineMetrics()
    reset_launches()
    disp, retired, wall = serve(idx_m, stream, B, met)
    # the rebuilds inside the run launch nothing
    expect_launches("[serve:mixed]", window_launches(
        len(retired), sum(r.rcnt is not None for r in retired)))
    summ = met.summary()
    log(f"[serve:mixed] {len(stream)} arrivals (30 % scans, write ratio "
        f"0.5) in {len(retired)} windows in {wall:.6f} s, PC={MIXED_PC}: "
        f"rebuilds {summ['rebuilds']} ({summ['rebuilds_incremental']} "
        f"incremental), pending fill peak {summ['pending_fill_peak']:.4f}")
    assert summ["rebuilds"] >= 1, "no rebuild inside the mixed stream"
    oracle = Oracle(*base)
    n_r, n_p = check_stream(oracle, retired, "mixed")
    assert pi.validate_layout(disp.index)
    k, v = pi.live_items(disp.index)
    want_k, want_v = oracle.live()
    assert np.array_equal(k.astype(np.int64), want_k)
    assert np.array_equal(v.astype(np.int64), want_v)
    log(f"[serve:mixed] {n_r} RANGE and {n_p} point results agree with "
        f"the oracles across the rebuilds; the final live set equals "
        f"RefIndex's")
    return launches


class SimulatedCrash(RuntimeError):
    """Raised out of a fault point of the port to model the process dying
    there (the WAL writes are unbuffered, so the disk is left as a crash
    at that instruction leaves it)."""


def filesystem_of(path: str) -> str:
    """The type and mount point of the filesystem holding ``path``."""
    best = ("unknown", "")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[1]):
                best = (fstype, mnt)
    return f"{best[0]} at {best[1]}"


def copy_window(w):
    from repro_torch.pipeline import Window
    return Window(ops=w.ops.copy(), keys=w.keys.copy(), vals=w.vals.copy(),
                  occupancy=w.occupancy, qids=list(w.qids),
                  slots=w.slots.copy(), t_open=w.t_open,
                  t_enq=w.t_enq.copy(), trigger=w.trigger,
                  keys2=w.keys2.copy())


def _timed(fn, times):
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times.append(time.perf_counter() - t0)
        return out
    return call


def drive_durable(idx, stream, B, d, crash=None, hit=1, fresh=True, **kw):
    """``stream`` through ``Dispatcher.run`` (depth 1, ``kw`` to the
    dispatcher) with a ``Durability`` over ``d`` (per-window fsync, a
    snapshot every SNAPSHOT_EVERY windows), dying at the ``hit``-th pass of
    fault point ``crash`` when one is given (``fresh``: the directory
    removed first).  The collector's seal hook copies each
    window before the WAL sees it and records the acknowledged sequence
    numbers.  Returns a dict of the sealed copies, the acknowledged seqs,
    the dispatcher and the host times of appends, fsyncs and snapshots."""
    from repro_torch import faults
    from repro_torch.pipeline import (Collector, Dispatcher, Durability,
                                      WindowConfig)
    if fresh:     # a rank other than 0 leaves the directory to rank 0
        shutil.rmtree(d, ignore_errors=True)
    hits = [0]

    def hook(point):
        if point == crash:
            hits[0] += 1
            if hits[0] == hit:
                raise SimulatedCrash(point)

    out = dict(sealed=[], acked=[], append=[], fsync=[], snapshot=[],
               crashed=False)
    prev = faults.set_fault_hook(hook if crash else None)
    try:
        t0 = time.perf_counter()
        dur = Durability(d, idx, fsync="per_window",
                         snapshot_every=SNAPSHOT_EVERY)
        out["t_init"] = time.perf_counter() - t0
        dur.wal.sync = _timed(dur.wal.sync, out["fsync"])
        dur.snapshot = _timed(dur.snapshot, out["snapshot"])
        append = _timed(dur.on_seal, out["append"])

        def on_seal(win):
            out["sealed"].append(copy_window(win))
            out["acked"].append(append(win))

        disp = Dispatcher(idx, depth=1, max_span=MAX_SPAN, durability=dur,
                          **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            disp.run(stream, collector=Collector(WindowConfig(batch=B),
                                                 on_seal=on_seal))
            dur.close()
        except SimulatedCrash:
            out["crashed"] = True
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
    finally:
        faults.set_fault_hook(prev)
    if crash is not None:
        assert out["crashed"] and hits[0] == hit, \
            f"fault point {crash} was not reached"
    out["disp"] = disp
    return out


def stream_from(stream, start: int):
    """The arrivals of ``stream`` from position ``start`` on."""
    rest = type("Stream", (), {})()
    for name in ("t", "ops", "keys", "vals", "keys2"):
        setattr(rest, name, getattr(stream, name)[start:])
    return rest


def reference_states(idx, sealed, **kw):
    """The states of a dispatcher without durability over ``sealed``:
    the initial one, then one after each window (``kw``: the sharded
    path's mesh and capacity factor)."""
    from repro_torch.pipeline import Dispatcher
    states = [idx]
    plain = Dispatcher(idx, depth=0, max_span=MAX_SPAN, **kw)
    for w in sealed:
        plain.submit(copy_window(w))
        states.append(plain.index)
    return states


def crash_matrix(idx, stream, B, d, sealed, ref_states, tag, **kw):
    """A crash at each fault point, then ``recover``: the recovered
    windows hold every acknowledged one and the state equals the
    reference state after them.  Yields (point, recovered index, sealed
    windows, windows applied) after each point's checks."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.pipeline import recover
    for point in CRASH_POINTS:
        hit = 3 if point.startswith("wal.") else 2
        crash = drive_durable(idx, stream, B, d, crash=point, hit=hit, **kw)
        got = crash["sealed"]
        assert [w.qids for w in got] == [w.qids for w in sealed[:len(got)]]
        acked = crash["acked"][-1] if crash["acked"] else 0
        rec, tail = recover(d, device=DEVICE)
        step = CheckpointManager(os.path.join(d, "ckpt")).latest_step()
        n_applied = step + len(tail)
        assert acked <= n_applied <= len(got), (point, acked, n_applied)
        if point == "wal.mid_append":
            assert n_applied == acked, (point, acked, n_applied)
        if point.startswith("ckpt."):
            assert n_applied == acked == len(got), (point, acked, n_applied)
        assert same_state(rec, ref_states[n_applied]), point
        log(f"[{tag}] crash at {point} (pass {hit}): {len(got)} windows "
            f"sealed, {acked} acknowledged, snapshot {step} + "
            f"{len(tail)} replayed = {n_applied}; the state equals a "
            f"dispatcher without durability over those windows")
        yield point, rec, got, n_applied


def run_durable(idx_m, stream, B):
    """Phase 5: the durable path (see the module docstring).  Returns the
    crash-free durable run's launch counts."""
    from repro_torch import core as pi
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import RANGE
    from repro_torch.pipeline import (Dispatcher, Durability, WindowConfig,
                                      read_wal, record_window, recover)
    d = DURABLE_DIR
    os.makedirs(os.path.dirname(d), exist_ok=True)
    fs = filesystem_of(os.path.realpath(os.path.dirname(d)))
    n = len(stream.t)

    _, _, plain_wall = serve(idx_m, stream, B)
    reset_launches()
    run = drive_durable(idx_m, stream, B, d)
    launches = launch_counts()
    live = run["disp"].index
    sealed = run["sealed"]
    n_win = len(sealed)
    n_range_win = sum(bool((w.ops[:w.occupancy] == RANGE).any())
                      for w in sealed)
    assert n_range_win > 0, launches
    expect_launches("[durable]", window_launches(n_win, n_range_win))
    app, fsy = np.array(run["append"]) * 1e3, np.array(run["fsync"]) * 1e3
    wal_dir = os.path.join(d, "wal")
    wal_bytes = sum(os.path.getsize(os.path.join(wal_dir, f))
                    for f in os.listdir(wal_dir))
    snaps = run["snapshot"]
    log(f"[durable] {n} mixed arrivals in {n_win} windows through "
        f"Dispatcher.run with a Durability (fsync per_window, snapshot "
        f"every {SNAPSHOT_EVERY}) under {d} on {fs}: {n / run['wall']:.1f} "
        f"arrivals/s; the same stream without durability "
        f"{n / plain_wall:.1f} arrivals/s; kernel launches {launches}")
    log(f"[durable] WAL append a window: mean {app.mean():.6f} ms, p99 "
        f"{np.percentile(app, 99):.6f} ms ({len(app)} appends, each with "
        f"its fsync); fsync: mean {fsy.mean():.6f} ms, p99 "
        f"{np.percentile(fsy, 99):.6f} ms ({len(fsy)} fsyncs); WAL bytes "
        f"{wal_bytes}")

    ref_states = reference_states(idx_m, sealed)
    assert same_state(live, ref_states[-1]), "durability changed the state"

    # 1. crash-free: recover, and its two halves timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, tail = recover(d, device=DEVICE)
    torch.cuda.synchronize()
    t_recover = time.perf_counter() - t0
    assert rec.config.backend == "cuda" and same_state(rec, live), \
        "recover != the live state"
    ckpt = CheckpointManager(os.path.join(d, "ckpt"))
    step = ckpt.latest_step()
    snap_bytes = os.path.getsize(os.path.join(d, "ckpt", f"step_{step}",
                                              "host0.npz"))
    t0 = time.perf_counter()
    snap = ckpt.restore(step, pi.leaf_spec(live.config), device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay = Dispatcher(snap, depth=0, max_span=MAX_SPAN)
    for r in read_wal(os.path.join(d, "wal")):
        if r.seq > step:
            replay.submit(record_window(r))
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    assert same_state(replay.index, live)
    log(f"[durable] snapshots: initial {1e3 * run['t_init']:.6f} ms "
        f"(with opening the WAL), periodic {[round(1e3 * x, 6) for x in snaps]}"
        f" ms, {snap_bytes} B each (step {step}); recover "
        f"{1e3 * t_recover:.6f} ms for {len(tail)} replayed windows: load "
        f"{1e3 * t_load:.6f} ms, replay {1e3 * t_replay:.6f} ms (timed "
        f"apart)")
    meta_path = os.path.join(d, "durability.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["config"]["backend"] = "xla"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    rec_t, _ = recover(d, device=DEVICE)
    assert rec_t.config.backend == "torch" and same_state(rec_t, live), \
        "torch-backend recover != the live state"
    log("[durable] crash-free: recover equals the live state bit for bit, "
        "on the cuda and on the torch backend, and so does a dispatcher "
        "without durability over the same windows")
    del rec, rec_t, snap, replay

    # 2. a crash at each fault point; 3. resume after the first
    for point, rec, got, n_applied in crash_matrix(
            idx_m, stream, B, d, sealed, ref_states, "durable"):
        if point != "wal.mid_append":
            continue
        start = sum(w.n_arrivals for w in got[:n_applied])
        dur = Durability(d, rec, fsync="per_window",
                         snapshot_every=SNAPSHOT_EVERY)
        assert dur.wal.last_seq == n_applied
        resumed = Dispatcher(rec, depth=1, max_span=MAX_SPAN, durability=dur)
        resumed.run(stream_from(stream, start), WindowConfig(batch=B))
        dur.close()
        assert same_state(resumed.index, live), "resumed run != crash-free"
        again, _ = recover(d, device=DEVICE)
        assert same_state(again, live)
        log(f"[durable] resumed after the crash at {point}: a new "
            f"Durability over the recovered index took arrivals {start}.."
            f"{n - 1} to the crash-free state, and recover after it too")
        del resumed, again
    shutil.rmtree(d)
    return launches


# ---------------------------------------------------------------------------
# the sharded path: S fence-routed shards on the card; overload control
# ---------------------------------------------------------------------------

def shard_config(n_keys):
    """fig8_scalability's per-shard geometry for S shards of ``n_keys``
    keys: capacity 2N/S, pending capacity N/S/4, fanout 8."""
    from repro_torch import core as pi
    return pi.PIConfig(capacity=2 * n_keys // SHARDS,
                       pending_capacity=n_keys // SHARDS // 4, fanout=8,
                       backend="cuda")


def bucket_peak(windows, fences, cap):
    """The fullest send bucket of these windows' real queries, and whether
    any real query overflowed ``cap`` (the routing arithmetic of
    ``core.distributed`` on the host)."""
    sent = np.iinfo(np.int32).max
    peak = 0
    for w in windows:
        b = w.keys.shape[0] // SHARDS
        dest = np.clip(np.searchsorted(fences[1:-1], w.keys, side="right"),
                       0, SHARDS - 1)
        for s in range(SHARDS):
            d = dest[s * b:(s + 1) * b][w.keys[s * b:(s + 1) * b] != sent]
            peak = max(peak, int(np.bincount(d, minlength=SHARDS).max()))
    return peak


def check_shard_kernels(state, window, lo, hi):
    """The path's kernels at a shard's shapes, each against its plain
    version on the card: ``pi_probe`` and ``bitonic_argsort`` on the
    S * cap lanes shard 0 executes for ``window`` (its keys routed there,
    sentinel-padded), ``pi_range`` on (lo, hi) clipped to shard 0."""
    from repro_torch.core import shard_of
    from repro_torch.core.engine import range_tables
    from repro_torch.kernels import bitonic_sort as KB
    from repro_torch.kernels import pi_range as KR
    from repro_torch.kernels import pi_search as K
    shard = shard_of(state.shards, 0)
    F = shard.config.fanout
    f = state.fences.cpu().numpy()
    lanes = SHARDS * SHARD_CAP
    k = window.keys[(window.keys >= f[0]) & (window.keys < f[1])][:lanes]
    q = np.full(lanes, np.iinfo(np.int32).max, np.int32)
    q[:k.size] = k
    q = torch.from_numpy(q).to(DEVICE)
    got = K.pi_probe(shard.keys, shard.pkeys, q, fanout=F,
                     levels=shard.levels)
    want = K.pi_probe_plain(shard.keys, shard.pkeys, q, fanout=F,
                            levels=shard.levels)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), \
        "pi_probe != plain on a shard"
    perm = KB.bitonic_argsort(q)
    assert torch.equal(perm, KB.bitonic_argsort_plain(q)) and \
        torch.equal(perm, torch.argsort(q, stable=True)), \
        "bitonic_argsort != plain on a shard's lanes"
    slo = torch.maximum(lo, state.fences[0])
    shi = torch.minimum(hi, state.fences[1] - 1)
    live, rank, d2s, plive = range_tables(shard)
    args = (shard.keys, live, shard.vals, rank, d2s, shard.pkeys,
            shard.pvals, plive, slo, shi)
    rgot = KR.pi_range(*args, fanout=F, max_span=MAX_SPAN,
                       levels=shard.levels)
    rwant = KR.pi_range_plain(*args, fanout=F, max_span=MAX_SPAN,
                              levels=shard.levels)
    assert all(torch.equal(a, b) for a, b in zip(rgot, rwant)), \
        "pi_range != plain on a shard"
    log(f"[sharded:kernels] shard 0 (C={shard.config.capacity}): pi_probe "
        f"and bitonic_argsort on its {lanes} lanes of a window ({k.size} "
        f"real), pi_range on {lo.numel()} lanes clipped to its fences "
        f"({int(rwant[0].sum())} keys counted): each equal to its plain "
        f"version")


def point_windows(ycfg, keys_np, n_windows):
    """The first ``n_windows`` collector windows (coalescing on) of the
    point batches (write ratio 0.5, zipf 0.9)."""
    from repro_torch import data
    from repro_torch.pipeline import Collector, WindowConfig
    col = Collector(WindowConfig(batch=ycfg.batch))
    windows, w = [], 0
    while len(windows) < n_windows:
        ops, keys, vals = data.ycsb_batch(ycfg, keys_np, WINDOWS + 100 + w)
        B = ycfg.batch
        windows += col.offer_many(np.full(B, float(w)), ops, keys, vals,
                                  np.arange(w * B, (w + 1) * B))[1]
        w += 1
    return windows[:n_windows]


def run_point_windows(state, mesh, windows):
    """``windows`` one by one through a depth-0 sharded ``Dispatcher``:
    (retired windows, per-window latencies, seconds, final state)."""
    from repro_torch.pipeline import Dispatcher
    disp = Dispatcher(state, mesh=mesh, depth=0, max_span=MAX_SPAN,
                      capacity_factor=CAPACITY_FACTOR,
                      clock=time.perf_counter)
    retired, lat = [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for w in windows:
        t0 = time.perf_counter()
        retired += disp.submit(copy_window(w))
        lat.append(time.perf_counter() - t0)
    return retired, lat, time.perf_counter() - t_all, disp.index


def run_sharded(args, keys_np, vals_np, ycfg, base, single_p50_ms):
    """Phase [sharded] (see the module docstring).  Returns the launch
    counts of its point windows and its YCSB-E stream together, and what
    [mesh] holds its ranks to: the inputs, the initial state, each
    window's results and the digests of the states."""
    import dataclasses
    from repro_torch import core as pi
    from repro_torch.core import SEARCH
    from repro_torch.core.index import with_backend
    from repro_torch.pipeline import (Collector, DispatchOverflowError,
                                      Dispatcher, PipelineMetrics,
                                      WindowConfig)
    B = ycfg.batch
    cfg = shard_config(len(keys_np))
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = pi.build_sharded(cfg, SHARDS, keys_np, vals_np, device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    mesh = pi.make_mesh((SHARDS,), ("data",), device=DEVICE)
    fences = state.fences.cpu().numpy()
    _, cap = pi.make_sharded_executor(mesh, cfg, B // SHARDS,
                                      capacity_factor=CAPACITY_FACTOR)
    assert cap == SHARD_CAP, cap
    log(f"[sharded] S={SHARDS} shards of C={cfg.capacity} PC="
        f"{cfg.pending_capacity} F={cfg.fanout} W={cfg.seg_width_eff} "
        f"H={cfg.num_levels}, live keys {state.live_count().tolist()} (sum "
        f"{int(state.live_count().sum())}); built in {t_build:.3f} s, "
        f"{(torch.cuda.memory_allocated() - base_mem) / 2**20:.1f} MiB on "
        f"the card; windows of {B}, capacity factor {CAPACITY_FACTOR}: cap "
        f"{cap}, {SHARDS * cap} lanes a shard")

    windows = point_windows(ycfg, keys_np, SHARD_WINDOWS)
    lo, hi = ycsb_e_lanes(ycfg, keys_np, SEED + 5)
    check_shard_kernels(state, windows[0], lo, hi)
    _, _, load, dropped = pi.execute_sharded(
        state, mesh, *(torch.from_numpy(a).to(DEVICE) for a in
                       (windows[0].ops, windows[0].keys, windows[0].vals)),
        capacity_factor=CAPACITY_FACTOR)
    load = load.cpu().numpy()
    log(f"[sharded] a point window's load by shard {load.tolist()}, "
        f"imbalance {pi.load_imbalance(load):.6f}, dropped "
        f"{int(dropped.sum())}; the fullest send bucket over the "
        f"{SHARD_WINDOWS} windows holds {bucket_peak(windows, fences, cap)} "
        f"of {cap} real queries")

    # -- point windows through the sharded Dispatcher ----------------------
    for backend in ("cuda", "torch"):   # warm-up: first-call costs
        warm = dataclasses.replace(state, shards=with_backend(state.shards,
                                                              backend))
        run_point_windows(warm, mesh, windows[:2])
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    retired, lat, wall, after = run_point_windows(state, mesh, windows)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base_mem
    n_ops = sum(w.n_arrivals for w in windows)
    lat_ms = np.array(lat) * 1e3
    # what [mesh] holds its ranks to
    ref = dict(state=state, mesh=mesh, windows=windows, n_ops=n_ops,
               p50=float(np.percentile(lat_ms, 50)),
               points=window_results(retired),
               points_state=shard_digests(after))
    log(f"[sharded:cuda] {SHARD_WINDOWS} point windows ({n_ops} ops, "
        f"{sum(w.occupancy for w in windows)} slots) through the sharded "
        f"Dispatcher (depth 0) in {wall:.6f} s: {n_ops / wall:.1f} ops/s, "
        f"window latency p50 {np.percentile(lat_ms, 50):.6f} ms p99 "
        f"{np.percentile(lat_ms, 99):.6f} ms (the single shard's step: p50 "
        f"{single_p50_ms:.6f} ms); rebuilds "
        f"{sum(r.rebuilt for r in retired)}; kernel launches {launches}; "
        f"peak {peak / 2**20:.1f} MiB above the base")
    expect_launches("[sharded:cuda]",
                    window_launches(SHARD_WINDOWS, 0, SHARDS))
    counts = dict(launches)

    t0 = time.perf_counter()
    oracle = Oracle(*base)
    for k, res in enumerate(retired):
        w = res.window
        occ = w.occupancy
        found, val = oracle.execute(w.ops[:occ], w.keys[:occ],
                                    w.vals[:occ])
        assert np.array_equal(res.found[:occ], found), f"window {k}: found"
        assert np.array_equal(res.val[:occ].astype(np.int64), val), \
            f"window {k}: val != RefIndex"
    k_live, v_live = oracle.live()
    rebuilt = pi.rebuild_sharded(after)
    for tag, st in (("after the windows", after), ("rebuild_sharded",
                                                   rebuilt)):
        k, v = pi.collect_pairs(st)
        assert np.array_equal(k.astype(np.int64), k_live), tag
        assert np.array_equal(v.astype(np.int64), v_live), tag
    for s in range(SHARDS):
        assert pi.validate_layout(pi.shard_of(rebuilt.shards, s))
    log(f"[sharded:cuda] every window's results equal RefIndex's; "
        f"collect_pairs after the windows and after rebuild_sharded equal "
        f"its live set (checked in {time.perf_counter() - t0:.3f} s)")
    del oracle, rebuilt

    t_state = dataclasses.replace(state, shards=with_backend(state.shards,
                                                             "torch"))
    t_retired, t_lat, t_wall, t_after = run_point_windows(t_state, mesh,
                                                          windows)
    assert same_windows(retired, t_retired), "cuda and torch windows differ"
    assert same_state(after, t_after), "cuda and torch states differ"
    log(f"[sharded:torch] the same windows in {t_wall:.6f} s "
        f"({n_ops / t_wall:.1f} ops/s): results, flags and every stacked "
        f"leaf bit-identical to the cuda backend")
    del t_retired, t_after, t_state

    if args.profile:
        disp = Dispatcher(state, mesh=mesh, depth=0, max_span=MAX_SPAN,
                          capacity_factor=CAPACITY_FACTOR)
        extra = iter(copy_window(w) for w in windows[:args.profile + 1])
        dev, ops = device_events(lambda: disp.submit(next(extra)),
                                 args.profile)
        n = args.profile
        busy = sum(t for _, t, _ in dev) / n / 1e3
        p50 = np.percentile(lat_ms, 50)
        log(f"[profile:sharded] {n} windows: device {busy:.6f} ms a "
            f"window, {100 * busy / p50:.2f}% of the unprofiled p50 window "
            f"{p50:.6f} ms")
        for title, rows in (("kernel", dev), ("operator", ops)):
            for name, t, count in sorted(rows, key=lambda r: -r[1])[:12]:
                log(f"[profile:sharded] {title} {t / n / 1e3:10.6f} ms a "
                    f"window ({count / n:.1f}x) {name[:90]}")
    del after, retired

    # -- a YCSB-E stream through Dispatcher.run ----------------------------
    stream = ycsb_e_stream(ycfg, keys_np, SHARD_SERVE_WINDOWS, SEED + 3)
    kw = dict(mesh=mesh, capacity_factor=CAPACITY_FACTOR)
    for backend in ("cuda", "torch"):   # warm-up
        warm = dataclasses.replace(state, shards=with_backend(state.shards,
                                                              backend))
        serve(warm, ycsb_e_stream(ycfg, keys_np, 2, SEED + 9), B, **kw)
    met = PipelineMetrics()
    reset_launches()
    disp, retired, wall = serve(state, stream, B, met, **kw)
    e_launches = launch_counts()
    n_win = len(retired)
    n_range_win = sum(r.rcnt is not None for r in retired)
    summ = met.summary()
    log(f"[sharded:serve] YCSB-E {len(stream)} arrivals in {n_win} windows "
        f"({n_range_win} with ranges) in {wall:.6f} s: "
        f"{len(stream) / wall:.1f} arrivals/s; latency p50 "
        f"{summ['p50_ms']:.6f} ms p99 {summ['p99_ms']:.6f} ms; kernel "
        f"launches {e_launches}")
    assert n_range_win > 0, e_launches
    expect_launches("[sharded:serve]",
                    window_launches(n_win, n_range_win, SHARDS))
    for name in counts:
        counts[name] += e_launches[name]
    ref.update(stream_in=stream, n_arrivals=len(stream),
               stream=window_results(retired),
               stream_state=shard_digests(disp.index))
    oracle = Oracle(*base)
    n_r, n_p = check_stream(oracle, retired, "sharded YCSB-E")
    del oracle
    tdisp, t_retired, t_wall = serve(
        dataclasses.replace(state, shards=with_backend(state.shards,
                                                       "torch")),
        stream, B, **kw)
    assert same_windows(retired, t_retired), "cuda and torch windows differ"
    assert same_state(disp.index, tdisp.index), "final states differ"
    log(f"[sharded:serve] {n_r} RANGE results agree with the pre-window "
        f"oracle and {n_p} point results with RefIndex; the torch backend "
        f"({len(stream) / t_wall:.1f} arrivals/s) bit-identical")
    del disp, tdisp, retired, t_retired

    # -- a skewed burst re-cuts the fences ---------------------------------
    rng = np.random.default_rng(SEED + 13)
    sorted_keys = np.sort(keys_np)
    ranks = np.minimum((len(keys_np) * rng.random(B) ** 2).astype(np.int64),
                       len(keys_np) - 1)     # zipfian, theta 0.5, unscrambled
    burst = [torch.from_numpy(a).to(DEVICE) for a in (
        np.full(B, SEARCH, np.int32), sorted_keys[ranks],
        np.zeros(B, np.int32))]
    _, (found, _), load, dropped = pi.execute_sharded(
        state, mesh, *burst, capacity_factor=SHARDS)
    assert bool(found.all()) and int(dropped.sum()) == 0
    load = load.cpu().numpy()
    f2 = pi.rebalance_from_load(fences, load, smoothing=1.0, key_lo=0,
                                key_hi=ycfg.key_space)
    t0 = time.perf_counter()
    kk, vv = pi.collect_pairs(state)
    state2 = pi.build_sharded(cfg, SHARDS, kk, vv, fences=f2, device=DEVICE)
    torch.cuda.synchronize()
    t_reshard = time.perf_counter() - t0
    _, (found2, _), load2, _ = pi.execute_sharded(
        state2, mesh, *burst, capacity_factor=SHARDS)
    assert bool(found2.all())
    load2 = load2.cpu().numpy()
    i1, i2 = pi.load_imbalance(load), pi.load_imbalance(load2)
    log(f"[sharded:rebalance] a zipfian burst (theta 0.5 over the key "
        f"order) of {B} searches: load by shard {load.tolist()}, imbalance "
        f"{i1:.6f}; fences re-cut by rebalance_from_load, the index "
        f"rebuilt on them in {t_reshard:.3f} s: load {load2.tolist()}, "
        f"imbalance {i2:.6f}")
    assert i2 < i1, (i1, i2)
    ref.update(burst=[a.cpu().numpy() for a in burst], burst_load=load,
               fences2=f2, load2=load2, recut_state=shard_digests(state2))
    del state2, kk, vv

    # -- routing drops: real ones raise, padding does not ------------------
    tight = Dispatcher(state, mesh=mesh, depth=0, capacity_factor=0.25)
    try:
        tight.submit(copy_window(windows[0]))
        raise AssertionError("a window over capacity did not raise")
    except DispatchOverflowError as e:
        log(f"[sharded:drops] capacity factor 0.25 (cap "
            f"{pi.make_sharded_executor(mesh, cfg, B // SHARDS, capacity_factor=0.25)[1]}"
            f"): {e.args[0][:60]}...")
    col = Collector(WindowConfig(batch=B))
    few = keys_np[:8]
    for i, k in enumerate(few):
        assert col.offer(float(i), SEARCH, int(k), 0, i)
    (res,) = Dispatcher(state, mesh=mesh, depth=0,
                        capacity_factor=0.25).submit(col.take())
    assert res.per_arrival() == {i: (True, int(vals_np[i]))
                                 for i in range(8)}
    log(f"[sharded:drops] a window of 8 searches and {B - 8} pads at the "
        f"same capacity: pads dropped, no error, every result right")

    # -- durability of the sharded kind ------------------------------------
    run_sharded_durable(state, mesh, ycfg, keys_np, B)
    return counts, ref


def run_sharded_durable(state, mesh, ycfg, keys_np, B):
    """The sharded kind of durability: the mixed stream (SHARD_DURABLE
    windows' worth) with a ``Durability``; ``recover`` after a clean close
    and after a crash at each fault point equals a sharded dispatcher
    without durability over the recovered windows, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.pipeline import recover
    d = DURABLE_DIR + "_sharded"
    os.makedirs(os.path.dirname(d), exist_ok=True)
    stream = durable_stream(ycfg, keys_np, B)
    kw = dict(mesh=mesh, capacity_factor=CAPACITY_FACTOR)
    run = drive_durable(state, stream, B, d, **kw)
    live, sealed = run["disp"].index, run["sealed"]
    ref_states = reference_states(state, sealed, **kw)
    assert same_state(live, ref_states[-1]), "durability changed the state"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, tail = recover(d, device=DEVICE)
    torch.cuda.synchronize()
    t_recover = time.perf_counter() - t0
    assert rec.n_shards == SHARDS and same_state(rec, live), \
        "recover != the live sharded state"
    step = CheckpointManager(os.path.join(d, "ckpt")).latest_step()
    snap_bytes = os.path.getsize(os.path.join(d, "ckpt", f"step_{step}",
                                              "host0.npz"))
    log(f"[sharded:durable] {len(sealed)} windows with a Durability "
        f"(kind sharded, {SHARDS} shards): {len(stream.t) / run['wall']:.1f}"
        f" arrivals/s; snapshots {[round(1e3 * x, 6) for x in run['snapshot']]}"
        f" ms of {snap_bytes} B; recover {1e3 * t_recover:.6f} ms "
        f"(snapshot {step} + {len(tail)} windows) equals the live state bit "
        f"for bit")
    del rec
    for _ in crash_matrix(state, stream, B, d, sealed, ref_states,
                          "sharded:durable", **kw):
        pass
    shutil.rmtree(d)


# ---------------------------------------------------------------------------
# [mesh]: the fence-sharded index and the shard_map parts across ranks
# ---------------------------------------------------------------------------

def shard_digests(state) -> dict:
    """``(leaf, global shard) -> sha256`` of every leaf's slice of each
    shard this process holds (``PIIndex.tree_flatten`` order), and the
    fences' digest under ``("fences", -1)``."""
    import hashlib
    from repro_torch.core import index as tpi
    out = {}
    for i, x in enumerate(tpi.flat_leaves(state.shards)):
        host = x.cpu().numpy()
        for j in range(host.shape[0]):
            out[(i, state.first + j)] = hashlib.sha256(
                np.ascontiguousarray(host[j]).tobytes()).hexdigest()
    out[("fences", -1)] = hashlib.sha256(
        state.fences.cpu().numpy().tobytes()).hexdigest()
    return out


def window_results(retired) -> list:
    """The host arrays of retired windows that the ranks must reproduce."""
    return [tuple(getattr(r, f) for f in ("found", "val", "rcnt", "rsum"))
            + (r.rebuilt, r.rebuilt_incremental, r.pending_fill)
            for r in retired]


def same_results(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None) or np.array_equal(x, y)
        for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def durable_stream(ycfg, keys_np, B):
    """The mixed stream of the sharded durable paths (SHARD_DURABLE
    windows' worth, 30 % scans)."""
    from repro_torch.pipeline import ArrivalConfig, make_arrivals
    return make_arrivals(
        ArrivalConfig(process="poisson", rate=1e6,
                      n_arrivals=SHARD_DURABLE * B, range_frac=0.3,
                      span_min=1, span_max=6400, seed=SEED + 4),
        ycfg, keys_np)


def state_after(idx, stream, B, n, **kw):
    """The state of a depth-0 dispatcher without durability after the
    first ``n`` windows the collector seals from ``stream``."""
    import types
    from repro_torch.pipeline import Dispatcher, WindowConfig
    seen, got = [0], [idx if n == 0 else None]

    def on_seal(w):
        seen[0] += 1
        w.seq = seen[0]
        return w.seq

    def maybe_snapshot(index, seq):
        if seq == n:
            got[0] = index

    hook = types.SimpleNamespace(on_seal=on_seal,
                                 maybe_snapshot=maybe_snapshot,
                                 record_capacity_factor=lambda cf: None)
    Dispatcher(idx, depth=0, max_span=MAX_SPAN, durability=hook,
               **kw).run(stream, WindowConfig(batch=B))
    assert got[0] is not None, (n, seen[0])
    return got[0]


def mesh_rank(rank, world, backend, tmp, programs):
    """One rank of ``[mesh]`` (a top-level function: ``spawn`` imports
    this file anew in every rank).  Joins the process group through a
    ``FileStore`` under ``tmp``, runs ``programs`` on the card and writes
    its results to ``tmp/<backend>-rank<r>.pkl``."""
    import datetime
    import faulthandler
    import pickle
    import torch.distributed as tdist
    faulthandler.enable()          # a rank that crashes prints its stack
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=MESH_PG_TIMEOUT)
    store = tdist.FileStore(os.path.join(tmp, f"store-{backend}-{world}"),
                            world)
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world, timeout=timeout)
    out = {}
    try:
        from repro_torch.launch import mesh as lmesh
        dm = lmesh.make_mesh((world,), ("data",), device_type=DEVICE,
                             timeout=timeout)
        if "index" in programs:
            out.update(mesh_index(rank, dm, tmp, "durable" in programs))
        if "moe" in programs:
            out["moe"] = mesh_moe(lmesh.make_mesh(
                (2, world // 2), ("data", "model"), device_type=DEVICE,
                timeout=timeout))
        if "psum" in programs:
            out["psum"] = mesh_psum(rank, lmesh.make_mesh(
                (world,), ("pod",), device_type=DEVICE, timeout=timeout))
        if "pipe" in programs:
            out["pipe"] = mesh_pipe(lmesh.make_mesh(
                (world,), ("stage",), device_type=DEVICE, timeout=timeout))
        lm = [p for p in programs if p.startswith("lm_")]
        if lm:
            out.update(mesh_lm(rank, world, lm, tmp, timeout))
        torch.cuda.synchronize()
        with open(os.path.join(tmp, f"{backend}-rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        tdist.destroy_process_group()


def mesh_index(rank, dm, tmp, durable):
    """[sharded]'s windows, YCSB-E stream and fence re-cut on this rank's
    shards; with ``durable`` the mixed stream with a ``Durability`` and a
    crash at ``MESH_CRASH``."""
    import pickle
    from repro_torch import core as pi
    from repro_torch.pipeline import PipelineMetrics
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    keys_np = np.load(os.path.join(tmp, "keys.npy"))
    vals_np = np.load(os.path.join(tmp, "vals.npy"))
    B = inp["B"]
    cfg = shard_config(len(keys_np))
    mesh = pi.make_mesh((SHARDS,), ("data",), device=DEVICE, device_mesh=dm)
    t0 = time.perf_counter()
    state = pi.build_sharded(cfg, SHARDS, keys_np, vals_np, mesh=mesh)
    torch.cuda.synchronize()
    out = dict(t_build=time.perf_counter() - t0,
               shards=list(range(state.first,
                                 state.first + state.shards.keys.shape[0])))
    windows = inp["windows"]
    run_point_windows(state, mesh, windows[:2])       # warm-up
    reset_launches()
    retired, lat, wall, after = run_point_windows(state, mesh, windows)
    out["point_launches"] = launch_counts()
    out["points"] = window_results(retired)
    out["lat"], out["wall"] = lat, wall
    out["points_state"] = shard_digests(after)
    del retired, after

    kw = dict(mesh=mesh, capacity_factor=CAPACITY_FACTOR)
    met = PipelineMetrics()
    reset_launches()
    disp, retired, wall = serve(state, inp["stream"], B, met, **kw)
    out["stream_launches"] = launch_counts()
    out["stream"] = window_results(retired)
    out["stream_wall"] = wall
    out["stream_state"] = shard_digests(disp.index)
    del disp, retired

    burst = [torch.from_numpy(a).to(DEVICE) for a in inp["burst"]]
    _, (found, _), load, dropped = pi.execute_sharded(
        state, mesh, *burst, capacity_factor=SHARDS)
    assert bool(found.all()) and int(dropped.sum()) == 0
    load = load.cpu().numpy()
    f2 = pi.rebalance_from_load(state.fences.cpu().numpy(), load,
                                smoothing=1.0, key_lo=0,
                                key_hi=inp["key_space"])
    kk, vv = pi.collect_pairs(state)
    state2 = pi.build_sharded(cfg, SHARDS, kk, vv, fences=f2, mesh=mesh)
    _, (found2, _), load2, _ = pi.execute_sharded(
        state2, mesh, *burst, capacity_factor=SHARDS)
    assert bool(found2.all())
    out.update(burst_load=load, fences2=f2, load2=load2.cpu().numpy(),
               recut_state=shard_digests(state2))
    del state2, kk, vv

    if durable:
        reset_launches()
        run = drive_durable(state, inp["durable_stream"], B,
                            os.path.join(tmp, "durable"), crash=MESH_CRASH[0],
                            hit=MESH_CRASH[1], fresh=rank == 0, **kw)
        out["durable_launches"] = launch_counts()
        out["durable"] = dict(sealed=len(run["sealed"]), acked=run["acked"],
                              wall=run["wall"])
    return out


def moe_weights(cfg, seed):
    """granite-moe's expert layer at full width and MESH_MOE_B x
    MESH_MOE_S tokens' activations, float32, from a CPU generator (the
    same on every rank)."""
    g = torch.Generator().manual_seed(seed)
    d, f, Ep = cfg.d_model, cfg.d_ff_expert, cfg.experts_padded

    def draw(*shape, fan):
        return (torch.randn(shape, generator=g) / fan ** 0.5).to(DEVICE)

    p = dict(router=draw(d, cfg.n_experts, fan=d),
             w_gate=draw(Ep, d, f, fan=d), w_up=draw(Ep, d, f, fan=d),
             w_down=draw(Ep, f, d, fan=f))
    x = torch.randn((MESH_MOE_B, MESH_MOE_S, d), generator=g).to(DEVICE)
    return p, x


def mesh_moe(dm):
    """``moe_apply_shardmap`` on a (2, 2) ("data", "model") mesh."""
    import dataclasses
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              moe_capacity=MESH_MOE_CF)
    p, x = moe_weights(cfg, SEED + 21)
    with shd.use_mesh(dm):
        y, lb = moe.moe_apply_shardmap(cfg, p, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe.moe_apply_shardmap(cfg, p, x)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return dict(y=y.cpu().numpy(), lb=lb.item(), ms=ms)


def psum_inputs(world):
    g = torch.Generator().manual_seed(SEED + 22)
    return (torch.randn((world, MESH_PSUM_N), generator=g),
            1e-3 * torch.randn((world, MESH_PSUM_N), generator=g))


def mesh_psum(rank, dm):
    from repro_torch import optim
    from repro_torch import sharding as shd
    x, err = psum_inputs(dm.size())
    with shd.use_mesh(dm):
        mean, new_err = optim.compressed_psum(x[rank].to(DEVICE), "pod",
                                              err[rank].to(DEVICE))
    q, scale = optim.quantize_int8(x[rank].to(DEVICE) + err[rank].to(DEVICE))
    return dict(mean=mean.cpu().numpy(), err=new_err.cpu().numpy(),
                q=q.cpu().numpy(), scale=scale.item())


def pipe_inputs():
    g = torch.Generator().manual_seed(SEED + 23)
    L, M, mb, d = MESH_PIPE["L"], MESH_PIPE["M"], MESH_PIPE["mb"], \
        MESH_PIPE["d"]
    return (torch.randn((L, d, d), generator=g) / d ** 0.5,
            torch.randn((M, mb, d), generator=g))


def pipe_stage(p_stage, h):
    for w in p_stage:
        h = torch.tanh(h @ w)
    return h


def mesh_pipe(dm):
    from repro_torch.models.pipeline import pipelined_forward, stage_split
    W, x = (t.to(DEVICE) for t in pipe_inputs())
    return pipelined_forward(dm, "stage", pipe_stage,
                             stage_split(W, dm.size()), x).cpu().numpy()


def spawn_ranks(world, backend, tmp, programs):
    """``world`` ranks of ``mesh_rank`` (``torch.multiprocessing``,
    spawned); a rank that raises fails the others and the phase, and
    ranks alive after ``MESH_TIMEOUT`` seconds are killed and fail it.
    Returns each rank's results."""
    import pickle
    import torch.multiprocessing as mp
    ctx = mp.start_processes(mesh_rank, args=(world, backend, tmp, programs),
                             nprocs=world, join=False, start_method="spawn")
    t_end = time.perf_counter() + MESH_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() > t_end:
                raise RuntimeError(f"[mesh] {world} {backend} ranks alive "
                                   f"after {MESH_TIMEOUT} s: a rank hangs")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"{backend}-rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def check_mesh_index(tag, ref, outs):
    """Every rank's windows, stream and re-cut against [sharded]'s one
    process: results bit for bit on every rank, state digests by shard;
    launch counts: each rank's shards, once a window."""
    P = len(outs)
    for name in ("points", "stream"):
        for r, o in enumerate(outs):
            assert same_results(o[name], ref[name]), \
                f"{tag} rank {r}: {name} results != [sharded]'s"
    for name in ("points_state", "stream_state", "recut_state"):
        got = {}
        for o in outs:
            got.update(o[name])
        assert got == ref[name], f"{tag}: {name} digests != [sharded]'s"
    for r, o in enumerate(outs):
        for name in ("burst_load", "fences2", "load2"):
            assert np.array_equal(o[name], ref[name]), f"{tag} {name}"
    L = SHARDS // P
    n_range = sum(w[2] is not None for w in ref["stream"])
    for r, o in enumerate(outs):
        pl, sl = o["point_launches"], o["stream_launches"]
        assert pl["pi_probe"] == pl["bitonic_sort"] == L * SHARD_WINDOWS \
            and pl["pi_range"] == 0, (tag, r, pl)
        assert sl["pi_probe"] == sl["bitonic_sort"] == L * len(ref["stream"])\
            and sl["pi_range"] == L * n_range > 0, (tag, r, sl)
        log(f"{tag} rank {r} (shards {o['shards']}): kernel launches on the "
            f"point windows {pl}, on the YCSB-E stream {sl}")
    lat = np.array(outs[0]["lat"]) * 1e3
    n_ops = ref["n_ops"]
    return dict(p50=float(np.percentile(lat, 50)),
                p99=float(np.percentile(lat, 99)),
                ops_s=n_ops / outs[0]["wall"],
                stream_s=ref["n_arrivals"] / outs[0]["stream_wall"])


def run_mesh(ref, keys_np, vals_np, ycfg):
    """Phase [mesh] (see the module docstring).  Returns the kernel
    launches of the ranks' main paths, summed over the ranks."""
    import pickle
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.pipeline import recover
    B = ycfg.batch
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh-", dir=build_dir)
    counts = {}
    try:
        np.save(os.path.join(tmp, "keys.npy"), keys_np)
        np.save(os.path.join(tmp, "vals.npy"), vals_np)
        dstream = durable_stream(ycfg, keys_np, B)
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(B=B, windows=ref["windows"],
                             stream=ref["stream_in"], burst=ref["burst"],
                             key_space=ycfg.key_space,
                             durable_stream=dstream), f)
        t0 = time.perf_counter()
        outs = spawn_ranks(MESH_RANKS, "gloo", tmp,
                           ["index", "durable", "moe", "psum", "pipe"])
        t_gloo = time.perf_counter() - t0
        gloo = check_mesh_index("[mesh:index]", ref, outs)
        for o in outs:
            for name in ("point_launches", "stream_launches",
                         "durable_launches"):
                for k, v in o[name].items():
                    counts[k] = counts.get(k, 0) + v
        log(f"[mesh:index] {MESH_RANKS} ranks over gloo on one card "
            f"({SHARDS // MESH_RANKS} shards a rank, all_to_all_single and "
            f"all_gather staged through the host), {SHARD_WINDOWS} point "
            f"windows, a YCSB-E stream of {ref['n_arrivals']} arrivals and "
            f"a fence re-cut: every rank's results equal [sharded]'s bit "
            f"for bit, and the state digests of every leaf of every shard "
            f"after the windows, the stream and the re-cut equal its "
            f"own; the phase took {t_gloo:.3f} s with the spawn")
        log(f"[mesh:index] window latency p50 {gloo['p50']:.6f} ms p99 "
            f"{gloo['p99']:.6f} ms ({gloo['ops_s']:.1f} ops/s; YCSB-E "
            f"{gloo['stream_s']:.1f} arrivals/s) at P = {MESH_RANKS} over "
            f"gloo, beside [sharded]'s one process: p50 "
            f"{ref['p50']:.6f} ms.  {MESH_RANKS} ranks sharing one card "
            f"through gloo are not a multi-card figure")

        # -- [mesh:durable]: the crash at four ranks, recovered at one ----
        d = os.path.join(tmp, "durable")
        dur = outs[0]["durable"]
        assert all(o["durable"]["acked"] == dur["acked"] for o in outs)
        rec, tail = recover(d, device=DEVICE)
        step = CheckpointManager(os.path.join(d, "ckpt")).latest_step()
        n_applied = step + len(tail)
        acked = dur["acked"][-1] if dur["acked"] else 0
        assert n_applied == acked == dur["sealed"], \
            (n_applied, acked, dur["sealed"])
        want = state_after(ref["state"], dstream, B, n_applied,
                           mesh=ref["mesh"], capacity_factor=CAPACITY_FACTOR)
        assert rec.n_shards == SHARDS and same_state(rec, want), \
            "[mesh:durable] recover != the crash-free state"
        log(f"[mesh:durable] {MESH_RANKS} ranks with a Durability (rank 0 "
            f"writes, the snapshots gathered from every rank) crash at "
            f"{MESH_CRASH[0]} (pass {MESH_CRASH[1]}) after {dur['sealed']} "
            f"sealed windows, {acked} acknowledged; recover at P = 1 "
            f"(snapshot {step} + {len(tail)} windows) equals a crash-free "
            f"dispatcher over those windows bit for bit")
        del rec, want

        # -- [mesh:moe] ---------------------------------------------------
        import dataclasses
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = dataclasses.replace(get_config(MOE_ARCH),
                                  moe_capacity=MESH_MOE_CF)
        p, x = moe_weights(cfg, SEED + 21)
        with moe.record_drops() as drops:
            y0, lb0 = moe.moe_apply(cfg, p, x)
        assert int(sum(drops)) == 0, "[mesh:moe] the reference dropped"
        y0 = y0.cpu().numpy()
        top = float(np.abs(y0).max())
        err = max(float(np.abs(o["moe"]["y"] - y0).max()) for o in outs)
        lb_err = max(abs(o["moe"]["lb"] - lb0.item()) for o in outs)
        del p, x
        assert err <= 1e-5 * top and lb_err <= 1e-6, (err, top, lb_err)
        log(f"[mesh:moe] {MOE_ARCH}'s expert layer at full width (d "
            f"{cfg.d_model}, {cfg.n_experts} experts padded to "
            f"{cfg.experts_padded}, top {cfg.top_k}, width "
            f"{cfg.d_ff_expert}) on {MESH_MOE_B} x {MESH_MOE_S} tokens in "
            f"float32 (TF32 off), drop-free, on a (2, {MESH_RANKS // 2}) "
            f"(data, model) mesh of gloo ranks: max |y - moe_apply| "
            f"{err:.6e} = {err / top:.6e} of the largest |y| {top:.6f} "
            f"(bar 1e-5), lb_loss {lb_err:.3e} apart (bar 1e-6); "
            f"{outs[0]['moe']['ms']:.3f} ms a call on rank 0")

        # -- [mesh:psum] ----------------------------------------------------
        from repro_torch import optim
        xs, errs = psum_inputs(MESH_RANKS)
        deq, qs, new_errs, scales = [], [], [], []
        for r in range(MESH_RANKS):
            xf = xs[r] + errs[r]
            q, scale = optim.quantize_int8(xf)
            qs.append(q.numpy())
            scales.append(scale.item())
            deq.append(q.float() * scale)
            new_errs.append((xf - deq[-1]).numpy())
        mean = (sum(deq[1:], deq[0]) / MESH_RANKS).numpy()
        m_err = max(float(np.abs(o["psum"]["mean"] - mean).max())
                    for o in outs)
        e_err = max(float(np.abs(o["psum"]["err"] - new_errs[r]).max())
                    for r, o in enumerate(outs))
        s_err = max(abs(o["psum"]["scale"] - scales[r]) / scales[r]
                    for r, o in enumerate(outs))
        for r, o in enumerate(outs):
            assert np.array_equal(o["psum"]["q"], qs[r]), "[mesh:psum] q"
        assert m_err <= 1e-6 and e_err <= 1e-6, (m_err, e_err)
        log(f"[mesh:psum] compressed_psum of {MESH_PSUM_N} float32 values "
            f"over {MESH_RANKS} gloo ranks against the same call on the "
            f"CPU: q bit for bit, the mean {m_err:.3e} and the carried "
            f"error {e_err:.3e} apart (bar 1e-6; the scales {s_err:.3e} "
            f"apart relative)")

        # -- [mesh:pipe] ----------------------------------------------------
        W, xm = (t.to(DEVICE) for t in pipe_inputs())
        seq = pipe_stage(W, xm).cpu().numpy()
        p_err = max(float(np.abs(o["pipe"] - seq).max()) for o in outs)
        assert p_err <= 1e-5, p_err
        log(f"[mesh:pipe] pipelined_forward over a {MESH_RANKS}-stage axis "
            f"of gloo ranks ({MESH_PIPE['L']} layers tanh(h W) of "
            f"{MESH_PIPE['d']}, {MESH_PIPE['M']} microbatches of "
            f"{MESH_PIPE['mb']}): max |y - the stages in sequence| "
            f"{p_err:.3e} (bar 1e-5)")

        # -- [mesh:index:nccl]: one rank over NCCL ---------------------------
        t0 = time.perf_counter()
        nccl = spawn_ranks(1, "nccl", tmp, ["index"])
        t_nccl = time.perf_counter() - t0
        one = check_mesh_index("[mesh:index:nccl]", ref, nccl)
        for name in ("point_launches", "stream_launches"):
            for k, v in nccl[0][name].items():
                counts[k] = counts.get(k, 0) + v
        log(f"[mesh:index:nccl] 1 rank over NCCL (the communicator's "
            f"all_to_all_single and all_gather on the card): every result "
            f"and state digest equals [sharded]'s; window p50 "
            f"{one['p50']:.6f} ms p99 {one['p99']:.6f} ms beside "
            f"[sharded]'s {ref['p50']:.6f} ms; {t_nccl:.3f} s with the "
            f"spawn.  NCCL refuses two ranks on one card, so NCCL with "
            f"P > 1 is not run here")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def same_report(a, b) -> bool:
    """Two ``RunReport``s equal field for field, window by window."""
    return (a.results == b.results and a.range_results == b.range_results
            and list(map(int, a.admitted)) == list(map(int, b.admitted))
            and a.dropped == b.dropped and a.retries == b.retries
            and same_windows(a.window_results, b.window_results))


def run_overload(idx_m, keys_np, ycfg, base):
    """Phase [overload] (see the module docstring).  Returns the cuda
    run's launch counts."""
    import dataclasses
    from repro_torch.core import DELETE, SEARCH, RefIndex, live_items
    from repro_torch.core.index import with_backend
    from repro_torch.pipeline import (BREAKER_CLOSED, ArrivalConfig,
                                      Collector, Dispatcher, OverloadConfig,
                                      OverloadController, PipelineMetrics,
                                      RetryPolicy, WindowConfig,
                                      make_arrivals)
    B = ycfg.batch
    stream = make_arrivals(
        ArrivalConfig(process="bursty", rate=1e6,
                      n_arrivals=OVERLOAD_WINDOWS * B, seed=SEED + 11),
        dataclasses.replace(ycfg, write_ratio=0.6), keys_np)
    ocfg = OverloadConfig(shed_dup_at=0.15, shed_search_at=0.3,
                          shed_write_at=0.95, max_recoveries=10_000,
                          adapt_deadline=False)
    out = {}
    for backend in ("cuda", "torch"):
        m = PipelineMetrics()
        disp = Dispatcher(with_backend(idx_m, backend), depth=1, metrics=m,
                          overload=ocfg, clock=lambda: 0.0,
                          max_span=MAX_SPAN)
        ctl = OverloadController(ocfg, metrics=m,
                                 retry=RetryPolicy(max_retries=2), seed=9)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ctl.run(disp, Collector(WindowConfig(batch=B, deadline=5.0)),
                      stream, chunk=B)
        torch.cuda.synchronize()
        out[backend] = (rep, m, disp, time.perf_counter() - t0,
                        launch_counts())
    rep, m, disp, wall, launches = out["cuda"]
    s = m.summary()
    n_win = len(rep.window_results)
    log(f"[overload:cuda] {len(stream.t)} arrivals (write ratio 0.6, zipf "
        f"0.9, bursty) at PC={MIXED_PC} through OverloadController.run: "
        f"{n_win} windows in {wall:.6f} s, {len(stream.t) / wall:.1f} "
        f"arrivals/s; shed {s['shed_by_class']} (total {s['shed_total']}), "
        f"retries {rep.retries}, dropped for good {len(rep.dropped)}, "
        f"goodput {rep.goodput}; pending fill peak "
        f"{s['pending_fill_peak']:.6f}; rebuilds {s['rebuilds']}, breaker "
        f"trips {disp.breaker_trips}, state {disp.breaker_state}; kernel "
        f"launches {launches}")
    assert s["shed_total"] > 0, "the burst never drove shedding"
    assert s["shed_total"] == len(rep.dropped) + rep.retries
    assert m.pending_fill_peak >= ocfg.shed_dup_at
    assert disp.breaker_state == BREAKER_CLOSED
    # a breaker's replay executes its windows again
    assert launches["pi_probe"] == launches["bitonic_sort"] >= n_win > 0, \
        launches
    assert disp.breaker_trips or launches["pi_probe"] == n_win, launches
    # zero acknowledged loss: the admitted subsequence, replayed in
    # admission order against RefIndex, gives every acknowledged result
    t0 = time.perf_counter()
    adm = np.asarray(rep.admitted, dtype=np.int64)
    assert sorted(rep.results) == sorted(rep.admitted)
    assert set(rep.results) | set(rep.dropped) == set(range(len(stream.t)))
    assert not set(rep.results) & set(rep.dropped)
    ref = RefIndex(dict(base[0]))
    want = ref.execute(stream.ops[adm], stream.keys[adm], stream.vals[adm])
    for j, qid in enumerate(adm.tolist()):
        found, val = rep.results[qid]
        if stream.ops[qid] == SEARCH:
            assert (val if found else None) == want[j], qid
        elif stream.ops[qid] == DELETE:
            assert found == (want[j] is not None), qid
    k, v = live_items(disp.index)
    rk = np.fromiter(ref.data.keys(), np.int64, len(ref.data))
    rv = np.fromiter(ref.data.values(), np.int64, len(ref.data))
    order = np.argsort(rk)
    assert np.array_equal(k.astype(np.int64), rk[order])
    assert np.array_equal(v.astype(np.int64), rv[order])
    del ref
    t_rep, t_m, t_disp, t_wall, _ = out["torch"]
    assert same_report(rep, t_rep), "cuda and torch RunReports differ"
    t_s = t_m.summary()
    assert t_s.keys() == s.keys() and all(
        t_s[k] == s[k] or (t_s[k] != t_s[k] and s[k] != s[k]) for k in s), \
        "cuda and torch metrics differ"       # (NaN equals NaN here)
    assert same_state(disp.index, t_disp.index)
    log(f"[overload] the admitted subsequence ({adm.size} arrivals) "
        f"replays exactly against RefIndex, every arrival acknowledged or "
        f"reported dropped, the final live set equal (checked in "
        f"{time.perf_counter() - t0:.3f} s); the torch backend "
        f"({len(stream.t) / t_wall:.1f} arrivals/s) gives an identical "
        f"RunReport, metrics and state")
    return launches


# ---------------------------------------------------------------------------
# the LM path: the flash kernel, prefill and decode, the LM server
# ---------------------------------------------------------------------------

def flash_bound(B, Sq, H, KV, D, causal=True, itemsize=2,
                ops_per_s=BF16_OPS_PER_S):
    """The least time of the attention forward: ``flash_hbm_bytes`` (q and
    out once, k and v once a head) over the HBM rate, against the
    multiply-adds of QK^T and PV that the causal mask leaves, 4 B H D
    Sq (Sq + 1) / 2 operations, over the rate of the kernel's arithmetic
    (the bfloat16 tensor cores; float32 outside them for the float32
    kernel).  Returns (ms, bound by, operations)."""
    from repro_torch.kernels.flash_attention import flash_hbm_bytes
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sq
    ops = 4 * B * H * D * pairs
    return (*bound(flash_hbm_bytes(B, Sq, Sq, H, KV, D, D, itemsize), ops,
                   ops_per_s), ops)


def _flash_inputs(g, B, S, H, KV, D, dt, unaligned=False):
    """q, k, v from a seeded normal; ``unaligned``: views one element into
    their buffers, so that no base is 16-byte aligned."""
    out = []
    for heads in (H, KV, KV):
        n = B * S * heads * D
        x = torch.randn(n + unaligned, generator=g, device=DEVICE).to(dt)
        out.append(x[int(unaligned):].view(B, S, heads, D))
    return out


def check_flash(iters):
    """``[kernels:flash]``: the kernel against its plain version on the
    card at ``FLASH_CASES``; device times of the bfloat16 kernel at phi3's
    and recurrentgemma's prefill shapes (the window of 2048 does not bind
    at 2048 tokens) and of the float32 kernel at the float32 case, beside
    their plain version, ``F.scaled_dot_product_attention`` on the same
    tensors (causal) and their bounds.  A call's time runs from its first
    grid's start to its last grid's end (``device_ms``); each grid's own
    time is printed beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    err, out = 0.0, {}
    for name, (B, S, H, KV, D), dt, opts in FLASH_CASES:
        opts = dict(opts)
        q, k, v = _flash_inputs(g, B, S, H, KV, D, dt,
                                opts.pop("unaligned", False))
        got = FA.flash_attention_fwd(q, k, v, **opts)
        torch.cuda.synchronize()
        want = FA.flash_attention_fwd_plain(q, k, v, **opts)
        e, share = FA.card_error(got, want)
        atol, rtol = FA.CARD_TOL[dt]
        assert np.isfinite(e) and share <= 1.0, (name, e, share)
        err = max(err, e)
        log(f"[kernels:flash] {name} {(B, S, H, KV, D)} {dt}: max_abs_err "
            f"{e:.6g} (tolerance {atol:g} + {rtol:g} |plain|; the largest "
            f"error is {share:.4g} of its element's limit)")
        if name in ("phi3", "float32", "recurrentgemma prefill"):
            f32 = dt == torch.float32
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            grids = {}
            timed = dict(
                ms=device_ms(lambda: FA.flash_attention_fwd(q, k, v, **opts),
                             iters, "flash_f32_kernel" if f32
                             else "flash_fwd_kernel", grids),
                grid_ms=grids,
                plain_ms=device_ms(lambda: FA.flash_attention_fwd_plain(
                    q, k, v, **opts), max(1, iters // 10)),
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), iters),
                bound=flash_bound(B, S, H, KV, D, itemsize=q.element_size(),
                                  ops_per_s=SCALAR_OPS_PER_S if f32
                                  else BF16_OPS_PER_S))
            ms, bnd = timed["ms"], timed["bound"]
            log(f"[kernels:flash] {name} {(B, S, H, KV, D)} {dt}: kernel "
                f"{ms:.6f} ms a call, its grids' union "
                f"({bnd[2] / ms / 1e9:.1f} TFLOP/s), plain "
                f"{timed['plain_ms']:.6f} ms, scaled_dot_product_attention "
                f"{timed['library_ms']:.6f} ms; bound {bnd[0]:.6f} ms "
                f"({bnd[1]}, {bnd[2]:.4g} operations at "
                f"{(SCALAR_OPS_PER_S if f32 else BF16_OPS_PER_S) / 1e12:g} "
                f"TFLOP/s); the kernel at {100 * bnd[0] / ms:.2f}% of its "
                f"bound; each grid's own time: " + ", ".join(
                    f"{g} {t:.6f} ms" for g, t in timed["grid_ms"].items()))
            if name == "phi3":
                out.update(timed)
            else:
                out["f32" if f32 else "griffin"] = timed
        del q, k, v, got, want
    out["err"] = err
    return out


def time_split(fn, tag, spans=()):
    """Device time of one ``fn()`` by kernel class, from the profiler (the
    flash kernel, its grids' union, the matrix products of cuBLAS, the
    rest; the total is the union of all its device events), and of the
    named ``spans`` (``record_function`` ranges, kernels within them),
    beside the host's time to enqueue it and its count of PyTorch
    operators."""
    span_us = dict.fromkeys(spans, 0.0)
    busy = dict.fromkeys(("", "flash_fwd_kernel", "flash_f32_kernel"), 0.0)
    dev, ops = device_events(fn, 1, spans=span_us, busy=busy)
    total = busy[""] / 1e3
    cls = {"flash": (busy["flash_fwd_kernel"] + busy["flash_f32_kernel"])
           / 1e3,
           "matmul": sum(t for name, t, _ in dev
                         if kernel_class(name) == "matmul") / 1e3}
    cls["other"] = total - cls["flash"] - cls["matmul"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_ops = sum(c for name, _, c in ops if name.startswith("aten::"))
    head = tag.split()[0]
    log(f"{tag} device time {total:.6f} ms: " + ", ".join(
        f"{k} {v:.6f} ms ({100 * v / total:.2f}%)" for k, v in cls.items())
        + f"; unprofiled: host enqueue {1e3 * enqueue:.6f} ms, wall "
        f"{1e3 * wall:.6f} ms; {n_ops} aten operator calls")
    if spans:
        log(f"{tag} by span: " + ", ".join(
            f"{k} {v / 1e3:.6f} ms ({100 * v / 1e3 / total:.2f}%)"
            for k, v in span_us.items()))
    for name, t, count in sorted(dev, key=lambda r: -r[1])[:6]:
        log(f"{head}   {t / 1e3:10.6f} ms ({count}x) {name[:90]}")
    return total, cls, {k: v / 1e3 for k, v in span_us.items()}


def draw_params(cfg, seed=SEED):
    """``cfg``'s full parameter tree in its parameter dtype on the card,
    drawn on a CPU generator seeded with ``seed`` (the same tree as on the
    CPU)."""
    from repro_torch.models import init_params, model_layout
    return init_params(model_layout(cfg), torch.Generator().manual_seed(seed),
                       cfg.param_dtype, DEVICE)


def named_leaves(tree, path=""):
    """(path, leaf) of every leaf of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def check_prefill_vs_decode(tag, cfg32, params32, tokens):
    """A float32 prefill of ``tokens`` (the flash kernel, f32) against as
    many token-by-token decode steps (plain einsums over the cache): the
    last logits and every cache leaf within 1e-3 of the largest |decode|
    value (at least 1), positions equal."""
    from repro_torch.models import make_decode_step, make_prefill_step
    from repro_torch.models import decode as dec
    B, S = tokens.shape
    pl, pcache = make_prefill_step(cfg32)(params32, {"tokens": tokens})
    dcache = dec.init_cache(cfg32, B, S, device=DEVICE)
    step32 = make_decode_step(cfg32)
    for t in range(S):
        _, dl, dcache = step32(params32, {"cache": dcache,
                                          "tokens": tokens[:, t:t + 1],
                                          "idx": t})
    torch.cuda.synchronize()
    real = slice(0, cfg32.vocab)          # the padding logits are -1e30
    pairs = [("logits", pl[..., real], dl[..., real])]
    for (name, a), (_, b) in zip(named_leaves(pcache), named_leaves(dcache)):
        if name.endswith("/pos"):
            assert torch.equal(a, b), name
        else:
            pairs.append((name, a, b))
    rel = 1e-3       # float32 products of another order, every layer deep
    for name, a, b in pairs:
        e = (a - b).abs().max().item()
        scale = b.abs().max().item()
        tol = rel * max(1.0, scale)
        log(f"{tag} float32 prefill vs {S} decode steps, {name}: "
            f"max_abs_err {e:.6g} (tolerance {tol:.6g} = {rel} x "
            f"max(1, max |decode| = {scale:.6g}))")
        assert np.isfinite(e) and e <= tol, (name, e, tol)


LM_TAGS = {"dense": "[lm]", "moe": "[lm:moe]", "ssm": "[lm:ssm]",
           "griffin": "[lm:griffin]"}


def attn_layers(cfg) -> int:
    """The layers that launch the flash kernel once in a prefill or a
    ``forward`` (twice in a train step): every layer of the GQA
    families, griffin's attention layers, none of mamba2's."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "griffin":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def lm_config(arch):
    """``arch``'s published config at its ``LM_DEPTH`` (the LM phases')."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in LM_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH[arch])
    return cfg


def layout_params(cfg) -> int:
    """``cfg``'s parameter count by its layout (meta tensors, no storage)."""
    from repro_torch.models import abstract_params, model_layout
    from repro_torch.models.base import tree_leaves
    return sum(x.numel() for x in tree_leaves(
        abstract_params(model_layout(cfg), cfg.param_dtype)))


def describe(cfg) -> str:
    if cfg.family == "ssm":
        nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        body = (f"d {cfg.d_model}, state {cfg.ssm_state}, {nh} heads of "
                f"{cfg.ssm_headdim}, conv {cfg.ssm_conv}, chunk "
                f"{cfg.ssm_chunk}")
    elif cfg.family == "mla_moe":
        body = (f"d {cfg.d_model}, {cfg.n_heads} MLA heads (q_lora "
                f"{cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}), "
                f"{cfg.first_k_dense} dense, {cfg.n_experts} experts top "
                f"{cfg.top_k} + {cfg.n_shared_experts} shared, MTP "
                f"{cfg.mtp_depth}")
    else:
        body = (f"d {cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv} KV) of "
                f"{cfg.hd}, ")
        if cfg.family == "moe":
            body += (f"{cfg.n_experts} experts ({cfg.experts_padded} "
                     f"padded), top {cfg.top_k}, of width {cfg.d_ff_expert}")
        elif cfg.family == "griffin":
            body += (f"window {cfg.sliding_window}, lru {cfg.lru_width}, "
                     f"GeGLU d_ff {cfg.d_ff}; groups of (rec, rec, attn): "
                     f"{attn_layers(cfg)}, tail layers: "
                     f"{cfg.n_layers % cfg.attn_every}")
        else:
            body += f"d_ff {cfg.d_ff}"
    return (f"{cfg.n_layers} layers, {body}, vocab {cfg.vocab} "
            f"({cfg.vocab_padded} padded)")


def ring_of(cfg, cache):
    """The cache's attention ring (k, v, pos) whose positions decode
    writes, or None (mamba2 keeps states only)."""
    if cfg.family == "ssm":
        return None
    if cfg.family == "griffin":
        return cache["g_attn"]
    return cache["moe"] if cfg.family == "moe" else cache


def check_cache_shapes(cfg, cache, B, T):
    """The prefill cache's leaves have the reference's shapes for B
    sequences of up to T positions (mamba2's state float32)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        conv_dim = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
        assert cache["ssm"].shape == (L, B, nh, cfg.ssm_headdim,
                                      cfg.ssm_state)
        assert cache["ssm"].dtype == torch.float32
        assert cache["conv"].shape == (L, B, cfg.ssm_conv - 1, conv_dim)
        return
    G, W = attn_layers(cfg), T
    if cfg.family == "griffin":
        W = min(T, cfg.sliding_window)
        for t in range(L % cfg.attn_every):
            assert cache[f"tail{t}"]["h"].shape == (1, B, cfg.lru_width)
        assert cache["g_rec0"]["h"].dtype == torch.float32
    assert ring_of(cfg, cache)["k"].shape == (G, B, W, cfg.n_kv, cfg.hd)


def run_lm(arch):
    """``[lm]`` (phi3-mini-3.8b), ``[lm:moe]`` (granite-moe-3b-a800m),
    ``[lm:ssm]`` (mamba2-2.7b) and ``[lm:griffin]`` (recurrentgemma-9b):
    ``arch`` at full width, see the module docstring.  Returns the launch
    counts of its prefill, its float32 and compute-dtype weights and its
    numbers."""
    import dataclasses
    from repro_torch.models import (cast_floats, forward, make_decode_step,
                                    make_prefill_step)
    from repro_torch.models import moe
    from repro_torch.models.base import tree_bytes, tree_leaves
    cfg = lm_config(arch)
    is_moe = cfg.family == "moe"
    tag = LM_TAGS[cfg.family]
    rng = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = draw_params(cfg)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    params = cast_floats(params32, cfg.compute_dtype)   # once, up front
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"{tag} {arch}: {describe(cfg)}; {n_params} parameters drawn in "
        f"float32 on the CPU generator and copied to the card in "
        f"{t_draw:.3f} s, cast to {cfg.compute_dtype} in "
        f"{time.perf_counter() - t0 - t_draw:.3f} s")
    assert n_params == LM_PARAMS[arch] == layout_params(cfg), n_params

    def toks(b, s):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                .astype(np.int32)).to(DEVICE)

    T = PREFILL_S + DECODE_STEPS
    prefill = make_prefill_step(cfg, total_len=T)
    prefill(params, {"tokens": toks(1, 128)})          # warm-up
    tokens = toks(PREFILL_B, PREFILL_S)
    torch.cuda.synchronize()
    # the prefill's own peak, its arguments included ([roofline]): the
    # card's peak during it less what else was allocated then
    peak_before = torch.cuda.max_memory_allocated()
    other = torch.cuda.memory_allocated() - tree_bytes(params) - \
        tokens.numel() * tokens.element_size()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with moe.record_drops() as drops:
        logits, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated() - other
    launches = launch_counts()
    assert launches["flash_attention_fwd"] == attn_layers(cfg), launches
    assert logits.shape == (PREFILL_B, 1, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    check_cache_shapes(cfg, cache, PREFILL_B, T)
    dropped = ""
    if is_moe:
        n_drop = int(torch.stack(drops).sum())
        copies = cfg.n_layers * PREFILL_B * PREFILL_S * cfg.top_k
        cap = moe.capacity(cfg, PREFILL_B * PREFILL_S)
        dropped = (f", copies dropped at capacity factor "
                   f"{cfg.moe_capacity} ({cap} rows an expert): {n_drop} "
                   f"of {copies} ({100 * n_drop / copies:.4f}%)")
    kvquant = check_kvquant(tag, ring_of(cfg, cache)) \
        if cfg.family == "griffin" else None

    decode = make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    steps = []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        tok, dl, cache = decode(params, {"cache": cache,
                                         "tokens": tok[:, None],
                                         "idx": PREFILL_S + i})
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        assert torch.isfinite(dl).all()
    ring = ring_of(cfg, cache)
    if ring is not None:          # the last position, at its ring slot
        W = ring["pos"].shape[1]
        assert int(ring["pos"][0, (T - 1) % W]) == T - 1
    steps = np.array(steps) * 1e3
    peak = max(peak_before, torch.cuda.max_memory_allocated())
    log(f"{tag} prefill {PREFILL_B} x {PREFILL_S} tokens: "
        f"{1e3 * t_prefill:.6f} ms ({PREFILL_B * PREFILL_S / t_prefill:.1f} "
        f"tokens/s), flash kernel launches {launches['flash_attention_fwd']}"
        f"{dropped}; {DECODE_STEPS} greedy decode steps at batch "
        f"{PREFILL_B}: p50 {np.percentile(steps, 50):.6f} ms, p99 "
        f"{np.percentile(steps, 99):.6f} ms; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    spans = {"moe": MOE_SPANS, "ssm": SSM_SPANS,
             "griffin": GRIFFIN_SPANS}.get(cfg.family, ())
    split_prefill = time_split(lambda: prefill(params, {"tokens": tokens}),
                               f"{tag} prefill", spans)
    split_decode = time_split(lambda: decode(params, {
        "cache": cache, "tokens": tok[:, None],
        "idx": T - 1}), f"{tag} decode step", spans)
    del cache, logits

    reset_launches()
    fl, _ = forward(cfg, params, tokens=toks(1, 256))
    torch.cuda.synchronize()
    fwd = launch_counts()["flash_attention_fwd"]
    assert fwd == attn_layers(cfg) and torch.isfinite(fl).all(), fwd
    del fl
    long = griffin_long_prefill(tag, cfg, params, toks) \
        if cfg.family == "griffin" else None

    # the model in float32: prefill (the kernel) against token-by-token
    # decode (plain einsums over the cache); a moe model at a capacity
    # factor of E / K, so that an expert takes every token (cap = N) and
    # the prefill drops no copy; mamba2 at a length that is no multiple
    # of its chunk, so that the prefill pads
    extra = {}
    if is_moe:
        extra = dict(moe_capacity=cfg.n_experts / cfg.top_k)
        cap = moe.capacity(cfg, CHECK_B * CHECK_S, extra["moe_capacity"])
        log(f"{tag} float32 check at capacity factor "
            f"{extra['moe_capacity']}: {cap} rows an expert for "
            f"{CHECK_B * CHECK_S} tokens, drop-free")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", **extra)
    check_s = SSM_CHECK_S if cfg.family == "ssm" else CHECK_S
    check_prefill_vs_decode(tag, cfg32, params32, toks(CHECK_B, check_s))
    return dict(launches=launches, params=params, params32=params32,
                cfg=cfg, t_prefill=t_prefill, steps=steps, peak=peak,
                prefill_peak=prefill_peak,
                split_prefill=split_prefill, split_decode=split_decode,
                kvquant=kvquant, long=long)


def check_kvquant(tag, ring):
    """``models/kvquant.py`` on a prefill's ring cache: the int8 values
    and scales of its keys and values, dequantized within the bound of
    ``tests/test_kvquant.py`` (0.51 of a row's scale), and
    ``cache_bytes`` equal to the tensors' own bytes."""
    from repro_torch.models import kvquant
    out = {}
    for name in ("k", "v"):
        x = ring[name]
        q, s = kvquant.quantize_kv(x)
        back = kvquant.dequantize_kv(q, s, torch.float32)
        share = ((back - x.float()).abs() / (s * 0.51)).max().item()
        assert q.dtype == torch.int8 and share <= 1.0, (name, share)
        assert kvquant.cache_bytes(tuple(x.shape), True) == \
            q.nbytes + s.nbytes
        assert kvquant.cache_bytes(tuple(x.shape), False) == x.nbytes
        out[name] = share
        log(f"{tag} kvquant {name} {tuple(x.shape)} {x.dtype}: "
            f"{x.nbytes} bytes -> {q.nbytes + s.nbytes} as int8 + float32 "
            f"scales (cache_bytes agrees); the largest error is {share:.4g} "
            f"of the bound (0.51 of its row's scale)")
        del q, s, back
    return out


def griffin_long_prefill(tag, cfg, params, toks):
    """A prefill of 2 x ``GRIFFIN_LONG_S`` tokens, where the window binds
    in the flash kernel and the ring cache keeps the last ``window``
    positions, then one decode step onto the wrapped ring."""
    from repro_torch.models import make_decode_step, make_prefill_step
    S = GRIFFIN_LONG_S
    W = cfg.sliding_window
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg, total_len=S)(
        params, {"tokens": toks(2, S)})
    torch.cuda.synchronize()
    t_long = time.perf_counter() - t0
    n = launch_counts()["flash_attention_fwd"]
    assert n == attn_layers(cfg) and torch.isfinite(logits).all(), n
    ring = cache["g_attn"]
    want = torch.arange(S - W, S, dtype=torch.int32, device=DEVICE)
    assert ring["k"].shape[2] == W and torch.equal(ring["pos"][0], want)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    _, dl, cache = make_decode_step(cfg)(params, {
        "cache": cache, "tokens": tok[:, None], "idx": S})
    assert torch.isfinite(dl).all() and int(ring["pos"][0, S % W]) == S
    log(f"{tag} prefill 2 x {S} tokens (window {W} binds; the ring keeps "
        f"positions {S - W}..{S - 1}): {1e3 * t_long:.6f} ms, flash kernel "
        f"launches {n}; one decode step onto the wrapped ring at slot "
        f"{S % W}")
    del cache, logits
    return dict(ms=1e3 * t_long)


def run_serve_lm(cfg, params, tag):
    """``[serve:lm]``, ``[serve:lm:moe]``, ``[serve:lm:ssm]``,
    ``[serve:lm:griffin]``: the LM server at full width (see the module
    docstring).  Returns its launch counts."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.pipeline import recover
    rng = np.random.default_rng(SEED + 3)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    srv = Server(cfg, params, n_slots=8, max_len=128, index_backend="cuda",
                 wal_dir=SERVE_DIR, device=DEVICE)
    waiting = [Request(rid=1000 + 7 * i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(16, 49))), max_new=16)
        for i in range(SERVE_REQUESTS)]
    reqs = list(waiting)
    torch.cuda.synchronize()
    reset_launches()
    srv.pipeline_metrics.start(time.perf_counter())
    t0 = time.perf_counter()
    ticks = ranges = 0
    while waiting or srv.live:
        if waiting and srv.free:
            n = srv.admit(waiting[:len(srv.free)])
            waiting = waiting[n:]
        srv.tick()
        ticks += 1
        if ticks in (3, 20):     # mid-run: the table against the host
            lo, hi = 1000 + 7 * 2, 1000 + 7 * 11
            want = [(r, s) for r, s in srv.slot_of.items() if lo <= r <= hi]
            got = srv.session_range(lo, hi)
            assert got == (len(want), sum(s for _, s in want)), (got, want)
            ranges += 1
        assert ticks < 1000, "the server did not drain"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    srv.pipeline_metrics.stop(time.perf_counter())
    launches = launch_counts()
    summary = srv.pipeline_metrics.summary()
    assert all(len(r.out) == r.max_new for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    assert int(srv.table.live_count) == 0 and ranges == 2
    assert launches["pi_probe"] == launches["bitonic_sort"] == \
        summary["windows"], (launches, summary["windows"])
    assert launches["pi_range"] == ranges, launches
    srv.close()
    rec, tail = recover(SERVE_DIR, device=DEVICE)
    assert same_state(rec, srv.table), "recovered table != live table"
    n_new = sum(len(r.out) for r in reqs)
    n_prompt = sum(len(r.prompt) for r in reqs)
    log(f"{tag} {cfg.name}: {len(reqs)} requests ({n_prompt} prompt "
        f"tokens, each a decode step over the 8 slots, and {n_new} new "
        f"tokens) in {ticks} ticks, {wall:.6f} s: {len(reqs) / wall:.6f} "
        f"requests/s, {n_new / wall:.6f} new tokens/s, "
        f"{(n_new + n_prompt) / wall:.6f} tokens/s with the prompts; "
        f"session table: {summary['windows']} windows, "
        f"{srv.queries_processed} index queries, p50 "
        f"{summary['p50_ms']:.6f} ms, p99 {summary['p99_ms']:.6f} ms; "
        f"session_range twice against the host; recover replayed "
        f"{len(tail)} windows to the live table bit for bit; kernel "
        f"launches {launches}")
    shutil.rmtree(SERVE_DIR)
    return launches


# ---------------------------------------------------------------------------
# [train]: the flash kernel under autograd, phi3-mini train steps
# ---------------------------------------------------------------------------

def train_opt(**changes):
    from repro_torch.optim import OptConfig
    return OptConfig(**dict(TRAIN_OPT_ARGS, **changes))


def check_flash_grad(iters):
    """``[train]`` (a): ``FlashAttention`` at phi3's heads in bfloat16 and
    float32: the forward within ``CARD_TOL`` of the plain version, the
    gradient bit for bit autograd through the plain version at the
    model's chunk of 1024; then one layer's attention forward and
    backward timed at the train step's shape."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    B, S, H, KV, D = FLASH_GRAD_SHAPE
    for dt in (_BF, _F32):
        q, k, v = _flash_inputs(g, B, S, H, KV, D, dt)
        go = torch.randn(q.shape, generator=g, device=DEVICE).to(dt)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = FA.FlashAttention.apply(*leaves, True, None, None)
        got = torch.autograd.grad(out, leaves, go)
        e, share = FA.card_error(out.detach(),
                                 FA.flash_attention_fwd_plain(q, k, v))
        assert np.isfinite(e) and share <= 1.0, (dt, e, share)
        ref = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(FA.flash_attention_fwd_plain(
            *ref, kv_chunk=1024), ref, go)
        for name, a, b in zip("qkv", got, want):
            assert a.dtype == dt and torch.equal(a, b), (dt, name)
        log(f"[train] FlashAttention {FLASH_GRAD_SHAPE} {dt}: forward "
            f"max_abs_err {e:.6g} ({share:.4g} of CARD_TOL); dq, dk, dv "
            f"equal autograd through the plain version bit for bit")
        del q, k, v, go, leaves, out, got, ref, want
    B, S = TRAIN_B, TRAIN_S
    q, k, v = (x.requires_grad_() for x in _flash_inputs(g, B, S, H, KV, D,
                                                         _BF))
    go = torch.randn(q.shape, generator=g, device=DEVICE).to(_BF)
    busy = dict.fromkeys(("", "flash_fwd_kernel"), 0.0)
    dev, _ = device_events(lambda: torch.autograd.grad(
        FA.FlashAttention.apply(q, k, v, True, None, None), (q, k, v), go),
        iters, operators=False, busy=busy)
    total = busy[""] / iters / 1e3
    fwd = busy["flash_fwd_kernel"] / iters / 1e3
    log(f"[train] one layer's attention at ({B}, {S}, {H}, {KV}, {D}) "
        f"bfloat16: forward kernel {fwd:.6f} ms, backward (the plain "
        f"recompute in float64 scores and autograd) {total - fwd:.6f} ms "
        f"of device time")
    for name, t, count in sorted(dev, key=lambda r: -r[1])[:6]:
        log(f"[train]   {t / iters / 1e3:10.6f} ms ({count / iters:.0f}x) "
            f"{name[:90]}")
    return dict(fwd_ms=fwd, bwd_ms=total - fwd)


def step_split(cfg, opt_cfg, params, opt_state, batch):
    """Device time of one train step by phase (``make_train_step``'s body
    taken apart: the forward, the backward, the optimizer) and by kernel
    class, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.models import loss_fn
    from repro_torch.models.base import tree_leaves, tree_map
    live = tree_map(lambda a: a.detach().requires_grad_(), params)
    out = {}

    def run(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = fn()
            torch.cuda.synchronize()
        out[name] = [(e.key, e.self_device_time_total / 1e3)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and e.key not in ALL_SPANS
                     and kernel_class(e.key) != "flash"] + [
            ("flash_fwd_kernel, its grids' union",
             sum(busy_us(prof.events(), k) for k in
                 ("flash_fwd_kernel", "flash_f32_kernel")) / 1e3)]
        return res

    with torch.enable_grad():
        loss, _ = run("forward", lambda: loss_fn(cfg, live, batch))
        grads = run("backward", lambda: torch.autograd.grad(
            loss, tree_leaves(live)))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), live)
    del live, loss
    run("optimizer", lambda: optim.update(opt_cfg, grads, opt_state, params))
    return out


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name or "flash_f32_kernel" in name:
        return "flash"
    if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def train_full_width(cfg, params, profile, tag, source="the [lm] phase's "
                     "draw"):
    """``[train]``, ``[train:moe]``, ``[train:ssm]``, ``[train:griffin]``
    (b): ``cfg`` at full width (and full depth but for recurrentgemma's),
    from its float32 ``params`` (drawn once for the model's ``[lm]`` phase
    and updated in place here), AdamW with bfloat16 moments,
    ``TRAIN_STEPS`` steps on ``TRAIN_B`` x ``TRAIN_S`` tokens of
    ``lm_batch``.  Returns the flash launches and the numbers."""
    from repro_torch import data, optim
    from repro_torch.models import make_train_step
    from repro_torch.models.base import tree_leaves
    assert cfg.remat and cfg.compute_dtype == "bfloat16"
    assert not torch.backends.cuda.matmul.allow_tf32
    is_moe = cfg.family in ("moe", "mla_moe")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what the card holds besides the step's arguments ([roofline])
    other = torch.cuda.memory_allocated() - sum(
        x.numel() * x.element_size() for x in tree_leaves(params))
    t0 = time.perf_counter()
    opt = train_opt()
    opt_state = optim.init(opt, params)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    assert n_params == layout_params(cfg), n_params
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, {n_params} float32 "
        f"parameters ({source}) and AdamW moments in {opt.moment_dtype} "
        f"made in "
        f"{time.perf_counter() - t0:.3f} s: {state_gib:.3f} GiB on the "
        f"card; {opt}")
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                           global_batch=TRAIN_B, seed=SEED)
    batches = [data.lm_batch(dcfg, i, device=DEVICE)
               for i in range(TRAIN_STEPS + 1)]
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    reset_launches()
    losses, lbs, norms, times = [], [], [], []
    for batch in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if is_moe:
            lbs.append(float(metrics["lb_loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = np.array(times) * 1e3
    p50 = float(np.percentile(times, 50))
    tokens = TRAIN_B * TRAIN_S
    log(f"{tag} {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens: "
        f"losses {losses}, " + (f"lb_loss {lbs}, " if is_moe else "") +
        f"grad norms {norms}; step times {times.tolist()} ms, p50 "
        f"{p50:.6f} ms ({tokens / p50 * 1e3:.1f} tokens/s); peak device "
        f"memory {peak / 2 ** 30:.3f} GiB; flash kernel launches "
        f"{launches['flash_attention_fwd']}")
    assert all(np.isfinite(losses + lbs + norms)), (losses, lbs, norms)
    if not is_moe:
        assert losses[-1] < losses[0], losses
    assert launches["flash_attention_fwd"] == \
        2 * attn_layers(cfg) * TRAIN_STEPS, launches
    split = None
    if profile:
        split = step_split(cfg, opt, params, opt_state,
                           batches[TRAIN_STEPS])
        total = sum(t for rows in split.values() for _, t in rows)
        parts = []
        for phase, rows in split.items():
            ms = sum(t for _, t in rows)
            cls = {}
            for name, t in rows:
                cls[kernel_class(name)] = cls.get(kernel_class(name), 0) + t
            parts.append(f"{phase} {ms:.6f} ms ({100 * ms / total:.2f}%: " +
                         ", ".join(f"{k} {v:.6f}" for k, v in
                                   sorted(cls.items())) + ")")
        log(f"[profile:{tag[1:-1]}] one step's device time {total:.6f} ms, "
            f"{100 * total / p50:.2f}% of the unprofiled p50 step: " +
            "; ".join(parts))
        for phase, rows in split.items():
            for name, t in sorted(rows, key=lambda r: -r[1])[:5]:
                log(f"[profile:{tag[1:-1]}] {phase:9s} {t:10.6f} ms "
                    f"{name[:90]}")
    del params, opt_state, batches
    torch.cuda.empty_cache()
    return launches, dict(p50=p50, tokens_s=tokens / p50 * 1e3, peak=peak,
                          step_peak=peak - other, cfg=cfg, losses=losses,
                          split=split)


def tree_max_err(got, want, path=""):
    """(the largest |got - want| of a leaf over that leaf's largest |want|,
    the leaf's path) over two trees of one structure."""
    if isinstance(want, dict):
        return max(tree_max_err(got[k], want[k], f"{path}/{k}")
                   for k in sorted(want))
    a, b = got.detach().float().cpu(), want.detach().float().cpu()
    return ((a - b).abs().max().item() /
            max(b.abs().max().item(), 1e-30), path)


def adam_step_share(p_got, p_want, g_got, g_want, opt, lr):
    """One AdamW step from each side's own gradients against the other:
    (the largest parameter difference, its largest share of the bar, the
    elements held to the near-zero bar whose gradients differ, where the
    largest share lies, the largest share of the bar without that rule).
    The bar is ``CARD_CPU_TOL['param']`` x lr and one float32 ulp of the
    parameter, and 2 lr and the ulp where both sides' gradients, clipped
    as ``optim.update`` clips them, lie within ``NEAR_ZERO_EPS`` eps of
    0 (see ``CARD_CPU_TOL``)."""
    def clipped(grads):
        leaves = [g.detach().float().cpu() for _, g in named_leaves(grads)]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in leaves))
        scale = min(1.0, opt.clip_norm / max(norm.item(), 1e-30))
        return [g * scale for g in leaves]

    near = NEAR_ZERO_EPS * opt.eps
    moved = top = strict = 0.0
    n_near, where = 0, ""
    for (name, a), (_, b), gc, gh in zip(
            named_leaves(p_got), named_leaves(p_want), clipped(g_got),
            clipped(g_want)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        d = (a - b).abs()
        moved = max(moved, d.max().item())
        zero = (gc.abs() <= near) & (gh.abs() <= near)
        n_near += int((zero & (gc != gh)).sum())
        ulp = 2.0 ** -22 * b.abs()
        strict = max(strict, (d / (CARD_CPU_TOL["param"] * lr + ulp))
                     .max().item())
        sh = d / (torch.where(zero, 2.0, CARD_CPU_TOL["param"]) * lr + ulp)
        i = int(sh.argmax())
        if sh.flatten()[i].item() > top:
            top = sh.flatten()[i].item()
            where = (f"leaf {name}, its clipped gradient there "
                     f"{gc.flatten()[i].item():.3g} on the card, "
                     f"{gh.flatten()[i].item():.3g} on the CPU")
    return moved, top, n_near, where, strict


def train_card_vs_cpu(arch, tag):
    """``[train]`` / ``[train:moe]`` / ``[train:ssm]`` (c): one AdamW step
    of ``arch``'s widths at ``CHECK_LAYERS`` layers in float32 on the card
    (the float32 kernel in the forward) and on the CPU (the plain
    attention), from the same weights and batch, both drawn on the CPU
    generator: the loss, the gradients and the updated parameters, each
    within ``CARD_CPU_TOL``."""
    import dataclasses
    from repro_torch import data, optim
    from repro_torch.configs import get_config
    from repro_torch.models import loss_and_grad
    from repro_torch.models.base import tree_map
    cfg = dataclasses.replace(get_config(arch), n_layers=CHECK_LAYERS,
                              compute_dtype="float32")
    opt = train_opt(moment_dtype="float32")
    card = draw_params(cfg, SEED + 5)
    host = tree_map(lambda a: a.to("cpu", copy=True), card)
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=CHECK_TRAIN_S,
                           global_batch=1, seed=SEED + 5)
    out = {}
    for where, params in (("card", card), ("cpu", host)):
        t0 = time.perf_counter()
        b = data.lm_batch(dcfg, 0, device=params["final_norm"].device)
        (loss, _), grads = loss_and_grad(cfg, params, b)
        # a copy before the update clips the gradients in place
        grads_cpu = tree_map(lambda a: a.to("cpu", copy=True), grads)
        params, _, gn = optim.update(opt, grads, optim.init(opt, params),
                                     params)
        out[where] = (loss.item(), grads_cpu, tree_map(lambda a: a.cpu(),
                                                       params), gn.item())
        log(f"{tag} card vs cpu: the {where} step took "
            f"{time.perf_counter() - t0:.3f} s")
    (l_c, g_c, p_c, n_c), (l_h, g_h, p_h, n_h) = out["card"], out["cpu"]
    del card, host, out
    torch.cuda.empty_cache()
    loss_err = abs(l_c - l_h) / abs(l_h)
    grad_err, grad_leaf = tree_max_err(g_c, g_h)
    lr = optim.schedule(opt, torch.tensor(1)).item()     # step 1's rate
    moved, param_share, n_near, worst, strict = adam_step_share(
        p_c, p_h, g_c, g_h, opt, lr)
    log(f"{tag} card vs cpu, {CHECK_LAYERS} layers of {arch} in "
        f"float32, 1 x {CHECK_TRAIN_S} tokens, one AdamW step: loss "
        f"{l_c:.9g} vs {l_h:.9g} (relative {loss_err:.3g}, bar "
        f"{CARD_CPU_TOL['loss']:g}); grad norm {n_c:.9g} vs {n_h:.9g}; "
        f"gradients: largest error {grad_err:.3g} of its leaf's largest "
        f"|value| (leaf {grad_leaf}; bar {CARD_CPU_TOL['grad']:g}); updated "
        f"parameters: largest difference {moved:.3g} = {moved / lr:.3g} "
        f"x lr = {lr:.3g} (bar {CARD_CPU_TOL['param']:g} x lr + one float32 "
        f"ulp of the parameter, 2 x lr + the ulp at {n_near} elements "
        f"whose clipped gradients differ within {NEAR_ZERO_EPS} eps of 0 "
        f"on both sides; the largest share of its bar {param_share:.3g}: "
        f"{worst}; of the 0.1 lr bar everywhere {strict:.3g})")
    assert loss_err <= CARD_CPU_TOL["loss"], loss_err
    assert abs(n_c - n_h) / n_h <= CARD_CPU_TOL["grad"], (n_c, n_h)
    assert grad_err <= CARD_CPU_TOL["grad"], (grad_err, grad_leaf)
    assert param_share <= 1.0, (moved, param_share, worst)
    return dict(loss_err=loss_err, grad_err=grad_err, param_lr=moved / lr,
                param_share=param_share, near_zero=n_near,
                strict_share=strict)


def train_driver():
    """``[train]`` (d): ``launch/train.py::train`` at phi3's widths and
    ``CHECK_LAYERS`` layers, bfloat16 compute and moments: an
    uninterrupted run with a slow step, a run failing at
    ``TRAIN_FAIL_AT`` after its checkpoint, and its resumption."""
    import dataclasses
    from repro_torch import data
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=CHECK_LAYERS)
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=DRIVER_S,
                           global_batch=DRIVER_B, seed=SEED)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    loop = T.TrainLoopConfig(steps=TRAIN_FAIL_AT + 1,
                             ckpt_every=TRAIN_FAIL_AT - 1, sync_ckpt=True,
                             seed=SEED, straggler_factor=3.0)
    slow = TRAIN_FAIL_AT

    def pre_step(step):
        if step == slow:
            time.sleep(1.0)            # a straggler
    t0 = time.perf_counter()
    opt = train_opt()
    clean = T.train(cfg, opt, dataclasses.replace(
        loop, ckpt_dir=os.path.join(TRAIN_DIR, "clean"),
        ckpt_every=10 ** 9), dcfg, hooks={"pre_step": pre_step},
        device=DEVICE)
    t_clean = time.perf_counter() - t0
    assert slow in clean.straggler_steps, clean.straggler_steps
    failed = os.path.join(TRAIN_DIR, "failed")
    t0 = time.perf_counter()
    try:
        T.train(cfg, opt, dataclasses.replace(
            loop, ckpt_dir=failed, fail_at_step=TRAIN_FAIL_AT), dcfg,
            device=DEVICE)
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        assert "injected failure" in str(e), e
    t_failed = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = T.train(cfg, opt, dataclasses.replace(loop, ckpt_dir=failed),
                  dcfg, device=DEVICE)
    t_resume = time.perf_counter() - t0
    assert res.restored_from == TRAIN_FAIL_AT - 1, res.restored_from
    assert res.final_step == TRAIN_FAIL_AT and len(res.losses) == 1
    err = abs(res.losses[0] - clean.losses[-1]) / abs(clean.losses[-1])
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(os.path.join(
                   failed, f"step_{TRAIN_FAIL_AT}")) for f in fs)
    log(f"[train] driver, {CHECK_LAYERS} layers, {DRIVER_B} x {DRIVER_S} "
        f"tokens, bfloat16 moments: clean run {clean.losses} in "
        f"{t_clean:.3f} s (stragglers {clean.straggler_steps}); failure "
        f"injected at step {TRAIN_FAIL_AT} after the step "
        f"{TRAIN_FAIL_AT - 1} checkpoint ({t_failed:.3f} s); resumed from "
        f"step {res.restored_from}: loss {res.losses[0]:.9g} against the "
        f"clean run's {clean.losses[-1]:.9g} (relative {err:.3g}, bar "
        f"{DRIVER_TOL:g}) in {t_resume:.3f} s; a checkpoint holds "
        f"{size / 1e9:.3f} GB")
    assert err <= DRIVER_TOL, err
    shutil.rmtree(TRAIN_DIR)
    return dict(resume_err=err)


def run_train(params32, profile, iters):
    """``[train]``: (a) to (d) above, (b) from phi3's float32 ``params32``
    of ``[lm]``.  Returns the launch counts of (b), the full-width
    steps."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    grad = check_flash_grad(iters)
    log(f"[time] [train] (a) {time.perf_counter() - t0:.3f} s")
    launches, full = train_full_width(get_config(LM_ARCH), params32, profile,
                                      "[train]")
    del params32
    log(f"[time] [train] (b) {time.perf_counter() - t0:.3f} s")
    vs_cpu = train_card_vs_cpu(LM_ARCH, "[train]")
    log(f"[time] [train] (c) {time.perf_counter() - t0:.3f} s")
    driver = train_driver()
    log(f"[time] [train] (d) {time.perf_counter() - t0:.3f} s")
    if full["split"] is not None:
        step_ms = sum(t for rows in full["split"].values() for _, t in rows)
        share = 100 * grad["bwd_ms"] * LM_LAYERS / step_ms
        log(f"[profile:train] the attention backward, {grad['bwd_ms']:.6f} "
            f"ms a layer x {LM_LAYERS} layers, is {share:.2f}% of a step's "
            f"device time")
    return launches, dict(grad=grad, full=full, vs_cpu=vs_cpu,
                          driver=driver)


def run_train_moe(params32, profile):
    """``[train:moe]``: (b) granite-moe-3b-a800m at full width and depth
    from ``[lm:moe]``'s float32 ``params32``, (c) its widths at
    ``CHECK_LAYERS`` layers, card against CPU.  Returns the launch counts
    of (b)."""
    t0 = time.perf_counter()
    launches, full = train_full_width(lm_config(MOE_ARCH), params32,
                                      profile, "[train:moe]")
    del params32
    log(f"[time] [train:moe] (b) {time.perf_counter() - t0:.3f} s")
    vs_cpu = train_card_vs_cpu(MOE_ARCH, "[train:moe]")
    log(f"[time] [train:moe] (c) {time.perf_counter() - t0:.3f} s")
    return launches, dict(full=full, vs_cpu=vs_cpu)


def mla_layer(tag):
    """``[lm:mla]`` (i): one MLA layer (``mla_apply``) at deepseek-v3's
    published widths in bfloat16: a prefill of ``MLA_B`` x ``MLA_S``
    through the plain chunked attention, ``MLA_DECODE`` decode steps over
    the compressed cache, and in float32 the prefill against ``MLA_S``
    decode steps."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import cast_floats, init_params, moe
    from repro_torch.models.base import tree_leaves, tree_map
    cfg = get_config(MLA_ARCH)
    tree = init_params(moe.mla_layout(cfg, "attn", 1),
                       torch.Generator().manual_seed(SEED + 6),
                       cfg.param_dtype, DEVICE)
    p = tree_map(lambda a: a[0], tree["attn"])
    n_params = sum(x.numel() for x in tree_leaves(p))
    assert n_params == MLA_LAYER_PARAMS, n_params
    B, S, T = MLA_B, MLA_S, MLA_S + MLA_DECODE
    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    x = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(SEED + 7)).to(DEVICE)
    pos = torch.arange(T, device=DEVICE).expand(B, T)
    xb = x.to(torch.bfloat16)
    reset_launches()
    with torch.no_grad():
        moe.mla_apply(cfg, p, xb[:, :16], pos[:, :16])      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, (c_kv, k_rope) = moe.mla_apply(cfg, p, xb[:, :S], pos[:, :S])
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        assert o.shape == (B, S, cfg.d_model) and torch.isfinite(o).all()
        cache = {"c_kv": torch.zeros(B, T, kvr, dtype=o.dtype, device=DEVICE),
                 "k_rope": torch.zeros(B, T, 1, dr, dtype=o.dtype,
                                       device=DEVICE)}
        cache["c_kv"][:, :S] = c_kv
        cache["k_rope"][:, :S] = k_rope
        steps = []
        for t in range(S, T):
            t0 = time.perf_counter()
            o1, _ = moe.mla_apply(cfg, p, xb[:, t:t + 1], pos[:, t:t + 1],
                                  cache=dict(cache, idx=t))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            assert torch.isfinite(o1).all()
    assert launch_counts()["flash_attention_fwd"] == 0   # the plain path
    steps = np.array(steps) * 1e3
    per_token = (kvr + dr) * 2
    gqa = 2 * cfg.n_heads * (cfg.qk_nope_dim + dr) * 2
    log(f"{tag} (i) one MLA layer of {MLA_ARCH} at its published widths "
        f"({cfg.n_heads} heads, q_lora {cfg.q_lora_rank}, kv_lora {kvr}, "
        f"nope {cfg.qk_nope_dim} + rope {dr}, v {cfg.v_head_dim}; "
        f"{n_params} parameters, {cfg.param_dtype}): prefill {B} x {S} "
        f"through the plain chunked attention {1e3 * t_prefill:.6f} ms; "
        f"{MLA_DECODE} decode steps over the compressed cache ({per_token} "
        f"bytes a token a layer against {gqa} for uncompressed keys and "
        f"values): p50 {np.percentile(steps, 50):.6f} ms, p99 "
        f"{np.percentile(steps, 99):.6f} ms")

    # float32: the prefill against S decode steps over the cache
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = cast_floats(p, "float32")
    x32 = x[:, :S]
    with torch.no_grad():
        o_p, (ck_p, kr_p) = moe.mla_apply(cfg32, p32, x32, pos[:, :S])
        c32 = {"c_kv": torch.zeros(B, S, kvr, device=DEVICE),
               "k_rope": torch.zeros(B, S, 1, dr, device=DEVICE)}
        o_d = torch.cat([moe.mla_apply(cfg32, p32, x32[:, t:t + 1],
                                       pos[:, t:t + 1],
                                       cache=dict(c32, idx=t))[0]
                         for t in range(S)], 1)
    torch.cuda.synchronize()
    rel = 1e-3
    for name, a, b in (("output", o_p, o_d), ("c_kv", ck_p, c32["c_kv"]),
                       ("k_rope", kr_p, c32["k_rope"])):
        e = (a - b).abs().max().item()
        scale = b.abs().max().item()
        tol = rel * max(1.0, scale)
        log(f"{tag} (i) float32 prefill vs {S} decode steps, {name}: "
            f"max_abs_err {e:.6g} (tolerance {tol:.6g} = {rel} x max(1, "
            f"max |decode| = {scale:.6g}))")
        assert np.isfinite(e) and e <= tol, (name, e, tol)
    del tree, p, p32, cache, c32


def smoke_card_vs_cpu(cfg, tag, S):
    """``[lm:mla]`` (ii), ``[lm:griffin]``: a small config (deepseek-v3's
    ``smoke()``: MLA, a dense first layer, sigmoid routing, a shared
    expert, MTP; recurrentgemma's with a group and a tail of two) in
    float32 on the card and on the CPU from the same weights and inputs:
    ``forward``, ``prefill`` of 2 x ``S`` and three decode steps (logits
    and every cache leaf), then ``loss_fn`` with every gradient leaf and
    one AdamW step, each within ``CARD_CPU_TOL``.  Returns the CPU's
    metrics."""
    from repro_torch import optim
    from repro_torch.models import (forward, loss_and_grad,
                                    make_decode_step, make_prefill_step)
    from repro_torch.models.base import tree_leaves, tree_map
    opt = train_opt(moment_dtype="float32")
    card = draw_params(cfg, SEED + 8)
    host = tree_map(lambda a: a.to("cpu", copy=True), card)
    rng = np.random.default_rng(SEED + 8)
    B = 2
    np_in = {k: rng.integers(0, cfg.vocab, shape).astype(np.int32)
             for k, shape in (("tokens", (B, S)), ("labels", (B, S)),
                              ("steps", (3, B, 1)))}
    out = {}
    for where, params in (("card", card), ("cpu", host)):
        t0 = time.perf_counter()
        dev = params["final_norm"].device
        t = {k: torch.from_numpy(v).to(dev) for k, v in np_in.items()}
        r = {}
        with torch.no_grad():
            real = slice(0, cfg.vocab)   # the padding logits are -1e30
            logits, aux = forward(cfg, params, tokens=t["tokens"])
            r["forward"] = logits[..., real]
            if "lb_loss" in aux:
                r["forward lb_loss"] = aux["lb_loss"]
            logits, cache = make_prefill_step(cfg, total_len=S + 3)(
                params, {"tokens": t["tokens"]})
            r["prefill"] = logits[..., real]
            r["prefill cache"] = tree_map(lambda a: a.clone(), cache)
            decode = make_decode_step(cfg)
            for i in range(3):
                _, logits, cache = decode(params, {
                    "cache": cache, "tokens": t["steps"][i], "idx": S + i})
                r[f"decode {i}"] = logits[..., real]
            r["decode cache"] = cache
        (loss, metrics), grads = loss_and_grad(
            cfg, params, {"tokens": t["tokens"], "labels": t["labels"]})
        r["metrics"] = metrics
        r["grads"] = tree_map(lambda a: a.to("cpu", copy=True), grads)
        r["params"], _, _ = optim.update(opt, grads, optim.init(opt, params),
                                         params)
        out[where] = tree_map(lambda a: a.cpu(), r)
        log(f"{tag} smoke {where}: {time.perf_counter() - t0:.3f} s")
    c, h = out["card"], out["cpu"]
    errs = {}
    for key in h:
        if key in ("metrics", "params"):
            continue
        errs[key] = tree_max_err(c[key], h[key])
    loss_err = max(abs(c["metrics"][k].item() - h["metrics"][k].item()) /
                   abs(h["metrics"][k].item()) for k in h["metrics"])
    lr = optim.schedule(opt, torch.tensor(1)).item()
    _, share, n_near, worst, strict = adam_step_share(
        c["params"], h["params"], c["grads"], h["grads"], opt, lr)
    log(f"{tag} smoke config of {cfg.name} ({describe(cfg)}) in float32, "
        f"{B} x {S} tokens, card vs cpu: largest error of a "
        f"leaf over its largest |value| " + ", ".join(
            f"{k} {e:.3g}" for k, (e, _) in errs.items()) +
        f" (bar {CARD_CPU_TOL['grad']:g}); metrics "
        f"{ {k: round(v.item(), 6) for k, v in h['metrics'].items()} }, "
        f"largest relative error {loss_err:.3g} (bar "
        f"{CARD_CPU_TOL['loss']:g}); updated parameters: {share:.3g} of "
        f"the bar ({CARD_CPU_TOL['param']:g} x lr + one float32 ulp; 2 x lr "
        f"+ the ulp at {n_near} elements near 0: {worst}; of the 0.1 lr bar "
        f"everywhere {strict:.3g})")
    for k, (e, leaf) in errs.items():
        assert e <= CARD_CPU_TOL["grad"], (k, e, leaf)
    assert loss_err <= CARD_CPU_TOL["loss"], loss_err
    assert share <= 1.0, (share, worst)
    return h["metrics"]


def mla_smoke_config():
    from repro_torch.configs import get_config, smoke
    cfg = smoke(get_config(MLA_ARCH))
    assert cfg.use_mla and cfg.first_k_dense and cfg.mtp_depth
    return cfg


def griffin_smoke_config():
    import dataclasses
    from repro_torch.configs import get_config, smoke
    cfg = dataclasses.replace(smoke(get_config(GRIFFIN_ARCH)),
                              n_layers=GRIFFIN_SMOKE_LAYERS)
    assert cfg.n_layers % cfg.attn_every == 2
    assert cfg.sliding_window < SMOKE_S[GRIFFIN_ARCH]   # the ring wraps
    return cfg


def run_train_ssm(params32, profile):
    """``[train:ssm]``: (b) mamba2-2.7b at full width and ``LM_DEPTH``
    from ``[lm:ssm]``'s float32 ``params32``, (c) its widths at
    ``CHECK_LAYERS`` layers, card against CPU.  Returns the launch counts
    of (b)."""
    t0 = time.perf_counter()
    launches, full = train_full_width(lm_config(SSM_ARCH), params32,
                                      profile, "[train:ssm]")
    del params32
    log(f"[time] [train:ssm] (b) {time.perf_counter() - t0:.3f} s")
    vs_cpu = train_card_vs_cpu(SSM_ARCH, "[train:ssm]")
    log(f"[time] [train:ssm] (c) {time.perf_counter() - t0:.3f} s")
    return launches, dict(full=full, vs_cpu=vs_cpu)


def run_train_griffin(params32, profile):
    """``[train:griffin]``: recurrentgemma-9b's full width at a cut depth
    of 3 ``GRIFFIN_TRAIN_GROUPS`` + 2 layers: the first groups of
    ``[lm:griffin]``'s float32 draw and its two tail layers, copied out
    before the full draw is freed.  Returns the launch counts."""
    import dataclasses
    from repro_torch.models.base import tree_map
    full = lm_config(GRIFFIN_ARCH)
    g = GRIFFIN_TRAIN_GROUPS
    cfg = dataclasses.replace(full, n_layers=3 * g + full.n_layers % 3)
    cut = {k: v for k, v in params32.items() if k != "blocks"}
    cut["blocks"] = {k: (tree_map(lambda a: a[:g], v)
                         if k.startswith("g_") else v)
                     for k, v in params32["blocks"].items()}
    cut = tree_map(lambda a: a.clone(), cut)
    params32.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, out = train_full_width(
        cfg, cut, profile, "[train:griffin]",
        f"the [lm:griffin] draw's first {g} groups and its tail")
    log(f"[time] [train:griffin] {time.perf_counter() - t0:.3f} s")
    return launches, out


# ---------------------------------------------------------------------------
# [mesh:train]: the LM across ranks
# ---------------------------------------------------------------------------

def mesh_lm(rank, world, programs, tmp, timeout):
    """``[mesh:train]``'s programs on this rank, each a ``mesh_<name>``:
    the gloo ranks' (2, 2) ("data", "model") mesh, or one NCCL rank's
    (1, 1)."""
    from repro_torch.launch import mesh as lmesh
    shape = MESH_TRAIN_SHAPE if world > 1 else (1, 1)
    dm = lmesh.make_mesh(shape, ("data", "model"), device_type=DEVICE,
                         timeout=timeout)
    out = {}
    for prog in programs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[prog] = globals()[f"mesh_{prog}"](rank, dm, tmp)
        torch.cuda.synchronize()
        out[prog]["seconds_all"] = time.perf_counter() - t0
    return out


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (any dtype)."""
    import hashlib
    raw = t.detach().contiguous().reshape(-1).cpu().view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def mesh_lm_a(rank, dm, tmp):
    """(a): phi3-mini-3.8b at its full width and depth, bfloat16 compute
    and moments (``train_opt``), its state drawn onto the mesh from
    ``SEED`` (each rank draws every leaf on the host and keeps its
    block), ``MESH_TRAIN_STEPS`` steps of ``make_train_step`` on
    ``[train]``'s batches."""
    from repro_torch import data
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.models import steps
    cfg = get_config(LM_ARCH)
    opt = train_opt()
    t0 = time.perf_counter()
    sh = steps.train_state_shardings(cfg, opt, dm)
    p, o = steps.init_train_state(cfg, opt, torch.Generator().manual_seed(
        SEED), shardings=sh)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                           global_batch=TRAIN_B, seed=SEED)
    step = steps.make_train_step(cfg, opt)
    losses, norms, times = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with shd.use_mesh(dm):
        for i in range(MESH_TRAIN_STEPS):
            b = steps.place_batch(data.lm_batch(dcfg, i, device="cpu"), dm)
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, o, m = step(p, o, b)
            losses.append(float(shd.local(m["loss"])))
            norms.append(float(shd.local(m["grad_norm"])))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    return dict(losses=losses, norms=norms, times=times,
                peak=torch.cuda.max_memory_allocated(), state_gib=state_gib,
                t_init=t_init, launches=launch_counts(),
                local_heads=p["blocks"]["attn"]["wq"].to_local().shape[-1]
                // cfg.hd)


def strict_config():
    """(b)'s model: phi3's widths at ``CHECK_LAYERS`` layers in float32,
    AdamW with float32 moments (``[train]`` (c)'s)."""
    import dataclasses
    from repro_torch.configs import get_config
    return (dataclasses.replace(get_config(LM_ARCH), n_layers=CHECK_LAYERS,
                                compute_dtype="float32"),
            train_opt(moment_dtype="float32"))


def strict_batch(cfg, device):
    from repro_torch import data
    return data.lm_batch(data.DataConfig(
        vocab=cfg.vocab, seq_len=MESH_CHECK_S, global_batch=MESH_CHECK_B,
        seed=SEED + 5), 0, device=device)


def mesh_lm_b(rank, dm, tmp):
    """(b): the float32 strict check's step on the mesh, its loss,
    gradients and updated parameters gathered, and on rank 0 the same
    step in one process on the card (no mesh) from the same draw, the two
    compared under ``CARD_CPU_TOL``.  The state is drawn on the host and
    placed, every rank keeping its block, both timed."""
    from repro_torch import optim
    from repro_torch import sharding as shd
    from repro_torch.models import init_params, model_layout, steps
    from repro_torch.models.base import tree_map
    cfg, opt = strict_config()
    sh = steps.train_state_shardings(cfg, opt, dm)
    t0 = time.perf_counter()
    host = init_params(model_layout(cfg), torch.Generator().manual_seed(
        SEED + 5), cfg.param_dtype, "cpu")
    t_draw = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = shd.place(host, sh["params"])
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    o = steps.init_opt_state(cfg, opt, sh)
    b = steps.place_batch(strict_batch(cfg, "cpu"), dm)
    with shd.use_mesh(dm):
        (loss, _), grads = steps.loss_and_grad(cfg, p, b)
        # a copy: the update clips the gradients in place
        g_mesh = tree_map(lambda g: shd.full(g).to("cpu", copy=True), grads)
        p, _, gn = optim.update(opt, grads, o, p)
        p_mesh = tree_map(lambda x: shd.full(x).cpu(), p)
    out = dict(place_s=place_s, t_draw=t_draw)
    if rank != 0:
        return out
    del p, o, grads
    one = tree_map(lambda a: a.to(DEVICE), host)
    (loss1, _), grads = steps.loss_and_grad(cfg, one, strict_batch(cfg,
                                                                   DEVICE))
    g_one = tree_map(lambda g: g.to("cpu", copy=True), grads)
    one, _, gn1 = optim.update(opt, grads, optim.init(opt, one), one)
    lr = optim.schedule(opt, torch.tensor(1)).item()
    moved, share, n_near, worst, strict = adam_step_share(
        p_mesh, one, g_mesh, g_one, opt, lr)
    grad_err, grad_leaf = tree_max_err(g_mesh, g_one)
    out.update(loss=float(shd.local(loss)), loss1=loss1.item(),
               gn=float(gn), gn1=gn1.item(), grad_err=grad_err,
               grad_leaf=grad_leaf, moved=moved, lr=lr, share=share,
               n_near=n_near, worst=worst, strict=strict)
    return out


def elastic_setup():
    import dataclasses
    from repro_torch import data
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=MESH_ELASTIC_LAYERS)
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=DRIVER_S,
                           global_batch=DRIVER_B, seed=SEED)
    loop = T.TrainLoopConfig(steps=MESH_ELASTIC_STEPS,
                             ckpt_every=MESH_ELASTIC_STEPS - 2,
                             sync_ckpt=True, seed=SEED)
    return cfg, dcfg, loop


def mesh_lm_c(rank, dm, tmp):
    """(c): ``launch/train.py::train`` over the mesh at phi3's widths and
    ``MESH_ELASTIC_LAYERS`` layers (bfloat16), checkpoints after the last
    two steps; the digests of its final state, gathered."""
    import dataclasses
    from repro_torch.launch import train as T
    cfg, dcfg, loop = elastic_setup()
    t0 = time.perf_counter()
    res = T.train(cfg, train_opt(), dataclasses.replace(
        loop, ckpt_dir=os.path.join(tmp, "elastic")), dcfg, mesh=dm)
    return dict(losses=res.losses, seconds=time.perf_counter() - t0,
                digests=[digest(x.full_tensor()) for _, x in
                         named_leaves(res.state)])


def mesh_lm_c1(rank, dm, tmp):
    """(c) on one NCCL rank: the four ranks' last checkpoint restored
    onto this mesh (digests), and ``train`` resumed from the one before
    it for the last step."""
    import dataclasses
    from repro_torch import sharding as shd
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as T
    from repro_torch.models import steps
    cfg, dcfg, loop = elastic_setup()
    opt = train_opt()
    d4 = os.path.join(tmp, "elastic")
    mgr = CheckpointManager(d4)
    last = mgr.latest_step()
    params, _, ostate, _ = steps.abstract_train_state(cfg, opt)
    t0 = time.perf_counter()
    st = mgr.restore(last, {"params": params, "opt": ostate},
                     steps.train_state_shardings(cfg, opt, dm))
    t_restore = time.perf_counter() - t0
    digests = [digest(shd.full(x)) for _, x in named_leaves(st)]
    del st
    d1 = os.path.join(tmp, "elastic1")
    shutil.copytree(os.path.join(d4, f"step_{last - 1}"),
                    os.path.join(d1, f"step_{last - 1}"))
    res = T.train(cfg, opt, dataclasses.replace(loop, ckpt_dir=d1), dcfg,
                  mesh=dm)
    return dict(last=last, digests=digests, t_restore=t_restore,
                losses=res.losses, restored=res.restored_from)


def moe_check_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=CHECK_LAYERS,
                               compute_dtype="float32", moe_capacity=64.0)


def moe_check_batch(cfg, device):
    from repro_torch import data
    return data.lm_batch(data.DataConfig(
        vocab=cfg.vocab, seq_len=MESH_TRAIN_MOE_S,
        global_batch=MESH_TRAIN_MOE_B, seed=SEED + 6), 0, device=device)


def mesh_lm_d(rank, dm, tmp):
    """(d): granite-moe's widths at ``CHECK_LAYERS`` layers in float32,
    drop-free: ``loss_and_grad`` over the mesh, every MoE layer through
    ``moe_apply_shardmap`` (counted), gradients gathered; rank 0 takes
    the same gradients in one process (``moe_apply``) and compares."""
    from repro_torch import sharding as shd
    from repro_torch.models import init_params, model_layout, moe, steps
    from repro_torch.models.base import tree_map
    cfg = moe_check_config()
    sh = steps.train_state_shardings(cfg, train_opt(), dm)
    p = init_params(model_layout(cfg), torch.Generator().manual_seed(
        SEED + 6), cfg.param_dtype, shardings=sh["params"])
    b = steps.place_batch(moe_check_batch(cfg, "cpu"), dm)
    calls = []
    inner = moe.moe_apply_shardmap

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    moe.moe_apply_shardmap = counted
    try:
        with shd.use_mesh(dm):
            (loss, m), grads = steps.loss_and_grad(cfg, p, b)
            g_full = tree_map(lambda g: shd.full(g).cpu(), grads)
    finally:
        moe.moe_apply_shardmap = inner
    out = dict(calls=len(calls),
               experts_local=p["blocks"]["moe"]["experts"]["w_up"]
               .to_local().shape[1])
    if rank != 0:
        return out
    del p, grads
    one = init_params(model_layout(cfg), torch.Generator().manual_seed(
        SEED + 6), cfg.param_dtype, DEVICE)
    (loss1, m1), grads = steps.loss_and_grad(cfg, one,
                                             moe_check_batch(cfg, DEVICE))
    grad_err, grad_leaf = tree_max_err(g_full, grads)
    out.update(loss=float(shd.local(loss)), loss1=loss1.item(),
               lb=float(shd.local(m["lb_loss"])), lb1=m1["lb_loss"].item(),
               grad_err=grad_err, grad_leaf=grad_leaf)
    return out


def mesh_lm_e(rank, dm, tmp):
    """(e) on one NCCL rank: (a)'s step at ``CHECK_LAYERS`` layers through
    the one-rank mesh and without a mesh, from one draw and batch,
    deterministic algorithms on (the embedding's backward adds without
    atomics): the loss, the gradient norm and every leaf of the updated
    state, bit for bit."""
    import dataclasses
    from repro_torch import data
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.models import steps
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=CHECK_LAYERS)
    opt = train_opt()
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                           global_batch=TRAIN_B, seed=SEED)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, mesh in (("mesh", dm), ("plain", None)):
            sh = None if mesh is None else \
                steps.train_state_shardings(cfg, opt, mesh)
            p, o = steps.init_train_state(
                cfg, opt, torch.Generator().manual_seed(SEED), DEVICE,
                shardings=sh)
            b = data.lm_batch(dcfg, 0, device="cpu")
            b = steps.place_batch(b, mesh) if mesh is not None else \
                {k: v.to(DEVICE) for k, v in b.items()}
            with shd.use_mesh(mesh):
                p, o, m = steps.make_train_step(cfg, opt)(p, o, b)
            out[name] = (float(shd.local(m["loss"])),
                         float(shd.local(m["grad_norm"])),
                         [digest(shd.full(x)) for _, x in
                          named_leaves({"params": p, "opt": o})])
            del p, o
    finally:
        torch.use_deterministic_algorithms(False)
    return dict(mesh=out["mesh"], plain=out["plain"])


def run_mesh_train(train_first_loss):
    """Phase ``[mesh:train]`` (see the module docstring); ``train_first_
    loss`` is ``[train]`` (b)'s one-process first loss at full depth.
    Returns the flash launches of (a), the main path, summed over the
    ranks."""
    import tempfile
    card = card_line()
    ref = train_first_loss
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh-train-", dir=build_dir)
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        outs = spawn_ranks(MESH_RANKS, "gloo", tmp,
                           ["lm_a", "lm_b", "lm_c", "lm_d"])
        t_gloo = time.perf_counter() - t0
        # -- (a) ------------------------------------------------------------
        a = [o["lm_a"] for o in outs]
        losses = a[0]["losses"]
        assert all(x["losses"] == losses for x in a), \
            [x["losses"] for x in a]
        err = abs(losses[0] - ref) / abs(ref)
        times = np.array(a[0]["times"]) * 1e3
        # the first step is a warm-up: the p50 is over the later ones
        p50 = float(np.percentile(times[1:], 50))
        flash = [x["launches"]["flash_attention_fwd"] for x in a]
        want = 2 * LM_LAYERS * MESH_TRAIN_STEPS
        for r, x in enumerate(a):
            log(f"[mesh:train] (a) rank {r}: state {x['state_gib']:.3f} GiB "
                f"drawn onto the mesh in {x['t_init']:.3f} s, peak device "
                f"memory {x['peak'] / 2 ** 30:.3f} GiB, step times "
                f"{[round(t * 1e3, 3) for t in x['times']]} ms, flash "
                f"launches {x['launches']['flash_attention_fwd']} on "
                f"{x['local_heads']} local heads ({card})")
        log(f"[mesh:train] (a) phi3-mini-3.8b at full width, "
            f"{LM_LAYERS} layers, bfloat16, AdamW with bfloat16 "
            f"moments, {MESH_TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} "
            f"tokens on a {MESH_TRAIN_SHAPE} (data, model) mesh of "
            f"{MESH_RANKS} gloo ranks sharing the card: losses {losses} on "
            f"every rank, grad norms {a[0]['norms']}; the first loss "
            f"{err:.3e} from the one-process step's {ref:.9g} (bar "
            f"{MESH_TRAIN_TOL:g}); the warm-up step {times[0]:.3f} ms, "
            f"step p50 {p50:.6f} ms over the {len(times) - 1} after it "
            f"({TRAIN_B * TRAIN_S / p50 * 1e3:.1f} tokens/s), peak "
            f"{max(x['peak'] for x in a) / 2 ** 30:.3f} GiB a rank; flash "
            f"kernel launches a rank {flash} (2 a layer a step: {want}); "
            f"{card}")
        assert err <= MESH_TRAIN_TOL, (losses[0], ref)
        assert all(np.isfinite(losses + a[0]["norms"]))
        assert all(f == want for f in flash), flash
        counts = {}
        for x in a:
            for k, v in x["launches"].items():
                counts[k] = counts.get(k, 0) + v
        # -- (b) ------------------------------------------------------------
        b = outs[0]["lm_b"]
        loss_err = abs(b["loss"] - b["loss1"]) / abs(b["loss1"])
        log(f"[mesh:train] (b) {CHECK_LAYERS} layers of phi3 at full width "
            f"in float32, {MESH_CHECK_B} x {MESH_CHECK_S} tokens, one AdamW "
            f"step on the {MESH_RANKS} ranks against one process on the "
            f"card: loss {b['loss']:.9g} vs {b['loss1']:.9g} (relative "
            f"{loss_err:.3g}, bar {CARD_CPU_TOL['loss']:g}); grad norm "
            f"{b['gn']:.9g} vs {b['gn1']:.9g}; gradients: largest error "
            f"{b['grad_err']:.3g} of its leaf's largest (leaf "
            f"{b['grad_leaf']}; bar {CARD_CPU_TOL['grad']:g}); parameters: "
            f"largest difference {b['moved']:.3g} = "
            f"{b['moved'] / b['lr']:.3g} lr, the largest share of its bar "
            f"{b['share']:.3g} ({b['n_near']} elements near 0 held to 2 "
            f"lr; {b['worst']}; of 0.1 lr everywhere {b['strict']:.3g}); "
            f"the state drawn on the host in {b['t_draw']:.3f} s and placed "
            f"in {b['place_s']:.3f} s, every rank keeping its block; "
            f"{card}")
        assert loss_err <= CARD_CPU_TOL["loss"], loss_err
        assert b["grad_err"] <= CARD_CPU_TOL["grad"], b["grad_err"]
        assert b["share"] <= 1.0, (b["moved"], b["share"], b["worst"])
        # -- (d) ------------------------------------------------------------
        d = [o["lm_d"] for o in outs]
        loss_err = abs(d[0]["loss"] - d[0]["loss1"]) / abs(d[0]["loss1"])
        log(f"[mesh:train] (d) granite-moe-3b-a800m's widths at "
            f"{CHECK_LAYERS} layers in float32, drop-free (capacity factor "
            f"64), {MESH_TRAIN_MOE_B} x {MESH_TRAIN_MOE_S} tokens: "
            f"{d[0]['calls']} calls of moe_apply_shardmap a rank with "
            f"{d[0]['experts_local']} experts each; loss {d[0]['loss']:.9g} "
            f"vs one process's moe_apply {d[0]['loss1']:.9g} (relative "
            f"{loss_err:.3g}), lb_loss {d[0]['lb']:.9g} vs "
            f"{d[0]['lb1']:.9g}; gradients: largest error "
            f"{d[0]['grad_err']:.3g} of its leaf's largest (leaf "
            f"{d[0]['grad_leaf']}; bar 1e-5); {card}")
        e_rank = moe_check_config().experts_padded // MESH_TRAIN_SHAPE[1]
        assert all(x["calls"] >= CHECK_LAYERS and
                   x["experts_local"] == e_rank for x in d), d
        assert d[0]["grad_err"] <= 1e-5, (d[0]["grad_err"],
                                          d[0]["grad_leaf"])
        # -- (c), (e): one NCCL rank ----------------------------------------
        t0 = time.perf_counter()
        nccl = spawn_ranks(1, "nccl", tmp, ["lm_c1", "lm_e"])[0]
        t_nccl = time.perf_counter() - t0
        c4 = outs[0]["lm_c"]
        c1 = nccl["lm_c1"]
        assert all(o["lm_c"]["digests"] == c4["digests"] for o in outs)
        assert c1["digests"] == c4["digests"], "restored != gathered"
        assert c1["restored"] == c1["last"] - 1 and len(c1["losses"]) == 1
        c_err = abs(c1["losses"][0] - c4["losses"][-1]) / \
            abs(c4["losses"][-1])
        log(f"[mesh:train] (c) launch/train.py::train over the "
            f"{MESH_RANKS} ranks, {MESH_ELASTIC_LAYERS} layer of phi3 at "
            f"full width, {DRIVER_B} x "
            f"{DRIVER_S} tokens, checkpoints after steps "
            f"{MESH_ELASTIC_STEPS - 2} and {MESH_ELASTIC_STEPS - 1}: losses "
            f"{c4['losses']} in {c4['seconds']:.3f} s; 1 NCCL rank restored "
            f"its step-{c1['last']} checkpoint onto a one-rank mesh in "
            f"{c1['t_restore']:.3f} s, all {len(c4['digests'])} leaves bit "
            f"for bit the state the ranks gathered; resumed from step "
            f"{c1['restored']}, its step {c1['last']} loss "
            f"{c1['losses'][0]:.9g} vs the {MESH_RANKS} ranks' "
            f"{c4['losses'][-1]:.9g} (relative {c_err:.3g}, bar "
            f"{MESH_TRAIN_TOL:g})")
        assert c_err <= MESH_TRAIN_TOL, c_err
        e = nccl["lm_e"]
        assert e["mesh"] == e["plain"], (e["mesh"][:2], e["plain"][:2])
        log(f"[mesh:train] (e) 1 NCCL rank, (a)'s step at {CHECK_LAYERS} "
            f"layers through a one-rank (1, 1) mesh and without one, "
            f"deterministic algorithms: loss {e['mesh'][0]:.9g}, grad norm "
            f"{e['mesh'][1]:.9g}, all {len(e['mesh'][2])} leaves of the "
            f"updated state bit for bit equal; {t_nccl:.3f} s with the "
            f"spawn.  The {MESH_RANKS} gloo ranks took {t_gloo:.3f} s with "
            f"the spawn; rank 0's programs: " + ", ".join(
                f"{k} {v['seconds_all']:.3f} s" for k, v in
                list(outs[0].items()) + list(nccl.items())
                if isinstance(v, dict) and "seconds_all" in v))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts

def run_mla():
    """``[lm:mla]``: deepseek-v3-671b in the two forms one card holds."""
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_params, model_layout, tree_bytes
    cfg = get_config(MLA_ARCH)
    n = tree_bytes(abstract_params(model_layout(cfg), "bfloat16")) // 2
    log(f"[lm:mla] {MLA_ARCH} has {n} parameters by its layout "
        f"({cfg.param_count()} by param_count; {2 * n / 1e12:.3f} TB in "
        f"bfloat16): it fits no single card at any precision, so it runs "
        f"as (i) one MLA layer at its published widths and (ii) its "
        f"smoke() config")
    t0 = time.perf_counter()
    mla_layer("[lm:mla]")
    log(f"[time] [lm:mla] (i) {time.perf_counter() - t0:.3f} s")
    smoke = smoke_card_vs_cpu(mla_smoke_config(), "[lm:mla] (ii)",
                              SMOKE_S[MLA_ARCH])
    assert sorted(smoke) == ["lb_loss", "loss", "mtp_loss", "nll"]
    log(f"[time] [lm:mla] (ii) {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# [examples]: the seven examples on the card
# ---------------------------------------------------------------------------

def load_example(name):
    """``examples_torch/<name>.py`` as a module."""
    import importlib.util
    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples():
    """``[examples]``: the seven examples of ``examples_torch/`` through
    their ``main``, in this process on the card, at the reference's
    sizes (``train_lm`` at ``EXAMPLE_TRAIN_STEPS`` steps, its checkpoints
    under ``EXAMPLE_CKPT``, removed at the end); each example's own checks
    hold, and quickstart's results equal its run on the CPU here bit for
    bit.  Returns the kernel launches of the seven runs."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    want = load_example("quickstart").main(["--device", "cpu"])
    log(f"[examples] quickstart on the CPU in "
        f"{time.perf_counter() - t0:.3f} s")
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    runs = (("quickstart", []), ("open_loop_pipeline", []),
            ("durable_pipeline", []), ("overload_degradation", []),
            ("ycsb_serve", []),
            ("train_lm", ["--steps", str(EXAMPLE_TRAIN_STEPS),
                          "--ckpt", EXAMPLE_CKPT]),
            ("distributed_index", []))
    total = {name: 0 for name in launch_counts()}
    out = {}
    try:
        for name, extra in runs:
            mod = load_example(name)
            reset_launches()
            t0 = time.perf_counter()
            out[name] = mod.main(["--device", DEVICE] + extra)
            torch.cuda.synchronize()
            counts = launch_counts()
            log(f"[examples] {name} on the card in "
                f"{time.perf_counter() - t0:.3f} s; kernel launches {counts}")
            for k, v in counts.items():
                total[k] += v
            out[name + ":launches"] = counts
    finally:
        shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    got = out["quickstart"]
    assert got == want, ("quickstart: card and CPU differ", got, want)
    log(f"[examples] quickstart's results on the card equal the CPU's bit "
        f"for bit: {got}")
    # the kernels each example reaches (ROADMAP B)
    for name in ("quickstart", "open_loop_pipeline", "durable_pipeline",
                 "overload_degradation", "ycsb_serve", "distributed_index"):
        c = out[name + ":launches"]
        assert c["pi_probe"] >= 1 and c["bitonic_sort"] >= 1, (name, c)
    assert out["quickstart:launches"]["pi_range"] >= 1
    assert out["train_lm:launches"]["flash_attention_fwd"] >= \
        EXAMPLE_TRAIN_STEPS
    assert out["distributed_index:launches"]["pi_probe"] >= SHARDS * 8
    assert out["durable_pipeline"]["same"]
    assert sorted(out["ycsb_serve"]["done"]) == list(range(1000, 1010))
    log(f"[examples] every example's checks hold; the seven in "
        f"{time.perf_counter() - t_phase:.3f} s")
    return total


# ---------------------------------------------------------------------------
# [roofline]: the census of the LM phases' steps, priced at the H100's rates
# ---------------------------------------------------------------------------

def lm_cells(lm, peaks, cells=None):
    """Adds an ``[lm*]`` phase's prefill and decode step to ``[roofline]``'s
    cells (their measured host and device times) and the prefill's peak to
    ``peaks``; returns (cells, peaks)."""
    cells = [] if cells is None else cells
    cfg = lm["cfg"]
    tag = LM_TAGS[cfg.family]
    cells.append((tag, cfg, "prefill", PREFILL_B, PREFILL_S, lm["t_prefill"],
                  lm["split_prefill"][0] / 1e3))
    cells.append((tag, cfg, "decode", PREFILL_B, PREFILL_S,
                  float(np.percentile(lm["steps"], 50)) / 1e3,
                  lm["split_decode"][0] / 1e3))
    peaks[(tag, "prefill")] = lm["prefill_peak"]
    return cells, peaks


def train_cell(tag, full, cells, peaks):
    """Adds a ``[train*]`` phase's step (its p50) and peak."""
    cells.append((tag, full["cfg"], "train", TRAIN_B, TRAIN_S,
                  full["p50"] / 1e3, None))
    peaks[(tag, "train")] = full["step_peak"]


def step_census(cfg, kind, B, S):
    """The census of one step of ``cfg`` as an LM phase ran it on the card
    (``kind``: "prefill" of B x S tokens into a cache of S +
    ``DECODE_STEPS``, "decode" of B tokens over that cache, "train" on B x
    S tokens with ``train_opt()``), on ``meta`` tensors."""
    from repro_torch import optim
    from repro_torch.models import (abstract_params, cast_floats,
                                    make_decode_step, make_prefill_step,
                                    make_train_step, model_layout)
    from repro_torch.models import decode as dec
    from repro_torch.roofline import census
    params = abstract_params(model_layout(cfg), cfg.param_dtype)

    def toks(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    if kind == "train":
        opt = train_opt()
        args = (params, optim.init(opt, params),
                {"tokens": toks(B, S), "labels": toks(B, S)})
        return census.analyze(make_train_step(cfg, opt), *args)
    params = cast_floats(params, cfg.compute_dtype)
    T = S + DECODE_STEPS
    if kind == "prefill":
        return census.analyze(make_prefill_step(cfg, total_len=T), params,
                              {"tokens": toks(B, S)})
    cache = dec.init_cache(cfg, B, T, device="meta")
    return census.analyze(make_decode_step(cfg), params, {
        "cache": cache, "tokens": toks(B, 1), "idx": T - 1})


def run_roofline(cells, peaks):
    """``[roofline]``, on the host: the census of each step an LM phase
    timed (``cells``: (tag, cfg, kind, B, S, measured seconds, device
    seconds or None)), its roofline at the H100's rates
    (``repro_torch.roofline.model``), MFU and share (roofline time over
    measured time, which must not pass ``ROOFLINE_SHARE_MAX``); the
    census's peak bytes beside ``max_memory_allocated`` (``peaks``: (tag,
    kind) → the step's own peak on the card, its arguments' bytes
    included), within ``PEAK_TOL`` either way for ``PEAK_CHECKED``; then
    the production dry-run cell ``ROOFLINE_CELL`` over a fake 256-rank
    mesh.  Returns the shares and the cell's result."""
    import torch.distributed as tdist
    from repro_torch.roofline.model import model_flops_for, roofline
    t_phase = time.perf_counter()
    shares = {}
    for tag, cfg, kind, B, S, measured, device_s in cells:
        t0 = time.perf_counter()
        st = step_census(cfg, kind, B, S)
        seq = 1 if kind == "decode" else S
        mf = model_flops_for(cfg, kind, S, B)
        rl = roofline(st.dot_flops, st.traffic_bytes_fused,
                      st.collective_bytes, 1, mf)
        share = rl.step_time_s / measured
        shares[(tag, kind)] = share
        dev = "" if device_s is None else \
            f", {rl.step_time_s / device_s:.4f} of its device time " \
            f"{1e3 * device_s:.6f} ms"
        log(f"[roofline] {tag} {kind} {B} x {seq}: {st.dot_flops:.6e} "
            f"FLOPs, {st.traffic_bytes:.6e} bytes, peak "
            f"{st.peak_bytes / 2**30:.3f} GiB (arguments "
            f"{st.argument_bytes / 2**30:.3f}); roofline compute "
            f"{1e3 * rl.compute_s:.6f} ms, memory {1e3 * rl.memory_s:.6f} "
            f"ms, step {1e3 * rl.step_time_s:.6f} ms ({rl.bottleneck}), MFU "
            f"{rl.mfu:.6f} at the roofline, "
            f"{mf / (measured * BF16_OPS_PER_S):.6f} measured; measured "
            f"{1e3 * measured:.6f} ms: share {share:.4f}{dev} "
            f"(census {time.perf_counter() - t0:.3f} s)")
        if (tag, kind) in peaks:
            got = peaks[(tag, kind)]
            ratio = st.peak_bytes / got
            log(f"[roofline] {tag} {kind} peak: census "
                f"{st.peak_bytes / 2**30:.3f} GiB, max_memory_allocated "
                f"{got / 2**30:.3f} GiB (the step's own, its arguments "
                f"included): {ratio:.4f}")
            if (tag, kind) in PEAK_CHECKED:
                assert abs(ratio - 1) <= PEAK_TOL, (tag, kind, ratio)
        assert share <= ROOFLINE_SHARE_MAX, (tag, kind, share)
    assert all(key in shares and key in peaks for key in PEAK_CHECKED), \
        (list(shares), list(peaks))
    t0 = time.perf_counter()
    if tdist.is_initialized():
        raise RuntimeError("[roofline] the dry run needs this process "
                           "without a process group")
    from repro_torch.launch import dryrun
    try:
        res = dryrun.lower_cell(*ROOFLINE_CELL)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    assert res["status"] == "ok", res
    rl = res["roofline"]
    log(f"[roofline] dry run {'/'.join(ROOFLINE_CELL)} ({res['chips']} "
        f"ranks, rank 0 counted on meta): {res['hlo']['dot_flops']:.6e} "
        f"FLOPs, {res['hlo']['traffic_bytes']:.6e} bytes, collectives "
        f"{res['hlo']['collective_bytes_by_kind']}; arguments "
        f"{res['memory']['argument_bytes'] / 2**30:.3f} GiB, peak "
        f"{res['hlo']['peak_bytes'] / 2**30:.3f} GiB a card; roofline "
        f"compute {rl['compute_s']:.6f} s, memory {rl['memory_s']:.6f} s, "
        f"collective {rl['collective_s']:.6f} s: {rl['bottleneck']}-bound "
        f"at {rl['step_time_s']:.6f} s, MFU {rl['mfu']:.6f} (in "
        f"{time.perf_counter() - t0:.3f} s)")
    log(f"[roofline] the phase in {time.perf_counter() - t_phase:.3f} s")
    return shares, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="WINDOWS",
                    help="also profile this many windows (off: 0)")
    args = ap.parse_args(argv)

    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2

    from repro_torch import core as pi
    from repro_torch import data
    from repro_torch.kernels import build as kbuild

    # -- 1. build --------------------------------------------------------
    t_start = t0 = time.perf_counter()
    kbuild.build()
    log(f"[build] kernels built/loaded in {time.perf_counter() - t0:.3f} s "
        f"into {kbuild.BUILD_DIR}")
    ptxas = "".join(kbuild.build_log(name) for name in kbuild.SIGNATURES)
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    log(f"[build] {len(regs)} kernel instantiations, at most "
        f"{max(regs, default=0)} registers a thread, spill stores "
        f"{sorted(set(spills)) or 'not reported'}")
    card = card_line()
    log(f"[card] {card}")
    pilint_cli = run_pilint()
    n_keys = N_KEYS
    ycfg = data.YCSBConfig(n_keys=n_keys, key_space=1 << 30, batch=8192,
                           write_ratio=0.5, theta=0.9, seed=SEED)
    cfg = pi.PIConfig(capacity=2 * n_keys,
                      pending_capacity=max(8192 * 4, n_keys // 4),
                      fanout=8, backend="cuda")
    t0 = time.perf_counter()
    keys_np, vals_np = data.ycsb_dataset(ycfg)
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx0 = pi.build(cfg, keys_np, vals_np, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[index] n={n_keys} C={cfg.capacity} PC={cfg.pending_capacity} "
        f"F={cfg.fanout} W={cfg.seg_width_eff} S={cfg.num_segments} "
        f"H={cfg.num_levels} D={cfg.max_dirty}; data {t_data:.3f} s, "
        f"build {time.perf_counter() - t0:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card")

    # -- 2. kernels against their plain versions -------------------------
    rng = np.random.default_rng(SEED + 1)
    fresh = rng.integers(0, ycfg.key_space, cfg.pending_capacity // 4) \
        .astype(np.int32)
    q = mixed_queries(rng, keys_np, fresh, ycfg.batch, ycfg.key_space)
    window_keys = torch.from_numpy(data.ycsb_batch(ycfg, keys_np, 0)[1])
    window_keys = window_keys.to(DEVICE)
    check_kernels(idx0, q, window_keys, "fresh", ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    filled, _ = pi.insert_batch(idx0, torch.from_numpy(fresh).to(DEVICE),
                                torch.from_numpy(fresh).to(DEVICE))
    q = mixed_queries(rng, keys_np, fresh, ycfg.batch, ycfg.key_space)
    timing = check_kernels(filled, q, window_keys, "pending-filled", ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    lo, hi = range_queries(rng, keys_np, ycfg.batch, ycfg.key_space)
    range_fresh = check_range_kernel(idx0, lo, hi, "fresh", ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    dead = np.concatenate([rng.choice(keys_np, ycfg.batch // 2),
                           rng.choice(fresh, ycfg.batch // 2)])
    filled, _ = pi.delete_batch(filled, torch.from_numpy(dead).to(DEVICE))
    lo, hi = range_queries(rng, keys_np, ycfg.batch, ycfg.key_space)
    range_timing = check_range_kernel(filled, lo, hi, "pending-filled+deletes",
                                      ITERS)
    assert range_fresh["budget"] > 0 and range_timing["budget"] > 0, \
        "no check lane spends the walk's budget"
    lo, hi = ycsb_e_lanes(ycfg, keys_np, SEED + 5)
    range_ycsb = check_range_kernel(idx0, lo, hi, "ycsb-e window, fresh",
                                    ITERS)
    range_ycsb_p = check_range_kernel(
        filled, lo, hi, "ycsb-e window, pending-filled+deletes", ITERS)
    del filled
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    bitonic = check_bitonic(rng, window_keys, ITERS)
    pilint_cli()
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 3. the main path -------------------------------------------------
    batches_np = [data.ycsb_batch(ycfg, keys_np, w)
                  for w in range(WINDOWS)]
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in b)
               for b in batches_np]
    lookup_np = np.concatenate([
        rng.choice(keys_np, ycfg.batch // 2),
        rng.integers(-5, ycfg.key_space, ycfg.batch // 2)]).astype(np.int32)
    lookup_q = torch.from_numpy(lookup_np).to(DEVICE)

    for backend in ("cuda", "torch"):   # warm-up: first-call costs
        run_main_path(pi.with_backend(idx0, backend), batches[:2], lookup_q)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run_cuda = run_main_path(idx0, batches, lookup_q)
    launches = launch_counts()
    # a window: one execute (one probe, one sort); then the rebuild and
    # the repack launch nothing, the lookup one probe, the traverse one
    # search
    expect_launches("[main:cuda]", {
        "core.execute": WINDOWS, "pi_probe": WINDOWS + 1,
        "bitonic_sort": WINDOWS, "pi_search": 1, "pipeline.ranges": 0,
        "pi_range": 0, "flash_attention_fwd": 0})
    peak = torch.cuda.max_memory_allocated()
    summarize("cuda", run_cuda, ycfg.batch)
    single_p50 = float(np.percentile(np.array(run_cuda["lat"]) * 1e3, 50))
    log(f"[main:cuda] kernel launches {launches}; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    assert run_cuda["incremental"], "rebuild after the windows: not incremental"

    t0 = time.perf_counter()
    order = np.argsort(keys_np)
    base = (dict(zip(keys_np.tolist(), vals_np.tolist())),
            keys_np[order].astype(np.int64), vals_np[order].astype(np.int64))
    ref = pi.RefIndex(dict(base[0]))
    check_against_ref(ref, batches_np, run_cuda, lookup_np)
    del ref
    log(f"[main:cuda] {WINDOWS} windows x {ycfg.batch} ops, both "
        f"rebuild tiers, lookup and traverse agree with RefIndex "
        f"(checked in {time.perf_counter() - t0:.3f} s)")

    run_torch = run_main_path(pi.with_backend(idx0, "torch"), batches,
                              lookup_q)
    summarize("torch", run_torch, ycfg.batch)
    for w, (a, b) in enumerate(zip(run_cuda["outs"], run_torch["outs"])):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), \
            f"window {w}: cuda and torch backends differ"
    for name, a, b in zip(("windows", "rebuild", "repack"),
                          run_cuda["states"], run_torch["states"]):
        assert same_state(a, b), f"state after {name}: backends differ"
    assert all(torch.equal(a, b) for a, b in zip(run_cuda["reads"],
                                                  run_torch["reads"]))
    log("[main] cuda and torch backends bit-identical: every window's "
        "results and flags, the states after the windows, the rebuild and "
        "the repack, and the reads")

    if args.profile:
        extra = [tuple(torch.from_numpy(a).to(DEVICE)
                       for a in data.ycsb_batch(ycfg, keys_np, w))
                 for w in range(WINDOWS, WINDOWS + args.profile)]
        profile_windows(run_cuda["states"][0], extra,
                        1e3 * run_cuda["t_windows"] / WINDOWS)

    del run_cuda, run_torch, batches
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 4. the serving path ----------------------------------------------
    idx_m, mixed = mixed_setup(cfg, keys_np, vals_np, ycfg)
    serve_launches = run_serving(args, idx0, keys_np, ycfg, base, idx_m,
                                 mixed)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 5. the durable path ----------------------------------------------
    durable_launches = run_durable(idx_m, mixed, ycfg.batch)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 6. the sharded path ----------------------------------------------
    sharded_launches, mesh_ref = run_sharded(args, keys_np, vals_np, ycfg,
                                             base, single_p50)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 6b. the mesh: the sharded index and shard_map parts over ranks ----
    mesh_launches = run_mesh(mesh_ref, keys_np, vals_np, ycfg)
    shard_stream = (len(mesh_ref["stream"]),
                    sum(w[2] is not None for w in mesh_ref["stream"]))
    del mesh_ref
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 7. overload control ------------------------------------------------
    overload_launches = run_overload(idx_m, keys_np, ycfg, base)
    del idx_m
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 8. the flash kernel against its plain version --------------------
    flash = check_flash(ITERS)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 9. the LM path: prefill and decode at full width ------------------
    lm = run_lm(LM_ARCH)
    roof_cells, roof_peaks = lm_cells(lm, {})
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 10. the LM server --------------------------------------------------
    serve_lm_launches = run_serve_lm(lm["cfg"], lm["params"], "[serve:lm]")
    lm_launches, params32 = lm["launches"], lm["params32"]
    del lm
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 11. training: the flash kernel under autograd, phi3-mini steps ----
    train_launches, train_out = run_train(params32, args.profile, 3)
    del params32
    train_cell("[train]", train_out["full"], roof_cells, roof_peaks)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 11b. the LM across ranks ------------------------------------------
    mesh_train_launches = run_mesh_train(train_out["full"]["losses"][0])
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 12. the moe family: granite-moe-3b-a800m served ------------------
    lm = run_lm(MOE_ARCH)
    lm_cells(lm, roof_peaks, roof_cells)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    serve_moe_launches = run_serve_lm(lm["cfg"], lm["params"],
                                      "[serve:lm:moe]")
    moe_launches, params32 = lm["launches"], lm["params32"]
    del lm
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 13. ... and trained ------------------------------------------------
    train_moe_launches, out = run_train_moe(params32, args.profile)
    train_cell("[train:moe]", out["full"], roof_cells, roof_peaks)
    del params32
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 14. the mla_moe family: deepseek-v3's MLA layer and smoke config -
    run_mla()
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 15. the ssm family: mamba2-2.7b served and trained ----------------
    lm = run_lm(SSM_ARCH)
    lm_cells(lm, roof_peaks, roof_cells)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    serve_ssm_launches = run_serve_lm(lm["cfg"], lm["params"],
                                      "[serve:lm:ssm]")
    ssm_launches, params32 = lm["launches"], lm["params32"]
    del lm
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    train_ssm_launches, out = run_train_ssm(params32, args.profile)
    train_cell("[train:ssm]", out["full"], roof_cells, roof_peaks)
    del params32
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 16. the griffin family: recurrentgemma-9b served and trained ------
    lm = run_lm(GRIFFIN_ARCH)
    lm_cells(lm, roof_peaks, roof_cells)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    smoke_card_vs_cpu(griffin_smoke_config(), "[lm:griffin]",
                      SMOKE_S[GRIFFIN_ARCH])
    serve_griffin_launches = run_serve_lm(lm["cfg"], lm["params"],
                                          "[serve:lm:griffin]")
    griffin_launches, params32 = lm["launches"], lm["params32"]
    del lm
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")
    train_griffin_launches, out = run_train_griffin(params32, args.profile)
    del params32
    train_cell("[train:griffin]", out, roof_cells, roof_peaks)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 17. the seven examples on the card --------------------------------
    examples_launches = run_examples()
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 18. the roofline: the census of the LM phases' steps --------------
    run_roofline(roof_cells, roof_peaks)
    log(f"[time] {time.perf_counter() - t_start:.3f} s since the start")

    # -- 19. launch counts ------------------------------------------------
    # the point, serving, durable and sharded paths were held to exact
    # counts in their phases (expect_launches)
    n_sw, n_srw = shard_stream
    # at least once: the windows the controller seals follow its shedding
    # and a breaker's replay executes windows again (run_overload holds
    # the probes to its window count when the breaker did not trip)
    assert overload_launches["pi_probe"] >= 1, overload_launches
    # griffin: its attention layers once a prefill, twice a train step
    assert griffin_launches["flash_attention_fwd"] == \
        attn_layers(lm_config(GRIFFIN_ARCH)), griffin_launches
    assert train_griffin_launches["flash_attention_fwd"] == \
        2 * GRIFFIN_TRAIN_GROUPS * TRAIN_STEPS, train_griffin_launches
    assert ssm_launches["flash_attention_fwd"] == 0 == \
        train_ssm_launches["flash_attention_fwd"]
    # [mesh:train] (a): each rank twice a layer a step
    assert mesh_train_launches["flash_attention_fwd"] == \
        MESH_RANKS * 2 * LM_LAYERS * MESH_TRAIN_STEPS, \
        mesh_train_launches
    # [mesh]: each rank holds its point windows and its stream to its
    # shards once a window (check_mesh_index); the sum adds the durable
    # run, which the crash at MESH_CRASH cuts short, so it is a floor
    assert mesh_launches["pi_probe"] == mesh_launches["bitonic_sort"] >= \
        2 * SHARDS * (SHARD_WINDOWS + n_sw) and \
        mesh_launches["pi_range"] >= 2 * SHARDS * n_srw, mesh_launches
    paths = (launches, serve_launches, durable_launches, sharded_launches,
             mesh_launches, overload_launches, lm_launches, serve_lm_launches,
             train_launches, mesh_train_launches, moe_launches, serve_moe_launches,
             train_moe_launches, ssm_launches, serve_ssm_launches,
             train_ssm_launches, griffin_launches, serve_griffin_launches,
             train_griffin_launches, examples_launches)

    def total(name):
        return sum(p[name] for p in paths)

    src = "src/repro_torch/kernels/csrc/pi_search.cu"
    kernels = [
        dict(name="pi_probe", route="cuda", source=src,
             replaces="src/repro/kernels/pi_search.py:309",
             launches=total("pi_probe"),
             max_abs_err=timing["probe_err"], ms=timing["probe_ms"],
             plain_ms=timing["probe_plain_ms"],
             bound_ms=timing["probe_bound"][0],
             bound_by=timing["probe_bound"][1], library_ms=None,
             searchsorted_pending_ms=timing["searchsorted_pending_ms"]),
        dict(name="pi_search", route="cuda", source=src,
             replaces="src/repro/kernels/pi_search.py:263",
             launches=launches["pi_search"],
             max_abs_err=timing["search_err"], ms=timing["search_ms"],
             plain_ms=timing["search_plain_ms"],
             bound_ms=timing["search_bound"][0],
             bound_by=timing["search_bound"][1], library_ms=None),
        dict(name="pi_range", route="cuda",
             source="src/repro_torch/kernels/csrc/pi_range.cu",
             replaces="src/repro/kernels/pi_range.py:112",
             launches=total("pi_range"),
             max_abs_err=max(range_fresh["err"], range_timing["err"],
                             range_ycsb["err"], range_ycsb_p["err"]),
             ms=range_timing["ms"], plain_ms=range_timing["plain_ms"],
             bound_ms=range_timing["bound"][0],
             bound_by=range_timing["bound"][1], library_ms=None),
        dict(name="bitonic_sort", route="cuda",
             source="src/repro_torch/kernels/csrc/bitonic_sort.cu",
             replaces="src/repro/kernels/bitonic_sort.py:55",
             launches=total("bitonic_sort"), max_abs_err=bitonic["err"],
             ms=bitonic["ms"], plain_ms=bitonic["plain_ms"],
             bound_ms=bitonic["bound"][0], bound_by=bitonic["bound"][1],
             library_ms=bitonic["library_ms"]),
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=total("flash_attention_fwd"), max_abs_err=flash["err"],
             ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound"][0], bound_by=flash["bound"][1],
             library_ms=flash["library_ms"], grid_ms=flash["grid_ms"],
             recurrentgemma_ms=flash["griffin"]["ms"],
             recurrentgemma_grid_ms=flash["griffin"]["grid_ms"],
             recurrentgemma_bound_ms=flash["griffin"]["bound"][0],
             recurrentgemma_library_ms=flash["griffin"]["library_ms"]),
    ]
    log(f"[time] the whole script: {time.perf_counter() - t_start:.3f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

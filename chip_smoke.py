"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold every hand-written
kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

  1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
  2. build ``src/repro_torch/csrc/*.cu`` with nvcc (one process per source,
     in parallel) and print each kernel's register / spill report (every
     instance, the unplaced decode ones as ``plane_kernel<rows, WB,
     dense>``, WB 0 taking it at run time);
  3. the main path at full width, through the serving entry point:
     qwen3-1.7b (28 layers, d 2048, d_ff 6144, vocab 151936, random weights
     from a seed) on a 1 x 1 x 16 x 65,536 subarray grid: calibration with
     the ``calib_iter`` kernel, ECR masks, placement, placed bit-plane packs,
     greedy decode of 4 prompts of 32 tokens for 16 tokens with every FFN and
     unembed projection in the placed GEMM kernels; then one batch-1 request
     (placed GEMV kernel in decode); launch counters are zeroed before and
     read after each drive; profiles of one batch-4 and one batch-1 placed
     decode step print the placed GEMM kernels' device time per step;
  4. the whole-model check: prefill logits through the kernels equal, bit
     for bit, the same packs run through the plain versions on the card;
  5. the calibration check: the main run's calibrated levels (12 kernel
     launches over the whole grid) equal ``calibrate_fleet`` through the
     plain version on the card, from the same seed; then the cache-miss
     calibration again, stage by stage with ``cuda.synchronize`` after each
     (manufacture, the iterations' draws, the ``calib_iter`` launches,
     ``measure_ecr_fleet``, the cache save), its levels, ECR and masks
     equal to the session's, and a profile of the ECR stage by kernel;
  6. reopen the session on the same cache: table HIT and placement HIT;
     then, on a copy of the cache, a partial recalibration: subarrays 3
     and 11 drift by a seeded shift of 0.5 sigma_static, their ECR on the
     old levels, ``PUDSession.recalibrate_subarrays`` (12 ``calib_iter``
     launches), its stages with ``cuda.synchronize`` after each, and the
     checks (kernel == plain version, one pass == one pass per subarray,
     the other 14 rows unchanged); then read-fault injection: a placed
     and an identity plan from the main run's masks, packed, every
     error-prone window column reading its stuck value, prefill and 4
     greedy steps through the placed kernels (placed logits bit-identical
     to the clean pack's, identity logits off by more than 0.1);
  7. the unplaced engine path at full width, through the serving entry
     point: ``--pud-gemv --calib-cache <the same cache> --no-placement
     --engine`` with 8 prompts on 4 engine slots, every packed projection in
     the unplaced GEMM/GEMV kernels and none in the placed ones; then one
     batch-1 request on the unplaced packs (unplaced GEMV decode), a
     profile of one batch-4 unplaced decode step and one of the unplaced
     prefill of 4 prompts (128 rows: the tensor-core GEMM kernel);
  8. a ragged engine run (12 requests, prompts of 8 to 128 tokens, budgets
     of 4 to 32) through the kernels and again through the plain versions
     with the same schedule: tokens equal, logits bit for bit;
  9. the pack archive: the placed and the unplaced ``PackedModel`` saved
     with ``save_packed_npz`` and loaded with ``load_packed_npz``; greedy
     decode at batch 4 and batch 1 from the loaded packs equal to the
     in-memory packs', bit for bit, and a loaded layer's ``to_dense``
     form through the GEMM kernel equal to its bit-packed form; then
     monitored serving through the entry point (``--pud-gemv --engine
     --monitor --drift-sim`` on a copy of the main run's cache, ``MONITOR``:
     8 prompts on 4 slots, subarrays 1 and 5 drift at engine step 3 at
     3000 C, a canary probe every 2 steps): a table hit and a new
     canary-aware placement, critical events on 1 and 5 only, a recovery
     of exactly [1, 5] (12 ``calib_iter`` launches), the other 14 rows of
     the persisted table unchanged, a repacked placement on no refreshed
     fault or canary, tokens on every step, post-swap decode equal to a
     fresh pack's; detection step and latency, canary and table ECR,
     recalibrate and repack walls, modeled probe overhead, and one probe
     round's host wall and device time by kernel; then the tuning phase:
     ``serve --pud-gemv --pud-attention --tune`` on the main cache (FFN,
     attention and unembed packs placed; the real occupancy printed; tuned
     at batch 1 and 4), then ``PUDSession.tune(batches=(1, 4, 32))``
     (``TUNE_BATCHES``): every key's heuristic and tuned time, speedup,
     winning plan and candidate count, each winner held to the plain
     version on the card, the prefill logits through the tuned kernels
     equal to the plain versions; x [4] x wi / wo at the heuristic plan
     and at one K split; a reopened session on the same cache hits every
     key; batch-4 decode with tuned and untuned packs bit-identical, one
     step of each profiled twice, in turns, and the host microseconds a
     stamped plan adds per packed call; a pack archive keeps the plans; then ``serve --weight-bits 8`` (placed FFN packs; prefill and
     decode equal to the plain versions); then the
     paper's Table I at its own scales through
     ``repro_torch.benchmarks.table1.run`` for B300 and T210 (Algorithm 1
     on a 65,536-column subarray, 8,192 MAJ5 trials, ADD8 / MUL8 graph ECR
     on 4,096 columns at 512 / 128 trials), each number beside the paper's
     and each stage's wall time; ``benchmarks.fleet_calibration --full
     --check-full`` (its parity leg and its main leg, 20 ``calib_iter``
     launches at [16, 512, 5, 65,536], bit-exact against the plain
     version on the same inputs; its ``#csv`` block); the paper's other
     figures through ``repro_torch.benchmarks.run`` at ``--full`` scale
     (``FIGURES``: Fig. 3 with its asserts, Fig. 5, Fig. 6, convergence,
     the drift-recovery and MAJX benchmarks, placement; each ``#csv``
     block, validation lines and wall; any raising benchmark fails);
     then the quickstart's ``PUDSession.baseline_ecr()`` and
     ``calibrate()``;
 10. the command-level simulator at paper width: 256 MAJ5 events on one
     65,536-column subarray built from ``write_row`` / ``frac`` / ``simra``
     commands (one ``majx_sense`` launch each), whose ECR must agree with
     ``measure_ecr_maj5`` on the same offsets within a binomial tolerance;
     the host wall per event beside the device time per event by kernel
     (``torch.profiler`` over 16 more events);
 11. the dense plane layout (the reference's default) through the ``ops``
     entries at the reference kernel benchmark's shapes (B 8 and B 1,
     K = N = 2048, 4-bit): every GEMM/GEMV entry launches its kernel;
     the contract gate ``python -m repro_torch.analysis --sms <the
     card's>`` (exit 0); ``benchmarks.run --only`` serving,
     serving_engine, kernels and kernel_microbench (the modules
     mvdram_serving, serving_engine at its smoke configuration,
     kernel_bench and kernel_microbench; each exits 0, the last two hold
     every kernel result to its plain version);
 12. each kernel at the main path's shapes against its plain version on the
     card (exact equality, both modes), timed with CUDA events (median of 30
     launches, L2 flushed before each, the host's launch time hidden behind
     a spin on the card) beside its bound and a library
     yardstick (``torch._int_mm`` on the unpacked signed weights, with x
     zero-padded to 32 rows where it has fewer; none for the calibration
     and sensing kernels); ``calib_iter`` also at the fleet benchmark's
     main-leg shape and at a ragged grid (its byte path), ``majx_sense`` beside an empty kernel timed the same way (the
     floor of a timed launch); the dense layout as extra shapes of the
     GEMM rows; each shape prints its launch plan (GEMM/GEMV: dp4a or
     tensor cores, grid, K split, stage words, stages, shared memory; an
     unplaced dp4a row also the WB its kernel instance is compiled for;
     made for the card's SM count); the placed GEMM also at the tuning
     phase's attention wq and the 8-bit wi, at batch 4;
 13. gemma-7b at full width through the engine's scheduler, after the
     qwen3 phases' models, packs and caches are freed: 28 layers, d 3,072,
     d_ff 24,576, vocab 256,000, random weights from the seed, on a 1 x 1 x
     32 x 65,536 grid (its 1,718,272 placed columns do not fit 16
     subarrays): calibration (a cache miss), placement, 4-bit placed packs;
     12 requests on 4 slots (8 sharing a 64-token system prompt, 2 exact
     repeats, 2 unrelated; ``GEMMA``) served (A) with 32-row chunked
     prefill, a prefix cache and a heartbeat, (B) by the FIFO engine with
     whole-request bucketed prefill, (C) as A with SLO admission at a
     deadline of 16 modeled steps: A's tokens and logits equal B's bit for
     bit, 2 full and 7 partial prefix hits, fewer prefilled tokens, the
     heartbeat at the last step, C sheds at admission and meets deadlines,
     its unshed requests equal B's; A replayed through the plain versions
     bit for bit; profiles of a chunk step and a decode step (the placed
     GEMM kernels' device time and launches); peak device memory; then
     the placed GEMM/GEMV and ``calib_iter`` at gemma's shapes, as in 12;
 14. deepseek-v2-lite-16b (MLA attention, 64 routed experts top-6 + 2
     shared, one dense layer first; ``DEEPSEEK``) at full width and full
     depth, 15.7 B parameters from the seed, after gemma's packs are freed,
     on the main path's 16 x 65,536 grid: calibration (a cache miss),
     placement of 326,016 columns, 4-bit placed FFN (layer 0's and the
     shared experts') and unembed packs, the routed banks in bf16; the
     whole-model prefill logits through the kernels == plain versions;
     lockstep greedy decode of 4 prompts of 32 tokens for 16; the engine
     (8 requests on 4 slots, whole-prompt prefill) equal to lockstep token
     for token; a ragged engine run (prompts of 5-40 tokens) through the
     kernels == plain versions; a profile of one batch-4 decode step; with
     MLA's wq / wo packed too (464,256 columns), a prefill and 4 decode
     steps through the kernels == plain versions; peak device memory; then
     the placed GEMM / GEMV at its shapes, as in 12;
 15. the sharded fleet (``FLEET``), after deepseek's packs are freed:
     qwen3-1.7b at full width and depth through ``PUDSession.open_fleet``
     on a (data 2, model 2) mesh of logical PUD devices, each 8 x 65,536
     (on one card every position sits on it; the position -> card map is
     printed): a calibration miss on every device (12 ``calib_iter``
     launches each), per-shard placement (about 276,672 placed columns per
     device) and packs, a reopen that hits every table and placement,
     ``FleetServingEngine`` over 8 requests (prompt 32, gen 16) on 4 slots
     per lane, a batch-1 request per layout, and the checks: (a) a ragged
     fleet run through the kernels == its replay on the plain versions,
     (b) every lane == a single-device ``ServingEngine`` over the unsharded
     logical pack (same requests, order and slots), tokens and logits bit
     for bit, (c) the same for a forced-logical fleet, (d)
     ``recalibrate_shard(1, ...)`` after two of shard 1's subarrays drift
     moves only shard 1's levels, masks and placement (the other devices'
     state objects untouched; levels == the plain version's), (e)
     ``FleetDriftMonitor`` stamps the events with shard 1 and its recovery
     moves only shard 1; a profiled batch-4 decode step of a lane
     (device time by kernel, busy share, launches per step) and the
     aggregate DDR4-PUD rate; then each kernel at its per-shard shapes;
 16. the SSM, hybrid, encoder-decoder and VLM families (``FAMILIES``),
     after the fleet's state is freed, on one 16 x 65,536 calibration
     cache, random weights from the seed, 4-bit placed packs: (a)
     zamba2-7b at full width and depth (81 blocks, 5.75 B parameters)
     through ``serve --pud-gemv --pud-attention --engine``: a calibration
     miss, 46,336 placed columns (the shared attention's four projections
     and the unembed), lockstep decode of 4 prompts of 32 tokens for 16,
     the engine refused (its Mamba2 segment caches carry the batch on axis
     2; the reference's engine fails on it), prefill logits through the
     kernels == plain versions, a batch-1 request (placed GEMV), 53 placed
     GEMM launches per batch-4 decode step (13 uses x 4 + the unembed), a
     profiled decode step and peak memory; (b) mamba2-1.3b at full width
     and depth (48 layers): a table hit, 50,280 placed columns (the
     unembed), the engine equal to lockstep (4 requests on 4 slots through
     serve, then 8 on 4 against lockstep in batches of 4), a ragged engine
     run == its plain-version replay, the unplaced packs through the
     ``plane_gemm`` kernels at batch 4 and 1, a profiled decode step; (c)
     whisper-large-v3 at full width and depth (32 + 32 layers, 1,500
     frames) with the encoder's attention packed (215,706 columns, its
     projections at 4 x 1,500 rows), prefill == plain, lockstep decode,
     the engine skip line; (d) pixtral-12b at full width with 4 of its 40
     layers (266,240 columns: FFN + unembed), prefill == plain, the cache
     filled over patches + prompt and lockstep decode after the prefix;
     then the placed GEMM / GEMV at their shapes;
 17. training on one card (``TRAIN``), after the families' state is
     freed: (a) qwen3-1.7b at full width and depth through the training
     entry point (``launch.train``; bf16 parameters, float32 moments,
     2,048-token rows, batch 8 in 4 microbatches, random weights from the
     seed): run A is the 6-step run stopped before step 3 as a preemption
     would stop it (``launch.train.run(..., stop_at=3)``: the schedule
     depends on ``--steps``, so a 3-step run is another run), after its
     async checkpoint of step 3; run B resumes it to step 6 (the parameters and moments restored equal A's
     final state bit for bit, the data stream at step 3 with batches equal
     to run C's bit for bit, its losses within ``loss_tol`` of C's); run C
     takes 6 steps uninterrupted, each profiled, and its loss falls (exit
     code 0).  Per step: host wall, device time, tokens/s; the peak memory
     and the checkpoint's bytes and write / read walls.  (b) one
     ``make_train_step`` of every arch's smoke config on the card against
     the same step on the CPU (same parameters, same batch): loss, every
     gradient leaf and the updated parameters within the bf16 tolerances
     of the CPU parity tests;
 18. the mesh group (``MESH``), after training's state is freed: (a)
     qwen3-1.7b at full width and depth through ``launch.train.run(...,
     mesh=...)`` on a (data 2, model 2) mesh of positions on the card
     (parameters and AdamW moments stored as per-position shards, the
     data-parallel step), TRAIN's 6-step run cut before step 3, then the
     same run on one device: per step host wall, device time, tokens/s,
     the bytes per position and peak memory; losses within the
     reference's mesh-test tolerances and the bf16 parameters within
     2e-2; then one step of every arch's smoke config on the mesh against
     the card's one-device step; (b) ``pipelined_apply`` over 4 stages of
     7 of qwen3's layers, 8 microbatches of [1, 2,048, 2,048] bf16, equal
     to sequential application bit for bit; (c) mamba2-1.3b at full
     width and depth on a (2, 2) fleet of 8 x 65,536 devices: calibration
     misses, the unembed placed per shard, the fleet engine (8 requests,
     4 slots per lane) with every lane == a single-device engine and the
     run == its plain-version replay, bit for bit; then the placed GEMM /
     GEMV at the per-shard unembed shape;
 19. the dry-run group (``DRYRUN``), after the mesh's state is freed: the
     dry run (``launch/dryrun.py``, on meta tensors) predicts (a) TRAIN's
     qwen3-1.7b step (8 x 2,048 tokens in 4 microbatches) and (b) the
     qwen3-1.7b lane of decode_32k (tokens [8, 1] against a 32,768-token
     bf16 cache), each on a one-position (1, 1) mesh, and the same steps
     run on a (1, 1) mesh on the card: predicted FLOPs within 2% of
     ``torch.profiler``'s (``with_flops``, matrix products), the predicted
     peak within 15% of ``max_memory_allocated``, the roofline's bound
     beside the measured device time (for (b) the median of 5 profiled
     steps); (c) ``launch.dryrun`` on the single mesh for one cell per
     family (qwen3 train_4k, deepseek-v2-lite decode_32k, mamba2
     long_500k, whisper and pixtral prefill_32k), each record complete,
     finite and non-zero, then the roofline over the records; then the
     split over "model" (``DRYRUN["split"]``), its four positions taking
     turns on the card: (d) the train step of (a) on a (1, 4) mesh, its
     first loss against (a)'s one-device loss on the same weights and
     batch (the mesh group's tolerances), the dry run's per-position FLOPs
     x 4 within 0.5% of the profiler's, its per-position peak x 4 beside
     ``max_memory_allocated``; (e) the lane of (b) on (1, 4) with the
     production mesh's decode layout (kv heads whole, the cache split over
     its sequence), 8 greedy steps from a random cache against the
     unsplit lane on the same weights and cache (the split lane fed the
     unsplit lane's tokens): logits within 0.05 or, where larger, 1.5 x
     the unsplit lane's own difference when its first step runs row by
     row (at full width its logits move by ~0.19 that way: the random
     model amplifies accumulation order), greedy tokens equal at every
     step but where the unsplit lane's two best logits tie within the
     step's logit difference (the top-2 margin printed where a token
     differs); both with host wall, device time and launches per step;
     then the other families' split on the same (1, 4) mesh
     (``DRYRUN["families"]``), held as (d) and (e) are: (f) mamba2-1.3b's
     decode lane at full width and depth (8 rows, a random window and
     state, put back before each run since a step rewrites them whole),
     (g) whisper-large-v3's train step at full width and 2 + 2 of its 32
     + 32 layers (2 rows of 1,500 frames and 448 tokens) against one
     position's on the same weights and batch, in float32 within the mesh
     tolerances, in bf16 within those or, where larger, 1.5 x one
     position's own bf16-vs-float32 gap (deeper, the random full-width
     model is chaotic: at 8 + 8 layers its float32 loss moves by ~0.02
     when the frames move by one ulp), (h) pixtral-12b's decode lane at
     4 of its 40 layers (8 rows, a random 32,768-token cache split over
     its sequence), (i) zamba2-7b at full width: its decode lane at full
     depth (8 rows, a random 2,048-token cache of its 13 shared-block
     uses, split over their kv heads), in bf16 held as (f) and in float32
     held to the unsplit lane within 1e-6 of its largest logit (float32
     sums that cross the split accumulate in float64 on both sides, so
     the two should be equal), then its float32 train step at 13 of its
     81 blocks (2 rows of 512 tokens) on one position and split, the
     split's profiler FLOPs against 4 x the dry run's per-position count
     of matrix products within 0.01%, its loss against one position's,
     the peak beside the dry run's;
 20. print the ``kernels`` JSON line and, last, the device JSON line.

The phases run in groups that share no state (``GROUPS``: main = 3-9,
papers = 9 (Table I on) - 12, gemma = 13, deepseek = 14, fleet = 15,
families = 16, train = 17, mesh = 18, dryrun = 19); each
group adds its launches and timed shapes to the kernel rows (``Rows``),
which are assembled and printed last.  ``run(only=[...])`` drives some
groups, as the CPU rehearsal does (``tests/test_torch_rehearsal_*.py``);
``main`` drives them all.  Every phase prints its wall.

Device time from ``torch.profiler`` counts each device event (kernel, copy,
memset) once; the host ops that launched them are not added again.

It needs the port's sources beside it (``src/repro_torch``) and a GPU.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_S = 1979e12         # dense int8 tensor-core rate
F32_OPS_S = 67e12            # float32 outside the tensor cores
ARCH = "qwen3-1.7b"
GRID = dict(n_channels=1, n_banks=1, n_subarrays=16, n_cols=65536)
BATCH, PROMPT, GEN, SEED = 4, 32, 16, 0
ENGINE_BATCH, ENGINE_SLOTS = 8, 4
RAGGED = dict(n=12, prompt=(8, 128), budget=(4, 32))
LIB_ROWS = 32                # torch._int_mm takes more than 16 rows
                             # (and N padded to a multiple of 8)
# benchmarks/table1.py's scales (the reference's evaluate_method defaults)
TABLE1 = dict(n_cols=65536, n_trials_maj5=8192, n_cols_arith=4096,
              n_trials_arith=512)
PAPER = {"B300": dict(ecr=0.466, maj5=0.89e12, add=50.2e9, mul=5.8e9),
         "T210": dict(ecr=0.033, maj5=1.62e12, add=94.6e9, mul=11.0e9),
         "gain": dict(maj5=1.81, add=1.88, mul=1.89)}
QUICKSTART = dict(n_channels=1, n_banks=1, n_subarrays=2, n_cols=4096)
SIMRA = dict(n_cols=65536, events=256)
DENSE = dict(b=8, k=2048, n=2048, wb=4)   # benchmarks/kernel_bench.py
# majx_sense rows (T, R, C, n_fracs): the simulator's own event, one ECR
# chunk of a DDR4 row, kernel_bench.py's shape, and a ragged one
SENSE_SHAPES = [(1, 8, SIMRA["n_cols"], 3), (256, 8, 65536, 3),
                (256, 8, 65536, 0), (16, 8, 4096, 0), (16, 8, 4096, 3),
                (13, 8, 65000, 3)]
# calib_iter rows beside the main path's grid: the fleet benchmark's main
# leg (--full: 16 subarrays, CalibrationConfig's 512 samples), a ragged one
# (C not a multiple of 4, the kernel's byte path), the partial
# recalibration of two subarrays (the recalibration and monitored phases),
# and the figures phase's own grids (placement; drift_recovery's
# calibration and its recovery of two subarrays)
CALIB_SHAPES = [(16, 512, 5, 65536), (3, 64, 5, 1001), (2, 256, 5, 65536),
                (8, 128, 5, 512), (8, 128, 5, 1024), (2, 128, 5, 1024)]
RECAL = (3, 11)              # the drifted subarrays of the recalibration
FAULT_STEPS = 4              # decode steps of the fault-injection phase
ARCHIVE_STEPS = 4            # decode steps from the loaded archives
# benchmarks.fleet_calibration on the card; --check-full holds its main
# leg's calib_iter launches against the plain version on the same inputs
FLEET_ARGV = ["--full", "--check-full"]
# monitored serving at full width (``--monitor --drift-sim``): 8 prompts on
# 4 slots, drift at engine step 3 on subarrays 1 and 5 at the reference's
# 3000 C stress, a canary probe every 2 steps, 16 canaries per subarray
MONITOR = dict(batch=8, slots=4, drift_at=3, subarrays=(1, 5),
               probe_every=2, n_canary=16)
# the paper's figures through ``benchmarks.run`` at ``--full`` (Table I and
# the fleet benchmark run in their own phases, so the harness skips them);
# ``check_plain`` reruns drift_recovery and placement, whose kernel
# launches join the kernels line, on the plain versions and requires equal
# results
FIGURES = dict(n_cols=65536, n_trials_maj5=8192, n_cols_arith=4096,
               full=True, check_plain=True)
# the tuning phase: qwen3 with attention packs, tuned at the GEMV, the dp4a
# GEMM and the tensor-core GEMM (a gemma-sized prefill chunk) rows
TUNE_BATCHES = (1, BATCH, 32)
WEIGHT_BITS = 8              # the --weight-bits phase's plane count
# the benchmarks phase: ``benchmarks.run --only`` names of the modules
# mvdram_serving, serving_engine (at its smoke configuration),
# kernel_bench and kernel_microbench
BENCHMARKS = ("serving", "serving_engine", "kernels", "kernel_microbench")
# gemma-7b at full width through the engine's scheduler: 1,718,272 placed
# columns need 32 subarrays of 65,536 (16 hold ~1.01 M error-free).  The
# traffic: 8 prompts sharing a 64-token system prompt (own tails of 8-64
# tokens), 2 unrelated prompts of 16-96 and 2 exact repeats, budgets of
# 4-16; the SLO run's deadline is ``slo_steps`` modeled steps.
GEMMA = dict(arch="gemma-7b", preset="full",
             grid=dict(n_channels=1, n_banks=1, n_subarrays=32,
                       n_cols=65536),
             slots=4, max_len=256, chunk=32, system=64, own=(8, 64),
             unrelated=(16, 96), budget=(4, 16), n_shared=8, cache=64,
             slo_steps=16)
# deepseek-v2-lite-16b at full width and full depth (15.7 B parameters,
# 31.4 GB of bf16 weights: one card holds it whole) on the main path's
# 16 x 65,536 grid: its FFN + unembed packs need 326,016 placed columns,
# 464,256 with MLA's wq / wo.  Lockstep and the engine run at batch 4, at
# most top_k (6), so each expert's decode capacity is the whole batch and
# no token is dropped: a row does not depend on its neighbours.  MoE
# models prefill whole prompts at their exact length, so the ragged run's
# prompts of 5-40 tokens each take their own prefill shape.
DEEPSEEK = dict(arch="deepseek-v2-lite-16b", preset="full", grid=GRID,
                batch=BATCH, prompt=PROMPT, gen=GEN, requests=ENGINE_BATCH,
                slots=ENGINE_SLOTS,
                ragged=dict(n=8, prompt=(5, 40), budget=(4, 16)),
                attn_steps=4, placed_cols=326_016, attn_cols=464_256)


# the sharded fleet: qwen3-1.7b at full width and depth on a (data 2,
# model 2) mesh of logical PUD devices, each 8 subarrays x 65,536 columns
# (its 553,344 placed columns split about 276,672 per shard, about 0.55 of
# a device's error-free columns at ECR 0.0371); 8 requests (prompt 32,
# gen 16) on 4 slots per lane; two of shard 1's subarrays drift for the
# recalibration and monitor checks; a ragged run replays on the plain
# versions.  ``widen`` (smoke only) widens the smoke model so every shard
# owns columns of some projections.
FLEET = dict(arch=ARCH, preset="full", mesh=(2, 2),
             grid=dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=65536),
             requests=ENGINE_BATCH, prompt=PROMPT, gen=GEN,
             slots=ENGINE_SLOTS, drift=(2, 5), drift_temp_c=3000.0,
             ragged=dict(n=8, prompt=(8, 64), budget=(4, 16)), widen=None)


# the SSM, hybrid, encoder-decoder and VLM families on one 16 x 65,536
# calibration cache (zamba2 misses, the others hit and place anew): 4
# prompts of 32 tokens for 16 (mamba2: 8 requests on 4 engine slots, and a
# ragged run replayed on the plain versions); pixtral's 40-layer backbone
# is the ported TransformerLM, so it runs 4 layers (its placed FFN +
# unembed: 4 x 33,792 + 131,072 columns).  ``placed_cols`` are the full
# configs' placements.
FAMILIES = dict(preset="full", grid=GRID, batch=BATCH, prompt=PROMPT,
                gen=GEN, requests=ENGINE_BATCH, slots=ENGINE_SLOTS,
                ragged=dict(n=8, prompt=(5, 40), budget=(4, 16)),
                pixtral_layers=4,
                placed_cols={"zamba2-7b": 46_336, "mamba2-1.3b": 50_280,
                             "whisper-large-v3": 215_706,
                             "pixtral-12b": 266_240})

# training (item 17): qwen3-1.7b at full width and depth, 2,048-token rows,
# batch 8 in 4 microbatches; run A (6 steps, stopped at 3) saves at step 3,
# run B resumes it to 6, run C takes 6 steps without a checkpoint.
# ``loss_tol``: B's losses against C's (the card's scatter-adds need not
# add in one order).  The smoke step of every arch is held to the CPU's:
# in float32, the loss and each gradient leaf (as a share of its largest
# magnitude) within ``f32_tol``, 10x the CPU tests' port-vs-reference
# tolerance (``tests/_train.py``): the two devices sum GEMMs and
# scatter-adds in other orders (gemma's embedding: 2.8e-4, zamba2's shared
# FFN: 6.8e-4).  In bf16, within ``bf16_loss_tol`` / ``bf16_grad_tol`` (the
# CPU tests' hybrid tolerance) or, where larger, the CPU's own difference
# between its bf16 and float32 steps on that leaf: bf16 rounding's noise
# floor (the hybrid's smoke model moves its bf16 gradients by up to 3.5x a
# leaf's scale against float32 on the CPU alone).
TRAIN = dict(arch=ARCH, preset="full", seq_len=2048, global_batch=8,
             microbatches=4, steps_a=3, steps=6, loss_tol=1e-2,
             smoke=dict(seq_len=40, global_batch=4, microbatches=2),
             f32_tol=1e-3, bf16_loss_tol=1e-3, bf16_grad_tol=0.1)

# the mesh group (item 18): (a) TRAIN's qwen3 run cut at step 3 on a (data
# 2, model 2) mesh of positions on the card and on one device, held to the
# reference's own mesh-test tolerances (tests/test_distributed_train.py:
# losses within rtol = atol = 2e-4, bf16 parameters within 2e-2), and
# every arch's smoke step on the mesh against the card's one-device step
# within TRAIN's card tolerances; (b) GPipe over 4 stages of 7 qwen3
# layers, 8 microbatches of [1, 2,048, 2,048]; (c) mamba2-1.3b at full
# width and depth on a (2, 2) fleet of 8 x 65,536 devices, 8 requests on 4
# slots per lane.
MESH = dict(
    train=dict(TRAIN, mesh=(2, 2), loss_rtol=2e-4, loss_atol=2e-4,
               param_atol=2e-2),
    pipeline=dict(arch=ARCH, preset="full", stages=4, micro=8, rows=1,
                  seq=2048),
    fleet=dict(arch="mamba2-1.3b", preset="full", mesh=(2, 2),
               grid=dict(n_channels=1, n_banks=1, n_subarrays=8,
                         n_cols=65536),
               requests=ENGINE_BATCH, prompt=PROMPT, gen=GEN,
               slots=ENGINE_SLOTS, widen=None))


# the dry-run group (item 19): the dry run's prediction of two steps, each
# on a one-position (1, 1) mesh so that the prediction is the program the
# card runs, against the same steps on the card: (a) TRAIN's qwen3-1.7b
# step (8 x 2,048 tokens in 4 microbatches) and (b) the qwen3-1.7b lane of
# decode_32k on the single mesh (8 of its 128 rows against a 32,768-token
# bf16 cache, 30.1 GB), FLOPs within ``flops_rtol`` of the profiler's
# count, the peak within ``peak_rtol`` of ``max_memory_allocated``; then
# the dry run of one cell per family on the single mesh and the roofline
# over the records; then (``split``) the same train step and decode lane
# with their compute split over a (1, 4) mesh's "model" positions, against
# the one-position steps (docstring, item 19).
DRYRUN = dict(
    arch=ARCH, preset="full",
    train=dict(seq_len=2048, global_batch=8, microbatches=4),
    decode=dict(seq_len=32768, batch=8, steps=5),
    flops_rtol=0.02, peak_rtol=0.15,
    split=dict(mesh=(1, 4), decode_steps=8, flops_rtol=0.005,
               logits_atol=0.05, floor_factor=1.5, loss_rtol=2e-4,
               loss_atol=2e-4),
    cells=(("qwen3-1.7b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
           ("mamba2-1.3b", "long_500k"), ("whisper-large-v3", "prefill_32k"),
           ("pixtral-12b", "prefill_32k")),
    # (f)-(h): the other families' split on the same (1, 4) mesh, held as
    # (d) and (e) are: (f) mamba2-1.3b's decode lane (8 rows, its O(1)
    # cache), (h) pixtral-12b's (8 rows, a 32,768-token cache, 4 of its 40
    # layers as the families group serves it), (g) whisper-large-v3's train
    # step (2 encoder and 2 decoder layers: the random model is chaotic
    # deeper; 2 rows of 1,500 frames and 448 tokens in one microbatch);
    # each also in float32, the split held to the unsplit run there (a
    # decode lane within ``f32_rtol`` of the unsplit lane's largest logit:
    # float32 cross-split sums accumulate in float64 on both sides; (h)'s
    # layout holds the heads whole and splits wq / wk / wv over "embed",
    # which on the CPU rounds otherwise than the unsplit float32 product,
    # 1.7e-5 of the largest logit in the CPU rehearsal, so 1e-4 there); (i)
    # zamba2-7b's decode lane at full depth (a 2,048-token cache: its 13
    # uses' KV caches, bf16 and float32, fit beside the weights), and its
    # float32 train step at ``layers`` of its 81 blocks (its loss within
    # ``loss_rtol`` of one position's)
    families=dict(
        ssm=dict(arch="mamba2-1.3b", batch=8, seq_len=32768, f32_rtol=1e-6),
        vlm=dict(arch="pixtral-12b", batch=8, seq_len=32768, layers=4,
                 f32_rtol=1e-4),
        train=dict(arch="whisper-large-v3", seq_len=448, global_batch=2,
                   microbatches=1, layers=2),
        hybrid=dict(arch="zamba2-7b", batch=8, seq_len=2048, f32_rtol=1e-6,
                    train=dict(seq_len=512, global_batch=2, microbatches=1,
                               layers=13, flops_rtol=1e-4, loss_rtol=1e-6))))


class PhaseError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


#: [name, start] of the phase running now; the walls of the ended ones
_PHASE: list = []
PHASE_WALLS: dict = {}


def _end_phase() -> None:
    if _PHASE:
        name, t0 = _PHASE.pop()
        wall = time.perf_counter() - t0
        PHASE_WALLS[name] = PHASE_WALLS.get(name, 0.0) + wall
        print(f"  (phase wall {wall:.2f}s)", flush=True)


def phase(name: str):
    """Start a phase: print its name, and the wall of the one before."""
    _end_phase()
    print(f"== {name}", flush=True)
    _PHASE.append([name, time.perf_counter()])


def end_phases() -> dict:
    """End the last phase; returns every phase's wall in seconds."""
    _end_phase()
    walls = dict(PHASE_WALLS)
    PHASE_WALLS.clear()
    return walls


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    need(r.returncode == 0 and r.stdout.strip(),
         f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 30) -> float:
    """Median device time of one call in ms, L2 flushed before each launch
    (CUDA events); on a CPU rehearsal, the host clock.  A spin of about
    0.3 ms queued after the flush keeps the card busy while the host runs
    the wrapper, so the host's time to launch does not count as the
    kernel's."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if flush.is_cuda:
            torch.cuda._sleep(500_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def reset_counts(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def restamp(tree, backend: str):
    """The packed tree with every pack stamped to run through ``backend``."""
    from repro_torch.pud.packed import PackedTensor, ShardedPackedTensor
    if isinstance(tree, dict):
        return {k: restamp(v, backend) for k, v in tree.items()}
    if isinstance(tree, (PackedTensor, ShardedPackedTensor)):
        return tree.replace(backend=backend)
    return tree


def library_weights(pt):
    """[K, N] int8 signed weights of a pack (placed: its logical columns),
    the operand of the library yardstick."""
    from repro_torch.kernels.placed_gemm import window_cols
    from repro_torch.kernels.ref import signed_weights, unpack_plane_words
    dense = pt.planes
    if pt.layout == "bitpack8":
        dense = unpack_plane_words(pt.planes, pt.logical_k)
    if pt.col_ids is not None:
        dense = dense[:, :, window_cols(pt.col_ids, pt.planes.shape[-1],
                                        pt.window_block)]
    return signed_weights(dense).to(dense.dtype).contiguous()   # int8


def kernel_name(mangled: str) -> str:
    """A readable name of a mangled kernel: its name (the shortest
    identifier after its length that ends in ``kernel``; a longer one can
    start inside the anonymous namespace's tag) and its template arguments
    (``dp4a_kernel<4, false>``)."""
    import re
    found = []
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            name = mangled[m.end():m.end() + int(m.group()[i:])]
            if name.endswith("kernel"):
                found.append((len(name), name, m.end() + len(name)))
    if not found:
        return mangled
    _, name, end = min(found)
    args = [v if k == "i" else ("true" if v == "1" else "false")
            for k, v in re.findall(r"L([bi])(\d+)E",
                                   mangled[end:].split("EEv")[0])]
    return name + (f"<{', '.join(args)}>" if args else "")


def sms_of(pt) -> int:
    """The SM count the wrappers plan for: the pack's card's, else the
    plans' default."""
    from repro_torch import devices
    from repro_torch.kernels.placed_gemm import SMS
    return devices.sm_count(pt.planes.device) if pt.planes.is_cuda else SMS


def placed_plan(pt, b: int) -> str:
    """The launch plan of a placed pack at B rows, as the wrapper makes it."""
    from repro_torch.kernels.placed_gemm import plan_launch, window_tiling
    wb, _, w_len = pt.planes.shape
    pwb, bc = window_tiling(pt.n, w_len, pt.window_block, "chip_smoke")
    p = plan_launch(b, -(-pt.k // 8), pt.n, wb, pwb, bc,
                    pt.layout == "dense", sms_of(pt))
    path = "tensor cores" if p.tensor_cores else "dp4a"
    return (f"{path}, {p.rows} rows x {p.tile_cols} columns per block, "
            f"grid {p.grid}, K split {p.n_split} x {p.split_words} words, "
            f"{p.stage_words} words per stage, "
            f"{'staged' if p.staged else 'unstaged'}, "
            f"{p.smem_bytes} B shared")


def unplaced_plan(pt, b: int) -> str:
    """The launch plan of an unplaced pack at B rows, as the wrapper makes
    it; the dp4a path names the WB its kernel instance is compiled for."""
    from repro_torch.kernels.plane_gemm import (TILE_COLS, instance_wb,
                                                plan_launch)
    wb = pt.planes.shape[0]
    p = plan_launch(b, -(-pt.k // 8), pt.n, wb, pt.layout == "dense",
                    sms_of(pt))
    path = "tensor cores" if p.tensor_cores else \
        f"dp4a, instance WB {instance_wb(wb) or 'run time'}"
    return (f"{path}, {p.rows} rows x {TILE_COLS} columns per block, "
            f"grid {p.grid}, K split {p.n_split} x {p.split_words} words, "
            f"{p.stage_words} words per stage, {p.stages} stages, "
            f"{p.smem_bytes} B shared")


def finite(*xs) -> bool:
    return all(math.isfinite(x) for x in xs)


def table1_phase(torch, dev, scale: dict, calib=None) -> dict:
    """Paper Table I through ``repro_torch.benchmarks.table1.run`` at
    ``scale`` (it prints each method's stage walls): every number beside
    the paper's."""
    from repro_torch.benchmarks import table1
    from repro_torch.benchmarks.common import BenchScale, emit
    from repro_torch.core.calibrate import CalibrationConfig
    phase("Table I: benchmarks.table1.run, B300 and T210 at the paper's "
          "scales")
    calib = calib or CalibrationConfig()
    print(f"  {scale}, {calib}")
    rows = table1.run(BenchScale(**scale), seed=SEED, device=dev,
                      calib_config=calib)
    emit("table1", rows, header="paper Table I; gains row compares T210/B300")
    rows = {r["method"]: r for r in rows}
    res = {}
    for name in ("B300", "T210"):
        row, ref = rows[name], PAPER[name]
        r = dict(ecr=row["ecr_pct"] / 100, ecr_add=row["ecr_add_pct"] / 100,
                 ecr_mul=row["ecr_mul_pct"] / 100,
                 maj5_tops=row["maj5_tops"] * 1e12,
                 add8_gops=row["add8_gops"] * 1e9,
                 mul8_gops=row["mul8_gops"] * 1e9)
        print(f"  {name}: ECR {r['ecr']:.4f} (paper {ref['ecr']}), ADD8 ECR "
              f"{r['ecr_add']:.4f}, MUL8 ECR {r['ecr_mul']:.4f}; MAJ5 "
              f"{row['maj5_tops']:.4f} TOPS (paper {ref['maj5'] / 1e12}), "
              f"ADD8 {row['add8_gops']:.3f} GOPS (paper "
              f"{ref['add'] / 1e9}), MUL8 {row['mul8_gops']:.3f} GOPS "
              f"(paper {ref['mul'] / 1e9})")
        need(finite(*r.values()), f"{name}: a Table-I number is not finite")
        res[name] = r
    g = rows["gain_T210_over_B300"]
    gains = dict(maj5=g["maj5_tops"], add=g["add8_gops"], mul=g["mul8_gops"])
    print("  gains T210/B300: " + ", ".join(
        f"{k.upper()} {v:.3f}x (paper {PAPER['gain'][k]}x)"
        for k, v in gains.items()))
    need(res["T210"]["ecr"] < res["B300"]["ecr"],
         "T210's ECR is not below B300's")
    need(finite(*gains.values()), "a Table-I gain is not finite")
    res["gains"] = gains
    return res


def quickstart_phase(torch, dev, grid: dict) -> dict:
    """examples/quickstart.py's session: B300 baseline, then Algorithm 1."""
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.runtime.session import PUDSession
    phase("quickstart: PUDSession.open(grid).baseline_ecr(), calibrate()")
    t0 = time.perf_counter()
    session = PUDSession.open(FleetConfig(**grid), seed=SEED, device=dev)
    base = session.baseline_ecr()
    tuned = session.calibrate().mean_ecr
    print(f"  grid {grid}: ECR baseline {base:.4f} (paper 0.466), PUDTune "
          f"{tuned:.4f} (paper 0.033), {time.perf_counter() - t0:.3f}s")
    need(finite(base, tuned) and tuned < base,
         "the quickstart's calibration did not lower the ECR")
    return dict(baseline=base, tuned=tuned)


def stage_timer(walls: dict, sync):
    """``timed(stage, fn, *args)``: ``fn(*args)`` between two
    synchronisations, its wall added to ``walls[stage]``."""
    def timed(stage, fn, *args):
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        walls[stage] += time.perf_counter() - t0
        return out
    return timed


def calibration_walls(torch, dev, session, sync) -> dict:
    """The cache-miss calibration of ``session`` (``load_or_calibrate``)
    again, stage by stage, with ``cuda.synchronize`` after each: the
    fleet's manufacture, the draws and the ``calib_iter`` launches of
    ``calibrate_fleet``'s iterations, ``measure_ecr_fleet``, and the cache
    save.  Its levels, ECR and masks must equal the session's."""
    from repro_torch.core.ecr import measure_ecr_fleet
    from repro_torch.core.fleet import (fleet_calib_charges, ladder_tables,
                                        manufacture_fleet)
    from repro_torch.core.offsets import neutral_level
    from repro_torch.core.rng import derive_seed, generator
    from repro_torch.kernels.calib_iter import calib_iter
    from repro_torch.runtime.calib_cache import CalibrationTableCache
    phase("calibration walls: the cache-miss calibration stage by stage")
    cfg, p, cc, seed = (session.fleet_cfg, session.physics,
                        session.calib_cfg, session.seed)
    walls = dict.fromkeys(("manufacture", "draws", "calib_iter", "ecr",
                           "save"), 0.0)
    timed = stage_timer(walls, sync)

    offsets = timed("manufacture", manufacture_fleet, seed, cfg, p, dev)
    ladder = cfg.ladder(p)
    qsum, swing = ladder_tables(ladder, p)
    g, c = offsets.shape
    gen = generator(seed, "calibrate", device=dev)
    levels = torch.full((g, c), neutral_level(ladder), dtype=torch.int32,
                        device=dev)

    def draws():
        return (torch.randint(0, 2, (g, cc.n_samples, cc.maj_inputs, c),
                              generator=gen, device=dev, dtype=torch.uint8),
                torch.randn((g, cc.n_samples, c), generator=gen, device=dev,
                            dtype=torch.float32))

    for _ in range(cc.n_iterations):
        inputs, noise = timed("draws", draws)
        levels, _ = timed("calib_iter", calib_iter, inputs, noise, levels,
                          offsets, p, ladder.n_fracs, qsum, swing,
                          cc.threshold, cc.maj_inputs, cc.const_charge_sum,
                          cc.const_swing_sq)
    del inputs, noise
    ecr, masks = timed(
        "ecr", lambda: measure_ecr_fleet(
            derive_seed(seed, 0x0ECD), offsets,
            fleet_calib_charges(ladder, levels, p), p, ladder.n_fracs,
            n_trials=session.n_trials_ecr))
    st = session.calibration
    need(torch.equal(levels, st.levels) and torch.equal(ecr, st.ecr)
         and torch.equal(masks, st.masks),
         "the staged calibration differs from the session's")
    if dev.type == "cuda":
        # what the ECR stage runs on the card
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            measure_ecr_fleet(derive_seed(seed, 0x0ECD), offsets,
                              fleet_calib_charges(ladder, levels, p), p,
                              ladder.n_fracs, n_trials=session.n_trials_ecr)
            sync()
        rows = device_rows(prof)
        print(f"  measure_ecr_fleet under torch.profiler: device time "
              f"{sum(d for d, _, _ in rows) / 1e3:.1f} ms over "
              f"{sum(c for _, c, _ in rows)} device ops; by op:")
        print_top(rows)
    with tempfile.TemporaryDirectory(prefix="pud-walls-") as d:
        timed("save", lambda: CalibrationTableCache(d).save(
            session.device_id, cfg, p, levels.cpu().numpy(),
            ecr=ecr.cpu().numpy(), masks=masks.cpu().numpy(),
            metadata={"method": "fused", "n_iterations": cc.n_iterations},
            assumed_temp_c=p.temp_nominal_c))
    total = sum(walls.values())
    print("  " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in walls.items())
          + f"; sum {total * 1e3:.1f} ms (the session's unsynchronised "
          f"cache miss: {st.wall_s * 1e3:.1f} ms); levels, ECR and masks "
          "== the session's")
    return dict(walls_ms={k: v * 1e3 for k, v in walls.items()},
                session_ms=st.wall_s * 1e3)


def recalibration_phase(torch, dev, session, cache_dir: str, recal,
                        kernels, sync) -> dict:
    """Partial recalibration on a copy of the main run's cache: subarrays
    ``recal`` drift by a seeded normal shift of 0.5 sigma_static; their
    ECR against the old levels, then ``recalibrate_subarrays`` (its
    ``calib_iter`` launches counted), the same stages again with
    ``cuda.synchronize`` after each, and the checks: the kernel's levels
    equal the plain version's, one pass equals one pass per subarray, and
    the other rows of levels, ECR and masks are unchanged."""
    import shutil
    from repro_torch.core.ecr import measure_ecr_fleet
    from repro_torch.core.fleet import (fleet_calib_charges,
                                        iterate_calibration,
                                        manufacture_fleet,
                                        recalibrate_subarrays,
                                        recalibration_draws)
    from repro_torch.core.rng import derive_seed, generator
    from repro_torch.runtime.session import PUDSession
    phase(f"partial recalibration: subarrays {list(recal)} after a drift")
    tmp = tempfile.TemporaryDirectory(prefix="pud-recal-")
    shutil.copytree(cache_dir, tmp.name, dirs_exist_ok=True)
    rs = PUDSession.open(session.arch, grid=session.fleet_cfg,
                         cache_dir=tmp.name, calib=session.calib_cfg,
                         seed=session.seed, device=dev)
    st0 = rs.calibrate()
    need(st0.cache_hit, "the copied cache missed")
    cfg, p, cc, seed = rs.fleet_cfg, rs.physics, rs.calib_cfg, rs.seed
    ladder = cfg.ladder(p)
    offs = manufacture_fleet(seed, cfg, p, dev)
    gen = generator(SEED, "drift", device=dev)
    rows = torch.tensor(recal, device=dev)
    offs[rows] += 0.5 * p.sigma_static * torch.randn(
        (len(recal), cfg.n_cols), generator=gen, device=dev)
    before, _ = measure_ecr_fleet(
        derive_seed(seed, 0x0EC5), offs[rows],
        fleet_calib_charges(ladder, st0.levels[rows], p), p, ladder.n_fracs,
        n_trials=rs.n_trials_ecr)

    reset_counts(kernels)
    st1 = rs.recalibrate_subarrays(recal, offs)
    sync()
    launches = kernels["calib_iter"].launches
    need(launches == cc.n_iterations or dev.type != "cuda",
         f"recalibration launched calib_iter {launches} times")
    after = st1.ecr[rows]
    print("  ECR " + ", ".join(
        f"subarray {g}: {float(b):.4f} on the old levels -> {float(a):.4f}"
        for g, b, a in zip(recal, before, after))
          + f"; session wall {st1.wall_s * 1e3:.1f} ms (synchronised, the "
          f"save not included), {launches} calib_iter launches")

    walls = dict.fromkeys(("draws", "calib_iter", "ecr", "merge", "save"),
                          0.0)
    timed = stage_timer(walls, sync)

    def draws():
        it = recalibration_draws(seed, recal, cc, cfg.n_cols, dev)
        for _ in range(cc.n_iterations):
            yield timed("draws", next, it)

    levels, _ = timed("calib_iter", iterate_calibration, draws(),
                      offs[rows], ladder, p, cc)
    walls["calib_iter"] -= walls["draws"]       # the loop timed its draws
    ecr, masks = timed("ecr", lambda: measure_ecr_fleet(
        derive_seed(seed, 0x0EC5), offs[rows],
        fleet_calib_charges(ladder, levels, p), p, ladder.n_fracs,
        n_trials=rs.n_trials_ecr))

    def merge():
        lv, e, m = st0.levels.clone(), st0.ecr.clone(), st0.masks.clone()
        lv[rows], e[rows], m[rows] = levels, ecr, masks
        return lv, e, m

    lv, e, m = timed("merge", merge)
    timed("save", lambda: rs.cache.save(
        rs.device_id, cfg, p, lv.cpu().numpy(), ecr=e.cpu().numpy(),
        masks=m.cpu().numpy(), metadata={"method": rs.method,
                                         "recalibrated_subarrays":
                                         list(recal)},
        assumed_temp_c=p.temp_nominal_c))
    print("  stages: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                   for k, v in walls.items())
          + f"; sum {sum(walls.values()) * 1e3:.1f} ms")
    need(torch.equal(lv, st1.levels) and torch.equal(e, st1.ecr)
         and torch.equal(m, st1.masks),
         "the staged recalibration differs from the session's")
    keep = torch.tensor([g for g in range(cfg.n_subarrays_total)
                         if g not in recal], device=dev)
    need(torch.equal(st1.levels[keep], st0.levels[keep])
         and torch.equal(st1.ecr[keep], st0.ecr[keep])
         and torch.equal(st1.masks[keep], st0.masks[keep]),
         "recalibration changed a row it was not given")
    plain = recalibrate_subarrays(seed, offs, recal, cfg, p, cc,
                                  method="reference")
    need(torch.equal(st1.levels[rows], plain),
         "recalibrated levels through calib_iter differ from the plain "
         "version")
    apart = torch.cat([recalibrate_subarrays(seed, offs, [g], cfg, p, cc)
                       for g in recal])
    need(torch.equal(apart, plain), "recalibrating one subarray at a time "
         "differs from one pass over both")
    need(rs.cache.load(rs.device_id, cfg, p).metadata[
        "recalibrated_subarrays"] == list(recal),
        "the merged table was not persisted")
    print(f"  levels of {list(recal)}: kernel == plain version, one pass "
          f"== one pass per subarray; the other "
          f"{cfg.n_subarrays_total - len(recal)} rows of levels, ECR and "
          "masks unchanged")
    tmp.cleanup()
    return dict(launches=launches, wall_ms=st1.wall_s * 1e3,
                walls_ms={k: v * 1e3 for k, v in walls.items()},
                ecr_before=[float(x) for x in before],
                ecr_after=[float(x) for x in after])


def fault_phase(torch, dev, model, params, tokens, max_len, masks, grid,
                kernels, sync) -> dict:
    """Read-fault injection at full width: a placed plan and the identity
    plan from the main run's masks, both packed, both with every
    error-prone window column reading its stuck value; prefill and
    ``FAULT_STEPS`` greedy decode steps through the placed kernels.  The
    placed logits stay bit-identical; the identity layout's break."""
    from repro_torch.launch import serve
    from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
    from repro_torch.pud.packer import pack_for_serving, packing_requests
    from repro_torch.pud.placement import inject_read_faults, plan_for_grid
    phase("read-fault injection: placed vs identity layout")
    cfg = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE)
    reqs = packing_requests(params, cfg)
    m = masks.cpu().numpy()
    gshape = (grid["n_channels"], grid["n_banks"], grid["n_subarrays"])
    reset_counts(kernels)
    out = {}
    for label, avoid in (("placed", True), ("identity", False)):
        plan = plan_for_grid(m, reqs, gshape, avoid_faulty=avoid)
        clean, _ = pack_for_serving(params, cfg, placement=plan)
        hurt = inject_read_faults(clean, plan)
        bad = sum(int(tp.faulty.sum()) for tp in plan.entries.values())
        _, lc = serve.greedy_generate(model, clean, tokens, FAULT_STEPS,
                                      max_len)
        _, lh = serve.greedy_generate(model, hurt, tokens, FAULT_STEPS,
                                      max_len)
        sync()
        out[label] = dict(clean=lc, hurt=lh, corrupted_cols=bad,
                          used=plan.used_total)
        del clean, hurt
        print(f"  {label}: {plan.used_total:,} columns placed, {bad:,} "
              "corrupted window columns")
    counts = read_counts(kernels)
    pl_, id_ = out["placed"], out["identity"]
    delta = float((id_["hurt"] - id_["clean"]).abs().max())
    print(f"  launches: {counts}; logits {list(pl_['clean'].shape)}: "
          "placed fault-injected == clean bit for bit, identity clean == "
          f"placed clean, identity fault-injected max |delta| {delta:.3f}")
    need(torch.equal(pl_["hurt"], pl_["clean"]),
         "fault-injected placed logits differ from the clean ones")
    need(torch.equal(id_["clean"], pl_["clean"]),
         "the identity layout's clean logits differ from the placed ones")
    need(delta > 0.1, f"identity logits moved by only {delta}")
    need(pl_["corrupted_cols"] > 0 and id_["corrupted_cols"] > 0,
         "no window column was corrupted")
    need(counts["gemm_placed"] > 0 or dev.type != "cuda",
         "fault-injected decode never launched gemm_placed")
    return dict(launches=counts, delta=delta,
                corrupted_cols={k: v["corrupted_cols"]
                                for k, v in out.items()})


def swap_packs(tree, packs: dict, path=()):
    """``tree`` with every ``<name>_pud`` pack replaced by ``packs[name]``."""
    out = {}
    for key, sub in tree.items():
        if key.endswith("_pud"):
            out[key] = packs["/".join(path + (key[: -len("_pud")],))]
        elif isinstance(sub, dict):
            out[key] = swap_packs(sub, packs, path + (key,))
        else:
            out[key] = sub
    return out


def archive_phase(torch, dev, model, runs, kernels, sync) -> dict:
    """The pack archive: each (label, PackedModel, prompts) of ``runs`` is
    saved with ``save_packed_npz`` and loaded with ``load_packed_npz``;
    greedy decode at batch 4 and one batch-1 request from the loaded packs
    must equal the in-memory packs' tokens and logits bit for bit, and a
    loaded layer's ``to_dense`` form through the GEMM kernel must equal its
    bit-packed one."""
    from repro_torch.core.rng import generator
    from repro_torch.kernels import placed_gemm, plane_gemm
    from repro_torch.launch import serve
    from repro_torch.pud.packed import (load_packed_npz, save_packed_npz,
                                        to_dense)
    phase("pack archive: save, load, decode from the loaded packs")
    gen = generator(SEED, "archive", device=dev)
    res = {}
    with tempfile.TemporaryDirectory(prefix="pud-packs-") as d:
        for label, pm, tokens, max_len in runs:
            path = pathlib.Path(d) / f"{label}.npz"
            sync()
            t0 = time.perf_counter()
            save_packed_npz(path, pm)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = load_packed_npz(path, device=dev)
            sync()
            t_load = time.perf_counter() - t0
            need(loaded is not None and list(loaded) == list(pm.tensors),
                 f"the {label} archive did not load")
            tree = swap_packs(pm.params, loaded)
            reset_counts(kernels)
            for rows_ in (BATCH, 1):
                toks = tokens[:rows_]
                got = serve.greedy_generate(model, tree, toks, ARCHIVE_STEPS,
                                            max_len)
                want = serve.greedy_generate(model, pm.params, toks,
                                             ARCHIVE_STEPS, max_len)
                sync()
                need(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]),
                     f"{label} batch-{rows_} decode from the archive "
                     "differs from the in-memory packs")
            counts = read_counts(kernels)
            pt = loaded["layers_0_dense/mixer/wi"].layer(0)
            dense = to_dense(pt)
            x = torch.randint(-127, 128, (BATCH, pt.k), generator=gen,
                              device=dev, dtype=torch.int8)
            if pt.placed:
                fn, extra = placed_gemm.gemm_placed, (pt.col_ids,)
                kw = dict(window_block=pt.window_block)
            else:
                fn, extra, kw = plane_gemm.gemm, (), {}
            a = fn(x, pt.planes, *extra, "folded", layout=pt.layout,
                   logical_k=pt.logical_k, **kw)
            b = fn(x, dense.planes, *extra, "folded", layout="dense",
                   logical_k=None, **kw)
            sync()
            need(torch.equal(a, b), f"{label}: to_dense of a loaded pack "
                 "differs from its bit-packed form through the kernel")
            size = path.stat().st_size
            print(f"  {label}: {len(loaded)} packs, {size / 2**20:.1f} MiB, "
                  f"save {t_save:.3f}s, load {t_load:.3f}s; batch {BATCH} "
                  f"and batch 1 x {ARCHIVE_STEPS} steps from the loaded "
                  f"packs == in memory, bit for bit; to_dense through "
                  f"{fn.__name__} == bit-packed; launches {counts}")
            res[label] = dict(bytes=size, save_s=t_save, load_s=t_load,
                              launches=counts)
            del loaded, tree
    return res


def monitored_phase(torch, dev, preset: str, grid: dict, cache_dir: str,
                    cfg: dict, kernels, sync) -> dict:
    """``serve --monitor --drift-sim`` at ``preset`` on a copy of the main
    run's cache (the recovery rewrites the table and drops its
    placements): a table hit, a new canary-aware placement, critical events
    on the drifted subarrays only, a recovery of exactly those (its
    ``calib_iter`` launches counted), the other rows of the persisted table
    unchanged, a repacked placement off every refreshed fault and canary,
    tokens on every step, post-swap decode equal to a fresh pack's; then
    one probe round profiled by kernel."""
    import shutil
    from repro_torch.core.canary import probe_ecr
    from repro_torch.core.rng import derive_seed
    from repro_torch.launch import serve
    from repro_torch.runtime.calib_cache import CalibrationTableCache
    subs = sorted(cfg["subarrays"])
    phase(f"monitored serving: --monitor --drift-sim, drift at step "
          f"{cfg['drift_at']} on subarrays {subs}")
    tmp = tempfile.TemporaryDirectory(prefix="pud-monitor-")
    shutil.copytree(cache_dir, tmp.name, dirs_exist_ok=True)
    argv = ["--arch", ARCH, "--preset", preset, "--pud-gemv", "--engine",
            "--batch", str(cfg["batch"]), "--batch-size", str(cfg["slots"]),
            "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--fleet-subarrays", str(grid["n_subarrays"]),
            "--fleet-cols", str(grid["n_cols"]), "--calib-cache", tmp.name,
            "--monitor", "--drift-sim", "--drift-at", str(cfg["drift_at"]),
            "--drift-subarrays", ",".join(map(str, subs)),
            "--probe-every", str(cfg["probe_every"]),
            "--n-canary", str(cfg["n_canary"]), "--seed", str(SEED),
            "--device", str(dev)]
    print("  serve " + " ".join(a if a != tmp.name else "<cache copy>"
                                for a in argv))
    reset_counts(kernels)
    t0 = time.perf_counter()
    res = serve.run(serve.parse_args(argv))
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    s, mon = res["session"], res["monitor"]
    rep = mon["report"]
    print(f"  launches: {counts}; serve wall {wall:.1f}s")
    need(s.calibration is not None and res["placement"][0] == "planned",
         f"placement {res['placement']}")
    fp = s.canaries.fingerprint()
    need(res["placement"][1].endswith(f"-c{fp}"),
         f"placement name {res['placement'][1]} lacks the canary set {fp}")
    cache = CalibrationTableCache(cache_dir)
    t_old = cache.load(s.device_id, s.fleet_cfg, s.physics)
    need(t_old is not None, "the main run's table is missing")
    events = mon["monitor"].detector.events
    crit = sorted({e.subarray for e in events if e.severity == "critical"})
    need(crit == subs, f"critical events on {crit}, drifted {subs}")
    need(len(rep["recoveries"]) == 1
         and rep["recoveries"][0]["subarrays"] == subs,
         f"recoveries {[r['subarrays'] for r in rep['recoveries']]}")
    n_it = s.calib_cfg.n_iterations
    need(counts["calib_iter"] == n_it or dev.type != "cuda",
         f"the recovery launched calib_iter {counts['calib_iter']} times, "
         f"not {n_it}")
    need(counts["gemm_placed"] > 0 or dev.type != "cuda",
         "the monitored engine never launched gemm_placed")
    t_new = s.cache.load(s.device_id, s.fleet_cfg, s.physics)
    keep = [g for g in range(s.fleet_cfg.n_subarrays_total) if g not in subs]
    need(t_new.metadata.get("recalibrated_subarrays") == subs,
         "the recovered table was not persisted")
    need(all(np.array_equal(getattr(t_new, f)[keep], getattr(t_old, f)[keep])
             for f in ("levels", "ecr", "masks")),
         "the recovery changed a persisted row it was not given")
    bad = (s.calibration.masks.cpu().numpy() | s.canaries.mask()).reshape(-1)
    placed = np.concatenate([np.asarray(tp.phys_cols).ravel()
                             for tp in s.placement.entries.values()])
    need(not bad[placed].any(), "the repacked placement uses a refreshed "
         "fault or a canary")
    need(rep["min_tokens_per_step"] > 0 and rep["swap_step_tokens"]
         and min(rep["swap_step_tokens"]) > 0, "a step stalled")
    need(mon["spot_ok"] == mon["spot_n"] > 0,
         "post-swap decode differs from a fresh pack's")
    comps = mon["completions"]
    need(len(comps) == cfg["batch"] + mon["spot_n"]
         and all(len(c.tokens) == GEN for c in comps),
         "the monitored engine did not complete every request")
    rec = rep["recoveries"][0]
    lat = rec["detected_step"] - mon["drift_step"]
    print(f"  canary set {fp}; placement {res['placement'][1]} planned; "
          f"{len(keep)} other rows of the persisted table unchanged; "
          f"{len(placed):,} placed columns, none on a refreshed fault or "
          "canary")
    print(f"  drift at engine step {mon['drift_step']}, detected at step "
          f"{rec['detected_step']} (latency {lat} steps, probe round "
          f"{rec['detected_round']}); canary ECR at detection "
          + ", ".join(f"{g}: {e:.4f}"
                      for g, e in rec["canary_ecr_at_detection"].items()))
    print("  table ECR " + ", ".join(
        f"subarray {g}: {mon['ecr_before'][g]:.4f} -> "
        f"{mon['ecr_after'][g]:.4f}" for g in subs)
          + f"; recalibrate {rec['recalibrate_wall_s'] * 1e3:.1f} ms, "
          f"repack {rec['repack_wall_s'] * 1e3:.1f} ms (synchronised)")
    print(f"  swap at steps {rep['swap_steps']}, tokens on swap steps "
          f"{rep['swap_step_tokens']}, min tokens per step "
          f"{rep['min_tokens_per_step']}; modeled probe overhead "
          f"{rep['probe_overhead']:.4%} of DRAM time; spot check "
          f"{mon['spot_ok']}/{mon['spot_n']} bit-identical")
    sim, m = mon["sim"], mon["monitor"]
    probe = profile_calls(torch, "one probe round (16 subarrays x "
                          f"{cfg['n_canary']} canaries, "
                          f"{m.config.probe_trials} trials)",
                          lambda: probe_ecr(
                              derive_seed(m.seed, 0), sim.sense_offsets(),
                              m._charges(), s.physics, s.n_fracs,
                              cols=s.canaries.cols,
                              n_trials=m.config.probe_trials), sync)
    out = dict(launches=counts, wall_s=wall, detected_step=rec[
        "detected_step"], latency_steps=lat,
        canary_ecr=rec["canary_ecr_at_detection"],
        ecr_before=[float(mon["ecr_before"][g]) for g in subs],
        ecr_after=[float(mon["ecr_after"][g]) for g in subs],
        recalibrate_ms=rec["recalibrate_wall_s"] * 1e3,
        repack_ms=rec["repack_wall_s"] * 1e3,
        overhead=rep["probe_overhead"], probe=probe,
        events=[(e.subarray, e.severity) for e in events])
    del res, s, mon
    tmp.cleanup()
    return out


def figures_phase(torch, dev, scale: dict, kernels, sync) -> dict:
    """The paper's figures through ``repro_torch.benchmarks.run`` at
    ``scale`` (Table I and the fleet benchmark ran in their own phases):
    each prints its ``#csv`` block and its validation lines beside the
    paper's numbers; any raising benchmark fails the phase.  The phase's
    kernel launches (drift_recovery's and placement's) are held against
    the plain versions on the same inputs (``check_plain``, required)."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.common import BenchScale
    need(scale.get("check_plain"), "drift_recovery's and placement's "
         "kernel launches would run unchecked: set check_plain")
    # the roofline reads the dry run's records: the dryrun group runs it
    names = [n for n in bench_run.BENCHES if n not in (
        "table1", "fleet", "roofline", *BENCHMARKS)]
    phase(f"the paper's figures: benchmarks.run {names} at {scale}")
    reset_counts(kernels)
    walls = bench_run.run_benches(names, BenchScale(**scale), dev)
    sync()
    counts = read_counts(kernels)
    failed = [n for n, (_, f) in walls.items() if f]
    print("  walls: " + ", ".join(f"{n} {w:.2f}s"
                                  for n, (w, _) in walls.items())
          + f"; launches {counts}")
    need(not failed, f"benchmarks failed: {failed}")
    return dict(walls_s={n: w for n, (w, _) in walls.items()},
                launches=counts)


def fleet_calibration_phase(torch, dev, argv, counter) -> dict:
    """``repro_torch.benchmarks.fleet_calibration.main(argv)``: its fused
    kernel legs must equal the plain version on the same inputs, the
    parity leg and (``--check-full``, required here) the main leg, or the
    benchmark raises; it prints its ``#csv`` block."""
    from repro_torch.benchmarks import fleet_calibration
    phase(f"benchmarks.fleet_calibration {' '.join(argv)}")
    need("--check-full" in argv, "the fleet benchmark's main leg would run "
         "calib_iter unchecked: pass --check-full")
    counter.launches = 0
    try:
        rc = fleet_calibration.main(argv)
    except RuntimeError as e:
        raise PhaseError(str(e)) from e
    need(rc == 0, f"fleet_calibration exited {rc}")
    need(counter.launches > 0 or dev.type != "cuda",
         "fleet_calibration never launched calib_iter")
    print(f"  calib_iter launches: {counter.launches}")
    return dict(launches=counter.launches)


def simra_phase(torch, dev, cfg: dict, counter) -> dict:
    """MAJ5 through the command-level simulator: per event, five operand
    rows, the B_{3,0,0} rows built with commands (a 1 row Frac'd three
    times, a 0 row, a 1 row) and one ``simra`` over the eight rows.  Its
    ECR must agree with ``measure_ecr_maj5`` on the same offsets: both are
    means over the columns of independent per-column error events, so they
    may differ by 4 sigma of a binomial share, 4 sqrt(2 e (1 - e) / C)."""
    from repro_torch.core.ecr import measure_ecr_maj5
    from repro_torch.core.offsets import baseline_charges
    from repro_torch.core.rng import generator
    from repro_torch.pud import device as pud
    from repro_torch.pud.physics import PhysicsParams
    n, events = cfg["n_cols"], cfg["events"]
    phase(f"command-level MAJ5: {events} SiMRA events on one {n}-column "
          "subarray")
    p = PhysicsParams()
    pud.set_params(p)
    gen = generator(SEED, "simra", device=dev)
    state = pud.make_subarray(gen, 8, n, p, device=dev)
    ones = torch.ones(n, device=dev)
    any_err = torch.zeros(n, dtype=torch.bool, device=dev)

    def event(state):
        bits = torch.randint(0, 2, (5, n), generator=gen, device=dev,
                             dtype=torch.uint8)
        for r in range(5):
            state = pud.write_row(state, r, bits[r])
        state = pud.write_row(state, 5, ones)
        for _ in range(3):
            state = pud.frac(state, 5)
        state = pud.write_row(state, 6, torch.zeros_like(ones))
        state = pud.write_row(state, 7, ones)
        state, out = pud.simra(state, range(8), gen, 3)
        return state, out != (bits.sum(dim=0) > 2).to(torch.float32)

    counter.launches = 0
    t0 = time.perf_counter()
    for _ in range(events):
        state, err = event(state)
        any_err |= err
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    need(launches == events or dev.type != "cuda",
         f"{events} SiMRA events launched majx_sense {launches} times")
    cmd = float(any_err.float().mean())
    fast, _ = measure_ecr_maj5(generator(SEED, "simra-ecr", device=dev),
                               state.sense_offset,
                               baseline_charges(3, n, p, device=dev), p, 3,
                               n_trials=events)
    e = (cmd + fast) / 2
    tol = 4 * math.sqrt(2 * e * (1 - e) / n)
    print(f"  ECR over {events} trials: command level {cmd:.4f}, "
          f"measure_ecr_maj5 {fast:.4f}, |diff| {abs(cmd - fast):.4f} "
          f"(tolerance {tol:.4f}); {launches} majx_sense launches, "
          f"{wall:.3f}s")
    need(abs(cmd - fast) <= tol, "command-level ECR disagrees with "
         "measure_ecr_maj5")
    res = dict(ecr_cmd=cmd, ecr_fast=fast, tol=tol, launches=launches,
               wall_ms_per_event=wall / events * 1e3)
    if dev.type == "cuda":
        # device time per event, by kernel, over a few more events
        from torch.profiler import ProfilerActivity, profile
        n_prof = 16
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                state, _ = event(state)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        need(rows, "the profiler reported no device time for the events")
        busy = sum(d for d, _, _ in rows) / 1e3 / n_prof
        sense_ms = sum(d for d, _, k in rows if "sense_kernel" in k) / 1e3
        res.update(device_ms_per_event=busy,
                   sense_ms_per_event=sense_ms / n_prof)
        print(f"  per event: host wall {res['wall_ms_per_event']:.4f} ms "
              f"(the {events} events' wall / {events}); device time "
              f"{busy:.4f} ms, of which majx_sense "
              f"{sense_ms / n_prof:.4f} ms (torch.profiler over {n_prof} "
              "more events); by op, per event:")
        print_top(rows, n_prof)
    return res


def print_top(rows, per: int = 1, n: int = 5) -> None:
    """The ``n`` ops with the most device time, divided by ``per``."""
    for dev_us, count, key in sorted(rows, reverse=True)[:n]:
        print(f"    {dev_us / 1e3 / per:8.4f} ms  x{count / per:<6g} "
              f"{key[:70]}")


def dense_phase(torch, dev, cfg: dict, kernels) -> dict:
    """The dense plane layout through the ``ops`` entries at the reference
    kernel benchmark's shapes: GEMM entries at B rows, GEMV entries at one,
    both modes, each equal to the integer product."""
    from repro_torch.core.rng import generator
    from repro_torch.kernels import ops, ref
    b, k, n, wb = cfg["b"], cfg["k"], cfg["n"], cfg["wb"]
    phase(f"dense layout through ops: x [{b} | 1, {k}] x planes "
          f"[{wb}, {k}, {n}] int8")
    g = generator(SEED, "dense", device=dev)
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (k, n), generator=g,
                      device=dev, dtype=torch.int32)
    planes = ref.pack_bitplanes(w, wb)
    # a placed window: blocks of 256 logical columns among 288 window columns
    bc, pwb = 256, 288
    cols = torch.cat([j * pwb + torch.randperm(pwb, generator=g,
                                               device=dev)[:bc]
                      for j in range(n // bc)]).to(torch.int32)
    window = torch.zeros((wb, k, (n // bc) * pwb), dtype=torch.int8,
                         device=dev)
    window[:, :, cols.long()] = planes
    x = torch.randint(-127, 128, (b, k), generator=g, device=dev,
                      dtype=torch.int8)
    reset_counts(kernels)
    for mode in ("planes", "folded"):
        for xb, entries in ((x[:1].contiguous(), ("gemv", "gemv_placed")),
                            (x, ("gemm", "gemm_placed"))):
            want = (xb.double() @ w.double()).to(torch.int32)
            unplaced = getattr(ops, f"bitplane_{entries[0]}")(xb, planes,
                                                              mode)
            placed = getattr(ops, f"bitplane_{entries[1]}")(
                xb, window, cols, mode, window_block=pwb)
            need(torch.equal(unplaced, want) and torch.equal(placed, want),
                 f"dense {entries} ({mode}) differ from x @ W")
    xf = torch.randn((b, k), generator=g, device=dev)
    scale = torch.rand(n, generator=g, device=dev) + 0.01
    for xi in (xf, xf[0]):
        got = ops.pud_gemv(xi, planes, scale)
        want = ops.pud_gemv(xi, planes, scale, backend="reference")
        need(torch.equal(got, want), "dense pud_gemv differs from the "
             "reference backend")
    counts = {e: kernels[e].launches
              for e in ("gemm", "gemv", "gemm_placed", "gemv_placed")}
    print(f"  launches: {counts}; every entry == x @ W")
    need(all(v > 0 for v in counts.values()) or dev.type != "cuda",
         "a dense entry never launched its kernel")
    pack = types.SimpleNamespace(k=k, n=n, layout="dense", logical_k=None,
                                 planes=planes, col_ids=None,
                                 window_block=None)
    placed_pack = types.SimpleNamespace(k=k, n=n, layout="dense",
                                        logical_k=None, planes=window,
                                        col_ids=cols, window_block=pwb)
    return dict(launches=counts, pack=pack, placed_pack=placed_pack)


def ragged_requests(torch, vocab: int, spec: dict = RAGGED):
    """``spec["n"]`` requests with prompt lengths and budgets drawn from the
    seed, so buckets differ and slots are admitted mid-run."""
    from repro_torch.core.rng import generator
    from repro_torch.runtime.engine import Request
    g = generator(SEED, "ragged")
    (p0, p1), (b0, b1) = spec["prompt"], spec["budget"]
    lens = torch.randint(p0, p1 + 1, (spec["n"],), generator=g).tolist()
    budgets = torch.randint(b0, b1 + 1, (spec["n"],), generator=g).tolist()
    return [Request(i, torch.randint(0, vocab, (n,), generator=g,
                                     dtype=torch.int32), m)
            for i, (n, m) in enumerate(zip(lens, budgets))]


GEMM_KERNELS = ("dp4a_kernel", "mma_kernel", "plane_kernel")


def device_rows(prof) -> list:
    """(device us, calls, name) of every event that ran on the device:
    kernels, copies, memsets.  The host ops that launched them are left
    out: an op's self device time is the time of the kernels it launched,
    which appear as rows of their own, so summing both counts them
    twice."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if e.device_type != DeviceType.CPU and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return rows


def print_gemm_kernels(rows, per: str, was: str = "") -> list:
    gemm = [(d, c, k) for d, c, k in rows
            if any(name in k for name in GEMM_KERNELS)]
    print(f"  GEMM kernels: {sum(d for d, _, _ in gemm) / 1e3:.3f} ms over "
          f"{sum(c for _, c, _ in gemm)} launches per {per}{was}")
    return gemm


def profile_prefill(torch, model, params, tokens, max_len, sync) -> list:
    """Device time of one prefill by kernel (``torch.profiler``); returns
    the GEMM kernels' rows."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model.prefill(params, tokens, max_len=max_len)
        sync()
        acts = [ProfilerActivity.CPU]
        if tokens.is_cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            model.prefill(params, tokens, max_len=max_len)
            sync()
    rows = device_rows(prof)
    if not rows:
        print("  device time: not measured (the profiler reported none)")
        return []
    print(f"  device time {sum(r[0] for r in rows) / 1e3:.3f} ms; GEMM "
          "kernels by name:")
    gemm = print_gemm_kernels(rows, "prefill")
    for dev_us, count, key in sorted(gemm, reverse=True):
        print(f"    {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    return gemm


def profile_calls(torch, label: str, fn, sync, was: str = "") -> dict:
    """Host wall of one call of ``fn`` (median of 5, synchronised) and,
    from ``torch.profiler``, the device time it launched, by kernel, and
    the GEMM kernels' sum and launches (``was``: printed beside it)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        for _ in range(2):
            fn()
        sync()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            fn()
            sync()
    wall = statistics.median(walls)
    rows = device_rows(prof)
    print(f"  {label}: host wall {wall:.3f} ms (median of 5)")
    if not rows:
        print("  device time: not measured (the profiler reported none)")
        return dict(wall_ms=wall)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"  device time {busy:.3f} ms ({busy / wall:.1%} of the wall); "
          "by kernel:")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:70]}")
    gemm = print_gemm_kernels(rows, "step", was)
    return dict(wall_ms=wall, device_ms=busy,
                gemm_ms=sum(d for d, _, _ in gemm) / 1e3,
                gemm_launches=sum(c for _, c, _ in gemm))


def profile_step(torch, model, params, tokens, max_len, sync,
                 placed_was=None) -> dict:
    """``profile_calls`` over one decode step after a prefill of
    ``tokens``; ``placed_was``: the placed GEMM's device time per step
    before its staged redesign (ms), printed beside it."""
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens, max_len=max_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return profile_calls(torch, f"decode step (batch {tokens.shape[0]})",
                         lambda: model.decode_step(params, cache, nxt,
                                                   tokens.shape[1]), sync,
                         "" if placed_was is None else
                         f" (before the staged redesign: {placed_was} ms)")


def gemma_traffic(torch, vocab: int, cfg: dict):
    """The gemma phase's requests, as (first wave, second wave): the first
    shared prompt and the two unrelated ones, then the other shared
    prompts and the repeats of requests 0 and 1.  Lengths and budgets come
    from a CPU generator, so a CPU rehearsal draws the same ones."""
    from repro_torch.core.rng import generator
    from repro_torch.runtime.engine import Request
    g = generator(SEED, "gemma-traffic")

    def n_in(lo_hi):
        return int(torch.randint(lo_hi[0], lo_hi[1] + 1, (1,), generator=g))

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g, dtype=torch.int32)

    system = toks(cfg["system"])
    shared = [torch.cat([system, toks(n_in(cfg["own"]))])
              for _ in range(cfg["n_shared"])]
    unrelated = [toks(n_in(cfg["unrelated"])) for _ in range(2)]
    prompts = ([shared[0]] + unrelated + shared[1:]
               + [shared[0].clone(), unrelated[0].clone()])
    reqs = [Request(i, t, n_in(cfg["budget"])) for i, t in enumerate(prompts)]
    return reqs[:3], reqs[3:]


def counting_cache(capacity: int):
    """A ``PrefixCache`` that also counts its full hits (an entry covering
    the whole prompt) apart from its partial ones."""
    from repro_torch.runtime.prefix_cache import PrefixCache

    class Counting(PrefixCache):
        full_hits = 0

        def lookup(self, version, tokens, lengths):
            entry = super().lookup(version, tokens, lengths)
            if entry is not None and entry.n_tokens == len(tokens):
                self.full_hits += 1
            return entry

    return Counting(capacity=capacity)


def serve_waves(engine, waves, warm: int) -> list:
    """Submit the first wave, step ``warm`` times (the first shared prompt's
    chunks), then serve the second wave to completion."""
    first, second = waves
    engine.submit_all(first)
    for _ in range(warm):
        engine.step()
    return engine.run(second)


def gemma_phase(torch, dev, cfg: dict, kernels, sync) -> dict:
    """gemma-7b at full width (depth not cut, random weights from the seed)
    served by the engine's scheduler through the placed kernels.

    Calibrate a 1 x 1 x 32 x 65,536 grid (a cache miss), place and pack
    the FFN and unembed projections (4 bits); then the same traffic
    through (A) chunked prefill of ``chunk`` rows with a prefix cache and a
    heartbeat, (B) the FIFO engine with whole-request bucketed prefill,
    (C) A's scheduler with SLO admission; A's tokens and logits equal B's
    bit for bit, C's unshed requests equal B's; A again through the plain
    versions, bit for bit; profiles of a chunk step and a decode step.
    Returns the packs for the kernel rows and the launches of runs A-C."""
    from repro_torch.configs import get
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.rng import generator
    from repro_torch.models.params import init_params, param_count
    from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
    from repro_torch.runtime.engine import ServingEngine, SLOConfig
    from repro_torch.runtime.session import PUDSession
    from repro_torch.runtime.watchdog import Heartbeat
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spec = get(cfg["arch"])
    model = spec.make_model() if cfg["preset"] == "full" else \
        spec.make_smoke()
    mc = model.cfg
    phase(f"{cfg['arch']} ({cfg['preset']}): calibrate -> place -> pack on "
          f"a {cfg['grid']['n_subarrays']} x {cfg['grid']['n_cols']:,} grid")
    sync()
    t0 = time.perf_counter()
    params = init_params(model.param_defs(), SEED, dev)
    sync()
    print(f"  {param_count(model.param_defs()):,} parameters ({mc.n_layers} "
          f"layers, d {mc.d_model}, d_ff {mc.d_ff}, heads {mc.n_heads} / "
          f"{mc.n_kv_heads} of {mc.hd}, vocab {mc.vocab}, {mc.activation}, "
          f"embed scale {mc.embed_scale}, zero-centred norm "
          f"{mc.zero_centered_norm}); init {time.perf_counter() - t0:.2f}s")
    cache = tempfile.TemporaryDirectory(prefix="pud-gemma-")
    session = PUDSession.open(
        cfg["arch"], grid=FleetConfig(**cfg["grid"]), cache_dir=cache.name,
        calib=CalibrationConfig(n_iterations=12, n_samples=256),
        seed=SEED + 2, device=dev)
    reset_counts(kernels)
    st = session.calibrate()
    sync()
    calib_launches = kernels["calib_iter"].launches
    need(not st.cache_hit, "a fresh cache reported a hit")
    need(calib_launches > 0 or not on_card,
         "calibration never launched calib_iter")
    print(f"  calibration MISS in {st.wall_s:.3f}s: "
          f"{session.fleet_cfg.n_subarrays_total} subarrays, mean ECR "
          f"{st.mean_ecr:.4f}, {calib_launches} calib_iter launches")
    sync()
    t0 = time.perf_counter()
    packed = session.pack(params, PUDGemvConfig(weight_bits=4,
                                                packable=FFN_PACKABLE),
                          name=f"{cfg['arch']}-{cfg['preset']}")
    sync()
    t_pack = time.perf_counter() - t0
    del params
    need(session.placement_status == "planned" and packed.placed,
         f"placement {session.placement_status}: {session.placement_error}")
    rep = session.placement.capacity_report()
    extras = session.decode_extras()
    print(f"  placement planned: {rep['used_cols']:,} / "
          f"{rep['usable_cols']:,} error-free columns used (occupancy "
          f"{rep['occupancy']:.4f}, {rep['occupied_subarrays']} / "
          f"{rep['n_subarrays']} subarrays); {extras['n_packed']} packs, "
          f"{extras['stored_bytes'] / 2**30:.2f} GiB bit-packed; pack "
          f"{t_pack:.2f}s")
    for name in ("layers_0_dense/mixer/wi", "layers_0_dense/mixer/wo",
                 "unembed/w"):
        tp = session.placement.entries[name]
        print(f"    {name}: block {tp.block_cols}, window block "
              f"{tp.window_block}")

    waves = gemma_traffic(torch, mc.vocab, cfg)
    reqs = waves[0] + waves[1]
    warm = -(-waves[0][0].prompt_len // cfg["chunk"])
    print(f"  traffic: {len(reqs)} requests on {cfg['slots']} slots, "
          f"prompts {[r.prompt_len for r in reqs]}, budgets "
          f"{[r.max_new_tokens for r in reqs]}")
    common = dict(max_len=cfg["max_len"], batch_size=cfg["slots"],
                  collect_logits=True)

    def sched():
        return dict(chunk_prefill=cfg["chunk"],
                    prefix_cache=counting_cache(cfg["cache"]))

    def drive(label, engine):
        reset_counts(kernels)
        sync()
        t0 = time.perf_counter()
        comps = serve_waves(engine, waves, warm)
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts(kernels)
        r = engine.scheduler_report()
        print(f"  run {label}: {r['completed']} requests, "
              f"{r['generated_tokens']} tokens in {r['steps']} decode "
              f"steps, {r['prefill_chunks']} prefill chunks, "
              f"{r['prefilled_tokens']} prefilled tokens, "
              f"{r['prefill_traces']} bucket / {r['chunk_traces']} chunk "
              f"shapes, decode {r['wall_tok_s']:.1f} tok/s; {wall:.2f}s "
              f"wall; launches {counts}")
        return comps, r, counts, wall

    phase("gemma run A: chunked prefill + prefix cache + heartbeat")
    beat_dir = tempfile.TemporaryDirectory(prefix="pud-beat-")
    eng_a = session.serving_engine(model, heartbeat=Heartbeat(beat_dir.name),
                                   **common, **sched())
    comps_a, rep_a, counts_a, wall_a = drive("A", eng_a)
    pc = rep_a["prefix_cache"]
    full = eng_a._prefix_cache.full_hits
    print(f"    prefix cache: {pc['hits']} hits ({full} full, "
          f"{pc['hits'] - full} partial) / {pc['misses']} misses, "
          f"{pc['entries']} entries ({pc['bytes'] / 2**20:.1f} MiB), "
          f"{pc['evictions']} evictions")
    need(counts_a["gemm_placed"] > 0 and counts_a["gemv_placed"] > 0
         or not on_card, "run A never launched the placed GEMM and GEMV")
    need(counts_a["gemm"] == counts_a["gemv"] == 0,
         "the placed path launched an unplaced kernel")
    beats = Heartbeat.read_all(beat_dir.name)
    need(len(beats) == 1 and beats[0]["step"] == rep_a["steps"]
         and beats[0]["completed"] == len(reqs),
         f"the heartbeat does not hold the engine's last step: {beats}")
    print(f"    heartbeat: step {beats[0]['step']}, count "
          f"{beats[0]['count']}, {beats[0]['completed']} completed")
    beat_dir.cleanup()

    phase("gemma run B: FIFO engine, whole-request bucketed prefill")
    eng_b = session.serving_engine(model, **common)
    comps_b, rep_b, counts_b, wall_b = drive("B", eng_b)
    need(len(comps_a) == len(comps_b) == len(reqs)
         and all(len(c.tokens) == r.max_new_tokens
                 for c, r in zip(comps_b, reqs)),
         "an engine did not complete every request with its budget")
    need(all(0 <= t < mc.vocab for c in comps_b for t in c.tokens),
         "bad tokens")
    need(all(bool(torch.isfinite(c.logits).all()) for c in comps_b),
         "non-finite logits")
    same_tokens = all(a.tokens == b.tokens for a, b in zip(comps_a, comps_b))
    delta = max(float((a.logits - b.logits).abs().max())
                for a, b in zip(comps_a, comps_b))
    bit = all(torch.equal(a.logits, b.logits)
              for a, b in zip(comps_a, comps_b))
    print(f"  A vs B: tokens {'equal' if same_tokens else 'DIFFER'}, logits "
          f"{'bit-identical' if bit else f'max |delta| {delta}'}; "
          f"prefilled tokens A {rep_a['prefilled_tokens']} < B "
          f"{rep_b['prefilled_tokens']}")
    need(same_tokens, "run A's tokens differ from run B's")
    need(bit, f"run A's logits differ from run B's by {delta}")
    need(full >= 2 and pc["hits"] - full >= 7,
         f"expected 7 partial and 2 full prefix hits: {full} full, {pc}")
    need(rep_a["prefilled_tokens"] < rep_b["prefilled_tokens"],
         "the prefix cache saved no prefill")

    phase("gemma run C: run A's scheduler with SLO admission")
    step_ms = session.serving_engine(
        model, **common, slo=SLOConfig()).scheduler_report()["slo"]["step_ms"]
    deadline = cfg["slo_steps"] * step_ms
    print(f"  modeled step {step_ms:.3f} ms (the placement rate model at "
          f"batch {cfg['slots']}); deadline {cfg['slo_steps']} steps = "
          f"{deadline:.3f} ms")
    eng_c = session.serving_engine(
        model, **common, **sched(),
        slo=SLOConfig(default_deadline_ms=deadline))
    comps_c, rep_c, counts_c, wall_c = drive("C", eng_c)
    slo = rep_c["slo"]
    print(f"    slo: {slo['met']} met / {slo['missed']} missed (shed "
          f"{slo['shed_on_admit']} at admission, {slo['shed_admitted']} in "
          f"flight); shed {[c.request_id for c in comps_c if c.shed]}")
    need(slo["shed_on_admit"] >= 1 and slo["met"] >= 1,
         f"the deadline shed nothing at admission or met nothing: {slo}")
    for c, b in zip(comps_c, comps_b):
        need(c.shed or (c.tokens == b.tokens
                        and torch.equal(c.logits, b.logits)),
             f"run C's request {c.request_id} differs from run B's")

    phase("gemma: run A replayed through the plain versions")
    plain = ServingEngine(model, restamp(packed.params, "reference"),
                          session=session, **common, **sched())
    reset_counts(kernels)
    t0 = time.perf_counter()
    comps_p = serve_waves(plain, waves, warm)
    sync()
    t_plain = time.perf_counter() - t0
    need(sum(read_counts(kernels).values()) == 0,
         "the plain replay launched a kernel")
    for p_, a_ in zip(comps_p, comps_a):
        need(p_.tokens == a_.tokens and torch.equal(p_.logits, a_.logits),
             f"request {p_.request_id}: kernels differ from plain versions")
    print(f"  {len(comps_p)} requests: tokens and logits through the "
          f"kernels == plain versions, bit for bit ({t_plain:.2f}s wall)")
    del plain, comps_p

    phase("gemma profile: one chunk step (a 32-row chunk + a batch-4 decode "
          "wave) and one batch-4 decode step")
    g = generator(SEED, "gemma-profile")
    with torch.inference_mode():
        prompt = torch.randint(0, mc.vocab, (1, 2 * cfg["chunk"]),
                               generator=g, dtype=torch.int32).to(dev)
        batch = torch.randint(0, mc.vocab, (cfg["slots"], 2 * cfg["chunk"]),
                              generator=g, dtype=torch.int32).to(dev)
        _, cache4 = model.prefill(packed.params, batch,
                                  max_len=cfg["max_len"])
        _, cache1 = model.prefill(packed.params, prompt,
                                  max_len=cfg["max_len"])
        nxt = batch[:, -1:].contiguous()
        lens = torch.full((cfg["slots"],), 2 * cfg["chunk"],
                          dtype=torch.int32, device=dev)

    def chunk_step():
        model.prefill_chunk(packed.params, prompt[:, cfg["chunk"]:], cache1,
                            cfg["chunk"], kv_len=2 * cfg["chunk"])
        model.decode_step(packed.params, cache4, nxt, lens)

    def decode_step():
        model.decode_step(packed.params, cache4, nxt, lens)

    prof = {"chunk step": profile_calls(torch, "chunk step", chunk_step,
                                        sync),
            "decode step": profile_calls(torch, "decode step", decode_step,
                                         sync)}
    del cache4, cache1
    launches = {k: counts_a[k] + counts_b[k] + counts_c[k]
                for k in counts_a}
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    wall = time.perf_counter() - t_phase
    print(f"  gemma phase: {wall:.1f}s wall; runs A / B / C "
          f"{wall_a:.2f} / {wall_b:.2f} / {wall_c:.2f}s; peak device memory "
          + (f"{peak:.2f} GiB" if peak is not None else "not measured"))
    out = dict(
        packed=packed, launches=launches,
        calib_launches=calib_launches, mean_ecr=st.mean_ecr,
        calib_wall_s=st.wall_s, occupancy=rep["occupancy"],
        prefix_cache=pc, slo=slo,
        hits=(full, pc["hits"] - full),
        prefilled=(rep_a["prefilled_tokens"], rep_b["prefilled_tokens"]),
        walls=dict(A=wall_a, B=wall_b, C=wall_c, plain=t_plain,
                   phase=wall), profile=prof, peak_gib=peak)
    cache.cleanup()
    return out


def deepseek_phase(torch, dev, cfg: dict, kernels, sync) -> dict:
    """deepseek-v2-lite-16b (MLA + MoE; ``DEEPSEEK``) at full width and
    depth, random weights from the seed, on the main path: a cache-miss
    calibration, placement, 4-bit placed FFN (layer 0's dense FFN and the
    26 shared experts; the routed banks stay bf16) and unembed packs.

    Checks, each kernels vs plain versions bit for bit where named: the
    whole-model prefill logits; lockstep greedy decode; the engine's
    tokens equal to lockstep's; a ragged engine run (kernels == plain);
    with MLA's wq / wo packed too, a prefill and ``attn_steps`` decode
    steps (kernels == plain).  Prints placed columns, occupancy, walls,
    peak device memory, a batch-4 decode step's host wall and device time
    by kernel, the engine's decode rate and slot occupancy.  Returns the
    packs for the kernel rows and the phase's launches."""
    from repro_torch.configs import get
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.rng import generator
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.params import init_params, param_count
    from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,
                                      PUDGemvConfig)
    from repro_torch.runtime.engine import Request, ServingEngine
    from repro_torch.runtime.session import PUDSession
    on_card = dev.type == "cuda"
    full = cfg["preset"] == "full"
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spec = get(cfg["arch"])
    model = spec.make_model() if full else spec.make_smoke()
    mc = model.cfg
    phase(f"{cfg['arch']} ({cfg['preset']}): calibrate -> place -> pack on "
          f"a {cfg['grid']['n_subarrays']} x {cfg['grid']['n_cols']:,} grid")
    sync()
    t0 = time.perf_counter()
    params = init_params(model.param_defs(), SEED, dev)
    sync()
    n_params = param_count(model.param_defs())
    print(f"  {n_params:,} parameters ({mc.n_layers} layers: "
          f"{mc.groups()}, d {mc.d_model}, MLA rank {mc.mla_kv_rank}, "
          f"{mc.n_experts} routed experts (d_ff {mc.moe_d_ff}) top-"
          f"{mc.top_k} + {mc.n_shared_experts} shared, dense d_ff "
          f"{mc.d_ff}, vocab {mc.vocab}); init "
          f"{time.perf_counter() - t0:.2f}s")
    cache = tempfile.TemporaryDirectory(prefix="pud-deepseek-")

    def open_session():
        return PUDSession.open(
            cfg["arch"], grid=FleetConfig(**cfg["grid"]),
            cache_dir=cache.name,
            calib=CalibrationConfig(n_iterations=12, n_samples=256),
            seed=SEED + 2, device=dev)

    def pack(sess, packable, label):
        sync()
        t0 = time.perf_counter()
        pm = sess.pack(params, PUDGemvConfig(weight_bits=4,
                                             packable=packable),
                       name=f"{cfg['arch']}-{cfg['preset']}-{label}")
        sync()
        wall = time.perf_counter() - t0
        need(sess.placement_status == "planned" and pm.placed,
             f"placement {sess.placement_status}: {sess.placement_error}")
        rep = sess.placement.capacity_report()
        print(f"  {label} packs: {len(pm.packed_names)} placed, "
              f"{len(pm.skipped_names)} routed banks left bf16; "
              f"{rep['used_cols']:,} / {rep['usable_cols']:,} error-free "
              f"columns used (occupancy {rep['occupancy']:.4f}, "
              f"{rep['occupied_subarrays']} / {rep['n_subarrays']} "
              f"subarrays); pack {wall:.2f}s")
        return pm, rep, wall

    session = open_session()
    reset_counts(kernels)
    st = session.calibrate()
    sync()
    calib_launches = kernels["calib_iter"].launches
    need(not st.cache_hit, "a fresh cache reported a hit")
    need(calib_launches > 0 or not on_card,
         "calibration never launched calib_iter")
    print(f"  calibration MISS in {st.wall_s:.3f}s: "
          f"{session.fleet_cfg.n_subarrays_total} subarrays, mean ECR "
          f"{st.mean_ecr:.4f}, {calib_launches} calib_iter launches")
    packed, rep, t_pack = pack(session, FFN_PACKABLE, "ffn")
    need(not full or rep["used_cols"] == cfg["placed_cols"],
         f"{rep['used_cols']} placed columns, expected {cfg['placed_cols']}")
    plain_params = restamp(packed.params, "reference")

    g = generator(SEED, "deepseek-prompts")
    prompts = torch.randint(0, mc.vocab, (cfg["requests"], cfg["prompt"]),
                            generator=g, dtype=torch.int32).to(dev)
    b, gen = cfg["batch"], cfg["gen"]
    max_len = cfg["prompt"] + gen + 1
    launches = {k: 0 for k in kernels}

    def count():
        for k, v in read_counts(kernels).items():
            launches[k] += v
        return read_counts(kernels)

    phase("deepseek: whole-model prefill, kernels vs plain versions")
    reset_counts(kernels)
    with torch.inference_mode():
        got, _ = model.prefill(packed.params, prompts[:b], max_len=max_len)
        want, _ = model.prefill(plain_params, prompts[:b], max_len=max_len)
    sync()
    count()
    need(tuple(got.shape) == (b, mc.vocab)
         and bool(torch.isfinite(got).all()), "bad prefill logits")
    need(torch.equal(got, want),
         "prefill logits through the kernels differ from the plain path")
    print(f"  prefill logits {list(got.shape)}: kernels == plain versions, "
          "bit for bit")

    phase(f"deepseek: lockstep greedy decode, {b} prompts of "
          f"{cfg['prompt']} tokens, {gen} new tokens each")
    reset_counts(kernels)
    sync()
    t0 = time.perf_counter()
    toks, logits = greedy_generate(model, packed.params, prompts[:b], gen,
                                   max_len)
    sync()
    t_lock = time.perf_counter() - t0
    c_lock = count()
    need(c_lock["gemm_placed"] > 0 or not on_card,
         "lockstep never launched gemm_placed")
    need(c_lock["gemm"] == c_lock["gemv"] == 0,
         "the placed path launched an unplaced kernel")
    need(tuple(toks.shape) == (b, gen) and int(toks.min()) >= 0
         and int(toks.max()) < mc.vocab, "bad lockstep tokens")
    need(bool(torch.isfinite(logits).all()), "non-finite lockstep logits")
    print(f"  {b * gen} tokens in {t_lock:.2f}s wall; launches {c_lock}")
    reset_counts(kernels)
    rest = [greedy_generate(model, packed.params, prompts[i:i + b], gen,
                            max_len)[0]
            for i in range(b, cfg["requests"], b)]
    lock_toks = torch.cat([toks] + rest).tolist()
    count()

    phase(f"deepseek: engine, {cfg['requests']} requests on "
          f"{cfg['slots']} slots (whole-prompt prefill)")
    eng = session.serving_engine(model, max_len=max_len,
                                 batch_size=cfg["slots"])
    reqs = [Request(i, prompts[i], gen) for i in range(cfg["requests"])]
    reset_counts(kernels)
    sync()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    sync()
    t_eng = time.perf_counter() - t0
    c_eng = count()
    erep = eng.scheduler_report()
    same = sum(c.tokens == lock_toks[c.request_id] for c in comps)
    print(f"  {erep['generated_tokens']} tokens in {erep['steps']} steps, "
          f"slot occupancy {erep['slot_occupancy']:.4f}, decode "
          f"{erep['wall_tok_s']:.1f} tok/s ({t_eng:.2f}s wall); "
          f"{same} / {len(comps)} requests equal to lockstep; launches "
          f"{c_eng}")
    need(len(comps) == cfg["requests"] and same == len(comps),
         "the engine's tokens differ from lockstep's")
    del eng

    phase("deepseek: ragged engine run, kernels vs plain versions")
    gr = generator(SEED, "deepseek-ragged")
    (p0, p1), (b0, b1) = cfg["ragged"]["prompt"], cfg["ragged"]["budget"]
    n_r = cfg["ragged"]["n"]
    lens = torch.randint(p0, p1 + 1, (n_r,), generator=gr).tolist()
    budgets = torch.randint(b0, b1 + 1, (n_r,), generator=gr).tolist()
    rreqs = [Request(i, torch.randint(0, mc.vocab, (n,), generator=gr,
                                      dtype=torch.int32), m)
             for i, (n, m) in enumerate(zip(lens, budgets))]
    r_len = p1 + b1
    eng_k = session.serving_engine(model, max_len=r_len,
                                   batch_size=cfg["slots"],
                                   collect_logits=True)
    eng_p = ServingEngine(model, plain_params, session=session,
                          max_len=r_len, batch_size=cfg["slots"],
                          collect_logits=True)
    reset_counts(kernels)
    got_r = eng_k.run(rreqs)
    sync()
    count()
    reset_counts(kernels)
    want_r = eng_p.run(rreqs)
    sync()
    need(sum(read_counts(kernels).values()) == 0,
         "the plain replay launched a kernel")
    for g_, w_ in zip(got_r, want_r):
        need(g_.tokens == w_.tokens and torch.equal(g_.logits, w_.logits)
             and (g_.slot, g_.admitted_step) == (w_.slot, w_.admitted_step),
             f"request {g_.request_id}: kernels differ from plain versions")
    rrep = eng_k.scheduler_report()
    need(rrep["prefill_traces"] > 1
         and max(c.admitted_step for c in got_r) > 0,
         "the ragged run did not exercise prefill shapes and mid-run "
         "admission")
    print(f"  {len(got_r)} requests (prompts {lens}, budgets {budgets}), "
          f"{rrep['generated_tokens']} tokens in {rrep['steps']} steps, "
          f"{rrep['prefill_traces']} prefill shapes: tokens and logits "
          "through the kernels == plain versions, bit for bit")
    del eng_k, eng_p, got_r, want_r

    phase(f"profile: one batch-{b} deepseek decode step")
    prof = profile_step(torch, model, packed.params, prompts[:b], max_len,
                        sync)

    phase(f"deepseek --pud-attention: MLA wq / wo packed too; prefill + "
          f"{cfg['attn_steps']} decode steps, kernels vs plain versions")
    session_a = open_session()
    need(session_a.calibrate().cache_hit, "the attention run missed the "
         "table")
    packed_a, rep_a, t_pack_a = pack(session_a,
                                     FFN_PACKABLE + ATTN_PACKABLE, "attn")
    need(not full or rep_a["used_cols"] == cfg["attn_cols"],
         f"{rep_a['used_cols']} placed columns, expected {cfg['attn_cols']}")
    need(any(n.endswith("attn/wq") for n in packed_a.packed_names),
         "MLA wq was not packed")
    plain_a = restamp(packed_a.params, "reference")
    reset_counts(kernels)
    with torch.inference_mode():
        lg_k, cache_k = model.prefill(packed_a.params, prompts[:b],
                                      max_len=max_len)
        lg_p, cache_p = model.prefill(plain_a, prompts[:b], max_len=max_len)
        same_a = [torch.equal(lg_k, lg_p)]
        for i in range(cfg["attn_steps"]):
            nxt = torch.argmax(lg_k, dim=-1).to(torch.int32)[:, None]
            lg_k, cache_k = model.decode_step(packed_a.params, cache_k, nxt,
                                              cfg["prompt"] + i)
            lg_p, cache_p = model.decode_step(plain_a, cache_p, nxt,
                                              cfg["prompt"] + i)
            same_a.append(torch.equal(lg_k, lg_p))
    sync()
    count()
    need(all(same_a), f"attention packs: kernels differ from plain versions "
         f"at steps {[i for i, x in enumerate(same_a) if not x]}")
    print(f"  prefill and {cfg['attn_steps']} decode steps: logits through "
          "the kernels == plain versions, bit for bit")
    del cache_k, cache_p, plain_a, plain_params, params

    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    wall = time.perf_counter() - t_phase
    print(f"  deepseek phase: {wall:.1f}s wall; calibration "
          f"{st.wall_s:.3f}s, packs {t_pack:.2f} / {t_pack_a:.2f}s; peak "
          "device memory "
          + (f"{peak:.2f} GiB" if peak is not None else "not measured")
          + f"; launches {launches}")
    out = dict(packed=packed, packed_attn=packed_a, launches=launches,
               calib_launches=calib_launches, n_params=n_params,
               mean_ecr=st.mean_ecr, calib_wall_s=st.wall_s,
               placed_cols=rep["used_cols"], occupancy=rep["occupancy"],
               attn_cols=rep_a["used_cols"],
               attn_occupancy=rep_a["occupancy"],
               walls=dict(pack=t_pack, pack_attn=t_pack_a, lockstep=t_lock,
                          engine=t_eng, phase=wall),
               engine=dict(tok_s=erep["wall_tok_s"],
                           occupancy=erep["slot_occupancy"],
                           steps=erep["steps"]),
               profile=prof, peak_gib=peak)
    cache.cleanup()
    return out


def strip_plans(tree):
    """The packed tree with every pack's tuned plans dropped (the
    heuristic launch plans)."""
    from repro_torch.pud.packed import PackedTensor
    if isinstance(tree, dict):
        return {k: strip_plans(v) for k, v in tree.items()}
    if isinstance(tree, PackedTensor):
        return tree.replace(tile_plan=None)
    return tree


def stamp_first_candidates(session, batches) -> None:
    """The CPU rehearsal's stand-in for ``PUDSession.tune``, which needs the
    card: each pack is stamped, untimed, with its first non-heuristic valid
    candidate per row class."""
    from repro_torch.kernels.autotune import (candidate_plans, row_class,
                                              valid_candidates)
    stamped = {}
    for name, pt in session.packed.tensors.items():
        planes = pt.planes[0] if pt.planes.dim() == 4 else pt.planes
        plans = {}
        for b in batches:
            entry = "gemm" if b > 1 else "gemv"
            cands = valid_candidates(
                candidate_plans(entry, b, pt.k, pt.n, layout=pt.layout,
                                placed_window=(planes.shape[-1] if pt.placed
                                               else None),
                                pack_window_block=pt.window_block,
                                wb=pt.n_bits),
                entry, (b, pt.k), tuple(planes.shape), layout=pt.layout,
                logical_k=pt.logical_k, col_ids=pt.n if pt.placed else None,
                window_block=pt.window_block)
            plans[row_class(b)] = cands[1]
        stamped[name] = pt.replace(tile_plan=tuple(sorted(plans.items())))
    session._restamp_packs(stamped)


def layer0_copy(pt):
    """Layer 0 of a stacked pack as tensors of its own (a view would keep
    every layer alive)."""
    pt = pt.layer(0) if pt.planes.dim() == 4 else pt
    return pt.replace(planes=pt.planes.clone(), scale=pt.scale.clone(),
                      col_ids=None if pt.col_ids is None
                      else pt.col_ids.clone())


def hold_winner(torch, pt, batch: int, plan, sync) -> None:
    """A tuned plan's output on the card against the plain version, on the
    probe the tuner timed (layer 0 of ``pt``)."""
    from repro_torch.kernels import placed_gemm, plane_gemm
    pt = pt.layer(0) if pt.planes.dim() == 4 else pt
    dev = pt.planes.device
    x = ((torch.arange(batch * pt.k, device=dev) % 255) - 127).to(
        torch.int8).reshape(batch, pt.k)
    kw = dict(layout=pt.layout, logical_k=pt.logical_k)
    tp = None if plan.is_default() else plan
    if pt.placed:
        fn = placed_gemm.gemv_placed if batch == 1 else \
            placed_gemm.gemm_placed
        got = fn(x, pt.planes, pt.col_ids, window_block=pt.window_block,
                 tile_plan=tp, **kw)
        want = placed_gemm.placed_plain(x, pt.planes, pt.col_ids,
                                        window_block=pt.window_block, **kw)
    else:
        fn = plane_gemm.gemv if batch == 1 else plane_gemm.gemm
        got = fn(x, pt.planes, tile_plan=tp, **kw)
        want = plane_gemm.plane_plain(x, pt.planes, **kw)
    sync()
    need(torch.equal(got, want), f"the tuned plan {plan.to_dict()} of "
         f"{pt.n_bits}-bit {tuple(pt.planes.shape)} at B={batch} differs "
         "from the plain version")


def single_split(torch, dev, packed, sync) -> dict:
    """At the decode shapes x [BATCH] x wi / wo (layer 0): the heuristic
    plan beside the same plan with one K split (no zeroed output, no
    atomics), each held to the plain version and timed as the kernel rows
    are."""
    from repro_torch.kernels import placed_gemm
    from repro_torch.kernels.autotune import TunedPlan
    flush = torch.empty((256 if dev.type == "cuda" else 1) * 2**20,
                        dtype=torch.uint8, device=dev)
    out = {}
    for name in ("wi", "wo"):
        pt = packed.tensor(f"layers_0_dense/mixer/{name}").layer(0)
        x = ((torch.arange(BATCH * pt.k, device=dev) % 255) - 127).to(
            torch.int8).reshape(BATCH, pt.k)
        kw = dict(layout=pt.layout, logical_k=pt.logical_k,
                  window_block=pt.window_block)
        want = placed_gemm.placed_plain(x, pt.planes, pt.col_ids, **kw)
        times = {}
        for label, plan in (("heuristic", None),
                            ("one split", TunedPlan(n_split=1))):
            got = placed_gemm.gemm_placed(x, pt.planes, pt.col_ids,
                                          tile_plan=plan, **kw)
            sync()
            need(torch.equal(got, want), f"{name} ({label}) differs from "
                 "the plain version")
            times[label] = time_ms(torch, lambda p=plan: placed_gemm.
                                   gemm_placed(x, pt.planes, pt.col_ids,
                                               tile_plan=p, **kw), flush)
        h = placed_plan(pt, BATCH)
        print(f"  x [{BATCH}, {pt.k}] x {name}: heuristic "
              f"{times['heuristic']:.4f} ms ({h.split(', grid')[0]}, K split "
              f"{h.split('K split ')[1].split(' x')[0]}), one split "
              f"{times['one split']:.4f} ms (no zeroed output, no atomics)")
        out[name] = times
    return out


def plan_path_cost(torch, dev, packed, calls: int) -> float:
    """Host microseconds a stamped plan adds to one packed call (the
    contract check in ``ops.pud_matmul`` and the wrapper's plan lookup,
    both cached after the first call), timed over 2,000 calls at x
    [BATCH] x wi (layer 0) with one K split; printed against ``calls``
    packed calls per decode step."""
    from repro_torch import devices
    from repro_torch.analysis.contracts import check_kernel_args
    from repro_torch.kernels import placed_gemm
    from repro_torch.kernels.autotune import TunedPlan
    pt = packed.tensor("layers_0_dense/mixer/wi").layer(0)
    x = torch.zeros((BATCH, pt.k), dtype=torch.int8, device=dev)
    plan = TunedPlan(n_split=1)
    sms = devices.sm_count(dev) if dev.type == "cuda" else placed_gemm.SMS

    def path():
        check_kernel_args("gemm", x.shape, pt.planes.shape, layout=pt.layout,
                          logical_k=pt.logical_k, col_ids=pt.n,
                          window_block=pt.window_block, tuned=plan, sms=sms)
        placed_gemm._plan_of("gemm_placed", x, pt.planes, pt.col_ids,
                             pt.layout, pt.logical_k, pt.window_block, plan)

    for _ in range(100):
        path()
    t0 = time.perf_counter()
    for _ in range(2000):
        path()
    us = (time.perf_counter() - t0) / 2000 * 1e6
    print(f"  stamped-plan host path: {us:.1f} us per packed call (the "
          f"contract check and the plan lookup), {us * calls / 1e3:.2f} ms "
          f"over a decode step's {calls} packed calls")
    return us


def tuning_phase(torch, dev, preset: str, grid: dict, cache_dir: str,
                 batches, kernels, sync) -> dict:
    """qwen3-1.7b at ``preset`` with attention packs through ``serve
    --pud-gemv --pud-attention --tune`` on the main run's cache (tuned at
    batch 1 and ``BATCH``), then ``PUDSession.tune(batches)``: every key's
    heuristic and tuned times, plan and candidates; each winner held to the
    plain version; the whole model's prefill through the tuned kernels
    equal to the plain versions; a reopened session on the same cache hits
    every key; tuned and untuned decode at batch 4 bit-identical, one step
    of each profiled; a pack archive keeps the plans.  On a CPU rehearsal
    the tuner (which needs the card) is replaced by untimed stamps and its
    refusal is checked."""
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.launch import serve
    from repro_torch.pud.gemv import ATTN_PACKABLE, FFN_PACKABLE
    from repro_torch.pud.gemv import PUDGemvConfig
    from repro_torch.pud.packed import load_packed_npz, save_packed_npz
    from repro_torch.runtime.session import PUDSession
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    phase(f"tuning: serve --pud-attention{' --tune' if on_card else ''}, "
          f"then PUDSession.tune(batches={tuple(batches)})")
    argv = ["--arch", ARCH, "--preset", preset, "--pud-gemv",
            "--pud-attention", "--calib-cache", cache_dir,
            "--fleet-subarrays", str(grid["n_subarrays"]),
            "--fleet-cols", str(grid["n_cols"]), "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--seed", str(SEED), "--device", str(dev)]
    reset_counts(kernels)
    res = serve.run(serve.parse_args(argv + (["--tune"] if on_card else [])))
    session, model = res["session"], res["model"]
    need(session.calibration.cache_hit, "the tuning run missed the table")
    need(session.placement_status in ("planned", "hit"),
         f"attention packs not placed: {session.placement_error}")
    rep = session.placement.capacity_report()
    print(f"  placed columns with attention packs: {rep['used_cols']:,} of "
          f"{rep['usable_cols']:,} error-free (occupancy "
          f"{rep['occupancy']:.4f}), {len(session.packed.tensors)} packs")
    if on_card:
        t0 = time.perf_counter()
        trep = session.tune(batches=batches)
        sync()
        t_tune = time.perf_counter() - t0
    else:
        try:
            session.tune(batches=batches)
        except RuntimeError as e:
            print(f"  PUDSession.tune on the CPU raises: {e}")
        else:
            need(False, "PUDSession.tune ran on the CPU")
        stamp_first_candidates(session, batches)
        trep, t_tune = {"keys": {}}, 0.0
    packed = session.packed
    rows = []
    for key, row in sorted(trep["keys"].items()):
        pt = packed.tensor(row["name"])
        plan = pt.tile_plan and dict(pt.tile_plan)[row["row_class"]]
        need(plan is not None and plan.to_dict() == row["plan"],
             f"{key}: the stamped plan is not the report's")
        hold_winner(torch, pt, row["batch"], plan, sync)
        rows.append(dict(key=key, status=row["status"],
                         heuristic_ms=1e3 * row["heuristic_s"],
                         tuned_ms=1e3 * row["tuned_s"],
                         speedup=row["speedup"], plan=row["plan"],
                         candidates=row["n_candidates"]))
        print(f"  {row['status']:<5s} {key}: heuristic "
              f"{rows[-1]['heuristic_ms']:.4f} ms, tuned "
              f"{rows[-1]['tuned_ms']:.4f} ms ({row['speedup']:.3f}x), "
              f"{row['n_candidates']} candidates, plan "
              f"{row['plan'] or 'heuristic'}")
    if rows:
        print(f"  {len(rows)} keys in {t_tune:.2f}s; every winner == the "
              "plain version on the card")
    splits = single_split(torch, dev, packed, sync)
    with torch.inference_mode():
        got, _ = model.prefill(packed.params, res["tokens"],
                               max_len=res["max_len"])
        want, _ = model.prefill(restamp(packed.params, "reference"),
                                res["tokens"], max_len=res["max_len"])
    need(torch.equal(got, want), "prefill logits with attention packs "
         "through the tuned kernels differ from the plain versions")
    print(f"  prefill logits {list(got.shape)} with attention packs: tuned "
          "kernels == plain versions, bit for bit")

    phase("tuning: reopen on the same cache (every key a hit)")
    cfg = PUDGemvConfig(weight_bits=4,
                        packable=FFN_PACKABLE + ATTN_PACKABLE)
    again = PUDSession.open(
        ARCH, grid=FleetConfig(**grid), cache_dir=cache_dir,
        calib=CalibrationConfig(n_iterations=12, n_samples=256),
        seed=SEED + 2, device=dev)
    again.calibrate()
    again.pack(res["params"], cfg, name=f"{ARCH}-{preset}")
    if on_card:
        t0 = time.perf_counter()
        hits = again.tune(batches=batches)["keys"]
        t_hit = time.perf_counter() - t0
        statuses = sorted({r["status"] for r in hits.values()})
        need(statuses == ["hit"] and set(hits) == set(trep["keys"]),
             f"reopened tuning: {statuses}")
        print(f"  {len(hits)} keys, every one a hit, in {t_hit:.3f}s")
    del again

    phase(f"tuning: decode at batch {BATCH}, tuned vs untuned packs")
    toks = res["tokens"][:BATCH]
    before = read_counts(kernels)
    tuned = serve.greedy_generate(model, packed.params, toks, GEN,
                                  res["max_len"])
    untuned = serve.greedy_generate(model, strip_plans(packed.params), toks,
                                    GEN, res["max_len"])
    sync()
    need(torch.equal(tuned[0], untuned[0])
         and torch.equal(tuned[1], untuned[1]),
         "tuned and untuned decode differ")
    print("  tokens and logits bit-identical; launches "
          f"{ {k: v - before[k] for k, v in read_counts(kernels).items()} }")
    prof = {"tuned": [], "untuned": []}
    trees = {"tuned": packed.params, "untuned": strip_plans(packed.params)}
    for label in ("untuned", "tuned", "tuned", "untuned"):   # in turns
        phase(f"profile: one batch-{BATCH} decode step, {label} packs")
        prof[label].append(profile_step(torch, model, trees[label], toks,
                                        res["max_len"], sync))
    host_us = plan_path_cost(torch, dev, packed,
                             7 * model.cfg.n_layers + 1)

    phase("tuning: the pack archive keeps the plans")
    with tempfile.TemporaryDirectory(prefix="pud-tuned-") as d:
        path = pathlib.Path(d) / "tuned.npz"
        save_packed_npz(path, packed)
        loaded = load_packed_npz(path, device=dev)
    need(loaded is not None and all(
        loaded[n].tile_plan == pt.tile_plan and pt.tile_plan is not None
        for n, pt in packed.tensors.items()),
        "the archive's plans differ from the packs'")
    print(f"  {len(loaded)} packs saved and loaded: plans equal")
    wq = layer0_copy(packed.tensor("layers_0_dense/attn/wq"))
    counts = read_counts(kernels)
    wall = time.perf_counter() - t_phase
    print(f"  tuning phase: {wall:.1f}s wall; launches {counts}")
    del res, session, packed, loaded
    return dict(rows=rows, occupancy=rep["occupancy"],
                used_cols=rep["used_cols"], usable_cols=rep["usable_cols"],
                tune_s=t_tune, profile=prof, launches=counts, wq=wq,
                wall_s=wall, single_split=splits, plan_path_us=host_us)


def weight_bits_phase(torch, dev, preset: str, grid: dict, cache_dir: str,
                      bits: int, kernels, sync) -> dict:
    """``serve --weight-bits`` (placed FFN and unembed packs) on the main
    run's cache: prefill logits and greedy decode through the kernels equal
    to the plain versions on the new shapes."""
    from repro_torch.launch import serve
    phase(f"weight bits: serve --weight-bits {bits} (placed, FFN packs)")
    t0 = time.perf_counter()
    argv = ["--arch", ARCH, "--preset", preset, "--pud-gemv",
            "--weight-bits", str(bits), "--calib-cache", cache_dir,
            "--fleet-subarrays", str(grid["n_subarrays"]),
            "--fleet-cols", str(grid["n_cols"]), "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--seed", str(SEED), "--device", str(dev)]
    reset_counts(kernels)
    res = serve.run(serve.parse_args(argv))
    packed, model = res["packed"], res["model"]
    need(packed.weight_bits == bits and packed.placed,
         f"packed {packed.weight_bits}-bit, placed {packed.placed}")
    need(all(pt.n_bits == bits for pt in packed.tensors.values()),
         "a pack has another plane count")
    plain = restamp(packed.params, "reference")
    with torch.inference_mode():
        got, _ = model.prefill(packed.params, res["tokens"],
                               max_len=res["max_len"])
        want, _ = model.prefill(plain, res["tokens"],
                                max_len=res["max_len"])
    toks = res["tokens"][:BATCH]
    dec = serve.greedy_generate(model, packed.params, toks, ARCHIVE_STEPS,
                                res["max_len"])
    dec_plain = serve.greedy_generate(model, plain, toks, ARCHIVE_STEPS,
                                      res["max_len"])
    sync()
    need(torch.equal(got, want), f"{bits}-bit prefill logits through the "
         "kernels differ from the plain versions")
    need(torch.equal(dec[0], dec_plain[0]) and torch.equal(dec[1],
                                                           dec_plain[1]),
         f"{bits}-bit decode through the kernels differs from the plain "
         "versions")
    counts = read_counts(kernels)
    wall = time.perf_counter() - t0
    print(f"  {len(packed.tensors)} packs of {bits} planes: prefill logits "
          f"and batch-{BATCH} decode x {ARCHIVE_STEPS} == plain versions, "
          f"bit for bit; token agreement vs bf16 {res['agreement']:.4f}; "
          f"launches {counts}; {wall:.1f}s wall")
    out = dict(launches=counts, wall_s=wall,
               wi=layer0_copy(packed.tensor("layers_0_dense/mixer/wi")),
               agreement=res["agreement"])
    del res, packed, plain
    return out


def contracts_phase(dev) -> dict:
    """``python -m repro_torch.analysis --sms <the card's>``: the contract
    gate must exit 0."""
    from repro_torch import devices
    from repro_torch.kernels.placed_gemm import SMS
    sms = devices.sm_count(dev) if dev.type == "cuda" else SMS
    phase(f"contracts: python -m repro_torch.analysis --sms {sms}")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--sms", str(sms)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    for line in (r.stdout + r.stderr).strip().splitlines():
        print(f"  {line}")
    need(r.returncode == 0, f"the contract gate exited {r.returncode}")
    wall = time.perf_counter() - t0
    print(f"  exit 0 in {wall:.1f}s (a new process)")
    return dict(sms=sms, wall_s=wall)


def benchmarks_phase(torch, dev, kernels, sync) -> dict:
    """``benchmarks.run --only`` for each of ``BENCHMARKS`` (the modules
    mvdram_serving, serving_engine, kernel_bench and kernel_microbench):
    each exits 0, and kernel_bench and kernel_microbench hold every result
    to the plain versions (they raise otherwise)."""
    from repro_torch.benchmarks import run as bench_run
    out = {}
    for name in BENCHMARKS:
        phase(f"benchmarks.run --only {name}")
        argv = ["--only", name] + ([] if dev.type == "cuda"
                                   else ["--device", str(dev)])
        reset_counts(kernels)
        t0 = time.perf_counter()
        rc = bench_run.main(argv)
        sync()
        out[name] = dict(rc=rc, wall_s=time.perf_counter() - t0,
                         launches=read_counts(kernels))
        print(f"  {name}: exit {rc} in {out[name]['wall_s']:.1f}s, "
              f"launches {out[name]['launches']}")
        need(rc == 0, f"benchmarks.run --only {name} exited {rc}")
    return out


#: The kernel rows of the ``kernels`` line, in its order: (source, the TPU
#: kernel it replaces)
KERNEL_ROWS = {
    "calib_iter": ("src/repro_torch/csrc/calib_iter.cu",
                   "src/repro/kernels/majx.py:157"),
    "gemm_placed": ("src/repro_torch/csrc/placed_gemm.cu",
                    "src/repro/kernels/bitplane_gemm.py:166"),
    "gemv_placed": ("src/repro_torch/csrc/placed_gemm.cu",
                    "src/repro/kernels/bitplane_gemv.py:377"),
    "gemm": ("src/repro_torch/csrc/plane_gemm.cu",
             "src/repro/kernels/bitplane_gemm.py:105"),
    "gemv": ("src/repro_torch/csrc/plane_gemm.cu",
             "src/repro/kernels/bitplane_gemv.py:316"),
    "majx_sense": ("src/repro_torch/csrc/simra_sense.cu",
                   "src/repro/kernels/majx.py:197"),
}

#: The groups of phases ``run`` drives, in order.  Each group shares no
#: state with another: it adds its launches and its timed shapes to the
#: kernel rows, and ``run(only=...)`` drives a subset (the CPU rehearsal
#: runs one group per test file).
GROUPS = ("main", "papers", "gemma", "deepseek", "fleet", "families",
          "train", "mesh", "dryrun")


class Rows:
    """The kernel rows as the groups fill them: launches per kernel (each
    group's main-path runs) and every timed shape, in group order."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNEL_ROWS, 0)
        self.shapes = {name: [] for name in KERNEL_ROWS}

    def add(self, name: str, launches: int = 0, shapes=()) -> None:
        self.launches[name] += launches
        self.shapes[name].extend(shapes)

    def assemble(self) -> list:
        """One row per kernel that has a shape: its first shape as the
        head, the rest as ``extra_shapes`` with the dense-layout shapes
        last; launches summed over the groups."""
        rows = []
        for name, (source, replaces) in KERNEL_ROWS.items():
            shapes = sorted(self.shapes[name],
                            key=lambda r: r.get("layout") == "dense")
            if not shapes:
                continue
            head, *extras = shapes
            rows.append({**head, "name": name, "route": "cuda",
                         "source": source, "replaces": replaces,
                         "launches": self.launches[name],
                         "extra_shapes": extras})
        return rows


def row_context(torch, dev, kernels, sync):
    """What every group's kernel rows share: the card, the L2 flush buffer,
    the seeded input streams and the row builders (``calib_row``,
    ``sense_row``, ``gemm_row``: each checks the kernel against its plain
    version on the same inputs, then times both)."""
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig, ladder_tables
    from repro_torch.core.rng import generator
    from repro_torch.kernels import calib_iter, sense
    from repro_torch.pud.physics import PhysicsParams

    on_card = dev.type == "cuda"
    p = PhysicsParams()
    ccfg = CalibrationConfig(n_iterations=12, n_samples=256)
    ladder = FleetConfig().ladder(p)
    qsum, swing = ladder_tables(ladder, p)
    flush = torch.empty((256 if on_card else 1) * 2**20, dtype=torch.uint8,
                        device=dev)
    gen = generator(SEED, "chip-smoke", device=dev)
    gen_x = generator(SEED, "chip-smoke-x", device=dev)

    def calib_row(g, s, m, c):
        bits = torch.randint(0, 2, (g, s, m, c), generator=gen, device=dev,
                             dtype=torch.uint8)
        noise = torch.randn((g, s, c), generator=gen, device=dev)
        levels = torch.randint(0, ladder.n_levels, (g, c), generator=gen,
                               device=dev, dtype=torch.int32)
        offs = 0.033 * torch.randn((g, c), generator=gen, device=dev)
        cargs = (p, ladder.n_fracs, qsum, swing, ccfg.threshold, m)
        k_l, k_b = calib_iter.calib_iter(bits, noise, levels, offs, *cargs)
        p_l, p_b = calib_iter.calib_iter_plain(bits, noise, levels, offs,
                                               *cargs)
        sync()
        need(torch.equal(k_l, p_l) and torch.equal(k_b, p_b),
             f"calib_iter differs from its plain version at [{g},{s},{m},"
             f"{c}]")
        need(bool((k_l != levels).any()), "calib_iter moved no level")
        plan = calib_iter.plan_launch(g, m, c, True)
        nbytes = g * (s * m * c + s * c * 4 + 4 * c * 4)
        nops = g * s * c * (m + 10)
        return dict(
            shape=f"inputs [{g},{s},{m},{c}] u8, noise [{g},{s},{c}]",
            plan=(f"{'vector' if plan.vec else 'byte'} path, "
                  f"{plan.threads} threads x {calib_iter.COLS} columns, "
                  f"{plan.blocks} blocks, {plan.smem_bytes} B shared"),
            max_abs_err=float((k_b - p_b).abs().max()),
            ms=time_ms(torch, lambda: calib_iter.calib_iter(
                bits, noise, levels, offs, *cargs), flush),
            plain_ms=time_ms(torch, lambda: calib_iter.calib_iter_plain(
                bits, noise, levels, offs, *cargs), flush, reps=10),
            bytes=nbytes, ops=nops,
            bound_by_bytes_ms=nbytes / HBM_BYTES_S * 1e3,
            bound_by_ops_ms=nops / F32_OPS_S * 1e3, library_ms=None)

    def sense_row(t, r, c, n_fracs):
        charge = torch.rand((t, r, c), generator=gen_x, device=dev)
        offs = 0.033 * torch.randn(c, generator=gen_x, device=dev)
        noise = torch.randn((t, c), generator=gen_x, device=dev)
        args = (charge, offs, noise, p, n_fracs)
        got = sense.majx_sense(*args)
        want = sense.majx_sense_plain(*args)
        sync()
        need(torch.equal(got, want), f"majx_sense differs from its plain "
             f"version at charge [{t}, {r}, {c}], n_fracs {n_fracs}")
        need(0 < float(want.mean()) < 1, "majx_sense sensed one value")
        nbytes = (t * r * c + 2 * t * c + c) * 4
        nops = t * c * (5 * r + 9)
        plan = sense.plan_launch(t, c)
        return dict(
            shape=f"charge [{t},{r},{c}], n_fracs {n_fracs}",
            plan=f"{plan.threads} threads, grid {plan.grid}",
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(torch, lambda: sense.majx_sense(*args), flush),
            plain_ms=time_ms(torch, lambda: sense.majx_sense_plain(*args),
                             flush, reps=10),
            bytes=nbytes, ops=nops,
            bound_by_bytes_ms=nbytes / HBM_BYTES_S * 1e3,
            bound_by_ops_ms=nops / F32_OPS_S * 1e3, library_ms=None)

    def gemm_row(fn, plain, pt, b):
        x = torch.randint(-127, 128, (b, pt.k), generator=gen_x,
                          device=pt.planes.device, dtype=torch.int8)
        kw = dict(layout=pt.layout, logical_k=pt.logical_k)
        operands = (pt.planes,)
        if pt.col_ids is not None:
            operands += (pt.col_ids,)
            kw["window_block"] = pt.window_block
        want = plain(x, *operands, "folded", **kw)
        for mode in ("folded", "planes"):
            got = fn(x, *operands, mode, **kw)
            sync()
            need(torch.equal(got, want), f"{fn.__name__} ({mode}) differs "
                 f"from its plain version at x {tuple(x.shape)}")
        wb, kw_words, _ = pt.planes.shape
        n = pt.n
        nbytes = (b * pt.k + wb * kw_words * n + b * n * 4
                  + (n * 4 if pt.col_ids is not None else 0))
        nops = 2 * b * n * pt.k
        lib_ms = None
        if on_card:
            w8 = library_weights(pt)
            if n % 8:      # torch._int_mm takes N in multiples of 8
                w8 = torch.nn.functional.pad(w8, (0, -n % 8))
            xl = x
            if b < LIB_ROWS:
                xl = torch.zeros((LIB_ROWS, pt.k), dtype=torch.int8,
                                 device=x.device)
                xl[:b] = x
            need(torch.equal(torch._int_mm(xl, w8)[:b, :n], want),
                 "library yardstick disagrees")
            lib_ms = time_ms(torch, lambda: torch._int_mm(xl, w8), flush)
            del w8
        plan = (placed_plan if pt.col_ids is not None else unplaced_plan)(
            pt, b)
        return dict(
            shape=f"x [{b},{pt.k}] x {pt.layout} {list(pt.planes.shape)}, "
                  f"N {n}", layout=pt.layout, plan=plan,
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(torch, lambda: fn(x, *operands, "folded", **kw),
                       flush),
            plain_ms=time_ms(torch, lambda: plain(x, *operands, "folded",
                                                  **kw), flush, reps=10),
            bytes=nbytes, ops=nops,
            bound_by_bytes_ms=nbytes / HBM_BYTES_S * 1e3,
            bound_by_ops_ms=nops / INT8_OPS_S * 1e3, library_ms=lib_ms)

    return types.SimpleNamespace(
        torch=torch, dev=dev, on_card=on_card, sync=sync, kernels=kernels,
        p=p, ccfg=ccfg, flush=flush, calib_row=calib_row,
        sense_row=sense_row, gemm_row=gemm_row)


def layer0(pm, name):
    """Layer 0 of a dense-layer FFN pack of ``pm``."""
    return pm.tensor(f"layers_0_dense/mixer/{name}").layer(0)


def main_group(ctx, rows: Rows, preset: str, grid: dict, recal,
               monitor: dict, tune_batches, weight_bits: int) -> dict:
    """qwen3-1.7b through the serving entry points: the placed main path,
    its checks and profiles, the reopen, partial recalibration, fault
    injection, the unplaced engine path, the ragged engine run, the pack
    archive, monitored serving, tuning and ``--weight-bits``; then the
    kernel rows at its shapes."""
    from repro_torch.core.fleet import (FleetConfig, calibrate_fleet,
                                        manufacture_fleet)
    from repro_torch.kernels import placed_gemm, plane_gemm
    from repro_torch.launch import serve
    from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
    from repro_torch.pud.packed import to_dense
    from repro_torch.runtime.engine import ServingEngine
    from repro_torch.runtime.session import PUDSession

    torch, dev, on_card = ctx.torch, ctx.dev, ctx.on_card
    kernels, sync = ctx.kernels, ctx.sync

    phase("main path: calibrate -> place -> pack -> placed decode")
    cache = tempfile.TemporaryDirectory(prefix="pud-cache-")
    argv = ["--arch", ARCH, "--preset", preset, "--pud-gemv",
            "--calib-cache", cache.name,
            "--fleet-subarrays", str(grid["n_subarrays"]),
            "--fleet-cols", str(grid["n_cols"]), "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--seed", str(SEED), "--device", str(dev)]
    reset_counts(kernels)
    res = serve.run(serve.parse_args(argv))
    sync()
    counts = read_counts(kernels)
    session, packed = res["session"], res["packed"]
    print(f"  launches: {counts}")
    need(counts["calib_iter"] > 0 or not on_card,
         "calibration never launched calib_iter")
    need(not session.calibration.cache_hit, "fresh cache reported a hit")
    need(session.placement_status == "planned",
         f"placement {session.placement_status}: {session.placement_error}")
    need(counts["gemm_placed"] > 0 or not on_card,
         "decode never launched gemm_placed")
    need(counts["gemm"] == counts["gemv"] == 0,
         "the placed path launched an unplaced kernel")
    logits, toks = res["logits"], res["toks"]
    vocab = res["model"].cfg.vocab
    need(tuple(logits.shape) == (BATCH, GEN + 1, vocab)
         and bool(torch.isfinite(logits).all()), "bad packed logits")
    need(int(toks.min()) >= 0 and int(toks.max()) < vocab, "bad tokens")
    occupancy = session.placement.occupancy
    mean_ecr = session.calibration.mean_ecr
    print(f"  mean ECR {mean_ecr:.4f}, occupancy {occupancy:.4f}, "
          f"token agreement vs bf16 {res['agreement']:.4f}")

    phase("main path: one batch-1 request (placed GEMV decode)")
    reset_counts(kernels)
    one, _ = serve.greedy_generate(res["model"], packed.params,
                                   res["tokens"][:1], GEN, res["max_len"])
    sync()
    counts1 = read_counts(kernels)
    print(f"  launches: {counts1}")
    need(counts1["gemv_placed"] > 0 or not on_card,
         "B=1 decode never launched gemv_placed")
    need(tuple(one.shape) == (1, GEN), "bad batch-1 tokens")
    launches = {k: counts[k] + counts1[k] for k in counts}

    for rows_, was in ((BATCH, 5.6), (1, 3.3)):
        phase(f"profile: one batch-{rows_} placed decode step")
        profile_step(torch, res["model"], packed.params,
                     res["tokens"][:rows_], res["max_len"], sync, was)

    phase("whole-model check: kernels vs plain versions on the card")
    with torch.inference_mode():
        model = res["model"]
        got, _ = model.prefill(packed.params, res["tokens"],
                               max_len=res["max_len"])
        want, _ = model.prefill(restamp(packed.params, "reference"),
                                res["tokens"], max_len=res["max_len"])
    need(torch.equal(got, want),
         "prefill logits through the kernels differ from the plain path")
    print(f"  prefill logits {list(got.shape)}: kernels == plain versions, "
          "bit for bit")

    phase("calibration check: the main run's levels vs the plain version")
    p, ccfg = ctx.p, ctx.ccfg
    fcfg = FleetConfig(**grid)
    offs = manufacture_fleet(SEED + 2, fcfg, p, device=dev)
    want_levels = calibrate_fleet(SEED + 2, offs, fcfg, p, ccfg,
                                  method="reference").levels
    need(torch.equal(session.calibration.levels, want_levels),
         "calibrated levels through calib_iter differ from the plain path")
    print(f"  levels {list(want_levels.shape)} after "
          f"{ccfg.n_iterations} iterations: kernel == plain version")
    del offs, want_levels
    walls = calibration_walls(torch, dev, session, sync)

    phase("reopen: cache hits")
    cfg = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE)
    again = PUDSession.open(
        ARCH, grid=fcfg, cache_dir=cache.name, calib=ccfg,
        seed=SEED + 2, device=dev)
    st = again.calibrate()
    packed2 = again.pack(res["params"], cfg, name=f"{ARCH}-{preset}")
    need(st.cache_hit, "reopened session missed the calibration table")
    need(again.placement_status == "hit",
         f"reopened placement {again.placement_status}")
    need(torch.equal(packed2.tensor("unembed/w").planes,
                     packed.tensor("unembed/w").planes),
         "reopened packs differ")
    print(f"  table HIT in {st.wall_s:.2f}s, placement HIT "
          f"[{again.placement_name}]")
    del again, packed2

    recal = recalibration_phase(torch, dev, session, cache.name, recal,
                                kernels, sync)
    launches["calib_iter"] += recal["launches"]
    fault = fault_phase(torch, dev, res["model"], res["params"],
                        res["tokens"], res["max_len"],
                        session.calibration.masks, grid, kernels, sync)
    for k in ("gemm_placed", "gemv_placed"):
        launches[k] += fault["launches"][k]

    phase("unplaced engine path: --no-placement --engine, unplaced kernels")
    argv_u = ["--arch", ARCH, "--preset", preset, "--pud-gemv",
              "--calib-cache", cache.name, "--no-placement", "--engine",
              "--fleet-subarrays", str(grid["n_subarrays"]),
              "--fleet-cols", str(grid["n_cols"]),
              "--batch", str(ENGINE_BATCH), "--batch-size",
              str(ENGINE_SLOTS), "--prompt-len", str(PROMPT),
              "--gen", str(GEN), "--seed", str(SEED), "--device", str(dev)]
    reset_counts(kernels)
    ures = serve.run(serve.parse_args(argv_u))
    sync()
    ucounts = read_counts(kernels)
    usession, upacked, model = ures["session"], ures["packed"], ures["model"]
    print(f"  launches: {ucounts}")
    need(usession.calibration.cache_hit, "unplaced run missed the table")
    need(usession.placement_status is None and not upacked.placed,
         f"--no-placement placed the packs ({usession.placement_status})")
    need(ucounts["gemm"] > 0 or not on_card,
         "the unplaced engine path never launched gemm")
    need(ucounts["gemm_placed"] == ucounts["gemv_placed"] == 0,
         "the unplaced path launched a placed kernel")
    comps = ures["completions"]
    need(len(comps) == ENGINE_BATCH
         and all(len(c.tokens) == GEN for c in comps),
         "the engine did not complete every request with its budget")
    need(all(0 <= t < vocab for c in comps for t in c.tokens), "bad tokens")
    sched = ures["sched"]
    print(f"  engine: {sched['steps']} steps on {sched['batch_size']} slots, "
          f"slot occupancy {sched['slot_occupancy']:.4f}, decode wall "
          f"{sched['wall_tok_s']:.1f} tok/s; batched vs lockstep "
          f"{ures['engine_agreement']:.4f} of requests bit-identical")

    phase("unplaced: one batch-1 request (unplaced GEMV decode)")
    reset_counts(kernels)
    one_u, _ = serve.greedy_generate(model, upacked.params,
                                     ures["tokens"][:1], GEN,
                                     ures["max_len"])
    sync()
    ucounts1 = read_counts(kernels)
    print(f"  launches: {ucounts1}")
    need(ucounts1["gemv"] > 0 or not on_card,
         "B=1 decode never launched gemv")
    need(ucounts1["gemm_placed"] == ucounts1["gemv_placed"] == 0,
         "the unplaced path launched a placed kernel")
    need(tuple(one_u.shape) == (1, GEN), "bad batch-1 tokens")
    for k in ("gemm", "gemv"):
        launches[k] += ucounts[k] + ucounts1[k]

    phase("profile: one batch-4 unplaced decode step")
    profile_step(torch, model, upacked.params, ures["tokens"][:BATCH],
                 ures["max_len"], sync)

    phase(f"profile: one unplaced prefill of {BATCH} x {PROMPT} rows")
    gemm = profile_prefill(torch, model, upacked.params,
                           ures["tokens"][:BATCH], ures["max_len"], sync)
    need(not gemm or any("plane_mma_kernel" in k for _, _, k in gemm),
         "the unplaced prefill did not run the tensor-core GEMM kernel")

    phase("ragged engine run: kernels vs plain versions, same schedule")
    reqs = ragged_requests(torch, vocab)
    r_len = RAGGED["prompt"][1] + RAGGED["budget"][1]
    eng = usession.serving_engine(model, max_len=r_len,
                                  batch_size=ENGINE_SLOTS,
                                  collect_logits=True)
    eng_ref = ServingEngine(model, restamp(upacked.params, "reference"),
                            session=usession, max_len=r_len,
                            batch_size=ENGINE_SLOTS, collect_logits=True)
    got_c, want_c = eng.run(reqs), eng_ref.run(reqs)
    sync()
    for g_, w_ in zip(got_c, want_c):
        need(g_.tokens == w_.tokens and torch.equal(g_.logits, w_.logits)
             and (g_.slot, g_.admitted_step) == (w_.slot, w_.admitted_step),
             f"request {g_.request_id}: kernels differ from plain versions")
    rsched = eng.scheduler_report()
    need(len(got_c) == RAGGED["n"] and rsched["prefill_traces"] > 1
         and max(c.admitted_step for c in got_c) > 0,
         "the ragged run did not exercise buckets and mid-run admission")
    print(f"  {len(got_c)} requests, {rsched['generated_tokens']} tokens in "
          f"{rsched['steps']} steps, {rsched['prefill_traces']} prefill "
          f"buckets, occupancy {rsched['slot_occupancy']:.4f}: tokens and "
          "logits through the kernels == plain versions, bit for bit")
    del eng, eng_ref, got_c, want_c

    archive = archive_phase(
        torch, dev, model,
        [("placed", packed, res["tokens"], res["max_len"]),
         ("unplaced", upacked, ures["tokens"], ures["max_len"])],
        kernels, sync)
    for counts_ in (a["launches"] for a in archive.values()):
        for k in ("gemm_placed", "gemv_placed", "gemm", "gemv"):
            launches[k] += counts_[k]

    mon = monitored_phase(torch, dev, preset, grid, cache.name, monitor,
                          kernels, sync)
    for k in ("calib_iter", "gemm_placed", "gemv_placed"):
        launches[k] += mon["launches"][k]
    tun = tuning_phase(torch, dev, preset, grid, cache.name, tune_batches,
                       kernels, sync)
    wbits = weight_bits_phase(torch, dev, preset, grid, cache.name,
                              weight_bits, kernels, sync)
    for k in launches:
        launches[k] += tun["launches"][k] + wbits["launches"][k]
    del res, ures
    cache.cleanup()

    phase("kernels vs plain versions at the main path's shapes")
    # calib_iter: one launch over the whole grid, as each iteration of the
    # main path makes it: G subarrays x S=256 samples of M=5 operands
    rows.add("calib_iter", launches["calib_iter"], [ctx.calib_row(
        fcfg.n_subarrays_total, ccfg.n_samples, ccfg.maj_inputs,
        fcfg.n_cols)])
    # bit-plane GEMM / GEMV on the main path's packs (placed and unplaced),
    # and the unembed pack in the dense layout
    row = ctx.gemm_row
    wi, wo, un = layer0(packed, "wi"), layer0(packed, "wo"), \
        packed.tensor("unembed/w")
    dun = to_dense(un)
    gp = (placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain)
    vp = (placed_gemm.gemv_placed, placed_gemm.gemv_placed_plain)
    rows.add("gemm_placed", launches["gemm_placed"],
             [row(*gp, wi, BATCH * PROMPT)]
             + [row(*gp, pt, BATCH) for pt in (wi, wo, un, tun.pop("wq"),
                                                wbits.pop("wi"))]
             + [row(*gp, dun, BATCH)])
    rows.add("gemv_placed", launches["gemv_placed"],
             [row(*vp, un, 1), row(*vp, dun, 1)])
    del dun
    uwi, uwo, uun = layer0(upacked, "wi"), layer0(upacked, "wo"), \
        upacked.tensor("unembed/w")
    duun = to_dense(uun)
    gu = (plane_gemm.gemm, plane_gemm.gemm_plain)
    vu = (plane_gemm.gemv, plane_gemm.gemv_plain)
    rows.add("gemm", launches["gemm"],
             [row(*gu, uwi, BATCH * PROMPT)]
             + [row(*gu, pt, ENGINE_SLOTS) for pt in (uwo, uun)]
             + [row(*gu, uwo, BATCH * PROMPT), row(*gu, duun, BATCH)])
    rows.add("gemv", launches["gemv"], [row(*vu, uun, 1),
                                        row(*vu, duun, 1)])
    return {"mean_ecr": mean_ecr, "occupancy": occupancy,
            "calibration_walls": walls, "recalibration": recal,
            "faults": fault, "archive": archive, "monitor": mon,
            "tuning": tun, "weight_bits": wbits}


def papers_group(ctx, rows: Rows, table1: dict, table1_calib,
                 quickstart: dict, simra: dict, dense_cfg: dict,
                 sense_shapes, calib_shapes, fleet_argv,
                 figures: dict) -> dict:
    """The paper's Table I, the fleet benchmark, the figures, the
    quickstart, the command-level simulator, the dense layout through the
    ``ops`` entries, the contract gate and the benchmarks; then the
    ``majx_sense`` row, ``calib_iter`` at the benchmarks' grids and the
    dense layout on every GEMM / GEMV entry."""
    from repro_torch.kernels import calib_iter, placed_gemm, plane_gemm, \
        sense

    torch, dev, kernels, sync = ctx.torch, ctx.dev, ctx.kernels, ctx.sync
    t1 = table1_phase(torch, dev, table1, table1_calib)
    fleet = fleet_calibration_phase(torch, dev, fleet_argv,
                                    calib_iter.calib_iter)
    figs = figures_phase(torch, dev, figures, kernels, sync)
    qs = quickstart_phase(torch, dev, quickstart)
    sim = simra_phase(torch, dev, simra, sense.majx_sense)
    dense = dense_phase(torch, dev, dense_cfg, kernels)
    contr = contracts_phase(dev)
    benches = benchmarks_phase(torch, dev, kernels, sync)

    phase("kernels vs plain versions at the benchmarks' shapes")
    # calib_iter at the fleet benchmark's main leg and a ragged grid (its
    # byte path), ...
    rows.add("calib_iter", fleet["launches"] + figs["launches"]["calib_iter"],
             [ctx.calib_row(*sh) for sh in calib_shapes])
    for k in ("gemm_placed", "gemv_placed"):
        rows.add(k, figs["launches"][k])
    # ... the ops phase's dense benchmark packs on every entry ...
    row, lw = ctx.gemm_row, dense["launches"]
    kb, kbp = dense["pack"], dense["placed_pack"]
    for name, fn, plain, pt, b in (
            ("gemm_placed", placed_gemm.gemm_placed,
             placed_gemm.gemm_placed_plain, kbp, dense_cfg["b"]),
            ("gemv_placed", placed_gemm.gemv_placed,
             placed_gemm.gemv_placed_plain, kbp, 1),
            ("gemm", plane_gemm.gemm, plane_gemm.gemm_plain, kb,
             dense_cfg["b"]),
            ("gemm", plane_gemm.gemm, plane_gemm.gemm_plain, kb,
             BATCH * PROMPT),
            ("gemv", plane_gemm.gemv, plane_gemm.gemv_plain, kb, 1)):
        rows.add(name, shapes=[dict(row(fn, plain, pt, b),
                                    launches=lw[name])])
    # ... and majx_sense at the simulator's shapes, beside the practical
    # floor of a CUDA-event-timed launch: an empty kernel (a spin of zero
    # cycles) timed the same way
    floor = time_ms(torch, lambda: torch.cuda._sleep(0), ctx.flush) \
        if ctx.on_card else None
    (t0_, r0_, c0_, f0_), *rest = sense_shapes
    rows.add("majx_sense", sim["launches"],
             [dict(ctx.sense_row(t0_, r0_, c0_, f0_), floor_ms=floor)]
             + [ctx.sense_row(*sh) for sh in rest])
    return {"table1": t1, "fleet_calibration": fleet, "figures": figs,
            "quickstart": qs, "simra": sim, "contracts": contr,
            "benchmarks": benches}


def gemma_group(ctx, rows: Rows, gemma: dict) -> dict:
    """gemma-7b at full width through the engine's scheduler, then the
    placed GEMM / GEMV and ``calib_iter`` at its shapes."""
    from repro_torch.kernels import placed_gemm

    gem = gemma_phase(ctx.torch, ctx.dev, gemma, ctx.kernels, ctx.sync)
    gpk = gem.pop("packed")
    phase("kernels vs plain versions at gemma's shapes")
    rows.add("calib_iter", gem["calib_launches"], [ctx.calib_row(
        gemma["grid"]["n_subarrays"], ctx.ccfg.n_samples,
        ctx.ccfg.maj_inputs, gemma["grid"]["n_cols"])])
    gp = (placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain)
    gun = gpk.tensor("unembed/w")
    rows.add("gemm_placed", gem["launches"]["gemm_placed"],
             [ctx.gemm_row(*gp, pt, b) for pt, b in (
                 (layer0(gpk, "wi"), gemma["chunk"]),
                 (layer0(gpk, "wo"), gemma["slots"]),
                 (gun, gemma["slots"]))])
    rows.add("gemv_placed", gem["launches"]["gemv_placed"],
             [ctx.gemm_row(placed_gemm.gemv_placed,
                           placed_gemm.gemv_placed_plain, gun, 1)])
    return {"gemma": gem}


def deepseek_group(ctx, rows: Rows, deepseek: dict) -> dict:
    """deepseek-v2-lite-16b at full width and depth, then the placed GEMM /
    GEMV at its shapes."""
    from repro_torch.kernels import placed_gemm

    ds = deepseek_phase(ctx.torch, ctx.dev, deepseek, ctx.kernels, ctx.sync)
    dpk, dpa = ds.pop("packed"), ds.pop("packed_attn")
    phase("kernels vs plain versions at deepseek-v2-lite's shapes")
    rows.add("calib_iter", ds["calib_launches"])
    shared = [dpk.tensor(f"layers_1_moe/mixer/shared/{n}").layer(0)
              for n in ("wi", "wo")]
    dense0 = [layer0(dpk, n) for n in ("wi", "wo")]
    dun = dpk.tensor("unembed/w")
    dwq = dpa.tensor("layers_1_moe/attn/wq").layer(0)
    gp = (placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain)
    rows.add("gemm_placed", ds["launches"]["gemm_placed"],
             [ctx.gemm_row(*gp, pt, deepseek["batch"])
              for pt in shared + dense0 + [dun, dwq]])
    rows.add("gemv_placed", ds["launches"]["gemv_placed"],
             [ctx.gemm_row(placed_gemm.gemv_placed,
                           placed_gemm.gemv_placed_plain, dun, 1)])
    return {"deepseek": ds}


def fleet_phase(ctx, cfg: dict) -> dict:
    """The sharded fleet through ``PUDSession.open_fleet`` on a
    ``cfg["mesh"]`` mesh: a calibration miss on every device (the
    ``calib_iter`` launches counted), per-shard placement and packs, a
    reopen that hits every table and placement, ``FleetServingEngine``
    over the requests, one batch-1 request per layout, and the checks:
    (a) a ragged fleet run == its replay on the plain versions, (b) every
    lane == a single-device ``ServingEngine`` over the unsharded logical
    pack, same requests, order and slots, (c) the same for a
    forced-logical fleet, (d) ``recalibrate_shard(1, ...)`` moves only
    shard 1's state and its levels equal the plain version's, (e)
    ``FleetDriftMonitor`` stamps and routes events to shard 1; then a
    profiled batch-4 lane decode step and the aggregate rate model."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig, recalibrate_subarrays
    from repro_torch.core.reliability import DriftSimulator
    from repro_torch.core.rng import generator
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import init_params, param_count
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
    from repro_torch.pud.packer import pack_model
    from repro_torch.runtime.drift import DriftConfig, FleetDriftMonitor
    from repro_torch.runtime.engine import (FleetServingEngine, Request,
                                            ServingEngine)
    from repro_torch.runtime.session import PUDSession

    torch, dev, on_card = ctx.torch, ctx.dev, ctx.on_card
    kernels, sync = ctx.kernels, ctx.sync
    n_data, n_model = cfg["mesh"]
    spec = get(cfg["arch"])
    if cfg["preset"] == "smoke":
        model = spec.make_smoke()
        if cfg.get("widen"):
            model = TransformerLM(dataclasses.replace(model.cfg,
                                                      **cfg["widen"]))
    else:
        model = spec.make_model()
    phase(f"fleet: {cfg['arch']} ({cfg['preset']}, "
          f"{param_count(model.param_defs()):,} params) on a "
          f"{n_data}x{n_model} mesh of {cfg['grid']['n_subarrays']} x "
          f"{cfg['grid']['n_cols']:,} devices")
    mesh = make_host_mesh(n_data, n_model, device=dev)
    print(f"  positions -> cards: {mesh.describe()}")
    params = init_params(model.param_defs(), SEED, dev)
    grid = FleetConfig(**cfg["grid"])
    ccfg = ctx.ccfg
    pcfg = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE)
    cache = tempfile.TemporaryDirectory(prefix="pud-fleet-")
    name = f"{cfg['arch']}-{cfg['preset']}-fleet"

    def open_fleet(**kw):
        return PUDSession.open_fleet(cfg["arch"], mesh=mesh, grid=grid,
                                     cache_dir=cache.name, calib=ccfg,
                                     seed=SEED + 2, **kw)

    def statuses(f):
        return [[s.placement_status or "logical" for s in row]
                for row in f.sessions]

    reset_counts(kernels)
    fleet = open_fleet()
    t0 = time.perf_counter()
    states = fleet.calibrate()
    sync()
    t_cal = time.perf_counter() - t0
    n_cal = kernels["calib_iter"].launches
    need(not any(st.cache_hit for row in states for st in row),
         "a fresh fleet cache reported a hit")
    need(n_cal == fleet.n_devices * ccfg.n_iterations or not on_card,
         f"{n_cal} calib_iter launches for {fleet.n_devices} devices x "
         f"{ccfg.n_iterations} iterations")
    print(f"  calibration miss: {fleet.n_devices} devices in {t_cal:.2f}s, "
          f"{n_cal} calib_iter launches; mean ECR per device "
          f"{[[round(st.mean_ecr, 4) for st in row] for row in states]}")
    t0 = time.perf_counter()
    packs = fleet.pack(params, pcfg, name=name)
    sync()
    t_pack = time.perf_counter() - t0
    occ = [[round(s.placement.occupancy, 4) if s.placement else None
            for s in row] for row in fleet.sessions]
    used = [[s.placement.capacity_report()["used_cols"] if s.placement
             else 0 for s in row] for row in fleet.sessions]
    need(all(pm.placed for pm in packs), f"placement {statuses(fleet)}")
    print(f"  pack {t_pack:.2f}s: shard widths per slice "
          f"{list(fleet.shard_widths)}, placement {statuses(fleet)}, placed "
          f"columns per device {used}, occupancy {occ}")

    phase("fleet: reopen on the same cache")
    again = open_fleet()
    hits = [[st.cache_hit for st in row] for row in again.calibrate()]
    again.pack(params, pcfg, name=name)
    need(all(all(row) for row in hits), f"reopen missed a table: {hits}")
    need(statuses(again) == [["hit"] * n_model] * n_data,
         f"reopen placement {statuses(again)}")
    a_un = again.packs[0].tensor("unembed/w").shards[0]
    need(torch.equal(a_un.planes,
                     packs[0].tensor("unembed/w").shards[0].planes),
         "reopened packs differ")
    print(f"  every table HIT {hits}, every placement HIT")
    del again, a_un

    phase(f"fleet: FleetServingEngine, {cfg['requests']} requests on "
          f"{cfg['slots']} slots per lane")
    g = generator(SEED, "fleet-requests")
    prompts = [torch.randint(0, model.cfg.vocab, (cfg["prompt"],),
                             generator=g, dtype=torch.int32)
               for _ in range(cfg["requests"])]

    def requests():
        return [Request(i, t, cfg["gen"]) for i, t in enumerate(prompts)]

    max_len = cfg["prompt"] + cfg["gen"] + 1
    engine = fleet.serving_engine(model, max_len=max_len,
                                  batch_size=cfg["slots"],
                                  collect_logits=True)
    reset_counts(kernels)
    t0 = time.perf_counter()
    comps = engine.run(requests())
    sync()
    t_eng = time.perf_counter() - t0
    launches = read_counts(kernels)
    launches["calib_iter"] = n_cal
    sched = engine.scheduler_report()
    print(f"  launches: {launches}; {sched['completed']} requests over "
          f"{sched['n_lanes']} lanes in {sched['steps']} steps, "
          f"{sched['generated_tokens']} tokens, {t_eng:.2f}s wall")
    need(len(comps) == cfg["requests"]
         and all(len(c.tokens) == cfg["gen"] for c in comps),
         "the fleet engine did not complete every request")
    need(launches["gemm_placed"] > 0 or not on_card,
         "the fleet never launched gemm_placed")
    need(launches["gemm"] == launches["gemv"] == 0,
         "the placed fleet launched an unplaced kernel")
    lane_of = {c.request_id: d for d, lane in enumerate(engine.lanes)
               for c in lane._completions}

    phase("fleet (b): every lane == a single-device engine over the "
          "unsharded logical pack")
    logical = pack_model(params, pcfg)
    t0 = time.perf_counter()
    singles = {}
    for d in range(n_data):
        ids = [i for i in range(cfg["requests"]) if lane_of[i] == d]
        single = ServingEngine(model, logical.params, max_len=max_len,
                               batch_size=cfg["slots"], collect_logits=True)
        for c in single.run([requests()[i] for i in ids]):
            singles[c.request_id] = c
    sync()

    def same_as_single(cs, label):
        for c in cs:
            w = singles[c.request_id]
            need(c.tokens == w.tokens and torch.equal(c.logits, w.logits),
                 f"{label}: request {c.request_id} differs from the "
                 "single-device engine")

    same_as_single(comps, "placed fleet")
    print(f"  {len(comps)} requests over {n_data} lanes: tokens and logits "
          f"== the single-device engine's, bit for bit "
          f"({time.perf_counter() - t0:.2f}s)")

    phase("fleet: one batch-1 request through lane 0 (placed GEMV per "
          "shard)")
    reset_counts(kernels)
    one, _ = serve.greedy_generate(model, packs[0].params,
                                   prompts[0][None].to(dev), cfg["gen"],
                                   max_len)
    sync()
    c1 = read_counts(kernels)
    need(c1["gemv_placed"] > 0 or not on_card,
         "B=1 fleet decode never launched gemv_placed")
    need(tuple(one.shape) == (1, cfg["gen"]), "bad batch-1 tokens")
    print(f"  launches: {c1}")
    for k in ("gemm_placed", "gemv_placed"):
        launches[k] += c1[k]

    phase("fleet (c): a forced-logical fleet (placement=False)")
    flog = open_fleet(placement=False)
    flog.calibrate()
    lpacks = flog.pack(params, pcfg, name=name)
    need(not any(pm.placed for pm in lpacks), "placement=False placed")
    reset_counts(kernels)
    lcomps = flog.serving_engine(model, max_len=max_len,
                                 batch_size=cfg["slots"],
                                 collect_logits=True).run(requests())
    one_l, _ = serve.greedy_generate(model, lpacks[0].params,
                                     prompts[0][None].to(dev), cfg["gen"],
                                     max_len)
    sync()
    cl = read_counts(kernels)
    need(cl["gemm_placed"] == cl["gemv_placed"] == 0,
         "the logical fleet launched a placed kernel")
    need((cl["gemm"] > 0 and cl["gemv"] > 0) or not on_card,
         "the logical fleet never launched gemm / gemv")
    same_as_single(lcomps, "logical fleet")
    need(torch.equal(one_l, one),
         "batch-1 decode through the logical fleet differs from the placed")
    print(f"  launches: {cl}; tokens and logits == the single-device "
          "engine's, bit for bit; batch-1 tokens == the placed lane's")
    for k in ("gemm", "gemv"):
        launches[k] += cl[k]
    lun = lpacks[0].tensor("unembed/w")
    lwi = lpacks[0].tensor("layers_0_dense/mixer/wi")
    del flog, lcomps, logical, singles

    phase("fleet (a): a ragged fleet run, kernels vs plain versions")
    reqs = ragged_requests(torch, model.cfg.vocab, cfg["ragged"])
    r_len = cfg["ragged"]["prompt"][1] + cfg["ragged"]["budget"][1]
    reset_counts(kernels)
    got_c = fleet.serving_engine(model, max_len=r_len,
                                 batch_size=cfg["slots"],
                                 collect_logits=True).run(reqs)
    sync()
    cr = read_counts(kernels)
    want_c = FleetServingEngine(
        model, [restamp(pm.params, "reference") for pm in packs],
        fleet=fleet, max_len=r_len, batch_size=cfg["slots"],
        collect_logits=True).run(reqs)
    for g_, w_ in zip(got_c, want_c):
        need(g_.tokens == w_.tokens and torch.equal(g_.logits, w_.logits)
             and (g_.slot, g_.admitted_step) == (w_.slot, w_.admitted_step),
             f"fleet request {g_.request_id}: kernels differ from plain "
             "versions")
    print(f"  launches: {cr}; {len(got_c)} requests: tokens and logits "
          "through the kernels == plain versions, bit for bit")
    for k in ("gemm_placed", "gemv_placed"):
        launches[k] += cr[k]
    del got_c, want_c

    phase(f"profile: one batch-{cfg['slots']} decode step of lane 0")
    prof = profile_step(torch, model, packs[0].params,
                        torch.stack(prompts[:cfg["slots"]]).to(dev),
                        max_len, sync)
    per_step = {}
    reset_counts(kernels)
    with torch.inference_mode():
        logits, kv = model.prefill(packs[0].params,
                                   torch.stack(prompts[:cfg["slots"]])
                                   .to(dev), max_len=max_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        reset_counts(kernels)
        model.decode_step(packs[0].params, kv, nxt, cfg["prompt"])
        sync()
        per_step = read_counts(kernels)
    print(f"  launches per decode step: {per_step}")

    phase("fleet (e): FleetDriftMonitor routes events to shard 1")
    subs = sorted(cfg["drift"])
    sims = [DriftSimulator.for_session(s) for s in fleet.sessions[0]]
    mon = FleetDriftMonitor(fleet, sims, config=DriftConfig(probe_every=1))
    clean = [e for e in mon.probe() if e.severity == "critical"]
    need(not clean, f"critical events on a clean fleet: {clean}")
    sims[1].advance(temp_c=cfg["drift_temp_c"], subarrays=subs)
    events = [e for e in mon.probe() if e.severity == "critical"]
    need(events and {e.shard for e in events} == {1}
         and {e.subarray for e in events} <= set(subs),
         f"drift events not routed to shard 1: {events}")
    s00, state00 = fleet.shard(0, 0), fleet.shard(0, 0)._state
    reset_counts(kernels)
    mon.recover(events[0])
    sync()
    n_mon = kernels["calib_iter"].launches
    need(s00._state is state00, "the monitor's recovery touched shard 0")
    print(f"  critical events {[(e.shard, e.subarray) for e in events]} "
          f"after drifting shard 1's subarrays {subs} at "
          f"{cfg['drift_temp_c']:.0f} C; recover(event {events[0].subarray})"
          f" recalibrated shard 1 only ({n_mon} calib_iter launches)")

    phase(f"fleet (d): recalibrate_shard(1, {subs}) moves only shard 1")
    s01 = fleet.shard(0, 1)
    others = {(d, m): (fleet.shard(d, m)._state, fleet.shard(d, m)._placement)
              for d in range(n_data) for m in range(n_model)
              if (d, m) != (0, 1)}
    old = s01.calibration
    offs = sims[1].sense_offsets()
    reset_counts(kernels)
    t0 = time.perf_counter()
    pm = fleet.recalibrate_shard(1, subs, offs,
                                 assumed_temp_c=cfg["drift_temp_c"])
    sync()
    t_rec = time.perf_counter() - t0
    n_rec = kernels["calib_iter"].launches
    for key, (st_, plc) in others.items():
        need(fleet.shard(*key)._state is st_
             and fleet.shard(*key)._placement is plc,
             f"recalibrating shard 1 touched device {key}")
    new = s01.calibration
    rows_ = torch.tensor(subs, device=new.levels.device)
    keep = torch.ones(grid.n_subarrays_total, dtype=torch.bool,
                      device=new.levels.device)
    keep[rows_] = False
    need(torch.equal(new.levels[keep], old.levels[keep])
         and torch.equal(new.masks[keep], old.masks[keep]),
         "recalibration moved rows outside the drifted subarrays")
    need(not torch.equal(new.levels[rows_], old.levels[rows_]),
         "recalibration moved no level")
    want = recalibrate_subarrays(s01.seed, offs.to(s01.device), subs, grid,
                                 s01.physics, s01.calib_cfg,
                                 method="reference")
    need(torch.equal(new.levels[rows_], want),
         "recalibrated levels differ from the plain version")
    need(fleet.packs[0] is pm and pm.placed, "lane 0 was not repacked")
    need(n_rec == ccfg.n_iterations or not on_card,
         f"{n_rec} calib_iter launches for one recalibration")
    print(f"  {n_rec} calib_iter launches, {t_rec:.2f}s: shard 1's levels "
          f"moved on {subs} only (== plain version), masks and placement "
          "rebuilt; devices (0,0), (1,0), (1,1): state and placement "
          "objects untouched")
    launches["calib_iter"] += n_rec + n_mon

    phase("fleet: per-shard launch plans (PUDFleetSession.tune)")
    with torch.inference_mode():
        x4 = torch.stack(prompts[:cfg["slots"]]).to(dev)
        before, _ = model.prefill(fleet.packs[0].params, x4,
                                  max_len=max_len)
    tuned = None
    if on_card:
        t0 = time.perf_counter()
        trep = fleet.tune(batches=(1, cfg["slots"]))
        sync()
        tuned = dict(keys=len(trep["keys"]),
                     wall_s=time.perf_counter() - t0)
        with torch.inference_mode():
            after, _ = model.prefill(fleet.packs[0].params, x4,
                                     max_len=max_len)
        need(torch.equal(before, after),
             "prefill through the tuned fleet differs from the untuned")
        for key, r in sorted(trep["keys"].items()):
            speed = (f", {r['speedup']:.2f}x vs heuristic"
                     if "speedup" in r else "")
            print(f"    {r['status']:<5s} {key}{speed}")
        print(f"  {tuned['keys']} per-shard keys tuned in "
              f"{tuned['wall_s']:.2f}s; lane 0's prefill through the tuned "
              "packs == untuned, bit for bit")
    else:
        try:
            fleet.tune()
            need(False, "PUDFleetSession.tune ran on the CPU")
        except RuntimeError:
            print("  PUDFleetSession.tune on the CPU raises (it times the "
                  "CUDA kernels)")

    phase("fleet: DDR4-PUD aggregate rate model")
    perf = engine.perf_report(2 * spec.n_active_params)
    print(f"  aggregate {perf['aggregate_tok_s']:.2f} tok/s over "
          f"{perf['n_devices']} devices (batched at {perf['batch_size']}: "
          f"{perf['aggregate_batched_tok_s']:.2f}), scaling efficiency "
          f"{perf['scaling_efficiency']:.4f}, slowest-shard work share "
          f"{perf['shard_fraction']:.4f}")
    st = packs[0]
    shapes = dict(
        wi=st.tensor("layers_0_dense/mixer/wi").shards[0].layer(0),
        un=st.tensor("unembed/w").shards[0],
        lwi=lwi.shards[0].layer(0), lun=lun.shards[0])
    cache.cleanup()
    return {"launches": launches, "walls_s": dict(
                calibrate=t_cal, pack=t_pack, engine=t_eng,
                recalibrate=t_rec),
            "shard_widths": fleet.shard_widths, "occupancy": occ,
            "used_cols": used,
            "events": [(e.shard, e.subarray) for e in events],
            "profile": prof, "per_step": per_step, "tuned": tuned,
            "aggregate_tok_s": perf["aggregate_tok_s"],
            "scaling_efficiency": perf["scaling_efficiency"],
            "sched": sched, "shapes": shapes,
            "grid": (grid.n_subarrays_total, grid.n_cols)}


def fleet_group(ctx, rows: Rows, fleet: dict) -> dict:
    """The sharded fleet phase, then each kernel at its per-shard shapes."""
    from repro_torch.kernels import placed_gemm, plane_gemm

    fl = fleet_phase(ctx, fleet)
    sh = fl.pop("shapes")
    phase("kernels vs plain versions at the fleet's per-shard shapes")
    g, c = fl["grid"]
    row, lw = ctx.gemm_row, fl["launches"]
    gp = (placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain)
    rows.add("calib_iter", lw["calib_iter"], [ctx.calib_row(
        g, ctx.ccfg.n_samples, ctx.ccfg.maj_inputs, c)])
    rows.add("gemm_placed", lw["gemm_placed"],
             [row(*gp, sh["wi"], fleet["prompt"]),
              row(*gp, sh["wi"], fleet["slots"]),
              row(*gp, sh["un"], fleet["slots"])])
    rows.add("gemv_placed", lw["gemv_placed"],
             [row(placed_gemm.gemv_placed, placed_gemm.gemv_placed_plain,
                  sh["un"], 1)])
    rows.add("gemm", lw["gemm"],
             [row(plane_gemm.gemm, plane_gemm.gemm_plain, sh["lwi"],
                  fleet["slots"])])
    rows.add("gemv", lw["gemv"],
             [row(plane_gemm.gemv, plane_gemm.gemv_plain, sh["lun"], 1)])
    return {"fleet": fl}


def serve_family(ctx, cfg: dict, arch: str, cache_dir: str, batch: int,
                 extra=()) -> tuple:
    """One family through the serving entry point (``serve.run``) at the
    group's grid, prompts and budgets; returns (its result, the launches
    it made)."""
    from repro_torch.launch import serve
    grid = cfg["grid"]
    argv = ["--arch", arch, "--preset", cfg["preset"], "--pud-gemv",
            "--calib-cache", cache_dir,
            "--fleet-subarrays", str(grid["n_subarrays"]),
            "--fleet-cols", str(grid["n_cols"]), "--batch", str(batch),
            "--prompt-len", str(cfg["prompt"]), "--gen", str(cfg["gen"]),
            "--seed", str(SEED), "--device", str(ctx.dev), *extra]
    reset_counts(ctx.kernels)
    res = serve.run(serve.parse_args(argv))
    ctx.sync()
    counts = read_counts(ctx.kernels)
    s = res["session"]
    need(s.placement_status == "planned" and res["packed"].placed,
         f"{arch}: placement {s.placement_status}: {s.placement_error}")
    need(counts["gemm_placed"] > 0 or not ctx.on_card,
         f"{arch}: lockstep never launched gemm_placed")
    need(counts["gemm"] == counts["gemv"] == 0,
         f"{arch}: the placed path launched an unplaced kernel")
    need(bool(ctx.torch.isfinite(res["logits"]).all()), f"{arch}: bad logits")
    rep = s.placement.capacity_report()
    print(f"  {arch}: {len(res['packed'].packed_names)} packs "
          f"{list(res['packed'].packed_names)}; {rep['used_cols']:,} placed "
          f"columns (occupancy {rep['occupancy']:.4f}); table "
          f"{'HIT' if s.calibration.cache_hit else 'MISS'}; launches "
          f"{counts}")
    return res, counts, rep


def kernels_equal_plain(ctx, label: str, model, packed_params, tokens,
                        max_len: int, extras=None) -> None:
    """The whole-model prefill through the kernels == the same packs
    through the plain versions on the same device, bit for bit."""
    torch = ctx.torch
    ex = tuple((extras or {}).values())
    with torch.inference_mode():
        got, _ = model.prefill(packed_params, tokens, *ex, max_len=max_len)
        want, _ = model.prefill(restamp(packed_params, "reference"), tokens,
                                *ex, max_len=max_len)
    ctx.sync()
    need(torch.equal(got, want), f"{label}: prefill logits through the "
         "kernels differ from the plain versions")
    print(f"  {label}: prefill logits {list(got.shape)} through the kernels "
          "== plain versions, bit for bit")


def families_group(ctx, rows: Rows, cfg: dict) -> dict:
    """The SSM, hybrid, encoder-decoder and VLM families (``FAMILIES``) on
    one calibration cache: zamba2-7b (a table miss) at full width and
    depth, mamba2-1.3b and whisper-large-v3 at full width and depth,
    pixtral-12b at full width with ``pixtral_layers`` layers (each a table
    hit and a new placement); then the placed GEMM / GEMV at their
    shapes."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.rng import generator
    from repro_torch.kernels import placed_gemm
    from repro_torch.launch import serve
    from repro_torch.models.params import init_params, param_count
    from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
    from repro_torch.runtime.engine import Request, ServingEngine
    from repro_torch.runtime.session import PUDSession

    torch, dev, on_card, sync = ctx.torch, ctx.dev, ctx.on_card, ctx.sync
    kernels = ctx.kernels
    full = cfg["preset"] == "full"
    b, gen, prompt = cfg["batch"], cfg["gen"], cfg["prompt"]
    cache = tempfile.TemporaryDirectory(prefix="pud-families-")
    launches = dict.fromkeys(kernels, 0)
    keep, out = {}, {}
    card = card_line() if on_card else "the CPU (rehearsal)"

    def count(c):
        for k, v in c.items():
            launches[k] += v

    def peak():
        return (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else None)

    def expect_cols(arch, rep):
        want = cfg["placed_cols"][arch]
        need(not full or rep["used_cols"] == want,
             f"{arch}: {rep['used_cols']} placed columns, expected {want}")

    # -- (a) zamba2-7b: the slice's full-width path --------------------------
    arch = "zamba2-7b"
    phase(f"families: {arch} ({cfg['preset']}) through serve --pud-gemv "
          f"--pud-attention --engine, a calibration miss on a "
          f"{cfg['grid']['n_subarrays']} x {cfg['grid']['n_cols']:,} grid")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, c, rep = serve_family(ctx, cfg, arch, cache.name, b,
                               ["--pud-attention", "--engine"])
    count(c)
    model, packed, session = res["model"], res["packed"], res["session"]
    mc = model.cfg
    need(not session.calibration.cache_hit, "a fresh cache reported a hit")
    need(c["calib_iter"] > 0 or not on_card,
         "the calibration never launched calib_iter")
    need("engine" not in res, "the engine served the hybrid")
    expect_cols(arch, rep)
    print(f"  {param_count(model.param_defs()):,} parameters ({mc.n_blocks} "
          f"blocks: {mc.n_shared_uses} shared-attention uses x "
          f"{mc.mamba_per_segment} Mamba2 + {mc.n_tail}; d {mc.d_model}, "
          f"{mc.n_heads} heads, d_ff {mc.d_ff}, d_state {mc.d_state}, vocab "
          f"{mc.vocab}); calibration {session.calibration.wall_s:.3f}s, mean "
          f"ECR {session.calibration.mean_ecr:.4f}; serve wall "
          f"{time.perf_counter() - t0:.2f}s; the engine refused the hybrid "
          "(the reference's engine fails on it)")
    kernels_equal_plain(ctx, arch, model, packed.params, res["tokens"],
                        res["max_len"])
    phase(f"{arch}: one batch-1 request (placed GEMV decode), then the "
          f"placed launches of one batch-{b} decode step")
    reset_counts(kernels)
    one, _ = serve.greedy_generate(model, packed.params, res["tokens"][:1],
                                   gen, res["max_len"])
    sync()
    c1 = read_counts(kernels)
    count(c1)
    need(c1["gemv_placed"] > 0 or not on_card,
         "batch-1 decode never launched gemv_placed")
    need(tuple(one.shape) == (1, gen), "bad batch-1 tokens")
    with torch.inference_mode():
        lg, kv = model.prefill(packed.params, res["tokens"],
                               max_len=res["max_len"])
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        sync()
        reset_counts(kernels)
        model.decode_step(packed.params, kv, nxt, prompt)
        sync()
        per_step = read_counts(kernels)["gemm_placed"]
    want_step = 4 * mc.n_shared_uses + 1
    need(per_step == want_step or not on_card,
         f"{per_step} placed GEMM launches per step, expected {want_step}")
    print(f"  batch-1 launches {c1}; {per_step} placed GEMM launches per "
          f"batch-{b} step ({mc.n_shared_uses} uses x 4 attention "
          f"projections + the unembed); on {card}")
    del lg, kv
    phase(f"profile: one batch-{b} {arch} decode step")
    z_prof = profile_step(torch, model, packed.params, res["tokens"],
                          res["max_len"], sync)
    z_peak = peak()
    print(f"  {arch} decode step measured on {card}")
    out["zamba"] = dict(placed_cols=rep["used_cols"],
                        occupancy=rep["occupancy"], per_step=per_step,
                        profile=z_prof, peak_gib=z_peak,
                        calib_wall_s=session.calibration.wall_s,
                        mean_ecr=session.calibration.mean_ecr,
                        agreement=res["agreement"])
    keep["z_un"] = packed.tensor("unembed/w")
    keep["z_wq"] = packed.tensor("shared/attn/wq")
    print(f"  peak device memory "
          + (f"{z_peak:.2f} GiB" if z_peak is not None else "not measured"))
    del res, model, packed, session, one
    free(ctx)

    # -- (b) mamba2-1.3b -----------------------------------------------------
    arch = "mamba2-1.3b"
    phase(f"families: {arch} ({cfg['preset']}) through serve --pud-gemv "
          f"--engine: {b} requests on {cfg['slots']} slots")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res, c, rep = serve_family(
        ctx, cfg, arch, cache.name, b,
        ["--engine", "--batch-size", str(cfg["slots"])])
    count(c)
    model, packed, session = res["model"], res["packed"], res["session"]
    mc = model.cfg
    need(session.calibration.cache_hit, f"{arch} missed the table")
    expect_cols(arch, rep)
    need(res["engine_agreement"] == 1.0,
         "the engine's tokens differ from lockstep's")
    print(f"  {mc.n_layers} layers, d {mc.d_model}, d_state {mc.d_state}, "
          f"{model.ssm.n_heads} SSM heads, vocab {mc.vocab}; engine == "
          f"lockstep on {b} / {b} requests")
    kernels_equal_plain(ctx, arch, model, packed.params, res["tokens"],
                        res["max_len"])

    phase(f"{arch}: engine, {cfg['requests']} requests on {cfg['slots']} "
          "slots, against lockstep in batches of the slot count")
    g = generator(SEED, "mamba-prompts")
    prompts = torch.randint(0, mc.vocab, (cfg["requests"], prompt),
                            generator=g, dtype=torch.int32).to(dev)
    reset_counts(kernels)
    lock = [serve.greedy_generate(model, packed.params,
                                  prompts[i:i + cfg["slots"]], gen,
                                  res["max_len"])
            for i in range(0, cfg["requests"], cfg["slots"])]
    lock_toks = torch.cat([t for t, _ in lock]).tolist()
    lock_logits = torch.cat([lg for _, lg in lock])
    eng = session.serving_engine(model, max_len=res["max_len"],
                                 batch_size=cfg["slots"],
                                 collect_logits=True)
    sync()
    t0 = time.perf_counter()
    comps = eng.run([Request(i, prompts[i], gen)
                     for i in range(cfg["requests"])])
    sync()
    t_eng = time.perf_counter() - t0
    count(read_counts(kernels))
    erep = eng.scheduler_report()
    same = [c_.tokens == lock_toks[c_.request_id] for c_ in comps]
    for c_ in comps:
        want = lock_toks[c_.request_id]
        if c_.tokens != want:
            first = next(i for i, (x, y) in enumerate(zip(c_.tokens, want))
                         if x != y)
            d = (c_.logits - lock_logits[c_.request_id, :gen]).abs()
            print(f"    request {c_.request_id}: tokens differ from step "
                  f"{first}; max |logit delta| per step "
                  f"{d.amax(-1).tolist()}")
    print(f"  {erep['generated_tokens']} tokens in {erep['steps']} steps, "
          f"slot occupancy {erep['slot_occupancy']:.4f}, decode "
          f"{erep['wall_tok_s']:.1f} tok/s ({t_eng:.2f}s wall); "
          f"{sum(same)} / {len(comps)} requests equal to lockstep")
    need(len(comps) == cfg["requests"] and all(same),
         "the engine's tokens differ from lockstep's")
    del eng, comps, lock, lock_logits

    phase(f"{arch}: ragged engine run, kernels vs plain versions")
    gr = generator(SEED, "mamba-ragged")
    (p0, p1), (b0, b1) = cfg["ragged"]["prompt"], cfg["ragged"]["budget"]
    n_r = cfg["ragged"]["n"]
    lens = torch.randint(p0, p1 + 1, (n_r,), generator=gr).tolist()
    budgets = torch.randint(b0, b1 + 1, (n_r,), generator=gr).tolist()
    rreqs = [Request(i, torch.randint(0, model.cfg.vocab, (n,),
                                      generator=gr, dtype=torch.int32), m)
             for i, (n, m) in enumerate(zip(lens, budgets))]
    eng_k = session.serving_engine(model, max_len=p1 + b1,
                                   batch_size=cfg["slots"],
                                   collect_logits=True)
    eng_p = ServingEngine(model, restamp(packed.params, "reference"),
                          session=session, max_len=p1 + b1,
                          batch_size=cfg["slots"], collect_logits=True)
    reset_counts(kernels)
    got_r = eng_k.run(rreqs)
    sync()
    count(read_counts(kernels))
    reset_counts(kernels)
    want_r = eng_p.run(rreqs)
    sync()
    need(sum(read_counts(kernels).values()) == 0,
         "the plain replay launched a kernel")
    for g_, w_ in zip(got_r, want_r):
        need(g_.tokens == w_.tokens and torch.equal(g_.logits, w_.logits),
             f"request {g_.request_id}: kernels differ from plain versions")
    rrep = eng_k.scheduler_report()
    print(f"  {n_r} requests (prompts {lens}, budgets {budgets}), "
          f"{rrep['generated_tokens']} tokens in {rrep['steps']} steps, "
          f"{rrep['prefill_traces']} prefill shapes: tokens and logits "
          "through the kernels == plain versions, bit for bit")
    del eng_k, eng_p, got_r, want_r

    phase(f"{arch}: the unplaced packs (--no-placement): plane_gemm "
          "kernels at batch 4 and 1")
    s_np = PUDSession.open(
        arch, grid=FleetConfig(**cfg["grid"]), cache_dir=cache.name,
        calib=CalibrationConfig(n_iterations=12, n_samples=256),
        seed=SEED + 2, placement=False, device=dev)
    need(s_np.calibrate().cache_hit, "the unplaced session missed")
    pk_np = s_np.pack(res["params"], PUDGemvConfig(weight_bits=4,
                                                   packable=FFN_PACKABLE),
                      name=f"{arch}-{cfg['preset']}-logical")
    need(not pk_np.placed, "the unplaced session placed its packs")
    kernels_equal_plain(ctx, f"{arch} unplaced", model, pk_np.params,
                        res["tokens"], res["max_len"])
    reset_counts(kernels)
    serve.greedy_generate(model, pk_np.params, res["tokens"], gen,
                          res["max_len"])
    serve.greedy_generate(model, pk_np.params, res["tokens"][:1], gen,
                          res["max_len"])
    sync()
    c_np = read_counts(kernels)
    count(c_np)
    need((c_np["gemm"] > 0 and c_np["gemv"] > 0) or not on_card,
         "the unplaced packs never launched plane_gemm's kernels")
    need(c_np["gemm_placed"] == c_np["gemv_placed"] == 0,
         "the unplaced packs launched a placed kernel")
    print(f"  lockstep at batch {b} and 1 on logical columns: launches "
          f"{c_np}")
    phase(f"profile: one batch-{b} {arch} decode step")
    m_prof = profile_step(torch, model, packed.params, res["tokens"],
                          res["max_len"], sync)
    m_peak = peak()
    print(f"  {arch} decode step measured on {card}")
    out["mamba"] = dict(placed_cols=rep["used_cols"],
                        occupancy=rep["occupancy"], profile=m_prof,
                        peak_gib=m_peak, engine_tok_s=erep["wall_tok_s"],
                        engine_steps=erep["steps"],
                        agreement=res["agreement"])
    keep["m_un"] = packed.tensor("unembed/w")
    del res, model, packed, session, s_np, pk_np
    free(ctx)

    # -- (c) whisper-large-v3 ------------------------------------------------
    arch = "whisper-large-v3"
    phase(f"families: {arch} ({cfg['preset']}) through serve --pud-gemv "
          "--pud-attention --engine (the encoder's attention packed)")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res, c, rep = serve_family(ctx, cfg, arch, cache.name, b,
                               ["--pud-attention", "--engine"])
    count(c)
    model, packed, session = res["model"], res["packed"], res["session"]
    mc = model.cfg
    need(session.calibration.cache_hit, f"{arch} missed the table")
    need("engine" not in res, "the engine served the encoder-decoder")
    expect_cols(arch, rep)
    print(f"  {mc.n_enc_layers} + {mc.n_dec_layers} layers, d "
          f"{mc.d_model}, {mc.n_heads} heads, d_ff {mc.d_ff}, vocab "
          f"{mc.vocab}, {mc.n_frames} frames; the encoder's wq / wk / wv / "
          f"wo run at {b} x {mc.n_frames} rows; engine skipped (as the "
          "reference)")
    kernels_equal_plain(ctx, arch, model, packed.params, res["tokens"],
                        res["max_len"], res["frontend"])
    w_peak = peak()
    out["whisper"] = dict(placed_cols=rep["used_cols"],
                          occupancy=rep["occupancy"], peak_gib=w_peak,
                          agreement=res["agreement"],
                          pud_wall_s=res["wall_s"]["pud"])
    keep["w_wq"] = packed.tensor("enc_layers/attn/wq").layer(0)
    keep["w_un"] = packed.tensor("unembed/w")
    keep["w_rows"] = b * mc.n_frames
    del res, model, packed, session
    free(ctx)

    # -- (d) pixtral-12b, depth cut ------------------------------------------
    arch = "pixtral-12b"
    spec = get(arch)
    model = spec.make_model() if full else spec.make_smoke()
    lm = dataclasses.replace(model.cfg.lm, n_layers=min(
        cfg["pixtral_layers"], model.cfg.lm.n_layers))
    model = type(model)(dataclasses.replace(model.cfg, lm=lm))
    phase(f"families: {arch} ({cfg['preset']}, {lm.n_layers} of "
          f"{spec.make_model().cfg.lm.n_layers} layers): placed FFN + "
          "unembed, the patch prefix")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = init_params(model.param_defs(), SEED, dev)
    session = PUDSession.open(
        arch, grid=FleetConfig(**cfg["grid"]), cache_dir=cache.name,
        calib=CalibrationConfig(n_iterations=12, n_samples=256),
        seed=SEED + 2, device=dev)
    need(session.calibrate().cache_hit, f"{arch} missed the table")
    packed = session.pack(params, PUDGemvConfig(weight_bits=4,
                                                packable=FFN_PACKABLE),
                          name=f"{arch}-{cfg['preset']}-{lm.n_layers}l")
    need(session.placement_status == "planned" and packed.placed,
         f"placement {session.placement_status}: {session.placement_error}")
    rep = session.placement.capacity_report()
    expect_cols(arch, rep)
    tokens = torch.randint(0, lm.vocab, (b, prompt),
                           generator=generator(SEED + 1, "prompt",
                                               device=dev),
                           device=dev, dtype=torch.int32)
    extras, prefix = serve.frontend_extras(model, spec.family, b, SEED + 1,
                                           dev)
    max_len = prompt + gen + 1 + prefix
    print(f"  {param_count(model.param_defs()):,} parameters (d "
          f"{lm.d_model}, d_ff {lm.d_ff}, vocab {lm.vocab}, "
          f"{model.cfg.n_patches} patches of d_vit {model.cfg.d_vit}); "
          f"{len(packed.packed_names)} packs, {rep['used_cols']:,} placed "
          f"columns (occupancy {rep['occupancy']:.4f})")
    kernels_equal_plain(ctx, arch, model, packed.params, tokens, max_len,
                        extras)
    phase(f"{arch}: lockstep greedy decode after the {prefix}-patch prefix")
    with torch.inference_mode():
        _, kv = model.prefill(packed.params, tokens, *extras.values(),
                              max_len=max_len)
        k0 = kv[next(iter(kv))]["k"][0]            # layer 0 [B, max_len, ..]
        filled = k0.abs().flatten(2).amax(-1) > 0      # [B, max_len]
        need(bool(filled[:, :prefix + prompt].all())
             and not bool(filled[:, prefix + prompt:].any()),
             "the prefill did not fill exactly patches + prompt rows")
    reset_counts(kernels)
    toks, logits = serve.greedy_generate(model, packed.params, tokens, gen,
                                         max_len, extras, prefix)
    sync()
    c = read_counts(kernels)
    count(c)
    need(c["gemm_placed"] > 0 or not on_card,
         "lockstep never launched gemm_placed")
    need(tuple(toks.shape) == (b, gen) and bool(torch.isfinite(logits).all())
         and int(toks.max()) < lm.vocab, "bad lockstep tokens or logits")
    print(f"  cache rows [0, {prefix + prompt}) filled by the prefill "
          f"(patches + prompt), decode from position {prefix + prompt}; "
          f"{b * gen} tokens, launches {c}")
    p_peak = peak()
    out["pixtral"] = dict(placed_cols=rep["used_cols"], layers=lm.n_layers,
                          occupancy=rep["occupancy"], peak_gib=p_peak)
    keep["p_wi"] = packed.tensor("layers_0_dense/mixer/wi").layer(0)
    del params, packed, session, model, kv, toks, logits
    free(ctx)
    cache.cleanup()

    phase("kernels vs plain versions at the families' shapes")
    gp = (placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain)
    rows.add("calib_iter", launches["calib_iter"])
    rows.add("gemm", launches["gemm"])
    rows.add("gemv", launches["gemv"])
    rows.add("gemm_placed", launches["gemm_placed"],
             [ctx.gemm_row(*gp, keep["z_un"], b),
              ctx.gemm_row(*gp, keep["z_wq"], b),
              ctx.gemm_row(*gp, keep["w_wq"], keep["w_rows"]),
              ctx.gemm_row(*gp, keep["w_un"], b),
              ctx.gemm_row(*gp, keep["p_wi"], b)])
    rows.add("gemv_placed", launches["gemv_placed"],
             [ctx.gemm_row(placed_gemm.gemv_placed,
                           placed_gemm.gemv_placed_plain, keep["m_un"], 1)])
    out["launches"] = launches
    print(f"  families launches {launches}; kernel rows on {card}")
    return {"families": out}


def kernel_family(name: str) -> str:
    """A device event's name cut to its kernel family (template arguments
    and launch bounds dropped), for a per-step breakdown."""
    return name.split("<")[0].split("(")[0][:80]


def train_argv(cfg: dict, dev, steps: int, *extra) -> list:
    return ["--arch", cfg["arch"], "--preset", cfg["preset"],
            "--seq-len", str(cfg["seq_len"]),
            "--global-batch", str(cfg["global_batch"]),
            "--microbatches", str(cfg["microbatches"]), "--steps", str(steps),
            "--seed", str(SEED), "--log-every", "1", "--device", str(dev),
            *extra]


def print_steps(label: str, res: dict, device_ms=None) -> None:
    """Per step: loss, grad norm, lr, host wall, tokens/s (and the
    profiled device time)."""
    tok = res["tokens_per_step"]
    for i, (loss, gn, lr, wall) in enumerate(zip(
            res["losses"], res["grad_norms"], res["lrs"], res["step_s"])):
        dev = ("" if device_ms is None else
               f", device {device_ms[i]:.1f} ms "
               f"({device_ms[i] / 1e3 / wall:.1%} busy)")
        print(f"  {label} step {res['start_step'] + i}: loss {loss:.6f}, "
              f"grad norm {gn:.4f}, lr {lr:.3e}, host wall {wall:.3f} s"
              f"{dev}, {tok / wall:,.0f} tokens/s")


def leaf_errors(a, b) -> dict:
    """{leaf path: (max |a - b|, max |b|)} of two gradient trees (compared
    on the CPU; empty leaves left out)."""
    out = {}

    def walk(x, y, path):
        if isinstance(x, dict):
            for n in x:
                walk(x[n], y[n], path + (n,))
        elif y.numel():
            out["/".join(path)] = (float((x.cpu() - y.cpu()).abs().max()),
                                   float(y.abs().max()))
    walk(a, b, ())
    return out


@contextlib.contextmanager
def rules_for(mesh, rules=None):
    """The launcher's logical->mesh rules (``rules``, by default the
    mesh's own) with ``mesh``'s sizes installed for the block
    (``sharding_ctx.set_rules``), the ones before restored."""
    from repro_torch.models import sharding_ctx
    from repro_torch.runtime import sharding as shd
    before = sharding_ctx.get_rules()
    sharding_ctx.set_rules({**(rules or shd.make_rules(mesh)),
                            "_mesh_sizes": mesh.shape})
    try:
        yield
    finally:
        sharding_ctx.set_rules(before)


def train_smoke_step(ctx, arch: str, cfg: dict, mesh=None) -> dict:
    """One ``make_train_step`` of ``arch``'s smoke config on the card and
    on the CPU from the same parameters and batch, in float32 (the bf16
    parameters cast up) and in bf16.  With ``mesh`` (a ("data", "model")
    mesh of positions on the card) the step sharded on it is held to the
    card's one-device step instead.  Returns per dtype: the |loss diff|;
    ``grad_ratio``, the worst gradient leaf's max |diff| over its
    tolerance (float32: ``f32_tol`` x the leaf's largest magnitude; bf16:
    that with ``bf16_grad_tol``, or the CPU's own bf16-vs-float32
    difference on the leaf where larger, the noise floor of bf16 rounding)
    and the worst parameter |diff| after the step over the bound a sign
    flip of a near-zero gradient allows (two lr, one bf16 ulp)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.launch.train import family_extras
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.data import DataConfig, DataPipeline
    from repro_torch.runtime.optim import OptConfig, init_opt_state, tree_map
    from repro_torch.runtime.steps import (make_train_step, microbatch_grads,
                                           sharded_microbatch_grads)
    torch, dev = ctx.torch, ctx.dev
    spec = get(arch)
    m16 = spec.make_smoke()
    mc = m16.cfg
    m32 = type(m16)(
        dataclasses.replace(mc, lm=dataclasses.replace(
            mc.lm, dtype=torch.float32)) if hasattr(mc, "lm") else
        dataclasses.replace(mc, dtype=torch.float32))
    sm = cfg["smoke"]
    b16 = DataPipeline(DataConfig(vocab=getattr(mc, "lm", mc).vocab,
                                  seq_len=sm["seq_len"],
                                  global_batch=sm["global_batch"],
                                  seed=SEED)).batch_at(0)
    b16.update(family_extras(spec, m16, b16["tokens"].shape, 0, SEED))
    b32 = {k: v.float() if v.dtype == torch.bfloat16 else v
           for k, v in b16.items()}
    p16 = init_params(m16.param_defs(), SEED, "cpu")
    opt = OptConfig(warmup_steps=1)
    k = sm["microbatches"]
    def rules():
        return (rules_for(mesh) if mesh is not None
                else contextlib.nullcontext())
    runs = {}
    for tag, model, batch, cast in (("float32", m32, b32, torch.float32),
                                    ("bf16", m16, b16, None)):
        cpu = tree_map(lambda t: t.to(cast or t.dtype, copy=True), p16)
        card = tree_map(lambda t: t.to(dev, copy=True), cpu)  # in place
        cbatch = {n: v.to(dev) for n, v in batch.items()}
        loss_c, g_c = microbatch_grads(model, cpu, batch, k)
        loss_g, g_g = microbatch_grads(model, card, cbatch, k)
        if mesh is None:       # the card against the CPU
            ref, got = (loss_c, g_c, cpu, batch), (loss_g, g_g, card, cbatch)
        else:                  # the sharded step against the card's
            specs = param_pspecs(model.param_defs(), shd.make_rules(mesh))
            sharded = shd.device_put(card, shd.named(mesh, specs))
            with rules():
                loss_s, g_s = sharded_microbatch_grads(model, sharded,
                                                       batch, k)
            ref = (loss_g, g_g, card, cbatch)
            got = (loss_s, shd.gather_tree(g_s, "cpu"), sharded, batch)
        step = make_train_step(model, opt, k)
        _, _, m_r = step(ref[2], init_opt_state(ref[2], opt), ref[3])
        with rules():
            _, _, m_g = step(got[2], init_opt_state(got[2], opt), got[3])
        ctx.sync()
        lr, worst = float(m_r["lr"]), [0.0]

        def param_ratio(a, b):
            a = a.cpu().float()
            d = (a - b.cpu().float()).abs()
            if d.numel():   # two lr with 1% to spare, one bf16 ulp
                worst[0] = max(worst[0], float(
                    (d / (2.02 * lr + a.abs() / 128)).max()))
        tree_map(param_ratio, ref[2], shd.gather_tree(got[2], "cpu"))
        runs[tag] = dict(loss_ref=float(ref[0]), loss_got=float(got[0]),
                         g_ref=ref[1], g_got=got[1], g_cpu=g_c,
                         loss_cpu=float(loss_c), param_ratio=worst[0],
                         step_loss_err=abs(float(m_r["loss"])
                                           - float(m_g["loss"])),
                         gnorm_ref=float(m_r["grad_norm"]),
                         gnorm_got=float(m_g["grad_norm"]))
    floor = leaf_errors(runs["bf16"]["g_cpu"], runs["float32"]["g_cpu"])
    out = {}
    for tag, r in runs.items():
        ratios = {}
        for path, (err, scale) in leaf_errors(r["g_got"],
                                              r["g_ref"]).items():
            if tag == "float32":
                tol = cfg["f32_tol"] * scale
            else:
                tol = max(cfg["bf16_grad_tol"] * scale, floor[path][0])
            ratios[path] = err / tol if tol > 0 else (0.0 if err == 0
                                                      else math.inf)
        leaf = max(ratios, key=ratios.get)
        ltol = cfg["f32_tol"] if tag == "float32" else max(
            cfg["bf16_loss_tol"], abs(runs["bf16"]["loss_cpu"]
                                      - runs["float32"]["loss_cpu"]))
        out[tag] = dict(
            loss_ref=r["loss_ref"], loss_got=r["loss_got"],
            loss_err=abs(r["loss_ref"] - r["loss_got"]), loss_tol=ltol,
            step_loss_err=r["step_loss_err"], grad_leaf=leaf,
            grad_ratio=ratios[leaf], param_ratio=r["param_ratio"],
            gnorm_ref=r["gnorm_ref"], gnorm_got=r["gnorm_got"])
    return out


def print_smoke_steps(ctx, cfg: dict, got: str, ref: str, mesh=None) -> dict:
    """``train_smoke_step`` for every arch; prints each against its
    tolerances and fails past them."""
    from repro_torch.configs import all_archs
    smoke = {}
    for arch in all_archs():
        for tag, r in train_smoke_step(ctx, arch, cfg, mesh).items():
            label = f"{arch} ({tag})"
            print(f"  {label}: loss {r['loss_got']:.6f} ({ref} "
                  f"{r['loss_ref']:.6f}, |diff| {r['loss_err']:.2e} of "
                  f"{r['loss_tol']:.2e} allowed); worst gradient leaf "
                  f"{r['grad_leaf']} at {r['grad_ratio']:.3f} of its "
                  f"tolerance; grad norm {r['gnorm_got']:.4f} ({ref} "
                  f"{r['gnorm_ref']:.4f}); worst parameter |diff| "
                  f"{r['param_ratio']:.3f} of its bound")
            need(r["loss_err"] <= r["loss_tol"]
                 and r["step_loss_err"] <= r["loss_tol"],
                 f"{label}: the {got} loss differs from the {ref}'s")
            need(r["grad_ratio"] <= 1, f"{label}: gradient {r['grad_leaf']}"
                 f" differs from the {ref}'s ({r['grad_ratio']} of its "
                 "tolerance)")
            need(r["param_ratio"] <= 1, f"{label}: the update moved a "
                 f"parameter past its bound ({r['param_ratio']} of it)")
            smoke[label] = r
    return smoke


def step_profiler(ctx):
    """(``profiled(step)``, a context manager that profiles one step,
    the list it appends each step's device ms to, {kernel family: (events,
    ns)} summed over the steps)."""
    from torch.profiler import ProfilerActivity, profile
    device_ms, by_kernel = [], {}

    @contextlib.contextmanager
    def profiled(step):
        # the card's events only, read from the raw trace: building the
        # profiler's event tree for a step's ~10^5 events took ~50 s a step
        from torch.autograd import DeviceType
        acts = [ProfilerActivity.CUDA if ctx.on_card else
                ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            yield
            ctx.sync()
        total = 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                total += e.duration_ns()
                key = kernel_family(e.name())
                n, t = by_kernel.get(key, (0, 0))
                by_kernel[key] = (n + 1, t + e.duration_ns())
        device_ms.append(total / 1e6 if ctx.on_card else float("nan"))

    return profiled, device_ms, by_kernel


def train_group(ctx, cfg: dict) -> dict:
    """Training on one card (``TRAIN``): (a) qwen3-1.7b at full width and
    depth through ``launch.train`` (runs A, B resumed from A, C
    uninterrupted and profiled), (b) every arch's smoke step on the card
    against the CPU."""
    from repro_torch.launch import train
    torch, dev, sync = ctx.torch, ctx.dev, ctx.sync
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-train-")
    try:
        phase(f"train (a) run A: {cfg['arch']} ({cfg['preset']}), "
              f"{cfg['steps']} steps of {cfg['global_batch']} x "
              f"{cfg['seq_len']} tokens in {cfg['microbatches']} "
              f"microbatches, stopped before step {cfg['steps_a']} after an "
              "async checkpoint")
        if ctx.on_card:
            torch.cuda.reset_peak_memory_stats()
        a = train.run(train.parse_args(train_argv(
            cfg, dev, cfg["steps"], "--save-every", str(cfg["steps_a"]),
            "--ckpt-dir", tmp)), stop_at=cfg["steps_a"])
        print_steps("A", a)
        peak_a = (torch.cuda.max_memory_allocated() / 2**30
                  if ctx.on_card else None)
        save, = a["ckpt"]["saves"]
        write, = a["ckpt"]["writes"]
        print(f"  {a['n_params']:,} parameters; checkpoint of step "
              f"{write['step']}: {write['bytes']:,} bytes, host snapshot "
              f"{save['snapshot_s']:.2f} s, background write "
              f"{write['seconds']:.2f} s "
              f"({write['bytes'] / write['seconds'] / 1e9:.2f} GB/s); "
              f"peak memory {peak_a and f'{peak_a:.2f} GiB'}")
        final_a = {"params": a.pop("params"), "opt": a.pop("opt_state")}
        free(ctx)

        phase(f"train (a) run B: resume from step {cfg['steps_a']} to "
              f"{cfg['steps']}")
        restored = {}

        def on_restore(tree):
            from repro_torch.runtime.checkpoint import _flatten
            want, got = _flatten(final_a), _flatten(tree)
            need(list(want) == list(got), "run B restored other leaves")
            restored["leaves"] = len(got)
            restored["equal"] = sum(torch.equal(want[k], got[k])
                                    for k in want)
            restored["bytes"] = sum(t.numel() * t.element_size()
                                    for t in got.values())
            final_a.clear()

        b = train.run(train.parse_args(train_argv(
            cfg, dev, cfg["steps"], "--resume", "--ckpt-dir", tmp)),
            on_restore=on_restore)
        b.pop("params"), b.pop("opt_state")
        need(restored.get("leaves") and
             restored["equal"] == restored["leaves"],
             f"run B's restored state differs from run A's: {restored}")
        need(b["start_step"] == cfg["steps_a"],
             f"run B resumed at {b['start_step']}")
        print(f"  restored {restored['leaves']} leaves "
              f"({restored['bytes']:,} bytes) equal to run A's final state, "
              f"bit for bit; read wall {b['ckpt']['restore_s']:.2f} s")
        print_steps("B", b)
        bw = b["ckpt"]["writes"][-1]
        print(f"  final checkpoint (step {bw['step']}): {bw['bytes']:,} "
              f"bytes in {bw['seconds']:.2f} s")
        free(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    phase(f"train (a) run C: {cfg['steps']} steps uninterrupted, each "
          "profiled")
    profiled, device_ms, by_kernel = step_profiler(ctx)

    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats()
    c = train.run(train.parse_args(train_argv(cfg, dev, cfg["steps"])),
                  step_context=profiled)
    c.pop("params"), c.pop("opt_state")
    peak_c = (torch.cuda.max_memory_allocated() / 2**30
              if ctx.on_card else None)
    print_steps("C", c, device_ms if ctx.on_card else None)
    if by_kernel:
        steps = len(device_ms)
        print(f"  device time per step by kernel family (mean of {steps}):")
        for key, (n, t) in sorted(by_kernel.items(), key=lambda kv:
                                  -kv[1][1])[:10]:
            print(f"    {t / steps / 1e6:9.1f} ms  x{n // steps:<6d} {key}")
    need(c["rc"] == 0, f"run C's loss did not fall: {c['losses']}")
    k = cfg["steps_a"]
    need(b["digests"] == c["digests"][k:],
         "run B's batches differ from run C's at the same steps")
    need(a["digests"] == c["digests"][:k], "run A's batches differ from C's")
    err_b = max(abs(x - y) for x, y in zip(b["losses"], c["losses"][k:]))
    err_a = max(abs(x - y) for x, y in zip(a["losses"], c["losses"][:k]))
    print(f"  batches of B (steps {k}-{cfg['steps'] - 1}) == C's, bit for "
          f"bit; max |loss B - loss C| {err_b:.3e}, max |loss A - loss C| "
          f"{err_a:.3e} (tolerance {cfg['loss_tol']}); loss "
          f"{c['losses'][0]:.4f} -> {c['losses'][-1]:.4f}; peak memory "
          f"{peak_c and f'{peak_c:.2f} GiB'}")
    need(err_b <= cfg["loss_tol"] and err_a <= cfg["loss_tol"],
         f"resumed losses differ from the uninterrupted run: {err_b}, "
         f"{err_a}")
    out["a"] = dict(losses=a["losses"], step_s=a["step_s"], peak_gib=peak_a,
                    ckpt=a["ckpt"])
    out["b"] = dict(losses=b["losses"], step_s=b["step_s"], ckpt=b["ckpt"],
                    restored=restored)
    out["c"] = dict(losses=c["losses"], step_s=c["step_s"],
                    device_ms=device_ms, peak_gib=peak_c,
                    by_kernel=by_kernel,
                    tokens_per_step=c["tokens_per_step"])
    out["loss_err"] = (err_a, err_b)
    free(ctx)

    phase("train (b): one make_train_step of every arch's smoke config on "
          f"{dev} against the CPU, in float32 and in bf16")
    out["smoke"] = print_smoke_steps(ctx, cfg, "card", "CPU")
    return {"train": out}


def mesh_train_phase(ctx, cfg: dict) -> dict:
    """(a) qwen3-1.7b through ``launch.train.run(mesh=...)`` on a
    ``cfg["mesh"]`` mesh of positions on the card (parameters and AdamW
    moments stored as per-position shards, the data-parallel step), the
    run cut before step ``steps_a`` of ``steps``; then the same run on one
    device (plain tensors).  Both profiled; losses within the reference's
    own mesh-test tolerances (``loss_rtol`` / ``loss_atol``), the bf16
    parameters within ``param_atol`` at the cut."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.optim import tree_leaves
    torch, dev, on_card = ctx.torch, ctx.dev, ctx.on_card
    d, m = cfg["mesh"]
    mesh = make_host_mesh(d, m, device=dev)
    argv = train_argv(cfg, dev, cfg["steps"])
    out = {}
    for label, kw in (("mesh", dict(mesh=mesh)), ("one", {})):
        where = (f"a {d}x{m} mesh ({mesh.describe()})" if kw else
                 "one device")
        phase(f"mesh (a) {label}: {cfg['arch']} ({cfg['preset']}) on "
              f"{where}, {cfg['steps_a']} steps of the {cfg['steps']}-step "
              f"schedule, {cfg['global_batch']} x {cfg['seq_len']} tokens in "
              f"{cfg['microbatches']} microbatches, each profiled")
        free(ctx)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        profiled, device_ms, by_kernel = step_profiler(ctx)
        res = train.run(train.parse_args(argv), stop_at=cfg["steps_a"],
                        step_context=profiled, **kw)
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        print_steps(label, res, device_ms if on_card else None)
        r = dict(losses=res["losses"], step_s=res["step_s"],
                 device_ms=device_ms, peak_gib=peak,
                 tokens_per_step=res["tokens_per_step"])
        if kw:
            held = res["bytes_per_position"]
            state = tree_leaves({"p": res["params"], "o": res["opt_state"]})
            whole = sum(math.prod(x.shape) * x.dtype.itemsize
                        for x in state)
            # a position's share: each leaf over its distinct blocks (the
            # replicated norm scales whole)
            share = sum(math.prod(x.shape) * x.dtype.itemsize
                        / len(x.canonical()) for x in state)
            worst = max(held.values())
            print(f"  parameter + moment bytes per position: "
                  f"{ {c: f'{b / 1e9:.3f} GB' for c, b in held.items()} }; "
                  f"the whole state {whole / 1e9:.3f} GB, the largest "
                  f"position {worst / whole:.4f} of it (its share of the "
                  f"blocks {share / whole:.4f})")
            need(worst <= share * 1.01,
                 f"a position holds {worst / whole:.4f} of the state, "
                 f"over its share {share / whole:.4f}")
            r.update(bytes_per_position={str(c): b for c, b in held.items()},
                     state_bytes=whole)
            want = shd.gather_tree(res["params"], "cpu")
            del state
        else:
            worst_p = 0.0
            for a, b in zip(tree_leaves(res["params"]), tree_leaves(want)):
                if a.numel():
                    worst_p = max(worst_p, float(
                        (a.float() - b.to(a.device).float()).abs().max()))
            del want
        print(f"  peak memory {peak and f'{peak:.2f} GiB'}")
        if by_kernel:
            steps = len(device_ms)
            print(f"  device time per step by kernel family (mean of "
                  f"{steps}):")
            for key, (n, t) in sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1][1])[:6]:
                print(f"    {t / steps / 1e6:9.1f} ms  x{n // steps:<6d} "
                      f"{key}")
        out[label] = r
        del res
    sh, one = out["mesh"]["losses"], out["one"]["losses"]
    ok = all(abs(a - b) <= cfg["loss_atol"] + cfg["loss_rtol"] * abs(b)
             for a, b in zip(sh, one))
    print(f"  losses on the mesh {sh}, on one device {one}: max |diff| "
          f"{max(abs(a - b) for a, b in zip(sh, one)):.3e} (rtol = atol = "
          f"{cfg['loss_rtol']}); bf16 parameters at step {cfg['steps_a']}: "
          f"max |diff| {worst_p:.3e} (allowed {cfg['param_atol']})")
    need(ok and len(sh) == len(one) == cfg["steps_a"],
         f"the mesh's losses {sh} differ from one device's {one}")
    need(worst_p < cfg["param_atol"],
         f"the mesh's parameters differ from one device's by {worst_p}")
    out["param_err"] = worst_p
    free(ctx)
    return out


def mesh_pipeline_phase(ctx, cfg: dict) -> dict:
    """(b) ``runtime.pipeline.pipelined_apply`` over a ("stage",) mesh of
    ``stages`` positions on the card: qwen3-1.7b's stacked layers split by
    ``stage_split``, ``micro`` microbatches of [rows, seq, d_model] bf16
    hidden states, the model's layer as the stage function; equal, bit for
    bit, to applying every layer to each microbatch in turn."""
    from repro_torch.configs import get
    from repro_torch.core.rng import generator
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import layer_slices
    from repro_torch.runtime.pipeline import (bubble_fraction,
                                              pipelined_apply, stage_split)
    torch, dev, sync = ctx.torch, ctx.dev, ctx.sync
    spec = get(cfg["arch"])
    model = spec.make_model() if cfg["preset"] == "full" else \
        spec.make_smoke()
    (kind, n_layers), = model.cfg.groups()
    group = f"layers_0_{kind}"
    s, nm = cfg["stages"], cfg["micro"]
    phase(f"mesh (b): GPipe over {s} stages of {n_layers // s} "
          f"{cfg['arch']} layers ({cfg['preset']}), {nm} microbatches of "
          f"[{cfg['rows']}, {cfg['seq']}, {model.cfg.d_model}]")
    layers = init_params({group: model.param_defs()[group]}, SEED,
                         dev)[group]
    mesh = make_stage_mesh(s, device=dev)
    h = torch.randn((nm, cfg["rows"], cfg["seq"], model.cfg.d_model),
                    generator=generator(SEED, "pipeline", device=dev),
                    device=dev).to(model.cfg.dtype)
    positions = torch.arange(cfg["seq"], device=dev).expand(cfg["rows"],
                                                            cfg["seq"])

    def stage_fn(p, x):
        n = next(iter(p["ln1"].values())).shape[0]
        for lp in layer_slices(p, n):
            x = model._layer(kind, lp, x, positions)[0]
        return x

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        got = pipelined_apply(stage_fn, stage_split(layers, s), h, mesh)
        sync()
        t_pipe = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = torch.stack([stage_fn(layers, h[i]) for i in range(nm)])
        sync()
        t_seq = time.perf_counter() - t0
    need(torch.equal(got, want), "the pipeline differs from sequential "
         f"application (max |diff| {float((got - want).abs().max())})")
    need(bool(torch.isfinite(got).all()),
         "the pipeline's output is not finite")
    bub = bubble_fraction(s, nm)
    print(f"  positions -> cards: {mesh.describe()}; output "
          f"{list(got.shape)} == sequential application, bit for bit; "
          f"wall {t_pipe:.3f} s pipelined ({nm + s - 1} ticks), "
          f"{t_seq:.3f} s sequential; bubble_fraction({s}, {nm}) = "
          f"{bub:.4f} ({s - 1}/{nm + s - 1})")
    del layers, h, got, want
    return dict(pipelined_s=t_pipe, sequential_s=t_seq, bubble=bub)


def mesh_fleet_phase(ctx, cfg: dict) -> dict:
    """(c) mamba2-1.3b on the sharded fleet: ``PUDSession.open_fleet`` on a
    ``cfg["mesh"]`` mesh of ``cfg["grid"]`` devices (a calibration miss on
    each), the placed unembed split over the model shards,
    ``FleetServingEngine`` over the requests; every lane == a single-device
    ``ServingEngine`` over the unsharded logical pack, tokens and logits
    bit for bit; the fleet run replayed on the plain versions, bit for
    bit."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.rng import generator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import init_params, param_count
    from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
    from repro_torch.pud.packer import pack_model
    from repro_torch.runtime.engine import (FleetServingEngine, Request,
                                            ServingEngine)
    from repro_torch.runtime.session import PUDSession
    torch, dev, on_card = ctx.torch, ctx.dev, ctx.on_card
    kernels, sync = ctx.kernels, ctx.sync
    n_data, n_model = cfg["mesh"]
    spec = get(cfg["arch"])
    model = spec.make_model() if cfg["preset"] == "full" else \
        spec.make_smoke()
    if cfg.get("widen"):
        model = type(model)(dataclasses.replace(model.cfg, **cfg["widen"]))
    phase(f"mesh (c): {cfg['arch']} ({cfg['preset']}, "
          f"{param_count(model.param_defs()):,} params) on a "
          f"{n_data}x{n_model} fleet of {cfg['grid']['n_subarrays']} x "
          f"{cfg['grid']['n_cols']:,} devices")
    mesh = make_host_mesh(n_data, n_model, device=dev)
    params = init_params(model.param_defs(), SEED, dev)
    pcfg = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE)
    cache = tempfile.TemporaryDirectory(prefix="pud-mesh-")
    fleet = PUDSession.open_fleet(cfg["arch"], mesh=mesh,
                                  grid=FleetConfig(**cfg["grid"]),
                                  cache_dir=cache.name, calib=ctx.ccfg,
                                  seed=SEED + 2)
    reset_counts(kernels)
    t0 = time.perf_counter()
    fleet.calibrate()
    packs = fleet.pack(params, pcfg, name=f"{cfg['arch']}-mesh")
    sync()
    t_open = time.perf_counter() - t0
    n_cal = kernels["calib_iter"].launches
    un = packs[0].tensor("unembed/w")
    need(all(pm.placed for pm in packs), "the fleet did not place")
    need(all(w > 0 for w in un.shard_widths),
         f"an unembed shard owns no column: {un.shard_widths}")
    print(f"  {mesh.describe()}; calibration + placement + pack "
          f"{t_open:.2f} s ({n_cal} calib_iter launches); packed "
          f"{list(packs[0].packed_names)}; unembed shard widths "
          f"{list(un.shard_widths)} (Np {un.padded_n})")
    g = generator(SEED, "mesh-requests")
    vocab = model.cfg.vocab
    prompts = [torch.randint(0, vocab, (cfg["prompt"],), generator=g,
                             dtype=torch.int32)
               for _ in range(cfg["requests"])]

    def requests(ids=None):
        ids = range(len(prompts)) if ids is None else ids
        return [Request(i, prompts[i], cfg["gen"]) for i in ids]

    max_len = cfg["prompt"] + cfg["gen"] + 1
    engine = fleet.serving_engine(model, max_len=max_len,
                                  batch_size=cfg["slots"],
                                  collect_logits=True)
    reset_counts(kernels)
    t0 = time.perf_counter()
    comps = engine.run(requests())
    sync()
    t_eng = time.perf_counter() - t0
    launches = read_counts(kernels)
    launches["calib_iter"] = n_cal
    need(len(comps) == cfg["requests"]
         and all(len(c.tokens) == cfg["gen"] for c in comps),
         "the fleet engine did not complete every request")
    need((launches["gemm_placed"] > 0 and launches["gemv_placed"] > 0)
         or not on_card, f"the fleet's placed kernels never ran: {launches}")
    need(launches["gemm"] == launches["gemv"] == 0,
         "the placed fleet launched an unplaced kernel")
    sched = engine.scheduler_report()
    print(f"  fleet engine: {sched['completed']} requests over "
          f"{sched['n_lanes']} lanes in {sched['steps']} steps, "
          f"{sched['generated_tokens']} tokens, {t_eng:.2f} s wall; "
          f"launches {launches}")

    phase("mesh (c): every lane == a single-device engine; the fleet run "
          "== its plain-version replay")
    logical = pack_model(params, pcfg)
    for d, lane in enumerate(engine.lanes):
        ids = sorted(c.request_id for c in lane._completions)
        single = ServingEngine(model, logical.params, max_len=max_len,
                               batch_size=cfg["slots"], collect_logits=True)
        for c, w in zip(sorted(lane._completions,
                               key=lambda c: c.request_id),
                        single.run(requests(ids))):
            need(c.tokens == w.tokens and torch.equal(c.logits, w.logits),
                 f"lane {d}, request {c.request_id}: the fleet differs from "
                 "the single-device engine")
    del logical
    want = FleetServingEngine(
        model, [restamp(pm.params, "reference") for pm in packs],
        fleet=fleet, max_len=max_len, batch_size=cfg["slots"],
        collect_logits=True).run(requests())
    for a, b in zip(comps, want):
        need(a.tokens == b.tokens and torch.equal(a.logits, b.logits)
             and a.slot == b.slot,
             f"request {a.request_id}: the placed kernels differ from the "
             "plain versions")
    sync()
    print(f"  {len(comps)} requests over {n_data} lanes: tokens and logits "
          "== the single-device engine's and == the plain versions', bit "
          "for bit")
    shard = un.shards[0]
    cache.cleanup()
    del fleet, packs, params, engine
    return dict(launches=launches, unembed_shard=shard, open_s=t_open,
                engine_s=t_eng, shard_widths=list(un.shard_widths),
                padded_n=un.padded_n, steps=sched["steps"])


def mesh_group(ctx, rows: Rows, cfg: dict) -> dict:
    """The mesh group (``MESH``): (a) sharded training, then every arch's
    smoke step on mesh positions against the card's one-device step, (b)
    the pipeline, (c) mamba2 on the fleet, then the placed GEMM / GEMV at
    its per-shard unembed shape."""
    from repro_torch.kernels import placed_gemm
    from repro_torch.launch.mesh import make_host_mesh
    out = {"train": mesh_train_phase(ctx, cfg["train"])}
    tr = cfg["train"]
    phase(f"mesh (a): one step of every arch's smoke config on a "
          f"{tr['mesh'][0]}x{tr['mesh'][1]} mesh of positions on "
          f"{ctx.dev} against the one-device step, float32 and bf16")
    out["smoke"] = print_smoke_steps(
        ctx, tr, "mesh", "one device",
        make_host_mesh(*tr["mesh"], device=ctx.dev))
    free(ctx)
    out["pipeline"] = mesh_pipeline_phase(ctx, cfg["pipeline"])
    free(ctx)
    fl = mesh_fleet_phase(ctx, cfg["fleet"])
    sh, lw = fl.pop("unembed_shard"), fl["launches"]
    phase("kernels vs plain versions at the mesh fleet's per-shard "
          "unembed shape")
    rows.add("calib_iter", lw["calib_iter"])
    rows.add("gemm_placed", lw["gemm_placed"], [ctx.gemm_row(
        placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain, sh,
        cfg["fleet"]["slots"])])
    rows.add("gemv_placed", lw["gemv_placed"], [ctx.gemm_row(
        placed_gemm.gemv_placed, placed_gemm.gemv_placed_plain, sh, 1)])
    out["fleet"] = fl
    return {"mesh": out}


#: the profiler's names of the matrix products (the dry run's FLOPs)
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def profiled_step(ctx, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` with FLOP counting:
    {"flops": the FLOPs of the matrix products that ran, "aborted": (calls,
    FLOPs) of those that did not, "device_ms": the card's events and
    "launches" their count (None off the card), "peak":
    ``max_memory_allocated`` over the call (None off the card)}; read from
    the raw trace, as ``step_profiler``.

    ``torch.utils.checkpoint`` stops a recompute once it holds every
    tensor the backward needs: inside the autograd kernel of the last
    product, whose inputs its pack hook saves (``detach``) before the
    product runs.  The profiler has recorded that call and its FLOPs; it
    ran nothing else.  Such a call is told apart by its nested events:
    ``detach`` alone."""
    import bisect
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch = ctx.torch
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.on_card
                                     else [])
    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=acts, with_flops=True, record_shapes=True) as p:
        fn()
        ctx.sync()
    dev_ns = launches = 0
    threads = collections.defaultdict(list)
    for e in p.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev_ns += e.duration_ns()
            launches += 1
        else:
            threads[e.start_thread_id()].append(e)
    flops, aborted = 0, [0, 0]
    for evs in threads.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.duration_ns()))
        starts = [e.start_ns() for e in evs]
        for i, e in enumerate(evs):
            if e.name() not in MATMUL_OPS:
                continue
            end = bisect.bisect_left(starts, e.start_ns() + e.duration_ns())
            nested = {x.name() for x in evs[i + 1:end]}
            if nested and nested <= {"aten::detach", "detach"}:
                aborted[0] += 1
                aborted[1] += e.flops()
            else:
                flops += e.flops()
    return dict(flops=flops, aborted=tuple(aborted),
                device_ms=dev_ns / 1e6 if ctx.on_card else None,
                launches=launches if ctx.on_card else None,
                peak=torch.cuda.max_memory_allocated() if ctx.on_card
                else None)


def print_prediction(label: str, rec: dict, got: dict, cfg: dict,
                     device_ms=None, flops_limit: bool = True) -> None:
    """The dry run's FLOPs, peak and roofline bound beside the card's;
    fails past ``peak_rtol`` and (``flops_limit``) ``flops_rtol``."""
    from repro_torch.benchmarks import roofline
    t = roofline.terms(rec)
    bound = max(t.values())
    f_err = got["flops"] / rec["flops_per_device"] - 1
    print(f"  {label}: FLOPs predicted {rec['flops_per_device']:.6e}, "
          f"profiler {got['flops']:.6e} ({f_err:+.4%}; matrix products)")
    n, f = got.get("aborted", (0, 0))
    if n:
        print(f"  {label}: {n} more product calls ({f:.6e} FLOPs) recorded "
              "by the profiler ran nothing: checkpoint recomputes that "
              "stopped inside them")
    peak = got["peak"]
    if peak is not None:
        p_err = peak / rec["peak_bytes_per_device"] - 1
        print(f"  {label}: peak predicted "
              f"{rec['peak_bytes_per_device'] / 2**30:.3f} GiB, "
              f"max_memory_allocated {peak / 2**30:.3f} GiB ({p_err:+.2%})")
    dev = "not measured" if device_ms is None else f"{device_ms:.3f} ms"
    print(f"  {label}: roofline bound {bound * 1e3:.3f} ms "
          f"({max(t, key=t.get)}: compute {t['compute'] * 1e3:.3f}, memory "
          f"{t['memory'] * 1e3:.3f}, collective {t['collective'] * 1e3:.3f}"
          f" ms; {rec['bytes_per_device']:.4e} bytes), measured device "
          f"time {dev}; trace {rec['trace_s']} s")
    need(not flops_limit or abs(f_err) <= cfg["flops_rtol"],
         f"{label}: the profiler's FLOPs differ from the dry run's by "
         f"{f_err:+.4%}")
    if peak is not None:
        need(abs(p_err) <= cfg["peak_rtol"], f"{label}: the peak differs "
             f"from the dry run's by {p_err:+.2%}")


def dryrun_group(ctx, cfg: dict) -> dict:
    """The dry-run group (``DRYRUN``): (a) a train step and (b) decode
    steps predicted on a meta (1, 1) mesh and run on a (1, 1) mesh on the
    card; (c) one cell per family on the single mesh, then the
    roofline."""
    from repro_torch.benchmarks import roofline
    from repro_torch.configs import ShapeCell, get
    from repro_torch.core.rng import generator
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.optim import (OptConfig, init_opt_state,
                                           tree_map)
    torch, dev = ctx.torch, ctx.dev
    spec = get(cfg["arch"])
    model = spec.make_model() if cfg["preset"] == "full" else \
        spec.make_smoke()
    vocab = getattr(model.cfg, "lm", model.cfg).vocab
    meta = make_mesh((1, 1), ("data", "model"), device="meta")
    mesh = make_host_mesh(1, 1, device=dev)
    gen = generator(SEED, "chip-smoke-dryrun", device=dev)
    out = {}

    tc = cfg["train"]
    cell = ShapeCell("train", "train", tc["seq_len"], tc["global_batch"])
    phase(f"dryrun (a): {cfg['arch']} ({cfg['preset']}) train step, "
          f"{tc['global_batch']} x {tc['seq_len']} tokens in "
          f"{tc['microbatches']} microbatches on a (1, 1) mesh: the dry "
          f"run's prediction against the step on {dev}")
    rec = dryrun.run_cell(cfg["arch"], cell, meta, "1x1",
                          microbatch=tc["microbatches"], model=model)
    rules = shd.make_rules(mesh, dryrun.sharding_overrides(spec, mesh,
                                                           "train"))
    defs = model.param_defs()
    plain = init_params(defs, SEED, dev)
    params = shd.device_put(plain, shd.named(mesh, param_pspecs(defs,
                                                                rules)))
    del plain
    opt = OptConfig()
    state = init_opt_state(params, opt)
    toks = torch.randint(0, vocab, (tc["global_batch"], tc["seq_len"] + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = steps.make_train_step(model, opt, tc["microbatches"])
    with rules_for(mesh):
        loss0 = float(step(params, state, batch)[2]["loss"])   # warm-up
        got = profiled_step(ctx, lambda: step(params, state, batch))
    print_prediction("(a) train step", rec, got, cfg, got["device_ms"])
    out["train"] = dict(record=rec, measured=got, first_loss=loss0)
    del state, toks
    free(ctx)

    dc = cfg["decode"]
    cell = ShapeCell("decode_32k", "decode", dc["seq_len"], dc["batch"])
    phase(f"dryrun (b): the {cfg['arch']} lane of decode_32k, tokens "
          f"[{dc['batch']}, 1] against a {dc['seq_len']:,}-token cache on a "
          f"(1, 1) mesh: the prediction against {dc['steps']} steps on "
          f"{dev}")
    rec = dryrun.run_cell(cfg["arch"], cell, meta, "1x1", model=model)
    cdefs = model.cache_defs(dc["batch"], dc["seq_len"])
    crules = shd.make_rules(mesh, dryrun.sharding_overrides(spec, mesh,
                                                            "decode"))
    cache = tree_map(lambda d, s: shd.zeros(d.shape, d.dtype,
                                            shd.NamedSharding(mesh, s)),
                     cdefs, param_pspecs(cdefs, crules))
    tokens = torch.randint(0, vocab, (dc["batch"], 1), generator=gen,
                           device=dev, dtype=torch.int32)
    decode = steps.make_lane_decode_step(model, (0, 0))
    cur = dc["seq_len"] - 1
    with rules_for(mesh), torch.no_grad():
        # the step returns the cache rows it wrote: a view of the whole
        # cache, which ``_`` would keep alive past the ``del`` below
        logits = decode(params, cache, tokens, cur)[0]      # warm-up
        need(bool(torch.isfinite(logits).all()) and tuple(logits.shape)
             == (dc["batch"], vocab), "decode gave no finite logits")
        runs = [profiled_step(ctx, lambda: decode(params, cache, tokens,
                                                  cur))
                for _ in range(dc["steps"])]
    device_ms = [r["device_ms"] for r in runs]
    got = dict(runs[-1], peak=max(r["peak"] for r in runs)
               if ctx.on_card else None)
    med = statistics.median(device_ms) if ctx.on_card else None
    print(f"  (b) device time per step {device_ms} ms, median {med}")
    print_prediction("(b) decode step", rec, got, cfg, med,
                      flops_limit=False)
    out["decode"] = dict(record=rec, measured=got, device_ms=device_ms)
    del params, cache
    free(ctx)
    out["split"] = split_phases(ctx, cfg, model, spec, batch, loss0, gen,
                                out["train"]["measured"])
    del batch
    free(ctx)
    out["split"].update(family_split_phases(ctx, cfg, gen))
    free(ctx)

    phase(f"dryrun (c): launch.dryrun on the single mesh for "
          f"{len(cfg['cells'])} cells, then the roofline")
    recs = {}
    for arch, shape in cfg["cells"]:
        rc = dryrun.main(["--mesh", "single", "--arch", arch, "--shape",
                          shape, "--force"])
        need(rc == 0, f"launch.dryrun failed on {arch} / {shape}")
        r = json.loads((dryrun.ART / "single" / f"{arch}__{shape}.json")
                       .read_text())
        vals = [r["flops_per_device"], r["bytes_per_device"],
                r["peak_bytes_per_device"], r["collectives"]["total_bytes"]]
        need(r["ok"] and all(math.isfinite(v) and v > 0 for v in vals),
             f"{arch} / {shape}: an incomplete record {vals}")
        recs[f"{arch}/{shape}"] = r
    roofline.main(["--mesh", "single"])
    out["grid"] = recs
    return {"dryrun": out}


def split_phases(ctx, cfg: dict, model, spec, batch, loss0: float,
                 gen, one: dict) -> dict:
    """(d) and (e) of the dry-run group: the train step and the decode
    lane of (a) and (b) with their compute split over the "model"
    positions of a ``cfg["split"]["mesh"]`` mesh on the card; ``one``:
    (a)'s profile of the step on one position."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.optim import OptConfig, init_opt_state
    torch, dev = ctx.torch, ctx.dev
    sc = cfg["split"]
    d, m = sc["mesh"]
    mesh = make_host_mesh(d, m, device=dev)
    meta = make_mesh((d, m), ("data", "model"), device="meta")
    defs = model.param_defs()
    out = {}

    tc = cfg["train"]
    cell = dryrun.ShapeCell("train", "train", tc["seq_len"],
                            tc["global_batch"])
    phase(f"dryrun (d): the train step of (a) split over a ({d}, {m}) "
          f"mesh's \"model\" positions on {dev}: its first loss against "
          f"(a)'s, the dry run's FLOPs x {m} against the profiler's")
    rec = dryrun.run_cell(cfg["arch"], cell, meta, f"{d}x{m}",
                          microbatch=tc["microbatches"], model=model)
    rules = shd.make_rules(mesh, dryrun.sharding_overrides(
        spec, mesh, "train", model))
    plain = init_params(defs, SEED, dev)
    params = shd.device_put(plain, shd.named(mesh, param_pspecs(defs,
                                                                rules)))
    del plain
    opt = OptConfig()
    state = init_opt_state(params, opt)
    step = steps.make_train_step(model, opt, tc["microbatches"])
    box = {}

    def first_step():
        t0 = time.perf_counter()
        box["loss"] = float(step(params, state, batch)[2]["loss"])
        ctx.sync()
        box["host_ms"] = (time.perf_counter() - t0) * 1e3

    with rules_for(mesh, rules):           # one step, profiled
        got = profiled_step(ctx, first_step)
    loss = box["loss"]
    peak = got["peak"]
    err = abs(loss - loss0)
    print(f"  (d) first loss on the ({d}, {m}) mesh {loss:.6f}, on one "
          f"position {loss0:.6f}: |diff| {err:.3e} (rtol = atol = "
          f"{sc['loss_rtol']})")
    need(err <= sc["loss_atol"] + sc["loss_rtol"] * abs(loss0),
         f"the split step's loss {loss} differs from one position's "
         f"{loss0}")
    pred = rec["flops_per_device"] * m
    f_err = got["flops"] / pred - 1
    print(f"  (d) FLOPs: the dry run's per position "
          f"{rec['flops_per_device']:.6e} x {m} = {pred:.6e}, profiler "
          f"{got['flops']:.6e} ({f_err:+.4%}; matrix products); scheme "
          f"{rec['scheme']!r}; all-reduce "
          f"{rec['collectives']['bytes']['all-reduce']:.4e} B per position")
    n, f = got["aborted"]
    if n:
        print(f"  (d) {n} more product calls ({f:.6e} FLOPs) recorded by "
              "the profiler ran nothing: checkpoint recomputes that stopped "
              "inside them")
    need(abs(f_err) <= sc["flops_rtol"], f"(d): the profiler's FLOPs differ "
         f"from the dry run's x {m} by {f_err:+.4%}")
    ppk = rec["peak_bytes_per_device"]
    print(f"  (d) peak: the dry run's per position {ppk / 2**30:.3f} GiB "
          f"(x {m} = {m * ppk / 2**30:.3f} GiB), max_memory_allocated "
          f"{peak and f'{peak / 2**30:.3f} GiB'} for the {m} positions on "
          f"one card")
    print(f"  (d) the step: host wall {box['host_ms']:.1f} ms (under the "
          f"profiler), device time {got['device_ms']} ms, launches "
          f"{got['launches']} (one position, (a): {one['device_ms']} ms, "
          f"{one['launches']} launches)")
    out["train"] = dict(record=rec, measured=got, loss=loss, loss0=loss0,
                        peak=peak, host_ms=box["host_ms"])
    del state, params, step, box
    free(ctx)

    dc = cfg["decode"]
    ov = production_overrides(spec, model)
    phase(f"dryrun (e): the decode_32k lane of (b) split over the ({d}, "
          f"{m}) mesh's \"model\" positions with the production layout "
          f"{ov}: {sc['decode_steps']} greedy steps from a random "
          f"{dc['seq_len']:,}-token cache against the unsplit lane")
    out["decode"] = split_decode(ctx, "(e)", model, spec, sc, dc["batch"],
                                 dc["seq_len"], gen)
    return out


def family_split_phases(ctx, cfg: dict, gen) -> dict:
    """(f)-(h) of the dry-run group: the SSM's and the VLM's decode lanes
    and the encoder-decoder's train step split over the (1, 4) mesh of
    ``cfg["split"]``, held as (d) and (e) are (``cfg["families"]``)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    torch = ctx.torch
    sc, fc = cfg["split"], cfg["families"]
    d, m = sc["mesh"]
    out = {}

    def make(arch):
        spec = get(arch)
        return spec, (spec.make_model() if cfg["preset"] == "full"
                      else spec.make_smoke())

    c = fc["ssm"]
    spec, model = make(c["arch"])
    phase(f"dryrun (f): the {c['arch']} ({cfg['preset']}) decode lane of "
          f"{c['batch']} rows split over the ({d}, {m}) mesh's \"model\" "
          f"positions with the production layout "
          f"{production_overrides(spec, model)}: {sc['decode_steps']} greedy "
          f"steps from a random window and state against the unsplit lane")
    out["ssm"] = split_decode(ctx, "(f)", model, spec, sc, c["batch"],
                              c["seq_len"], gen, f32_rtol=c["f32_rtol"])

    c = fc["train"]
    spec, model = make(c["arch"])
    mc = model.cfg
    model = type(model)(dataclasses.replace(
        mc, n_enc_layers=min(c["layers"], mc.n_enc_layers),
        n_dec_layers=min(c["layers"], mc.n_dec_layers)))
    out["encdec"] = split_train_phase(ctx, "(g)", model, spec, sc, c, gen,
                                      cfg["preset"])

    c = fc["vlm"]
    spec, model = make(c["arch"])
    lm = model.cfg.lm
    model = type(model)(dataclasses.replace(model.cfg, lm=dataclasses.replace(
        lm, n_layers=min(c["layers"], lm.n_layers))))
    phase(f"dryrun (h): the {c['arch']} ({cfg['preset']}, "
          f"{model.cfg.lm.n_layers} of {lm.n_layers} layers) decode lane of "
          f"{c['batch']} rows split over the ({d}, {m}) mesh's \"model\" "
          f"positions with the production layout "
          f"{production_overrides(spec, model)}: {sc['decode_steps']} greedy "
          f"steps from a random {c['seq_len']:,}-token cache against the "
          f"unsplit lane")
    out["vlm"] = split_decode(ctx, "(h)", model, spec, sc, c["batch"],
                              c["seq_len"], gen, f32_rtol=c["f32_rtol"])
    del model
    free(ctx)

    c = fc["hybrid"]
    spec, model = make(c["arch"])
    # the mesh's own layout: the production mesh's for the full model
    # (32 heads, 32 kv heads and the vocab divide 4 and 16 alike)
    ov = dryrun.sharding_overrides(
        spec, make_host_mesh(d, m, device="meta"), "decode", model)
    phase(f"dryrun (i): the {c['arch']} ({cfg['preset']}) decode lane of "
          f"{c['batch']} rows split over the ({d}, {m}) mesh's \"model\" "
          f"positions with its layout {ov} (the production mesh's "
          f"{production_overrides(spec, model)}): {sc['decode_steps']} "
          f"greedy steps from a random {c['seq_len']:,}-token cache against "
          f"the unsplit lane, in bf16 and float32 (float32 within "
          f"{c['f32_rtol']} of the unsplit lane's largest logit)")
    out["hybrid"] = split_decode(ctx, "(i)", model, spec, sc, c["batch"],
                                 c["seq_len"], gen, f32_rtol=c["f32_rtol"],
                                 overrides=ov)
    free(ctx)
    t = c["train"]
    mc = model.cfg
    model = type(model)(dataclasses.replace(
        mc, n_blocks=min(t["layers"], mc.n_blocks), dtype=torch.float32))
    out["hybrid_train"] = f32_split_train(ctx, "(i)", model, spec, sc, t,
                                          gen, cfg["preset"])
    return out


def f32_split_train(ctx, label: str, model, spec, sc: dict, c: dict, gen,
                    preset: str) -> dict:
    """A float32 train step of ``model`` on random tokens from ``gen``, on
    one position and split over the (1, M) mesh of ``sc`` (the same
    weights and batch): the split's loss against one position's within
    ``c["loss_rtol"]`` of it (float32 cross-split sums accumulate in
    float64 on both sides, so the two should be equal), the split step's
    profiler FLOPs against M x the dry run's per-position count within
    ``c["flops_rtol"]``, ``max_memory_allocated`` beside M x the dry run's
    per-position peak; host wall, device time and launches of both."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.optim import OptConfig, init_opt_state
    torch, dev = ctx.torch, ctx.dev
    d, m = sc["mesh"]
    b, s, mb = c["global_batch"], c["seq_len"], c["microbatches"]
    mc = model.cfg
    phase(f"dryrun {label}: the {spec.arch_id} ({preset}, {mc.n_blocks} "
          f"blocks) float32 train step, {b} x {s} tokens in {mb} "
          f"microbatch(es), on one position and split over a ({d}, {m}) "
          f"mesh's \"model\" positions on {dev}: the loss against one "
          f"position's, the dry run's FLOPs x {m} against the profiler's")
    print(f"  {label} device memory allocated at the start: {held(ctx)}")
    defs = model.param_defs()
    toks = torch.randint(0, mc.vocab, (b, s + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = OptConfig()
    runs = {}
    for name, shape in (("one", (1, 1)), ("split", (d, m))):
        msh = make_host_mesh(*shape, device=dev)
        rules = shd.make_rules(msh, dryrun.sharding_overrides(
            spec, msh, "train", model))
        params = shd.device_put(init_params(defs, SEED, dev), shd.named(
            msh, param_pspecs(defs, rules)))
        state = init_opt_state(params, opt)
        step = steps.make_train_step(model, opt, mb)
        box = {}

        def first_step():
            t0 = time.perf_counter()
            box["loss"] = float(step(params, state, batch)[2]["loss"])
            ctx.sync()
            box["host_ms"] = (time.perf_counter() - t0) * 1e3

        with rules_for(msh, rules):
            got = profiled_step(ctx, first_step)
        runs[name] = dict(got, **box)
        peak = got["peak"]
        print(f"  {label} {name}: loss {box['loss']:.7f}, host wall "
              f"{box['host_ms']:.1f} ms (under the profiler), device time "
              f"{got['device_ms']} ms, launches {got['launches']}, FLOPs "
              f"{got['flops']:.6e}, max_memory_allocated "
              f"{peak and f'{peak / 2**30:.3f} GiB'}")
        del params, state, step, box
        free(ctx)
    rec = dryrun.run_cell(spec.arch_id, ShapeCell("train", "train", s, b),
                          make_mesh((d, m), ("data", "model"),
                                    device="meta"),
                          f"{d}x{m}", microbatch=mb, model=model)
    one, split = runs["one"]["loss"], runs["split"]["loss"]
    err = abs(split - one)
    print(f"  {label} float32 loss split {split!r}, one position {one!r}: "
          f"{'equal' if split == one else f'|diff| {err:.3e}'} (allowed "
          f"{c['loss_rtol']} x |one|)")
    need(err <= c["loss_rtol"] * abs(one),
         f"{label}: the float32 split step's loss {split} differs from one "
         f"position's {one}")
    got = runs["split"]
    conv = rec["conv_flops_per_device"]
    pred = (rec["flops_per_device"] - conv) * m
    f_err = got["flops"] / pred - 1
    print(f"  {label} FLOPs: the dry run's per position "
          f"{rec['flops_per_device']:.6e}, less its convolutions' "
          f"{conv:.6e} (the profiler counts matrix products only), x {m} = "
          f"{pred:.6e}, profiler {got['flops']:.6e} ({f_err:+.4%}); scheme "
          f"{rec['scheme']!r}; all-reduce "
          f"{rec['collectives']['bytes']['all-reduce']:.4e} B per position")
    n, f = got["aborted"]
    if n:
        print(f"  {label} {n} more product calls ({f:.6e} FLOPs) recorded by "
              "the profiler ran nothing: checkpoint recomputes that stopped "
              "inside them")
    need(rec["scheme"] == dryrun.SCHEME_SPLIT and abs(f_err) <= c[
        "flops_rtol"], f"{label}: the profiler's FLOPs differ from the dry "
         f"run's x {m} by {f_err:+.4%} ({rec['scheme']})")
    ppk, peak = rec["peak_bytes_per_device"], got["peak"]
    print(f"  {label} peak: the dry run's per position {ppk / 2**30:.3f} GiB "
          f"(x {m} = {m * ppk / 2**30:.3f} GiB), max_memory_allocated "
          f"{peak and f'{peak / 2**30:.3f} GiB'} for the {m} positions on "
          f"one card")
    return dict(record=rec, runs=runs, loss_err=err, flops_err=f_err,
                peak=peak)


def split_train_phase(ctx, label: str, model, spec, sc: dict, c: dict,
                      gen, preset: str) -> dict:
    """A train step of ``model`` (the encoder-decoder: the batch's frames
    drawn from ``gen``) on one position, then split over the (1, M) mesh
    of ``sc``, each in bf16 and in float32 (the same weights and batch
    upcast): the split loss in float32 within the mesh group's tolerances
    of one position's, in bf16 within the larger of those and
    ``floor_factor`` x one position's own bf16 noise (its loss in bf16
    against float32); the dry run's per-position FLOPs x M against the
    profiler's (the bf16 split step); the per-position peak x M beside
    ``max_memory_allocated``.  The random full-width model is chaotic past
    a few layers (PERF.md §6), so ``c["layers"]`` cuts its depth."""
    import dataclasses

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.optim import OptConfig, init_opt_state, tree_map
    torch, dev = ctx.torch, ctx.dev
    d, m = sc["mesh"]
    arch, mb = c["arch"], c["microbatches"]
    b, s = c["global_batch"], c["seq_len"]
    mc = model.cfg
    phase(f"dryrun {label}: the {arch} ({preset}) train step, {b} rows of "
          f"{mc.n_frames} frames and {s} tokens in {mb} microbatch(es), on "
          f"one position and split over a ({d}, {m}) mesh's \"model\" "
          f"positions on {dev}, in bf16 and float32: the loss against one "
          f"position's, the dry run's FLOPs x {m} against the profiler's")
    print(f"  {label} device memory allocated at the start: {held(ctx)}")
    defs = model.param_defs()
    toks = torch.randint(0, mc.vocab, (b, s + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    frames = 0.1 * torch.randn((b, mc.n_frames, mc.d_model), generator=gen,
                               device=dev)
    models = {False: model, True: type(model)(dataclasses.replace(
        mc, dtype=torch.float32))}
    opt = OptConfig()
    one, split = make_host_mesh(1, 1, device=dev), make_host_mesh(
        d, m, device=dev)
    losses, walls = {}, {}
    for name, msh, wide in (("one", one, False), ("split", split, False),
                            ("one", one, True), ("split", split, True)):
        key = name + (" float32" if wide else "")
        mdl = models[wide]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "frames": frames.to(mdl.cfg.dtype)}
        rules = shd.make_rules(msh, dryrun.sharding_overrides(
            spec, msh, "train", mdl))
        params = shd.device_put(tree_map(
            lambda t: t.float() if wide and t.is_floating_point() else t,
            init_params(defs, SEED, dev)), shd.named(
                msh, param_pspecs(defs, rules)))
        state = init_opt_state(params, opt)
        step = steps.make_train_step(mdl, opt, mb)
        box = {}

        def first_step():
            t0 = time.perf_counter()
            box["loss"] = float(step(params, state, batch)[2]["loss"])
            ctx.sync()
            box["host_ms"] = (time.perf_counter() - t0) * 1e3

        with rules_for(msh, rules):
            if key == "split":
                got = profiled_step(ctx, first_step)
            else:
                first_step()
        losses[key], walls[key] = box["loss"], box["host_ms"]
        del params, state, step, batch
        free(ctx)
    cell = ShapeCell("train", "train", s, b)
    rec = dryrun.run_cell(arch, cell, make_mesh((d, m), ("data", "model"),
                                                device="meta"),
                          f"{d}x{m}", microbatch=mb, model=model)

    def tol(ref: float) -> float:
        return sc["loss_atol"] + sc["loss_rtol"] * abs(ref)
    one32 = losses["one float32"]
    noise = abs(losses["one"] - one32)
    allowed32 = tol(one32)
    allowed = max(tol(losses["one"]), sc["floor_factor"] * noise)
    err32 = abs(losses["split float32"] - one32)
    err = abs(losses["split"] - losses["one"])
    print(f"  {label} losses: {json.dumps(losses)}")
    print(f"  {label} float32: |split - one| {err32:.3e}, allowed "
          f"{allowed32:.3e} (rtol = atol = {sc['loss_rtol']}); bf16: |split "
          f"- one| {err:.3e}, allowed {allowed:.3e} (the larger of those and "
          f"{sc['floor_factor']} x one position's |bf16 - float32| "
          f"{noise:.3e})")
    need(err32 <= allowed32, f"{label}: in float32 the split step's loss "
         f"{losses['split float32']} differs from one position's {one32} "
         f"by more than {allowed32}")
    need(err <= allowed, f"{label}: the split step's bf16 loss "
         f"{losses['split']} differs from one position's {losses['one']} "
         f"by more than {allowed}")
    pred = rec["flops_per_device"] * m
    f_err = got["flops"] / pred - 1
    print(f"  {label} FLOPs: the dry run's per position "
          f"{rec['flops_per_device']:.6e} x {m} = {pred:.6e}, profiler "
          f"{got['flops']:.6e} ({f_err:+.4%}; matrix products); scheme "
          f"{rec['scheme']!r}; all-reduce "
          f"{rec['collectives']['bytes']['all-reduce']:.4e} B per position")
    n, f = got["aborted"]
    if n:
        print(f"  {label} {n} more product calls ({f:.6e} FLOPs) recorded by "
              "the profiler ran nothing: checkpoint recomputes that stopped "
              "inside them")
    need(abs(f_err) <= sc["flops_rtol"], f"{label}: the profiler's FLOPs "
         f"differ from the dry run's x {m} by {f_err:+.4%}")
    ppk, peak = rec["peak_bytes_per_device"], got["peak"]
    print(f"  {label} peak: the dry run's per position {ppk / 2**30:.3f} GiB "
          f"(x {m} = {m * ppk / 2**30:.3f} GiB), max_memory_allocated "
          f"{peak and f'{peak / 2**30:.3f} GiB'} for the {m} positions on "
          f"one card")
    print(f"  {label} the bf16 split step: host wall {walls['split']:.1f} ms "
          f"(under the profiler), device time {got['device_ms']} ms, launches "
          f"{got['launches']}; unprofiled host walls: one position "
          f"{walls['one']:.1f} ms, float32 one {walls['one float32']:.1f} / "
          f"split {walls['split float32']:.1f} ms")
    return dict(record=rec, measured=got, losses=losses, noise=noise,
                allowed=allowed, allowed32=allowed32, peak=peak,
                host_ms=walls)


def production_overrides(spec, model) -> dict:
    """The dry run's decode overrides for the production mesh's "model"
    axis of 16 (the layout a (1, M) lane on the card takes)."""
    from repro_torch.launch import dryrun

    class Production:
        shape = {"data": 16, "model": 16}
    return dryrun.sharding_overrides(spec, Production, "decode", model)


def split_decode(ctx, label: str, model, spec, sc: dict, b: int, smax: int,
                 gen, f32_rtol: float | None = None,
                 overrides=None) -> dict:
    """A decode lane of ``model`` split over the (1, M) mesh of ``sc`` with
    the production mesh's layout, against the unsplit lane on the same
    weights and random cache (``b`` rows, ``smax`` of them for a KV cache):
    ``sc["decode_steps"]`` greedy steps, the split lane fed the unsplit
    lane's tokens; tokens equal but at ties; its logits within the larger
    of ``logits_atol`` and ``floor_factor`` x the unsplit lane's own noise:
    its difference when its first step runs row by row and (``f32_rtol``
    given) its difference at each step from the same lane in float32 (the
    same weights and cache upcast, fed the same tokens).  With
    ``f32_rtol`` the split lane in float32 is held to the unsplit one in
    float32 too, within that share of the unsplit lane's largest |logit|
    at each step (float32 cross-split sums accumulate in float64 on both
    sides, so the two should be equal), and the steps whose logits are
    equal are counted.  ``overrides``:
    the layout (default the production mesh's, ``production_overrides``).
    The cache leaves a step rewrites whole (an SSM's window and state: no
    "kv_seq" rows) are put back before each run.  Prints host wall, device
    time and launches per step."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.runtime.optim import tree_leaves, tree_map
    torch, dev = ctx.torch, ctx.dev
    print(f"  {label} device memory allocated at the start: {held(ctx)}")
    d, m = sc["mesh"]
    n = sc["decode_steps"]
    f32 = f32_rtol is not None
    ov = production_overrides(spec, model) if overrides is None else \
        overrides
    defs = model.param_defs()
    vocab = getattr(model.cfg, "lm", model.cfg).vocab
    one, mesh = make_host_mesh(1, 1, device=dev), make_host_mesh(d, m,
                                                                 device=dev)
    rules = {"unsplit": (one, shd.make_rules(one, ov)),
             "split": (mesh, shd.make_rules(mesh, ov))}
    plain = init_params(defs, SEED, dev)
    cdefs = model.cache_defs(b, smax)

    def random_leaf(dd):
        t = torch.empty(dd.shape, dtype=dd.dtype, device=dev)
        for i in range(dd.shape[0]):
            t[i] = torch.randn(dd.shape[1:], generator=gen, device=dev,
                               dtype=torch.float32).to(dd.dtype)
        return t
    caches = {False: tree_map(random_leaf, cdefs)}
    models = {False: model}
    if f32:
        def up(t):
            return t.float() if t.is_floating_point() else t
        caches[True] = tree_map(up, caches[False])
        cfg, f32_of = model.cfg, torch.float32
        models[True] = type(model)(
            dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm,
                                                            dtype=f32_of))
            if hasattr(cfg, "lm") else dataclasses.replace(cfg, dtype=f32_of))
    # the leaves a step rewrites whole (an SSM's window and state: no
    # "kv_seq" rows), put back before each run
    whole = [i for i, dd in enumerate(tree_leaves(cdefs))
             if "kv_seq" not in dd.axes]
    pristine = {k: [tree_leaves(c)[i].clone() for i in whole]
                for k, c in caches.items()}

    def restore(wide):
        leaves = tree_leaves(caches[wide])
        for i, p in zip(whole, pristine[wide]):
            leaves[i].copy_(p)

    def views(wide, msh, rl, rows=slice(None)):
        """The cache's ``rows`` as ``ShardedTensor``s of ``msh`` whose
        shards are views of it (the lanes share its memory)."""
        specs = param_pspecs(cdefs, rl)
        return tree_map(lambda t, sp: shd.ShardedTensor(
            shd.NamedSharding(msh, sp), tuple(t.shape), t.dtype, {
                c: t[shd.local_slices(shd.NamedSharding(msh, sp), t.shape,
                                      c)] for c in msh.positions()}),
            tree_map(lambda t, dd: t[(slice(None),) * dd.axes.index(
                "batch") + (rows,)], caches[wide], cdefs), specs)
    tokens = torch.randint(0, vocab, (b, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    start = smax - n
    runs, fed, floor = {}, None, (0.0, 0.0)
    order = [("unsplit", False), ("split", False)] + (
        [("unsplit", True), ("split", True)] if f32 else [])
    with torch.no_grad():
        for kind, wide in order:
            name = kind + (" float32" if wide else "")
            msh, rl = rules[kind]
            mdl = models[wide]
            # leaf by leaf: a float32 copy of the whole tree beside its
            # shards would not fit for zamba2-7b
            params = tree_map(lambda t, sh: shd.put(
                t.float() if wide and t.is_floating_point() else t, sh),
                plain, shd.named(msh, param_pspecs(defs, rl)))
            cache = views(wide, msh, rl)
            decode = steps.make_lane_decode_step(mdl, (0, 0))
            restore(wide)
            with rules_for(msh, rl):
                t, logits, walls = tokens, [], []
                for i in range(n):
                    t0 = time.perf_counter()
                    lg, _ = decode(params, cache, t, start + i)
                    ctx.sync()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    logits.append(lg.float())
                    # every lane is fed the unsplit lane's tokens, so a
                    # tie broken the other way does not fork the runs
                    t = (fed[i] if fed else
                         lg.argmax(-1, keepdim=True).to(torch.int32))
                prof = profiled_step(ctx, lambda: decode(
                    params, cache, t, start + n - 1))
            if fed is None:
                fed = [lg.argmax(-1, keepdim=True).to(torch.int32)
                       for lg in logits]
                # the unsplit lane's own noise: its first step again, row
                # by row (cuBLAS's accumulation order at one row)
                restore(wide)
                with rules_for(msh, rl):
                    alone = torch.cat([decode(
                        params, views(wide, msh, rl, slice(r, r + 1)),
                        tokens[r:r + 1], start)[0].float() for r in range(b)])
                dl = (alone - logits[0]).abs()
                floor = (float(dl.max()), float(dl.mean()))
                print(f"  {label} unsplit, its first step row by row: logits "
                      f"max |diff| {floor[0]:.4e}, mean {floor[1]:.4e} (its "
                      f"largest |logit| {float(logits[0].abs().max()):.3f})")
            runs[name] = dict(logits=logits, walls=walls, prof=prof)
            print(f"  {label} {name}: host wall per step "
                  f"{[round(w, 2) for w in walls]} ms; a profiled step: "
                  f"device time {prof['device_ms']} ms, launches "
                  f"{prof['launches']}, FLOPs {prof['flops']:.6e}")
            del params, cache
            free(ctx)

    def diffs(a: str, w: str) -> list:
        return [float((x - y).abs().max()) for x, y in
                zip(runs[a]["logits"], runs[w]["logits"])]
    gaps = (diffs("unsplit", "unsplit float32") if f32 else [0.0] * n)
    allowed = [max(sc["logits_atol"], sc["floor_factor"] * max(floor[0], g))
               for g in gaps]
    same, ties, errs, means = 0, 0, diffs("split", "unsplit"), []
    for i, (a, w) in enumerate(zip(runs["split"]["logits"],
                                   runs["unsplit"]["logits"])):
        means.append(float((a - w).abs().mean()))
        top = w.topk(2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        differ = a.argmax(-1) != w.argmax(-1)
        if not bool(differ.any()):
            same += 1
            continue
        # a row whose two best unsplit logits lie within the step's logit
        # difference has no greedy token to agree on: a tie
        tied = bool((margin[differ] <= 2 * errs[i]).all())
        ties += tied
        print(f"  {label} step {i}: tokens differ in rows "
              f"{differ.nonzero()[:, 0].tolist()}; the unsplit lane's top-2 "
              f"margin there {margin[differ].tolist()} (max logit |diff| "
              f"{errs[i]:.4e}: {'a tie' if tied else 'NOT a tie'})")
    print(f"  {label} {n} steps, the split lane fed the unsplit lane's "
          f"tokens: logits max |split - unsplit| per step "
          f"{[f'{e:.4e}' for e in errs]}, mean "
          f"{[f'{e:.4e}' for e in means]}; allowed "
          f"{[f'{e:.4e}' for e in allowed]} (the larger of "
          f"{sc['logits_atol']} and {sc['floor_factor']} x the unsplit "
          f"lane's own noise: its row-by-row difference"
          f"{', its difference from float32 per step' if f32 else ''}); "
          f"greedy tokens equal at {same} of {n} steps, {ties} ties")
    need(all(e <= a for e, a in zip(errs, allowed)) and same + ties == n,
         f"{label}: the split lane's decode differs from the unsplit lane's "
         f"({errs}, allowed {allowed}; tokens equal at {same} of {n} steps, "
         f"{ties} ties)")
    res = dict(logits_err=max(errs), steps_equal=same, ties=ties,
               floor=floor, allowed=allowed, overrides=ov,
               **{k: dict(walls=v["walls"], device_ms=v["prof"][
                   "device_ms"], launches=v["prof"]["launches"])
                  for k, v in runs.items()})
    if f32:
        e32 = diffs("split float32", "unsplit float32")
        whole32 = runs["unsplit float32"]["logits"]
        a32 = [f32_rtol * float(w.abs().max()) for w in whole32]
        rule = f"{f32_rtol} x the unsplit float32 lane's largest |logit|"
        equal = sum(bool(torch.equal(a, w)) for a, w in zip(
            runs["split float32"]["logits"], whole32))
        print(f"  {label} float32: logits max |split - unsplit| per step "
              f"{[f'{e:.4e}' for e in e32]}, allowed "
              f"{[f'{e:.4e}' for e in a32]} ({rule}); equal at {equal} of "
              f"{n} steps")
        res["f32_equal"] = equal
        need(all(e <= a for e, a in zip(e32, a32)), f"{label}: in float32 "
             f"the split lane differs from the unsplit lane by {e32} "
             f"(allowed {a32})")
        res["f32_err"], res["bf16_gap"] = max(e32), gaps
    del caches, pristine, plain, runs
    free(ctx)
    return res


def free(ctx) -> None:
    """Drop what the last group left, so the next one has the card."""
    gc.collect()
    if ctx.on_card:
        ctx.torch.cuda.empty_cache()


def held(ctx) -> str:
    """The device memory allocated now (what a phase starts with)."""
    if not ctx.on_card:
        return "not measured (no card)"
    return f"{ctx.torch.cuda.memory_allocated() / 2**30:.3f} GiB"


def run(torch, dev, preset: str = "full", grid: dict = GRID,
        table1: dict = TABLE1, table1_calib=None,
        quickstart: dict = QUICKSTART, simra: dict = SIMRA,
        dense_cfg: dict = DENSE, sense_shapes=SENSE_SHAPES,
        calib_shapes=CALIB_SHAPES, fleet_argv=FLEET_ARGV,
        recal=RECAL, gemma: dict = GEMMA, deepseek: dict = DEEPSEEK,
        monitor: dict = MONITOR,
        figures: dict = FIGURES, tune_batches=TUNE_BATCHES,
        weight_bits: int = WEIGHT_BITS, fleet: dict = FLEET,
        families: dict = FAMILIES, train: dict = TRAIN,
        mesh: dict = MESH, dryrun: dict = DRYRUN, only=None) -> dict:
    """The groups of phases (``GROUPS``, all of them unless ``only`` names
    some) on ``dev``.  ``main`` runs them all on the GPU at full width; a
    CPU rehearsal (``dev`` cpu, smoke preset, small grids and Table-I
    scales) runs the same control flow through the plain versions, without
    the launch-count checks and the library yardstick."""
    from repro_torch.kernels import (build, calib_iter, placed_gemm,
                                     plane_gemm, sense)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    groups = GROUPS
    if only is not None:
        need(set(only) <= set(GROUPS),
             f"unknown groups {sorted(set(only) - set(GROUPS))}")
        groups = tuple(g for g in GROUPS if g in set(only))
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kernels = {"calib_iter": calib_iter.calib_iter,
               "gemm_placed": placed_gemm.gemm_placed,
               "gemv_placed": placed_gemm.gemv_placed,
               "gemm": plane_gemm.gemm, "gemv": plane_gemm.gemv,
               "majx_sense": sense.majx_sense}

    if on_card:
        phase("build")
        t0 = time.perf_counter()
        libs = build.build_all()
        print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
              f"under {build.build_dir().relative_to(ROOT)}")
        for name in build.SOURCES:
            kernel = ""
            for line in build.ptxas_report(name).splitlines():
                if "Function properties for" in line:
                    kernel = kernel_name(line.split()[-1])
                elif "Used" in line or "spill" in line:
                    print(f"  {name} {kernel}: {line.strip()}")

    ctx = row_context(torch, dev, kernels, sync)
    rows, out = Rows(), {}
    drive = {
        "main": lambda: main_group(ctx, rows, preset, grid, recal, monitor,
                                   tune_batches, weight_bits),
        "papers": lambda: papers_group(ctx, rows, table1, table1_calib,
                                       quickstart, simra, dense_cfg,
                                       sense_shapes, calib_shapes,
                                       fleet_argv, figures),
        "gemma": lambda: gemma_group(ctx, rows, gemma),
        "deepseek": lambda: deepseek_group(ctx, rows, deepseek),
        "fleet": lambda: fleet_group(ctx, rows, fleet),
        "families": lambda: families_group(ctx, rows, families),
        "train": lambda: train_group(ctx, train),
        "mesh": lambda: mesh_group(ctx, rows, mesh),
        "dryrun": lambda: dryrun_group(ctx, dryrun),
    }
    for g in groups:
        out.update(drive[g]())
        free(ctx)

    phase("kernel rows: every shape against its plain version, timed")
    out["rows"] = rows.assemble()
    for r in [e for row in out["rows"]
              for e in [row] + row.get("extra_shapes", [])]:
        bb, bo = r["bound_by_bytes_ms"], r["bound_by_ops_ms"]
        r["bound_ms"] = max(bb, bo)
        r["bound_by"] = "bytes" if bb >= bo else "operations"
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "n/a")
        print(f"  {r.get('name', '  (extra)'):<12s} {r['shape']}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max |err| {r['max_abs_err']}")
        if r.get("floor_ms") is not None:
            print(f"      floor: an empty kernel timed the same way "
                  f"{r['floor_ms']:.4f} ms")
        if r.get("plan"):
            print(f"      plan: {r['plan']}")
    out["phase_walls_s"] = end_phases()
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    try:
        out = run(torch, torch.device("cuda"))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {**{k: r[k] for k in keys},
         "shape": r["shape"],
         **({"plan": r["plan"]} if r.get("plan") else {}),
         **({"floor_ms": r["floor_ms"]} if r.get("floor_ms") else {}),
         **({"extra_shapes": [{k: e[k] for k in (
             "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "layout", "launches", "plan")
             if k in e and (k != "plan" or e[k])}
             for e in r["extra_shapes"]]}
            if "extra_shapes" in r else {})}
        for r in out["rows"]]}
    print(f"  total wall {time.perf_counter() - t0:.1f}s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""On-card smoke run of can_tpu_torch: the quickest proof that the port
builds, serves and trains on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero; nothing is printed as a result then):

1. build    — compile csrc/context_fused.cu and csrc/bn_moments.cu from
              the checkout, one nvcc each, in parallel; ptxas registers
              and spills; per kernel function, the count of tensor-core
              instructions (HMMA/HGMMA) in ``cuobjdump -sass`` of the
              built library (the bf16 context GEMM must have some);
2. kernels  — each kernel against its plain PyTorch version on the card:
              the context kernel at the full feature map of the largest
              serving bucket (8, 96, 128, 512), the training map (8, 72,
              96, 512) and a ragged (2, 47, 61, 512), timed beside one
              cuBLAS ``fv @ Wcat`` in the working dtype (``products_ms``:
              the yardstick for its products alone, never called by the
              port); every device kernel of one context call (the Wcat
              permutation, Q, the main launch) by ``torch.profiler``.
              Then the BN kernels at every distinct BN shape of the (8,
              576, 768) training step, with bucket padding and a fill slot
              in the mask, f32 and bf16: the forward (one device kernel
              per call, sums against the plain version, bitwise
              repeatable) and the backward ``MomentSums.backward`` (the
              backward kernel against its plain twin, bitwise
              repeatable), each with its device time per call
              (``torch.profiler``), its single-call CUDA-event time, its
              bound, the share of the bound reached and its host time per
              call; at the largest layer also the forward's plain version
              and ``torch.var_mean`` (unmasked, the nearest library
              call), the backward's plain twin and the plain recompute it
              replaced; and both kernels checked at a ragged (3, 37, 51,
              128), whose pixel count is not a multiple of 4;
3. serving  — a reference-layout .pth of seeded He-scaled normal weights
              (``random_state_dict(he=True)``: gates that vary, counts of
              order one and up) is served by the port's CLI path
              (``cli.serve.build_service`` at its defaults: the priced
              sub-batch menu and flush; default ladder, --max-batch 8,
              --u8-warmup) over HTTP on an ephemeral port in f32, bf16 and
              int8: one request per ladder cell (non-/8 sizes, u8 and
              host-normalised bodies, one asking for the density map),
              then a burst of 32 requests at 768x1024 from a separate
              client process.  Warmup runs buckets x menu x dtypes
              signatures and traffic adds none.
              Every answer must be finite and match the same engine run
              with the plain-version seam, and that engine's counts must
              move by many tolerances when the gate matrices are zeroed
              (so the check sees the kernel's products).  int8: the weights
              stay int8 on the card (the memory an int8 engine adds is at
              most 1.05 x its int8 parameter bytes, an f32 engine's at
              least 3 x), its counts are graded against f32's on the
              parity ladder, and the per-launch dequantisation is timed.
              Then one f32 service at one bucket: ``[serve] sched`` (every
              flush of 1..8 requests launches the core's parts, each of
              ``cover_one(valid)`` slots, predicted cost == realized; the
              burst's p50/p99 and fill under the priced flush against the
              timer and against the service without the core, bf16,
              reported); ``[serve] streams`` (~30 frames of one
              stream over HTTP, a replayed frame_seq answered 409, a burst
              on the stream faster than it drains answered partly from
              the session's count EWMA — labelled degraded, with
              staleness — without a launch); ``[serve] swap``
              (``swap_params`` to a second seeded weight set: no new
              signature, counts equal a fresh engine's, another dtype's
              tree refused).  The context kernel's launch counter must
              equal the batches all these services ran;
4. training — a synthetic PNG dataset (20 train items mixed from 576x768,
              560x744 and 480x640, 8 test items) is trained by the port's
              CLI path (``cli.train.train``: --syncBN --bn-impl kernel
              --batch-size 8 --pad-multiple 64 --no-remnant-batches, one
              epoch of 3 steps with
              bucket padding and fill slots, eval, checkpoint) in f32 and
              in bf16; the BN forward and backward kernels must each
              launch 16 times per step and the context kernel once per
              step and per eval batch.  Then one step on a fixed batch
              with the kernel against the same step with ``onepass`` (loss,
              running stats and the update of all weights), every BN
              layer's kernel sums held against the plain version at the
              layer's real input, the step's time split (forward,
              backward, optimizer), and a ``torch.profiler`` device-time
              profile of one more warm step (the top 15 kernels; the BN
              forward, BN backward and context kernels' sums; the device's
              idle share of that step: the share of the span from its first
              to its last device activity in which no kernel, copy or
              memset ran);
5. auto     — the train CLI at its defaults (``--pad-multiple auto``,
              ``--max-buckets 24``) on a wild synthetic set (40 train and
              12 test items over 35 sizes from 448x576 to 576x768: a
              ladder), one whole epoch, f32 and bf16: the BN kernels
              launch 16 times per step of the planned schedule, the
              context kernel once per step and per eval batch;
6. eval     — ``cli.test`` on that run's checkpoint with its batching,
              f32 and bf16: MAE and MSE equal to the train CLI's last eval
              within 1e-6 relative, one context launch per eval batch (and
              one for ``--show-index 0``, whose three PNGs ``read_png``
              reads back at their shapes); one eval epoch timed at
              prefetch depth 0 and 2 (reported);
7. serve    — ``cli.serve`` from that ``--checkpoint-dir`` with
              ``--syncBN``, the bucket at test image 0's snapped shape:
              the count equals the sum of phase 6's density map, f32
              within 1e-5, bf16 within 2e-2;
8. planner  — the numbers behind ``cli/common.py``'s constants: the
              train step's peak memory at (4, 576, 768) and (8, 576, 768)
              for the BN and the plain model, with and without remat, f32
              and bf16, fitted as fixed bytes + bytes per pixel and checked
              at (6, 768, 1024); the step's Mpx/s; one launch's cost by
              ``measure_launch_cost_mpx``; the ``max_launch_pixels`` that
              results, which must agree with every fit within 10% (stale
              constants fail), admit every launch phase 5 trains, and, in
              f32 with remat, let a step at 95% of it run; a step at 115%
              is tried and its outcome printed;
slice 6, in this order after phase 3 (phases 4-8 run after it):
   determinism — the kernels against their plain versions with
              ``fill_uninitialized_memory`` on; the op deterministic mode
              refuses (ATen's adaptive-pool backward); the BN train step
              (3 steps at the fixed (8, 576, 768) batch: padding, a fill
              slot) trained twice from one seed with each setting —
              PyTorch's defaults (the path before this phase),
              ``cudnn.deterministic`` alone, the matrix pool alone,
              ``use_deterministic()`` — f32 and bf16, every parameter,
              momentum buffer and running stat compared bitwise (the last
              must repeat); step ms with the settings off, on, and on with
              the memory fill; 2 epochs of the train CLI against 1 epoch,
              a checkpoint and a resume of 1 (``--allow-config-change``),
              bitwise.  From here on every phase runs under
              ``use_deterministic()``;
   remat    — one BN step with remat on against off, f32 and bf16: loss,
              gradients and running stats bitwise equal, each BN layer's
              count advanced once, launches per step (32 BN forward, 16
              backward, 2 context with remat), step ms and peak memory;
              an f32 step above the no-remat cap and under the remat cap;
   s2d      — the folded stem conv against the plain one (f32 rel 1e-5,
              bf16 2e-2) and the BN model's forward with it at the model
              tolerance, and the train step ms of each;
   vgg16    — the train CLI with ``--vgg16-npz`` on a seeded .npz, one
              step at lr 0: the checkpoint's frontend is the file's;
   (then phases 5-8, and) legacy — a ``--plan-mode legacy`` auto epoch,
              and ``python -m can_tpu_torch.tools.plan_ablation`` (cost
              against legacy on a seeded histogram; every plan's
              predicted cost equal to its schedule's);
   prepare  — ``can_tpu_torch.tools.prepare_data --prepared`` on seeded
              ShanghaiTech ``.mat`` data (PNG images), ``--verify-store``,
              and one auto epoch of the train CLI from that store;
   golden   — tests/test_golden.py's recipe (10 epochs, batch 8, the
              plain model) against its JAX goldens: f32 within 1%, bf16
              reported against 5%;
slice 9, right after phase 3 (before slice 6's phases):
   fleet    — the serving fleet (``serve/fleet.py``) with two replicas on
              the one card: devices [cuda:0] x 2 of a scale universe
              [cuda:0] x 3 (a replica owns a slot, not a device), one
              bucket at 384x512, the default menu, the He weights.  The
              replicas time-slice the card: a correctness check, whose
              times say nothing of two GPUs.  ``python -m
              can_tpu_torch.cli.serve --replicas 2`` is refused by the
              card count before any weights load; a clean burst of 48
              requests in f32 and bf16 (all answered, both replicas serve,
              no new signature, every replica active with 0 failures,
              counts equal a single engine's: f32 rel 1e-5, bf16 2e-2);
              ``CAN_TPU_FAULTS`` replica_crash at replica 0's batch 2 (the
              batch redispatched once, nothing lost, memory_allocated
              falls by at least the replica's parameter bytes at the
              quarantine, resurrection at the current generation after a
              0.5 s cooldown); replica_hang of 3 s at replica 1 with a
              0.5 s watchdog (wedged; the batch served by the survivor
              within the deadline + 1 s); rollout under a steady stream in
              f32 and bf16 (0 rejected, generation 1 everywhere, no new
              signature, lone requests after the flip bitwise equal to a
              fresh engine's); add_replica then remove_replica under
              traffic (0 dropped; time to first ready, new signatures,
              and a fresh engine's first launch against steady state per
              signature); an Autoscaler (max 3) up on bursts and down on
              idle (0 dropped).  In every fleet window the context
              kernel's launches equal the fleet engines' predicts
              (warmups, batches, probes, staging, scale-ups); the burst's
              p50/p99 and images/s for 1 against 2 replicas are reported
              beside the card's name and power limit;
slice 11, right after fleet:
   obs      — telemetry on the serving path (``obs/``), through the serve
              CLI's own stack (``parse_args`` -> ``validate_incident_args``
              -> ``build_telemetry`` -> ``build_service``) on cuda:0 at
              [serve]'s 384x512 bucket, f32, the He weights.  Window (a):
              ``--telemetry-dir --metrics-port 0 --slo-spec slo_spec.json
              --incident-dir --telemetry-heartbeat-s 1`` against the same
              service with telemetry off, 48 requests one at a time over
              HTTP each: counts bitwise equal, context launches = the
              engines' predicts, no new signature after warmup; the JSONL
              has one ``run``, one ok ``serve.request`` per request, a
              ``serve.batch`` per batch, a ``request`` span per request
              with its four children inside it, a heartbeat; ``/metrics``
              parses as Prometheus text with
              ``can_tpu_serve_completed_total`` 48; ``serve_p99_deadline``
              graded and not burning; ``report.summarize`` counts 48; the
              p50/p99 on against off and the JSONL bytes per request
              reported.  Window (b): a two-replica fleet on cuda:0 with
              ``--incident-dir`` under ``replica_crash`` (replica 0, batch
              2): 0 lost, exactly one ``fleet_quarantine`` bundle written
              manifest last, its memory snapshot's cuda:0 row with
              ``bytes_in_use`` > 0, its ``serve_stats`` showing the
              quarantine, its ring holding the ``fleet.replica`` event;
              then a spec whose p99 bound is half the fastest request of
              window (a) burns (``slo.burn``, ``can_tpu_slo_alerting`` on
              the GaugeSink) and an Autoscaler handed that sink adds a
              replica with reason ``autoscale:slo_burn``.  Slice 12: window
              (a)'s telemetry arms the cost ledger, so its JSONL holds
              ``perf.summary`` at warmup, every 32 batches and at close
              with ``serve_predict`` rows (flops, bytes, roofline, MFU),
              every ``compile`` event the first call's flops and bytes, and
              ``/metrics`` after the close ``can_tpu_mfu_weighted``; the
              same CLI at ``--serve-dtype bf16`` (8 requests) prices its
              ledger at the bf16 peak, and its MFU at close lies in (0, 1);
slice 14, right after obs:
   aot      — the cold start of a serving process, each a fresh
              interpreter running the serve CLI's path (``parse_args`` ->
              ``build_service``, fleet mode: two replicas on the one card,
              the default ladder, --max-batch 8, f32, the He weights),
              one after another: with an empty ``--compile-cache`` (nvcc
              builds the kernel library), with that cache warm and
              ``--aot-bake``, and with an empty cache and ``--aot-bundle``
              (nvcc made to fail).  Each start split: the interpreter,
              ``import torch``, ``torch.cuda.is_available()``, the
              package's imports, the CUDA context, the cuDNN and cuBLAS
              handles, the kernel
              library, the weights (file read, ``torch.load``, check),
              the engines, the warmup (its first launches against the
              same grid warmed again), the first answered request.  The
              bundle process takes the library from the bundle with an
              empty cache, every warmup launch is an AOT hit (no
              first-seen signature), its counts of 8 requests are bitwise
              the cold and warm processes'; bundles stale on
              torch_version, kernel_sources and max_batch are refused
              naming the axis; time to first ready reported for the cold
              build, the warm cache and the bundle;
slice 12, right after phase 4's training:
   obs_train — the device side of telemetry on the train and eval CLIs:
              80 synthetic train images, 40 at 576x768 and 40 at 512x640
              (batch 8: each shape 5 steps, a first call and 4 timed), the
              train CLI (BN model, --bn-impl kernel, one epoch and its
              eval) with ``--telemetry-dir --trace-steps 2:4 --profile-dir
              --metrics-port 0`` against the same run with telemetry off,
              f32 and bf16: weights, momentum and running statistics
              bitwise equal, the kernels' launches equal, the epoch's
              ``perf.summary`` with ``train_step`` rows at both shapes (MFU
              and a roofline class at (8, 576, 768)), the trace holding
              exactly 2 optimizer steps and 2 x 16 records of each BN
              kernel (every launch without a record is logged by its
              place: the profiler's warm-up); the MFU, the ledger's
              launch-cost fit, the epoch times and the steady-state step
              medians on and off (CUDA
              events at each step's start) reported.  The eval CLI on that
              checkpoint
              with the same flags against off: MAE and MSE within 1e-6,
              launches equal, ``eval_step`` rows, a trace;
slice 7, last:
   ddp      — data parallelism on the one card.  World 1 over NCCL: the
              train CLI under ``torchrun --standalone --nproc_per_node=1``
              (3 steps of the smoke's training schedule at batch 8,
              eval, checkpoint), its checkpoint and eval metrics bitwise
              equal to the same run with no process group, then DDP's step
              overhead at world 1 (DDP against the plain step, in turns).
              World 2 over gloo, both ranks on cuda:0 (NCCL refuses two
              ranks on one GPU; ``--ddp-worker`` starts a rank): 4 images
              per rank, one step per case (f32, f32 with remat, bf16)
              against world 1 at 8 images (the loss and the update of all
              weights, gated), both ranks and a second world-2 run bitwise
              equal, remat bitwise equal to the plain step, launches per
              rank exact; the first world-2 run builds the kernels from
              nothing in both ranks at once (the build time per rank); the
              eval CLI at world 2 against world 1 (MAE and MSE within
              1e-6).  gloo's times measure correctness, not NCCL's speed;
slice 10, after ddp:
   sp       — spatial parallelism on the one card (``parallel/spatial.py``):
              two gloo ranks on cuda:0 split the fixed batch's rows (sp=2;
              the halo through pinned host buffers), one step per case
              (f32, f32 remat, bf16) against world 1 (the loss and the
              update of all weights, [ddp]'s gates), both ranks and a
              second run bitwise equal, remat bitwise equal to the plain
              step, launches per rank exact (BN forward 16, 32 with remat;
              backward 16; context 1, 2 with remat); the halo's exchanges
              and bytes and the pooled all-reduces per step; the context
              kernel on each shard's rows of a (8, 72, 96, 512) map against
              ``reference_context`` on them; the step's halo exchanges
              replayed alone; one (1, 2048, 2048) BN f32 image's step ms
              and peak memory at sp=1 and per rank at sp=2; the eval CLI at
              ``--sp 2`` against world 1 (MAE and MSE within 1e-6); a dp=2 x
              sp=2 step of four ranks at (4, 256, 320) against world 1
              (rank = d * sp + s);
slice 13, after sp:
   elastic  — elastic shrink-and-continue through the train CLI
              (``--elastic-dir --elastic-check-every 1``, BN model,
              ``--bn-impl kernel``, 24 synthetic images at 256x320 and
              224x288, 2 per rank): two gloo ranks on cuda:0, rank 1
              SIGTERMed by ``CAN_TPU_FAULTS`` at a seeded step, f32 and bf16
              side by side (their shrinking runs at once, then their cold
              restarts): the leaver exits 143; the survivor re-forms at
              world 1 on cuda:0, trains the remainder and evaluates; one
              ``elastic.transition``; consumed and remaining items
              partition the epoch; a cold restart at world 1 from the
              directory as the shrink left it is bitwise equal (every
              tensor of the checkpoint, the step, the epoch's loss, MAE,
              MSE); launches per rank exact (BN forward and backward 16 a
              step, context one a step and eval batch); the stages' times
              (SIGTERM, agreement, shrink checkpoint, barrier,
              re-formation, restore, first step) against the cold leg's
              launch to first step, split (the interpreter, torch, the
              device query, the imports, the CUDA context, the CLI's validation
              and runtime, its loop's imports, the mesh, the datasets, the
              memory agreement, the plan, the model, the kernel libraries,
              the restore, the first step).  Slice 14 adds, side by side
              with those, four gloo ranks on cuda:0 at dp=2 x sp=2
              (``--sp 2``), rank 1 SIGTERMed: ranks 0 and 1 (its
              replica) exit 143, ranks 2 and 3 re-form at (1, 2) and equal
              a cold restart at two ranks bitwise, f32 and bf16, by the
              same gates (launches per rank exact: BN 16 a step, context
              one a step and eval batch);
9. report   — the card's name and power limit (nvidia-smi's own line), a
              ``kernels`` JSON line,
              and last the result line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --ddp-worker SPEC`` is one rank of the ddp or sp
phase (the phase starts it; SPEC is the JSON the phase writes).
``python3 chip_smoke.py --obs-only`` runs the build and the obs and
obs_train phases alone;
``python3 chip_smoke.py --sp-only`` runs the build and the sp phase alone;
``python3 chip_smoke.py --sp-nccl``, on a machine with 4 GPUs, runs the
build and the sp steps over NCCL with one rank per GPU (dp=1 x sp=2 on two,
with step times, the halo replayed alone and the UCF-scale image; dp=2 x
sp=2 on four), each against world 1 on cuda:0 by the sp phase's gates.
``python3 chip_smoke.py --elastic-only`` runs the build and the elastic
phase alone, ``--aot-only`` the build and the aot phase; ``python3
chip_smoke.py --elastic-nccl``, on a machine with 4 GPUs, runs the build,
DDP with SyncBN over NCCL at world 2 and 4 (one rank per GPU, each world
twice) against world 1 on cuda:0 by the ddp phase's gates with the step's
ms at each world, the train CLI's shrink from 4 NCCL ranks to 3 with rank
0 (the checkpoint writer and coordinator) leaving, bitwise equal to a cold
restart at world 3 on three cards, and the shrink from dp=2 x sp=2 to
(1, 2) with rank 1 leaving (rank 0 with it), bitwise equal to a cold
(1, 2) world on two cards.  Ranks
are started one process each with their rendezvous variables, never by
torchrun, whose agent would stop the survivors when the leaver exits 143.
None of these prints a result line.

``python3 chip_smoke.py --measure-only`` runs the build and the timings of
phases 2 and 4 that reach the kernels only through interfaces older
versions of the port share (``moment_sums_cuda``, ``MomentSums``, the
train step) — the BN table (``bn_time``) and the step split and profile
(``step_breakdown``) — and no check, no serving, no result line: copied
into an older checkout, it times that checkout's kernels by this
script's methods, in the same chip call as this one.  The card's peaks
come from the checkout's ``cli/common.py`` table (PR 12 on; an older
checkout has none and is refused).

Imports torch, numpy, the standard library and ``can_tpu_torch`` — no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

# the cold-start split's stamps: this script's first line, torch imported,
# torch.cuda.is_available() answered (main sets the last two)
T_SCRIPT = time.time()
T_TORCH = T_AVAIL = None

ROOT = Path(__file__).resolve().parent
SEED = 0
LADDER = ((384, 512, 768), (512, 768, 1024))
MAX_BATCH = 8
BURST = 32
# kernel vs plain version: f32 differs only in summation order; bf16
# rounds the contrast to bf16 before the product (the TPU kernel's rule)
# and the output to bf16 — the bounds of tests/test_pallas_context.py
TOL = {"f32": (1e-5, 1e-5), "bf16": (2e-2, 1e-2)}  # (rtol, atol)
# served count vs the plain-version seam, relative to the count
COUNT_RTOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 1e-4}
# serving dtypes driven end to end, and the image dtypes each warms
SERVE_DTYPES = ("f32", "bf16", "int8")
# int8 residency: the memory an int8 engine adds against its parameter
# bytes (allocator rounding of ~60 small tensors fits in the 5%), and the
# least an f32 engine must add against the same figure
INT8_RESIDENT_MAX, F32_RESIDENT_MIN = 1.05, 3.0
# the one-bucket f32 service of [serve] sched / streams / swap
SLICE8_BUCKET = (384, 512)
STREAM_FRAMES, STREAM_BURST = 30, 24
# swap: served counts against a fresh engine on the new weights
SWAP_RTOL = 1e-6
# the gate products must move the served counts by more than this many
# tolerances (median over requests), or the parity check could not see them
GATE_EFFECT = 5
# BN moment sums vs their plain version: s1, s2 within this fraction of
# sum|y m| and sum y^2 m per channel (f32 summation order only: bf16 is
# widened exactly on both sides); s0 exact
BN_RTOL = 1e-5
# every distinct BN input of a training step at (8, 576, 768), with the
# number of the step's 16 BN layers that take it
BN_STEP_SHAPES = (((8, 576, 768, 64), 2), ((8, 288, 384, 128), 2),
                  ((8, 144, 192, 256), 3), ((8, 72, 96, 512), 6),
                  ((8, 72, 96, 256), 1), ((8, 72, 96, 128), 1),
                  ((8, 72, 96, 64), 1))
# a BN input off the step's shapes: 5661 pixels, not a multiple of 4, so
# the forward's ring copies m's last pixel by hand
BN_RAGGED_SHAPE = (3, 37, 51, 128)
# BN backward kernel vs its plain twin m (g1 + 2 g2 y): f32 only rounding
# order may differ; bf16 one rounding of the result to bf16
BWD_RTOL = {"f32": 1e-6, "bf16": 2 ** -7}
# one step with the kernel vs with onepass: the update (new - old) of all
# weights together, in relative L2 norm.  The two differ in f32 rounding
# only (summation order, the gradient's formula); a wrong BN gradient
# moves the update by O(1).  One parameter's own update can differ far
# more where its gradient is a small sum of cancelling terms (a BN
# scale): the per-parameter worst is reported beside the same figure for
# twopass vs onepass, the f32 noise of two correct plain steps
UPDATE_RTOL = 1e-2
# training phase: the dataset, the CLI's batch and the kernel-vs-onepass step
TRAIN_SIZES = ((576, 768), (560, 744), (480, 640))
TRAIN_ITEMS, TEST_ITEMS = 20, 8
TRAIN_BATCH, TRAIN_PAD, TRAIN_STEPS = 8, 64, 3
BN_LAYERS = 16  # 10 frontend + 6 backend
# one step with the kernel vs the same step with onepass: loss and new
# running stats (f32; sums differ only in summation order)
STEP_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"[smoke] FAIL: {msg}")
    sys.exit(1)


def peaks_for(name: str) -> dict:
    """The card's published dense peaks (FLOP/s by dtype, bytes/s) from
    the port's one peak table, ``cli.common.device_peaks_for_kind`` (the
    cost ledger's); a card missing from it is refused.  A checkout older
    than that table (PR 12) has none: --measure-only there fails here."""
    try:
        from can_tpu_torch.cli.common import device_peaks_for_kind
    except ImportError:
        fail("this checkout's can_tpu_torch.cli.common has no peak table "
             "(device_peaks_for_kind)")
    p = device_peaks_for_kind(name)
    if p is None:
        fail(f"no peaks recorded for {name!r} in cli/common.py's table")
    return {"f32": p.flops_f32, "bf16": p.flops_bf16, "bytes": p.hbm_bytes_s}


def time_ms(fn, reps: int = 10) -> float:
    """Warm median of CUDA-event timings of single calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps: int = 50) -> float:
    """Host time per call, in microseconds, of ``reps`` calls launched back
    to back (the launches queue; one synchronize at the end, outside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def sass_mma_counts(so: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per kernel function in the
    SASS of a built library, by ``cuobjdump -sass`` from the toolkit that
    built it; fails when cuobjdump is missing."""
    import re

    from can_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        fail(f"cuobjdump not found next to nvcc ({tool})")
    proc = subprocess.run([str(tool), "-sass", so], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {so} failed: {proc.stderr.strip()[-2000:]}")
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    if not counts:
        fail(f"cuobjdump -sass {so} listed no kernel function")
    return counts


def _readable(name: str) -> str:
    """``context_q_kernel<bf16>`` from a kernel name, mangled (cuobjdump)
    or demangled (the profiler)."""
    import re

    m = (re.search(r"(?<=\d)((?:context|bn)_[a-z0-9_]*[a-z])", name)
         or re.search(r"((?:context|bn)_[a-z0-9_]*[a-z])(?=[<(])", name))
    base = m.group(1) if m else name
    if re.search(r"[a-z](I13__nv_bfloat16E|INS_4Bf16E|<__nv_bfloat16>|<[^>]*Bf16>)", name):
        base += "<bf16>"
    elif re.search(r"[a-z](If[EL]|<float[,>])", name):
        base += "<f32>"
    return base


def phase_build():
    from can_tpu_torch.ops import _build, cuda_bn, cuda_context

    _build.load_kernel_libraries([cuda_context.KERNEL, cuda_bn.KERNEL])
    cuda_context.load_library()
    cuda_bn.load_library()
    for name in (cuda_context.KERNEL, cuda_bn.KERNEL):
        info = _build.build_info[name]
        log(f"[build] {name}: {info['seconds']:.2f}s "
            f"{info['source']} -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   ptxas: {line.strip()}")
        counts = sass_mma_counts(info["path"])
        for fn, n in sorted(counts.items()):
            log(f"[build]   sass: {_readable(fn)}: {n} HMMA/HGMMA")
        if name == cuda_context.KERNEL:
            tc = [n for fn, n in counts.items() if "context_gemm_bf16_kernel" in fn]
            if not tc or tc[0] == 0:
                fail(f"the bf16 context GEMM has no tensor-core instruction in "
                     f"its SASS ({counts})")


def _bound(flops: float, nbytes: float, peak_flops: float, peaks: dict):
    """The least time for ``flops`` at ``peak_flops`` and ``nbytes`` at the
    card's memory rate: (ms, "operations" or "bytes")."""
    by_ops = flops / peak_flops * 1e3
    by_bytes = nbytes / peaks["bytes"] * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def context_bound(fv, avew, uh, wmat, peaks: dict):
    """Least time for the context tail on these inputs: the kernel's work
    as the cost ledger counts it (``cuda_context.tail_cost``: the four
    gate products, the row interpolation and the elementwise work; each
    input read once and fi written once) at the peak of fv's dtype.
    Returns (ms, "operations" or "bytes", FLOP, bytes)."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc

    flops, nbytes = cc.tail_cost(fv, avew, uh, wmat)
    peak = peaks["bf16" if fv.dtype == torch.bfloat16 else "f32"]
    return (*_bound(flops, nbytes, peak, peaks), flops, nbytes)


CONTEXT_SHAPES =((8, 96, 128, 512), (8, 72, 96, 512), (2, 47, 61, 512))


def _device_us(ev) -> float:
    """An event's device time in microseconds (the attribute's name
    changed across PyTorch versions)."""
    t = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0) if t is None else t


def device_kernels(fn, reps: int = 5, attempts: int = 3):
    """Every device kernel that ``fn`` runs, over ``reps`` warm calls, by
    torch.profiler (CUPTI): ``[(name, ms per call, launches per call)]``
    and the summed ms per call.  On the card a profile now and then loses
    a kernel's record (4 of 5 launches seen) or all of them: a kernel's ms
    per call is its mean time per recorded launch times its launches per
    call (recorded / reps, rounded), and a profile that recorded nothing
    is taken again, up to ``attempts`` profiles; then it fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue  # host-side operators: their device time is their kernels'
            if _device_us(ev) > 0:
                per_call = max(1, round(ev.count / reps))
                rows.append((_readable(ev.key)[:60],
                             _device_us(ev) / ev.count * per_call / 1e3, per_call))
        if rows:
            return sorted(rows), sum(r[1] for r in rows)
        log(f"[profile] profile {attempt + 1} of {attempts} recorded no device "
            f"time; taking it again")
    fail(f"torch.profiler recorded no device time in {attempts} profiles")


def launch_split(fn, reps: int = 5) -> str:
    """Device time per call of every device kernel that ``fn`` runs, with
    their sum: for a context call the Wcat permutation copy, the Q launch
    and the main launch."""
    rows, total = device_kernels(fn, reps)
    if not rows:
        return "the profiler saw no device time"
    return (f"{', '.join(f'{n} {ms:.3f} ms' for n, ms, _ in rows)}; "
            f"sum {total:.3f} ms")


def phase_kernels(peaks: dict) -> dict:
    """Kernel vs plain version at every shape and dtype, beside one cuBLAS
    product ``fv @ Wcat`` (products_ms); returns the kernels-line numbers
    (times at the full-size shape in f32, the worst error over every
    check)."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    worst = 0.0
    for shape in CONTEXT_SHAPES:
        b, h, w, c = shape
        fv32 = torch.randn(shape, generator=g, device="cuda")
        aves32 = [torch.randn((b, s, s, c), generator=g, device="cuda")
                  for s in cc.SCALES]
        # gate weights ~ N(0, 1/C): logits of order one, the sigmoid's range
        ws32 = [torch.randn((c, c), generator=g, device="cuda") / c ** 0.5
                for _ in cc.SCALES]
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            fv = fv32.to(dt)
            aves = [a.to(dt) for a in aves32]
            avew, uh, wmat = cc.pack_inputs(fv, aves, [x.to(dt) for x in ws32], (h, w))
            got = cc.context_tail_cuda(fv, avew, uh, wmat)
            torch.cuda.synchronize()
            want = cc.context_tail_reference(fv, avew, uh, wmat)
            rtol, atol = TOL[name]
            diff = (got.float() - want.float()).abs()
            max_abs = float(diff.max())
            limit = atol + rtol * want.float().abs()
            if not bool(torch.isfinite(got.float()).all()):
                fail(f"context_fused {shape} {name}: non-finite output")
            if not bool((diff <= limit).all()):
                fail(f"context_fused {shape} {name}: max abs err {max_abs:.3e} "
                     f"exceeds rtol {rtol} / atol {atol}")
            worst = max(worst, max_abs)
            ms = time_ms(lambda: cc.context_tail_cuda(fv, avew, uh, wmat))
            plain_ms = time_ms(lambda: cc.context_tail_reference(fv, avew, uh, wmat))
            # the products alone in cuBLAS: the yardstick, not the port's path
            fv2d, wcat = fv.reshape(-1, c), cc.wcat_from(wmat)  # (C, 4C)
            products_ms = time_ms(lambda: torch.matmul(fv2d, wcat))
            bound, by, flops, nbytes = context_bound(fv, avew, uh, wmat, peaks)
            log(f"[kernel] context_fused {shape} {name}: max abs err "
                f"{max_abs:.3e} max rel err "
                f"{max_abs / max(float(want.float().abs().max()), 1e-30):.3e} "
                f"(rtol {rtol}, atol {atol}) | kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, products_ms (cuBLAS fv @ Wcat) "
                f"{products_ms:.3f} ms | bound {bound:.3f} ms ({by}: "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
                f"{100 * bound / ms:.1f}% of bound | "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
            if shape == CONTEXT_SHAPES[0]:
                log(f"[kernel] context_fused {shape} {name} launches "
                    f"(torch.profiler, per call): "
                    f"{launch_split(lambda: cc.context_tail_cuda(fv, avew, uh, wmat))}")
            rows[(shape, name)] = {"ms": ms, "plain_ms": plain_ms,
                                   "products_ms": products_ms,
                                   "bound_ms": bound, "bound_by": by}
            del got, want, diff, limit, wcat
    full = rows[(CONTEXT_SHAPES[0], "f32")]
    return {"max_abs_err": worst, **full,
            "bf16_ms": rows[(CONTEXT_SHAPES[0], "bf16")]["ms"]}


# BURST concurrent POSTs of one .npy body (?raw=1), stdlib only; prints
# {"wall": s, "lat": [s, ...], "server": [[latency_ms, queue_wait_ms], ...],
#  "errors": [...]} as its last line
# (http.client with TCP_NODELAY, as curl and urllib3 set it: urllib.request's
# urlopen adds ~40 ms per request here, serialised across threads)
BURST_CLIENT = r"""
import http.client, json, math, socket, sys, threading, time
port, n, body = int(sys.argv[1]), int(sys.argv[2]), open(sys.argv[3], "rb").read()
lat, server, errors = [], [], []
def client():
    t0 = time.perf_counter()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.request("POST", "/predict?raw=1", body=body)
        r = conn.getresponse()
        res = json.loads(r.read())
        conn.close()
        if r.status != 200:
            errors.append(f"HTTP {r.status}: {res}")
        elif not math.isfinite(res["count"]):
            errors.append("non-finite count")
        else:
            server.append([res["latency_ms"], res["queue_wait_ms"]])
    except Exception as e:
        errors.append(repr(e))
    lat.append(time.perf_counter() - t0)
threads = [threading.Thread(target=client) for _ in range(n)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join(600)
print(json.dumps({"wall": time.perf_counter() - t0, "lat": lat,
                  "server": server, "errors": errors}))
"""


def _post(port: int, arr: np.ndarray, query: str) -> dict:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict?{query}",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            fail(f"HTTP {r.status} for {arr.shape}")
        return json.loads(r.read())


def burst(port: int, path: Path) -> dict:
    """BURST concurrent raw POSTs of one .npy body from a separate client
    process (client work does not share the server's GIL); fails unless
    every one is answered."""
    proc = subprocess.run(
        [sys.executable, "-c", BURST_CLIENT, str(port), str(BURST), str(path)],
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"burst client failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["errors"] or len(out["lat"]) != BURST:
        fail(f"burst: {len(out['lat'])}/{BURST} answered, errors "
             f"{out['errors'][:3]}")
    lat = sorted(out["lat"])
    out["p50_ms"] = statistics.median(lat) * 1e3
    out["p99_ms"] = float(np.percentile(lat, 99)) * 1e3
    return out


def expected_signatures(service, buckets: int, dtypes: int) -> int:
    return buckets * len(service.stats()["sched"]["menu"]) * dtypes


def serve_one(pth: Path, serve_dtype: str) -> dict:
    """Build the CLI service at its defaults and serve HTTP traffic;
    returns the service (still holding its engine), the requests sent
    with their counts, and the batches run."""
    from can_tpu_torch.cli import serve as cli
    from can_tpu_torch.serve import serve_http

    args = cli.parse_args(["--torch-pth", str(pth), "--max-batch", str(MAX_BATCH),
                           "--u8-warmup", "--serve-dtype", serve_dtype,
                           "--port", "0", "--deadline-ms", "120000"])
    service = cli.build_service(args)
    warm_batches = service.engine.compile_count
    cells = [(hb, wb) for hb in LADDER[0] for wb in LADDER[1]]
    want = expected_signatures(service, len(cells), 2)
    if warm_batches != want:
        fail(f"{serve_dtype}: warmup ran {warm_batches} signatures, want "
             f"buckets x menu x dtypes = {want}")
    rng = np.random.default_rng(SEED + 1)
    sent = []
    with service:
        httpd = serve_http(service, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            # one request per ladder cell, just under the cell's bounds and
            # off the /8 grid; odd cells ship raw u8 bytes (device normalise)
            for i, (hb, wb) in enumerate(cells):
                img = rng.integers(0, 256, (hb - 5, wb - 3, 3), dtype=np.uint8)
                raw = i % 2 == 1
                dens = i == 0
                q = "raw=1" if raw else "raw=0"
                res = _post(port, img, q + ("&density=1" if dens else ""))
                if tuple(res["bucket"]) != (hb, wb):
                    fail(f"{img.shape} served in bucket {res['bucket']}, "
                         f"want {(hb, wb)}")
                if not np.isfinite(res["count"]):
                    fail(f"non-finite count for {img.shape}")
                if dens:
                    d = np.asarray(res["density"], np.float64)
                    if d.shape != ((hb - 5) // 8, (wb - 3) // 8) \
                            or not np.isfinite(d).all() \
                            or not np.isclose(d.sum(), res["count"], rtol=1e-3,
                                              atol=1e-30):
                        fail(f"density map {d.shape} inconsistent with count")
                sent.append((img, raw, res["count"]))
            # burst: BURST concurrent clients at the largest bucket
            body = pth.parent / "burst_768x1024.npy"
            np.save(body, rng.integers(0, 256, (768, 1024, 3), dtype=np.uint8))
            b = burst(port, body)
        finally:
            httpd.shutdown()
            httpd.server_close()
    stats = service.stats()
    if stats["rejected"]:
        fail(f"{serve_dtype}: {stats['rejected']} requests rejected")
    if stats["compile_count"] != warm_batches:
        fail(f"{serve_dtype}: traffic ran {stats['compile_count'] - warm_batches}"
             f" new signatures after warmup")
    if stats["sched"]["cost_mismatches"]:
        fail(f"{serve_dtype}: {stats['sched']['cost_mismatches']} batches "
             f"launched another size than the core predicted")
    in_server = statistics.median(x[0] for x in b["server"])
    queued = statistics.median(x[1] for x in b["server"])
    log(f"[serve] {serve_dtype}: {len(sent)} requests over {len(cells)} ladder "
        f"cells ok; burst {BURST} x 768x1024: p50 latency {b['p50_ms']:.1f} ms, "
        f"{BURST / b['wall']:.2f} images/s ({stats['batches']} batches served, "
        f"{warm_batches} warmup = {len(cells)} buckets x menu "
        f"{tuple(stats['sched']['menu'])} x 2 image dtypes; launches by size "
        f"{stats['sched']['launches_by_size']})")
    # client latency = before submit (upload, body parse) + queue wait +
    # batch (assembly, predict_batch, resolve) + response; medians
    log(f"[serve] {serve_dtype} burst p50 split: {b['p50_ms'] - in_server:.1f} ms "
        f"before submit and in the response, {queued:.1f} ms queued, "
        f"{in_server - queued:.1f} ms in its batch")
    return {"service": service, "sent": sent,
            "batches": warm_batches + stats["batches"]}


def breakdown(run: dict, serve_dtype: str, kernel_ms: float) -> None:
    """Where one full batch's time goes at 768x1024: ``predict_batch``
    wall time (host assembly excluded; H2D, forward, count fetch) against
    the forward on a device-resident batch, and the context kernel's
    share of that forward (its time from the kernels phase)."""
    import torch

    from can_tpu_torch.data import pad_batch
    from can_tpu_torch.train.steps import normalize_on_device

    engine = run["service"].engine
    img = np.zeros((768, 1024, 3), np.uint8)
    batch = pad_batch([(img, np.zeros((96, 128, 1), np.float32))] * MAX_BATCH,
                      (768, 1024), MAX_BATCH, [True] * MAX_BATCH, 8)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.predict_batch(batch)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with torch.inference_mode():
        x = normalize_on_device(torch.from_numpy(batch.image).cuda(),
                                torch.from_numpy(batch.pixel_mask).cuda())
        fwd = time_ms(lambda: engine.forward(x), reps=5)
    log(f"[breakdown] {serve_dtype} batch 8x768x1024: predict_batch "
        f"{wall:.1f} ms = forward {fwd:.1f} ms (context kernel {kernel_ms:.1f} "
        f"ms, {100 * kernel_ms / fwd:.1f}%) + H2D/fetch/host "
        f"{wall - fwd:.1f} ms")


def _no_gates(fv, aves, weights, hw):
    """The plain seam with zero gate matrices: every gate sigmoid(0) = 0.5,
    which is all a kernel that skipped its products could compute."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc

    return cc.reference_context(fv, aves, [torch.zeros_like(w) for w in weights],
                                hw)


def check_parity(run: dict, serve_dtype: str) -> None:
    """Every served count against the same engine with the plain seam, and
    proof that the check can see the kernel's gate products: without them
    the counts move by many tolerances."""
    from can_tpu_torch.data import pad_batch
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.serve import prepare_image

    engine = run["service"].engine
    batcher = run["service"].batcher
    tol = COUNT_RTOL[serve_dtype]
    worst, effects = 0.0, []
    for img, raw, count in run["sent"]:
        x = prepare_image(img, normalize=not raw)
        h, w = x.shape[:2]
        dm = np.zeros((h // 8, w // 8, 1), np.float32)
        batch = pad_batch([(x, dm)], batcher.bucket_of((h, w)), MAX_BATCH,
                          [True], 8)
        engine.model.context_fused = cc.reference_context
        want = float(engine.predict_batch(batch)[0][0])
        engine.model.context_fused = _no_gates
        flat = float(engine.predict_batch(batch)[0][0])
        if abs(want) < 1.0:
            fail(f"{serve_dtype} {img.shape}: count {want!r} is trivially "
                 f"small — the weights do not exercise the model")
        rel = abs(count - want) / abs(want)
        worst = max(worst, rel)
        effects.append(abs(flat - want) / abs(want))
        if rel > tol:
            fail(f"{serve_dtype} {img.shape}: served count {count!r} vs plain "
                 f"seam {want!r} (rel {rel:.2e} > {tol})")
    effect = statistics.median(effects)
    if effect < GATE_EFFECT * tol:
        fail(f"{serve_dtype}: the gate products move the counts by only "
             f"{effect:.2e} (median rel), under {GATE_EFFECT} x the tolerance "
             f"{tol}: the parity check could not see them")
    log(f"[parity] {serve_dtype}: {len(run['sent'])} served counts match the "
        f"plain-version engine, worst rel diff {worst:.2e} (tolerance {tol}); "
        f"without the gate products they would move by {min(effects):.2e} to "
        f"{max(effects):.2e} (median {effect:.2e})")
    engine.release_buffers()


def _post_status(port: int, arr: np.ndarray, query: str):
    """POST one .npy body; returns (HTTP status, JSON body), errors too.
    http.client with TCP_NODELAY: urllib.request adds ~40 ms a request."""
    import http.client
    import io
    import socket

    buf = io.BytesIO()
    np.save(buf, arr)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.request("POST", f"/predict?{query}", body=buf.getvalue())
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


class Events:
    """The services' telemetry seam: records ``emit(kind, **payload)``."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))

    def of(self, kind, since: int = 0) -> list:
        return [p for k, p in self.events[since:] if k == kind]


def check_residency(pth: Path) -> None:
    """int8 stays int8 on the card: the device memory an int8 engine adds
    is its int8 parameter bytes (within allocator rounding), an f32
    engine's about four times that."""
    import torch

    from can_tpu_torch.serve import ServeEngine, param_bytes
    from can_tpu_torch.utils.torch_import import load_torch_checkpoint

    def requested() -> int:
        # the bytes tensors asked for, before the allocator's block sizes
        return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)

    sd = load_torch_checkpoint(str(pth))
    grew = {}
    for dt in ("int8", "f32", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # fresh segments: the same blocks each run
        m0, r0 = torch.cuda.memory_allocated(), requested()
        engine = ServeEngine(sd, device="cuda", serve_dtype=dt)
        torch.cuda.synchronize()
        grew[dt] = (torch.cuda.memory_allocated() - m0, requested() - r0,
                    param_bytes(engine.params))
        engine.release_buffers()
        del engine
    d8, req8, pb8 = grew["int8"]
    if d8 > INT8_RESIDENT_MAX * pb8 or req8 > INT8_RESIDENT_MAX * pb8:
        fail(f"int8 engine added {d8} bytes of device memory ({req8} "
             f"requested) for {pb8} parameter bytes (> {INT8_RESIDENT_MAX} "
             f"x): not int8-resident")
    if grew["f32"][0] < F32_RESIDENT_MIN * pb8:
        fail(f"f32 engine added only {grew['f32'][0]} bytes, under "
             f"{F32_RESIDENT_MIN} x the int8 parameter bytes {pb8}")
    log(f"[serve] int8 residency: building the engine adds {d8} bytes of "
        f"device memory (memory_allocated; {req8} requested by its tensors) "
        f"for {pb8} int8 parameter bytes ({d8 / pb8:.4f} x / "
        f"{req8 / pb8:.4f} x, limit {INT8_RESIDENT_MAX}); f32 adds "
        f"{grew['f32'][0]} ({grew['f32'][1]} requested; "
        f"{grew['f32'][0] / pb8:.3f} x int8's parameter bytes, at least "
        f"{F32_RESIDENT_MIN}), bf16 {grew['bf16'][0]} ({grew['bf16'][1]})")


def int8_report(runs: dict) -> None:
    """int8's served counts against f32's on the parity ladder (the same
    requests), and the per-launch dequantisation on the card."""
    import torch

    from can_tpu_torch.serve.quant import dequantize_tree, grade_parity

    c32 = [c for _, _, c in runs["f32"]["sent"]]
    c8 = [c for _, _, c in runs["int8"]["sent"]]
    deltas = [abs(a - b) / max(abs(b), 1.0) for a, b in zip(c8, c32)]
    worst = max(deltas)
    grade = grade_parity(worst)
    if grade == "fail":
        fail(f"int8 counts move {worst:.3e} (relative) from f32's: off the "
             f"parity ladder")
    engine = runs["int8"]["service"].engine
    with torch.inference_mode():
        deq_ms = time_ms(lambda: dequantize_tree(engine.params, "int8"))
    # the bytes one dequantisation must move: int8 + scales in, f32 out
    q = [v for v in engine.params.values() if isinstance(v, dict)]
    moved = sum(v["q"].numel() * 5 + v["scale"].numel() * 4 for v in q)
    log(f"[serve] int8 parity ladder vs f32 over {len(deltas)} requests: worst "
        f"rel count delta {worst:.6f}, mean {statistics.mean(deltas):.6f} -> "
        f"grade '{grade}' (serve <= 2e-2, loose <= 1e-1; gated: not 'fail')")
    log(f"[serve] int8 dequantisation per launch: {deq_ms:.4f} ms for "
        f"{len(q)} weights ({moved / 1e6:.2f} MB moved: {moved / deq_ms / 1e6:.1f} "
        f"GB/s)")


def slice8_service(pth: Path, telemetry=None, bucket=SLICE8_BUCKET,
                   extra=()):
    from can_tpu_torch.cli import serve as cli

    args = cli.parse_args(["--torch-pth", str(pth), "--max-batch",
                           str(MAX_BATCH), "--bucket-shapes",
                           f"{bucket[0]}x{bucket[1]}", "--port", "0",
                           "--deadline-ms", "120000", *extra])
    return cli.build_service(args, telemetry=telemetry)


def serve_sched(pth: Path) -> int:
    """Every flush of n = 1..MAX_BATCH requests at one bucket launches the
    core's parts, each of ``cover_one(valid)`` slots, with predicted ==
    realized cost; warmup runs bucket x menu x dtype signatures and
    traffic adds none.  Returns the batches run."""
    from can_tpu_torch.sched import costs_match
    from can_tpu_torch.serve import prepare_image

    tel = Events()
    svc = slice8_service(pth, tel)
    warm = svc.engine.compile_count
    if warm != expected_signatures(svc, 1, 1):
        fail(f"[serve] sched: warmup ran {warm} signatures, want "
             f"{expected_signatures(svc, 1, 1)}")
    sched = svc.sched
    h, w = SLICE8_BUCKET
    rng = np.random.default_rng(SEED + 3)
    imgs = [prepare_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for _ in range(MAX_BATCH)]
    rows = []
    for n in range(1, MAX_BATCH + 1):
        since = len(tel.events)
        tickets = [svc.submit(imgs[i]) for i in range(n)]
        svc.batcher.intake()  # a group of MAX_BATCH flushes here
        svc.batcher.flush_all()
        for t in tickets:
            if not np.isfinite(t.result(timeout=300).count):
                fail("[serve] sched: non-finite count")
        batches = tel.of("serve.batch", since)
        sizes = tuple(b["size"] for b in batches)
        if sizes != sched.parts_for(n):
            fail(f"[serve] sched: a flush of {n} launched {sizes}, the core "
                 f"covers it with {sched.parts_for(n)}")
        for b in batches:
            if b["size"] != sched.cover_one(b["valid"]) or not costs_match(
                    b["predicted_cost_px"], b["realized_cost_px"]):
                fail(f"[serve] sched: batch {b} is not the core's prediction")
        rows.append(f"{n}->{'+'.join(map(str, sizes))}")
    st = svc.stats()
    if st["compile_count"] != warm or st["sched"]["cost_mismatches"]:
        fail(f"[serve] sched: {st['compile_count'] - warm} new signatures, "
             f"{st['sched']['cost_mismatches']} cost mismatches")
    svc.close()
    svc.engine.release_buffers()
    log(f"[serve] sched: menu {sched.menu} at {h}x{w}; flushes of n requests "
        f"launched {', '.join(rows)}; every batch cover_one(valid) slots and "
        f"predicted == realized cost ({st['sched']['predicted_cost_px_per_batch']}"
        f" px per batch); {warm} signatures = 1 bucket x {len(sched.menu)} "
        f"sizes x 1 dtype, unchanged by traffic; mean fill "
        f"{st['mean_batch_fill']}")
    return warm + st["batches"]


def burst_policies(pth: Path) -> int:
    """The 32-request burst at 768x1024 in bf16 (where the device time is
    smallest, so the flush policy shows most) under the priced flush, the
    timer (both with the menu) and the service without the core
    (``--menu-budget 1 --flush-policy timer``, the path before the core),
    in turns (A B C C B A in one process); reported and not gated: the
    burst is host-bound.  Returns the batches run."""
    from can_tpu_torch.serve import serve_http

    body = pth.parent / "burst_768x1024.npy"
    arms = {"priced": ("--flush-policy", "priced"),
            "timer": ("--flush-policy", "timer"),
            "no core": ("--menu-budget", "1", "--flush-policy", "timer")}
    rows, batches = {k: [] for k in arms}, 0
    for arm in list(arms) + list(reversed(arms)):
        svc = slice8_service(pth, None, (768, 1024),
                             ("--u8-warmup", "--serve-dtype", "bf16")
                             + arms[arm])
        with svc:
            httpd = serve_http(svc, host="127.0.0.1", port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                b = burst(httpd.server_address[1], body)
            finally:
                httpd.shutdown()
                httpd.server_close()
        st = svc.stats()
        batches += svc.engine.compile_count + st["batches"]
        svc.engine.release_buffers()
        rows[arm].append(f"p50 {b['p50_ms']:.1f} / p99 {b['p99_ms']:.1f} ms, "
                         f"{BURST / b['wall']:.2f} images/s, fill "
                         f"{st['mean_batch_fill']}, launches "
                         f"{st['sched']['launches_by_size']}")
    for arm, r in rows.items():
        log(f"[serve] sched burst {BURST} x 768x1024 bf16, {arm} "
            f"({' '.join(arms[arm])}): " + "; ".join(r))
    return batches


def serve_streams(pth: Path) -> int:
    """One camera's stream over HTTP: STREAM_FRAMES frames paced at 30/s
    (or slower, within the stream's capacity; all inferred), a replayed frame_seq (409), then a burst of
    STREAM_BURST frames submitted back to back, faster than the stream
    drains: the ladder answers some from the session's count EWMA
    (labelled degraded, with staleness) without a launch.  Returns the
    batches run."""
    from can_tpu_torch.serve import serve_http
    from can_tpu_torch.serve.streams import COUNT_EWMA_ALPHA

    tel = Events()
    svc = slice8_service(pth, tel)
    warm = svc.engine.compile_count
    h, w = SLICE8_BUCKET
    rng = np.random.default_rng(SEED + 4)
    frames = [rng.integers(0, 256, (h - 5, w - 3, 3), dtype=np.uint8)
              for _ in range(4)]
    ewma = None

    def fold(count):
        return count if ewma is None else ((1 - COUNT_EWMA_ALPHA) * ewma
                                           + COUNT_EWMA_ALPHA * count)

    with svc:
        httpd = serve_http(svc, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            pace, took = 1 / 30, []
            for i in range(STREAM_FRAMES):
                t0 = time.perf_counter()
                code, res = _post_status(port, frames[i % 4],
                                         f"stream_id=cam0&frame_seq={i + 1}")
                if code != 200 or res["degraded"] or not np.isfinite(
                        res["count"]):
                    fail(f"[serve] streams: frame {i + 1} answered {code} {res}")
                ewma = fold(res["count"])
                # a camera within capacity: 30 frames/s, or a third of the
                # rate the median round trip allows where that is slower
                took.append(time.perf_counter() - t0)
                pace = max(1 / 30, 3 * statistics.median(took))
                time.sleep(max(0.0, pace - took[-1]))
            sess = svc.streams.get("cam0")
            if sess.count_ewma != ewma or sess.served != STREAM_FRAMES:
                fail(f"[serve] streams: session EWMA {sess.count_ewma!r} "
                     f"served {sess.served}, want {ewma!r} / {STREAM_FRAMES}")
            code, res = _post_status(port, frames[0],
                                     f"stream_id=cam0&frame_seq={STREAM_FRAMES}")
            if code != 409 or res.get("reason") != "stale_frame":
                fail(f"[serve] streams: a replayed frame_seq got {code} {res}")
            # the burst, in order from one thread (a camera's frames)
            from can_tpu_torch.serve import prepare_image

            x = prepare_image(frames[1])
            seq0 = STREAM_FRAMES + 1
            tickets = [svc.submit(x, stream_id="cam0", frame_seq=seq0 + k)
                       for k in range(STREAM_BURST)]
            results = [t.result(timeout=300) for t in tickets]
            code, after = _post_status(
                port, frames[2], f"stream_id=cam0&frame_seq={seq0 + STREAM_BURST}")
        finally:
            httpd.shutdown()
            httpd.server_close()
    st = svc.stats()
    fresh = [r for r in results if not r.degraded]
    degraded = [r for r in results if r.degraded]
    # completions fold in frame order: every EWMA the session took
    seen = {ewma}
    for r in fresh:
        ewma = fold(r.count)
        seen.add(ewma)
    if not degraded:
        fail(f"[serve] streams: a burst of {STREAM_BURST} frames was all "
             f"inferred: the ladder never skipped")
    for r in degraded:
        if r.count not in seen or r.staleness_s is None or r.staleness_s < 0:
            fail(f"[serve] streams: degraded answer {r.count!r} (staleness "
                 f"{r.staleness_s}) is not one of the session's EWMAs")
    if code != 200 or after.get("degraded") is not True \
            or "staleness_s" not in after:
        fail(f"[serve] streams: the frame after the burst answered {code} "
             f"{after} (the skip rung holds for cooldown_s)")
    valid = sum(b["valid"] for b in tel.of("serve.batch"))
    if valid != STREAM_FRAMES + len(fresh) or st["degraded"] != len(degraded) + 1:
        fail(f"[serve] streams: {valid} frames launched for "
             f"{STREAM_FRAMES + len(fresh)} inferred; {st['degraded']} degraded")
    rungs = [(p["from_rung"], p["rung"]) for p in tel.of("stream.degrade")]
    svc.engine.release_buffers()
    log(f"[serve] streams: {STREAM_FRAMES} frames of cam0 at {1 / pace:.1f}/s "
        f"(round trip median {statistics.median(took) * 1e3:.1f} ms, max "
        f"{max(took) * 1e3:.1f}) all inferred "
        f"(session EWMA {sess.count_ewma:.6g} equal to the client's fold), "
        f"replayed frame_seq -> 409 stale_frame; burst of {STREAM_BURST}: "
        f"{len(fresh)} inferred, {len(degraded)} degraded (staleness "
        f"{min(r.staleness_s for r in degraded) * 1e3:.2f}.."
        f"{max(r.staleness_s for r in degraded) * 1e3:.2f} ms, each one of the "
        f"session's EWMAs) with no launch, and the next frame over HTTP "
        f"degraded: true, staleness_s {after['staleness_s']}; rung moves "
        f"{rungs}; {st['batches']} batches for {valid} inferred frames")
    return warm + st["batches"]


def serve_swap(pth: Path) -> dict:
    """``swap_params`` to a second seeded weight set on a warmed service:
    no new signature, the served counts move.  Returns what
    ``check_swap`` compares (after the launch count is read)."""
    import torch

    from can_tpu_torch.models import random_state_dict
    from can_tpu_torch.serve import prepare_image

    svc = slice8_service(pth)
    warm = svc.engine.compile_count
    h, w = SLICE8_BUCKET
    rng = np.random.default_rng(SEED + 5)
    imgs = [prepare_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for _ in range(3)]
    sd2 = {k: torch.from_numpy(v)
           for k, v in random_state_dict(SEED + 7, he=True).items()}
    with svc:
        before = [svc.predict(x, timeout=300).count for x in imgs]
        svc.engine.swap_params(sd2)
        after = [svc.predict(x, timeout=300).count for x in imgs]
    st = svc.stats()
    if st["compile_count"] != warm:
        fail(f"[serve] swap: {st['compile_count'] - warm} new signatures")
    return {"service": svc, "imgs": imgs, "before": before, "after": after,
            "sd2": sd2, "batches": warm + st["batches"]}


def check_swap(run: dict) -> None:
    from can_tpu_torch.data import pad_batch
    from can_tpu_torch.serve import ServeEngine, quantize_tree

    svc = run["service"]
    fresh = ServeEngine(run["sd2"], device="cuda")
    h, w = SLICE8_BUCKET
    worst = 0.0
    for x, got in zip(run["imgs"], run["after"]):
        batch = pad_batch([(x, np.zeros((h // 8, w // 8, 1), np.float32))],
                          (h, w), 1, [True], 8)
        want = float(fresh.predict_batch(batch)[0][0])
        worst = max(worst, abs(got - want) / abs(want))
    moved = min(abs(a - b) / abs(b) for a, b in zip(run["after"], run["before"]))
    if worst > SWAP_RTOL or moved < 1e-3:
        fail(f"[serve] swap: counts vs a fresh engine rel {worst:.2e} (> "
             f"{SWAP_RTOL}?), moved by {moved:.2e} from the old weights")
    try:
        svc.engine.swap_params(quantize_tree(run["sd2"], "bf16"),
                               quantized=True)
        fail("[serve] swap: a bf16 tree was swapped into the f32 engine")
    except ValueError as e:
        refusal = str(e)
    fresh.release_buffers()
    svc.engine.release_buffers()
    log(f"[serve] swap: swap_params to seed {SEED + 7}'s weights with no new "
        f"signature ({svc.engine.compile_count} warmed); served counts vs a "
        f"fresh engine on them: worst rel {worst:.2e} (tolerance {SWAP_RTOL}); "
        f"they moved by at least {moved:.2e} from the old weights; a bf16 tree "
        f"refused: {refusal[:60]}...")


# [fleet]: the serving fleet on the one card.  Two replicas share cuda:0
# (devices [cuda:0] x 2 of a universe [cuda:0] x 3: a replica owns a slot,
# not a device), so the phase checks the fleet's behaviour on the card and
# its times say nothing of two GPUs
FLEET_BUCKET = SLICE8_BUCKET
FLEET_BURST = 48
# each served count vs a single ServeEngine's on the same weights and image
FLEET_RTOL = {"f32": 1e-5, "bf16": 2e-2}
FLEET_HANG_S, FLEET_WATCHDOG_S, FLEET_COOLDOWN_S = 3.0, 0.5, 0.5
FLEET_SLOTS = 3
# the autoscaler's dead time after a move: long enough that the replica it
# added is not drained on idle before work steered to it has run
FLEET_AUTOSCALE_COOLDOWN_S = 2.0


class PredictCount:
    """Successful ``ServeEngine.predict_batch`` calls while installed,
    from every thread: each one runs the context tail once, so on the card
    each must be one launch of the context kernel."""

    def __init__(self):
        from can_tpu_torch.serve.engine import ServeEngine

        self._cls, self._orig = ServeEngine, ServeEngine.predict_batch
        self._lock = threading.Lock()
        self.n = 0
        orig, me = self._orig, self

        def counted(engine, *a, **kw):
            out = orig(engine, *a, **kw)
            with me._lock:
                me.n += 1
            return out

        ServeEngine.predict_batch = counted

    def close(self) -> None:
        self._cls.predict_batch = self._orig


def fleet_service(sd, serve_dtype: str, telemetry=None, replicas: int = 2,
                  **fleet_kw):
    """A warmed one-bucket service over a FleetEngine on cuda:0 slots, at
    the default menu and flush."""
    import torch

    from can_tpu_torch.serve import CountService, FleetEngine

    fleet = FleetEngine(sd, replicas=replicas, serve_dtype=serve_dtype,
                        devices=[torch.device("cuda", 0)] * FLEET_SLOTS,
                        telemetry=telemetry, **fleet_kw)
    h, w = FLEET_BUCKET
    svc = CountService(fleet, max_batch=MAX_BATCH, queue_capacity=256,
                       bucket_ladder=((h,), (w,)),
                       default_deadline_ms=120_000)
    svc.warmup([(h, w)])
    return fleet, svc


def release_fleet(fleet) -> None:
    """Every replica's weights off the card before the next fleet."""
    for r in fleet.replicas:
        r.engine.release_buffers()


def fleet_burst(svc, images, n: int) -> dict:
    """n requests submitted back to back; every one must resolve."""
    from can_tpu_torch.serve import RejectedError

    t0 = time.perf_counter()
    tickets = [svc.submit(images[i % len(images)]) for i in range(n)]
    submit_ms = (time.perf_counter() - t0) * 1e3
    try:
        results = [t.result(timeout=300) for t in tickets]
    except RejectedError as e:
        fail(f"[fleet] a burst request was rejected: {e}")
    wall = time.perf_counter() - t0
    lat = sorted(r.latency_s for r in results)
    return {"results": results, "wall": wall, "submit_ms": submit_ms,
            "p50_ms": statistics.median(lat) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def lone_batch(x):
    from can_tpu_torch.data import pad_batch

    h, w = x.shape[:2]
    return pad_batch([(x, np.zeros((h // 8, w // 8, 1), np.float32))],
                     (h, w), 1, [True], 8)


def single_engine_counts(sd, serve_dtype: str, images) -> list:
    """What one ServeEngine serves for each image as a lone request."""
    from can_tpu_torch.serve import ServeEngine

    eng = ServeEngine(sd, device="cuda", serve_dtype=serve_dtype,
                      name="reference")
    out = [float(eng.predict_batch(lone_batch(x))[0][0]) for x in images]
    eng.release_buffers()
    return out


def fleet_cli_refusal(pth: Path) -> None:
    """Gate 1: the CLI refuses --replicas 2 by the card count before any
    weights load."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        log(f"[fleet] CLI --replicas 2 on {n} cards: not a refusal case here")
        return
    proc = subprocess.run(
        [sys.executable, "-m", "can_tpu_torch.cli.serve", "--torch-pth",
         str(pth), "--replicas", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    want = "replicas=2 exceeds the 1 available devices"
    if proc.returncode == 0 or want not in proc.stderr + proc.stdout \
            or "[load]" in proc.stdout:
        fail(f"[fleet] python -m can_tpu_torch.cli.serve --replicas 2 on one "
             f"card: exit {proc.returncode}, stdout {proc.stdout[-300:]!r}, "
             f"stderr {proc.stderr[-300:]!r}")
    log(f"[fleet] CLI --replicas 2 on 1 card: exit {proc.returncode} before "
        f"any weights load: {proc.stderr.strip().splitlines()[-1][:100]}...")


def fleet_clean(sd, serve_dtype: str, images, refs, replicas: int = 2,
                count=None) -> dict:
    """Gate 2 (2 replicas) and the report's 1-replica arm: a clean burst;
    every request completes, no replica quarantines, no new signature,
    counts equal a single engine's, and the context kernel launched once
    per predict the fleet ran (warmups and batches).  Before the burst a
    lone request is steered to each replica in turn (the others' dispatch
    locks held), so every replica serves whatever split the burst takes."""
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.testing import serve_on

    cc.reset_launches()  # this fleet's window starts here
    c0 = count.n
    tel = Events()
    fleet, svc = fleet_service(sd, serve_dtype, tel, replicas=replicas)
    warm = [r.engine.compile_count for r in fleet.replicas]
    with svc:
        steered = [] if replicas < 2 else [
            res for r in range(replicas)
            for res in serve_on(fleet, svc, r, images[0], timeout_s=120)]
        since = len(tel.events)
        b = fleet_burst(svc, images, FLEET_BURST)
    launches, calls = cc.LAUNCHES, count.n - c0
    st = svc.stats()
    tag = f"[fleet] clean {serve_dtype} x {replicas}"
    if st["completed"] != FLEET_BURST + len(steered) or st["rejected"]:
        fail(f"{tag}: {st['completed']} completed of "
             f"{FLEET_BURST + len(steered)}, {st['rejected']} rejected")
    rows = fleet.healthz()["replicas"]
    if any(r["state"] != "active" or r["failures"] for r in rows):
        fail(f"{tag}: replicas {rows} (a kernel fault quarantines a replica)")
    if [r.engine.compile_count for r in fleet.replicas] != warm:
        fail(f"{tag}: traffic ran new signatures "
             f"{[r.engine.compile_count for r in fleet.replicas]} vs {warm}")
    per = {k: v["batches"] for k, v in st["replicas"].items()}
    if min(per.values()) < 1:
        fail(f"{tag}: a replica served no batch: {per}")
    if not launches == calls == sum(warm) + st["batches"]:
        fail(f"{tag}: context_fused launched {launches} times for {calls} "
             f"predicts ({sum(warm)} warmup + {st['batches']} batches)")
    worst = 0.0
    for r, want in ([(r, refs[i % len(refs)])
                     for i, r in enumerate(b["results"])]
                    + [(r, refs[0]) for r in steered]):
        if not np.isfinite(r.count):
            fail(f"{tag}: non-finite count")
        worst = max(worst, abs(r.count - want) / abs(want))
    if worst > FLEET_RTOL[serve_dtype]:
        fail(f"{tag}: served count vs a single engine rel {worst:.2e} > "
             f"{FLEET_RTOL[serve_dtype]}")
    # why the burst splits as it does: the batcher's one thread assembles
    # (and stages) each batch, the replicas launch it
    asm = [p["assembly_s"] for p in tel.of("serve.request", since)]
    exe = [p["execute_s"] for p in tel.of("serve.batch", since)]
    release_fleet(fleet)
    return {**b, "batches": per, "launches": launches, "worst": worst,
            "warm": warm, "steered": len(steered),
            "burst_batches": [p.get("replica", 0)
                              for p in tel.of("serve.batch", since)],
            "assembly_ms": statistics.median(asm) * 1e3,
            "execute_ms": statistics.median(exe) * 1e3}


def fleet_crash(sd, images, count) -> int:
    """Gate 3: replica_crash (replica 0, batch 2) through CAN_TPU_FAULTS:
    the batch is redispatched once, no request is lost, the replica's
    weights leave the card at quarantine, and after the cooldown it
    resurrects at the current generation."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.serve import param_bytes
    from can_tpu_torch.testing import faults

    os.environ[faults.FAULTS_ENV] = json.dumps({"faults": [
        {"kind": "replica_crash", "replica": 0, "batch": 2}]})
    faults._CACHED = faults._CACHED_SPEC = None
    try:
        cc.reset_launches()  # this fleet's window starts here
        c0 = count.n
        tel = Events()
        fleet, svc = fleet_service(sd, "f32", tel,
                                   probe_cooldown_s=FLEET_COOLDOWN_S,
                                   maintain_interval_s=0.05)
        rep0 = fleet.replicas[0]
        pbytes = param_bytes(rep0.engine.params)
        release, freed = rep0.engine.release_buffers, {}

        def measured():
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(0)
            release()
            freed["bytes"] = before - torch.cuda.memory_allocated(0)

        rep0.engine.release_buffers = measured
        inj = faults.active_injector()
        with svc:
            # one request at a time until the fault fires: the survivor is
            # idle at the quarantine, so the memory reading is the release's
            serial = 0
            while not inj.fired and serial < 20:
                if not np.isfinite(svc.predict(images[serial % len(images)],
                                               timeout=300).count):
                    fail("[fleet] crash: non-finite count")
                serial += 1
            if not inj.fired:
                fail("[fleet] crash: replica 0 never ran its second batch")
            fleet_burst(svc, images, 16)
            t0 = time.perf_counter()
            while fleet.live_replicas() < 2 and time.perf_counter() - t0 < 30:
                time.sleep(0.05)
            heal_s = time.perf_counter() - t0
            fleet_burst(svc, images, 16)  # through the healed fleet
        st = svc.stats()
        launches, calls = cc.LAUNCHES, count.n - c0
        quar = [p for p in tel.of("fleet.replica")
                if p["state"] == "quarantined"]
        res = tel.of("fleet.resurrect")
        valid = sum(b["valid"] for b in tel.of("serve.batch"))
        if st["rejected"] or st["completed"] != serial + 32 \
                or valid != st["completed"]:
            fail(f"[fleet] crash: {st['completed']} completed of "
                 f"{serial + 32}, {st['rejected']} rejected, {valid} "
                 f"launched: a request was lost or served twice")
        if len(quar) != 1 or quar[0]["replica"] != 0 or len(res) != 1 \
                or res[0]["generation"] != fleet.generation \
                or fleet.replicas[0].engine.name != "serve_predict_r0i1" \
                or fleet.live_replicas() != 2:
            fail(f"[fleet] crash: quarantines {quar}, resurrections {res}, "
                 f"live {fleet.live_replicas()}")
        if freed.get("bytes", 0) < pbytes:
            fail(f"[fleet] crash: quarantine freed {freed.get('bytes')} bytes "
                 f"of device memory, the replica holds {pbytes} parameter "
                 f"bytes")
        if launches != calls:
            fail(f"[fleet] crash: {launches} context launches for {calls} "
                 f"predicts")
        log(f"[fleet] crash: replica_crash at replica 0's batch 2 (request "
            f"{serial}): quarantined, its batch redispatched once and served "
            f"by replica 1, {st['completed']} requests completed, 0 lost or "
            f"rejected; memory_allocated fell {freed['bytes']} bytes at the "
            f"quarantine (replica parameter bytes {pbytes}); resurrected as "
            f"{fleet.replicas[0].engine.name} at generation "
            f"{res[0]['generation']} in {res[0]['seconds']} s "
            f"({res[0]['warmup_compiles']} new signatures), live 2 again "
            f"{heal_s:.2f} s after the burst")
        release_fleet(fleet)
        return launches
    finally:
        del os.environ[faults.FAULTS_ENV]
        faults._CACHED = faults._CACHED_SPEC = None


def fleet_hang(sd, images, count) -> int:
    """Gate 4: replica_hang (replica 1, FLEET_HANG_S) with a 0.5 s
    watchdog: the replica is wedged and its batch completes on the
    survivor within the deadline + 1 s; nothing is lost."""
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.testing import faults

    os.environ[faults.FAULTS_ENV] = json.dumps({"faults": [
        {"kind": "replica_hang", "replica": 1, "batch": 1,
         "delay_s": FLEET_HANG_S}]})
    faults._CACHED = faults._CACHED_SPEC = None
    try:
        cc.reset_launches()  # this fleet's window starts here
        c0 = count.n
        tel = Events()
        fleet, svc = fleet_service(sd, "f32", tel,
                                   watchdog_default_s=FLEET_WATCHDOG_S,
                                   maintain_interval_s=0.05)
        inj = faults.active_injector()
        with svc:
            serial, hung = 0, None
            while hung is None and serial < 20:
                res = svc.predict(images[serial % len(images)], timeout=300)
                serial += 1
                if inj.fired:
                    hung = res  # one request per batch: the hung one
            if hung is None:
                fail("[fleet] hang: replica 1 never ran a batch")
            fleet_burst(svc, images, 16)
            t_close = time.perf_counter()
        close_s = time.perf_counter() - t_close
        st = svc.stats()
        launches, calls = cc.LAUNCHES, count.n - c0
        rows = {r["replica"]: r for r in fleet.healthz()["replicas"]}
        wedge = [p for p in tel.of("fleet.replica") if p["state"] == "wedged"]
        if rows[1]["state"] != "wedged" or len(wedge) != 1 \
                or rows[0]["state"] != "active":
            fail(f"[fleet] hang: replicas {rows}, wedge events {wedge}")
        if hung.latency_s > FLEET_WATCHDOG_S + 1.0:
            fail(f"[fleet] hang: the hung batch resolved after "
                 f"{hung.latency_s:.3f} s (deadline {FLEET_WATCHDOG_S} + 1 s)")
        if st["rejected"] or st["completed"] != serial + 16:
            fail(f"[fleet] hang: {st['completed']} of {serial + 16} "
                 f"completed, {st['rejected']} rejected")
        if launches != calls:
            fail(f"[fleet] hang: {launches} context launches for {calls} "
                 f"predicts")
        log(f"[fleet] hang: replica_hang {FLEET_HANG_S} s at replica 1's "
            f"first batch, watchdog {FLEET_WATCHDOG_S} s: replica 1 wedged, "
            f"the hung request served by replica 0 {hung.latency_s:.3f} s "
            f"after submit (limit {FLEET_WATCHDOG_S + 1.0}); "
            f"{st['completed']} completed, 0 lost; close waited "
            f"{close_s:.2f} s for the abandoned thread's sleep to end")
        release_fleet(fleet)
        return launches
    finally:
        del os.environ[faults.FAULTS_ENV]
        faults._CACHED = faults._CACHED_SPEC = None


def steady_stream(svc, images, threads: int = 2):
    """Closed-loop clients until the returned stop() is called; stop()
    returns (requests answered, errors)."""
    stop, done, errors = threading.Event(), [0], []

    def client(k):
        i = k
        while not stop.is_set():
            try:
                svc.predict(images[i % len(images)], timeout=300)
                done[0] += 1
            except Exception as e:  # noqa: BLE001 — the gate reads them
                errors.append(repr(e))
            i += threads

    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()

    def halt():
        stop.set()
        for t in ts:
            t.join(timeout=300)
        if any(t.is_alive() for t in ts):
            fail("[fleet] a client thread did not stop")
        return done[0], errors

    return halt


def fleet_rollout(sd, sd2, serve_dtype: str, images, count) -> int:
    """Gate 5: rollout under a steady stream: zero rejects, generation 1 on
    every live replica, no new signature, and lone requests after the flip
    served bitwise as a fresh engine on the new weights serves them."""
    from can_tpu_torch.ops import cuda_context as cc

    cc.reset_launches()  # this fleet's window starts here
    c0 = count.n
    fleet, svc = fleet_service(sd, serve_dtype)
    warm = [r.engine.compile_count for r in fleet.replicas]
    with svc:
        halt = steady_stream(svc, images)
        time.sleep(0.3)
        rep = fleet.rollout(sd2)
        time.sleep(0.3)
        answered, errors = halt()
        after = [svc.predict(x, timeout=300).count for x in images[:3]]
    launches, calls = cc.LAUNCHES, count.n - c0
    st = svc.stats()
    tag = f"[fleet] rollout {serve_dtype}"
    if errors or st["rejected"]:
        fail(f"{tag}: {st['rejected']} rejected, errors {errors[:3]}")
    if rep["flipped"] != [0, 1] or any(r.generation != 1
                                       for r in fleet.replicas):
        fail(f"{tag}: report {rep}")
    if [r.engine.compile_count for r in fleet.replicas] != warm:
        fail(f"{tag}: new signatures after the flip")
    if launches != calls:
        fail(f"{tag}: {launches} context launches for {calls} predicts")
    want = single_engine_counts(sd2, serve_dtype, images[:3])
    if after != want:
        fail(f"{tag}: counts after the flip {after} != a fresh engine's "
             f"{want}")
    log(f"{tag} under {answered} steady requests: generation 1 on replicas "
        f"{rep['flipped']}, 0 rejected, no new signature, staging "
        f"{rep['staging_compiles']} signatures in {rep['staging_seconds']} s, "
        f"rollout {rep['seconds']} s; lone requests after the flip bitwise "
        f"equal to a fresh engine on the new weights")
    release_fleet(fleet)
    return launches


def first_launch_ms(sd, menu) -> str:
    """A fresh engine's first launch of each menu signature against its
    steady state, in this warm process (the cost a replica's warmup
    pays)."""
    import torch

    from can_tpu_torch.data import pad_batch
    from can_tpu_torch.serve import ServeEngine

    h, w = FLEET_BUCKET
    eng = ServeEngine(sd, device="cuda", name="reference")
    rows = []
    for size in menu:
        x = np.zeros((h, w, 3), np.float32)
        batch = pad_batch([(x, np.zeros((h // 8, w // 8, 1), np.float32))],
                          (h, w), size, [False], 8)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.predict_batch(batch)
            times.append((time.perf_counter() - t0) * 1e3)
        rows.append(f"b{size} {times[0]:.1f} vs {statistics.median(times[1:]):.1f}")
    eng.release_buffers()
    return ", ".join(rows)


def fleet_scale(sd, images, count) -> int:
    """Gate 6: add_replica then remove_replica under traffic, zero drops;
    the new replica serves (work steered to it, the others' dispatch locks
    held) before it is the one drained; the scale-up's time to ready and
    new signatures (what a counterpart of the JAX AOT bundle must beat)."""
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.testing import serve_on

    cc.reset_launches()  # this fleet's window starts here
    c0 = count.n
    tel = Events()
    fleet, svc = fleet_service(sd, "f32", tel)
    with svc:
        halt = steady_stream(svc, images, threads=6)
        time.sleep(0.3)
        up = fleet.add_replica(reason="smoke")
        live_up = fleet.live_replicas()
        steered = serve_on(fleet, svc, up["replica"], images[0],
                           timeout_s=120)
        # the stats rows list current replicas only: read it before the drain
        new = svc.stats()["replicas"][str(up["replica"])]["batches"]
        time.sleep(0.3)
        down = fleet.remove_replica(reason="smoke")
        time.sleep(0.3)
        answered, errors = halt()
    launches, calls = cc.LAUNCHES, count.n - c0
    st = svc.stats()
    if errors or st["rejected"] or live_up != 3 or \
            fleet.live_replicas() != 2 or \
            st["completed"] != answered + len(steered):
        fail(f"[fleet] scale: live {live_up} -> {fleet.live_replicas()}, "
             f"{st['completed']} completed of {answered + len(steered)}, "
             f"{st['rejected']} rejected, errors {errors[:3]}")
    if launches != calls:
        fail(f"[fleet] scale: {launches} context launches for {calls} "
             f"predicts")
    if new < 1 or down["replica"] != up["replica"]:
        fail(f"[fleet] scale: the added replica {up['replica']} served {new} "
             f"batches; remove_replica drained replica {down['replica']}")
    log(f"[fleet] scale: add_replica on slot 2 (cuda:0) under traffic: "
        f"time_to_first_ready_s {up['time_to_first_ready_s']}, "
        f"warmup_compiles {up['warmup_compiles']}, aot_hits "
        f"{up['aot_hits']}; it served {new} batches ({len(steered)} lone "
        f"requests steered to it); remove_replica drained it; "
        f"{answered + len(steered)} requests, 0 dropped")
    log(f"[fleet] first launch vs steady state (ms) of a fresh f32 engine's "
        f"signatures at {FLEET_BUCKET[0]}x{FLEET_BUCKET[1]} in a warm "
        f"process: {first_launch_ms(sd, svc.sched.menu)}")
    release_fleet(fleet)
    return launches


def fleet_autoscale(sd, images, count) -> int:
    """Gate 7: an Autoscaler (max 3) scales up on a burst and down on idle,
    with zero drops; the replica it added serves (work steered to it, in
    the cooldown after the scale-up) before it is the one drained."""
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.serve import Autoscaler, AutoscalePolicy
    from can_tpu_torch.testing import serve_on

    cc.reset_launches()  # this fleet's window starts here
    c0 = count.n
    tel = Events()
    fleet, svc = fleet_service(sd, "f32", tel)
    svc.autoscaler = Autoscaler(svc, AutoscalePolicy(
        min_replicas=2, max_replicas=FLEET_SLOTS, queue_high=4.0,
        queue_low=1.0, up_consecutive=1, down_consecutive=3,
        cooldown_s=FLEET_AUTOSCALE_COOLDOWN_S, interval_s=0.05))
    submitted, added = 0, None
    with svc:
        t0 = time.perf_counter()
        while not tel.of("fleet.scale") and time.perf_counter() - t0 < 30:
            fleet_burst(svc, images, FLEET_BURST)
            submitted += FLEET_BURST
        ups = tel.of("fleet.scale")
        if ups and ups[0]["direction"] == "up":
            added = next((r for r in fleet.replicas
                          if r.index == ups[0]["replica"]), None)
            if added is None:
                fail("[fleet] autoscale: the added replica was drained "
                     "before work was steered to it")
            submitted += len(serve_on(fleet, svc, added.index, images[0],
                                      timeout_s=120))
        t1 = time.perf_counter()
        while len(tel.of("fleet.scale")) < 2 and time.perf_counter() - t1 < 30:
            time.sleep(0.05)
        idle_s = time.perf_counter() - t1
    launches, calls = cc.LAUNCHES, count.n - c0
    st = svc.stats()
    scale = tel.of("fleet.scale")
    moves = [(p["direction"], p["live"]) for p in scale]
    new = 0 if added is None else added.batches
    if moves != [("up", 3), ("down", 2)] or st["rejected"] \
            or st["completed"] != submitted:
        fail(f"[fleet] autoscale: moves {moves}, {st['completed']} of "
             f"{submitted} completed, {st['rejected']} rejected")
    if new < 1 or scale[1]["replica"] != added.index:
        fail(f"[fleet] autoscale: the added replica {added.index} served "
             f"{new} batches; the scale-down drained replica "
             f"{scale[1]['replica']}")
    if launches != calls:
        fail(f"[fleet] autoscale: {launches} context launches for {calls} "
             f"predicts")
    log(f"[fleet] autoscale (max 3): {moves[0]} under bursts of "
        f"{FLEET_BURST} ({submitted} requests), the added replica served "
        f"{new} batches, {moves[1]} {idle_s:.2f} s into idle, draining it; "
        f"0 dropped")
    release_fleet(fleet)
    return launches


def phase_fleet(pth: Path, card: str) -> dict:
    """The fleet path on the card (gates 1-7; the 1- against 2-replica
    burst reported); returns the context launches the fleets made."""
    import torch

    from can_tpu_torch.models import random_state_dict
    from can_tpu_torch.serve import prepare_image
    from can_tpu_torch.utils.torch_import import load_torch_checkpoint

    t_phase = time.perf_counter()
    fleet_cli_refusal(pth)
    sd = load_torch_checkpoint(str(pth))
    sd2 = {k: torch.from_numpy(v)
           for k, v in random_state_dict(SEED + 7, he=True).items()}
    h, w = FLEET_BUCKET
    rng = np.random.default_rng(SEED + 9)
    images = [prepare_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for _ in range(8)]
    count = PredictCount()
    total, report = 0, []
    try:
        for dt in ("f32", "bf16"):
            refs = single_engine_counts(sd, dt, images)
            arms = {k: fleet_clean(sd, dt, images, refs, k, count)
                    for k in (1, 2)}
            total += sum(a["launches"] for a in arms.values())
            two = arms[2]
            log(f"[fleet] clean {dt}: {FLEET_BURST} requests over 2 replicas "
                f"on cuda:0 after {two['steered']} steered to each replica "
                f"in turn, batches by replica {two['batches']} (the burst's "
                f"in order: {two['burst_batches']}; submitted in "
                f"{two['submit_ms']:.1f} ms, median batch assembly "
                f"{two['assembly_ms']:.1f} ms on the batcher thread vs "
                f"execute {two['execute_ms']:.1f} ms), 0 rejected, "
                f"every replica active with 0 failures, warmup signatures "
                f"{two['warm']} unchanged by traffic; counts vs a single "
                f"engine worst rel {two['worst']:.2e} (limit "
                f"{FLEET_RTOL[dt]}); context_fused launches {two['launches']}"
                f" = the fleet's predicts (warmups + batches)")
            report.append(", ".join(
                f"{dt} {k} replica{'s' if k > 1 else ''} p50 "
                f"{a['p50_ms']:.1f} / p99 {a['p99_ms']:.1f} ms, "
                f"{FLEET_BURST / a['wall']:.1f} images/s"
                for k, a in arms.items()))
        total += fleet_crash(sd, images, count)
        total += fleet_hang(sd, images, count)
        for dt in ("f32", "bf16"):
            total += fleet_rollout(sd, sd2, dt, images, count)
        total += fleet_scale(sd, images, count)
        total += fleet_autoscale(sd, images, count)
    finally:
        count.close()
    log(f"[fleet] burst of {FLEET_BURST} at {h}x{w} (reported, not gated; the "
        f"replicas time-slice one card, {card}: these times say nothing of "
        f"two GPUs): " + "; ".join(report))
    log(f"[fleet] context_fused launches on the fleet path: {total}, each one "
        f"a predict of a fleet engine (warmups, batches, probes, staging, "
        f"scale-ups); phase {time.perf_counter() - t_phase:.1f} s")
    return {"bn": 0, "bn_backward": 0, "context": total}


# [obs]: telemetry on the serving path (slice 11).  The serve CLI's own
# stack — parse_args -> validate_incident_args -> build_telemetry ->
# build_service — on cuda:0 at [serve]'s one bucket, against the same
# service with telemetry off; then the incident path on a two-replica
# fleet and an SLO burn that scales it
OBS_REQUESTS = 48
OBS_BF16_REQUESTS = 8  # the bf16 service's, for its ledger's MFU at close
# span children may start/end within the 6-digit rounding of the root's
OBS_SPAN_SLACK_S = 2e-6
OBS_PROM_LINE = r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (-?[0-9.e+E-]+|NaN|[+-]Inf)$"


def obs_http(service, images) -> dict:
    """``images`` POSTed one at a time over HTTP; the counts and each
    request's wall time at the client."""
    from can_tpu_torch.serve import serve_http

    httpd = serve_http(service, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    counts, lat = [], []
    try:
        for img in images:
            t0 = time.perf_counter()
            res = _post(port, img, "raw=0")
            lat.append(time.perf_counter() - t0)
            if not np.isfinite(res["count"]):
                fail(f"[obs] non-finite count for {img.shape}")
            counts.append(res["count"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    lat.sort()
    return {"counts": counts, "p50_ms": statistics.median(lat) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3, "min_s": lat[0]}


def obs_stack(argv):
    """The serve CLI's telemetry stack from ``argv`` (no signal hook: the
    smoke is not the CLI's main)."""
    from can_tpu_torch.cli import serve as cli
    from can_tpu_torch.cli.train import build_telemetry, validate_incident_args

    args = cli.parse_args(argv)
    validate_incident_args(args)
    tel, hb, exporter = build_telemetry(args, host_id=0, install_signals=False,
                                        trace_window=None)
    return args, tel, hb, exporter


def obs_check_jsonl(path: Path, n: int, batches: int) -> list:
    """The window's JSONL gates; returns its events."""
    events = [json.loads(x) for x in path.read_text().splitlines()]
    kinds = [e["kind"] for e in events]
    reqs = [e["payload"] for e in events if e["kind"] == "serve.request"]
    if kinds.count("run") != 1 or len(reqs) != n \
            or not all(r["ok"] for r in reqs) \
            or kinds.count("serve.batch") != batches \
            or "heartbeat" not in kinds:
        fail(f"[obs] JSONL: run {kinds.count('run')}, serve.request "
             f"{len(reqs)} (ok {sum(r['ok'] for r in reqs)}) for {n} requests, "
             f"serve.batch {kinds.count('serve.batch')} for {batches} batches, "
             f"heartbeats {kinds.count('heartbeat')}")
    spans = [e["payload"] for e in events if e["kind"] == "trace.span"]
    roots = [s for s in spans if s["name"] == "request"]
    if len(roots) != n or {s["trace_id"] for s in roots} != \
            {r["trace_id"] for r in reqs}:
        fail(f"[obs] {len(roots)} request root spans for {n} requests")
    for root in roots:
        kids = [s for s in spans if s["parent_id"] == root["span_id"]]
        end = root["start_s"] + root["duration_s"] + OBS_SPAN_SLACK_S
        if sorted(k["name"] for k in kids) != ["batch_assembly", "device",
                                                "queue_wait", "respond"] \
                or any(k["start_s"] < root["start_s"] - OBS_SPAN_SLACK_S
                       or k["start_s"] + k["duration_s"] > end for k in kids):
            fail(f"[obs] request span tree {root['trace_id']}: children "
                 f"{[(k['name'], k['start_s'], k['duration_s']) for k in kids]}"
                 f" of the root at {root['start_s']} + {root['duration_s']}")
    return events


def obs_bf16_ledger(base: list, work: Path, images) -> dict:
    """The serve CLI at ``--serve-dtype bf16`` with ``--telemetry-dir``:
    its ledger prices MFU at the bf16 peak, and the MFU it reads at close
    lies in (0, 1).  Returns the close's perf.summary."""
    from can_tpu_torch import obs
    from can_tpu_torch.cli import serve as cli

    args, tel, hb, exporter = obs_stack(
        base + ["--serve-dtype", "bf16", "--telemetry-dir", str(work / "tel_bf16")])
    try:
        svc = cli.build_service(args, telemetry=tel)
        with svc:
            obs_http(svc, images)
        compute, peak = tel.ledger.compute, tel.ledger.peaks.flops("bf16")
    finally:
        obs.shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    perf = [json.loads(x)["payload"] for x in
            (work / "tel_bf16" / "telemetry.host0.jsonl").read_text().splitlines()
            if json.loads(x)["kind"] == "perf.summary"]
    last = perf[-1] if perf else {}
    mfu = last.get("mfu_weighted")
    if compute != "bf16" or last.get("peak_flops") != peak \
            or mfu is None or not 0 < mfu < 1:
        fail(f"[obs] --serve-dtype bf16: ledger compute {compute!r}, "
             f"perf.summary at close priced at {last.get('peak_flops')} "
             f"FLOP/s (the bf16 peak is {peak}), mfu_weighted {mfu}: want "
             f"bf16, its peak, and 0 < MFU < 1")
    log(f"[obs] --serve-dtype bf16, {len(images)} requests: ledger priced at "
        f"the bf16 peak {peak / 1e12:.0f} TFLOP/s, mfu_weighted {mfu} at close")
    return last


def obs_window_a(pth: Path, work: Path, images, count) -> dict:
    """Telemetry on (the five flags) against off, 48 requests each."""
    import re

    from can_tpu_torch import obs
    from can_tpu_torch.cli import serve as cli
    from can_tpu_torch.ops import cuda_context as cc

    h, w = SLICE8_BUCKET
    spec = ROOT / "slo_spec.json"
    base = ["--torch-pth", str(pth), "--max-batch", str(MAX_BATCH),
            "--bucket-shapes", f"{h}x{w}", "--port", "0",
            "--deadline-ms", "120000"]
    argv = base + ["--telemetry-dir", str(work / "tel"), "--metrics-port", "0",
                   "--slo-spec", str(spec), "--incident-dir", str(work / "inc"),
                   "--telemetry-heartbeat-s", "1"]
    cc.reset_launches()  # window (a) starts here
    c0 = count.n
    args, tel, hb, exporter = obs_stack(argv)
    try:
        on = cli.build_service(args, telemetry=tel)
        exporter.add_stats_source("serve", on.stats)
        warm_on = on.engine.compile_count
        with on:
            got_on = obs_http(on, images)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exporter.port}/metrics", timeout=30) as r:
                metrics = r.read().decode()
        st_on = on.stats()
        # after the close: its perf.summary carries every batch's timing
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/metrics", timeout=30) as r:
            closed_metrics = r.read().decode()
    finally:
        obs.shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    off = cli.build_service(cli.parse_args(base))
    warm_off = off.engine.compile_count
    with off:
        got_off = obs_http(off, images)
    st_off = off.stats()
    obs_bf16_ledger(base, work, images[:OBS_BF16_REQUESTS])
    launches, calls = cc.LAUNCHES, count.n - c0
    if got_on["counts"] != got_off["counts"]:
        worst = max(abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(got_on["counts"], got_off["counts"]))
        fail(f"[obs] counts with telemetry on differ from off (worst rel "
             f"{worst:.3e}): they must be bitwise equal")
    if launches != calls or st_on["compile_count"] != warm_on \
            or st_off["compile_count"] != warm_off:
        fail(f"[obs] {launches} context launches for {calls} predicts; new "
             f"signatures after warmup: on {st_on['compile_count'] - warm_on}, "
             f"off {st_off['compile_count'] - warm_off}")
    path = work / "tel" / "telemetry.host0.jsonl"
    events = obs_check_jsonl(path, len(images), st_on["batches"])
    bad = [x for x in metrics.splitlines()
           if x and not x.startswith("#") and not re.match(OBS_PROM_LINE, x)]
    done = [x for x in metrics.splitlines()
            if x.startswith("can_tpu_serve_completed_total ")]
    if bad or done != [f"can_tpu_serve_completed_total {len(images)}"]:
        fail(f"[obs] /metrics: unparsable lines {bad[:3]}, completed {done}")
    grade = obs.grade_events(events, obs.load_slo_spec(str(spec)))
    p99 = grade["objectives"]["serve_p99_deadline"]
    burning = [e for e in events if e["kind"] == "slo.burn"
               and e["payload"]["alerting"]]
    if [v for v in grade["violations"] if v["objective"] == "serve_p99_deadline"] \
            or burning or p99["samples"] != len(images) or not p99["graded"]:
        fail(f"[obs] serve_p99_deadline graded {p99}, live burns {burning[:2]}")
    summary = obs.summarize(events)
    if summary["serve_requests"] != len(images):
        fail(f"[obs] report.summarize counts {summary['serve_requests']} "
             f"requests of {len(images)}")
    if os.listdir(work / "inc"):
        fail(f"[obs] a clean window wrote incident bundles "
             f"{os.listdir(work / 'inc')}")
    perf = [e["payload"] for e in events if e["kind"] == "perf.summary"]
    compiles = [e["payload"] for e in events if e["kind"] == "compile"]
    mfu_gauges = [x for x in closed_metrics.splitlines()
                  if x.startswith("can_tpu_mfu_weighted ")]
    want_phases = (["serve_warmup"] + ["serve"] * (st_on["batches"] // 32)
                   + ["serve_close"])
    if [p["phase"] for p in perf] != want_phases \
            or not all(r["name"] == "serve_predict" and r["flops"]
                       for p in perf for r in p["detail"]) \
            or not all(c.get("flops") and c.get("bytes_accessed") for c in compiles) \
            or perf[-1].get("mfu_weighted") is None or not mfu_gauges:
        fail(f"[obs] cost ledger: perf.summary phases "
             f"{[p['phase'] for p in perf]} (want {want_phases}: warmup, one "
             f"per 32 batches, close), rows {[(r['name'], r['flops']) for p in perf[-1:] for r in p['detail']]}, "
             f"compile costs {[(c.get('flops'), c.get('bytes_accessed')) for c in compiles]}, "
             f"/metrics after the close {mfu_gauges}")
    for r in perf[-1]["detail"]:
        log(f"[obs] serve ledger row {r['name']} {tuple(r['shape'])} "
            f"{r['dtype']}: {r['flops'] / 1e9:.2f} GFLOP, "
            f"{r['bytes_accessed'] / 1e9:.3f} GB accessed (unfused), "
            f"intensity {r['intensity']}, {r['roofline']}-bound, launches "
            f"{r['launches']}, mean {r['mean_s']} s, MFU {r['mfu']}")
    log(f"[obs] serve perf.summary at close: mfu_weighted "
        f"{perf[-1]['mfu_weighted']} against {perf[-1]['peak_source']} "
        f"({perf[-1]['peak_flops'] / 1e12:.0f} TFLOP/s); /metrics {mfu_gauges[0]}")
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    log(f"[obs] telemetry on (--telemetry-dir --metrics-port 0 --slo-spec "
        f"--incident-dir --telemetry-heartbeat-s 1) against off, "
        f"{len(images)} requests one at a time over HTTP at {h}x{w} f32: "
        f"counts bitwise equal, context_fused launches {launches} = the "
        f"engines' predicts (warmups {warm_on} + {warm_off}, batches "
        f"{st_on['batches']} + {st_off['batches']}), no new signature; "
        f"JSONL events {kinds}; {len(images)} request span trees of 4 "
        f"children inside their roots; /metrics parses, "
        f"can_tpu_serve_completed_total {len(images)}; serve_p99_deadline "
        f"not burning (samples {p99['samples']}, bad {p99['bad']}); "
        f"summarize: {summary['serve_requests']} requests")
    log(f"[obs] request latency at the client (reported, not gated: host-"
        f"bound): p50 {got_on['p50_ms']:.2f} / p99 {got_on['p99_ms']:.2f} ms "
        f"with telemetry on, {got_off['p50_ms']:.2f} / {got_off['p99_ms']:.2f}"
        f" ms off; JSONL {path.stat().st_size / len(images):.0f} bytes per "
        f"request ({path.stat().st_size} bytes, {len(events)} events)")
    # the fastest request as the service saw it (submit to respond)
    min_s = min(e["payload"]["latency_s"] for e in events
                if e["kind"] == "serve.request")
    return {"launches": launches, "min_s": min_s}


def obs_window_b(pth: Path, sd, work: Path, images, count,
                 min_latency_s: float) -> int:
    """The incident path on the two-replica fleet under replica_crash,
    then an SLO burn that the autoscaler answers."""
    from can_tpu_torch import obs
    from can_tpu_torch.obs.incidents import read_manifest
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.serve import Autoscaler, AutoscalePolicy
    from can_tpu_torch.testing import faults

    cc.reset_launches()  # window (b) starts here
    c0 = count.n
    inc = work / "fleet_inc"
    args, tel, hb, exporter = obs_stack(
        ["--torch-pth", str(pth), "--replicas", "2", "--incident-dir",
         str(inc), "--telemetry-heartbeat-s", "1"])
    os.environ[faults.FAULTS_ENV] = json.dumps({"faults": [
        {"kind": "replica_crash", "replica": 0, "batch": 2}]})
    faults._CACHED = faults._CACHED_SPEC = None
    try:
        fleet, svc = fleet_service(sd, "f32", tel)
        inj = faults.active_injector()
        with svc:
            serial = 0
            while not inj.fired and serial < 20:
                svc.predict(images[serial % len(images)], timeout=300)
                serial += 1
            fleet_burst(svc, images, 16)
        st = svc.stats()
        release_fleet(fleet)
    finally:
        del os.environ[faults.FAULTS_ENV]
        faults._CACHED = faults._CACHED_SPEC = None
        obs.shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    if not inj.fired or st["rejected"] or st["completed"] != serial + 16:
        fail(f"[obs] crash: fired {bool(inj.fired)}, {st['completed']} of "
             f"{serial + 16} completed, {st['rejected']} rejected")
    bundles = sorted(os.listdir(inc))
    if len(bundles) != 1 or not bundles[0].endswith("-fleet-quarantine"):
        fail(f"[obs] crash: bundles {bundles}, want one fleet_quarantine")
    bdir = inc / bundles[0]
    man = read_manifest(str(bdir))
    mtimes = {f.name: f.stat().st_mtime_ns for f in bdir.iterdir()}
    mem = json.loads((bdir / "memory.json").read_text())
    ring = [json.loads(x) for x in (bdir / "ring.jsonl").read_text().splitlines()]
    rows = [d for d in mem["devices"] if d["platform"] == "cuda" and d["id"] == 0]
    quar = [e for e in ring if e["kind"] == "fleet.replica"
            and e["payload"]["state"] == "quarantined"
            and e["payload"]["replica"] == 0]
    rep0 = man["info"]["serve_stats"]["replicas"]["0"] if man else {}
    if man is None or man["reason"] != "fleet_quarantine" \
            or mtimes["incident.json"] < max(mtimes.values()) \
            or not rows or rows[0]["bytes_in_use"] <= 0 \
            or rep0.get("quarantined") != 1 or not quar:
        fail(f"[obs] crash bundle: manifest {man and man['reason']}, "
             f"manifest last {mtimes.get('incident.json') == max(mtimes.values())}"
             f", memory rows {mem['devices']}, serve_stats replica 0 {rep0}, "
             f"quarantine events in the ring {len(quar)}")
    log(f"[obs] crash: replica_crash at replica 0's batch 2 on the 2-replica "
        f"fleet (cuda:0 x 2): {st['completed']} completed, 0 lost; one bundle "
        f"{bundles[0]} (files {man['files']}, manifest written last), memory "
        f"row cuda:0 bytes_in_use {rows[0]['bytes_in_use']} of "
        f"{rows[0]['bytes_limit']}, serve_stats replica 0 quarantined, the "
        f"ring's {len(ring)} events hold the quarantine")

    # an SLO whose p99 bound lies under every latency the card served
    threshold = min_latency_s / 2
    spec = work / "slo_tight.json"
    spec.write_text(json.dumps({"version": 1, "eval_interval_s": 0.05,
                                "objectives": [{
                                    "name": "serve_p99_tight",
                                    "event": "serve.request",
                                    "field": "latency_s", "op": "<=",
                                    "threshold": threshold, "target": 0.99,
                                    "windows_s": [60, 300], "burn_alert": 2.0,
                                    "min_samples": 4}]}))
    args, tel, hb, exporter = obs_stack(
        ["--torch-pth", str(pth), "--replicas", "2", "--slo-spec",
         str(spec), "--telemetry-dir", str(work / "tel_burn"),
         "--telemetry-heartbeat-s", "1"])
    try:
        fleet, svc = fleet_service(sd, "f32", tel)
        auto = Autoscaler(svc, AutoscalePolicy(min_replicas=2,
                                               max_replicas=FLEET_SLOTS,
                                               cooldown_s=0.0),
                          gauges=tel._gauge_sink)
        with svc:
            sent = 0
            while sent < 32 and not any(
                    g["name"].endswith("_slo_alerting") and g["value"]
                    for g in tel._gauge_sink.snapshot()["labelled_gauges"]):
                svc.predict(images[sent % len(images)], timeout=300)
                sent += 1
            actions = [auto.tick(now=float(i)) for i in range(2)]
            live = fleet.live_replicas()
        release_fleet(fleet)
    finally:
        obs.shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    burn = [g for g in tel._gauge_sink.snapshot()["labelled_gauges"]
            if g["name"].endswith("_slo_alerting")]
    events = [json.loads(x) for x in (work / "tel_burn" / "telemetry.host0.jsonl")
              .read_text().splitlines()]
    burns = [e["payload"] for e in events if e["kind"] == "slo.burn"
             and e["payload"]["alerting"]]
    scale = [e["payload"] for e in events if e["kind"] == "fleet.scale"]
    if actions != [None, "up"] or live != 3 or not burn or not burn[0]["value"] \
            or not burns or [p["reason"] for p in scale] != ["autoscale:slo_burn"]:
        fail(f"[obs] slo burn: alerting gauges {burn}, slo.burn alerts "
             f"{len(burns)}, autoscaler actions {actions}, scale events "
             f"{scale}, live {live}")
    launches, calls = cc.LAUNCHES, count.n - c0
    if launches != calls:
        fail(f"[obs] fleet windows: {launches} context launches for {calls} "
             f"predicts")
    labels = ",".join(f"{k}={v}" for k, v in burn[0]["labels"].items())
    log(f"[obs] slo burn: p99 bound {threshold * 1e3:.3f} ms (half the "
        f"fastest request of window (a)) burned after {sent} requests "
        f"(slo.burn burn_max {burns[0]['burn_max']}): {burn[0]['name']}"
        f"{{{labels}}} = {burn[0]['value']} on the GaugeSink; the autoscaler "
        f"handed it scaled up with reason {scale[0]['reason']}, live 2 -> "
        f"{live}; context_fused launches in the fleet windows {launches} = "
        f"predicts")
    return launches


# [aot]: the cold start of a serving process and the AOT bundle.  Each
# process is the serve CLI's path (``cli.serve.parse_args`` ->
# ``build_service``) in a fresh interpreter (``--ddp-worker`` with a
# "coldserve" spec), fleet mode with two replicas on the one card (the
# universe [cuda:0] x 2: --aot-bundle is fleet-only, as in JAX), started
# one after another so that none shares the machine with another:
#   cold   --compile-cache <empty dir>            (nvcc builds the library)
#   warm   --compile-cache <that dir> --aot-bake  (a cache hit; then bakes)
#   bundle --compile-cache <empty dir> --aot-bundle  (nvcc is made to fail:
#          the library must come from the bundle)
AOT_REPLICAS = 2
AOT_IMAGES = ((300, 400), (384, 512), (500, 700), (512, 768), (640, 900),
              (768, 1024), (450, 1000), (700, 500))


def aot_images() -> list:
    from can_tpu_torch.serve import prepare_image

    rng = np.random.default_rng(SEED + 7)
    return [prepare_image((rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8))
            for h, w in AOT_IMAGES]


def coldserve_worker(spec: dict) -> int:
    """One fresh serve CLI process of [aot]: the stamps of its start (the
    interpreter, torch, the device query, the package's imports, the CUDA
    context, the cuDNN and cuBLAS handles, then ``build_service``'s own
    stages to ready), the first answered request, the counts of
    ``aot_images`` one at a time, the warmup's launches, and the grid
    warmed again (its steady launches)."""
    t = {"launch": spec["t_launch"], "script": T_SCRIPT, "torch": T_TORCH,
         "device_query": T_AVAIL}
    import torch

    from can_tpu_torch.cli import serve as serve_cli
    from can_tpu_torch.ops import _build
    from can_tpu_torch.ops import cuda_context as cc

    t["imports"] = time.time()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    t["context"] = time.time()
    x = torch.zeros(1, 8, 8, 8, device=dev)
    torch.nn.functional.conv2d(x, torch.zeros(8, 8, 3, 3, device=dev), padding=1)
    torch.cuda.synchronize(dev)
    t["cudnn"] = time.time()
    torch.zeros(8, 8, device=dev) @ torch.zeros(8, 8, device=dev)
    torch.cuda.synchronize(dev)
    t["cublas"] = time.time()
    if spec.get("no_nvcc"):
        def refuse():
            raise RuntimeError("nvcc ran in a process that serves from a bundle")
        _build.find_nvcc = refuse
    # the fleet's universe: the one card, once per replica slot
    serve_cli.fleet_devices = lambda platform: [dev] * AOT_REPLICAS
    args = serve_cli.parse_args(spec["argv"])
    # the weights' stage split: the file's bytes, torch.load, the check
    import io

    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.utils import torch_import

    def timed_load(a):
        t0 = time.perf_counter()
        raw = Path(a.torch_pth).read_bytes()
        t1 = time.perf_counter()
        obj = torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True)
        t2 = time.perf_counter()
        sd = torch_import.check_state_dict(obj)
        t["weights_split"] = {"read": t1 - t0, "torch.load": t2 - t1,
                              "check": time.perf_counter() - t2, "bytes": len(raw)}
        return sd, None

    eval_cli.load_params = timed_load
    cc.reset_launches()  # the main path starts here
    service = serve_cli.build_service(args)
    t["ready"] = time.time()
    warm_launches = cc.LAUNCHES
    fleet = service.engine
    out = {"startup": service.startup,
           "build_info": {n: {"source": b["source"], "seconds": b["seconds"]}
                          for n, b in _build.build_info.items()},
           "compile_count": fleet.compile_count,
           "warm_aot_hits": sum(r.engine.aot_hits for r in fleet.replicas),
           "warm_launches": warm_launches}
    images = aot_images()
    counts = []
    with service:
        for i, img in enumerate(images):
            res = service.predict(img, deadline_ms=120_000)
            if i == 0:
                t["first_answer"] = time.time()
            counts.append(float(res.count))
    out["counts"] = counts
    out["aot_hits"] = sum(r.engine.aot_hits for r in fleet.replicas)
    out["compile_count_after"] = fleet.compile_count
    shapes, max_batch, dtypes, sizes = fleet._warmup_spec
    t0 = time.perf_counter()
    fleet.warmup(shapes, max_batch, dtypes=dtypes, sizes=sizes)
    out["rewarm_s"] = time.perf_counter() - t0
    out["launches"] = cc.LAUNCHES  # ... and ends here
    out["libraries"] = sorted(p.name for p in Path(spec["cache"]).rglob("*.so"))
    out["t"] = t
    for r in fleet.replicas:
        r.engine.release_buffers()
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def aot_process(work: Path, tag: str, argv: list, cache: Path, **extra) -> dict:
    """One fresh serve CLI process (``coldserve_worker``); its result."""
    leg = work / "aot" / tag
    leg.mkdir(parents=True, exist_ok=True)
    spec = leg / "spec.json"
    spec.write_text(json.dumps({"mode": "coldserve", "argv": argv, "cache": str(cache),
                                "out": str(leg / "out.json"), "t_launch": time.time(),
                                **extra}))
    run_ranks([([sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker", str(spec)],
                dict(os.environ))], work / "aot", tag)
    return json.loads((leg / "out.json").read_text())


def aot_split(tag: str, out: dict) -> None:
    t, st = out["t"], out["startup"]
    stages = [("interpreter", t["script"] - t["launch"]),
              ("import torch", t["torch"] - t["script"]),
              ("device query", t["device_query"] - t["torch"]),
              ("package imports", t["imports"] - t["device_query"]),
              ("CUDA context", t["context"] - t["imports"]),
              ("cuDNN handle", t["cudnn"] - t["context"]),
              ("cuBLAS handle", t["cublas"] - t["cudnn"]),
              (f"kernel library ({st['kernel_source']})", st["kernel_seconds"]),
              ("weights", st["weights"])]
    stages += [(f"(weights: {k})", v) for k, v in t["weights_split"].items()
               if k != "bytes"]
    stages += [("engines", st["engines"]), ("warmup", st["warmup"]),
               ("first answer", t["first_answer"] - t["ready"])]
    rest = (t["ready"] - t["cublas"]) - st["total"]
    log(f"[aot] {tag}: launch -> first answered request "
        f"{t['first_answer'] - t['launch']:.2f} s = "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages)
        + f" (build_service's other work {rest + st['kernels'] - st['kernel_seconds']:.3f}); "
        f"time to first ready {t['ready'] - t['launch'] - st.get('bake', 0.0):.2f} s"
        + (f" (then the bake {st['bake']:.2f} s)" if "bake" in st else "") + "; warmup "
        f"{st['warmup']:.3f} s against the same grid warmed again "
        f"{out['rewarm_s']:.3f} s (first launches of {out['warm_launches']} "
        f"signature launches: +{st['warmup'] - out['rewarm_s']:.3f} s)")


def aot_refusals(pth: Path, bundle: Path, work: Path) -> None:
    """A stale bundle is refused naming its axis, before anything runs:
    the kernel source hash and the torch version (a tampered copy of the
    manifest), and the batch geometry (another --max-batch), through
    ``build_service`` as the CLI exits."""
    import shutil

    import torch

    from can_tpu_torch.cli import serve as serve_cli
    from can_tpu_torch.serve.aot import MANIFEST_NAME

    cases = []
    for axis, edit in (("torch_version", lambda m: m.update(torch_version="0.0")),
                       ("kernel_sources", lambda m: m["kernel_sources"].update(
                           context_fused="0" * 16))):
        stale = work / "aot" / f"stale_{axis}"
        shutil.rmtree(stale, ignore_errors=True)
        shutil.copytree(bundle, stale)
        m = json.loads((stale / MANIFEST_NAME).read_text())
        edit(m)
        (stale / MANIFEST_NAME).write_text(json.dumps(m))
        cases.append((axis, stale, []))
    cases.append(("max_batch", bundle, ["--max-batch", "4"]))
    dev = torch.device("cuda", 0)
    saved = serve_cli.fleet_devices
    serve_cli.fleet_devices = lambda platform: [dev] * AOT_REPLICAS
    try:
        for axis, path, extra in cases:
            args = serve_cli.parse_args(aot_argv(pth) + ["--aot-bundle", str(path)] + extra)
            try:
                serve_cli.build_service(args)
            except SystemExit as e:
                msg = str(e)
            else:
                fail(f"[aot] a bundle stale on {axis} was served")
            if not msg.startswith(f"--aot-bundle refused: AOT bundle stale on {axis}"):
                fail(f"[aot] the bundle stale on {axis} was refused with {msg!r}")
            log(f"[aot] stale on {axis}: {msg[:150]}")
    finally:
        serve_cli.fleet_devices = saved


def aot_argv(pth: Path) -> list:
    return ["--torch-pth", str(pth), "--replicas", str(AOT_REPLICAS),
            "--max-batch", str(MAX_BATCH), "--deadline-ms", "120000"]


def phase_aot(pth: Path, work: Path) -> dict:
    """The split of a cold serve CLI process with the build directory cold
    and warm, a bake, a fresh process from the bundle (no nvcc: every
    library from the bundle, counts bitwise equal to the warm path, AOT
    hits, no first-seen signature), stale bundles refused."""
    import shutil

    t_phase = time.perf_counter()
    base = work / "aot"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    cache, empty, bundle = base / "cache", base / "cache_bundle", base / "bundle"
    argv = aot_argv(pth)
    cold = aot_process(work, "cold", argv + ["--compile-cache", str(cache)], cache)
    warm = aot_process(work, "warm", argv + ["--compile-cache", str(cache),
                                             "--aot-bake", str(bundle)], cache)
    aot = aot_process(work, "bundle", argv + ["--compile-cache", str(empty),
                                              "--aot-bundle", str(bundle)], empty,
                      no_nvcc=True)
    for tag, out, source in (("cold", cold, "built"), ("warm", warm, "cache"),
                             ("bundle", aot, "bundle")):
        got = {n: b["source"] for n, b in out["build_info"].items()}
        if got != {"context_fused": source}:
            fail(f"[aot] {tag}: kernel libraries {got}, want context_fused from {source}")
        aot_split(tag, out)
    if aot["libraries"]:
        fail(f"[aot] the bundle process built {aot['libraries']} into its cache")
    sigs = cold["compile_count"]
    # every warmup launch is a context launch: a short count is a plain fallback
    for tag, out in (("cold", cold), ("warm", warm)):
        if (out["warm_launches"] != out["compile_count"] or out["warm_aot_hits"]
                or out["compile_count_after"] != out["compile_count"]):
            fail(f"[aot] {tag}: warmup launches {out['warm_launches']}, signatures "
                 f"{out['compile_count']} -> {out['compile_count_after']}, AOT hits "
                 f"{out['warm_aot_hits']}")
    if (aot["compile_count"] or aot["compile_count_after"]
            or aot["warm_aot_hits"] != sigs or aot["warm_launches"] != sigs
            or aot["aot_hits"] <= aot["warm_aot_hits"]):
        fail(f"[aot] bundle process: signatures {aot['compile_count']} -> "
             f"{aot['compile_count_after']}, warmup AOT hits {aot['warm_aot_hits']} and "
             f"launches {aot['warm_launches']} (want {sigs} each), AOT hits after "
             f"traffic {aot['aot_hits']}")
    if not (cold["counts"] == warm["counts"] == aot["counts"]):
        fail(f"[aot] counts differ: cold {cold['counts']}, warm {warm['counts']}, "
             f"bundle {aot['counts']}")
    if not all(np.isfinite(c) for c in aot["counts"]):
        fail(f"[aot] non-finite counts {aot['counts']}")
    m = json.loads((bundle / "aot_manifest.json").read_text())
    log(f"[aot] bundle: {len(m['programs'])} programs on device(s) "
        f"{sorted({p['device_id'] for p in m['programs']})}, libraries "
        + ", ".join(f"{lib['name']} ({lib['bytes']} B)" for lib in m["libraries"])
        + f", device_kind {m['device_kind']!r}, torch {m['torch_version']} cuda "
        f"{m['cuda_version']}, baked in {m['bake_seconds']} s")
    log(f"[aot] the bundle process: every library from the bundle (nvcc made to fail, "
        f"its cache {empty.name} empty), {sigs} warmup launches all AOT hits, "
        f"{aot['aot_hits']} AOT hits after {len(AOT_IMAGES)} requests, no first-seen "
        f"signature; the {len(AOT_IMAGES)} counts bitwise equal to the cold and warm "
        f"processes' ({aot['counts'][0]!r} ...)")
    first = {tag: out["t"]["ready"] - out["t"]["launch"] - out["startup"].get("bake", 0.0)
             for tag, out in (("cold build", cold), ("warm cache", warm), ("bundle", aot))}
    log("[aot] time to first ready: " + ", ".join(f"{k} {v:.2f} s" for k, v in first.items())
        + "; to the first answered request: "
        + ", ".join(f"{k} {o['t']['first_answer'] - o['t']['launch']:.2f} s"
                    for k, o in (("cold build", cold), ("warm cache", warm),
                                 ("bundle", aot))))
    aot_refusals(pth, bundle, work)
    context = sum(out["launches"] for out in (cold, warm, aot))
    log(f"[aot] the phase took {time.perf_counter() - t_phase:.1f} s; context launches "
        f"{context}")
    return {"bn": 0, "bn_backward": 0, "context": context}


def phase_obs(pth: Path, work: Path) -> dict:
    """Telemetry on the serving path (slice 11); returns the context
    launches its services made."""
    import shutil

    from can_tpu_torch.serve import prepare_image
    from can_tpu_torch.utils.torch_import import load_torch_checkpoint

    t_phase = time.perf_counter()
    work = work / "obs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    h, w = SLICE8_BUCKET
    rng = np.random.default_rng(SEED + 11)
    raw = [rng.integers(0, 256, (h - 8 * (i % 3), w - 8 * (i % 5), 3),
                        dtype=np.uint8) for i in range(OBS_REQUESTS)]
    count = PredictCount()
    try:
        a = obs_window_a(pth, work, raw, count)
        images = [prepare_image(x) for x in raw[:8]]
        sd = load_torch_checkpoint(str(pth))
        b = obs_window_b(pth, sd, work, images, count, a["min_s"])
    finally:
        count.close()
    log(f"[obs] phase {time.perf_counter() - t_phase:.1f} s; context_fused "
        f"launches {a['launches']} + {b}")
    return {"bn": 0, "bn_backward": 0, "context": a["launches"] + b}


# [obs] train and eval windows (slice 12): the train CLI with the cost
# ledger, the step trace window and the metrics exporter on, against the
# same run with telemetry off; then the eval CLI on that checkpoint, on
# and off.  Two launch shapes, each OBS_TRAIN_STEPS times: a first call
# plus four timed launches (MIN_UNFENCED_LAUNCHES), so the ledger's MFU
# and its launch-cost fit have what they need (nine timed launches read
# the same MFU on the card, PERF.md §6 PR 12, for 20 s more)
OBS_TRAIN_SIZES = ((576, 768), (512, 640))
OBS_TRAIN_STEPS = 5
# --trace-steps 2:4: steps 2 and 3, whose trace holds exactly 2 x 16
# records of each BN kernel.  A window one step off holds 16 or 48; a
# session that loses its first launches' records (as it did before
# obs.trace warmed the profiler up) holds 31
OBS_TRACE = (2, 4)
OBS_EVAL_RTOL = 1e-6


def obs_train_data(work: Path) -> Path:
    """TRAIN_BATCH x OBS_TRAIN_STEPS images at each of OBS_TRAIN_SIZES
    (train; whole batches, so every step is one of the two shapes) and
    TEST_ITEMS mixed (test)."""
    import shutil

    from can_tpu_torch.data import make_synthetic_dataset

    root = work / "synth"
    for sub in ("images", "ground_truth"):
        (root / "train_data" / sub).mkdir(parents=True)
    n, per = 0, TRAIN_BATCH * OBS_TRAIN_STEPS
    for i, size in enumerate(OBS_TRAIN_SIZES):
        part = work / f"part{i}"
        make_synthetic_dataset(str(part), per, sizes=(size,), seed=SEED + 20 + i)
        for k in range(per):
            for sub, ext in (("images", "png"), ("ground_truth", "npy")):
                (part / sub / f"IMG_{k:04d}.{ext}").rename(
                    root / "train_data" / sub / f"IMG_{n:04d}.{ext}")
            n += 1
        shutil.rmtree(part)
    make_synthetic_dataset(str(root / "test_data"), TEST_ITEMS,
                           sizes=OBS_TRAIN_SIZES, seed=SEED + 22)
    return root


def _launch_counts() -> dict:
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    return {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
            "context": cc.LAUNCHES}


def _reset_launches() -> None:
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    cb.reset_launches()
    cc.reset_launches()


def _tel_argv(d: Path) -> list:
    return ["--telemetry-dir", str(d / "tel"), "--trace-steps",
            f"{OBS_TRACE[0]}:{OBS_TRACE[1]}", "--profile-dir", str(d / "prof"),
            "--metrics-port", "0"]


def _step_periods(marks: list, first: set) -> list:
    """Each step's period in ms, from its start event to the next step's
    (the last step has none): ``[(ordinal, shape, group, ms)]``, the group
    ``first`` for the first call of a shape (the counting scope runs in
    it), ``window`` for the steps whose period holds the trace window
    (ordinals OBS_TRACE[0] - 1 .. OBS_TRACE[1] - 1: the start's sync, the
    profiled steps, the stop and the export), else ``steady``."""
    import torch

    torch.cuda.synchronize()
    window = set(range(OBS_TRACE[0] - 1, OBS_TRACE[1]))
    return [(k, marks[k][0],
             "first" if k in first else "window" if k in window else "steady",
             marks[k][1].elapsed_time(marks[k + 1][1]))
            for k in range(len(marks) - 1)]


def _timed_epochs(marks: list, first: set):
    """``train_one_epoch`` with a CUDA event recorded as each step starts
    (inside the loop's own instrumentation, the same on both runs; an
    event is no kernel launch and touches no tensor)."""
    import torch

    from can_tpu_torch import train as tr

    real = tr.train_one_epoch

    def epoch(train_step, state, batches, **kw):
        def step(state, dev):
            shape = tuple(dev["image"].shape)
            if shape not in {m[0] for m in marks}:
                first.add(len(marks))
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((shape, ev))
            return train_step(state, dev)

        return real(step, state, batches, **kw)

    return real, epoch


def obs_train_run(root: Path, work: Path, bf16: bool, telemetry: bool) -> dict:
    """The train CLI (BN model, kernel moments, batch 8, one epoch and its
    eval); its summary, wall time, the launches of this run and its step
    periods (``_step_periods``)."""
    from can_tpu_torch import train as tr
    from can_tpu_torch.cli import train as cli

    d = work / f"train_{'bf16' if bf16 else 'f32'}_{'on' if telemetry else 'off'}"
    argv = ["--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
            "--batch-size", str(TRAIN_BATCH), "--pad-multiple", str(TRAIN_PAD),
            "--epochs", "1", "--lr", "1e-6", "--seed", str(SEED),
            "--checkpoint-dir", str(d / "ck")]
    argv += (["--bf16"] if bf16 else []) + (_tel_argv(d) if telemetry else [])
    marks, first = [], set()
    real, tr.train_one_epoch = _timed_epochs(marks, first)
    try:
        _reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        summary = cli.train(cli.parse_args(argv))
        wall = time.perf_counter() - t0
        launches = _launch_counts()  # ... and ends here
    finally:
        tr.train_one_epoch = real
    return {"summary": summary, "wall_s": wall, "launches": launches, "dir": d,
            "periods": _step_periods(marks, first)}


def _state_tensors(ckpt: Path, map_location=None) -> dict:
    """Every tensor of a checkpoint's state (weights, running statistics,
    momentum), by path (on the card that saved it, or ``map_location``)."""
    import torch

    out = {}

    def walk(x, key):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{key}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{key}.{i}")
        elif isinstance(x, torch.Tensor):
            out[key] = x

    state = torch.load(ckpt / "0" / "state.pt", weights_only=True,
                       map_location=map_location)
    for part in ("model", "optimizer"):
        walk(state[part], part)
    return out


def trace_counts(prof: Path) -> dict:
    """The one Chrome trace a window wrote: optimizer steps (CPU-side
    annotations, one per train step), BN kernel records, and the window's
    launches that left no kernel record (matched by CUPTI's correlation
    id: ``lost``, each as its API call, its ms after the window's first
    launch, its ordinal among that call's launches in the window, and the
    optimizer steps before it)."""
    files = sorted(prof.iterdir()) if prof.is_dir() else []
    if len(files) != 1:
        fail(f"[obs] {prof} holds {[f.name for f in files]}: want one trace")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in kernels]
    seen = {e.get("args", {}).get("correlation") for e in kernels}
    launches = sorted((e for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])
    steps_end = sorted(e["ts"] + e.get("dur", 0) for e in events
                       if e.get("cat") == "user_annotation"
                       and e.get("name", "").startswith("Optimizer.step#"))
    lost, ordinal = [], {}
    for e in launches:
        api = e["name"]
        ordinal[api] = ordinal.get(api, -1) + 1
        if e.get("args", {}).get("correlation") not in seen:
            lost.append({"api": api,
                         "ms": round((e["ts"] - launches[0]["ts"]) / 1e3, 3),
                         "of_api": f"{ordinal[api]}/{sum(x['name'] == api for x in launches)}",
                         "after_steps": sum(t < e["ts"] for t in steps_end)})
    return {"steps": len(steps_end),
            "bn": sum("bn_moments_ring_kernel" in k for k in names),
            "bn_backward": sum("bn_moments_backward_kernel" in k for k in names),
            "kernels": len(kernels), "launches": len(launches),
            "window_ms": round((launches[-1]["ts"] - launches[0]["ts"]) / 1e3, 3)
            if launches else 0.0,
            "lost": lost, "bytes": files[0].stat().st_size}


def check_obs_train(on: dict, off: dict, tag: str) -> dict:
    """The train window's gates; returns the reported numbers."""
    steps = on["summary"]["steps"]
    if steps != off["summary"]["steps"] or steps != 2 * OBS_TRAIN_STEPS:
        fail(f"[obs] train {tag}: {steps} steps on, {off['summary']['steps']} "
             f"off; want {2 * OBS_TRAIN_STEPS}")
    a, b = _state_tensors(on["dir"] / "ck"), _state_tensors(off["dir"] / "ck")
    diff = sorted(k for k in a if k not in b or not bool((a[k] == b[k]).all()))
    if a.keys() != b.keys() or diff:
        fail(f"[obs] train {tag}: telemetry on and off differ in {diff[:5]} "
             f"(of {len(a)} tensors): training must be bitwise the same")
    if on["launches"] != off["launches"] \
            or on["launches"]["bn"] != BN_LAYERS * steps:
        fail(f"[obs] train {tag}: launches on {on['launches']} against off "
             f"{off['launches']} (bn_moments want {BN_LAYERS} x {steps})")
    events = [json.loads(x) for x in
              (on["dir"] / "tel" / "telemetry.host0.jsonl").read_text().splitlines()]
    perf = [e["payload"] for e in events
            if e["kind"] == "perf.summary" and e["payload"]["phase"] == "train"]
    rows = {tuple(r["shape"]): r for r in perf[-1]["detail"]
            if r["name"] == "train_step"} if perf else {}
    big = rows.get((TRAIN_BATCH, *OBS_TRAIN_SIZES[0], 3))
    if not big or big["mfu"] is None or big["roofline"] not in ("compute", "memory") \
            or len(rows) != len(OBS_TRAIN_SIZES):
        fail(f"[obs] train {tag}: the epoch's perf.summary rows {rows}: want "
             f"train_step at both shapes, MFU and a roofline class at "
             f"{(TRAIN_BATCH, *OBS_TRAIN_SIZES[0], 3)}")
    tr = trace_counts(on["dir"] / "prof")
    span = OBS_TRACE[1] - OBS_TRACE[0]
    want = span * BN_LAYERS
    if tr["steps"] != span or tr["bn"] != want or tr["bn_backward"] != want:
        fail(f"[obs] train {tag}: the --trace-steps {OBS_TRACE[0]}:"
             f"{OBS_TRACE[1]} trace holds {tr['steps']} optimizer steps, "
             f"{tr['bn']} bn_moments and {tr['bn_backward']} "
             f"bn_moments_backward kernel records; want {span}, and {want} "
             f"of each; launches without a record {tr['lost']} of "
             f"{tr['launches']} over {tr['window_ms']} ms")
    summ = perf[-1]
    for shape, r in sorted(rows.items()):
        log(f"[obs] train {tag} ledger row {shape}: {r['flops'] / 1e12:.3f} "
            f"TFLOP, {r['bytes_accessed'] / 1e9:.2f} GB accessed (unfused), "
            f"intensity {r['intensity']}, {r['roofline']}-bound, "
            f"{r['launches']} timed launches, mean {r['mean_s']} s, MFU "
            f"{r['mfu']}")
    fit = {k: summ.get(k) for k in ("launch_cost_fit_name", "rate_mpx_s",
                                    "intercept_s", "launch_cost_mpx_empirical",
                                    "launch_cost_drift", "fit_points")}
    log(f"[obs] train {tag} (reported, not gated): MFU {big['mfu']} at "
        f"{(TRAIN_BATCH, *OBS_TRAIN_SIZES[0], 3)} against "
        f"{summ['peak_source']} {summ['peak_flops'] / 1e12:.0f} TFLOP/s; "
        f"mfu_weighted {summ.get('mfu_weighted')}; launch-cost fit {fit} "
        f"(planned DEFAULT_LAUNCH_COST_MPX 0.00086); epoch wall "
        f"{on['summary']['epochs'][-1]['epoch_s']:.3f} s on, "
        f"{off['summary']['epochs'][-1]['epoch_s']:.3f} s off (first calls "
        f"included; the on run counts them); CLI wall {on['wall_s']:.2f} / "
        f"{off['wall_s']:.2f} s")
    med = {}
    for shape in sorted({p[1] for p in on["periods"] + off["periods"]}):
        got = [[ms for _, sh, g, ms in run["periods"] if sh == shape and g == "steady"]
               for run in (on, off)]
        med[shape] = [statistics.median(x) if x else float("nan") for x in got]
        log(f"[obs] train {tag} steady-state step {shape} (reported, not "
            f"gated; CUDA events at each step's start, first calls and the "
            f"trace window's steps left out): median {med[shape][0]:.3f} ms "
            f"on ({len(got[0])} steps) against {med[shape][1]:.3f} ms off "
            f"({len(got[1])}); telemetry costs "
            f"{med[shape][0] - med[shape][1]:+.3f} ms a step "
            f"({(med[shape][0] - med[shape][1]) / med[shape][1]:+.2%})")
    by = {g: [sum(ms for *_, gg, ms in run["periods"] if gg == g)
              for run in (on, off)] for g in ("first", "window", "steady")}
    log(f"[obs] train {tag} step periods on / off by group (ms, summed): "
        + ", ".join(f"{g} {a:.1f} / {b:.1f} ({a - b:+.1f})"
                    for g, (a, b) in by.items())
        + "; every period (ordinal, group, ms) on "
        + str([(k, g[0], round(ms, 1)) for k, _, g, ms in on["periods"]])
        + " off " + str([(k, g[0], round(ms, 1)) for k, _, g, ms in off["periods"]]))
    log(f"[obs] train {tag}: telemetry on = off bitwise ({len(a)} tensors: "
        f"weights, running stats, momentum), launches {on['launches']} both; "
        f"trace {OBS_TRACE[0]}:{OBS_TRACE[1]}: {tr['steps']} optimizer steps, "
        f"{tr['bn']} bn_moments + {tr['bn_backward']} bn_moments_backward "
        f"records of {tr['kernels']} kernels ({tr['bytes'] / 1e6:.1f} MB); "
        f"launches without a record (the warm-up's) {tr['lost']} of "
        f"{tr['launches']} over {tr['window_ms']} ms")
    return {"mfu": big["mfu"], "fit": fit, "mean_s": big["mean_s"],
            "step_ms": med}


def obs_eval(root: Path, ckpt: Path, work: Path, bf16: bool) -> dict:
    """The eval CLI on ``ckpt`` with the train window's flags, and off:
    MAE and MSE equal within OBS_EVAL_RTOL; returns the context launches."""
    from can_tpu_torch.cli import test as cli

    tag = "bf16" if bf16 else "f32"
    base = (["--data_root", str(root), "--checkpoint-dir", str(ckpt), "--syncBN"]
            + (["--bf16"] if bf16 else []))
    out, launches = {}, {}
    for mode in ("on", "off"):
        d = work / f"eval_{tag}_{mode}"
        _reset_launches()  # the main path starts here
        out[mode] = cli.evaluate_checkpoint(cli.parse_args(
            base + (_tel_argv(d) if mode == "on" else [])))
        launches[mode] = _launch_counts()  # ... and ends here
    for k in ("mae", "mse"):
        rel = abs(out["on"][k] - out["off"][k]) / abs(out["off"][k])
        if rel > OBS_EVAL_RTOL:
            fail(f"[obs] eval {tag}: {k} on {out['on'][k]!r} off "
                 f"{out['off'][k]!r} (rel {rel:.2e} > {OBS_EVAL_RTOL})")
    d = work / f"eval_{tag}_on"
    events = [json.loads(x) for x in
              (d / "tel" / "telemetry.host0.jsonl").read_text().splitlines()]
    perf = [e["payload"] for e in events if e["kind"] == "perf.summary"]
    rows = [r for r in perf[-1]["detail"] if r["name"] == "eval_step"] if perf else []
    tr = trace_counts(d / "prof")
    if launches["on"] != launches["off"] or not rows \
            or launches["on"]["context"] != out["on"]["batches"] \
            or tr["kernels"] == 0:
        fail(f"[obs] eval {tag}: launches on {launches['on']} off "
             f"{launches['off']} for {out['on']['batches']} batches, "
             f"eval_step rows {rows}, trace kernels {tr['kernels']}")
    log(f"[obs] eval {tag}: MAE {out['on']['mae']:.9g} MSE "
        f"{out['on']['mse']:.9g} on = off (rtol {OBS_EVAL_RTOL}), "
        f"context_fused {launches['on']['context']} launches each; ledger "
        + ", ".join(f"{tuple(r['shape'])} MFU {r['mfu']} {r['roofline']}"
                    for r in rows)
        + f"; trace {tr['kernels']} kernel records")
    return {k: launches["on"][k] + launches["off"][k] for k in launches["on"]}


def phase_obs_train(work: Path) -> dict:
    """The device side of telemetry (slice 12) on the train and eval CLIs;
    returns the launches of every run."""
    import shutil

    t_phase = time.perf_counter()
    work = work / "obs_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    root = obs_train_data(work)
    total = {"bn": 0, "bn_backward": 0, "context": 0}
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        on = obs_train_run(root, work, bf16, telemetry=True)
        off = obs_train_run(root, work, bf16, telemetry=False)
        check_obs_train(on, off, tag)
        ev = obs_eval(root, on["dir"] / "ck", work, bf16)
        for k in total:
            total[k] += on["launches"][k] + off["launches"][k] + ev[k]
    log(f"[obs] train/eval windows {time.perf_counter() - t_phase:.1f} s; "
        f"launches {total}")
    return total


def _bn_mask(b: int, h: int, w: int, device) -> "torch.Tensor":
    """Bucket padding (bottom quarter, right third) and, for b > 1, one
    fill slot."""
    import torch

    m = torch.ones((b, h, w, 1), device=device)
    m[:, h - h // 4:] = 0
    m[:, :, w - w // 3:] = 0
    if b > 1:
        m[-1] = 0
    return m


def check_bn_sums(got, y, m, what: str) -> float:
    """Kernel sums against the plain version on the same inputs; returns
    the max abs error over s1 and s2."""
    import torch

    from can_tpu_torch.ops import cuda_bn as cb

    yf = y.detach().float()
    w1, w2, w0 = cb.masked_moment_sums(yf, m)
    s1, s2, s0 = (t.detach() for t in got)
    e1, e2 = (s1 - w1).abs(), (s2 - w2).abs()
    scale1 = torch.sum((yf * m).abs(), dim=(0, 1, 2))
    scale2 = torch.sum(yf * yf * m, dim=(0, 1, 2))
    if not bool(torch.isfinite(s1).all() and torch.isfinite(s2).all()):
        fail(f"bn_moments {what}: non-finite sums")
    if not bool((e1 <= BN_RTOL * scale1).all() and (e2 <= BN_RTOL * scale2).all()):
        fail(f"bn_moments {what}: sums off by {float(e1.max()):.3e} / "
             f"{float(e2.max()):.3e}, over {BN_RTOL} of sum|y m| / sum y^2 m")
    if float(s0) != float(w0):
        fail(f"bn_moments {what}: s0 {float(s0)!r} != {float(w0)!r}")
    return max(float(e1.max()), float(e2.max()))


def bn_bound(y, m, peaks: dict):
    """Least time for the moment sums on these inputs, the kernel's work
    as the cost ledger counts it (``cuda_bn.moment_sums_cost``: y and the
    mask read once, (2C + 1) f32 written; 4 f32 operations per element of
    y on CUDA cores, bf16 being widened): (ms, bound by, bytes)."""
    from can_tpu_torch.ops import cuda_bn as cb

    flops, nbytes = cb.moment_sums_cost(y, m)
    return (*_bound(flops, nbytes, peaks["f32"], peaks), nbytes)


class _Saved:
    """What ``MomentSums.backward`` reads of its autograd context."""

    def __init__(self, *tensors):
        self.saved_tensors = tensors


def bn_backward_bound(y, m, peaks: dict):
    """Least time for the BN backward dy = m (g1 + 2 g2 y) on these
    inputs (``cuda_bn.moment_sums_backward_cost``: y, the mask, g1 and g2
    read once, dy written once; 3 f32 operations per element):
    (ms, bound by, bytes)."""
    from can_tpu_torch.ops import cuda_bn as cb

    flops, nbytes = cb.moment_sums_backward_cost(y, m)
    return (*_bound(flops, nbytes, peaks["f32"], peaks), nbytes)


def check_bn_backward(got, want, y, name: str, what: str) -> float:
    """The backward kernel's dy against its plain twin: f32 within rtol
    1e-6, bf16 within one bf16 rounding; returns the max abs error."""
    import torch

    if got.dtype != y.dtype or got.shape != y.shape:
        fail(f"bn_moments_backward {what}: dy {got.dtype} {tuple(got.shape)}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"bn_moments_backward {what}: non-finite dy")
    err = (g - w).abs()
    rtol = BWD_RTOL[name]
    if not bool((err <= rtol * w.abs() + 1e-30).all()):
        fail(f"bn_moments_backward {what}: dy off by {float(err.max()):.3e}, "
             f"over rtol {rtol}")
    return float(err.max())


def check_bn_kernels(y, m, g1, g2, name: str, what: str):
    """Both BN kernels against their plain versions on one input: the
    forward's sums (s0 exact) and the backward's dy, each bitwise equal on
    a second run; returns (forward, backward) max abs errors."""
    import torch

    from can_tpu_torch.ops import cuda_bn as cb

    sums = cb.moment_sums_cuda(y, m)
    torch.cuda.synchronize()
    err_f = check_bn_sums(sums, y, m, what)
    if not all(torch.equal(a, b) for a, b in zip(sums, cb.moment_sums_cuda(y, m))):
        fail(f"bn_moments {what}: two runs differ")
    dy = cb.moment_sums_backward_cuda(y, m, g1, g2)
    torch.cuda.synchronize()
    want = cb.masked_moment_sums_backward(y, m, g1, g2)
    err_b = check_bn_backward(dy, want, y, name, what)
    if not torch.equal(dy, cb.moment_sums_backward_cuda(y, m, g1, g2)):
        fail(f"bn_moments_backward {what}: two runs differ")
    return err_f, err_b


def bn_cases():
    """Seeded inputs at every BN shape, f32 and bf16: ``(shape, count,
    dtype name, y, m, g1, g2)``, ``count`` the step's BN layers at that
    shape (0 for BN_RAGGED_SHAPE, last, which is not one of them)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for shape, count in BN_STEP_SHAPES + ((BN_RAGGED_SHAPE, 0),):
        b, h, w, c = shape
        y32 = torch.randn(shape, generator=g, device="cuda") * 2 + 0.5
        m = _bn_mask(b, h, w, "cuda")
        g1 = torch.randn((c,), generator=g, device="cuda")
        g2 = torch.randn((c,), generator=g, device="cuda")
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            yield shape, count, name, y32.to(dt), m, g1, g2


def bn_time(y, m, g1, g2, peaks: dict, what: str) -> dict:
    """The BN forward (``moment_sums_cuda``) and backward
    (``MomentSums.backward``) on one input: device time per call by
    torch.profiler with the device kernels of a call, single-call time by
    CUDA events and host time per call, beside their bounds."""
    from can_tpu_torch.ops import cuda_bn as cb

    def fwd():
        return cb.moment_sums_cuda(y, m)

    def bwd():
        return cb.MomentSums.backward(_Saved(y, m), g1, g2, None)[0]

    fk, f_dev = device_kernels(fwd)
    f_call = time_ms(fwd)
    bk, b_dev = device_kernels(bwd)
    b_call = time_ms(bwd)
    f_host, b_host = host_us(fwd), host_us(bwd)
    f_bound, f_by, f_bytes = bn_bound(y, m, peaks)
    b_bound, b_by, b_bytes = bn_backward_bound(y, m, peaks)
    log(f"[bn] {what} forward: device {f_dev:.4f} ms "
        f"({', '.join(f'{n} x{k:g}' for n, _, k in fk)}), call "
        f"{f_call:.4f} ms, bound {f_bound:.4f} ms ({f_by}: "
        f"{f_bytes / 1e6:.1f} MB), {100 * f_bound / f_dev:.1f}% of "
        f"bound (device), {100 * f_bound / f_call:.1f}% (call); host "
        f"{f_host:.1f} us/call")
    log(f"[bn] {what} backward: device {b_dev:.4f} ms "
        f"({len(bk)} kernels, {sum(k for _, _, k in bk):g} launches: "
        f"{', '.join(f'{n} {ms:.4f}' for n, ms, _ in bk)[:400]}), call "
        f"{b_call:.4f} ms, bound {b_bound:.4f} ms ({b_by}: y + m + dy "
        f"{b_bytes / 1e6:.1f} MB), {100 * b_bound / b_dev:.1f}% of "
        f"bound (device), {100 * b_bound / b_call:.1f}% (call); host "
        f"{b_host:.1f} us/call")
    return {"fk": fk, "f_dev": f_dev, "f_call": f_call, "f_bound": f_bound,
            "f_by": f_by, "b_dev": b_dev, "b_call": b_call, "b_bound": b_bound,
            "b_by": b_by}


def bn_totals(rows: dict) -> None:
    """The per-shape times summed over the step's BN layers."""
    for name in ("f32", "bf16"):
        tot = {k: sum(r[k] * count for (_, count, n), r in rows.items() if n == name)
               for k in ("f_dev", "f_call", "f_bound", "b_dev", "b_call", "b_bound")}
        log(f"[bn] {name} step total over its {BN_LAYERS} BN layers: forward "
            f"device {tot['f_dev']:.3f} ms, call {tot['f_call']:.3f} ms, bound "
            f"{tot['f_bound']:.3f} ms ({100 * tot['f_bound'] / tot['f_dev']:.1f}% "
            f"of bound, device); backward device {tot['b_dev']:.3f} ms, call "
            f"{tot['b_call']:.3f} ms, bound {tot['b_bound']:.3f} ms "
            f"({100 * tot['b_bound'] / tot['b_dev']:.1f}% of bound, device)")


def phase_bn(peaks: dict) -> dict:
    """The BN kernels at every distinct BN shape of the (8, 576, 768)
    step, f32 and bf16: held against their plain versions (one device
    kernel per forward call), then timed (``bn_time``); and checked at
    BN_RAGGED_SHAPE.  Returns the kernels-line numbers of the forward and
    the backward (times at the largest layer, f32; the worst error over
    every shape)."""
    import torch

    from can_tpu_torch.ops import cuda_bn as cb

    rows, worst, worst_f = {}, 0.0, 0.0
    for shape, count, name, y, m, g1, g2 in bn_cases():
        what = f"{shape} {name}"
        err_f, err_b = check_bn_kernels(y, m, g1, g2, name, what)
        worst_f, worst = max(worst_f, err_f), max(worst, err_b)
        if not count:
            log(f"[bn] {what} (ragged, {y.numel() // shape[-1]} pixels): "
                f"forward sums and backward dy match their plain versions, max "
                f"abs err {err_f:.3e} / {err_b:.3e}, bitwise repeatable")
            continue
        row = rows[(shape, count, name)] = bn_time(y, m, g1, g2, peaks, what)
        if len(row["fk"]) != 1 or row["fk"][0][2] != 1:
            fail(f"bn_moments {what}: one forward call ran {row['fk']} on the "
                 f"device, want exactly one kernel launch")
        if shape == BN_STEP_SHAPES[0][0]:
            # the yardsticks at the largest layer: the forward's plain
            # version and the nearest library call (unmasked); the
            # backward's plain twin and the recompute it replaced
            row["f_plain"] = time_ms(lambda: cb.masked_moment_sums(y.float(), m))
            row["f_library"] = time_ms(lambda: torch.var_mean(y, dim=(0, 1, 2)))
            row["b_plain"] = time_ms(
                lambda: cb.masked_moment_sums_backward(y, m, g1, g2))
            row["b_recompute"] = time_ms(
                lambda: cb.moment_sums_vjp_plain(y, m, g1, g2))
            log(f"[bn] {what} yardsticks (single calls): forward plain "
                f"version {row['f_plain']:.4f} ms, torch.var_mean "
                f"(unmasked) {row['f_library']:.4f} ms | backward: plain "
                f"twin {row['b_plain']:.4f} ms, the plain recompute it "
                f"replaced {row['b_recompute']:.4f} ms")
    bn_totals(rows)
    first = rows[(BN_STEP_SHAPES[0][0], BN_STEP_SHAPES[0][1], "f32")]
    return {"forward": {"max_abs_err": worst_f, "ms": first["f_call"],
                        "plain_ms": first["f_plain"], "bound_ms": first["f_bound"],
                        "bound_by": first["f_by"], "library_ms": first["f_library"]},
            "backward": {"max_abs_err": worst, "ms": first["b_call"],
                         "plain_ms": first["b_plain"], "bound_ms": first["b_bound"],
                         "bound_by": first["b_by"], "library_ms": None}}


def make_train_data(work: Path):
    """The synthetic PNG dataset (the port's writer) under ``work``."""
    from can_tpu_torch.data import make_synthetic_dataset

    root = work / "synth"
    make_synthetic_dataset(str(root / "train_data"), TRAIN_ITEMS,
                           sizes=TRAIN_SIZES, seed=SEED)
    make_synthetic_dataset(str(root / "test_data"), TEST_ITEMS,
                           sizes=TRAIN_SIZES, seed=SEED + 1)
    return root


def check_schedule(root: Path) -> None:
    """The steps the CLI will run must carry bucket padding and fill slots."""
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher

    ds = CrowdDataset(str(root / "train_data" / "images"),
                      str(root / "train_data" / "ground_truth"))
    sched = ShardedBatcher(ds, TRAIN_BATCH, seed=SEED,
                           pad_multiple=TRAIN_PAD).global_schedule(0)[:TRAIN_STEPS]
    padded = any(ds.snapped_shape(i) != key for key, g in sched for i, _ in g)
    fill = any(not v for _, g in sched for _, v in g)
    if not (padded and fill):
        fail(f"the first {TRAIN_STEPS} training batches carry padding={padded} "
             f"fill={fill}; the smoke run needs both")
    log(f"[train] schedule: {len(sched)} steps, buckets "
        f"{sorted({k for k, _ in sched})}, "
        f"{sum(not v for _, g in sched for _, v in g)} fill slots")


def train_cli(root: Path, work: Path, bf16: bool) -> dict:
    """The port's train CLI path, one epoch of TRAIN_STEPS steps; returns
    its summary plus the launch counts of this run."""
    import math

    from can_tpu_torch.cli import train as cli
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.utils.checkpoint import has_checkpoint

    tag = "bf16" if bf16 else "f32"
    ckpt = work / f"ckpt_{tag}"
    argv = ["--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
            "--batch-size", str(TRAIN_BATCH), "--pad-multiple", str(TRAIN_PAD),
            # straggler groups padded to the batch: the fill slots that
            # check_schedule asks for
            "--no-remnant-batches",
            "--epochs", "1", "--max-steps-per-epoch", str(TRAIN_STEPS),
            "--lr", "1e-6", "--seed", str(SEED), "--checkpoint-dir", str(ckpt)]
    args = cli.parse_args(argv + (["--bf16"] if bf16 else []))
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    summary = cli.train(args)
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    row = summary["epochs"][-1]
    if summary["steps"] != TRAIN_STEPS:
        fail(f"train {tag}: {summary['steps']} steps, want {TRAIN_STEPS}")
    if not (math.isfinite(row["train_loss"]) and math.isfinite(row["mae"])):
        fail(f"train {tag}: loss {row['train_loss']!r}, MAE {row['mae']!r}")
    if not has_checkpoint(str(ckpt)):
        fail(f"train {tag}: no checkpoint under {ckpt}")
    for key in ("bn", "bn_backward"):
        if launches[key] != BN_LAYERS * summary["steps"]:
            fail(f"train {tag}: {key} kernel launched {launches[key]} times, "
                 f"want {BN_LAYERS} x {summary['steps']} steps")
    if launches["context"] != summary["steps"] + summary["eval_batches"]:
        fail(f"train {tag}: context_fused launched {launches['context']} "
             f"times, want {summary['steps']} steps + "
             f"{summary['eval_batches']} eval batches")
    log(f"[train] {tag}: CLI path, {summary['steps']} steps, loss "
        f"{row['train_loss']:.6g}, eval MAE {row['mae']:.6g} over "
        f"{summary['eval_batches']} batches, checkpoint in {ckpt.name}; "
        f"launches bn_moments {launches['bn']} and bn_moments_backward "
        f"{launches['bn_backward']} (each = {BN_LAYERS} x steps), "
        f"context_fused {launches['context']} (= steps + eval batches)")
    return {**summary, "launches": launches}


def fixed_batch(root: Path):
    """The first training batch of the schedule (bucket padding
    included), on the card."""
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher
    from can_tpu_torch.train.steps import batch_to_device

    ds = CrowdDataset(str(root / "train_data" / "images"),
                      str(root / "train_data" / "ground_truth"))
    batch = next(ShardedBatcher(ds, TRAIN_BATCH, seed=SEED,
                                pad_multiple=TRAIN_PAD).epoch(0))
    return batch_to_device(batch, "cuda")


def _state(batch_norm: bool = True, s2d_stem: bool = False):
    import torch

    from can_tpu_torch.models import CANNet
    from can_tpu_torch.train import create_train_state, make_lr_schedule

    # s2d_stem only when asked: --measure-only runs this in older checkouts
    model = CANNet(device="cuda", seed=SEED, batch_norm=batch_norm,
                   **({"s2d_stem": True} if s2d_stem else {}))
    return create_train_state(model.to(memory_format=torch.channels_last),
                              make_lr_schedule(1e-6))


def kernel_vs_onepass_step(batch) -> None:
    """One f32 step with the kernel (each layer's sums held against the
    plain version at the layer's real input) against the same step with
    onepass: loss and new running stats."""
    import torch

    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.train import make_train_step

    worst, layers = 0.0, []

    def checked(y, m, axes):
        sums = cb.moment_sums(y, m)
        layers.append(tuple(y.shape))
        nonlocal worst
        worst = max(worst, check_bn_sums(sums, y, m, f"layer {len(layers)} "
                                         f"{tuple(y.shape)}"))
        return bm._finish_onepass(*sums, axes)

    ops = {"kernel": bm.BNOps(impl="kernel", masked_moments=checked,
                              global_moments=bm.global_moments_onepass),
           "onepass": bm.make_bn_ops("onepass"), "twopass": None}
    def updated_weights(sd, k):
        # running stats are held apart; a conv bias right before a BN has
        # true gradient 0 (BN cancels it), so its update is float residue
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            return False
        prefix, leaf = k.rsplit(".", 1)
        group, idx = prefix.split(".")[0], prefix.split(".")[-1]
        return not (leaf == "bias" and group in ("frontend", "backend")
                    and f"{group}.{int(idx) + 1}.running_mean" in sd)

    out = {}
    for name, bn_ops in ops.items():
        state = _state()
        old = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        _, m = make_train_step(bn_ops=bn_ops)(state, batch)
        sd = state.model.state_dict()
        stats = torch.cat([b for k, b in sd.items()
                           if k.endswith(("running_mean", "running_var"))])
        upd = {k: (sd[k] - old[k]).double() for k in sd if updated_weights(sd, k)}
        out[name] = (float(m["loss"]), stats, upd)
        del state, old
    (lk, sk, uk), (lo, so, uo) = out["kernel"], out["onepass"]
    if len(layers) != BN_LAYERS:
        fail(f"the kernel step ran {len(layers)} BN layers, want {BN_LAYERS}")
    loss_rel = abs(lk - lo) / abs(lo)
    stats_rel = float((sk - so).abs().max() / so.abs().max())

    def update_diff(u):
        """(all weights' relative L2, worst parameter, its relative L2)"""
        per = {k: float((u[k] - uo[k]).norm() / uo[k].norm().clamp_min(1e-30))
               for k in uo}
        worst_k = max(per, key=per.get)
        total = float(sum((u[k] - uo[k]).square().sum() for k in uo).sqrt()
                      / sum(uo[k].square().sum() for k in uo).sqrt())
        return total, worst_k, per[worst_k]

    upd, upd_k, upd_w = update_diff(uk)
    noise, noise_k, noise_w = update_diff(out["twopass"][2])
    if not (loss_rel <= STEP_RTOL and stats_rel <= STEP_RTOL):
        fail(f"kernel step vs onepass step: loss rel {loss_rel:.3e}, running "
             f"stats rel {stats_rel:.3e} (tolerance {STEP_RTOL})")
    if upd > UPDATE_RTOL:
        fail(f"kernel step vs onepass step: the update differs by {upd:.3e} "
             f"(relative L2 over all weights, tolerance {UPDATE_RTOL})")
    log(f"[train] kernel step vs onepass step (f32, fixed batch): loss "
        f"{lk:.6g} vs {lo:.6g} (rel {loss_rel:.2e}), running stats rel "
        f"{stats_rel:.2e} (tolerance {STEP_RTOL}); the update of all "
        f"{len(uo)} weights within {upd:.2e} relative L2 (tolerance "
        f"{UPDATE_RTOL}; twopass vs onepass {noise:.2e}), worst parameter "
        f"{upd_k} {upd_w:.2e} (twopass vs onepass: {noise_k} {noise_w:.2e}); "
        f"{len(layers)} BN layers' kernel sums match the plain version at "
        f"their real inputs, worst abs err {worst:.3e}")


def device_span(prof, skip=()):
    """(span, busy) in ms of a profile's device activity: the span from
    its first device record's start to its last one's end, and the time
    within it in which at least one kernel, copy or memset ran (overlaps
    counted once).  Records named in ``skip`` (device-side annotations of
    ``record_function`` ranges) are left out."""
    import torch

    iv = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name not in skip and ev.time_range.end > ev.time_range.start)
    if not iv:
        fail("torch.profiler recorded no device activity in the profiled step")
    busy, (lo, hi) = 0.0, iv[0]
    for start, end in iv[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return (max(e for _, e in iv) - iv[0][0]) / 1e3, busy / 1e3


def _short(name: str) -> str:
    """A device kernel's name without its argument list, cut to 70."""
    import re

    r = _readable(name)
    if r != name:
        return r
    return re.sub(r"\(.*$", "", name)[:70]


def step_breakdown(batch, bf16: bool) -> None:
    """Where a training step's time goes: forward, backward and optimizer
    by CUDA events (median of 3 warm steps), images/s, peak memory; then
    the device time of one more step by torch.profiler: the top 15
    kernels, name-pattern buckets, the BN forward and backward and the
    context kernel sums, and the device's idle share of that step (see
    ``device_span``).  The
    two autograd backwards are labelled with ``record_function`` ranges
    while that step is profiled, so the device time of whatever they
    launch (a kernel, or a plain recompute of ATen kernels) sums under one
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.train.steps import backward, forward_loss

    tag = "bf16" if bf16 else "f32"
    dt = torch.bfloat16 if bf16 else None
    state = _state()
    shapes = []

    def recording(y, m, axes):
        shapes.append(tuple(y.shape))
        return bm.masked_moments_kernel(y, m, axes)

    ops = bm.BNOps(impl="kernel", masked_moments=recording,
                   global_moments=bm.global_moments_onepass)
    splits = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = forward_loss(state, batch, compute_dtype=dt, bn_ops=ops)
        ev[1].record()
        backward(state, loss)
        ev[2].record()
        state.apply_update()
        ev[3].record()
        ev[3].synchronize()
        if i >= 2:
            splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd, opt = (statistics.median(x[j] for x in splits) for j in range(3))
    step = fwd + bwd + opt
    seen = {}
    for s in shapes[:BN_LAYERS]:
        seen[s] = seen.get(s, 0) + 1
    if seen != dict(BN_STEP_SHAPES):
        fail(f"the step's BN layers take {seen}, BN_STEP_SHAPES says "
             f"{dict(BN_STEP_SHAPES)}")
    b = batch["image"].shape[0]
    log(f"[train] {tag} step on {tuple(batch['image'].shape[:3])}: {step:.1f} ms "
        f"= forward {fwd:.1f} + backward {bwd:.1f} + optimizer {opt:.1f} ms "
        f"(CUDA events, median of 3 warm steps); {b / step * 1e3:.2f} images/s; "
        f"peak memory {peak / 2 ** 30:.2f} GiB")

    labels = {cb.MomentSums: "bn_moments.backward",
              cc.ContextTail: "context_fused.backward"}
    plain = {cls: cls.backward for cls in labels}

    def labelled(fn, label):
        def bwd_fn(ctx, *grads):
            with record_function(label):
                return fn(ctx, *grads)
        return staticmethod(bwd_fn)

    try:
        for cls, label in labels.items():
            cls.backward = labelled(plain[cls], label)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss, _ = forward_loss(state, batch, compute_dtype=dt, bn_ops=ops)
            backward(state, loss)
            state.apply_update()
            torch.cuda.synchronize()
    finally:
        for cls, fn in plain.items():
            cls.backward = staticmethod(fn)
    # a range appears twice: as a host event whose device time sums the
    # ATen kernels launched inside it, and as a device-side annotation
    # spanning them (the only record of a kernel launched through ctypes)
    kernels, ranges, spans = [], {}, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.key in labels.values():
                spans[ev.key] = _device_us(ev) / 1e3
            elif _device_us(ev) > 0:
                kernels.append((_device_us(ev) / 1e3, ev.count, ev.key))
        elif ev.key in labels.values():
            ranges[ev.key] = _device_us(ev) / 1e3
    kernels.sort(reverse=True)
    total = sum(k[0] for k in kernels)
    span, busy = device_span(prof, skip=set(labels.values()))

    def inside(label):
        return ranges.get(label) or spans.get(label, 0.0)

    def pick(*pats, without=()):
        return sum(ms for ms, _, key in kernels
                   if any(p in key for p in pats) and not any(p in key for p in without))

    ours = ("bn_moments", "context_")
    sums = {"bn forward": pick("bn_moments", without=("backward",)),
            "bn backward (range)": inside("bn_moments.backward"),
            "context forward": pick("context_"),
            "context backward (range)": inside("context_fused.backward")}
    buckets = {"GEMM/convolution": pick("gemm", "conv", "xmma", "cudnn", "cutlass",
                                        "implicit", "wgrad", "dgrad", "fft",
                                        without=ours),
               "elementwise": pick("elementwise", without=ours),
               "reduction": pick("reduce", without=ours)}
    log(f"[profile] {tag} one step: device time {total:.2f} ms in "
        f"{sum(k[1] for k in kernels)} launches of {len(kernels)} kernels; "
        f"device busy {busy:.2f} ms of the {span:.2f} ms from its first to "
        f"its last device activity, idle {100 * (1 - busy / span):.1f}% "
        f"(the profiled step; the unprofiled steps above took {step:.2f} ms "
        f"by CUDA events)")
    for i, (ms, n, key) in enumerate(kernels[:15]):
        log(f"[profile] {tag} #{i + 1} {ms:.3f} ms ({100 * ms / total:.1f}%, "
            f"{n} launches) {_short(key)}")
    log(f"[profile] {tag} sums: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in sums.items()))
    log(f"[profile] {tag} name-pattern buckets: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in buckets.items())
        + f", the rest {total - sum(buckets.values()) - pick(*ours):.3f} ms")
    del state


def train_data(work: Path) -> Path:
    """TF32 off, as the train CLI sets it (cuDNN would run f32 convs in
    TF32), and the synthetic dataset."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return make_train_data(work)


def phase_train(work: Path) -> dict:
    """The train CLI in f32 and bf16, then the fixed-batch step checks,
    split and profile."""
    root = train_data(work)
    check_schedule(root)
    runs = {tag: train_cli(root, work, tag == "bf16") for tag in ("f32", "bf16")}
    batch = fixed_batch(root)
    kernel_vs_onepass_step(batch)
    for tag in ("f32", "bf16"):
        step_breakdown(batch, tag == "bf16")
    return {k: sum(r["launches"][k] for r in runs.values())
            for k in ("bn", "bn_backward", "context")}


# the planner's measurement: BN-model train steps at two batch shapes fit
# the card's peak memory as fixed + bytes per pixel; a third shape checks
# the fit; the constants written into can_tpu_torch/cli/common.py must
# agree with this run's fit within PLAN_FIT_RTOL
PLAN_FIT_SHAPES = ((4, 576, 768), (8, 576, 768))
PLAN_CHECK_SHAPE = (6, 768, 1024)
PLAN_FIT_RTOL = 0.10
# the train CLI at its defaults (--pad-multiple auto, --max-buckets 24) on
# a wild synthetic set: 35 sizes around 576x768, more distinct shapes than
# the budget, so the planner builds a ladder
AUTO_SIZES = tuple((h, w) for h in range(448, 577, 32) for w in range(576, 769, 32))
AUTO_TRAIN_ITEMS, AUTO_TEST_ITEMS = 40, 12
# [eval] against the train CLI's own last eval of the same checkpoint
EVAL_RTOL = 1e-6
# served count of test image 0 against the sum of [eval]'s density map
SERVE_CKPT_RTOL = {"f32": 1e-5, "bf16": 2e-2}


def synthetic_batch(b: int, h: int, w: int):
    """A device batch of normalised noise at (b, h, w): every slot real,
    no padding (the fit's pixels are all the batch's)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    return {"image": torch.randn((b, h, w, 3), generator=g, device="cuda"),
            "dmap": torch.rand((b, h // 8, w // 8, 1), generator=g, device="cuda"),
            "pixel_mask": torch.ones((b, h // 8, w // 8, 1), device="cuda"),
            "sample_mask": torch.ones((b,), device="cuda")}


def train_step_cost(shape, bf16: bool, *, batch_norm: bool = True,
                    remat: bool = False, reps: int = 3):
    """(peak bytes allocated, median ms) of a warm train step with the
    kernels at ``shape`` (BN or plain model, remat on or off): weights,
    gradients and momentum included.  ``reps=0``: one step, its peak
    memory and wall ms."""
    import torch

    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.train import make_train_step

    state = _state(batch_norm=batch_norm)
    batch = synthetic_batch(*shape)
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None,
                           bn_ops=bm.make_bn_ops("kernel") if batch_norm else None,
                           remat=remat)
    if reps:
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if reps:
        ms = time_ms(lambda: step(state, batch), reps=reps)
    else:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del state, batch
    torch.cuda.empty_cache()
    return peak, ms


def fits_on_card(shape, bf16: bool, remat: bool = False) -> bool:
    """Does one BN train step at ``shape`` run, or run out of device memory?"""
    import torch

    try:
        train_step_cost(shape, bf16, remat=remat, reps=0)
        return True
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return False


# the footprints the planner's constants hold: (model, remat)
PLAN_VARIANTS = (("bn", False), ("bn", True), ("plain", False), ("plain", True))


def phase_planner(root: Path) -> dict:
    """The card's numbers behind the planner's constants: the train step's
    peak memory at two batch shapes (fixed part and bytes per pixel) for
    the BN and the plain model, with and without remat, f32 and bf16,
    each checked at a third shape; the BN step's rate in Mpx/s; one
    launch's cost by ``measure_launch_cost_mpx``; the per-launch cap of
    the train CLI's default (BN model, --remat auto: the remat
    footprint), which must admit every launch the auto train phase plans;
    and, in f32 with remat, a step at 95% of it (must run) and at 115%.
    Every constant of cli/common.py is held against this run's fit: any
    off by more than 10% fails the phase, after all are printed."""
    import torch

    from can_tpu_torch.cli import common
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher

    total = torch.cuda.mem_get_info()[1]
    stale = []
    for model, remat in PLAN_VARIANTS:
        what = f"{model} model, remat {'on' if remat else 'off'}"
        for tag in ("f32", "bf16"):
            bf16 = tag == "bf16"
            kw = dict(batch_norm=model == "bn", remat=remat)
            (p1, t1), (p2, t2) = (train_step_cost(s, bf16, **kw)
                                  for s in PLAN_FIT_SHAPES)
            px1, px2 = (b * h * w for b, h, w in PLAN_FIT_SHAPES)
            per_px = (p2 - p1) / (px2 - px1)
            fixed = p2 - per_px * px2
            ms_per_mpx = (t2 - t1) / ((px2 - px1) / 1e6)
            rate = px2 / 1e6 / (t2 / 1e3)
            pc, tc = train_step_cost(PLAN_CHECK_SHAPE, bf16, **kw)
            pxc = PLAN_CHECK_SHAPE[0] * PLAN_CHECK_SHAPE[1] * PLAN_CHECK_SHAPE[2]
            predicted = fixed + per_px * pxc
            cap_fit = (0.92 * total - fixed) / per_px
            cfixed, cper_px = common.train_footprint(bf16=bf16, **kw)
            cap = common.max_launch_pixels(bf16=bf16, device="cuda", **kw)
            log(f"[planner] {tag} {what}: train step peak memory "
                f"{p1 / 2 ** 30:.3f} GiB at {PLAN_FIT_SHAPES[0]}, "
                f"{p2 / 2 ** 30:.3f} GiB at {PLAN_FIT_SHAPES[1]} -> fixed "
                f"{fixed:.0f} B + {per_px:.1f} B/px; at {PLAN_CHECK_SHAPE} "
                f"{pc / 2 ** 30:.3f} GiB, the fit says {predicted / 2 ** 30:.3f} "
                f"GiB ({100 * (predicted / pc - 1):+.1f}%)")
            log(f"[planner] {tag} {what}: step time {t1:.2f} / {t2:.2f} / "
                f"{tc:.2f} ms at the three shapes: {rate:.2f} Mpx/s at "
                f"{PLAN_FIT_SHAPES[1]}, {ms_per_mpx:.3f} ms/Mpx + "
                f"{t2 - ms_per_mpx * px2 / 1e6:.2f} ms fixed per step")
            log(f"[planner] {tag} {what}: max_launch_pixels {cap / 1e6:.2f} Mpx "
                f"from cli/common.py's constants (fixed {cfixed:.0f} B, "
                f"{cper_px:.1f} B/px), {cap_fit / 1e6:.2f} Mpx from this run's "
                f"fit, at 0.92 of {total / 2 ** 30:.2f} GiB")
            if abs(predicted / pc - 1) > PLAN_FIT_RTOL:
                stale.append(f"{tag} {what}: the memory fit misses "
                             f"{PLAN_CHECK_SHAPE} by more than {PLAN_FIT_RTOL:.0%}")
            if abs(cap / cap_fit - 1) > PLAN_FIT_RTOL:
                stale.append(f"{tag} {what}: cli/common.py's cap {cap / 1e6:.2f} "
                             f"Mpx is off this run's {cap_fit / 1e6:.2f} Mpx by "
                             f"more than {PLAN_FIT_RTOL:.0%}: the constants are "
                             f"stale")
    if stale:
        fail("[planner] " + "; ".join(stale))
    probe = common.measure_launch_cost_mpx("cuda")
    log(f"[planner] measure_launch_cost_mpx: {probe:.6f} Mpx "
        f"({probe / common.MODEL_MPX_PER_S * 1e3:.4f} ms per synchronised launch "
        f"at {common.MODEL_MPX_PER_S} Mpx/s); cli/common.py's default "
        f"--launch-cost-mpx {common.DEFAULT_LAUNCH_COST_MPX}")
    # the train CLI's cap (BN model, --remat auto) against what the auto
    # phase will train, and against the card
    ds = CrowdDataset(str(root / "train_data" / "images"),
                      str(root / "train_data" / "ground_truth"))
    caps = {tag: common.max_launch_pixels(bf16=tag == "bf16", device="cuda",
                                          remat=True) for tag in ("f32", "bf16")}
    for tag, cap in caps.items():
        sched = ShardedBatcher(ds, TRAIN_BATCH, seed=SEED, pad_multiple="auto",
                               max_buckets=24, remnant_sizes=True,
                               launch_cost_px=common.DEFAULT_LAUNCH_COST_MPX * 1e6,
                               max_launch_px=cap).global_schedule(0)
        biggest = max(len(g) * k[0] * k[1] for k, g in sched)
        if biggest > cap:
            fail(f"{tag}: the cap {cap / 1e6:.2f} Mpx refuses a launch the "
                 f"smoke trains ({biggest / 1e6:.2f} Mpx)")
        log(f"[planner] {tag}: the train CLI's cap (remat footprint) "
            f"{cap / 1e6:.2f} Mpx admits every launch the auto phase trains "
            f"(largest {biggest / 1e6:.2f} Mpx)")
    w = 1536
    for frac in (0.95, 1.15):
        b = 4
        h = int(frac * caps["f32"] / (b * w)) // 8 * 8
        ran = fits_on_card((b, h, w), bf16=False, remat=True)
        log(f"[planner] f32 step with remat at {(b, h, w)} = "
            f"{b * h * w / 1e6:.2f} Mpx ({100 * b * h * w / caps['f32']:.0f}% of "
            f"the cap): {'ran' if ran else 'out of device memory'}")
        if frac < 1 and not ran:
            fail("a launch the cap admits ran out of device memory")
    return {"caps": caps, "probe_mpx": probe}


def train_auto(root: Path, work: Path, bf16: bool, extra=()) -> dict:
    """The train CLI at its default --pad-multiple auto (with ``extra``
    flags), one whole epoch; the BN kernels must launch 16 times per step
    of the planned schedule, the context kernel once per step and per
    eval batch."""
    import math

    from can_tpu_torch.cli import train as cli
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    tag = "bf16" if bf16 else "f32"
    ckpt = work / f"ckpt_auto_{tag}{''.join(extra).replace('-', '_')}"
    argv = ["--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
            "--batch-size", str(TRAIN_BATCH), "--epochs", "1", "--lr", "1e-6",
            "--seed", str(SEED), "--checkpoint-dir", str(ckpt), *extra]
    args = cli.parse_args(argv + (["--bf16"] if bf16 else []))
    if (args.pad_multiple, args.max_buckets) != ("auto", 24):
        fail(f"the train CLI's defaults are --pad-multiple "
             f"{args.pad_multiple!r} --max-buckets {args.max_buckets}")
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    summary = cli.train(args)
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    row = summary["epochs"][-1]
    steps = summary["schedule_steps"]
    if summary["steps"] != steps or not steps:
        fail(f"train auto {tag}: ran {summary['steps']} steps of a planned {steps}")
    if not (math.isfinite(row["train_loss"]) and math.isfinite(row["mae"])):
        fail(f"train auto {tag}: loss {row['train_loss']!r}, MAE {row['mae']!r}")
    for key in ("bn", "bn_backward"):
        if launches[key] != BN_LAYERS * steps:
            fail(f"train auto {tag}: {key} launched {launches[key]} times, want "
                 f"{BN_LAYERS} x {steps} planned steps")
    if launches["context"] != steps + summary["eval_batches"]:
        fail(f"train auto {tag}: context_fused launched {launches['context']} "
             f"times, want {steps} steps + {summary['eval_batches']} eval batches")
    log(f"[train] auto {tag}: {steps} steps (the planned schedule), loss "
        f"{row['train_loss']:.6g}, eval MAE {row['mae']:.9g} MSE "
        f"{row['mse']:.9g} over {summary['eval_batches']} batches; launches "
        f"bn_moments {launches['bn']} and bn_moments_backward "
        f"{launches['bn_backward']} (= {BN_LAYERS} x steps), context_fused "
        f"{launches['context']} (= steps + eval batches)")
    return {**summary, "launches": launches, "ckpt": ckpt,
            "argv": ["--batch-size", str(TRAIN_BATCH), "--pad-multiple", "auto"]}


def eval_cli(root: Path, work: Path, run: dict, bf16: bool) -> dict:
    """The eval CLI on the auto run's checkpoint with the train CLI's
    batching: MAE and MSE equal to the train CLI's last eval, one context
    launch per eval batch (and one for --show-index), three readable
    PNGs; then the eval epoch timed at prefetch depth 0 and 2."""
    from can_tpu_torch.cli import test as cli
    from can_tpu_torch.data import CrowdDataset
    from can_tpu_torch.data.imageio import read_png
    from can_tpu_torch.ops import cuda_context as cc

    tag = "bf16" if bf16 else "f32"
    argv = (["--data_root", str(root), "--checkpoint-dir", str(run["ckpt"]),
             "--syncBN"] + run["argv"] + (["--bf16"] if bf16 else []))
    cc.reset_launches()  # the main path starts here
    out = cli.evaluate_checkpoint(cli.parse_args(
        argv + ["--show-index", "0", "--out-dir", str(work / f"eval_{tag}")]))
    launches = cc.LAUNCHES  # ... and ends here
    last = run["epochs"][-1]
    for k in ("mae", "mse"):
        rel = abs(out[k] - last[k]) / abs(last[k])
        if rel > EVAL_RTOL:
            fail(f"eval {tag}: {k} {out[k]!r} vs the train CLI's {last[k]!r} "
                 f"(rel {rel:.2e} > {EVAL_RTOL})")
    if launches != out["batches"] + 1:
        fail(f"eval {tag}: context_fused launched {launches} times, want "
             f"{out['batches']} eval batches + 1 (--show-index)")
    ds = CrowdDataset(str(root / "test_data" / "images"),
                      str(root / "test_data" / "ground_truth"), phase="test")
    h, w = ds.snapped_shape(0)
    want = [(h, w, 3), (h // 8, w // 8, 3), (h // 8, w // 8, 3)]
    got = [read_png(p).shape for p in out["viz_paths"]]
    if got != want:
        fail(f"eval {tag}: --show-index PNGs {got}, want {want}")
    log(f"[eval] {tag}: checkpoint epoch {out['epoch']}, MAE {out['mae']:.9g} "
        f"MSE {out['mse']:.9g} over {out['num_images']} images in "
        f"{out['batches']} batches (the train CLI's last eval: MAE "
        f"{last['mae']:.9g} MSE {last['mse']:.9g}, rtol {EVAL_RTOL}); "
        f"context_fused {launches} launches (= batches + 1); PNGs {got}")
    times = {0: [], 2: []}
    for depth in (0, 2, 0, 2):
        times[depth].append(cli.evaluate_checkpoint(
            cli.parse_args(argv), prefetch=depth)["eval_s"] * 1e3)
    log(f"[eval] {tag} eval epoch wall time: prefetch depth 0 "
        f"{' / '.join(f'{t:.1f}' for t in times[0])} ms, depth 2 "
        f"{' / '.join(f'{t:.1f}' for t in times[2])} ms (reported, not gated)")
    return {"density": out["density"], "launches": launches}


def serve_checkpoint(root: Path, run: dict, density, serve_dtype: str) -> int:
    """The serve CLI from the auto run's checkpoint dir with --syncBN, the
    bucket at test image 0's snapped shape (no padding): its count must
    equal the sum of [eval]'s density map for that image.  Returns the
    context launches of the serving (the batches it ran)."""
    from can_tpu_torch.cli import serve as cli
    from can_tpu_torch.data.imageio import read_png
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.serve import serve_http

    img = read_png(str(root / "test_data" / "images" / "IMG_0000.png"))
    h, w = img.shape[0] // 8 * 8, img.shape[1] // 8 * 8
    args = cli.parse_args(["--checkpoint-dir", str(run["ckpt"]), "--syncBN",
                           "--bucket-shapes", f"{h}x{w}", "--max-batch", "1",
                           "--serve-dtype", serve_dtype, "--port", "0",
                           "--deadline-ms", "120000"])
    cc.reset_launches()  # the main path starts here
    service = cli.build_service(args)
    with service:
        httpd = serve_http(service, host="127.0.0.1", port=0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            res = _post(httpd.server_address[1], img, "raw=0")
        finally:
            httpd.shutdown()
            httpd.server_close()
    launches = cc.LAUNCHES  # ... and ends here
    batches = service.engine.compile_count + service.stats()["batches"]
    service.engine.release_buffers()
    want = float(np.asarray(density, np.float64).sum())
    rel = abs(res["count"] - want) / abs(want)
    tol = SERVE_CKPT_RTOL[serve_dtype]
    if not np.isfinite(res["count"]) or rel > tol:
        fail(f"serve checkpoint {serve_dtype}: count {res['count']!r} vs the "
             f"eval density sum {want!r} (rel {rel:.2e} > {tol})")
    if launches != batches:
        fail(f"serve checkpoint {serve_dtype}: context_fused launched {launches} "
             f"times for {batches} batches")
    log(f"[serve] checkpoint {serve_dtype}: --checkpoint-dir --syncBN, bucket "
        f"{h}x{w}: count {res['count']:.9g} vs [eval]'s density sum {want:.9g} "
        f"(rel {rel:.2e}, tolerance {tol}); context_fused {launches} launches "
        f"(= batches, warmup included)")
    return launches


def make_auto_data(work: Path) -> Path:
    """The wild synthetic set of the auto phase (the port's writer)."""
    from can_tpu_torch.data import make_synthetic_dataset

    root = work / "auto"
    make_synthetic_dataset(str(root / "train_data"), AUTO_TRAIN_ITEMS,
                           sizes=AUTO_SIZES, seed=SEED)
    make_synthetic_dataset(str(root / "test_data"), AUTO_TEST_ITEMS,
                           sizes=AUTO_SIZES, seed=SEED + 1)
    return root


def phase_slice5(work: Path) -> dict:
    """[train] auto, [eval] and [serve] checkpoint on the wild synthetic
    set, then [planner]; returns the kernels' launches in their main
    paths."""
    root = make_auto_data(work)
    context = 0
    bn = {"bn": 0, "bn_backward": 0}
    for tag in ("f32", "bf16"):
        bf16 = tag == "bf16"
        run = train_auto(root, work, bf16)
        ev = eval_cli(root, work, run, bf16)
        context += (run["launches"]["context"] + ev["launches"]
                    + serve_checkpoint(root, run, ev["density"], tag))
        for k in bn:
            bn[k] += run["launches"][k]
    phase_planner(root)
    return {"context": context, **bn}

# -- slice 6: determinism, remat, s2d, VGG-16 init, prepare_data, golden ----
DET_STEPS = 3
# the determinism runs' settings: PyTorch's defaults and each candidate alone
DET_MODES = {
    "off": "PyTorch's defaults: cuDNN's default algorithms, no deterministic "
           "algorithms, ATen's adaptive pool",
    "cudnn": "cudnn.deterministic alone (ATen's adaptive pool)",
    "pool": "the matrix adaptive pool alone (cuDNN's defaults)",
    "on": "use_deterministic(): all of them, fill_uninitialized_memory off",
    "on+fill": "use_deterministic() with fill_uninitialized_memory on",
}
# tests/test_golden.py's committed GOLDEN_MAE (the JAX package's 10-epoch
# f32 and bf16 trajectories on its seeded synthetic set, 8-device CPU
# mesh), copied here: this script imports no test
GOLDEN_MAE = {
    "f32": [20.8517, 20.3003, 19.5731, 18.8142, 18.0385,
            17.2353, 16.4846, 15.9598, 15.4430, 14.9687],
    "bf16": [20.8531, 20.3056, 19.5807, 18.8183, 18.0424,
             17.2430, 16.4778, 15.9605, 15.4432, 14.9572],
}
GOLDEN_RTOL = {"f32": 0.01, "bf16": 0.05}  # bf16: reported, not gated
# [s2d]: the folded stem conv against the plain one (max error over the
# map's max); the whole forward at the model tolerance of
# tests/test_model.py (f32: the two forwards differ at the model's own
# f32 noise, ~1e-5 of the map, after 16 layers) and, in bf16, 5% of the
# map's scale (tests/test_torch_model.py's bf16 band)
S2D_RTOL = {"f32": 1e-5, "bf16": 2e-2}
MODEL_TOL = (1e-3, 1e-4)
S2D_MODEL_BF16 = 5e-2
# [prepare]: a ShanghaiTech-layout set with .mat annotations, PNG images
PREP_SIZES = ((256, 320), (320, 256), (264, 344))
PREP_TRAIN_ITEMS, PREP_TEST_ITEMS = 12, 4


def _aten_adaptive_pool(x, output_size):
    """The earlier adaptive pool (ATen's, whose CUDA backward deterministic mode
    refuses): the comparison's 'off' side only."""
    import torch.nn.functional as F

    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), output_size).permute(0, 2, 3, 1)


def set_det_mode(mode: str) -> None:
    """Process settings of one ``DET_MODES`` entry; the adaptive pool of
    the model's context block is swapped for ATen's where the mode says."""
    import torch

    from can_tpu_torch.device import use_deterministic
    from can_tpu_torch.models import cannet
    from can_tpu_torch.ops import pooling

    if mode.startswith("on"):
        use_deterministic()
        torch.utils.deterministic.fill_uninitialized_memory = mode == "on+fill"
    else:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = mode == "cudnn"
        torch.backends.cudnn.benchmark = False
    cannet.adaptive_avg_pool2d = (
        pooling.adaptive_avg_pool2d if mode in ("pool", "on", "on+fill")
        else _aten_adaptive_pool)


def det_train(batch, bf16: bool, *, steps: int = DET_STEPS, model_kw=None):
    """``steps`` BN-model train steps from the seed on one batch; returns
    every loss, parameter, momentum buffer and buffer (running stats,
    batch counts), cloned."""
    import torch

    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.train import make_train_step

    state = _state(**(model_kw or {}))
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None,
                           bn_ops=bm.make_bn_ops("kernel"))
    losses = [step(state, batch)[1]["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    snap = {"loss": torch.stack(losses)}
    for k, p in state.model.named_parameters():
        snap[f"param {k}"] = p.detach().clone()
        snap[f"momentum {k}"] = state.optimizer.state[p]["momentum_buffer"].clone()
    for k, b in state.model.named_buffers():
        snap[f"buffer {k}"] = b.clone()
    return snap


def snap_diff(a: dict, b: dict):
    """(names whose tensors differ bitwise, the largest abs difference)."""
    import torch

    bad = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((float((a[k].double() - b[k].double()).abs().max()) for k in bad),
                default=0.0)
    return bad, worst


def fill_checks() -> None:
    """The kernels against their plain versions with every torch.empty
    filled with NaN: a kernel that reads memory it never wrote fails."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc

    set_det_mode("on+fill")
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    b, h, w, c = CONTEXT_SHAPES[1]
    fv32 = torch.randn((b, h, w, c), generator=g, device="cuda")
    aves32 = [torch.randn((b, s, s, c), generator=g, device="cuda") for s in cc.SCALES]
    ws32 = [torch.randn((c, c), generator=g, device="cuda") / c ** 0.5 for _ in cc.SCALES]
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fv = fv32.to(dt)
        avew, uh, wmat = cc.pack_inputs(fv, [a.to(dt) for a in aves32],
                                        [x.to(dt) for x in ws32], (h, w))
        got = cc.context_tail_cuda(fv, avew, uh, wmat).float()
        want = cc.context_tail_reference(fv, avew, uh, wmat).float()
        rtol, atol = TOL[name]
        if not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
            fail(f"[determinism] context_fused {CONTEXT_SHAPES[1]} {name} with "
                 f"fill_uninitialized_memory on: off its plain version")
    n = 0
    for shape, count, name, y, m, g1, g2 in bn_cases():
        check_bn_kernels(y, m, g1, g2, name, f"{shape} {name} (memory filled)")
        n += 1
    log(f"[determinism] fill_uninitialized_memory on: context_fused at "
        f"{CONTEXT_SHAPES[1]} f32 and bf16 and both BN kernels at {n} "
        f"(shape, dtype) cases match their plain versions (no read of "
        f"unwritten memory)")
    set_det_mode("on")


def refusal_probe(batch) -> None:
    """One f32 BN step under deterministic mode with ATen's adaptive pool:
    the op deterministic mode refuses, by its own message."""
    import torch

    from can_tpu_torch.models import cannet

    set_det_mode("on")
    cannet.adaptive_avg_pool2d = _aten_adaptive_pool
    try:
        det_train(batch, False, steps=1)
        log("[determinism] deterministic mode with ATen's adaptive pool: no op "
            "refused")
    except RuntimeError as e:
        first = str(e).strip().splitlines()[0]
        log(f"[determinism] deterministic mode refuses, with ATen's adaptive "
            f"pool: {first[:300]}")
    finally:
        set_det_mode("on")
        torch.cuda.synchronize()


def det_step_ms(batch, bf16: bool) -> dict:
    """Step ms (CUDA events, median of 3 warm steps) with each setting, in
    turns: off, on, on+fill, off, on, on+fill."""
    import torch

    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.train import make_train_step

    state = _state()
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None,
                           bn_ops=bm.make_bn_ops("kernel"))
    times = {m: [] for m in ("off", "on", "on+fill")}
    for mode in list(times) * 2:
        set_det_mode(mode)
        times[mode].append(time_ms(lambda: step(state, batch), reps=3))
    set_det_mode("on")
    del state
    return times


def exact_resume(root: Path, work: Path) -> dict:
    """Two epochs straight against one epoch, its checkpoint and a resume
    of one more, through the train CLI (f32): the final state and MAE
    bitwise equal."""
    import shutil

    import torch

    from can_tpu_torch.cli import train as cli
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    base = ["--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
            "--batch-size", str(TRAIN_BATCH), "--pad-multiple", str(TRAIN_PAD),
            "--lr", "1e-6", "--seed", str(SEED)]
    dirs = {k: work / f"resume_{k}" for k in ("straight", "first", "resumed")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    straight = cli.train(cli.parse_args(base + ["--epochs", "2", "--checkpoint-dir",
                                                str(dirs["straight"])]))
    first = cli.train(cli.parse_args(base + ["--epochs", "1", "--checkpoint-dir",
                                             str(dirs["first"])]))
    resumed = cli.train(cli.parse_args(base + [
        "--epochs", "2", "--checkpoint-dir", str(dirs["resumed"]),
        "--init_checkpoint", str(dirs["first"]), "--allow-config-change"]))
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    steps = straight["steps"] + first["steps"] + resumed["steps"]
    evals = (straight["eval_batches"] + first["eval_batches"]
             + resumed["eval_batches"])
    if launches != {"bn": BN_LAYERS * steps, "bn_backward": BN_LAYERS * steps,
                    "context": steps + evals}:
        fail(f"[determinism] resume runs: launches {launches} for {steps} steps "
             f"and {evals} eval batches")
    if [r["epoch"] for r in resumed["epochs"]] != [1]:
        fail(f"[determinism] the resume trained epochs "
             f"{[r['epoch'] for r in resumed['epochs']]}, want [1]")
    a = torch.load(dirs["straight"] / "1" / "state.pt", weights_only=True)
    b = torch.load(dirs["resumed"] / "1" / "state.pt", weights_only=True)
    bad = [k for k, v in a["model"].items() if not torch.equal(v, b["model"][k])]
    mom = [i for i, s in a["optimizer"]["state"].items()
           if not torch.equal(s["momentum_buffer"],
                              b["optimizer"]["state"][i]["momentum_buffer"])]
    mae_a, mae_b = straight["epochs"][-1]["mae"], resumed["epochs"][-1]["mae"]
    if bad or mom or a["step"] != b["step"] or mae_a != mae_b:
        fail(f"[determinism] 2 epochs straight vs 1 + resume: {len(bad)} model "
             f"tensors and {len(mom)} momentum buffers differ, step "
             f"{a['step']} vs {b['step']}, MAE {mae_a!r} vs {mae_b!r}")
    log(f"[determinism] exact resume (train CLI, f32): 2 epochs straight and 1 "
        f"epoch + checkpoint + resume of 1 (--allow-config-change for the "
        f"epochs) give the same {len(a['model'])} model tensors, "
        f"{len(a['optimizer']['state'])} momentum buffers and step {a['step']} "
        f"bitwise, MAE {mae_a!r} = {mae_b!r}")
    return launches


def phase_determinism(work: Path) -> dict:
    """[determinism]: the kernel checks with memory filled; what
    deterministic mode refuses; the BN step trained twice per setting
    (f32, bf16), bitwise; step ms with the settings off and on; the exact
    resume through the train CLI.  Leaves use_deterministic()'s settings
    on: every later phase runs under them."""
    root = train_data(work)
    batch = fixed_batch(root)
    fill_checks()
    refusal_probe(batch)
    for tag in ("f32", "bf16"):
        bf16 = tag == "bf16"
        for mode in ("off", "cudnn", "pool", "on"):
            set_det_mode(mode)
            bad, worst = snap_diff(det_train(batch, bf16), det_train(batch, bf16))
            log(f"[determinism] {tag} {mode} ({DET_MODES[mode]}): two trainings "
                f"of {DET_STEPS} steps at {tuple(batch['image'].shape[:3])} "
                + ("bitwise equal in every parameter, momentum buffer and "
                   "running stat" if not bad else
                   f"differ in {len(bad)} tensors (max abs diff {worst:.3e}; "
                   f"first: {', '.join(bad[:3])})"))
            if mode == "on" and bad:
                fail(f"[determinism] {tag}: training under use_deterministic() "
                     f"does not repeat itself")
    for tag in ("f32", "bf16"):
        t = det_step_ms(batch, tag == "bf16")
        med = {m: statistics.median(v) for m, v in t.items()}
        log(f"[determinism] {tag} step ms at {tuple(batch['image'].shape[:3])}, "
            f"in turns: off (PyTorch's defaults) {' / '.join(f'{x:.2f}' for x in t['off'])}, "
            f"on {' / '.join(f'{x:.2f}' for x in t['on'])}, on with "
            f"fill_uninitialized_memory {' / '.join(f'{x:.2f}' for x in t['on+fill'])}"
            f" (on/off {med['on'] / med['off']:.3f}, fill/on "
            f"{med['on+fill'] / med['on']:.3f})")
    set_det_mode("on")
    launches = exact_resume(root, work)
    log("[determinism] phases build, kernels, bn and serve ran before this one "
        "with PyTorch's default settings; every phase from here on "
        "runs under use_deterministic() (cuDNN deterministic, deterministic "
        "algorithms, the matrix adaptive pool; CUBLAS_WORKSPACE_CONFIG=:4096:8 "
        "for the whole run)")
    return launches


def step_grads(batch, bf16: bool, remat: bool):
    """One BN train step from the seed: its loss, every gradient, the new
    running stats, peak memory, the launches of the step and its warm ms."""
    import torch

    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.train import make_train_step

    state = _state()
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None,
                           bn_ops=bm.make_bn_ops("kernel"), remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    _, met = step(state, batch)
    torch.cuda.synchronize()
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    out = {"loss": met["loss"].clone()}
    for k, p in state.model.named_parameters():
        out[f"grad {k}"] = p.grad.clone()
    for k, b in state.model.named_buffers():
        out[f"buffer {k}"] = b.clone()
    ms = time_ms(lambda: step(state, batch), reps=3)
    del state
    torch.cuda.empty_cache()
    return out, launches, peak, ms


def phase_remat(work: Path) -> dict:
    """[remat]: a BN step at the fixed batch with remat on against off,
    f32 and bf16 — loss, gradients and running stats bitwise equal, each
    BN layer's running stats advanced once; the launches of one step
    with remat (the recompute re-runs the BN forward and context kernels);
    step ms and peak memory; then one f32 step at a shape above the
    no-remat cap and under the remat cap."""
    import torch

    from can_tpu_torch.cli import common

    batch = fixed_batch(train_data(work))
    total = {"bn": 0, "bn_backward": 0, "context": 0}
    for tag in ("f32", "bf16"):
        bf16 = tag == "bf16"
        (off, l_off, p_off, t_off), (on, l_on, p_on, t_on) = (
            step_grads(batch, bf16, remat) for remat in (False, True))
        bad, worst = snap_diff(off, on)
        if bad:
            fail(f"[remat] {tag}: the step with remat differs from the step "
                 f"without in {len(bad)} tensors (max abs {worst:.3e}; "
                 f"{', '.join(bad[:4])})")
        tracked = {int(v) for k, v in on.items() if k.endswith("num_batches_tracked")}
        if tracked != {1}:
            fail(f"[remat] {tag}: num_batches_tracked after one step {tracked}")
        want_on = {"bn": 2 * BN_LAYERS, "bn_backward": BN_LAYERS, "context": 2}
        want_off = {"bn": BN_LAYERS, "bn_backward": BN_LAYERS, "context": 1}
        if l_on != want_on or l_off != want_off:
            fail(f"[remat] {tag}: launches per step {l_on} with remat, {l_off} "
                 f"without; want {want_on} and {want_off}")
        for k in total:
            total[k] += l_on[k] + l_off[k]
        px = batch["image"].shape[0] * batch["image"].shape[1] * batch["image"].shape[2]
        log(f"[remat] {tag} at {tuple(batch['image'].shape[:3])}: loss, "
            f"{sum(k.startswith('grad') for k in on)} gradients and every "
            f"running stat bitwise equal with remat on and off (deterministic "
            f"mode); running stats advanced once (num_batches_tracked 1); "
            f"launches per step with remat {l_on} (without: {l_off}); step "
            f"{t_on:.2f} ms with remat, {t_off:.2f} ms without "
            f"({t_on / t_off:.3f}x); peak memory {p_on / 2 ** 30:.3f} GiB vs "
            f"{p_off / 2 ** 30:.3f} GiB ({p_on / px:.1f} vs {p_off / px:.1f} "
            f"B/px, fixed part included)")
    cap_off = common.max_launch_pixels(bf16=False, device="cuda", remat=False)
    cap_on = common.max_launch_pixels(bf16=False, device="cuda", remat=True)
    b, w = 4, 1536
    h = int((cap_off + cap_on) / 2 / (b * w)) // 8 * 8
    if not cap_off < b * h * w < cap_on:
        fail(f"[remat] no shape between the caps {cap_off / 1e6:.2f} and "
             f"{cap_on / 1e6:.2f} Mpx")
    peak, ms = train_step_cost((b, h, w), False, remat=True)
    log(f"[remat] f32 step at {(b, h, w)} = {b * h * w / 1e6:.2f} Mpx, above the "
        f"no-remat cap {cap_off / 1e6:.2f} Mpx and under the remat cap "
        f"{cap_on / 1e6:.2f} Mpx: ran with remat, {ms:.1f} ms, peak "
        f"{peak / 2 ** 30:.3f} GiB of {torch.cuda.mem_get_info()[1] / 2 ** 30:.2f}")
    return total


def phase_s2d(work: Path) -> dict:
    """[s2d]: the space-to-depth stem against the plain stem on the same
    He-scaled weights and the fixed batch's images, f32 and bf16 — the
    stem conv the fold replaces (its output, S2D_RTOL) and the BN model's
    whole forward in eval mode (the model tolerance: f32 MODEL_TOL, bf16
    S2D_MODEL_BF16 relative to the map's scale) — and the train step ms
    of each."""
    import torch

    from can_tpu_torch.models import CANNet, random_state_dict
    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.ops.conv import conv2d, depth_to_space, fold_stem_kernel, space_to_depth
    from can_tpu_torch.train import make_train_step

    batch = fixed_batch(train_data(work))
    sd = {k: torch.from_numpy(v) for k, v in
          random_state_dict(SEED, he=True, batch_norm=True).items()}
    models = {}
    for s2d in (False, True):
        m = CANNet(device="cuda", seed=None, batch_norm=True, s2d_stem=s2d)
        m.load_state_dict(sd)
        models[s2d] = m.to(memory_format=torch.channels_last).eval()
    total = {"bn": 0, "bn_backward": 0, "context": 0}
    for tag in ("f32", "bf16"):
        dt = torch.bfloat16 if tag == "bf16" else torch.float32
        x = batch["image"].to(dt)
        stem = models[False].frontend[0]
        w, b = stem.weight.to(dt), stem.bias.to(dt)
        with torch.inference_mode():
            plain = conv2d(x, w, b).float()
            wp, bp = fold_stem_kernel(w, b)
            folded = depth_to_space(conv2d(space_to_depth(x), wp, bp)).float()
            stem_rel = float((folded - plain).abs().max() / plain.abs().max())
            full = [models[s](batch["image"], compute_dtype=dt).float()
                    for s in (False, True)]
        full_rel = float((full[1] - full[0]).abs().max() / full[0].abs().max())
        if not bool(torch.isfinite(folded).all()) or stem_rel > S2D_RTOL[tag]:
            fail(f"[s2d] {tag}: the folded stem conv is off the plain one by "
                 f"{stem_rel:.3e} (tolerance {S2D_RTOL[tag]})")
        if tag == "f32":
            rtol, atol = MODEL_TOL
            model_ok = bool(((full[1] - full[0]).abs()
                             <= atol + rtol * full[0].abs()).all())
        else:
            model_ok = full_rel <= S2D_MODEL_BF16
        if not (model_ok and bool(torch.isfinite(full[1]).all())):
            fail(f"[s2d] {tag}: the forward with the folded stem is off the "
                 f"plain stem's by {full_rel:.3e} (max, relative to the map)")
        times = {}
        for s2d in (False, True):
            state = _state(s2d_stem=s2d)
            step = make_train_step(compute_dtype=dt if tag == "bf16" else None,
                                   bn_ops=bm.make_bn_ops("kernel"))
            cb.reset_launches()
            cc.reset_launches()  # the main path starts here
            step(state, batch)
            torch.cuda.synchronize()
            for k, n in (("bn", cb.LAUNCHES), ("bn_backward", cb.BACKWARD_LAUNCHES),
                         ("context", cc.LAUNCHES)):  # ... and ends here
                total[k] += n
            times[s2d] = time_ms(lambda: step(state, batch), reps=3)
            del state
        log(f"[s2d] {tag} at {tuple(batch['image'].shape[:3])}: the folded stem "
            f"conv against the plain one, max rel err {stem_rel:.3e} (tolerance "
            f"{S2D_RTOL[tag]}); the BN model's forward with it against the "
            f"plain stem's, max rel err {full_rel:.3e} ("
            + (f"rtol {MODEL_TOL[0]} / atol {MODEL_TOL[1]}" if tag == "f32"
               else f"tolerance {S2D_MODEL_BF16}")
            + f"); train step {times[True]:.2f} ms with --s2d-stem, "
            f"{times[False]:.2f} ms without")
    return total


def phase_vgg16(work: Path) -> dict:
    """[vgg16]: the train CLI with --vgg16-npz on a seeded .npz in
    tools/convert_vgg16.py's layout, one step at lr 0: the checkpoint's
    frontend convs are the .npz's bit for bit and the BN parameters are
    the init's."""
    import torch

    from can_tpu_torch.cli import train as cli
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    root = train_data(work)
    rng = np.random.default_rng(SEED + 16)
    npz, cin, i = work / "vgg16_seeded.npz", 3, 0
    arrays = {}
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512):
        if v == "M":
            continue
        arrays[f"conv{i}_w"] = (rng.standard_normal((3, 3, cin, v)) *
                                np.sqrt(2 / (9 * cin))).astype(np.float32)
        arrays[f"conv{i}_b"] = (rng.standard_normal(v) * 0.01).astype(np.float32)
        cin, i = v, i + 1
    np.savez(npz, **arrays)
    ckpt = work / "ckpt_vgg16"
    args = cli.parse_args(["--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
                           "--batch-size", str(TRAIN_BATCH), "--pad-multiple",
                           str(TRAIN_PAD), "--epochs", "1", "--max-steps-per-epoch",
                           "1", "--lr", "0", "--seed", str(SEED),
                           "--checkpoint-dir", str(ckpt), "--vgg16-npz", str(npz)])
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    summary = cli.train(args)
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    sd = torch.load(ckpt / "0" / "state.pt", weights_only=True)["model"]
    convs = [k[:-len(".weight")] for k in sd if k.startswith("frontend.")
             and k.endswith(".weight") and sd[k].dim() == 4]
    for j, k in enumerate(convs):
        w = torch.from_numpy(arrays[f"conv{j}_w"]).permute(3, 2, 0, 1)
        if not (torch.equal(sd[f"{k}.weight"].cpu(), w)
                and torch.equal(sd[f"{k}.bias"].cpu(),
                                torch.from_numpy(arrays[f"conv{j}_b"]))):
            fail(f"[vgg16] {k} is not conv{j} of {npz.name}")
    bn_w = [k for k in sd if k.startswith("frontend.") and k.endswith(".weight")
            and sd[k].dim() == 1]
    if not all(bool((sd[k] == 1).all()) for k in bn_w):
        fail("[vgg16] the BN scales moved")
    if summary["steps"] != 1 or launches["bn"] != BN_LAYERS:
        fail(f"[vgg16] {summary['steps']} steps, launches {launches}")
    log(f"[vgg16] train CLI --vgg16-npz {npz.name} (seeded, HWIO), one step at "
        f"lr 0: the checkpoint's {len(convs)} frontend convs equal the .npz's "
        f"bit for bit, its {len(bn_w)} frontend BN scales are the init's; "
        f"loss {summary['epochs'][-1]['train_loss']:.6g}, launches {launches}")
    return launches


def run_tool(module: str, argv, tag: str, timeout: int = 300) -> str:
    """``python -m <module> <argv>`` from the checkout's root, waited for;
    its standard output, or a failure naming the tool."""
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"{tag} python -m {module} {' '.join(argv)} exited "
             f"{proc.returncode}: {proc.stderr.strip()[-1500:]}")
    return proc.stdout


def make_prepare_data(work: Path) -> Path:
    """A ShanghaiTech-layout set written here: PNG images (the card's
    machine has no JPEG decoder) and GT_IMG_*.mat head annotations as
    scipy writes the real ones, no density maps."""
    import shutil

    import scipy.io as sio

    from can_tpu_torch.data.imageio import write_png

    root = work / "prep"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 21)
    for split, n in (("train", PREP_TRAIN_ITEMS), ("test", PREP_TEST_ITEMS)):
        img_dir, gt_dir = root / f"{split}_data" / "images", root / f"{split}_data" / "ground_truth"
        img_dir.mkdir(parents=True)
        gt_dir.mkdir(parents=True)
        for i in range(n):
            h, w = PREP_SIZES[int(rng.integers(len(PREP_SIZES)))]
            pts = np.stack([rng.uniform(0, w, 30), rng.uniform(0, h, 30)], axis=1)
            img = (rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
            for c, r in pts.astype(int):
                img[max(0, r - 3):r + 4, max(0, c - 3):c + 4] = 255
            write_png(str(img_dir / f"IMG_{i}.png"), img)
            inner = np.empty((1, 1), object)
            inner[0, 0] = (pts,)
            sio.savemat(gt_dir / f"GT_IMG_{i}.mat", {"image_info": inner})
    return root


def phase_prepare(work: Path) -> dict:
    """[prepare]: ``python -m can_tpu_torch.tools.prepare_data --prepared``
    on seeded .mat data, then ``--verify-store`` (each its own process,
    as a user runs them), then one auto epoch of the train CLI reading
    that store (``--prepared-root``, which must validate)."""
    import math

    from can_tpu_torch.cli import train as cli
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    root = make_prepare_data(work)
    store = work / "prep_store"
    outs = []
    for argv in (["--root", str(root), "--prepared", "--prepared-out", str(store),
                  "--quiet"],
                 ["--root", str(root), "--verify-store", "--prepared-out",
                  str(store), "--quiet"]):
        out = run_tool("can_tpu_torch.tools.prepare_data", argv, "[prepare]")
        outs.append(" | ".join(out.strip().splitlines()))
    n = PREP_TRAIN_ITEMS + PREP_TEST_ITEMS
    if f"wrote {n} density maps" not in outs[0] or outs[1].count("verified") != 2:
        fail(f"[prepare] unexpected output: {outs}")
    ckpt = work / "ckpt_prep"
    args = cli.parse_args(["--data_root", str(root), "--syncBN", "--bn-impl",
                           "kernel", "--batch-size", "4", "--epochs", "1",
                           "--lr", "1e-6", "--seed", str(SEED), "--prepared-root",
                           str(store), "--checkpoint-dir", str(ckpt)])
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    summary = cli.train(args)
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    row = summary["epochs"][-1]
    steps = summary["schedule_steps"]
    if (summary["steps"] != steps or launches["bn"] != BN_LAYERS * steps
            or not math.isfinite(row["mae"])):
        fail(f"[prepare] auto epoch from the store: {summary['steps']} of {steps} "
             f"steps, launches {launches}, MAE {row['mae']!r}")
    log(f"[prepare] prepare_data --prepared: {outs[0]}; --verify-store: "
        f"{outs[1]}; one auto epoch from that store (--prepared-root): {steps} "
        f"steps, loss {row['train_loss']:.6g}, MAE {row['mae']:.6g}, launches "
        f"{launches}")
    return launches


def phase_legacy(work: Path) -> dict:
    """A --plan-mode legacy auto epoch on the wild set, beside the cost
    mode's plan of the same set."""
    from can_tpu_torch.cli import common
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher

    root = work / "auto"
    run = train_auto(root, work, False, extra=["--plan-mode", "legacy"])
    ds = CrowdDataset(str(root / "train_data" / "images"),
                      str(root / "train_data" / "ground_truth"))
    cost = ShardedBatcher(ds, TRAIN_BATCH, seed=SEED, pad_multiple="auto",
                          max_buckets=24, remnant_sizes=True,
                          launch_cost_px=common.DEFAULT_LAUNCH_COST_MPX * 1e6,
                          max_launch_px=common.max_launch_pixels(
                              bf16=False, device="cuda", remat=True))
    log(f"[train] auto f32 --plan-mode legacy: {run['schedule_steps']} steps "
        f"(cost mode plans {cost.batches_per_epoch(0)} for the same set)")
    out = work / "plan_ablation.json"
    run_tool("can_tpu_torch.tools.plan_ablation",
             ["--out", str(out), "--repeats", "1"], "[plan_ablation]")
    doc = json.loads(out.read_text())
    if not all(r["predicted_eq_realized"] for r in doc["results"]):
        fail("[plan_ablation] a plan's predicted cost differs from its schedule's")
    head = doc["headline"]
    log(f"[plan_ablation] python -m can_tpu_torch.tools.plan_ablation: "
        f"{len(doc['results'])} candidates; b16 schedule overhead legacy at 2.0 "
        f"Mpx {head['baseline_legacy_tunnel_pricing']['schedule_overhead']}, cost "
        f"at 2.0 Mpx {head['cost_planner_same_pricing']['schedule_overhead']}, "
        f"cost at the card's price "
        f"{head['cost_planner_device_pricing']['schedule_overhead']} "
        f"({head['config']})")
    return run["launches"]


def phase_golden(work: Path) -> dict:
    """[golden]: tests/test_golden.py's recipe on the card — the plain
    model from seed 0, the seeded synthetic set (24 + 8 items at 64x64 and
    64x96, seeds 42 and 43), global batch 8, 10 epochs, lr 2e-6 x 8 on a
    loss divided by 8 (JAX's dp = 8 mesh as one process) — against the
    JAX goldens: f32 within 1%, bf16 reported against 5%."""
    import torch

    from can_tpu_torch.data import CrowdDataset, ShardedBatcher, make_synthetic_dataset
    from can_tpu_torch.data.prefetch import DevicePut
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_lr_schedule,
        make_train_step,
        train_one_epoch,
    )

    root = work / "golden"
    tr = make_synthetic_dataset(str(root / "data"), 24, sizes=((64, 64), (64, 96)), seed=42)
    te = make_synthetic_dataset(str(root / "test"), 8, sizes=((64, 64),), seed=43)
    train_b = ShardedBatcher(CrowdDataset(*tr, phase="train"), 8, shuffle=True, seed=0)
    test_b = ShardedBatcher(CrowdDataset(*te, phase="test"), 8, shuffle=False, seed=0)
    put = DevicePut(torch.device("cuda"))
    launches = 0
    for tag in ("f32", "bf16"):
        dt = torch.bfloat16 if tag == "bf16" else None
        model = CANNet(device="cuda", seed=0).to(memory_format=torch.channels_last)
        state = create_train_state(model, make_lr_schedule(2e-6, world_size=8))
        step, ev = make_train_step(grad_divisor=8, compute_dtype=dt), make_eval_step(compute_dtype=dt)
        cc.reset_launches()  # the main path starts here
        maes, steps, batches = [], 0, 0
        for epoch in range(10):
            state, st = train_one_epoch(step, state, train_b.epoch(epoch),
                                        put_fn=put, epoch=epoch, prefetch=put.depth)
            m = evaluate(ev, state.model, test_b.epoch(0), put_fn=put,
                         dataset_size=test_b.dataset_size, prefetch=put.depth)
            maes.append(m["mae"])
            steps, batches = steps + st.steps, batches + m["batches"]
        n = cc.LAUNCHES  # ... and ends here
        if n != steps + batches:
            fail(f"[golden] {tag}: context_fused launched {n} times for {steps} "
                 f"steps and {batches} eval batches")
        launches += n
        rel = max(abs(a - b) / b for a, b in zip(maes, GOLDEN_MAE[tag]))
        log(f"[golden] {tag}: MAE trajectory {[round(x, 4) for x in maes]} against "
            f"the JAX goldens {GOLDEN_MAE[tag]}: worst epoch rel {rel:.2e} "
            f"(band {GOLDEN_RTOL[tag]:.0%}{', gated' if tag == 'f32' else ', reported'})")
        if not all(np.isfinite(maes)) or (tag == "f32" and rel > GOLDEN_RTOL[tag]):
            fail(f"[golden] {tag}: the trajectory misses the goldens by {rel:.2e}")
        if not maes[-1] < 0.75 * maes[0]:
            fail(f"[golden] {tag}: the final MAE {maes[-1]:.4f} is not under 0.75 "
                 f"x the first {maes[0]:.4f}")
    return {"bn": 0, "bn_backward": 0, "context": launches}


# [ddp]: data parallelism on the one card.  World 1 over NCCL through
# torchrun (the CLI's own rendezvous), bitwise against the same run with
# no process group; world 2 over gloo with both ranks on cuda:0 (NCCL
# refuses two ranks on one GPU), each rank stepping on half the fixed
# batch, against world 1 on the whole batch.  gloo's times on the card
# measure correctness, not NCCL's speed.
DDP_RANK_BATCH = TRAIN_BATCH // 2
# world 2 against world 1 after one step: the loss (a sum of the two
# ranks' SSEs against one SSE: f32 summation order) and the update of all
# weights and statistics together, in relative L2 norm.  Only summation
# order differs (8.6e-6 f32, 3.9e-4 bf16 on the card); an all-reduce that
# drops the cross-rank gradient term moves a parameter's update by O(1)
# (up to 1.31 in tests/test_torch_ddp.py's float64 SyncBN case, run on a
# mutated copy)
DDP_LOSS_RTOL = {"f32": 1e-5, "bf16": 2e-2}
DDP_UPDATE_RTOL = {"f32": 1e-3, "bf16": 1e-2}
DDP_CASES = (("f32", False), ("f32 remat", True), ("bf16", False))
DDP_TIMEOUT_S = 420
DDP_STEP_REPS = 5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmds, work: Path, tag: str, want=None) -> list:
    """Start every (argv, env) at once, each in a session of its own, wait
    up to DDP_TIMEOUT_S, and kill whatever is left; logs go to
    ``work/ddp_{tag}_{i}.log``.  Fails unless the exit codes are ``want``
    (default: every process 0)."""
    import signal

    procs, logs = [], []
    for i, (argv, env) in enumerate(cmds):
        path = work / f"ddp_{tag}_{i}.log"
        logs.append(path)
        with open(path, "w") as f:
            procs.append(subprocess.Popen(argv, env=env, cwd=ROOT, stdout=f,
                                          stderr=subprocess.STDOUT,
                                          start_new_session=True))
    deadline = time.perf_counter() + DDP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    rcs = [p.returncode for p in procs]
    if rcs != (want or [0] * len(procs)):
        for path, rc in zip(logs, rcs):
            log(f"[ddp] {path.name} (exit {rc}):\n" + path.read_text()[-4000:])
        fail(f"[ddp] {tag}: exit codes {rcs}, want {want or [0] * len(procs)}")
    return logs


def ddp_step_state(batch, tag: str, remat: bool, world: int, mesh=None):
    """One BN train step from the seed (lr scaled by ``world``) on
    ``batch``: under a live process group through ``make_dp_train_step``,
    else the plain step.  Returns (this step's global loss, the model's
    state dict, launches)."""
    import torch

    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.parallel import make_dp_train_step, make_mesh, reduce_value
    from can_tpu_torch.train import create_train_state, make_lr_schedule

    model = CANNet(device="cuda", seed=SEED, batch_norm=True)
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, make_lr_schedule(1e-6, world_size=world))
    step = make_dp_train_step(model, mesh or make_mesh(),
                              compute_dtype=torch.bfloat16 if tag == "bf16" else None,
                              bn_ops=bm.make_bn_ops("kernel"), remat=remat)
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    _, m = step(state, batch)
    torch.cuda.synchronize()
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    loss = float(reduce_value(np.float64(float(m["loss"])), average=False))
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return loss, sd, launches


def ddp_worker(spec_path: Path) -> int:
    """One rank of a [ddp] run (``chip_smoke.py --ddp-worker SPEC``):
    world 1 under torchrun, or one of the two gloo ranks on cuda:0."""
    import torch

    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.cli import train as train_cli
    from can_tpu_torch.device import use_deterministic, use_full_f32
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.parallel import (
        barrier,
        generation,
        init_runtime,
        process_index,
        shutdown_runtime,
    )

    spec = json.loads(spec_path.read_text())
    if spec["mode"] == "sp":
        return sp_worker(spec)
    if spec["mode"] == "elastic":
        return elastic_worker(spec)
    if spec["mode"] == "nccl":
        return nccl_worker(spec)
    out = {}
    if spec["mode"] == "world1":
        # the train CLI under torchrun: its own rendezvous, NCCL world 1
        cb.reset_launches()
        cc.reset_launches()  # the main path starts here
        summary = train_cli.train(train_cli.parse_args(spec["train_argv"]))
        out["launches"] = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                           "context": cc.LAUNCHES}  # ... and ends here
        out["summary"] = {k: summary[k] for k in ("steps", "eval_batches",
                                                  "world_size", "best_mae")}
        # a second generation for the step timing: DDP against no DDP
        topo = init_runtime()
        out["topology"] = topo
        batch = ddp_batch(Path(spec["root"]), 0, 1)
        from can_tpu_torch.models import CANNet
        from can_tpu_torch.ops import bn_moments as bm
        from can_tpu_torch.parallel import make_dp_train_step, make_mesh
        from can_tpu_torch.train import create_train_state, make_lr_schedule, make_train_step

        steps = {}
        for kind in ("plain", "ddp"):
            model = CANNet(device="cuda", seed=SEED, batch_norm=True)
            model = model.to(memory_format=torch.channels_last)
            state = create_train_state(model, make_lr_schedule(1e-6))
            fn = (make_train_step(bn_ops=bm.make_bn_ops("kernel")) if kind == "plain"
                  else make_dp_train_step(model, make_mesh(),
                                          bn_ops=bm.make_bn_ops("kernel")))
            steps[kind] = (fn, state)
        times = {"plain": [], "ddp": []}
        for kind in ("plain", "ddp", "ddp", "plain"):
            fn, state = steps[kind]
            times[kind].append(time_ms(lambda: fn(state, batch), reps=DDP_STEP_REPS))
        out["step_ms"] = times
        out["generation"] = generation()
        shutdown_runtime()
    else:
        # two ranks on one card: gloo, both on cuda:0
        use_deterministic()
        use_full_f32()
        topo = init_runtime(device=torch.device("cuda", 0), backend="gloo")
        out["topology"] = topo
        rank = process_index()
        if spec.get("build_root"):
            # every rank builds the kernels at once, into a fresh root: the
            # build cache the CLIs' --compile-cache auto then finds too
            from can_tpu_torch.ops import _build
            from can_tpu_torch.utils.compile_cache import enable_compilation_cache

            os.environ["CAN_TPU_COMPILE_CACHE"] = spec["build_root"]
            enable_compilation_cache()
            t0 = time.perf_counter()
            _build.load_kernel_libraries([cc.KERNEL, cb.KERNEL])
            out["build_s"] = time.perf_counter() - t0
            out["build_hits"] = {k: v["source"] == "cache"
                                 for k, v in _build.build_info.items()}
            barrier("kernels-built")
        batch = ddp_batch(Path(spec["root"]), rank, 2)
        out["cases"] = {}
        for tag, remat in DDP_CASES:
            loss, sd, launches = ddp_step_state(batch, tag.split()[0], remat, 2)
            path = Path(spec["out_dir"]) / f"{tag.replace(' ', '_')}_rank{rank}.pt"
            torch.save(sd, path)
            out["cases"][tag] = {"loss": loss, "state": str(path), "launches": launches}
        # the gloo step's time (correctness, not NCCL's speed)
        from can_tpu_torch.models import CANNet
        from can_tpu_torch.ops import bn_moments as bm
        from can_tpu_torch.parallel import make_dp_train_step, make_mesh
        from can_tpu_torch.train import create_train_state, make_lr_schedule

        model = CANNet(device="cuda", seed=SEED, batch_norm=True)
        model = model.to(memory_format=torch.channels_last)
        state = create_train_state(model, make_lr_schedule(1e-6, world_size=2))
        step = make_dp_train_step(model, make_mesh(), bn_ops=bm.make_bn_ops("kernel"))
        out["gloo_step_ms"] = time_ms(lambda: step(state, batch), reps=DDP_STEP_REPS)
        del model, state, step
        cc.reset_launches()  # the main path starts here
        got = eval_cli.evaluate_checkpoint(eval_cli.parse_args(spec["eval_argv"]))
        out["eval"] = {k: got[k] for k in ("mae", "mse", "num_images", "batches")}
        out["eval"]["launches"] = cc.LAUNCHES  # ... and ends here
        shutdown_runtime()
    (Path(spec["out_dir"]) / f"{spec['mode']}_rank{out['topology']['process_index']}.json"
     ).write_text(json.dumps(out))
    return 0


def ddp_batch(root: Path, rank: int, nproc: int):
    """This rank's slice of the fixed batch (the first launch of the
    smoke's training schedule, ``fixed_batch``), on the card: the
    lockstep batcher's own slicing."""
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher
    from can_tpu_torch.train.steps import batch_to_device

    ds = CrowdDataset(str(root / "train_data" / "images"),
                      str(root / "train_data" / "ground_truth"))
    batch = next(ShardedBatcher(ds, TRAIN_BATCH // nproc, seed=SEED,
                                pad_multiple=TRAIN_PAD, process_index=rank,
                                process_count=nproc).epoch(0))
    return batch_to_device(batch, "cuda")


def _update_rel(old: dict, got: dict, want: dict) -> float:
    """The update of all floating weights and statistics together, in
    relative L2 norm: |(got - old) - (want - old)| / |want - old|."""
    import torch

    num = den = 0.0
    for k, w in want.items():
        if not torch.is_floating_point(w):
            continue
        d = want[k].double() - old[k].double()
        num += float(((got[k].double() - old[k].double()) - d).pow(2).sum())
        den += float(d.pow(2).sum())
    return (num / den) ** 0.5


def phase_ddp(work: Path) -> dict:
    """World 1 over NCCL (torchrun, the train CLI) bitwise against no
    process group; world 2 over gloo on one card against world 1, bitwise
    against itself; evaluation at world 2 against world 1."""
    import torch

    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.utils.checkpoint import CheckpointManager

    root = train_data(work)
    ddp_dir = work / "ddp"
    ddp_dir.mkdir(exist_ok=True)
    counts = {"bn": 0, "bn_backward": 0, "context": 0}

    def add(launches):
        for k, v in launches.items():
            counts[k] += v

    # -- world 1 over NCCL, against no process group --------------------------
    base = ["--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
            "--batch-size", str(TRAIN_BATCH), "--pad-multiple", str(TRAIN_PAD),
            "--no-remnant-batches", "--epochs", "1", "--max-steps-per-epoch",
            str(TRAIN_STEPS), "--lr", "1e-6", "--seed", str(SEED)]
    from can_tpu_torch.cli import train as train_cli

    ck0, ck1 = ddp_dir / "ckpt_nogroup", ddp_dir / "ckpt_world1"
    batch = fixed_batch(root)
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    train_cli.train(train_cli.parse_args(base + ["--checkpoint-dir", str(ck0)]))
    add({"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
         "context": cc.LAUNCHES})  # ... and ends here
    torch.cuda.empty_cache()
    spec = ddp_dir / "world1.json"
    spec.write_text(json.dumps({"mode": "world1", "root": str(root),
                                "out_dir": str(ddp_dir),
                                "train_argv": base + ["--checkpoint-dir", str(ck1)]}))
    env = dict(os.environ)
    t0 = time.perf_counter()
    run_ranks([([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=1", str(ROOT / "chip_smoke.py"), "--ddp-worker",
                 str(spec)], env)], ddp_dir, "world1")
    w1_s = time.perf_counter() - t0
    w1 = json.loads((ddp_dir / "world1_rank0.json").read_text())
    add(w1["launches"])
    topo = w1["topology"]
    if (topo["backend"], topo["process_count"], topo["source"]) != ("nccl", 1, "torchrun"):
        fail(f"[ddp] world 1: topology {topo}, want nccl, 1 process, from torchrun")
    a = CheckpointManager(str(ck0)).model_state_dict(0)
    b = CheckpointManager(str(ck1)).model_state_dict(0)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    mae0 = json.loads((ck0 / "0" / "metrics.json").read_text())
    mae1 = json.loads((ck1 / "0" / "metrics.json").read_text())
    if bad or mae0 != mae1 or w1["summary"]["world_size"] != 1:
        fail(f"[ddp] world 1 over NCCL differs from no process group: "
             f"{len(bad)} tensors ({bad[:4]}), metrics {mae1} vs {mae0}")
    for key in ("bn", "bn_backward"):
        if w1["launches"][key] != BN_LAYERS * w1["summary"]["steps"]:
            fail(f"[ddp] world 1: {key} launched {w1['launches'][key]} times, "
                 f"want {BN_LAYERS} x {w1['summary']['steps']}")
    plain = statistics.median(w1["step_ms"]["plain"])
    ddp = statistics.median(w1["step_ms"]["ddp"])
    log(f"[ddp] world 1 over NCCL (torchrun --standalone --nproc_per_node=1, the "
        f"train CLI): {w1['summary']['steps']} steps, {len(a)} model tensors and "
        f"the eval metrics {mae1} bitwise equal to the same run with no process "
        f"group; launches on rank 0: bn_moments {w1['launches']['bn']}, "
        f"bn_moments_backward {w1['launches']['bn_backward']}, context_fused "
        f"{w1['launches']['context']}; the torchrun call took {w1_s:.1f} s")
    log(f"[ddp] world 1 step at {tuple(batch['image'].shape[:3])} f32: DDP "
        f"{' / '.join(f'{t:.2f}' for t in w1['step_ms']['ddp'])} ms against no "
        f"DDP {' / '.join(f'{t:.2f}' for t in w1['step_ms']['plain'])} ms "
        f"(medians of {DDP_STEP_REPS} single steps per CUDA-event pair, in turns): "
        f"overhead {100 * (ddp / plain - 1):+.2f}% (generation "
        f"{w1['generation']} of the worker's runtime)")

    # -- world 2 over gloo on one card, against world 1 ----------------------
    refs = {}
    for tag, remat in DDP_CASES:
        loss, sd, launches = ddp_step_state(batch, tag.split()[0], remat, 1)
        refs[tag] = (loss, sd)
        add(launches)
    old = {k: v.detach().cpu().clone() for k, v in
           CANNet(device="cpu", seed=SEED, batch_norm=True).state_dict().items()}
    del batch
    torch.cuda.empty_cache()
    eval_argv = ["--data_root", str(root), "--checkpoint-dir", str(ck1), "--syncBN",
                 "--num-workers", "0"]
    runs = []
    for run in ("a", "b"):
        out_dir = ddp_dir / f"world2_{run}"
        out_dir.mkdir(exist_ok=True)
        port = _free_port()
        cmds = []
        for rank in range(2):
            spec = out_dir / f"spec{rank}.json"
            spec.write_text(json.dumps({
                "mode": "world2", "root": str(root), "out_dir": str(out_dir),
                "eval_argv": eval_argv + ["--batch-size", str(DDP_RANK_BATCH)],
                # run a: both ranks build the kernels at once, from nothing
                "build_root": str(out_dir / "build") if run == "a" else ""}))
            cmds.append(([sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker",
                          str(spec)],
                         dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                              LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port))))
        t0 = time.perf_counter()
        run_ranks(cmds, ddp_dir, f"world2_{run}")
        secs = time.perf_counter() - t0
        ranks = [json.loads((out_dir / f"world2_rank{r}.json").read_text())
                 for r in range(2)]
        for r in ranks:
            for c in r["cases"].values():
                add(c["launches"])
            add({"context": r["eval"]["launches"]})
        runs.append(ranks)
        log(f"[ddp] world 2 over gloo, run {run}: {secs:.1f} s for both ranks; "
            + ("kernel build with both ranks compiling at once: "
               + ", ".join(f"rank {i} {r['build_s']:.2f} s (cache hits "
                           f"{r['build_hits']})" for i, r in enumerate(ranks)) + "; "
               if run == "a" else "")
            + "launches per rank: " + "; ".join(
                f"rank {i} " + ", ".join(
                    f"{tag} bn {c['launches']['bn']}/{c['launches']['bn_backward']} "
                    f"context {c['launches']['context']}"
                    for tag, c in r["cases"].items())
                + f", eval context {r['eval']['launches']}" for i, r in enumerate(ranks))
            + f"; gloo step {ranks[0]['gloo_step_ms']:.1f} ms (gloo through the "
              f"host: a correctness figure, not NCCL's speed)")
    states = {(run, r, tag): torch.load(runs[run][r]["cases"][tag]["state"])
              for run in range(2) for r in range(2) for tag, _ in DDP_CASES}
    for tag, remat in DDP_CASES:
        want_launch = {"bn": BN_LAYERS * (2 if remat else 1), "bn_backward": BN_LAYERS,
                       "context": 2 if remat else 1}
        for run in range(2):
            for r in range(2):
                got = runs[run][r]["cases"][tag]["launches"]
                if got != want_launch:
                    fail(f"[ddp] world 2 {tag}: rank {r} launches {got}, want "
                         f"{want_launch}")
        # the replicas agree, and a second world-2 run repeats bitwise
        for key in ((0, 1, tag), (1, 0, tag), (1, 1, tag)):
            bad, worst = snap_diff(states[(0, 0, tag)], states[key])
            if bad:
                fail(f"[ddp] world 2 {tag}: run/rank {key[:2]} differs from run "
                     f"a rank 0 in {len(bad)} tensors (worst {worst:.3e})")
        dt = tag.split()[0]
        loss2 = runs[0][0]["cases"][tag]["loss"]
        loss1, sd1 = refs[tag]
        loss_rel = abs(loss2 - loss1) / abs(loss1)
        upd = _update_rel(old, states[(0, 0, tag)], sd1)
        log(f"[ddp] world 2 ({DDP_RANK_BATCH} images per rank) against world 1 "
            f"({TRAIN_BATCH} images), one {tag} step: loss {loss2:.9g} vs "
            f"{loss1:.9g} (rel {loss_rel:.2e}, tolerance {DDP_LOSS_RTOL[dt]:g}); the "
            f"update of all weights and statistics within {upd:.3e} relative L2 "
            f"(tolerance {DDP_UPDATE_RTOL[dt]:g}); both ranks and a second world-2 "
            f"run bitwise equal")
        if loss_rel > DDP_LOSS_RTOL[dt] or not upd <= DDP_UPDATE_RTOL[dt]:
            fail(f"[ddp] world 2 {tag} is off world 1: loss rel {loss_rel:.2e}, "
                 f"update rel {upd:.3e}")
    bad, worst = snap_diff(states[(0, 0, "f32")], states[(0, 0, "f32 remat")])
    if bad:
        fail(f"[ddp] world 2: the remat step differs from the plain step in "
             f"{len(bad)} tensors (worst {worst:.3e})")
    log("[ddp] world 2: the remat step bitwise equal to the plain step")

    # -- evaluation at world 2 against world 1 ---------------------------------
    cc.reset_launches()  # the main path starts here
    one = eval_cli.evaluate_checkpoint(eval_cli.parse_args(
        eval_argv + ["--batch-size", str(TRAIN_BATCH)]))
    one_launches = cc.LAUNCHES  # ... and ends here
    add({"context": one_launches})
    for run in range(2):
        for r in range(2):
            two = runs[run][r]["eval"]
            for k in ("mae", "mse"):
                rel = abs(two[k] - one[k]) / abs(one[k])
                if rel > EVAL_RTOL or two["num_images"] != one["num_images"]:
                    fail(f"[ddp] eval at world 2 (run {run}, rank {r}): {k} "
                         f"{two[k]!r} vs world 1 {one[k]!r} (rel {rel:.2e})")
    two = runs[0][0]["eval"]
    log(f"[ddp] eval CLI at world 2 ({DDP_RANK_BATCH} per rank): MAE "
        f"{two['mae']:.9g} MSE {two['mse']:.9g} over {two['num_images']} images, "
        f"world 1 ({TRAIN_BATCH} per launch): MAE {one['mae']:.9g} MSE "
        f"{one['mse']:.9g} (rtol {EVAL_RTOL}); context_fused launches per rank "
        f"{two['launches']} ({two['batches']} batches), world 1 {one_launches} "
        f"({one['batches']} batches)")
    log(f"[ddp] launches in this phase: {counts}")
    return counts


# [sp]: spatial parallelism on the one card.  Two gloo ranks on cuda:0
# (NCCL refuses two ranks on one GPU) split the fixed batch's rows; the
# halo rows go through pinned host buffers (gloo sends CPU tensors only),
# so the times here measure correctness, not NCCL's speed.
SP_CASES = DDP_CASES
# the sp=2 step against world 1: as [ddp]'s world 2 (summation order only)
SP_LOSS_RTOL, SP_UPDATE_RTOL = DDP_LOSS_RTOL, DDP_UPDATE_RTOL
# the dp=2 x sp=2 mesh check: 4 ranks on the card at a smaller batch
SP_SMALL = (4, 256, 320)
# one UCF-QNRF-scale image, BN f32, at sp=1 and at sp=2
SP_UCF = (1, 2048, 2048)
# the context kernel on an H-shard's rows against the plain version
SP_CONTEXT_SHAPE = (8, 72, 96, 512)
SP_STEP_REPS = 3


def sp_host_block(root: Path, mesh):
    """Rank (d, s)'s block of the fixed batch: its replica's slice of the
    schedule's first launch, its rows of it, on the card
    (``make_global_batch(..., spatial=True)``: the rows are cut on the
    host)."""
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher
    from can_tpu_torch.parallel import make_global_batch

    ds = CrowdDataset(str(root / "train_data" / "images"),
                      str(root / "train_data" / "ground_truth"))
    host = next(ShardedBatcher(ds, TRAIN_BATCH // mesh.dp, seed=SEED,
                               pad_multiple=TRAIN_PAD, process_index=mesh.d,
                               process_count=mesh.dp).epoch(0))
    return make_global_batch(host, mesh, device="cuda", spatial=True)


def sp_synthetic_block(shape, mesh):
    """Rank (d, s)'s block of ``synthetic_batch(*shape)`` (the same seeded
    batch on every rank)."""
    b, h, _ = shape
    full = synthetic_batch(*shape)
    n, hl, gl = b // mesh.dp, h // mesh.sp, h // 8 // mesh.sp
    d, s = mesh.d, mesh.s
    return {"image": full["image"][d * n:(d + 1) * n, s * hl:(s + 1) * hl].contiguous(),
            "dmap": full["dmap"][d * n:(d + 1) * n, s * gl:(s + 1) * gl].contiguous(),
            "pixel_mask": full["pixel_mask"][d * n:(d + 1) * n,
                                             s * gl:(s + 1) * gl].contiguous(),
            "sample_mask": full["sample_mask"][d * n:(d + 1) * n]}


def sp_step(block, mesh, hw, tag: str, remat: bool):
    """One sp BN step from the seed on this rank's block: (global loss,
    state dict, launches, the step's halo and pooled all-reduce counts,
    the step object and state for timing)."""
    import torch

    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.parallel import make_sp_train_step, reduce_value
    from can_tpu_torch.parallel import spatial
    from can_tpu_torch.train import create_train_state, make_lr_schedule

    model = CANNet(device="cuda", seed=SEED, batch_norm=True)
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, make_lr_schedule(1e-6, world_size=mesh.dp))
    step = make_sp_train_step(model, mesh, hw, bn_ops=bm.make_bn_ops("kernel"),
                              compute_dtype=torch.bfloat16 if tag == "bf16" else None,
                              remat=remat)
    spatial.reset_stats()
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    _, m = step(state, block)
    torch.cuda.synchronize()
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    stats = dict(spatial.STATS)
    loss = float(reduce_value(np.float64(float(m["loss"])), average=False))
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return loss, sd, launches, stats, (step, state)


def sp_context_check(mesh) -> float:
    """The context kernel on this shard's rows of a (8, 72, 96, 512) map,
    with rows [row0, row0 + 36) of the whole map's interpolation matrix,
    against ``reference_context`` on the same slice (``[kernel]``'s
    tolerances); returns the worst abs error.  Not on the main path."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc

    b, h, w, c = SP_CONTEXT_SHAPE
    hl = h // mesh.sp
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    fv32 = torch.randn((b, h, w, c), generator=g, device="cuda")
    fv32 = fv32[:, mesh.s * hl:(mesh.s + 1) * hl].contiguous()
    aves32 = [torch.randn((b, s, s, c), generator=g, device="cuda") for s in cc.SCALES]
    ws32 = [torch.randn((c, c), generator=g, device="cuda") / c ** 0.5
            for _ in cc.SCALES]
    worst = 0.0
    fused = cc.make_fused_context()
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (fv32.to(dt), [a.to(dt) for a in aves32], [x.to(dt) for x in ws32],
                (h, w))
        got = fused(*args, row0=mesh.s * hl).float()
        want = cc.reference_context(*args, row0=mesh.s * hl).float()
        rtol, atol = TOL[name]
        diff = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or not bool(
                (diff <= atol + rtol * want.abs()).all()):
            fail(f"[sp] context_fused on rows {mesh.s * hl}..{(mesh.s + 1) * hl} "
                 f"{name}: max abs err {float(diff.max()):.3e} exceeds rtol "
                 f"{rtol} / atol {atol}")
        worst = max(worst, float(diff.max()))
    return worst


def sp_halo_ms(block, mesh, hw) -> dict:
    """The halo exchanges of one f32 step, replayed alone: their shapes
    recorded through a step, then the same exchanges timed back to back
    (both ranks in lockstep; the staged copies are synchronous)."""
    import torch

    from can_tpu_torch.parallel import barrier
    from can_tpu_torch.parallel import spatial

    shapes = []
    real = spatial.HaloTransport.exchange

    def recording(self, down, up):
        shapes.append((tuple(down.shape), tuple(up.shape), down.dtype))
        return real(self, down, up)

    spatial.HaloTransport.exchange = recording
    try:
        sp_step(block, mesh, hw, "f32", False)
    finally:
        spatial.HaloTransport.exchange = real
    transport = spatial.HaloTransport(mesh, "cuda")
    bufs = [(torch.zeros(a, dtype=dt, device="cuda"), torch.zeros(b, dtype=dt, device="cuda"))
            for a, b, dt in shapes]
    times = []
    for _ in range(SP_STEP_REPS):
        barrier("sp-halo")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for down, up in bufs:
            transport.exchange(down, up)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(d.numel() * d.element_size() + u.numel() * u.element_size()
                 for d, u in bufs) // mesh.sp
    return {"exchanges": len(shapes), "ms": statistics.median(times),
            "bytes_sent_per_rank": nbytes}


def sp_ucf(mesh) -> dict:
    """One UCF-QNRF-scale image, BN f32: the step's median ms and this
    process's peak memory, on this rank's block (the whole image at sp=1)."""
    import torch

    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.parallel import make_sp_train_step
    from can_tpu_torch.train import create_train_state, make_lr_schedule, make_train_step

    torch.cuda.empty_cache()
    model = CANNet(device="cuda", seed=SEED, batch_norm=True)
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, make_lr_schedule(1e-6))
    if mesh is None:
        batch = synthetic_batch(*SP_UCF)
        step = make_train_step(bn_ops=bm.make_bn_ops("kernel"))
    else:
        batch = sp_synthetic_block(SP_UCF, mesh)
        step = make_sp_train_step(model, mesh, SP_UCF[1:],
                                  bn_ops=bm.make_bn_ops("kernel"))
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(state, batch), reps=SP_STEP_REPS)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, batch
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak / 2 ** 30}


def sp_worker(spec: dict) -> int:
    """One rank of an [sp] run: gloo ranks on cuda:0 (``spec["nccl"]``
    false) or torchrun's ranks on cuda:LOCAL_RANK over NCCL; the fixed
    batch's blocks (all of ``SP_CASES``) or, with ``spec["small"]``, the
    smaller synthetic batch's (f32); ``measure``: step times, the context
    check, the halo replay, the UCF-scale image and the eval CLI;
    ``ucf``: step times, the halo replay and the UCF-scale image."""
    import torch

    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.device import use_deterministic, use_full_f32
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.parallel import init_runtime, make_mesh, shutdown_runtime
    from can_tpu_torch.parallel.spatial import HaloTransport

    use_deterministic()
    use_full_f32()
    topo = (init_runtime() if spec.get("nccl")
            else init_runtime(device=torch.device("cuda", 0), backend="gloo"))
    mesh = make_mesh(dp=spec["dp"], sp=spec["sp"])
    out = {"topology": topo, "mesh": [mesh.d, mesh.s], "cases": {},
           "halo_path": HaloTransport(mesh, "cuda").path}
    out_dir = Path(spec["out_dir"])
    if spec.get("small"):
        block = sp_synthetic_block(SP_SMALL, mesh)
        hw = SP_SMALL[1:]
        cases = (("f32", False),)
    else:
        block = sp_host_block(Path(spec["root"]), mesh)
        hw = (block["image"].shape[1] * mesh.sp, block["image"].shape[2])
        cases = SP_CASES
    timed = spec.get("measure") or spec.get("ucf")
    out["block"] = list(block["image"].shape)
    for tag, remat in cases:
        loss, sd, launches, stats, (step, state) = sp_step(block, mesh, hw,
                                                           tag.split()[0], remat)
        path = out_dir / f"{tag.replace(' ', '_')}_rank{topo['process_index']}.pt"
        torch.save(sd, path)
        out["cases"][tag] = {"loss": loss, "state": str(path), "launches": launches,
                             "stats": stats}
        if timed and tag in ("f32", "bf16"):
            out["cases"][tag]["step_ms"] = time_ms(lambda: step(state, block),
                                                   reps=SP_STEP_REPS)
        del step, state
    if timed:
        out["halo"] = sp_halo_ms(block, mesh, hw)
        del block
        out["ucf"] = sp_ucf(mesh)
    if spec.get("measure"):
        out["context_err"] = sp_context_check(mesh)
        cc.reset_launches()  # the main path starts here
        got = eval_cli.evaluate_checkpoint(eval_cli.parse_args(spec["eval_argv"]))
        out["eval"] = {k: got[k] for k in ("mae", "mse", "num_images", "batches")}
        out["eval"]["launches"] = cc.LAUNCHES  # ... and ends here
    shutdown_runtime()
    (out_dir / f"sp_rank{topo['process_index']}.json").write_text(json.dumps(out))
    return 0


def sp_ranks(work: Path, sp_dir: Path, tag: str, spec: dict, world: int) -> list:
    """Run ``world`` [sp] ranks — on cuda:0 over gloo, or with
    ``spec["nccl"]`` one per GPU over NCCL under ``torchrun --standalone``
    — and return their JSON results."""
    out_dir = sp_dir / tag
    out_dir.mkdir(exist_ok=True)
    port = _free_port()
    cmds = []
    if spec.get("nccl"):
        path = out_dir / "spec.json"
        path.write_text(json.dumps(dict(spec, mode="sp", out_dir=str(out_dir))))
        cmds.append(([sys.executable, "-m", "torch.distributed.run", "--standalone",
                      f"--nproc_per_node={world}", str(ROOT / "chip_smoke.py"),
                      "--ddp-worker", str(path)], dict(os.environ)))
    for rank in range(0 if spec.get("nccl") else world):
        path = out_dir / f"spec{rank}.json"
        path.write_text(json.dumps(dict(spec, mode="sp", out_dir=str(out_dir))))
        cmds.append(([sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker",
                      str(path)],
                     dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))))
    t0 = time.perf_counter()
    run_ranks(cmds, sp_dir, f"sp_{tag}")
    log(f"[sp] {tag}: {world} ranks in {time.perf_counter() - t0:.1f} s")
    return [json.loads((out_dir / f"sp_rank{r}.json").read_text()) for r in range(world)]


def _check_sp_case(tag, ranks, want_launch, ref, old, label):
    """Every rank's launches exact and state bitwise equal to rank 0's;
    the step against world 1 (loss, update of all weights)."""
    import torch

    for r, out in enumerate(ranks):
        got = out["cases"][tag]["launches"]
        if got != want_launch:
            fail(f"[sp] {label} {tag}: rank {r} launches {got}, want {want_launch} "
                 f"(short = a plain-version fallback)")
    states = [torch.load(out["cases"][tag]["state"]) for out in ranks]
    for r in range(1, len(states)):
        bad, worst = snap_diff(states[0], states[r])
        if bad:
            fail(f"[sp] {label} {tag}: rank {r} differs from rank 0 in {len(bad)} "
                 f"tensors (worst {worst:.3e})")
    dt = tag.split()[0]
    loss, loss1 = ranks[0]["cases"][tag]["loss"], ref[0]
    loss_rel = abs(loss - loss1) / abs(loss1)
    upd = _update_rel(old, states[0], ref[1])
    if loss_rel > SP_LOSS_RTOL[dt] or not upd <= SP_UPDATE_RTOL[dt]:
        fail(f"[sp] {label} {tag} is off world 1: loss rel {loss_rel:.2e}, "
             f"update rel {upd:.3e}")
    return states[0], loss, loss_rel, upd


def phase_sp(work: Path) -> dict:
    """dp=1 x sp=2 on the fixed batch (f32, f32 remat, bf16) against world
    1, bitwise across ranks and across two runs; the context kernel on a
    shard's rows; the halo and pooled all-reduce counts and the halo's
    time; one UCF-QNRF-scale image at sp=1 and sp=2; the eval CLI at
    --sp 2 against world 1; a dp=2 x sp=2 step of 4 ranks against world
    1."""
    import torch

    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.cli import train as train_cli
    from can_tpu_torch.device import use_deterministic
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.utils.checkpoint import has_checkpoint

    t_phase = time.perf_counter()
    use_deterministic()  # as every phase from [determinism] on (--sp-only too)
    root = train_data(work)
    sp_dir = work / "sp"
    sp_dir.mkdir(exist_ok=True)
    counts = {"bn": 0, "bn_backward": 0, "context": 0}

    def add(launches):
        for k, v in launches.items():
            counts[k] += v

    ck = work / "ddp" / "ckpt_world1"  # [ddp]'s checkpoint, else a fresh one
    if not has_checkpoint(str(ck)):
        ck = sp_dir / "ckpt"
        cc.reset_launches()  # set-up, not the main path: not counted
        train_cli.train(train_cli.parse_args([
            "--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
            "--batch-size", str(TRAIN_BATCH), "--pad-multiple", str(TRAIN_PAD),
            "--no-remnant-batches", "--epochs", "1", "--max-steps-per-epoch",
            str(TRAIN_STEPS), "--lr", "1e-6", "--seed", str(SEED),
            "--checkpoint-dir", str(ck)]))
    batch = fixed_batch(root)
    refs = {}
    for tag, remat in SP_CASES:
        loss, sd, launches = ddp_step_state(batch, tag.split()[0], remat, 1)
        refs[tag] = (loss, sd)
        add(launches)
    small = synthetic_batch(*SP_SMALL)
    loss, sd, launches = ddp_step_state(small, "f32", False, 1)
    refs["small"] = (loss, sd)
    add(launches)
    del batch, small
    ucf1 = sp_ucf(None)
    eval_argv = ["--data_root", str(root), "--checkpoint-dir", str(ck), "--syncBN",
                 "--num-workers", "0", "--batch-size", str(TRAIN_BATCH)]
    cc.reset_launches()  # the main path starts here
    one = eval_cli.evaluate_checkpoint(eval_cli.parse_args(eval_argv))
    add({"context": cc.LAUNCHES})  # ... and ends here
    old = {k: v.detach().cpu().clone() for k, v in
           CANNet(device="cpu", seed=SEED, batch_norm=True).state_dict().items()}
    torch.cuda.empty_cache()

    spec = {"root": str(root), "dp": 1, "sp": 2}
    runs = [sp_ranks(work, sp_dir, "a", dict(spec, measure=True,
                                              eval_argv=eval_argv + ["--sp", "2"]), 2),
            sp_ranks(work, sp_dir, "b", spec, 2)]
    four = sp_ranks(work, sp_dir, "dp2", {"root": str(root), "dp": 2, "sp": 2,
                                          "small": True}, 4)
    for ranks in runs + [four]:
        for r in ranks:
            for c in r["cases"].values():
                add(c["launches"])
    add({"context": sum(r["eval"]["launches"] for r in runs[0])})
    a = runs[0]
    for r, out in enumerate(a):
        if out["mesh"] != [0, r] or out["topology"]["backend"] != "gloo":
            fail(f"[sp] rank {r}: mesh {out['mesh']} topology {out['topology']}")
    for r, out in enumerate(four):
        if out["mesh"] != list(divmod(r, 2)):
            fail(f"[sp] dp=2 x sp=2 rank {r}: mesh (d, s) {out['mesh']}, want "
                 f"{list(divmod(r, 2))} (rank = d * sp + s)")
    for tag, remat in SP_CASES:
        want_launch = {"bn": BN_LAYERS * (2 if remat else 1), "bn_backward": BN_LAYERS,
                       "context": 2 if remat else 1}
        state_a, loss, loss_rel, upd = _check_sp_case(tag, a, want_launch, refs[tag],
                                                      old, "sp=2")
        bad, worst = snap_diff(state_a, torch.load(runs[1][0]["cases"][tag]["state"]))
        if bad or runs[1][0]["cases"][tag]["loss"] != loss:
            fail(f"[sp] sp=2 {tag}: a second run differs in {len(bad)} tensors "
                 f"(worst {worst:.3e})")
        st = a[0]["cases"][tag]["stats"]
        log(f"[sp] sp=2 (two gloo ranks on cuda:0, blocks {tuple(a[0]['block'])} of "
            f"the fixed batch) against world 1, one {tag} step: loss "
            f"{loss:.9g} vs {refs[tag][0]:.9g} (rel {loss_rel:.2e}, tolerance "
            f"{SP_LOSS_RTOL[tag.split()[0]]:g}); update of all weights and statistics "
            f"within {upd:.3e} relative L2 (tolerance "
            f"{SP_UPDATE_RTOL[tag.split()[0]]:g}); both ranks and a second run "
            f"bitwise equal; launches per rank {a[0]['cases'][tag]['launches']}; "
            f"halo exchanges {st['halo_exchanges']} ({st['halo_bytes'] / 1e6:.3f} MB "
            f"sent per rank), pooled all-reduces {st['pool_allreduces']} per step"
            + (f"; step {a[0]['cases'][tag]['step_ms']:.1f} / "
               f"{a[1]['cases'][tag]['step_ms']:.1f} ms (ranks 0 / 1)"
               if "step_ms" in a[0]["cases"][tag] else ""))
    bad, worst = snap_diff(torch.load(a[0]["cases"]["f32"]["state"]),
                           torch.load(a[0]["cases"]["f32 remat"]["state"]))
    if bad:
        fail(f"[sp] sp=2: the remat step differs from the plain step in {len(bad)} "
             f"tensors (worst {worst:.3e})")
    _, loss, loss_rel, upd = _check_sp_case(
        "f32", four, {"bn": BN_LAYERS, "bn_backward": BN_LAYERS, "context": 1},
        refs["small"], old, "dp=2 x sp=2")
    log(f"[sp] sp=2: the remat step bitwise equal to the plain step; dp=2 x sp=2 "
        f"(4 gloo ranks on cuda:0, rank = d * sp + s) at {SP_SMALL} against world "
        f"1: loss rel {loss_rel:.2e}, update rel {upd:.3e}, 4 ranks bitwise equal")
    errs = [out["context_err"] for out in a]
    log(f"[sp] context_fused on each shard's rows of {SP_CONTEXT_SHAPE} (rows "
        f"[row0, row0 + {SP_CONTEXT_SHAPE[1] // 2}) of the whole map's uh) against "
        f"reference_context, f32 and bf16: worst abs err {max(errs):.3e} (rtol/atol "
        f"f32 {TOL['f32']}, bf16 {TOL['bf16']})")
    h = a[0]["halo"]
    log(f"[sp] halo at sp=2, {h['exchanges']} exchanges of one f32 step (forward "
        f"and backward) replayed alone: {h['ms']:.2f} ms, "
        f"{h['bytes_sent_per_rank'] / 1e6:.3f} MB sent per rank (gloo through "
        f"pinned host buffers: not NCCL's speed)")
    log(f"[sp] UCF-QNRF scale {SP_UCF}, BN f32 step: sp=1 {ucf1['ms']:.1f} ms, peak "
        f"{ucf1['peak_gib']:.2f} GiB; sp=2 (two ranks time-sharing the card) "
        + " / ".join(f"{out['ucf']['ms']:.1f} ms" for out in a) + ", peak per rank "
        + " / ".join(f"{out['ucf']['peak_gib']:.2f} GiB" for out in a))
    for r, out in enumerate(a):
        ev = out["eval"]
        for k in ("mae", "mse"):
            rel = abs(ev[k] - one[k]) / abs(one[k])
            if rel > EVAL_RTOL or ev["num_images"] != one["num_images"]:
                fail(f"[sp] eval CLI at --sp 2 (rank {r}): {k} {ev[k]!r} vs world 1 "
                     f"{one[k]!r} (rel {rel:.2e})")
        if ev["launches"] != ev["batches"]:
            fail(f"[sp] eval at --sp 2 rank {r}: context launched {ev['launches']} "
                 f"times for {ev['batches']} batches")
    ev = a[0]["eval"]
    log(f"[sp] eval CLI at --sp 2: MAE {ev['mae']:.9g} MSE {ev['mse']:.9g} over "
        f"{ev['num_images']} images, world 1 MAE {one['mae']:.9g} MSE "
        f"{one['mse']:.9g} (rtol {EVAL_RTOL}); context_fused launches per rank "
        f"{ev['launches']} ({ev['batches']} batches)")
    log(f"[sp] launches in this phase: {counts}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_sp_nccl(work: Path) -> None:
    """``--sp-nccl``, on a machine with 4 GPUs: torchrun's ranks one per
    GPU over NCCL (the halo through ``batch_isend_irecv``): dp=1 x sp=2 on
    2 GPUs (the fixed batch, f32 / f32 remat / bf16; step ms; the halo
    replayed alone; the UCF-scale image's step ms and peak per rank) and
    dp=2 x sp=2 on 4 (the fixed batch), each against world 1 on cuda:0 by
    [sp]'s gates, ranks bitwise, launches exact."""
    import torch

    from can_tpu_torch.device import use_deterministic
    from can_tpu_torch.models import CANNet

    if torch.cuda.device_count() < 4:
        fail(f"--sp-nccl needs 4 GPUs, {torch.cuda.device_count()} visible")
    use_deterministic()
    root = train_data(work)
    sp_dir = work / "sp_nccl"
    sp_dir.mkdir(exist_ok=True)
    batch = fixed_batch(root)
    refs = {}
    for tag, remat in SP_CASES:
        loss, sd, _ = ddp_step_state(batch, tag.split()[0], remat, 1)
        refs[tag] = (loss, sd)
    step_ms = {}
    for tag in ("f32", "bf16"):
        state = _state()
        from can_tpu_torch.ops import bn_moments as bm
        from can_tpu_torch.train import make_train_step

        step = make_train_step(bn_ops=bm.make_bn_ops("kernel"),
                               compute_dtype=torch.bfloat16 if tag == "bf16" else None)
        step_ms[tag] = time_ms(lambda: step(state, batch), reps=SP_STEP_REPS)
        del state, step
    del batch
    ucf1 = sp_ucf(None)
    old = {k: v.detach().cpu().clone() for k, v in
           CANNet(device="cpu", seed=SEED, batch_norm=True).state_dict().items()}
    torch.cuda.empty_cache()
    base = {"root": str(root), "sp": 2, "nccl": True}
    two = sp_ranks(work, sp_dir, "nccl_sp2", dict(base, dp=1, ucf=True), 2)
    four = sp_ranks(work, sp_dir, "nccl_dp2_sp2", dict(base, dp=2), 4)
    for label, ranks in (("NCCL sp=2", two), ("NCCL dp=2 x sp=2", four)):
        for r, out in enumerate(ranks):
            topo = out["topology"]
            if (topo["backend"], out["halo_path"], out["mesh"]) != (
                    "nccl", "nccl", list(divmod(r, 2))) or topo["device"] != f"cuda:{r}":
                fail(f"[sp] {label} rank {r}: topology {topo}, halo "
                     f"{out['halo_path']}, mesh {out['mesh']}")
        for tag, remat in SP_CASES:
            want_launch = {"bn": BN_LAYERS * (2 if remat else 1),
                           "bn_backward": BN_LAYERS, "context": 2 if remat else 1}
            _, loss, loss_rel, upd = _check_sp_case(tag, ranks, want_launch, refs[tag],
                                                    old, label)
            st = ranks[0]["cases"][tag]["stats"]
            ms = ranks[0]["cases"][tag].get("step_ms")
            log(f"[sp] {label} (one GPU per rank, blocks "
                f"{tuple(ranks[0]['block'])}) against world 1, one {tag} step: "
                f"loss rel {loss_rel:.2e}, update rel {upd:.3e}, ranks bitwise; "
                f"halo {st['halo_exchanges']} exchanges, {st['halo_bytes'] / 1e6:.3f} "
                f"MB sent per rank; pooled all-reduces {st['pool_allreduces']}"
                + (f"; step {ms:.1f} ms vs world 1 {step_ms[tag]:.1f} ms"
                   if ms is not None and tag in step_ms else ""))
    h = two[0]["halo"]
    log(f"[sp] NCCL sp=2: {h['exchanges']} halo exchanges of one f32 step "
        f"replayed alone {h['ms']:.2f} ms ({h['bytes_sent_per_rank'] / 1e6:.3f} "
        f"MB per rank); {SP_UCF} BN f32: sp=1 {ucf1['ms']:.1f} ms, "
        f"{ucf1['peak_gib']:.2f} GiB; sp=2 "
        + " / ".join(f"{out['ucf']['ms']:.1f} ms" for out in two) + ", peak "
        + " / ".join(f"{out['ucf']['peak_gib']:.2f} GiB" for out in two)
        + " per rank")


# [elastic]: elastic shrink-and-continue through the train CLI.  On one
# card two gloo ranks on cuda:0 (as [ddp]); with --elastic-nccl four NCCL
# ranks, one per GPU.  Each leg is the CLI in its own process
# (``--ddp-worker`` with an "elastic" spec), never under torchrun: its
# agent would stop the survivors when the leaver exits 143.
ELASTIC_SIZES = ((256, 320), (224, 288))
ELASTIC_TRAIN, ELASTIC_TEST = 24, 4
ELASTIC_BATCH = 2      # per rank: a world of 2 steps 4 images, of 4 steps 8
ELASTIC_KILL_SEED = 5  # the seeded step (1 or 2) of the SIGTERM
ELASTIC_STAGES = ("agreed", "shrink_saved", "shrink_barrier", "reformed",
                  "restored", "first_step")


def elastic_data(work: Path) -> Path:
    from can_tpu_torch.data import make_synthetic_dataset

    root = work / "elastic_synth"
    make_synthetic_dataset(str(root / "train_data"), ELASTIC_TRAIN,
                           sizes=ELASTIC_SIZES, seed=SEED)
    make_synthetic_dataset(str(root / "test_data"), ELASTIC_TEST,
                           sizes=ELASTIC_SIZES, seed=SEED + 1)
    return root


def elastic_argv(root: Path, leg: Path, bf16: bool, sp: int = 1) -> list:
    return (["--data_root", str(root), "--syncBN", "--bn-impl", "kernel",
             "--sp", str(sp),
             "--batch-size", str(ELASTIC_BATCH), "--epochs", "1", "--lr", "1e-6",
             "--seed", str(SEED), "--num-workers", "2", "--prepared-root", "off",
             "--checkpoint-dir", str(leg / "ck"), "--telemetry-dir", str(leg / "tel"),
             "--elastic-dir", str(leg.parent / "sig"), "--elastic-check-every", "1"]
            + (["--bf16"] if bf16 else []))


def elastic_worker(spec: dict) -> int:
    """One rank of an [elastic] leg: the train CLI with its launch counts,
    summary and elastic timeline, and the stamps of its process's start
    (the interpreter, torch, the device query, the imports, the CUDA context);
    exits with the CLI's code (143 for the leaver).  ``gloo``: the rank
    joins a gloo world on cuda:0 first."""
    import torch

    from can_tpu_torch.cli import train as train_cli
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc
    from can_tpu_torch.parallel import init_runtime

    stamps = {"script": T_SCRIPT, "torch": T_TORCH, "device_query": T_AVAIL,
              "imports": time.time()}
    dev = torch.device("cuda", 0 if spec["gloo"] else int(os.environ.get("LOCAL_RANK", 0)))
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    stamps["context"] = time.time()
    if spec["gloo"]:
        init_runtime(device=torch.device("cuda", 0), backend="gloo")
    cb.reset_launches()
    cc.reset_launches()  # the main path starts here
    summary = train_cli.train(train_cli.parse_args(spec["argv"]))
    launches = {"bn": cb.LAUNCHES, "bn_backward": cb.BACKWARD_LAUNCHES,
                "context": cc.LAUNCHES}  # ... and ends here
    out = {k: summary[k] for k in ("steps", "eval_batches", "epochs", "world_size",
                                   "generations", "topology", "timeline", "exit_code")}
    out.update(launches=launches, t_launch=spec["t_launch"], stamps=stamps)
    Path(spec["out"]).write_text(json.dumps(out))
    return summary["exit_code"]


def elastic_cmds(leg: Path, argv: list, world: int, *, gloo: bool,
                 faults=None) -> list:
    """The (argv, env) of ``world`` ranks of the train CLI: gloo on cuda:0,
    or NCCL one rank per GPU (a world of 1: no process group)."""
    leg.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    cmds = []
    for rank in range(world):
        spec = leg / f"spec{rank}.json"
        spec.write_text(json.dumps({"mode": "elastic", "argv": argv, "gloo": gloo,
                                    "out": str(leg / f"rank{rank}.json"),
                                    "t_launch": time.time()}))
        env = dict(os.environ)
        if world > 1:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if faults is not None:
            env["CAN_TPU_FAULTS"] = json.dumps(faults)
        cmds.append(([sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker",
                      str(spec)], env))
    return cmds


def elastic_results(leg: Path, world: int) -> list:
    return [json.loads((leg / f"rank{r}.json").read_text()) for r in range(world)]


def _transitions(tel: Path) -> list:
    return [ev for path in sorted(tel.glob("telemetry.host*.jsonl"))
            for ev in map(json.loads, path.read_text().splitlines())
            if ev.get("kind") == "elastic.transition"]


def _shrink_point_copy(ckpt: Path, dst: Path, manifest: dict) -> None:
    """The checkpoint directory as the shrink left it, before any survivor
    re-formed: the shrink checkpoints, the manifest, the old world's run
    config (tests/test_torch_elastic_chaos.py's rule)."""
    import shutil

    from can_tpu_torch.parallel import elastic as el

    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ckpt / el.ELASTIC_SUBDIR, dst / el.ELASTIC_SUBDIR)
    shutil.copy(ckpt / el.MANIFEST_NAME, dst / el.MANIFEST_NAME)
    cfg = json.loads((ckpt / "run_config.json").read_text())
    cfg["world_size"] = manifest["world_old"]["dp"]
    (dst / "run_config.json").write_text(json.dumps(cfg))


def elastic_shrinks(root: Path, work: Path, cases: list, counts: dict) -> None:
    """Each case (tag, base dir, world, leaver, gloo, bf16, sp): ``world``
    ranks of the train CLI at ``--sp sp``, ``leaver`` SIGTERMed at a seeded
    step (its replica's ``sp`` ranks leave together), then a cold restart
    at ``world - sp`` ranks from the directory as the shrink left it;
    every gate.  The cases' shrinking runs start together, then their cold
    restarts: each leg's processes share the machine with the other cases'."""
    import shutil

    import torch

    from can_tpu_torch.parallel import elastic as el
    from can_tpu_torch.testing.faults import make_kill_schedule

    cmds, want = [], []
    for c in cases:
        sp = c.setdefault("sp", 1)
        shutil.rmtree(c["base"], ignore_errors=True)
        c["faults"] = make_kill_schedule(ELASTIC_KILL_SEED, rank=c["leaver"], max_step=2)
        c["leavers"] = sorted(el.replica_leavers({c["leaver"]}, n_processes=c["world"],
                                                 sp=sp))
        cmds += elastic_cmds(c["base"] / "run", elastic_argv(root, c["base"] / "run",
                                                             c["bf16"], sp),
                             c["world"], gloo=c["gloo"], faults=c["faults"])
        want += [el.LEAVE_EXIT_CODE if r in c["leavers"] else 0 for r in range(c["world"])]
    t0 = time.perf_counter()
    run_ranks(cmds, work, "elastic_run", want=want)
    run_s = time.perf_counter() - t0
    cmds = []
    for c in cases:
        tag, base, world, leaver = c["tag"], c["base"], c["world"], c["leaver"]
        new_world = world - len(c["leavers"])
        c["ranks"] = ranks = elastic_results(base / "run", world)
        c["survivors"] = survivors = [r for r in range(world) if r not in c["leavers"]]
        # the survivors' world: renumbered, each on its own card
        for new, old in enumerate(survivors):
            topo = ranks[old]["topology"]
            want_dev = "cuda:0" if c["gloo"] else f"cuda:{old}"
            if (topo["process_count"], topo["process_index"], topo["device"],
                    ranks[old]["generations"]) != (new_world, new, want_dev, 2):
                fail(f"[elastic] {tag}: survivor {old} re-formed as {topo} "
                     f"(generations {ranks[old]['generations']}), want rank {new} of "
                     f"{new_world} on {want_dev}")
        ck = base / "run" / "ck"
        c["manifest"] = m = el.load_manifest(str(ck))
        # one elastic.transition per surviving process (each writes its own
        # JSONL), none from the leaver, all the same record
        events = _transitions(base / "run" / "tel")
        if (m is None or m["leavers"] != c["leavers"]
                or m["world_new"] != {"processes": new_world, "dp": new_world // c["sp"],
                                      "sp": c["sp"], "devices": new_world}
                or sorted(ev["host_id"] for ev in events) != survivors
                or any(ev["payload"] != events[0]["payload"] for ev in events)):
            fail(f"[elastic] {tag}: manifest {m}, elastic.transition events {events} "
                 f"(want one from each of hosts {survivors})")
        t = events[0]["payload"]
        c["remaining"] = rem = el.remaining_items(m, ELASTIC_TRAIN)
        consumed = set(m["consumed"])
        if (consumed | set(rem) != set(range(ELASTIC_TRAIN)) or consumed & set(rem)
                or not rem or t["remaining_items"] != len(rem)
                or (t["processes_old"], t["processes_new"]) != (world, new_world)
                or m["steps_done"] < c["faults"]["faults"][0]["step"]):
            fail(f"[elastic] {tag}: consumed {sorted(consumed)} and remaining {rem} do "
                 f"not partition the epoch's {ELASTIC_TRAIN} items, or the event {t} "
                 f"is off")
        # the cold restart at world - sp from the directory as the shrink left it
        _shrink_point_copy(ck, base / "snap", m)
        cmds += elastic_cmds(base / "cold", elastic_argv(root, base / "cold", c["bf16"],
                                                         c["sp"])
                             + ["--init_checkpoint", str(base / "snap")], new_world,
                             gloo=c["gloo"] and new_world > 1)
    t0 = time.perf_counter()
    run_ranks(cmds, work, "elastic_cold", want=[0] * len(cmds))
    cold_s = time.perf_counter() - t0
    for c in cases:
        tag, base, world, leaver = c["tag"], c["base"], c["world"], c["leaver"]
        ranks, survivors, m = c["ranks"], c["survivors"], c["manifest"]
        new_world = len(survivors)
        cold = elastic_results(base / "cold", new_world)
        # launches per rank exact: a short count is a plain fallback
        for label, outs in (("run", ranks), ("cold", cold)):
            for r, out in enumerate(outs):
                got = out["launches"]
                want_l = {"bn": BN_LAYERS * out["steps"],
                          "bn_backward": BN_LAYERS * out["steps"],
                          "context": out["steps"] + out["eval_batches"]}
                if got != want_l or not out["steps"]:
                    fail(f"[elastic] {tag} {label} rank {r}: launches {got}, want {want_l}")
                for k in counts:
                    counts[k] += got[k]
        cold_events = _transitions(base / "cold" / "tel")
        if (len(cold_events) != new_world
                or any(ev["payload"]["resumed_from"] != "cold_restart"
                       for ev in cold_events)):
            fail(f"[elastic] {tag}: cold restart recorded {cold_events}")
        # bitwise: every parameter, momentum buffer and running statistic,
        # the step, the epoch's loss, MAE and MSE
        ck, ck_cold = base / "run" / "ck", base / "cold" / "ck"
        # on the CPU: the survivors' checkpoint was written from cuda:1
        # after a rank-0 leaver, the cold restart's from cuda:0
        a, b = _state_tensors(ck, "cpu"), _state_tensors(ck_cold, "cpu")
        bad, worst = snap_diff(a, b)
        sa = torch.load(ck / "0" / "state.pt", weights_only=True, map_location="cpu")
        sb = torch.load(ck_cold / "0" / "state.pt", weights_only=True, map_location="cpu")
        row_a, row_b = ranks[survivors[0]]["epochs"][-1], cold[0]["epochs"][-1]
        same = {k: row_a[k] == row_b[k] for k in ("train_loss", "mae", "mse", "lr")}
        if (bad or a.keys() != b.keys() or sa["step"] != sb["step"]
                or not all(same.values())):
            fail(f"[elastic] {tag}: survivors vs cold restart differ: {len(bad)} "
                 f"tensors (worst {worst:.3e}), step {sa['step']} vs {sb['step']}, "
                 f"{same}")
        tl = ranks[survivors[0]]["timeline"]
        sigterm = ranks[leaver]["timeline"]["sigterm"]
        stages = [sigterm] + [tl[k] for k in ELASTIC_STAGES]
        ctl = cold[0]["timeline"]
        log(f"[elastic] {tag}: {world} ranks (dp {world // c['sp']} x sp {c['sp']}), "
            f"rank {leaver} SIGTERMed at step {c['faults']['faults'][0]['step']}, ranks "
            f"{c['leavers']} exit 143, the agreement at step "
            f"{m['steps_done']}; {len(m['consumed'])} items consumed + "
            f"{len(c['remaining'])} remaining = {ELASTIC_TRAIN}; survivors re-formed at "
            f"world {new_world} (dp {new_world // c['sp']} x sp {c['sp']}, "
            + ("gloo, cuda:0" if c["gloo"] else
               "NCCL, cuda:" + ",".join(str(r) for r in survivors))
            + f"), trained {row_a['steps']} steps and evaluated; one elastic.transition "
            f"per survivor; the cold restart at world {new_world} bitwise equal: "
            f"{len(a)} tensors, step {sa['step']}, loss {row_a['train_loss']!r}, MAE "
            f"{row_a['mae']!r}, MSE {row_a['mse']!r}; launches per rank exact "
            + "; ".join(f"rank {r} {o['launches']}" for r, o in enumerate(ranks)))
        log(f"[elastic] {tag} timeline (s): SIGTERM -> agreement "
            + " -> ".join(f"{b_ - a_:.3f}" for a_, b_ in zip(stages, stages[1:]))
            + " (agreement, shrink checkpoint, barrier, re-formation, restore, first "
            f"step); SIGTERM -> first step {tl['first_step'] - sigterm:.2f} s; the cold "
            f"leg: launch -> first step {ctl['first_step'] - cold[0]['t_launch']:.2f} s "
            f"(launch -> the CLI {ctl['start'] - cold[0]['t_launch']:.2f} s)")
        st = dict(cold[0]["stamps"], launch=cold[0]["t_launch"], **ctl)
        st["cli_imports"] = st.pop("imports")
        st["imports"] = cold[0]["stamps"]["imports"]
        keys = ("launch", "script", "torch", "device_query", "imports", "context", "start",
                "runtime", "cli_imports", "world", "datasets", "memory", "data", "model",
                "kernels", "restored", "first_step")
        names = ("interpreter", "import torch", "device query", "package imports",
                 "CUDA context", "to the CLI", "validation and runtime",
                 "the loop's imports", "mesh", "datasets", "memory agreed",
                 "data planned", "model on the card", "kernel libraries", "restore",
                 "first step")
        log(f"[elastic] {tag} cold leg split (s, rank 0): "
            + ", ".join(f"{n} {st[b] - st[a]:.3f}"
                        for n, a, b in zip(names, keys, keys[1:]))
            + f"; launch -> first step {st['first_step'] - st['launch']:.2f}")
    log(f"[elastic] {', '.join(c['tag'] for c in cases)}: the shrinking runs "
        f"{run_s:.1f} s, the cold restarts {cold_s:.1f} s (each leg's processes at "
        f"once)")


def phase_elastic(work: Path) -> dict:
    """Two gloo ranks on cuda:0, rank 1 SIGTERMed, f32 and bf16 side by
    side: the survivor re-forms at world 1 and matches a cold restart
    bitwise."""
    t_phase = time.perf_counter()
    root = elastic_data(work)
    counts = {"bn": 0, "bn_backward": 0, "context": 0}
    cases = [{"tag": f"2 -> 1 {tag}", "base": work / "elastic" / tag, "world": 2,
              "leaver": 1, "gloo": True, "bf16": tag == "bf16"} for tag in ("f32", "bf16")]
    # sp: four gloo ranks at dp=2 x sp=2; rank 1 leaves and rank 0, its
    # replica's partner, with it; ranks 2 and 3 re-form at (1, 2)
    cases += [{"tag": f"sp (2, 2) -> (1, 2) {tag}", "base": work / "elastic" / f"sp_{tag}",
               "world": 4, "sp": 2, "leaver": 1, "gloo": True, "bf16": tag == "bf16"}
              for tag in ("f32", "bf16")]
    elastic_shrinks(root, work / "elastic", cases, counts)
    log(f"[elastic] launches in this phase: {counts}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def nccl_worker(spec: dict) -> int:
    """One NCCL rank of --elastic-nccl (a): one DDP step per case on its
    slice of the fixed batch, its state, launches and step times."""
    import torch

    from can_tpu_torch.device import use_deterministic, use_full_f32
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.parallel import (
        init_runtime,
        make_dp_train_step,
        make_mesh,
        shutdown_runtime,
    )
    from can_tpu_torch.train import create_train_state, make_lr_schedule

    use_deterministic()
    use_full_f32()
    topo = init_runtime()
    world, rank = topo["process_count"], topo["process_index"]
    batch = ddp_batch(Path(spec["root"]), rank, world)
    out = {"topology": topo, "cases": {}, "step_ms": {}}
    for tag, remat in DDP_CASES:
        loss, sd, launches = ddp_step_state(batch, tag.split()[0], remat, world)
        path = Path(spec["out_dir"]) / f"{tag.replace(' ', '_')}_rank{rank}.pt"
        torch.save(sd, path)
        out["cases"][tag] = {"loss": loss, "state": str(path), "launches": launches}
    for tag in ("f32", "bf16"):
        model = CANNet(device="cuda", seed=SEED, batch_norm=True)
        model = model.to(memory_format=torch.channels_last)
        state = create_train_state(model, make_lr_schedule(1e-6, world_size=world))
        step = make_dp_train_step(model, make_mesh(), bn_ops=bm.make_bn_ops("kernel"),
                                  compute_dtype=torch.bfloat16 if tag == "bf16" else None)
        out["step_ms"][tag] = time_ms(lambda: step(state, batch), reps=DDP_STEP_REPS)
        del model, state, step
    shutdown_runtime()
    (Path(spec["out_dir"]) / f"nccl_rank{rank}.json").write_text(json.dumps(out))
    return 0


def phase_elastic_nccl(work: Path) -> None:
    """``--elastic-nccl``, on a machine with 4 GPUs: (a) DDP with SyncBN
    over NCCL at world 2 and 4, one rank per GPU, against world 1 on
    cuda:0 by [ddp]'s gates, each world run twice; (b) the train CLI's
    elastic shrink from 4 NCCL ranks to 3 with rank 0 (the checkpoint
    writer and coordinator) leaving, bitwise equal to a cold restart at
    world 3 on three cards."""
    import torch

    from can_tpu_torch.device import use_deterministic
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops import bn_moments as bm
    from can_tpu_torch.train import make_train_step

    if torch.cuda.device_count() < 4:
        fail(f"--elastic-nccl needs 4 GPUs, {torch.cuda.device_count()} visible")
    use_deterministic()
    root = train_data(work)
    nccl_dir = work / "ddp_nccl"
    nccl_dir.mkdir(exist_ok=True)
    batch = fixed_batch(root)
    refs = {}
    for tag, remat in DDP_CASES:
        loss, sd, _ = ddp_step_state(batch, tag.split()[0], remat, 1)
        refs[tag] = (loss, sd)
    step_ms = {}
    for tag in ("f32", "bf16"):
        state = _state()
        step = make_train_step(bn_ops=bm.make_bn_ops("kernel"),
                               compute_dtype=torch.bfloat16 if tag == "bf16" else None)
        step_ms[tag] = time_ms(lambda: step(state, batch), reps=DDP_STEP_REPS)
        del state, step
    del batch
    old = {k: v.detach().cpu().clone() for k, v in
           CANNet(device="cpu", seed=SEED, batch_norm=True).state_dict().items()}
    torch.cuda.empty_cache()
    for world in (2, 4):
        runs = []
        for run in ("a", "b"):
            out_dir = nccl_dir / f"world{world}_{run}"
            out_dir.mkdir(exist_ok=True)
            port = _free_port()
            cmds = []
            for rank in range(world):
                spec = out_dir / f"spec{rank}.json"
                spec.write_text(json.dumps({"mode": "nccl", "root": str(root),
                                            "out_dir": str(out_dir)}))
                cmds.append(([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--ddp-worker", str(spec)],
                             dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                                  LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=str(port))))
            t0 = time.perf_counter()
            run_ranks(cmds, nccl_dir, f"world{world}_{run}")
            log(f"[ddp] NCCL world {world}, run {run}: {time.perf_counter() - t0:.1f} s "
                f"for {world} ranks")
            runs.append([json.loads((out_dir / f"nccl_rank{r}.json").read_text())
                         for r in range(world)])
        for r, out in enumerate(runs[0]):
            topo = out["topology"]
            if (topo["backend"], topo["device"], topo["process_count"]) != (
                    "nccl", f"cuda:{r}", world):
                fail(f"[ddp] NCCL world {world} rank {r}: topology {topo}")
        for tag, remat in DDP_CASES:
            want_launch = {"bn": BN_LAYERS * (2 if remat else 1), "bn_backward": BN_LAYERS,
                           "context": 2 if remat else 1}
            states = {}
            for run in range(2):
                for r in range(world):
                    got = runs[run][r]["cases"][tag]["launches"]
                    if got != want_launch:
                        fail(f"[ddp] NCCL world {world} {tag}: run {run} rank {r} "
                             f"launches {got}, want {want_launch}")
                    states[(run, r)] = torch.load(runs[run][r]["cases"][tag]["state"])
            for key in states:
                bad, worst = snap_diff(states[(0, 0)], states[key])
                if bad:
                    fail(f"[ddp] NCCL world {world} {tag}: run/rank {key} differs from "
                         f"run a rank 0 in {len(bad)} tensors (worst {worst:.3e})")
            dt = tag.split()[0]
            loss, (loss1, sd1) = runs[0][0]["cases"][tag]["loss"], refs[tag]
            loss_rel = abs(loss - loss1) / abs(loss1)
            upd = _update_rel(old, states[(0, 0)], sd1)
            log(f"[ddp] NCCL world {world} ({TRAIN_BATCH // world} images per rank, one "
                f"GPU each) against world 1 ({TRAIN_BATCH} images on cuda:0), one {tag} "
                f"step: loss rel {loss_rel:.2e} (tolerance {DDP_LOSS_RTOL[dt]:g}), the "
                f"update of all weights and statistics within {upd:.3e} relative L2 "
                f"(tolerance {DDP_UPDATE_RTOL[dt]:g}); all {world} ranks and a second "
                f"run bitwise equal; launches per rank {want_launch}")
            if loss_rel > DDP_LOSS_RTOL[dt] or not upd <= DDP_UPDATE_RTOL[dt]:
                fail(f"[ddp] NCCL world {world} {tag} is off world 1: loss rel "
                     f"{loss_rel:.2e}, update rel {upd:.3e}")
        for tag in ("f32", "bf16"):
            ms = [out["step_ms"][tag] for out in runs[0]]
            log(f"[ddp] NCCL world {world} {tag} DDP step at {TRAIN_BATCH // world} "
                f"images per rank: " + " / ".join(f"{t:.1f}" for t in ms)
                + f" ms by rank (world 1 at {TRAIN_BATCH} images: {step_ms[tag]:.1f} ms)")
    counts = {"bn": 0, "bn_backward": 0, "context": 0}
    root = elastic_data(work)
    elastic_shrinks(root, work / "elastic_nccl",
                    [{"tag": "NCCL 4 -> 3 f32", "base": work / "elastic_nccl" / "f32",
                      "world": 4, "leaver": 0, "gloo": False, "bf16": False}], counts)
    # (2, 2) -> (1, 2): rank 1 leaves and rank 0 (the writer and coordinator)
    # with it; ranks 2 and 3 re-form on cuda:2,3, the cold world on cuda:0,1
    elastic_shrinks(root, work / "elastic_nccl",
                    [{"tag": "NCCL sp (2, 2) -> (1, 2) f32",
                      "base": work / "elastic_nccl" / "sp_f32", "world": 4, "sp": 2,
                      "leaver": 1, "gloo": False, "bf16": False}], counts)


def main(argv) -> int:
    global T_TORCH, T_AVAIL
    import torch

    T_TORCH = time.time()
    measure_only = argv == ["--measure-only"]
    sp_only = argv == ["--sp-only"]
    sp_nccl = argv == ["--sp-nccl"]
    obs_only = argv == ["--obs-only"]
    elastic_only = argv == ["--elastic-only"]
    elastic_nccl = argv == ["--elastic-nccl"]
    aot_only = argv == ["--aot-only"]
    worker = len(argv) == 2 and argv[0] == "--ddp-worker"
    if argv and not (measure_only or sp_only or sp_nccl or obs_only or elastic_only
                     or elastic_nccl or aot_only or worker):
        fail(f"unknown arguments {argv} (none, --measure-only, --sp-only, "
             f"--sp-nccl, --obs-only, --elastic-only, --elastic-nccl, --aot-only, "
             f"or --ddp-worker SPEC)")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    T_AVAIL = time.time()
    try:
        import can_tpu_torch
    except ImportError as e:
        fail(f"can_tpu_torch is not importable next to {Path(__file__).name} "
             f"({e}); run it from the root of a checkout")
    if Path(can_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"can_tpu_torch resolved to {can_tpu_torch.__file__}, not this "
             f"checkout")
    from can_tpu_torch.models import random_state_dict
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    t_start = time.perf_counter()
    # the train and eval CLIs turn deterministic mode on (device.py), which
    # needs this before the process's first cuBLAS call: PyTorch reads it
    # once, and the phases before the CLIs' use cuBLAS
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    if worker:
        spec = json.loads(Path(argv[1]).read_text())
        if spec["mode"] == "coldserve":
            return coldserve_worker(spec)
        return ddp_worker(Path(argv[1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    log(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    phase_build()
    if sp_only or sp_nccl or elastic_only or elastic_nccl:
        {"--sp-only": phase_sp, "--sp-nccl": phase_sp_nccl,
         "--elastic-only": phase_elastic,
         "--elastic-nccl": phase_elastic_nccl}[argv[0]](work)
        log(f"[smoke] {argv[0]} done in {time.perf_counter() - t_start:.1f}s")
        log(card)
        return 0
    pth = work / "cannet_seed0_he.pth"
    # He-scaled normals: the reference N(0, 0.01) init collapses every gate
    # to 0.5 and every count to ~1e-8, where parity would prove nothing
    torch.save({k: torch.from_numpy(v) for k, v in
                random_state_dict(SEED, he=True).items()}, pth)
    if obs_only or aot_only:
        if obs_only:
            phase_obs(pth, work)
            phase_obs_train(work)
        else:
            phase_aot(pth, work)
        log(f"[smoke] {argv[0]} done in {time.perf_counter() - t_start:.1f}s")
        log(card)
        return 0
    if measure_only:
        rows = {(shape, count, name): bn_time(y, m, g1, g2, peaks, f"{shape} {name}")
                for shape, count, name, y, m, g1, g2 in bn_cases() if count}
        bn_totals(rows)
        batch = fixed_batch(train_data(work))
        for tag in ("f32", "bf16"):
            step_breakdown(batch, tag == "bf16")
        log(f"[smoke] --measure-only done in {time.perf_counter() - t_start:.1f}s")
        log(card)
        return 0
    row = phase_kernels(peaks)
    bn = phase_bn(peaks)
    check_residency(pth)
    cc.reset_launches()  # the serving path starts here
    runs = {dt: serve_one(pth, dt) for dt in SERVE_DTYPES}
    paths8 = {"sched": serve_sched(pth), "sched burst": burst_policies(pth),
              "streams": serve_streams(pth)}
    swap = serve_swap(pth)
    launches = cc.LAUNCHES  # ... and ends here
    want = (sum(r["batches"] for r in runs.values()) + sum(paths8.values())
            + swap["batches"])
    if launches != want:
        fail(f"context_fused launched {launches} times, but the services ran "
             f"{want} batches")
    log(f"[serve] context_fused launches during serving: {launches} "
        f"(= batches run, warmup included: "
        + ", ".join(f"{dt} {r['batches']}" for dt, r in runs.items()) + ", "
        + ", ".join(f"{k} {v}" for k, v in paths8.items())
        + f", swap {swap['batches']})")
    check_swap(swap)
    int8_report(runs)
    for dt, run in runs.items():
        breakdown(run, dt, row["bf16_ms"] if dt == "bf16" else row["ms"])
        check_parity(run, dt)  # ends by releasing the engine's weights
    del runs, swap

    # each phase resets and reads the counts around each path it drives
    paths = {"fleet": phase_fleet(pth, card), "obs": phase_obs(pth, work),
             "aot": phase_aot(pth, work),
             "determinism": phase_determinism(work),
             "train": phase_train(work), "obs_train": phase_obs_train(work),
             "remat": phase_remat(work),
             "s2d": phase_s2d(work), "vgg16": phase_vgg16(work),
             "slice5": phase_slice5(work), "legacy": phase_legacy(work),
             "prepare": phase_prepare(work), "golden": phase_golden(work),
             "ddp": phase_ddp(work), "sp": phase_sp(work),
             "elastic": phase_elastic(work)}
    counts = {k: sum(p[k] for p in paths.values())
              for k in ("bn", "bn_backward", "context")}

    kernels = [{"name": cc.KERNEL, "route": "cuda",
                "source": "can_tpu_torch/csrc/context_fused.cu",
                "replaces": "can_tpu/ops/pallas_context.py:143",
                "launches": launches + counts["context"],
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None, "products_ms": row["products_ms"]},
               {"name": cb.KERNEL, "route": "cuda",
                "source": "can_tpu_torch/csrc/bn_moments.cu",
                "replaces": "can_tpu/ops/pallas_bn.py:104",
                "launches": counts["bn"], **bn["forward"]},
               {"name": cb.BACKWARD_KERNEL, "route": "cuda",
                "source": "can_tpu_torch/csrc/bn_moments.cu",
                "replaces": "can_tpu/ops/pallas_bn.py:143",
                "launches": counts["bn_backward"], **bn["backward"]}]
    log(f"[smoke] done in {time.perf_counter() - t_start:.1f}s; kernels timed "
        f"at context (8, 96, 128, 512) f32 (bf16: {row['bf16_ms']:.3f} ms), "
        f"bn_moments and bn_moments_backward {BN_STEP_SHAPES[0][0]} f32; launches "
        f"by path: context_fused {launches} serving + "
        + ", ".join(f"{p['context']} {k}" for k, p in paths.items())
        + "; bn_moments " + ", ".join(f"{p['bn']} {k}" for k, p in paths.items())
        + "; bn_moments_backward "
        + ", ".join(f"{p['bn_backward']} {k}" for k, p in paths.items()))
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

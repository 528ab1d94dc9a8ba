"""Training CLI, one process per GPU (counterpart of
``can_tpu/cli/train.py``)::

    python -m can_tpu_torch.cli.train --data_root part_A --syncBN \\
        --bn-impl kernel --batch-size 8 --pad-multiple 64 --epochs 500
    torchrun --nproc_per_node=8 -m can_tpu_torch.cli.train \\
        --data_root part_A --syncBN --bn-impl kernel --batch-size 8

Trains CANNet (``--syncBN``: the BatchNorm model, its train-mode moments
through ``--bn-impl``; ``kernel`` is the CUDA kernel of ``ops/cuda_bn.py``)
from a ShanghaiTech-layout dataset, evaluates MAE/MSE every
``--eval-interval`` epochs and writes full-state checkpoints (latest 3
plus the best MAE) to ``--checkpoint-dir``; ``--init_checkpoint`` resumes.

``--platform default`` (or ``gpu``) trains on the CUDA device and exits
non-zero when there is none; ``--platform cpu`` is the explicit CPU run.
On the card training is deterministic (``device.use_deterministic``: the
same seed and data give the same weights bit for bit, so a resume is
exact), and in f32 TF32 is off.  ``--remat auto`` (the default)
recomputes the forward in the backward for launches whose footprint
would not fit the card otherwise.  ``--pad-multiple auto`` (the default, as in the JAX
package) buckets by exact shapes when at most ``--max-buckets`` occur,
else by the planner's ladder; straggler groups launch at their exact
size and the train batcher caps each launch at the card's memory
(``cli/common.py``).  Batches load on ``--num-workers`` threads and are
put on the card ahead at the scheduling core's priced depth
(``sched.prefetch_depth_for``, ``data/prefetch.py``); density maps come from
a prepared store where one validates (``--prepared-root``).

Under a launcher (``torchrun`` / ``torch.distributed.launch --use_env``,
the JAX package's ``COORDINATOR_ADDRESS`` variables, or SLURM's ``srun``:
``parallel/runtime.py``) each process trains on its own GPU
(``cuda:LOCAL_RANK``) over NCCL, or over gloo with ``--platform cpu``:
DDP averages the gradients, ``--batch-size`` is per process (the global
batch is ``batch_size * world``), the lr scales with the world, and with
``--syncBN`` every BN layer takes the global batch's moments (one
all-reduce of its packed sums).  Rank 0 logs, evaluates into the
checkpoint directory and writes checkpoints; every rank restores from
it.  ``--sp K`` splits each image's height over K processes
(``parallel/spatial.py``): the world is dp = processes / K replicas of K
shards, the ranks of a replica load the same images and keep their rows
of them, bucket H is padded to multiples of 8*K and at least 16*K, the
step sums its gradients over the world (no DDP) and the lr scales with
dp.

``--elastic-dir D`` arms elastic shrink-and-continue training
(``parallel/elastic.py``): every ``--elastic-check-every`` steps the ranks
agree on preemption notices (a SIGTERM, a ``leave`` or ``dead`` file in
D); on one, every rank saves the shrink checkpoint under
``<checkpoint-dir>/elastic/``, the leavers exit 143 and the survivors form
a new world, rebuild DDP, the optimizer, the lr schedule and the batcher
for the new dp, restore the shrink checkpoint and train the interrupted
epoch's remaining items (one ``elastic.transition`` event).  A cold
restart with ``--init_checkpoint`` on that directory resumes from the same
manifest by the same code, to the same weights bit for bit.  Under ``--sp
K`` a replica's K ranks leave together (any of them leaving takes the
whole replica, whose partners also exit 143) and the survivors re-form at
dp' = survivors / K with K unchanged, as a JAX host leaves with its sp
group; a cold restart resumes at the same K.  Launch elastic runs one
process per rank with the rendezvous variables set per process, not under
``torchrun`` (its agent stops every worker when the leaver exits
non-zero).

Telemetry (``obs/``) is off unless asked for, with the JAX CLI's flags:
``--telemetry-dir`` writes ``telemetry.host{rank}.jsonl`` (one per
process: ``compile`` with each first call's flops and bytes,
``step_window``, ``stall``, ``memory``, ``perf.summary`` — MFU against the
card's peaks, roofline class, the launch-cost fit — ``epoch``, span
trees, heartbeats), ``--metrics-port`` serves Prometheus ``/metrics``,
``--incident-dir`` / ``--slo-spec`` / ``--collector-push`` as in the
serve CLI.  Any of them turns on the per-step instrumentation (the
steps also return their grad and update norms, for the run-health
detectors); training with it is bitwise the training without.
``--trace-steps A:B --profile-dir D`` writes one ``torch.profiler``
Chrome trace of steps A..B-1 into D; ``--profile-dir`` alone traces the
whole run.  The wiring (``validate_trace_args``,
``validate_incident_args``, ``build_telemetry``) is shared with the eval
and serve CLIs.
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import os
import sys

import numpy as np
import torch

from can_tpu_torch.cli.common import (
    DEFAULT_LAUNCH_COST_MPX,
    agreed_device_memory_bytes,
    build_mesh_and_batch,
    make_cached_sp_eval_step,
    make_cached_sp_train_step,
    make_remat_policy,
    max_launch_pixels,
    parse_launch_cost,
    parse_pad_multiple,
    print_data_line,
    resolve_launch_cost_px,
    resolve_num_workers,
    resolve_sp_padding,
    resolve_split_roots,
    split_prepared_spec,
)
from can_tpu_torch.device import (
    PLATFORMS,
    NoCudaDeviceError,
    use_deterministic,
    use_full_f32,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CANNet training (PyTorch/CUDA)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=1,
                   help="images per process (per GPU) per step; the global "
                        "batch is batch-size x processes")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial (image-height) shards per replica: each "
                        "image's rows split over this many processes "
                        "(processes / sp data-parallel replicas)")
    p.add_argument("--lr", type=float, default=1e-7)
    p.add_argument("--lrf", type=float, default=1.0,
                   help="final lr fraction for a cosine decay (1.0 = constant)")
    p.add_argument("--syncBN", action="store_true",
                   help="train the BatchNorm variant of CANNet, its moments "
                        "those of the global batch across processes")
    p.add_argument("--bn-impl", choices=("twopass", "onepass", "kernel"),
                   default="onepass",
                   help="train-mode BN moments (with --syncBN): 'onepass' "
                        "(default) one read per layer, 'twopass' mean then "
                        "centered variance, 'kernel' the CUDA moment-sums "
                        "kernel (its plain version on the CPU)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 parameters, f32 BN moments)")
    p.add_argument("--u8-input", action="store_true",
                   help="ship uint8 pixels and normalise on the device")
    p.add_argument("--remat", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="recompute the forward segment by segment in the "
                        "backward (torch.utils.checkpoint): the same "
                        "gradients for less activation memory.  'auto' "
                        "(default) turns it on per launch shape where the "
                        "step's footprint without it would exceed 80%% of "
                        "the card's memory (cli/common.py); bare --remat "
                        "forces it on, 'off' disables it and caps launches "
                        "by the footprint without remat")
    p.add_argument("--vgg16-npz", type=str, default="",
                   help="pretrained VGG-16 frontend .npz "
                        "(tools/convert_vgg16.py's layout)")
    p.add_argument("--s2d-stem", action="store_true",
                   help="run the first frontend conv in space-to-depth "
                        "space (the folded kernel of ops/conv.py "
                        "fold_stem_kernel): the plain stem up to summation "
                        "order")
    p.add_argument("--data_root", type=str, default="",
                   help="ShanghaiTech-layout root "
                        "(<root>/<split>_data/{images,ground_truth})")
    p.add_argument("--train-image-root", type=str, default="")
    p.add_argument("--train-gt-root", type=str, default="")
    p.add_argument("--test-image-root", type=str, default="")
    p.add_argument("--test-gt-root", type=str, default="")
    p.add_argument("--checkpoint-dir", type=str, default="./checkpoints")
    p.add_argument("--init_checkpoint", "--init-checkpoint", type=str,
                   default="", help="checkpoint dir to resume from (latest epoch)")
    p.add_argument("--init-torch-pth", type=str, default="",
                   help="warm-start the parameters from a reference-layout "
                        ".pth (strict layout check; optimizer and step fresh)")
    p.add_argument("--allow-config-change", action="store_true",
                   help="permit resuming (--init_checkpoint) with "
                        "schedule-bearing flags (lr/lrf/epochs/batch/seed/"
                        "syncBN/bf16) that differ from the checkpoint's run; "
                        "without it such drift is an error")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pad-multiple", type=parse_pad_multiple, default="auto",
                   help="'auto' (default): exact shapes when at most "
                        "--max-buckets occur, else the planner's bucket "
                        "ladder; 'none'/'exact': exact snapped shapes; or "
                        "an integer multiple of 8")
    p.add_argument("--max-buckets", type=int, default=24,
                   help="budget of distinct (shape x batch size) programs "
                        "for --pad-multiple auto")
    p.add_argument("--no-remnant-batches", action="store_true",
                   help="pad straggler groups to the full batch instead of "
                        "launching them at their exact size")
    p.add_argument("--plan-mode", choices=("cost", "legacy"), default="cost",
                   help="batch-plan search: 'cost' (default) plans bucket "
                        "boundaries, per-cell batch sizes and remnant menus "
                        "under one cost model; 'legacy' is the earlier "
                        "heuristic planner, kept for comparison "
                        "(tools/plan_ablation.py)")
    p.add_argument("--launch-cost-mpx", type=parse_launch_cost,
                   default=DEFAULT_LAUNCH_COST_MPX,
                   help="fixed cost of one step launch in megapixel "
                        "equivalents, for the planner's pixels-against-"
                        "launches trade (default: the card's measured "
                        "launch, cli/common.py); 'auto' measures this host")
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-loading threads (default min(8, CPUs); 0 = "
                        "load in the main thread)")
    p.add_argument("--prepared-root", type=str, default="auto",
                   help="prepared 1/8-density store: 'auto' (default) "
                        "probes each split's <gt_root>/prepared and decodes "
                        "when it is absent or stale; 'off'; or a root of "
                        "per-split stores (<path>/train, <path>/test) that "
                        "must validate")
    p.add_argument("--item-cache-mb", type=float, default=0.0,
                   help="in-memory LRU over decoded items, in MB, shared by "
                        "both splits (0 = off)")
    p.add_argument("--show", action="store_true",
                   help="save a test image's density maps as PNGs under "
                        "<checkpoint-dir>/temp at every eval")
    p.add_argument("--wandb", action="store_true",
                   help="also log to wandb where it is installed")
    p.add_argument("--eval-interval", type=int, default=1,
                   help="evaluate and checkpoint every N epochs (the final "
                        "epoch always evaluates)")
    p.add_argument("--max-steps-per-epoch", type=int, default=0,
                   help="truncate epochs (smoke runs); 0 = full epoch")
    p.add_argument("--elastic-dir", type=str, default="",
                   help="arm elastic shrink-and-continue training "
                        "(parallel/elastic.py): a shared signal directory "
                        "polled for preemption leave/dead files, written by a "
                        "preempted rank's SIGTERM hook or tools/run_monitor.py "
                        "--emit-signal.  On an agreed signal every rank "
                        "checkpoints at a bounded barrier, the leavers exit "
                        "143, the survivors re-form at the shrunk world, the "
                        "planner replans the interrupted epoch's remaining "
                        "items, lr and global batch rescale with dp, and "
                        "training continues (one elastic.transition event).  "
                        "Default off: no hook, no polling")
    p.add_argument("--elastic-check-every", type=int, default=4,
                   help="steps between elastic agreement polls (each is one "
                        "small host allgather at world > 1; every epoch's "
                        "first step polls too)")
    p.add_argument("--platform", type=str, default="default",
                   choices=list(PLATFORMS),
                   help="default/gpu: the CUDA device cuda:LOCAL_RANK, NCCL "
                        "between processes (exit non-zero without it); cpu: "
                        "run on the CPU, gloo between processes")
    add_compile_cache_arg(p)
    add_telemetry_args(p)
    return p.parse_args(argv)


def add_compile_cache_arg(p) -> None:
    """``--compile-cache``, shared by the three CLIs (the JAX CLIs' flag)."""
    p.add_argument("--compile-cache", type=str, default="auto",
                   help="kernel build cache dir ('auto' = <checkout>/build/"
                        "can_tpu_torch or $CAN_TPU_COMPILE_CACHE; 'off' "
                        "builds into a temporary dir of this process): warm "
                        "restarts load the CUDA kernel libraries instead of "
                        "running nvcc (utils/compile_cache.py)")


def apply_compile_cache(args, *, announce: bool = False):
    """Point the kernel build at ``--compile-cache`` before any kernel
    loads; returns the directory in effect, or None (off, or the CPU)."""
    from can_tpu_torch.utils.compile_cache import enable_compilation_cache

    spec = getattr(args, "compile_cache", "auto")
    device = "cpu" if getattr(args, "platform", "default") == "cpu" else None
    try:
        cache_dir = enable_compilation_cache(None if spec == "auto" else spec,
                                             device=device)
    except RuntimeError as e:
        raise SystemExit(f"--compile-cache: {e}") from None
    if announce and cache_dir:
        print(f"[build] kernel build cache at {cache_dir}")
    return cache_dir


def load_kernels(device, *, bn_kernel: bool) -> dict:
    """Load (building where needed) the kernel libraries a run on
    ``device`` launches, before its first step: the context kernel, and
    the BN-moments kernels with ``bn_kernel``.  Nothing on the CPU, where
    the plain versions run.  Returns ``_build.build_info`` of each."""
    if torch.device(device).type != "cuda":
        return {}
    from can_tpu_torch.ops import _build, cuda_bn, cuda_context

    names = [cuda_context.KERNEL] + ([cuda_bn.KERNEL] if bn_kernel else [])
    _build.load_kernel_libraries(names)
    return {n: _build.build_info.get(n, {}) for n in names}


def add_telemetry_args(p) -> None:
    """The nine telemetry flags of the train and eval CLIs, with the JAX
    CLIs' defaults."""
    p.add_argument("--profile-dir", type=str, default="",
                   help="torch.profiler trace output dir (one Chrome trace): "
                        "the --trace-steps window; the train CLI traces the "
                        "whole run when it is given alone")
    p.add_argument("--trace-steps", type=str, default="",
                   help="torch.profiler trace WINDOW by run-local step "
                        "range, START:STOP slice semantics (e.g. 10:13 = "
                        "steps 10..12) into --profile-dir — instead of the "
                        "whole-run trace a bare --profile-dir captures")
    p.add_argument("--telemetry-dir", type=str, default="",
                   help="write structured telemetry JSONL here (one "
                        "telemetry.host{k}.jsonl per process: compile / "
                        "step_window / stall / memory / perf.summary / "
                        "heartbeat / epoch events; summarize with "
                        "tools/telemetry_report.py)")
    p.add_argument("--telemetry-heartbeat-s", type=float, default=60.0,
                   help="heartbeat event interval (with --telemetry-dir): "
                        "a hung run leaves a last-known-good timestamp; "
                        "<= 0 disables the heartbeat thread")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus-text /metrics + /healthz on this "
                        "port (0 = ephemeral): live step/loss/grad-norm and "
                        "MFU gauges, compile/stall/alert counters; also "
                        "enables the run-health detectors (health.alert "
                        "events).  Default off")
    p.add_argument("--metrics-host", type=str, default="127.0.0.1",
                   help="bind address for --metrics-port (0.0.0.0 to let "
                        "a fleet scraper reach every host)")
    p.add_argument("--collector-push", type=str, default="",
                   metavar="URL",
                   help="stream this process's telemetry to a FleetCollector "
                        "(python -m can_tpu_torch.cli.collect) at URL as "
                        "batched JSONL over HTTP POST /ingest; best-effort: "
                        "a dead collector costs dropped batches (counted), "
                        "never the run")
    p.add_argument("--incident-dir", type=str, default="",
                   help="arm the incident layer (obs/incidents.py): a "
                        "flight-recorder ring, and any trigger — NaN/stall "
                        "health alert, unhandled loop exception, "
                        "SIGTERM — dumps a bundle (ring + gauges + cost "
                        "ledger + all-thread stacks + device memory + run "
                        "config) into this directory.  Default off")
    p.add_argument("--slo-spec", type=str, default="",
                   help="JSON SLO spec (see slo_spec.json): objectives "
                        "evaluated live as multi-window burn rates — "
                        "slo.burn events, can_tpu_slo_* gauges on /metrics, "
                        "bundles on fast burn (with --incident-dir).  Grade "
                        "a finished run with tools/slo_report.py")


def validate_trace_args(args):
    """Parse ``--trace-steps`` (SystemExit on malformed specs, BEFORE any
    device work) and require the trace destination; returns the window
    or None."""
    from can_tpu_torch.obs import parse_trace_steps

    try:
        window = parse_trace_steps(getattr(args, "trace_steps", ""))
    except ValueError as e:
        raise SystemExit(str(e))
    if window and not args.profile_dir:
        raise SystemExit("--trace-steps needs --profile-dir (the trace's "
                         "output directory)")
    return window


def wants_instrumentation(args, trace_window) -> bool:
    """The loops are instrumented when ANY consumer exists: a JSONL
    artifact, a trace window, a live /metrics scraper, an incident
    recorder or an SLO engine (the JAX CLIs' rule)."""
    return bool(args.telemetry_dir or trace_window
                or args.metrics_port is not None
                or args.incident_dir or args.slo_spec)


def run_config(args) -> dict:
    """The schedule-bearing flags a resume must not silently change."""
    return {"lr": args.lr, "lrf": args.lrf, "epochs": args.epochs,
            "batch_size": args.batch_size, "seed": args.seed,
            "syncBN": bool(args.syncBN), "bf16": bool(args.bf16)}


def validate(args):
    """Pure argument and file checks, before any device work; returns the
    split roots."""
    from can_tpu_torch.utils.checkpoint import (
        ConfigDriftError,
        check_resume_config,
        has_checkpoint,
        load_run_config,
    )

    if args.eval_interval < 1:
        raise SystemExit("--eval-interval must be >= 1 (the final epoch "
                         "always evaluates)")
    if args.elastic_check_every < 1:
        raise SystemExit("--elastic-check-every must be >= 1")
    if args.batch_size < 1 or args.epochs < 1:
        raise SystemExit("--batch-size and --epochs must be >= 1")
    if args.sp < 1:
        raise SystemExit("--sp must be >= 1")
    if args.s2d_stem and args.sp > 1:
        raise SystemExit("--s2d-stem is dp-path only (the sp step builds its "
                         "own sharded apply)")
    if args.item_cache_mb < 0:
        raise SystemExit("--item-cache-mb must be >= 0")
    roots = (resolve_split_roots("train", args.train_image_root,
                                 args.train_gt_root, args.data_root)
             + resolve_split_roots("test", args.test_image_root,
                                   args.test_gt_root, args.data_root))
    if args.init_torch_pth:
        if args.vgg16_npz:
            raise SystemExit("--init-torch-pth already contains the trained "
                             "frontend; drop --vgg16-npz")
        if args.init_checkpoint:
            raise SystemExit("--init-torch-pth (fresh warm-start) and "
                             "--init_checkpoint (full-state resume) conflict; "
                             "pick one")
        if not os.path.isfile(args.init_torch_pth):
            raise SystemExit(f"no such checkpoint file: {args.init_torch_pth}")
    if args.vgg16_npz and not os.path.isfile(args.vgg16_npz):
        raise SystemExit(f"no such VGG-16 file: {args.vgg16_npz}")
    if args.init_checkpoint:
        from can_tpu_torch.parallel.elastic import load_manifest, manifest_is_live
        from can_tpu_torch.utils.checkpoint import CheckpointManager

        saved = load_run_config(args.init_checkpoint)
        live = load_manifest(args.init_checkpoint)
        # a preemption before the first epoch's save leaves no epoch
        # checkpoint but a manifest and a shrink checkpoint, whose schedule
        # the guard protects as much (world_size is checked after the
        # world exists, with the elastic allowance)
        resumable = has_checkpoint(args.init_checkpoint) or live is not None
        latest = CheckpointManager(args.init_checkpoint).latest_epoch()
        if (manifest_is_live(live, latest) and not args.allow_config_change
                and int(live["world_new"].get("sp", 1)) != args.sp):
            # a transition keeps sp: the manifest explains a new dp, never
            # rows split another way
            raise SystemExit(
                f"config drift: the live elastic manifest in "
                f"{args.init_checkpoint} re-forms at --sp "
                f"{live['world_new'].get('sp', 1)}, not {args.sp}: resume with "
                f"--sp {live['world_new'].get('sp', 1)} (or pass "
                f"--allow-config-change)")
        if saved is not None and resumable:
            saved = {k: v for k, v in saved.items() if k != "world_size"}
            try:
                drifted = check_resume_config(saved, run_config(args),
                                              allow=args.allow_config_change)
            except ConfigDriftError as e:
                raise SystemExit(f"{e}: resume with the flags the checkpoint "
                                 f"was trained with (or pass "
                                 f"--allow-config-change)") from None
            if drifted:
                print(f"[resume] config drift allowed: {', '.join(drifted)}")
    return roots


def validate_incident_args(args) -> None:
    """Pure arg/path validation for the incident/SLO flags — run BEFORE
    any CUDA work or rendezvous (a typo'd spec must cost nothing, the same
    contract as the dataset path checks).  Shared by the CLIs."""
    spec_path = getattr(args, "slo_spec", "")
    if spec_path:
        from can_tpu_torch.obs.slo import load_slo_spec

        try:
            # stash the PARSED spec: build_telemetry runs later, and
            # re-reading the file there would reopen the failure window
            # this validation closes (a spec replaced mid-launch)
            args._slo_spec_parsed = load_slo_spec(spec_path)
        except OSError as e:
            raise SystemExit(f"--slo-spec: cannot read {spec_path}: {e}")
        except ValueError as e:
            raise SystemExit(f"--slo-spec: {e}")
    incident_dir = getattr(args, "incident_dir", "")
    if incident_dir:
        try:
            os.makedirs(incident_dir, exist_ok=True)
        except OSError as e:
            raise SystemExit(f"--incident-dir: cannot create "
                             f"{incident_dir}: {e}")


def ledger_compute(args) -> str:
    """The compute dtype a run's MFU is priced at: ``"bf16"`` under
    ``--bf16`` (train, eval, and the serve CLI's legacy mode) or the serve
    CLI's ``--serve-dtype bf16``; ``"f32"`` otherwise (int8 serving
    computes in f32 on dequantised weights).  On the H100 the two peaks
    differ 15x (989 against 67 TFLOP/s), so a bf16 run priced at f32
    would read an MFU 15x too high."""
    return ("bf16" if getattr(args, "bf16", False)
            or getattr(args, "serve_dtype", "f32") == "bf16" else "f32")


def build_telemetry(args, *, host_id: int, trace_window, device=None,
                    logger=None, install_signals: bool = True):
    """The CLIs' shared wiring: per-host JSONL sink (``--telemetry-dir``),
    MetricLogger adapter, optional step-range trace window
    (``trace_window``: ``validate_trace_args``' result, or None),
    heartbeat thread, and — with ``--metrics-port`` — an in-memory gauge
    sink plus the live Prometheus exporter (obs/exporter.py).
    ``--incident-dir`` adds the flight recorder + IncidentManager (+ the
    SIGTERM/preemption hook, unless ``install_signals=False`` —
    in-process tests must not retarget the interpreter's signal table);
    ``--slo-spec`` adds the SLO burn-rate engine.  Returns ``(telemetry,
    heartbeat_or_None, exporter_or_None)`` — tear the stack down with
    ``obs.shutdown_telemetry``.

    ``--collector-push URL`` adds a best-effort push sink streaming the
    bus to a FleetCollector; ``CAN_TPU_HOST_ID`` overrides the host id on
    every emitted event (several processes on one machine all read rank
    0 — the fleet view needs them distinct).

    The bus carries ``_gauge_sink`` (the autoscaler reads
    ``can_tpu_slo_alerting`` from it), ``incidents``, and — when any
    consumer exists — ``spans`` and ``ledger``: a ``ProgramCostLedger``
    pricing MFU at the run's compute dtype (``ledger_compute``) against
    ``device``'s peaks (default: the device ``--platform`` resolves to; a
    CPU run never touches CUDA).  The serving fleet prices its watchdog
    from it."""
    from can_tpu_torch import obs

    env_hid = os.environ.get("CAN_TPU_HOST_ID", "")
    if env_hid:
        try:
            host_id = int(env_hid)
        except ValueError:
            raise SystemExit(f"CAN_TPU_HOST_ID: not an int: {env_hid!r}")
    extra = [obs.MetricLoggerSink(logger)] if logger is not None else []
    collector_url = getattr(args, "collector_push", "")
    if collector_url:
        extra.append(obs.CollectorPushSink(collector_url))
    exporter = None
    gauges = None
    telemetry_dir = getattr(args, "telemetry_dir", "")
    metrics_port = getattr(args, "metrics_port", None)
    incident_dir = getattr(args, "incident_dir", "")
    slo_spec_path = getattr(args, "slo_spec", "")
    if metrics_port is not None or incident_dir or slo_spec_path:
        # the gauge sink exists for ANY of its three consumers: the
        # scrape endpoint, the bundle's gauges.json snapshot, and the
        # SLO layer's can_tpu_slo_* exports
        gauges = obs.GaugeSink()
        extra.append(gauges)
    if metrics_port is not None:
        # a port that cannot bind raises here: the CLI exits non-zero
        exporter = obs.MetricsExporter(
            gauges, host=getattr(args, "metrics_host", "127.0.0.1"),
            port=metrics_port).start()
        print(f"[metrics] /metrics + /healthz on "
              f"http://{exporter.host}:{exporter.port}")
    recorder = None
    if incident_dir:
        recorder = obs.FlightRecorder()
        extra.append(recorder)
    trace = (obs.StepTraceWindow(args.profile_dir, *trace_window)
             if trace_window else None)
    if telemetry_dir:
        tel = obs.open_host_telemetry(telemetry_dir, host_id=host_id,
                                      extra_sinks=extra, trace=trace)
    else:
        tel = obs.Telemetry(extra, host_id=host_id, trace=trace)
    tel._gauge_sink = gauges
    # the cost ledger and the span tracer are armed when any consumer
    # exists (JSONL artifact, live scraper, trace window, incident
    # recorder, SLO engine); a default run constructs neither, so nothing
    # new touches its hot path.  MFU is priced at the COMPUTE dtype
    if (telemetry_dir or exporter is not None or trace_window
            or incident_dir or slo_spec_path):
        if device is None:
            from can_tpu_torch.device import resolve_device

            device = resolve_device(getattr(args, "platform", "default"))
        tel.ledger = obs.ProgramCostLedger(compute=ledger_compute(args),
                                           device=device)
        tel.spans = obs.SpanTracer(tel)
    run_config = {k: v for k, v in vars(args).items()
                  if isinstance(v, (str, int, float, bool, type(None)))}
    if slo_spec_path:
        # the spec validate_incident_args already parsed; loaded here
        # only for callers that skipped validation
        spec = getattr(args, "_slo_spec_parsed", None)
        if spec is None:
            spec = obs.load_slo_spec(slo_spec_path)
        tel.watchers.append(obs.SloEngine(spec, tel))
    if incident_dir:
        manager = obs.IncidentManager(tel, recorder,
                                      incident_dir=incident_dir,
                                      gauges=gauges,
                                      run_config=run_config,
                                      host_id=host_id)
        tel.watchers.append(manager)
        tel.incidents = manager
        if install_signals:
            # SIGTERM/preemption: dump + flush a bundle, then SystemExit
            # into the CLI's finally -> shutdown_telemetry (same order as
            # a clean exit); None off the main thread
            obs.install_sigterm_handler(manager)
    tel.emit("run", config=run_config)
    # heartbeat whenever an artifact OR a live consumer wants liveness
    hb = (obs.Heartbeat(tel, args.telemetry_heartbeat_s)
          if (telemetry_dir or exporter is not None or incident_dir
              or slo_spec_path) else None)
    return tel, hb, exporter


def train(args) -> dict:
    """The whole run; returns ``{"steps", "schedule_steps" (the planned
    schedule's steps over the epochs run), "eval_batches", "epochs" (one
    dict per epoch), "best_mae", "checkpoint_dir", "world_size",
    "generations", "topology" (the last generation's), "timeline" (wall
    times: ``start``, ``runtime`` (the process group and the build cache
    set); the first generation's ``imports``, ``world`` (the mesh),
    ``datasets``, ``memory`` (the card's memory agreed), ``data``
    (batchers planned), ``model`` (on the card), ``kernels`` (libraries
    loaded); the last generation's ``restored`` and ``first_step``; the
    elastic stages this process saw), "exit_code"}``.
    Raises SystemExit on bad arguments and without the asked-for device.
    Joins the process group a launcher describes (``init_runtime``) and
    leaves it at the end, unless the caller formed it and no elastic
    transition replaced it."""
    import time

    from can_tpu_torch.parallel import (
        generation,
        init_runtime,
        runtime_active,
        shutdown_runtime,
    )

    t_start = time.time()
    roots = validate(args)
    trace_window = validate_trace_args(args)
    validate_incident_args(args)
    owned = not runtime_active()
    try:
        topo = init_runtime(platform=args.platform)
    except NoCudaDeviceError as e:
        raise SystemExit(f"[train] {e}") from None
    from can_tpu_torch.parallel import is_main_process

    apply_compile_cache(args, announce=is_main_process())
    t_runtime = time.time()
    gen0 = generation()
    supervisor = None
    if args.elastic_dir:
        from can_tpu_torch.parallel.elastic import ElasticSupervisor

        # installed before the incident manager's SIGTERM hook (built with
        # the telemetry): the manager dumps its bundle first and chains
        # here, which sets the leaving flag and returns
        supervisor = ElasticSupervisor(args.elastic_dir,
                                       check_every=args.elastic_check_every)
        supervisor.install_signal_hook()
    try:
        return _train(args, roots, topo, trace_window, supervisor,
                      {"start": t_start, "runtime": t_runtime})
    finally:
        if supervisor is not None:
            supervisor.close()
        if owned or generation() != gen0:
            shutdown_runtime()


def _train(args, roots, topo, trace_window, supervisor, stamps: dict) -> dict:
    """The generation loop: each iteration is one runtime generation, built
    at the current world; an agreed elastic shrink ends it, and the
    survivors re-form and loop.  Datasets, the item cache, the logger and
    the telemetry stack are built once and survive a transition; a run
    without ``--elastic-dir`` runs one generation."""
    import gc
    import time

    from can_tpu_torch import obs
    from can_tpu_torch.parallel.mesh import forget_meshes

    ctx = {"datasets": None, "item_cache": None, "launch_cost_px": None,
           "telemetry": None, "heartbeat": None, "exporter": None,
           "logger": None, "pending_manifest": None, "best": None,
           "generations": 0,
           "timeline": dict(stamps)}
    summary = {"steps": 0, "schedule_steps": 0, "eval_batches": 0,
               "epochs": [], "checkpoint_dir": os.path.abspath(args.checkpoint_dir)}
    try:
        while True:
            summary["topology"] = topo
            outcome, detail = _generation(args, roots, topo, trace_window,
                                          supervisor, ctx, summary)
            if outcome != "reform":
                break
            # every object of the dying generation (DDP and its group, the
            # model) is gone with _generation's frame; the mesh cache holds
            # its spatial and data groups
            forget_meshes()
            gc.collect()
            topo = supervisor.reform(detail)
            ctx["pending_manifest"] = detail
    finally:
        if ctx["logger"] is not None:
            ctx["logger"].finish()
        if ctx["telemetry"] is not None:
            # one teardown order for clean exit, abort, leave and SIGTERM
            obs.shutdown_telemetry(ctx["telemetry"], heartbeat=ctx["heartbeat"],
                                   exporter=ctx["exporter"])
    summary["generations"] = ctx["generations"]
    summary["timeline"] = dict(ctx["timeline"], **(supervisor.timeline
                                                   if supervisor else {}))
    summary["best_mae"] = ctx["best"]
    summary["exit_code"] = detail if outcome == "leave" else 0
    if outcome == "done":
        from can_tpu_torch.parallel import is_main_process

        if ctx["item_cache"] is not None and is_main_process():
            print(f"[data] item cache: {ctx['item_cache'].stats()}")
        if is_main_process():
            best = ctx["best"]
            print(f"[done] best MAE {best:.3f}" if best is not None else "[done]")
    return summary


def _generation(args, roots, topo, trace_window, supervisor, ctx, summary):
    """One runtime generation: build the world, resume (from a pending or
    live elastic manifest, else the latest epoch), train.  Returns
    ``("done", None)``, ``("reform", manifest)`` or ``("leave", rc)``."""
    import time

    from can_tpu_torch import obs
    from can_tpu_torch.data import CrowdDataset, ItemCache, ShardedBatcher, StaleStoreError
    from can_tpu_torch.data.prefetch import DevicePut
    from can_tpu_torch.models import CANNet, load_vgg16_frontend
    from can_tpu_torch.ops.bn_moments import make_bn_ops
    from can_tpu_torch.parallel import (
        generation,
        is_main_process,
        make_dp_eval_step,
        make_dp_train_step,
        process_count,
        process_index,
    )
    from can_tpu_torch.parallel import elastic as el
    from can_tpu_torch.parallel.data_parallel import spatial_rows
    from can_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_lr_schedule,
        train_one_epoch,
    )
    from can_tpu_torch.utils.checkpoint import (
        CheckpointIOError,
        CheckpointManager,
        ConfigDriftError,
        check_resume_config,
        has_checkpoint,
        load_run_config,
        save_run_config,
    )
    from can_tpu_torch.utils.logging import MetricLogger
    from can_tpu_torch.utils.profiling import profile_trace

    ctx["timeline"].setdefault("imports", time.time())
    train_img, train_gt, test_img, test_gt = roots
    ctx["generations"] += 1
    first = ctx["generations"] == 1
    device = torch.device(topo["device"])
    main = is_main_process()
    # per-step instrumentation (known before the steps are built: they
    # return their grad and update norms for the health detectors)
    instrument = wants_instrumentation(args, trace_window)
    if device.type == "cuda":
        use_deterministic()
        if not args.bf16:
            use_full_f32()
    compute_dtype = torch.bfloat16 if args.bf16 else None
    try:
        mesh, host_batch, dp = build_mesh_and_batch(args.batch_size, args.sp)
    except ValueError as e:
        raise SystemExit(f"[train] {e}") from None
    ctx["timeline"].setdefault("world", time.time())
    sp = mesh.sp
    shards = dp * sp  # cards per launch
    summary["world_size"] = dp
    pad_multiple, min_pad, min_bucket_h = resolve_sp_padding(args.pad_multiple, sp)
    if main:
        if first:
            print(f"[start] {datetime.datetime.now():%Y-%m-%d %H:%M:%S} on {device}"
                  + (f" ({torch.cuda.get_device_name(device)})"
                     if device.type == "cuda" else ""))
        if topo["backend"] is not None or not first:
            print(f"[runtime] {topo}")

    if ctx["datasets"] is None:
        # host-side decode, independent of the world: built once
        item_cache = (ItemCache(int(args.item_cache_mb * 1e6))
                      if args.item_cache_mb > 0 else None)
        try:
            ctx["datasets"] = [
                CrowdDataset(img, gt, phase=split, u8_output=args.u8_input,
                             prepared=split_prepared_spec(args.prepared_root, split),
                             item_cache=item_cache)
                for split, img, gt in (("train", train_img, train_gt),
                                       ("test", test_img, test_gt))]
        except StaleStoreError as e:
            raise SystemExit(f"--prepared-root {args.prepared_root}: {e}") from None
        ctx["item_cache"] = item_cache
        if main:
            print("[data] prepared store: " + " ".join(
                f"{split}={'on' if d.prepared_note['active'] else 'off (' + str(d.prepared_note['reason']) + ')'}"
                for split, d in zip(("train", "test"), ctx["datasets"])))
    ctx["timeline"].setdefault("datasets", time.time())
    train_ds, test_ds = ctx["datasets"]
    item_cache = ctx["item_cache"]
    num_workers = resolve_num_workers(args.num_workers)
    if sp > 1 and main and pad_multiple != "auto":
        print(f"[data] sp={sp}: padding H,W to multiples of {pad_multiple}")
    if ctx["launch_cost_px"] is None:
        ctx["launch_cost_px"] = resolve_launch_cost_px(args.launch_cost_mpx,
                                                       device, announce=main)
    # every launch splits evenly across the dp replicas, each replica's
    # ranks loading the same slice (the replica index d of dp); every
    # input of the plan below is agreed across processes.  The quantum is
    # this generation's: after a shrink the planner replans under the new
    common = dict(seed=args.seed, pad_multiple=pad_multiple,
                  min_pad_multiple=min_pad, min_bucket_h=min_bucket_h,
                  max_buckets=args.max_buckets, num_workers=num_workers,
                  plan_mode=args.plan_mode,
                  process_index=mesh.d, process_count=dp,
                  batch_quantum=dp,
                  remnant_sizes=not args.no_remnant_batches,
                  launch_cost_px=ctx["launch_cost_px"])
    # the memory cap per launch: cells whose full batch would not fit the
    # card run at smaller menu sizes (remnant mode only, as in JAX); it
    # counts on remat, which the policy turns on where it is needed,
    # unless --remat off.  A launch is split across the dp x sp cards.
    hbm = agreed_device_memory_bytes(device)
    ctx["timeline"].setdefault("memory", time.time())
    cap = (None if args.no_remnant_batches
           else max_launch_pixels(bf16=args.bf16, hbm_bytes=hbm,
                                  batch_norm=args.syncBN,
                                  remat=args.remat != "off", shards=shards))
    remat_policy = make_remat_policy(args.remat, global_batch=host_batch * dp,
                                     bf16=args.bf16, hbm_bytes=hbm,
                                     batch_norm=args.syncBN, announce=main and first,
                                     shards=shards)
    train_batcher = ShardedBatcher(train_ds, host_batch, shuffle=True,
                                   max_launch_px=cap, **common)
    test_batcher = ShardedBatcher(test_ds, host_batch, shuffle=False,
                                  **common)
    if main:
        print(f"[data] train={len(train_ds)} test={len(test_ds)} "
              f"batch={host_batch} per process x dp={dp}"
              + (f" x sp={sp} (rows split)" if sp > 1 else "") + " "
              f"workers={num_workers} launch cap "
              + (f"{cap / 1e6:.1f} Mpx" if cap is not None else "none"))
        print_data_line("train", train_batcher, remat_policy)
        print_data_line("test", test_batcher)
    ctx["timeline"].setdefault("data", time.time())

    # the same seed gives the same weights on every process
    model = CANNet(device=device, seed=args.seed, batch_norm=args.syncBN,
                   s2d_stem=args.s2d_stem)
    if args.vgg16_npz:
        load_vgg16_frontend(model, args.vgg16_npz)
        if main and first:
            print(f"[init] loaded the pretrained VGG-16 frontend from "
                  f"{args.vgg16_npz}")
    if args.init_torch_pth:
        from can_tpu_torch.utils.torch_import import (
            is_batch_norm_layout,
            load_torch_checkpoint,
        )

        sd = load_torch_checkpoint(args.init_torch_pth)
        if is_batch_norm_layout(sd) != args.syncBN:
            raise SystemExit(
                f"--init-torch-pth {args.init_torch_pth} holds the "
                f"{'BN' if is_batch_norm_layout(sd) else 'plain'} model; "
                f"{'drop' if args.syncBN else 'add'} --syncBN")
        model.load_state_dict(sd, strict=True)
        if main and first:
            print(f"[init] warm-started parameters from {args.init_torch_pth}")
    model = model.to(memory_format=torch.channels_last)
    ctx["timeline"].setdefault("model", time.time())
    built = load_kernels(device, bn_kernel=args.syncBN and args.bn_impl == "kernel")
    if built and first and main:
        print("[build] kernels: " + ", ".join(
            f"{n} {b['source']} in {b['seconds']:.2f} s" for n, b in built.items()))
    ctx["timeline"].setdefault("kernels", time.time())
    bn_ops = make_bn_ops(args.bn_impl) if args.syncBN else None
    if args.syncBN and main:
        print(f"[model] BatchNorm variant, moments: {args.bn_impl}"
              + (f", synced across {shards} processes" if shards > 1 else ""))

    steps_per_epoch = train_batcher.batches_per_epoch(0)
    # linear lr scaling with the world: DDP averages the gradients.  After
    # a shrink this is the schedule at dp': the elastic lr rescaling
    schedule = make_lr_schedule(args.lr, world_size=dp,
                                total_steps=args.epochs * steps_per_epoch,
                                lrf=args.lrf)
    state = create_train_state(model, schedule)
    ckpt = CheckpointManager(args.checkpoint_dir)

    # -- resume: the shrink this process just took part in, else (first
    # generation only) a live manifest in --init_checkpoint, else the
    # latest epoch
    manifest = manifest_dir = resumed_from = None
    start_epoch, best, include = 0, ctx["best"], None
    if ctx["pending_manifest"] is not None:
        manifest, ctx["pending_manifest"] = ctx["pending_manifest"], None
        manifest_dir, resumed_from = args.checkpoint_dir, "in_process"
    elif first and args.init_checkpoint:
        probe = CheckpointManager(args.init_checkpoint)
        latest = probe.latest_epoch()
        live = el.load_manifest(args.init_checkpoint)
        saved = load_run_config(args.init_checkpoint)
        if el.manifest_is_live(live, latest):
            manifest, manifest_dir = live, args.init_checkpoint
            resumed_from, best = "cold_restart", probe.best_metric()
            if saved is not None and "world_size" in saved:
                # the live manifest permits a world-only change
                drifted = check_resume_config(
                    {"world_size": saved["world_size"]}, {"world_size": dp},
                    allow=args.allow_config_change, allow_elastic=True)
                if drifted and main:
                    print(f"[elastic] world drift permitted by the live "
                          f"transition manifest: world_size "
                          f"{saved['world_size']} -> {dp}")
        else:
            # a world size other than the checkpoint's changes the schedule
            if (saved is not None and "world_size" in saved
                    and has_checkpoint(args.init_checkpoint)):
                try:
                    check_resume_config({"world_size": saved["world_size"]},
                                        {"world_size": dp},
                                        allow=args.allow_config_change)
                except ConfigDriftError as e:
                    raise SystemExit(f"{e}: the checkpoint trained at another "
                                     f"world size and no live elastic manifest "
                                     f"explains it (pass --allow-config-change "
                                     f"to resume on this one)") from None
            if latest is None:
                if main:
                    print(f"[resume] no checkpoint in {args.init_checkpoint}; "
                          f"cold start")
            else:
                probe.restore(state, epoch=latest)
                start_epoch, best = latest + 1, probe.best_metric()
                if main:
                    print(f"[resume] epoch {latest} from {args.init_checkpoint} "
                          f"(step {state.step}, best MAE {best:.3f})")
    if manifest is not None:
        # the survivor and a cold restart alike: the exact mid-epoch state
        # from the shrink checkpoint (never the survivor's live tensors),
        # and the interrupted epoch's remaining items replanned at this
        # world's quantum
        CheckpointManager(os.path.join(manifest_dir, el.ELASTIC_SUBDIR)).restore(
            state, epoch=int(manifest["transition_id"]))
        ctx["timeline"]["restored"] = time.time()
        start_epoch = int(manifest["epoch"])
        remaining = el.remaining_items(manifest, len(train_ds))
        include = set(remaining) if remaining else None
        if not remaining:
            start_epoch += 1  # interrupted exactly at the epoch's end
        if supervisor is not None:
            # the transition's rank map and handled leavers: a stale
            # signal file cannot trigger the shrink this manifest records
            supervisor.adopt_manifest(manifest)
        if main:
            old = manifest["world_old"]
            print(f"[elastic] resuming generation {manifest['generation']} "
                  f"transition: epoch {manifest['epoch']} step "
                  f"{manifest['steps_done']}, world {old['processes']}proc/"
                  f"dp{old['dp']} -> {process_count()}proc/dp{dp}"
                  + (f" (sp {sp})" if sp > 1 else "")
                  + f", {len(remaining)} item(s) remaining ({resumed_from})")
    # after the resume check: an in-place resume reads the saved world first
    save_run_config(args.checkpoint_dir, dict(run_config(args), world_size=dp))

    if sp > 1:
        train_step = make_cached_sp_train_step(model, mesh, policy=remat_policy,
                                               compute_dtype=compute_dtype,
                                               bn_ops=bn_ops,
                                               health_metrics=instrument)
        eval_step = make_cached_sp_eval_step(mesh, compute_dtype=compute_dtype)
    else:
        train_step = make_dp_train_step(model, mesh, policy=remat_policy,
                                        compute_dtype=compute_dtype, bn_ops=bn_ops,
                                        health_metrics=instrument)
        eval_step = make_dp_eval_step(mesh, compute_dtype=compute_dtype)
    put = DevicePut(device)
    # under sp each rank keeps its rows of the replica's batch on the host
    put_fn = put if sp == 1 else (lambda b: put(spatial_rows(b, mesh)))
    # priced prefetch depth (the scheduling core's): a pure function of
    # each batcher's epoch-invariant schedule
    prefetch = put.depth_for(train_batcher)
    eval_prefetch = put.depth_for(test_batcher)
    if first:
        ctx["logger"] = MetricLogger(
            use_wandb=args.wandb, enabled=main, run_id_file=os.path.join(
                args.checkpoint_dir, "wandb_run_id.txt"))
        # the bus (one JSONL per process) and, when a consumer exists, the
        # instrumented loops; built once, it outlives transitions
        ctx["telemetry"], ctx["heartbeat"], ctx["exporter"] = build_telemetry(
            args, host_id=process_index(), trace_window=trace_window,
            device=device)
        if supervisor is not None:
            supervisor.telemetry = ctx["telemetry"]
        for split, d in zip(("train", "test"), (train_ds, test_ds)):
            ctx["telemetry"].emit("data.prepared", split=split, **d.prepared_note)
    logger = ctx["logger"]
    # a transition may have made another process the main one
    logger.enabled = main
    telemetry = ctx["telemetry"]
    if telemetry.ledger is not None:
        # the drift gauge prices against the launch cost this run's plans used
        telemetry.ledger.plan_launch_cost_px = common["launch_cost_px"]
    if manifest is not None:
        # the transition record, once per transition (survivor or cold
        # restart), through the supervisor when armed
        topo_now = {"generation": generation(), "process_count": process_count()}
        emit = (supervisor.emit_transition if supervisor is not None
                else lambda m, t, **kw: el.emit_transition(telemetry, m, t, **kw))
        emit(manifest, topo_now, new_dp=dp,
             remaining=0 if include is None else len(include),
             global_batch_new=host_batch * dp, resumed_from=resumed_from)
    loop_tel = telemetry if instrument else None
    health = obs.HealthMonitor(telemetry) if loop_tel is not None else None
    try:
        with profile_trace(None if trace_window else (args.profile_dir or None)):
            for epoch in range(start_epoch, args.epochs):
                inc = include if epoch == start_epoch else None
                batches = train_batcher.epoch(epoch, inc)
                summary["schedule_steps"] += len(train_batcher.global_schedule(epoch, inc))
                if args.max_steps_per_epoch:
                    batches = itertools.islice(batches, args.max_steps_per_epoch)
                lr = state.lr()
                on_step = (supervisor.step_hook(epoch) if supervisor is not None
                           else None)
                if epoch == start_epoch:
                    on_step = _stamp_first_step(on_step, ctx["timeline"], device)
                try:
                    state, stats = train_one_epoch(train_step, state, batches,
                                                   put_fn=put_fn, epoch=epoch,
                                                   prefetch=prefetch,
                                                   telemetry=loop_tel, health=health,
                                                   on_step=on_step)
                except el.ElasticInterrupt as interrupt:
                    summary["steps"] += interrupt.steps_done
                    # coverage of an earlier transition counts only while
                    # training that transition's remainder
                    prior = (manifest.get("consumed", ())
                             if manifest is not None and inc is not None else ())
                    new_manifest = supervisor.shrink(
                        interrupt, state=interrupt.state, epoch=epoch,
                        checkpoint_dir=args.checkpoint_dir,
                        schedule=train_batcher.global_schedule(epoch, inc),
                        dp=dp, sp=sp, batch_size=host_batch,
                        prior_consumed=prior)
                    ctx["best"] = best
                    if process_index() in new_manifest["leavers"]:
                        if main:
                            print("[elastic] leaving after the shrink "
                                  "checkpoint (preempted)")
                        return "leave", supervisor.leave()
                    return "reform", new_manifest
                row = {"epoch": epoch, "train_loss": stats.loss, "lr": lr,
                       "img_per_s": stats.img_per_s, "epoch_s": stats.seconds,
                       "steps": stats.steps,
                       "distinct_shapes": stats.distinct_shapes}
                summary["steps"] += stats.steps
                eval_epoch = ((epoch + 1) % args.eval_interval == 0
                              or epoch == args.epochs - 1)
                if eval_epoch:
                    metrics = evaluate(eval_step, state.model,
                                       test_batcher.epoch(0), put_fn=put_fn,
                                       prefetch=eval_prefetch,
                                       dataset_size=test_batcher.dataset_size,
                                       telemetry=loop_tel)
                    summary["eval_batches"] += metrics["batches"]
                    row.update(mae=metrics["mae"], mse=metrics["mse"])
                # the JAX CLI's epoch event: the row's scalars, the epoch
                # as the event's step
                telemetry.emit("epoch", step=epoch, **{
                    k: v for k, v in row.items() if k not in ("epoch", "steps")})
                telemetry.emit("data.planner", step=epoch,
                               realized_programs=stats.programs,
                               **train_batcher.planner_stats(epoch))
                if item_cache is not None:
                    telemetry.emit("data.cache", step=epoch, **item_cache.stats())
                if eval_epoch:
                    ckpt.save(epoch, state, mae=metrics["mae"],
                              extra={"mse": metrics["mse"]})
                    if best is None or metrics["mae"] < best:
                        best = metrics["mae"]
                        if main:
                            print(f"[best] epoch {epoch}: MAE {best:.3f}")
                    if args.show and main:
                        _save_sample_viz(args, state.model, test_ds, epoch,
                                         logger, compute_dtype)
                logger.log(row, step=epoch)
                summary["epochs"].append(row)
    except CheckpointIOError as e:
        if telemetry.incidents is not None:
            # the typed give-up after exhausted retries: one bundle
            telemetry.incidents.on_exception(e, phase="checkpoint")
        raise
    finally:
        train_batcher.close()
        test_batcher.close()
    ctx["best"] = best
    return "done", None


def _stamp_first_step(on_step, timeline: dict, device):
    """``on_step`` that also records, once the card has finished it, the
    wall time of a generation's first step (``timeline["first_step"]``)."""
    import time

    def hook(step: int) -> None:
        if step == 1:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timeline["first_step"] = time.time()
        if on_step is not None:
            on_step(step)

    return hook


def _save_sample_viz(args, model, test_ds, epoch, logger, compute_dtype) -> None:
    """One seeded test image's ground-truth and estimated density maps as
    PNGs under ``<checkpoint-dir>/temp``, handed to the logger."""
    from can_tpu_torch.data import normalize_host
    from can_tpu_torch.utils.viz import save_density_visualization

    idx = int(np.random.default_rng((args.seed, epoch)).integers(len(test_ds)))
    img, gt = test_ds[idx]
    img = normalize_host(img)  # no-op for the f32 path
    device = next(model.parameters()).device
    with torch.inference_mode():
        et = model(torch.from_numpy(np.ascontiguousarray(img))[None].to(device),
                   compute_dtype=compute_dtype)
    paths = save_density_visualization(
        img, gt, et[0].float().cpu().numpy(),
        os.path.join(args.checkpoint_dir, "temp"), tag=f"epoch{epoch}")
    logger.log_images(paths, caption=f"epoch {epoch}", step=epoch)


def main(argv=None) -> int:
    from can_tpu_torch.train import NonFiniteLossError
    from can_tpu_torch.utils.checkpoint import CheckpointIOError

    args = parse_args(argv)
    try:
        summary = train(args)
    except (NonFiniteLossError, CheckpointIOError) as e:
        print(f"[abort] {e}", file=sys.stderr)
        return 1
    return summary["exit_code"]  # 143: an elastic leaver's clean exit


if __name__ == "__main__":
    raise SystemExit(main())

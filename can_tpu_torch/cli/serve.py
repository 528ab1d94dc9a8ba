"""Online serving CLI: load CANNet weights, warm up the bucket ladder,
answer count/density requests over HTTP on the card.

Counterpart of ``can_tpu/cli/serve.py``::

    python -m can_tpu_torch.cli.serve --torch-pth epoch_354.pth \\
        --bucket-shapes 384x512,512x768,768x1024 --max-batch 8 --port 8000
    python -m can_tpu_torch.cli.serve --checkpoint-dir ./checkpoints --syncBN
    python -m can_tpu_torch.cli.serve --checkpoint-dir ./checkpoints \\
        --replicas 4 --autoscale-max 8     # the fleet: one replica per GPU

    curl -X POST --data-binary @img.npy \\
        'http://127.0.0.1:8000/predict?deadline_ms=200'

The weights load as the eval CLI loads them (``cli/test.py``'s
``validate_params_source`` and ``load_params``): the train CLI's
checkpoint directory (best MAE, else the latest, or ``--epoch``; the BN
model with its running statistics under ``--syncBN``), a reference
``.pth`` or a ``save_params_npz`` ``.npz``.  ``--platform default`` (or
``gpu``) runs on the CUDA device and exits non-zero when there is none;
``--platform cpu`` is the explicit CPU run.

At its defaults the service runs the scheduling core's priced sub-batch
menu (``--menu-budget 3``) and priced flush (``--flush-policy priced``);
``--menu-budget 1 --flush-policy timer`` is the service without it.
Clients opt into per-camera stream sessions with
``?stream_id=cam1&frame_seq=17`` (``serve/streams.py``).

``--replicas N`` (N >= 2) serves through a ``FleetEngine``
(``serve/fleet.py``): one replica per visible GPU (``--platform cpu``:
the one CPU, so N >= 2 is refused there), work stealing, quarantine and
self-healing, blue/green ``POST /rollout``, and with ``--autoscale-max``
the autoscaler (``serve/autoscale.py``).  Every flag is validated before
the weights load, in the JAX CLI's order and with its messages.

Cold start (fleet mode, as in the JAX CLI): ``--aot-bake D`` writes an AOT
bundle after warmup (``serve/aot.py``: the serving kernel library built
for this card and the signature table of every device of the autoscale
range) and keeps serving from it; ``--aot-bundle D`` on the next start
loads it — the kernel library from the bundle, no ``nvcc``, every warmup
launch an AOT hit — and a stale bundle exits ``--aot-bundle refused:
<axis>``.  ``--compile-cache`` (default ``auto``: ``<checkout>/build/
can_tpu_torch``) is the kernel build directory (``utils/compile_cache.py``),
set before any kernel loads; ``off`` builds in a temporary directory.

Telemetry (``obs/``) is off unless asked for: ``--telemetry-dir`` writes
``telemetry.host{k}.jsonl`` (``serve.*`` events, request span trees,
heartbeats), ``--metrics-port`` serves Prometheus ``/metrics`` with the
service's ``/stats`` counters, ``--incident-dir`` dumps a bundle on a
replica quarantine, a fast SLO burn or SIGTERM, ``--slo-spec`` grades
the traffic live (the autoscaler reads its burn gauges), and
``--collector-push`` streams the bus to ``python -m
can_tpu_torch.cli.collect``.  Any of them arms the cost ledger: the
JSONL gains ``perf.summary`` lines (``serve_predict`` rows: each warmed
program's flops, bytes and roofline class, MFU once traffic times it),
``/metrics`` the ``can_tpu_mfu_*`` / ``can_tpu_roofline_*`` gauges, and
the fleet's watchdog its priced deadline.
"""

from __future__ import annotations

import argparse
import re
from typing import List, Tuple

import numpy as np

from can_tpu_torch.cli.train import add_compile_cache_arg
from can_tpu_torch.device import PLATFORMS, NoCudaDeviceError, resolve_device
from can_tpu_torch.serve.quant import SERVE_DTYPES


def parse_bucket_shapes(spec: str) -> List[Tuple[int, int]]:
    """'384x512,512x768' -> [(384, 512), (512, 768)] (validated /8)."""
    shapes = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(\d+)x(\d+)", part)
        if not m:
            raise argparse.ArgumentTypeError(
                f"bad bucket shape {part!r} (want HxW, e.g. 384x512)")
        h, w = int(m.group(1)), int(m.group(2))
        if h % 8 or w % 8:
            raise argparse.ArgumentTypeError(
                f"bucket shape {h}x{w} must be multiples of 8 (the "
                f"density grid)")
        shapes.append((h, w))
    if not shapes:
        raise argparse.ArgumentTypeError("no bucket shapes given")
    return sorted(set(shapes))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CANNet online serving (PyTorch/CUDA)")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="the train CLI's checkpoint dir (default "
                        "./checkpoints)")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch (default: best by MAE, else latest)")
    p.add_argument("--torch-pth", type=str, default="",
                   help="serve a reference-layout torch checkpoint")
    p.add_argument("--params-npz", type=str, default="",
                   help="serve a can_tpu save_params_npz .npz")
    p.add_argument("--syncBN", action="store_true",
                   help="the checkpoint is the BatchNorm model (served with "
                        "its running statistics)")
    p.add_argument("--seed", type=int, default=0,
                   help="the JAX CLI's flag; no weights are drawn here")
    p.add_argument("--bucket-shapes", type=parse_bucket_shapes,
                   default=parse_bucket_shapes("384x512,512x768,768x1024"),
                   help="comma-separated HxW bucket ladder; requests snap UP "
                        "per axis to the smallest covering bound, and every "
                        "(H bound, W bound) pair is warmed at startup")
    p.add_argument("--max-batch", type=int, default=8,
                   help="the largest launch (the top of the sub-batch menu)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="latency CAP on batching: the priced flush deadline "
                        "never waits past this; with --flush-policy timer it "
                        "is the fixed flush deadline itself")
    p.add_argument("--menu-budget", type=int, default=None,
                   help="launch sizes per (bucket, dtype) in the priced "
                        "sub-batch menu (sched.select_menu; default 3): a "
                        "2-request flush launches a 2-slot batch instead of "
                        "padding to --max-batch; every menu size is warmed. "
                        "1 = the single max-batch size")
    p.add_argument("--flush-policy", type=str, default="priced",
                   choices=["priced", "timer"],
                   help="priced: a group flushes the moment waiting longer "
                        "cannot beat launch-cost amortisation given its "
                        "arrival rate and deadline slack; timer: the fixed "
                        "--max-wait-ms deadline")
    p.add_argument("--dispatch-order", type=str, default="priced",
                   choices=["priced", "fifo"],
                   help="fleet work-queue order: priced = cheapest-"
                        "feasible-first under deadline pressure with a "
                        "starvation age bound (sched.pick_work); fifo = "
                        "pure FIFO")
    p.add_argument("--queue-capacity", type=int, default=64,
                   help="hard bound on queued requests (beyond: queue_full)")
    p.add_argument("--high-water", type=int, default=None,
                   help="outstanding requests that start load shedding "
                        "(backpressure until half-drained); default 3/4 "
                        "of --queue-capacity")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline (expired requests are "
                        "rejected, never dispatched)")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve-engine replicas, one per visible GPU (>= 2 "
                        "builds the FleetEngine: work-stealing dispatch, "
                        "quarantine and self-healing, blue/green /rollout; "
                        "1 keeps the single-engine service)")
    p.add_argument("--serve-dtype", type=str, default="f32",
                   choices=list(SERVE_DTYPES),
                   help="f32 = full f32 (TF32 off); bf16 = bf16 weights and "
                        "compute with f32 accumulation; int8 = weight-only "
                        "post-training quantisation (per-output-channel "
                        "scales, int8 resident on the card, dequantised to "
                        "f32 per launch, f32 compute)")
    p.add_argument("--bf16", action="store_true",
                   help="LEGACY bf16 compute with f32 weights; superseded "
                        "by --serve-dtype bf16, conflict if both given")
    p.add_argument("--aot-bundle", type=str, default="",
                   help="load an AOT bundle dir (serve/aot.py): the kernel "
                        "library comes from it (no nvcc) and warmup, "
                        "resurrection and scale-up launches are AOT hits "
                        "(no first-seen signature); a stale bundle (weights/"
                        "dtype/grid/torch/CUDA/card/kernel-source mismatch) "
                        "is refused with the axis named")
    p.add_argument("--aot-bake", type=str, default="",
                   help="after warmup, write the AOT bundle for EVERY device "
                        "of the scale universe into this dir (beside the "
                        "checkpoint is the convention) and keep serving "
                        "from it: the artifact --aot-bundle loads on the "
                        "next start")
    p.add_argument("--autoscale-max", type=int, default=0,
                   help="fleet only: the autoscaler's replica ceiling "
                        "(> --replicas; 0 = off)")
    p.add_argument("--autoscale-min", type=int, default=None,
                   help="fleet only: autoscaler floor (default: --replicas)")
    p.add_argument("--autoscale-interval-s", type=float, default=1.0,
                   help="fleet only: autoscaler evaluation period")
    p.add_argument("--probe-cooldown-s", type=float, default=5.0,
                   help="fleet only: probation cooldown before a "
                        "quarantined replica's first health probe")
    p.add_argument("--watchdog-slack", type=float, default=10.0,
                   help="fleet only: hang-watchdog deadline = expected "
                        "execute time x this slack")
    p.add_argument("--watchdog-default-s", type=float, default=30.0,
                   help="fleet only: hang-watchdog deadline before any "
                        "timing exists")
    p.add_argument("--stream-ttl-s", type=float, default=300.0,
                   help="evict a stream session idle this long (host-side "
                        "state: count/density EWMA, frame sequence; clients "
                        "opt in per request with ?stream_id=...&frame_seq=N)")
    p.add_argument("--degrade-policy", type=str, default="priced",
                   choices=["priced", "off"],
                   help="priced: the per-stream degradation ladder — full "
                        "inference -> frame-skip (answer from the session "
                        "EWMA, labelled degraded + staleness, no launch) -> "
                        "reject, driven by arrival rate against the sched "
                        "core's priced drain cost with hysteresis; off: "
                        "sessions and sequence hygiene only, never skip")
    p.add_argument("--u8-warmup", action="store_true",
                   help="also warm uint8-input batches, for clients POSTing "
                        "?raw=1 (bytes on the wire, normalised on the device)")
    p.add_argument("--max-body-mb", type=float, default=64.0,
                   help="HTTP 413 any POST body over this many MiB")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--platform", type=str, default="default",
                   choices=list(PLATFORMS),
                   help="default/gpu: the CUDA device (exit non-zero without "
                        "one); cpu: run on the CPU")
    add_compile_cache_arg(p)
    p.add_argument("--telemetry-dir", type=str, default="",
                   help="write serve.request/serve.batch/serve.reject "
                        "JSONL here (tools/telemetry_report.py summarises)")
    p.add_argument("--telemetry-heartbeat-s", type=float, default=60.0)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus-text /metrics + /healthz on this "
                        "port (0 = ephemeral): the service's /stats "
                        "counters (requests, rejects, queue depth, "
                        "latency percentiles) in the SAME format and "
                        "labels as the train CLI's gauges — one scrape "
                        "config covers training and serving")
    p.add_argument("--metrics-host", type=str, default="127.0.0.1",
                   help="bind address for --metrics-port")
    p.add_argument("--collector-push", type=str, default="",
                   metavar="URL",
                   help="stream telemetry to a FleetCollector "
                        "(can_tpu_torch.cli.collect) at URL — best-effort "
                        "batched JSONL over HTTP")
    p.add_argument("--incident-dir", type=str, default="",
                   help="arm the incident layer: a replica quarantine, a "
                        "fast SLO burn, or a SIGTERM dumps a "
                        "self-contained bundle (flight-recorder ring + "
                        "gauges + live serve stats + stacks) here — see "
                        "obs/incidents.py")
    p.add_argument("--slo-spec", type=str, default="",
                   help="JSON SLO spec (slo_spec.json): serve p99 vs "
                        "deadline, reject rate, ... evaluated live as "
                        "multi-window burn rates; can_tpu_slo_* gauges "
                        "on /metrics are the autoscaler's signal")
    return p.parse_args(argv)


def validate_args(args) -> None:
    """The JAX CLI's flag checks, in its order and with its messages
    (before the weights load)."""
    if args.bf16 and args.serve_dtype != "f32":
        raise SystemExit("--bf16 is the legacy f32-params/bf16-compute "
                         "mode; with --serve-dtype use the mode itself "
                         "(drop --bf16)")
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    if args.menu_budget is not None and not 1 <= args.menu_budget <= 8:
        raise SystemExit(f"--menu-budget must be in [1, 8], got "
                         f"{args.menu_budget}")
    if args.stream_ttl_s <= 0:
        raise SystemExit(f"--stream-ttl-s must be positive, got "
                         f"{args.stream_ttl_s}")
    if args.max_body_mb <= 0:
        raise SystemExit(f"--max-body-mb must be positive, got "
                         f"{args.max_body_mb}")
    fleet_only = ["--aot-bundle", "--aot-bake", "--autoscale-max"]
    if args.replicas <= 1 and (args.aot_bundle or args.aot_bake
                               or args.autoscale_max):
        raise SystemExit(f"{'/'.join(fleet_only)} need fleet mode "
                         f"(--replicas >= 2)")
    if args.autoscale_max and args.autoscale_max <= args.replicas:
        raise SystemExit(f"--autoscale-max ({args.autoscale_max}) must "
                         f"exceed --replicas ({args.replicas})")
    if args.autoscale_max and args.autoscale_min is not None:
        if not 1 <= args.autoscale_min <= args.autoscale_max:
            raise SystemExit(
                f"--autoscale-min ({args.autoscale_min}) must be in "
                f"[1, --autoscale-max={args.autoscale_max}]")
    if args.max_batch < 1:
        raise SystemExit(f"--max-batch must be >= 1, got {args.max_batch}")


def _run_config_for(checkpoint_dir, torch_pth, params_npz):
    """Run config for the rollout drift guard — imported .pth/.npz files
    carry none, so the guard is skipped for them.  One helper so
    serve-time and rollout-time agree."""
    from can_tpu_torch.utils.checkpoint import load_run_config

    if torch_pth or params_npz:
        return None
    return load_run_config(checkpoint_dir)


def make_rollout_loader(base_args):
    """Checkpoint loader for the HTTP /rollout endpoint: a JSON source
    spec (the CLI's keys) -> ``(state_dict, run_config)``, through the
    eval CLI's validated loading path — anything you can serve you can
    roll out."""
    import argparse as _ap

    def load(spec: dict):
        from can_tpu_torch.cli.test import load_params, validate_params_source

        allowed = {"checkpoint_dir", "epoch", "params_npz", "torch_pth",
                   "syncBN"}
        unknown = set(spec) - allowed
        if unknown:
            raise ValueError(f"unknown rollout keys: {sorted(unknown)} "
                             f"(allowed: {sorted(allowed)})")
        # an imported-source spec (torch_pth / params_npz) must NOT
        # inherit the serving checkpoint_dir: validate_params_source
        # rejects the combination, which would 409 every such rollout
        imported = bool(spec.get("torch_pth") or spec.get("params_npz"))
        ns = _ap.Namespace(
            # default to the SERVING run's directory (a bare {"epoch": N}
            # rolls forward within it), as syncBN below
            checkpoint_dir=spec.get(
                "checkpoint_dir",
                None if imported else base_args.checkpoint_dir),
            epoch=spec.get("epoch"),
            torch_pth=spec.get("torch_pth", ""),
            params_npz=spec.get("params_npz", ""),
            syncBN=bool(spec.get("syncBN", base_args.syncBN)),
            seed=base_args.seed)
        try:
            validate_params_source(ns)
            state_dict, _ = load_params(ns)
        except SystemExit as e:
            # the loading path speaks CLI (SystemExit); over HTTP that
            # must become a 409-able error, not a dead handler thread
            raise ValueError(str(e)) from None
        return state_dict, _run_config_for(ns.checkpoint_dir, ns.torch_pth,
                                           ns.params_npz)

    return load


def fleet_devices(platform: str) -> list:
    """The fleet's scale universe: the one CPU under ``--platform cpu``,
    else every visible GPU (``NoCudaDeviceError`` without one)."""
    import torch

    from can_tpu_torch.serve.fleet import default_devices

    if platform == "cpu":
        return [torch.device("cpu")]
    return default_devices()


def build_service(args, telemetry=None):
    """Engine + warmed service from parsed args (no networking) — the seam
    tests and ``chip_smoke.py`` drive; ``main`` adds HTTP around it.
    ``telemetry``: an object with ``emit(kind, **payload)``, or None.

    ``service.startup`` holds the start's stages in seconds — ``kernels``
    (the build or load before the weights), ``weights``, ``engines`` (the
    weights on the card; a bundle's check and its library), ``warmup``,
    ``total``, with ``--aot-bake`` the ``bake`` after them — and the
    context kernel library's ``kernel_source`` (built, cache or bundle)
    and ``kernel_seconds``."""
    import time

    import torch

    from can_tpu_torch.cli.test import load_params, validate_params_source
    from can_tpu_torch.cli.train import apply_compile_cache, load_kernels
    from can_tpu_torch.ops import _build, cuda_context
    from can_tpu_torch.serve import AotStaleError, CountService, FleetEngine, ServeEngine
    from can_tpu_torch.serve.fleet import check_replicas

    try:
        device = resolve_device(args.platform)
        devices = fleet_devices(args.platform) if args.replicas > 1 else None
    except NoCudaDeviceError as e:
        raise SystemExit(f"[serve] {e}")
    validate_params_source(args)
    validate_args(args)
    if devices is not None:
        try:
            check_replicas(args.replicas, devices)
        except ValueError as e:
            raise SystemExit(f"[serve] {e}")
    apply_compile_cache(args, announce=True)
    t0 = time.perf_counter()
    if not args.aot_bundle:
        # the kernel library before the weights: a missing nvcc or a failed
        # build costs no load (a bundle's come with the fleet, below)
        load_kernels(device, bn_kernel=False)
    t1 = time.perf_counter()
    state_dict, _ = load_params(args)
    t2 = time.perf_counter()
    compute_dtype = torch.bfloat16 if args.bf16 else None
    if devices is not None:
        try:
            engine = FleetEngine(
                state_dict, replicas=args.replicas,
                serve_dtype=args.serve_dtype,
                compute_dtype=compute_dtype, devices=devices,
                telemetry=telemetry,
                run_config=_run_config_for(args.checkpoint_dir,
                                           args.torch_pth, args.params_npz),
                aot_bundle=args.aot_bundle or None,
                probe_cooldown_s=args.probe_cooldown_s,
                watchdog_slack=args.watchdog_slack,
                watchdog_default_s=args.watchdog_default_s,
                dispatch_order=args.dispatch_order)
        except AotStaleError as e:
            # a stale bundle never runs: refuse, name the axis, point at
            # the re-bake
            raise SystemExit(f"--aot-bundle refused: {e}")
    else:
        engine = ServeEngine(state_dict, device=device,
                             serve_dtype=args.serve_dtype,
                             compute_dtype=compute_dtype, telemetry=telemetry)
    high_water = (args.high_water if args.high_water is not None
                  else max(1, (3 * args.queue_capacity) // 4))
    shapes = args.bucket_shapes
    ladder = (tuple(sorted({h for h, _ in shapes})),
              tuple(sorted({w for _, w in shapes})))
    service = CountService(engine, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           queue_capacity=args.queue_capacity,
                           high_water=high_water,
                           default_deadline_ms=args.deadline_ms,
                           bucket_ladder=ladder, telemetry=telemetry,
                           menu_budget=args.menu_budget,
                           flush_policy=args.flush_policy,
                           stream_ttl_s=args.stream_ttl_s,
                           degrade_policy=args.degrade_policy,
                           max_body_mb=args.max_body_mb)
    if devices is not None:
        # the /rollout endpoint's checkpoint loader (fleet only: a single
        # engine has no staging replica to warm on)
        service.rollout_loader = make_rollout_loader(args)
    # any (H bound, W bound) pairing can occur: warm the whole cross
    # product, at every menu size
    grid = [(h, w) for h in ladder[0] for w in ladder[1]]
    dtypes = (np.float32, np.uint8) if args.u8_warmup else (np.float32,)
    t3 = time.perf_counter()
    try:
        report = service.warmup(grid, dtypes=dtypes)
    except AotStaleError as e:
        # warmup re-checks the batch geometry (max_batch, the bucket grid,
        # the menu) the constructor cannot know yet
        raise SystemExit(f"--aot-bundle refused: {e}")
    t4 = time.perf_counter()
    menu = service.stats()["sched"]["menu"]
    where = (f"{args.replicas} replicas on "
             f"{', '.join(str(d) for d in engine.devices)}"
             if devices is not None else str(device))
    aot = ""
    if devices is not None and args.aot_bundle:
        hits = sum(r.engine.aot_hits for r in engine.replicas)
        aot = f" [AOT: {hits} hits]"
    print(f"[serve] warmup: {report['compiles']} programs over "
          f"{report['shapes']} bucket shapes x menu {tuple(menu)} "
          f"[{args.serve_dtype}{', bf16 compute' if args.bf16 else ''}]{aot} on "
          f"{where} in {report['seconds']:.1f}s")
    built = _build.build_info.get(cuda_context.KERNEL)
    service.startup = startup = dict(
        kernels=t1 - t0, weights=t2 - t1, engines=t3 - t2, warmup=t4 - t3,
        total=t4 - t0, kernel_source=built["source"] if built else None,
        kernel_seconds=built["seconds"] if built else 0.0)
    if built is not None:
        print(f"[serve] ready in {startup['total']:.2f}s: kernels "
              f"{built['source']} {built['seconds']:.2f}s, weights "
              f"{startup['weights']:.2f}s, engines {startup['engines']:.2f}s, "
              f"warmup {startup['warmup']:.2f}s")
    if devices is not None and args.aot_bake:
        manifest = engine.bake_aot(args.aot_bake)
        engine.load_aot(args.aot_bake)  # this run heals from it too
        startup["bake"] = manifest["bake_seconds"]
        print(f"[serve] AOT bundle: {len(manifest['programs'])} programs "
              f"over {len({p['device_id'] for p in manifest['programs']})} "
              f"device(s), {len(manifest['libraries'])} kernel "
              f"librar{'y' if len(manifest['libraries']) == 1 else 'ies'} -> "
              f"{args.aot_bake} ({manifest['bake_seconds']:.1f}s)")
    if devices is not None and args.autoscale_max:
        from can_tpu_torch.serve import Autoscaler, AutoscalePolicy

        policy = AutoscalePolicy(
            min_replicas=(args.autoscale_min
                          if args.autoscale_min is not None
                          else args.replicas),
            max_replicas=args.autoscale_max,
            p99_high_s=(args.deadline_ms / 1e3
                        if args.deadline_ms else None),
            interval_s=args.autoscale_interval_s)
        # the SLO engine's can_tpu_slo_alerting gauges (--slo-spec) are
        # the autoscaler's burn signal
        service.autoscaler = Autoscaler(
            service, policy,
            gauges=getattr(telemetry, "_gauge_sink", None))
        print(f"[serve] autoscaler armed: {policy.min_replicas}.."
              f"{policy.max_replicas} replicas, "
              f"eval every {policy.interval_s:g}s")
    return service


def main(argv=None) -> int:
    from can_tpu_torch.cli.test import validate_params_source
    from can_tpu_torch.cli.train import build_telemetry, validate_incident_args
    from can_tpu_torch.obs import shutdown_telemetry
    from can_tpu_torch.serve import serve_http

    args = parse_args(argv)
    # every check that needs no device runs first: a bad flag, spec or
    # incident dir, or a missing card, costs no telemetry and no CUDA work
    # (on a copy: build_service validates again and defaults the dir)
    validate_params_source(argparse.Namespace(**vars(args)))
    validate_args(args)
    validate_incident_args(args)
    try:
        resolve_device(args.platform)
    except NoCudaDeviceError as e:
        raise SystemExit(f"[serve] {e}")
    telemetry, heartbeat, exporter = build_telemetry(args, host_id=0,
                                                     trace_window=None)
    try:
        service = build_service(args, telemetry=telemetry)
        if exporter is not None:
            # serve's counters in the same scrape as the bus gauges
            exporter.add_stats_source("serve", service.stats)
        with service:
            httpd = serve_http(service, host=args.host, port=args.port)
            endpoints = "POST /predict, GET /healthz, GET /stats"
            if args.replicas > 1:
                endpoints += ", POST /rollout"
            print(f"[serve] listening on http://{args.host}:"
                  f"{httpd.server_address[1]} ({endpoints})", flush=True)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                print("[serve] shutting down")
            finally:
                httpd.server_close()
        return 0
    finally:
        # the one teardown order shared with the SIGTERM path
        shutdown_telemetry(telemetry, heartbeat=heartbeat, exporter=exporter)


if __name__ == "__main__":
    raise SystemExit(main())

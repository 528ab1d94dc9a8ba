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
              (``cli.serve.build_service``, default ladder, --max-batch 8,
              --u8-warmup) over HTTP on an ephemeral port in f32 and bf16:
              one request per ladder cell (non-/8 sizes, u8 and
              host-normalised bodies, one asking for the density map),
              then a burst of 32 requests at 768x1024 from a separate
              client process.
              Every answer must be finite and match the same engine run
              with the plain-version seam, and that engine's counts must
              move by many tolerances when the gate matrices are zeroed
              (so the check sees the kernel's products); the kernel's
              launch counter must equal the batches the two services ran;
4. training — a synthetic PNG dataset (20 train items mixed from 576x768,
              560x744 and 480x640, 8 test items) is trained by the port's
              CLI path (``cli.train.train``: --syncBN --bn-impl kernel
              --batch-size 8 --pad-multiple 64, one epoch of 3 steps with
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
5. report   — the card's name and power limit (nvidia-smi's own line), a
              ``kernels`` JSON line,
              and last the result line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --measure-only`` runs the build and the timings of
phases 2 and 4 that reach the kernels only through interfaces older
versions of the port share (``moment_sums_cuda``, ``MomentSums``, the
train step) — the BN table (``bn_time``) and the step split and profile
(``step_breakdown``) — and no check, no serving, no result line: copied
into an older checkout, it times that checkout's kernels by this
script's methods, in the same chip call as this one.

Imports torch, numpy, the standard library and ``can_tpu_torch`` — no JAX.
"""

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

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
COUNT_RTOL = {"f32": 1e-4, "bf16": 2e-2}
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
# published dense peaks (FLOP/s by dtype, bytes/s), NVIDIA's H100 SXM data
# sheet: the one card this script has run on; any other card is refused
# until its peaks are added here
PEAKS = {"NVIDIA H100 80GB HBM3": {"f32": 67e12, "bf16": 989e12,
                                   "bytes": 3.35e12}}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"[smoke] FAIL: {msg}")
    sys.exit(1)


def peaks_for(name: str) -> dict:
    if name not in PEAKS:
        fail(f"no peaks recorded for {name!r} (known: {sorted(PEAKS)})")
    return PEAKS[name]


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
            f"cache_hit={info['cache_hit']} -> {info['path']}")
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


def context_bound(fv, avew, uh, wmat, peaks: dict):
    """Least time for the context tail on these inputs: the four gate
    products, the row interpolation and the elementwise work at the peak
    of fv's dtype, against each input read once and fi written once.
    Returns (ms, "operations" or "bytes", FLOP, bytes)."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc

    b, h, w, c = fv.shape
    n = b * h * w
    flops = 2 * 4 * n * c * c + 2 * cc.N_ROWS * n * c + 6 * 4 * n * c
    # inputs read once, fi (fv's shape and dtype) written once
    nbytes = sum(t.numel() * t.element_size() for t in (fv, avew, uh, wmat, fv))
    peak = peaks["bf16" if fv.dtype == torch.bfloat16 else "f32"]
    by_ops = flops / peak * 1e3
    by_bytes = nbytes / peaks["bytes"] * 1e3
    return (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes",
            flops, nbytes)


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


def serve_one(pth: Path, serve_dtype: str) -> dict:
    """Build the CLI service and serve HTTP traffic; returns the service
    (still holding its engine), the requests sent with their counts, and
    the batches run."""
    from can_tpu_torch.cli import serve as cli
    from can_tpu_torch.serve import serve_http

    args = cli.parse_args(["--torch-pth", str(pth), "--max-batch", str(MAX_BATCH),
                           "--u8-warmup", "--serve-dtype", serve_dtype,
                           "--port", "0", "--deadline-ms", "120000"])
    service = cli.build_service(args)
    warm_batches = service.engine.compile_count
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
            cells = [(hb, wb) for hb in LADDER[0] for wb in LADDER[1]]
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
            # burst: BURST concurrent clients at the largest bucket, from a
            # separate process so client work does not share the server's GIL
            body = pth.parent / "burst_768x1024.npy"
            np.save(body, rng.integers(0, 256, (768, 1024, 3), dtype=np.uint8))
            proc = subprocess.run(
                [sys.executable, "-c", BURST_CLIENT, str(port), str(BURST),
                 str(body)], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                fail(f"burst client failed: {proc.stderr[-2000:]}")
            burst = json.loads(proc.stdout.strip().splitlines()[-1])
            lat, wall = burst["lat"], burst["wall"]
            if burst["errors"] or len(lat) != BURST:
                fail(f"burst: {len(lat)}/{BURST} answered, errors "
                     f"{burst['errors'][:3]}")
        finally:
            httpd.shutdown()
            httpd.server_close()
    stats = service.stats()
    if stats["rejected"]:
        fail(f"{serve_dtype}: {stats['rejected']} requests rejected")
    p50 = statistics.median(lat) * 1e3
    in_server = statistics.median(x[0] for x in burst["server"])
    queued = statistics.median(x[1] for x in burst["server"])
    log(f"[serve] {serve_dtype}: {len(sent)} requests over {len(cells)} ladder "
        f"cells ok; burst {BURST} x 768x1024: p50 latency {p50:.1f} ms, "
        f"{BURST / wall:.2f} images/s ({stats['batches']} batches served, "
        f"{warm_batches} warmup)")
    # client latency = before submit (upload, body parse) + queue wait +
    # batch (assembly, predict_batch, resolve) + response; medians
    log(f"[serve] {serve_dtype} burst p50 split: {p50 - in_server:.1f} ms "
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
        fwd = time_ms(lambda: engine.model(x, compute_dtype=engine.compute_dtype),
                      reps=5)
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


def bn_bound(y, peaks: dict):
    """Least time for the moment sums on these inputs: y and the mask read
    once, (2C + 1) f32 written; 4 f32 operations per element of y (y m,
    +, fma) on CUDA cores (bf16 is widened, so the f32 peak)."""
    b, h, w, c = y.shape
    nbytes = y.numel() * y.element_size() + b * h * w * 4 + (2 * c + 1) * 4
    by_bytes = nbytes / peaks["bytes"] * 1e3
    by_ops = 4 * y.numel() / peaks["f32"] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), nbytes


class _Saved:
    """What ``MomentSums.backward`` reads of its autograd context."""

    def __init__(self, *tensors):
        self.saved_tensors = tensors


def bn_backward_bound(y, peaks: dict):
    """Least time for the BN backward dy = m (g1 + 2 g2 y) on these
    inputs: y and the mask read once, dy (y's shape and dtype) written
    once; 3 f32 operations per element (2 g2 is per channel) on CUDA
    cores."""
    b, h, w, c = y.shape
    nbytes = 2 * y.numel() * y.element_size() + b * h * w * 4 + 2 * c * 4
    by_bytes = nbytes / peaks["bytes"] * 1e3
    by_ops = 3 * y.numel() / peaks["f32"] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), nbytes


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
    f_bound, f_by, f_bytes = bn_bound(y, peaks)
    b_bound, b_by, b_bytes = bn_backward_bound(y, peaks)
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


def _state():
    import torch

    from can_tpu_torch.models import CANNet
    from can_tpu_torch.train import create_train_state, make_lr_schedule

    model = CANNet(device="cuda", seed=SEED, batch_norm=True)
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


def main(argv) -> int:
    import torch

    measure_only = argv == ["--measure-only"]
    if argv and not measure_only:
        fail(f"unknown arguments {argv} (none, or --measure-only)")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
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
    pth = work / "cannet_seed0_he.pth"
    # He-scaled normals: the reference N(0, 0.01) init collapses every gate
    # to 0.5 and every count to ~1e-8, where parity would prove nothing
    torch.save({k: torch.from_numpy(v) for k, v in
                random_state_dict(SEED, he=True).items()}, pth)
    cc.reset_launches()  # the serving path starts here
    runs = {dt: serve_one(pth, dt) for dt in ("f32", "bf16")}
    launches = cc.LAUNCHES  # ... and ends here
    want = sum(r["batches"] for r in runs.values())
    if launches != want:
        fail(f"context_fused launched {launches} times, but the services ran "
             f"{want} batches")
    log(f"[serve] context_fused launches during serving: {launches} "
        f"(= batches run, warmup included)")
    for dt, run in runs.items():
        breakdown(run, dt, row["ms"] if dt == "f32" else row["bf16_ms"])
        check_parity(run, dt)  # ends by releasing the engine's weights
    del runs

    train_launches = phase_train(work)  # resets and reads the counts

    kernels = [{"name": cc.KERNEL, "route": "cuda",
                "source": "can_tpu_torch/csrc/context_fused.cu",
                "replaces": "can_tpu/ops/pallas_context.py:143",
                "launches": launches + train_launches["context"],
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None, "products_ms": row["products_ms"]},
               {"name": cb.KERNEL, "route": "cuda",
                "source": "can_tpu_torch/csrc/bn_moments.cu",
                "replaces": "can_tpu/ops/pallas_bn.py:104",
                "launches": train_launches["bn"], **bn["forward"]},
               {"name": cb.BACKWARD_KERNEL, "route": "cuda",
                "source": "can_tpu_torch/csrc/bn_moments.cu",
                "replaces": "can_tpu/ops/pallas_bn.py:143",
                "launches": train_launches["bn_backward"], **bn["backward"]}]
    log(f"[smoke] done in {time.perf_counter() - t_start:.1f}s; kernels timed "
        f"at context (8, 96, 128, 512) f32 (bf16: {row['bf16_ms']:.3f} ms), "
        f"bn_moments and bn_moments_backward {BN_STEP_SHAPES[0][0]} f32; launches: "
        f"context_fused {launches} serving + {train_launches['context']} "
        f"training, bn_moments {train_launches['bn']} and "
        f"bn_moments_backward {train_launches['bn_backward']} training")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""On-card smoke run of can_tpu_torch: the quickest proof that the port
builds and serves on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero; nothing is printed as a result then):

1. build    — compile csrc/context_fused.cu from the checkout with nvcc;
2. kernels  — the context kernel against its plain PyTorch version on the
              card, at the full feature map of the largest bucket
              (8, 96, 128, 512) and at a ragged (2, 47, 61, 512), in f32
              and bf16; warm CUDA-event medians of both;
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
4. report   — the card's name and power limit (nvidia-smi's own line), a
              ``kernels`` JSON line,
              and last the result line ``{"ok": true, "device": {...}}``.

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


def phase_build():
    from can_tpu_torch.ops import _build, cuda_context

    cuda_context.load_library()
    info = _build.build_info[cuda_context.KERNEL]
    log(f"[build] {cuda_context.KERNEL}: {info['seconds']:.2f}s "
        f"cache_hit={info['cache_hit']} -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   ptxas: {line.strip()}")


def phase_kernels(peaks: dict) -> dict:
    """Kernel vs plain version at both shapes and dtypes; returns the
    kernels-line numbers (times at the full-size shape in f32, the worst
    error over every check)."""
    import torch

    from can_tpu_torch.ops import cuda_context as cc

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    worst = 0.0
    for shape in ((8, 96, 128, 512), (2, 47, 61, 512)):
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
            bound = atol + rtol * want.float().abs()
            if not bool(torch.isfinite(got.float()).all()):
                fail(f"context_fused {shape} {name}: non-finite output")
            if not bool((diff <= bound).all()):
                fail(f"context_fused {shape} {name}: max abs err {max_abs:.3e} "
                     f"exceeds rtol {rtol} / atol {atol}")
            worst = max(worst, max_abs)
            ms = time_ms(lambda: cc.context_tail_cuda(fv, avew, uh, wmat))
            plain_ms = time_ms(lambda: cc.context_tail_reference(fv, avew, uh, wmat))
            n = b * h * w
            flops = 2 * 4 * n * c * c + 2 * cc.N_ROWS * n * c + 6 * 4 * n * c
            nbytes = sum(t.numel() * t.element_size()
                         for t in (fv, avew, uh, wmat, got))
            by_ops = flops / peaks[name] * 1e3
            by_bytes = nbytes / peaks["bytes"] * 1e3
            log(f"[kernel] context_fused {shape} {name}: max abs err "
                f"{max_abs:.3e} max rel err "
                f"{max_abs / max(float(want.float().abs().max()), 1e-30):.3e} "
                f"(rtol {rtol}, atol {atol}) | kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms | bound {max(by_ops, by_bytes):.3f} ms "
                f"({'operations' if by_ops >= by_bytes else 'bytes'}: "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) | "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
            rows[(shape, name)] = {"ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": max(by_ops, by_bytes),
                                   "bound_by": ("operations" if by_ops >= by_bytes
                                                else "bytes")}
            del got, want, diff, bound
    full = rows[((8, 96, 128, 512), "f32")]
    return {"max_abs_err": worst, **full,
            "bf16_ms": rows[((8, 96, 128, 512), "bf16")]["ms"]}


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


def main() -> int:
    import torch

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

    phase_build()
    row = phase_kernels(peaks)

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    pth = work / "cannet_seed0_he.pth"
    # He-scaled normals: the reference N(0, 0.01) init collapses every gate
    # to 0.5 and every count to ~1e-8, where parity would prove nothing
    torch.save({k: torch.from_numpy(v) for k, v in
                random_state_dict(SEED, he=True).items()}, pth)
    cc.reset_launches()  # the main path starts here
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
        check_parity(run, dt)

    kernels = [{"name": cc.KERNEL, "route": "cuda",
                "source": "can_tpu_torch/csrc/context_fused.cu",
                "replaces": "can_tpu/ops/pallas_context.py:143",
                "launches": launches, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}]
    log(f"[smoke] done in {time.perf_counter() - t_start:.1f}s; kernels timed "
        f"at (8, 96, 128, 512) f32 (bf16: {row['bf16_ms']:.3f} ms)")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Online serving CLI: load CANNet weights, warm up the bucket ladder,
answer count/density requests over HTTP on the card.

Single-replica counterpart of ``can_tpu/cli/serve.py``::

    python -m can_tpu_torch.cli.serve --torch-pth epoch_354.pth \\
        --bucket-shapes 384x512,512x768,768x1024 --max-batch 8 --port 8000
    python -m can_tpu_torch.cli.serve --checkpoint-dir ./checkpoints --syncBN

    curl -X POST --data-binary @img.npy \\
        'http://127.0.0.1:8000/predict?deadline_ms=200'

The weights load as the eval CLI loads them (``cli/test.py``'s
``validate_params_source`` and ``load_params``): the train CLI's
checkpoint directory (best MAE, else the latest, or ``--epoch``; the BN
model with its running statistics under ``--syncBN``), a reference
``.pth`` or a ``save_params_npz`` ``.npz``.  ``--platform default`` (or
``gpu``) runs on the CUDA device and exits non-zero when there is none;
``--platform cpu`` is the explicit CPU run.
"""

from __future__ import annotations

import argparse
import re
from typing import List, Tuple

import numpy as np

from can_tpu_torch.device import PLATFORMS, NoCudaDeviceError, resolve_device
from can_tpu_torch.serve.quant import INT8_MESSAGE, SERVE_DTYPES


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
    p.add_argument("--bucket-shapes", type=parse_bucket_shapes,
                   default=parse_bucket_shapes("384x512,512x768,768x1024"),
                   help="comma-separated HxW bucket ladder; requests snap UP "
                        "per axis to the smallest covering bound, and every "
                        "(H bound, W bound) pair is warmed at startup")
    p.add_argument("--max-batch", type=int, default=8,
                   help="requests per micro-batch (every launch pads to it)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="flush a partial batch this long after its oldest "
                        "request arrived")
    p.add_argument("--queue-capacity", type=int, default=64,
                   help="hard bound on queued requests (beyond: queue_full)")
    p.add_argument("--high-water", type=int, default=None,
                   help="outstanding requests that start load shedding "
                        "(backpressure until half-drained); default 3/4 "
                        "of --queue-capacity")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline (expired requests are "
                        "rejected, never dispatched)")
    p.add_argument("--serve-dtype", type=str, default="f32",
                   choices=list(SERVE_DTYPES),
                   help="f32 = full f32 (TF32 off); bf16 = bf16 weights and "
                        "compute with f32 accumulation; int8 = not ported yet")
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
    return p.parse_args(argv)


def build_service(args):
    """Engine + warmed service from parsed args (no networking) — the seam
    tests and ``chip_smoke.py`` drive; ``main`` adds HTTP around it."""
    from can_tpu_torch.cli.test import load_params, validate_params_source
    from can_tpu_torch.serve import CountService, ServeEngine

    try:
        device = resolve_device(args.platform)
    except NoCudaDeviceError as e:
        raise SystemExit(f"[serve] {e}")
    validate_params_source(args)
    if args.serve_dtype == "int8":
        raise SystemExit(INT8_MESSAGE)
    if args.max_batch < 1:
        raise SystemExit(f"--max-batch must be >= 1, got {args.max_batch}")
    if args.max_body_mb <= 0:
        raise SystemExit(f"--max-body-mb must be positive, got "
                         f"{args.max_body_mb}")
    state_dict, _ = load_params(args)
    engine = ServeEngine(state_dict, device=device,
                         serve_dtype=args.serve_dtype)
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
                           bucket_ladder=ladder, max_body_mb=args.max_body_mb)
    # any (H bound, W bound) pairing can occur: warm the whole cross product
    grid = [(h, w) for h in ladder[0] for w in ladder[1]]
    dtypes = (np.float32, np.uint8) if args.u8_warmup else (np.float32,)
    report = service.warmup(grid, dtypes=dtypes)
    print(f"[serve] warmup: {report['compiles']} programs over "
          f"{report['shapes']} bucket shapes [{args.serve_dtype}] on "
          f"{device} in {report['seconds']:.1f}s")
    return service


def main(argv=None) -> int:
    from can_tpu_torch.serve import serve_http

    args = parse_args(argv)
    service = build_service(args)
    with service:
        httpd = serve_http(service, host=args.host, port=args.port)
        print(f"[serve] listening on http://{args.host}:"
              f"{httpd.server_address[1]} (POST /predict, GET /healthz, "
              f"GET /stats)", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            print("[serve] shutting down")
        finally:
            httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

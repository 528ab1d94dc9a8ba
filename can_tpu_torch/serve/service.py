"""CountService: the serving front door, programmatic and over HTTP
(counterpart of ``can_tpu/serve/service.py``: ``prepare_image`` :63,
``CountService`` :120, ``make_http_handler`` :724, ``serve_http`` :943 —
single engine; no fleet, stream sessions, autoscaler, rollout or
telemetry bus in this slice)::

    client -> submit() -> BoundedRequestQueue -> MicroBatcher (thread)
                                               -> ServeEngine.predict_batch
                                               -> resolve ServeRequests
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from can_tpu_torch.data.dataset import normalize_host
from can_tpu_torch.data.imageio import resize_linear
from can_tpu_torch.serve.batcher import MicroBatcher
from can_tpu_torch.serve.engine import ServeEngine
from can_tpu_torch.serve.queue import (
    REJECT_BACKPRESSURE,
    REJECT_DEADLINE,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
    BoundedRequestQueue,
    RejectedError,
    ServeRequest,
    ServeResult,
)
from can_tpu_torch.utils.profiling import StepTimer

STREAMS_MESSAGE = ("stream sessions (stream_id/frame_seq) are not ported yet: "
                   "they come with the serve scheduler/streams/fleet slice of "
                   "can_tpu_torch")


def prepare_image(image: np.ndarray, *, ds: int = 8,
                  normalize: bool = True) -> np.ndarray:
    """Snap an HWC RGB image down to the nearest /ds multiple (bilinear,
    half-pixel centres, as the offline dataset's ``cv2.resize``), then
    ImageNet-normalise (u8 input with normalize=False keeps the bytes for
    normalisation on the device)."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected HWC RGB image, got shape {image.shape}")
    h, w = image.shape[:2]
    rows, cols = h // ds, w // ds
    if rows == 0 or cols == 0:
        raise ValueError(f"image {h}x{w} is smaller than one {ds}px "
                         f"density cell")
    if (rows * ds, cols * ds) != (h, w):
        image = resize_linear(image, rows * ds, cols * ds)
    if normalize:
        image = normalize_host(np.asarray(image))
        if image.dtype != np.float32:
            raise ValueError("normalize=True needs uint8 or already "
                             f"normalised float32 pixels, got {image.dtype}")
    return image


class ServeTicket:
    """Handle returned by ``submit()``; ``result()`` blocks for the
    outcome, raising ``RejectedError`` on any rejection (the wait is
    bounded by the deadline plus a grace window — never a hang)."""

    def __init__(self, request: ServeRequest, service: "CountService"):
        self._request = request
        self._service = service
        self.id = request.id

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if timeout is None:
            if self._request.deadline_ts is not None:
                timeout = (self._request.deadline_ts - time.monotonic()
                           + self._service.grace_s)
            else:
                timeout = self._service.default_result_timeout_s
        return self._request.wait(max(timeout, 0.0))


class CountService:
    """Owns the queue, the batcher thread and the engine.  Call
    ``warmup()`` before traffic."""

    def __init__(self, engine: ServeEngine, *, max_batch: int = 8,
                 max_wait_ms: float = 5.0, queue_capacity: int = 64,
                 high_water: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 bucket_ladder=None, max_body_mb: float = 64.0):
        if max_body_mb <= 0:
            raise ValueError(f"max_body_mb must be positive, got {max_body_mb}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.default_deadline_s = (None if default_deadline_ms is None
                                   else float(default_deadline_ms) / 1e3)
        self.grace_s = max(1.0, 4 * float(max_wait_ms) / 1e3)
        self.default_result_timeout_s = 120.0
        self.max_body_bytes = int(float(max_body_mb) * 2 ** 20)
        self.queue = BoundedRequestQueue(queue_capacity, high_water=high_water)
        self.batcher = MicroBatcher(self.queue, self._dispatch,
                                    max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    bucket_ladder=bucket_ladder, ds=engine.ds,
                                    on_reject=self._note_reject)
        # request latency reservoir; read by HTTP threads while the
        # batcher thread records, hence under _lock
        self.latency = StepTimer()
        self._lock = threading.Lock()
        self._stats = {"submitted": 0, "completed": 0, "rejected": 0,
                       "batches": 0, "batch_slots": 0, "batch_valid": 0}
        self._started = False
        self._closed = False
        # image dtypes warmup() has run — the HTTP raw=1 gate
        self.warmed_dtypes: set = set()
        self._trace_prefix = f"req-{os.getpid():x}{os.urandom(2).hex()}"

    # -- lifecycle -------------------------------------------------------
    def warmup(self, bucket_shapes: Sequence[Tuple[int, int]],
               dtypes=(np.float32,)) -> dict:
        report = self.engine.warmup(bucket_shapes, self.max_batch,
                                    dtypes=dtypes)
        self.warmed_dtypes.update(np.dtype(dt) for dt in dtypes)
        return report

    def start(self) -> "CountService":
        if not self._started:
            self.batcher.start()
            self._started = True
        return self

    def close(self) -> None:
        """Stop admissions, drain in-flight work, reject the rest."""
        if self._closed:
            return
        self._closed = True
        for r in self.queue.close():
            r.reject(REJECT_SHUTDOWN, "service closing")
            self._note_reject(REJECT_SHUTDOWN)
        self.batcher.close()
        self._started = False

    def __enter__(self) -> "CountService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the programmatic API --------------------------------------------
    def submit(self, image: np.ndarray, *,
               deadline_ms: Optional[float] = None,
               want_density: bool = False) -> ServeTicket:
        """Enqueue one prepared image (see ``prepare_image``).  Returns a
        ticket; an immediate rejection (full queue, shedding, shutdown)
        is stored on it."""
        deadline_s = (float(deadline_ms) / 1e3 if deadline_ms is not None
                      else self.default_deadline_s)
        req = ServeRequest(np.asarray(image), deadline_s=deadline_s,
                           want_density=want_density)
        req.trace_id = f"{self._trace_prefix}-{req.id}"
        ds = self.engine.ds
        if req.shape[0] % ds or req.shape[1] % ds:
            raise ValueError(
                f"image shape {req.shape} is not snapped to the /{ds} "
                f"density grid — call prepare_image first")
        bucket = self.batcher.bucket_of(req.shape)
        if bucket[0] < req.shape[0] or bucket[1] < req.shape[1]:
            raise ValueError(
                f"image {req.shape[0]}x{req.shape[1]} exceeds the largest "
                f"bucket {bucket[0]}x{bucket[1]} — resize it or serve with "
                f"a bigger bucket ladder")
        with self._lock:
            self._stats["submitted"] += 1
        if self._closed:
            req.reject(REJECT_SHUTDOWN, "service closed")
            self._note_reject(REJECT_SHUTDOWN)
            return ServeTicket(req, self)
        reason = self.queue.offer(req)
        if reason is not None:
            self._note_reject(reason)
        return ServeTicket(req, self)

    def predict(self, image: np.ndarray, *,
                deadline_ms: Optional[float] = None,
                want_density: bool = False,
                timeout: Optional[float] = None) -> ServeResult:
        """submit + result in one call."""
        return self.submit(image, deadline_ms=deadline_ms,
                           want_density=want_density).result(timeout)

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            lat = self.latency.percentiles()
        slots = max(s["batch_slots"], 1)
        return {**s,
                "queue_depth": self.queue.depth(),
                "shedding": self.queue.shedding,
                "mean_batch_fill": round(s["batch_valid"] / slots, 4),
                "latency_p50_s": lat["p50_s"],
                "latency_p95_s": lat["p95_s"],
                "latency_max_s": lat["max_s"],
                "compile_count": self.engine.compile_count}

    def healthz(self) -> dict:
        return {"ok": not self._closed}

    # -- batcher dispatch (runs on the batcher thread) -------------------
    def _dispatch(self, bucket_hw, batch, requests) -> None:
        counts, density = self.engine.predict_batch(
            batch, want_density=any(r.want_density for r in requests))
        now = time.monotonic()
        fill = len(requests) / batch.image.shape[0]
        ds = self.engine.ds
        for slot, req in enumerate(requests):
            h, w = req.shape
            dens = (np.asarray(density[slot, : h // ds, : w // ds])
                    if req.want_density else None)
            latency = now - req.t_submit
            req.resolve(ServeResult(
                count=float(counts[slot]), density=dens,
                bucket_hw=tuple(bucket_hw), batch_fill=fill,
                latency_s=latency,
                queue_wait_s=round(max(req.t_assembly - req.t_submit, 0.0), 6),
                trace_id=req.trace_id))
            with self._lock:
                self.latency.record(latency)
        with self._lock:
            self._stats["completed"] += len(requests)
            self._stats["batches"] += 1
            self._stats["batch_slots"] += batch.image.shape[0]
            self._stats["batch_valid"] += len(requests)

    def _note_reject(self, reason: str, count: int = 1) -> None:
        with self._lock:
            self._stats["rejected"] += count


# -- HTTP front end -----------------------------------------------------
def make_http_handler(service: CountService):
    """Request handler class bound to ``service``.

    POST /predict   body: .npy bytes (np.save of an HWC uint8/float32
                    image); query: ?deadline_ms=&density=1&raw=1 (raw=1
                    keeps uint8 pixels and normalises on the device; needs
                    the u8 programs warmed, cli --u8-warmup)
                    -> 200 {"count", "latency_ms", "bucket", "batch_fill",
                            "trace_id", "queue_wait_ms"[, "density"]}
                    -> 408/503 {"error", "reason"} on deadline/shedding;
                       400 on a bad request (and on stream_id/frame_seq,
                       not ported yet); 413 when the body exceeds the cap
    GET  /healthz   -> 200 {"ok": true}
    GET  /stats     -> 200 stats() JSON
    """
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    status_of = {REJECT_DEADLINE: 408, REJECT_QUEUE_FULL: 503,
                 REJECT_BACKPRESSURE: 503, REJECT_SHUTDOWN: 503}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body_capped(self) -> Optional[int]:
            """Content-Length, or None after answering 400/413: an
            oversized body is refused before it is read."""
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n < 0:
                    raise ValueError(f"negative Content-Length {n}")
            except ValueError as e:
                self._send(400, {"error": f"bad request: {e}"})
                return None
            if n > service.max_body_bytes:
                self._send(413, {
                    "error": f"request body {n} bytes exceeds the "
                             f"{service.max_body_bytes} byte cap "
                             f"(--max-body-mb="
                             f"{service.max_body_bytes / 2 ** 20:g})"})
                return None
            return n

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                health = service.healthz()
                self._send(200 if health.get("ok") else 503, health)
            elif path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"no such path: {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._send(404, {"error": f"no such path: {url.path}"})
                return
            n = self._body_capped()
            if n is None:
                return
            try:
                body = self.rfile.read(n)
                q = parse_qs(url.query)
                if "stream_id" in q or "frame_seq" in q:
                    raise ValueError(STREAMS_MESSAGE)
                arr = np.load(io.BytesIO(body), allow_pickle=False)
                deadline_ms = (float(q["deadline_ms"][0])
                               if "deadline_ms" in q else None)
                want_density = q.get("density", ["0"])[0] not in ("0", "")
                raw = q.get("raw", ["0"])[0] not in ("0", "")
                if raw and arr.dtype != np.uint8:
                    raise ValueError("raw=1 needs uint8 pixels")
                if raw and np.dtype(np.uint8) not in service.warmed_dtypes:
                    raise ValueError("raw=1 (uint8) programs are not warmed "
                                     "on this server; start it with "
                                     "--u8-warmup")
                image = prepare_image(arr, ds=service.engine.ds,
                                      normalize=not raw)
            except Exception as e:  # noqa: BLE001 — client error, not ours
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                res = service.predict(image, deadline_ms=deadline_ms,
                                      want_density=want_density)
            except ValueError as e:  # submit-side validation: client error
                self._send(400, {"error": f"bad request: {e}"})
                return
            except RejectedError as e:
                self._send(status_of.get(e.reason, 503),
                           {"error": str(e), "reason": e.reason})
                return
            payload = {"count": res.count,
                       "latency_ms": round(res.latency_s * 1e3, 3),
                       "bucket": list(res.bucket_hw),
                       "batch_fill": res.batch_fill,
                       "trace_id": res.trace_id,
                       "queue_wait_ms": round(res.queue_wait_s * 1e3, 3)}
            if res.density is not None:
                payload["density"] = res.density[..., 0].tolist()
            self._send(200, payload)

    return Handler


def serve_http(service: CountService, *, host: str = "127.0.0.1",
               port: int = 8000):
    """A ``ThreadingHTTPServer`` for ``service`` (the caller runs
    ``serve_forever()``): one thread per client connection, the single
    batcher thread owns the device."""
    from http.server import ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 resets connections
        # when a burst of clients connects at once
        request_queue_size = 128

    return Server((host, port), make_http_handler(service))

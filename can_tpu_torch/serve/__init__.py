"""can_tpu_torch.serve — online CANNet counting: bucketed micro-batches
priced by the scheduling core, deadlines, backpressure, per-stream
sessions, f32/bf16/int8 weights, HTTP, and the serving fleet — replicas
with work stealing, blue/green rollout, self-healing and the autoscaler,
and AOT bundles for its cold start (counterpart of ``can_tpu/serve``)::

    engine = ServeEngine(state_dict, device=resolve_device("default"))
    ladder = ((384, 512, 768), (512, 768, 1024))
    svc = CountService(engine, max_batch=8, max_wait_ms=5,
                       bucket_ladder=ladder)
    svc.warmup([(h, w) for h in ladder[0] for w in ladder[1]])
    with svc:
        res = svc.predict(prepare_image(img), deadline_ms=200)
        cam = svc.predict(prepare_image(frame), stream_id="cam1",
                          frame_seq=17)  # cam.degraded, cam.staleness_s

    fleet = FleetEngine(state_dict, replicas=2)   # one replica per GPU
    svc = CountService(fleet, max_batch=8, bucket_ladder=ladder)
    svc.warmup(...); svc.start(); svc.rollout(new_state_dict)
    fleet.bake_aot("ckpt/aot")                    # then, in a new process:
    FleetEngine(state_dict, replicas=2, aot_bundle="ckpt/aot")

Guarantees: every submitted request resolves or is rejected with a typed
reason; the engine's signature count is (bucket, menu size, dtype),
all paid in ``warmup`` (per replica in a fleet).
"""

from can_tpu_torch.serve.aot import AotBundle, AotStaleError, load_aot_bundle
from can_tpu_torch.serve.autoscale import Autoscaler, AutoscalePolicy
from can_tpu_torch.serve.batcher import MicroBatcher
from can_tpu_torch.serve.engine import ServeEngine, tree_signature
from can_tpu_torch.serve.fleet import (
    REPLICA_ACTIVE,
    REPLICA_DRAINING,
    REPLICA_QUARANTINED,
    REPLICA_WEDGED,
    FleetClosedError,
    FleetEngine,
    ReplicaWedgedError,
    priced_deadline_s,
)
from can_tpu_torch.serve.quant import (
    PARITY_LADDER,
    SERVE_DTYPES,
    compute_dtype_for,
    dequantize_tree,
    host_tree,
    param_bytes,
    parity_report,
    quantize_tree,
)
from can_tpu_torch.serve.queue import (
    REJECT_BACKPRESSURE,
    REJECT_DEADLINE,
    REJECT_ERROR,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
    REJECT_STALE_FRAME,
    REJECT_STREAM_OVERLOAD,
    BoundedRequestQueue,
    RejectedError,
    ServeRequest,
    ServeResult,
)
from can_tpu_torch.serve.service import (
    CountService,
    ServeTicket,
    make_http_handler,
    prepare_image,
    serve_http,
)
from can_tpu_torch.serve.streams import (
    STREAM_RUNG_FULL,
    STREAM_RUNG_REJECT,
    STREAM_RUNG_SKIP,
    StreamSession,
    StreamSessionRegistry,
    repin_target,
)

__all__ = [
    "AotBundle", "AotStaleError", "load_aot_bundle",
    "Autoscaler", "AutoscalePolicy", "FleetClosedError", "FleetEngine",
    "REPLICA_ACTIVE", "REPLICA_DRAINING", "REPLICA_QUARANTINED",
    "REPLICA_WEDGED", "ReplicaWedgedError", "priced_deadline_s",
    "BoundedRequestQueue", "CountService", "MicroBatcher", "PARITY_LADDER",
    "SERVE_DTYPES", "compute_dtype_for", "dequantize_tree", "host_tree",
    "param_bytes", "parity_report", "quantize_tree", "tree_signature",
    "REJECT_BACKPRESSURE", "REJECT_DEADLINE", "REJECT_ERROR",
    "REJECT_QUEUE_FULL", "REJECT_SHUTDOWN", "REJECT_STALE_FRAME",
    "REJECT_STREAM_OVERLOAD", "RejectedError", "STREAM_RUNG_FULL",
    "STREAM_RUNG_REJECT", "STREAM_RUNG_SKIP", "ServeEngine", "ServeRequest",
    "ServeResult", "ServeTicket", "StreamSession", "StreamSessionRegistry",
    "make_http_handler", "prepare_image", "repin_target", "serve_http",
]

"""can_tpu_torch.serve — online CANNet counting: bucketed micro-batches,
deadlines, backpressure, HTTP (counterpart of ``can_tpu/serve``, single
engine)::

    engine = ServeEngine(state_dict, device=resolve_device("default"))
    ladder = ((384, 512, 768), (512, 768, 1024))
    svc = CountService(engine, max_batch=8, max_wait_ms=5,
                       bucket_ladder=ladder)
    svc.warmup([(h, w) for h in ladder[0] for w in ladder[1]])
    with svc:
        res = svc.predict(prepare_image(img), deadline_ms=200)
"""

from can_tpu_torch.serve.batcher import MicroBatcher
from can_tpu_torch.serve.engine import ServeEngine
from can_tpu_torch.serve.quant import SERVE_DTYPES, compute_dtype_for, quantize_tree
from can_tpu_torch.serve.queue import (
    REJECT_BACKPRESSURE,
    REJECT_DEADLINE,
    REJECT_ERROR,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
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

__all__ = [
    "MicroBatcher", "ServeEngine", "SERVE_DTYPES", "compute_dtype_for",
    "quantize_tree", "REJECT_BACKPRESSURE", "REJECT_DEADLINE", "REJECT_ERROR",
    "REJECT_QUEUE_FULL", "REJECT_SHUTDOWN", "BoundedRequestQueue",
    "RejectedError", "ServeRequest", "ServeResult", "CountService",
    "ServeTicket", "make_http_handler", "prepare_image", "serve_http",
]

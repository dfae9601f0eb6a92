"""Runtime pieces: fault tolerance (``fault``) and gradient compression
(``compress``: its numerics and the int8 all-reduce) for training, and
the sweep engine's spans, counters and device events (``spans``)."""

from .fault import (HeartbeatMonitor, StragglerPolicy, WorkerFailure,
                    run_with_restarts)
from .compress import (compressed_psum, dequantize_int8, fake_quant_grads,
                       quantize_int8)

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "WorkerFailure",
           "run_with_restarts", "compressed_psum", "dequantize_int8",
           "fake_quant_grads", "quantize_int8"]

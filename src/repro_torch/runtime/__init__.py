"""Runtime pieces of training: fault tolerance (``fault``) and gradient
compression (``compress``: its numerics and the int8 all-reduce)."""

from .fault import (HeartbeatMonitor, StragglerPolicy, WorkerFailure,
                    run_with_restarts)
from .compress import (compressed_psum, dequantize_int8, fake_quant_grads,
                       quantize_int8)

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "WorkerFailure",
           "run_with_restarts", "compressed_psum", "dequantize_int8",
           "fake_quant_grads", "quantize_int8"]

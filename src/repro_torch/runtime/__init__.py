"""Runtime pieces of training: fault tolerance (``fault``) and gradient
compression numerics (``compress``)."""

from .fault import (HeartbeatMonitor, StragglerPolicy, WorkerFailure,
                    run_with_restarts)
from .compress import dequantize_int8, fake_quant_grads, quantize_int8

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "WorkerFailure",
           "run_with_restarts", "dequantize_int8", "fake_quant_grads",
           "quantize_int8"]

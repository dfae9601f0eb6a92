"""Cache substrate on tensors: replacement policies, prefetchers, the
trace simulator, the batched sweep and the streaming engine."""

from .base import (CacheState, Evicted, N_PF_SRC, PF_AMP, PF_MITHRIL,
                   PF_NONE, PF_PG, access, contains, init_cache,
                   insert_prefetch)
from .amp import AmpConfig, AmpState, amp_access, init_amp
from .pg import PgConfig, PgState, init_pg, pg_access
from .simulator import (SimConfig, SimResult, SimSession, Stats,
                        build_segments, build_step, max_hit_ratio, simulate)
from .sweep import (LaneGroup, PaddedSuite, RingBuffer, StreamResult,
                    SweepPlan, SweepResult, build_batched_step, chunk_runner,
                    compile_count, pad_traces, plan_sweep, reset_runners,
                    sweep, sweep_grid, sweep_scheduled, sweep_streaming,
                    wide_plan)

__all__ = [
    "CacheState", "Evicted", "access", "contains", "init_cache",
    "insert_prefetch", "PF_NONE", "PF_MITHRIL", "PF_AMP", "PF_PG", "N_PF_SRC",
    "AmpConfig", "AmpState", "amp_access", "init_amp",
    "PgConfig", "PgState", "init_pg", "pg_access",
    "SimConfig", "SimResult", "SimSession", "Stats", "build_segments",
    "build_step", "max_hit_ratio", "simulate",
    "LaneGroup", "PaddedSuite", "RingBuffer", "StreamResult", "SweepPlan",
    "SweepResult", "build_batched_step", "chunk_runner", "compile_count",
    "pad_traces", "plan_sweep", "reset_runners", "sweep", "sweep_grid",
    "sweep_scheduled", "sweep_streaming", "wide_plan",
]

from repro_torch.traces.generators import (GENERATORS, TraceConfig, BlockAccess,
                                     sharegpt_trace, lmsys_trace,
                                     agentic_trace, workload_sessions)
from repro_torch.traces.replay import replay, run_table_v, ReplayResult

_SERVING_REPLAY = ("ServingReplayConfig", "ServingReplayResult",
                   "run_serving_replay", "run_replay_serving_table")


def __getattr__(name):
    # lazy: serving_replay pulls in jax + the full model/serving stack,
    # which the lightweight block-level trace consumers don't need
    if name in _SERVING_REPLAY:
        from repro_torch.traces import serving_replay
        return getattr(serving_replay, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

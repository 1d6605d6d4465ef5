from repro_torch.serving.continuous import (
    ContinuousResult, serve_continuous, splice_cache)
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import (
    EngineClock, ScheduleResult, run_engine_schedule)

__all__ = ["ContinuousResult", "Engine", "EngineConfig", "EngineClock",
           "ScheduleResult", "run_engine_schedule", "serve_continuous",
           "splice_cache"]

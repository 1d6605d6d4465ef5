from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import (
    EngineClock, ScheduleResult, run_engine_schedule)

__all__ = ["Engine", "EngineConfig", "EngineClock", "ScheduleResult",
           "run_engine_schedule"]

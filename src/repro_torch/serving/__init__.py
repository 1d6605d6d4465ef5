from repro_torch.serving.continuous import (
    ContinuousResult, serve_continuous, splice_cache)
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.metrics import summarize
from repro_torch.serving.router import (
    FleetScheduleResult, FleetScheduler, run_fleet_schedule, summarize_fleet)
from repro_torch.serving.scheduler import (
    ContinuousBatchScheduler, DynamicBatchScheduler, ElasticBatchScheduler,
    EngineClock, FCFSScheduler, FixedBatchScheduler, ModelClock,
    MultiBinBatchScheduler, PolicyScheduler, ScheduleResult,
    SRPTBatchScheduler, WaitBatchScheduler, run_continuous_virtual,
    run_engine_schedule, run_schedule)

__all__ = ["ContinuousBatchScheduler", "ContinuousResult",
           "DynamicBatchScheduler", "ElasticBatchScheduler", "Engine",
           "EngineClock", "EngineConfig", "FCFSScheduler",
           "FixedBatchScheduler", "FleetScheduleResult", "FleetScheduler",
           "ModelClock", "MultiBinBatchScheduler",
           "PolicyScheduler", "SRPTBatchScheduler", "ScheduleResult",
           "WaitBatchScheduler", "run_continuous_virtual",
           "run_engine_schedule", "run_fleet_schedule", "run_schedule",
           "serve_continuous", "splice_cache", "summarize",
           "summarize_fleet"]

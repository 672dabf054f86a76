from repro_torch.serve.engine import Engine, ServeConfig, ServeStats  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    Request, SchedStats, Scheduler, SchedulerConfig)

from repro_torch.serving.scheduler import (
    ADMITTED,
    EVICTION_POLICIES,
    REJECTED_DEADLINE,
    REJECTED_HALTED,
    REJECTED_QUEUE,
    ScheduledRequest,
    SlotEngine,
    drive,
    drop_newest,
    drop_oldest,
    shed_deadline,
)
from repro_torch.serving.faults import (
    SMOKE_PLAN,
    FaultInjector,
    FaultPlan,
    InjectedLaunchError,
)
from repro_torch.serving.engine import Request, ServeEngine, greedy_generate
from repro_torch.serving.pool import ReplicaPool
from repro_torch.serving.sessions import SessionEngine, SessionRequest
from repro_torch.serving.vision import VisionEngine, VisionRequest

__all__ = ["Request", "ServeEngine", "greedy_generate",
           "SessionEngine", "SessionRequest",
           "VisionEngine", "VisionRequest", "ReplicaPool",
           "ScheduledRequest", "SlotEngine",
           "drive", "EVICTION_POLICIES", "drop_newest", "drop_oldest",
           "shed_deadline", "ADMITTED", "REJECTED_DEADLINE",
           "REJECTED_HALTED", "REJECTED_QUEUE",
           "FaultInjector", "FaultPlan", "InjectedLaunchError",
           "SMOKE_PLAN"]

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
from repro_torch.serving.vision import VisionEngine, VisionRequest

__all__ = ["VisionEngine", "VisionRequest", "ScheduledRequest", "SlotEngine",
           "drive", "EVICTION_POLICIES", "drop_newest", "drop_oldest",
           "shed_deadline", "ADMITTED", "REJECTED_DEADLINE",
           "REJECTED_HALTED", "REJECTED_QUEUE"]

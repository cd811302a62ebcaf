"""Runtime substrate: supervised training with checkpoint/restart fault tolerance,
straggler mitigation via deadline barriers, and the failure accounting of the
async server's replicas."""
from repro_torch.runtime.supervisor import (  # noqa: F401
    FailureInjector, ReplicaHealth, RestartTracker, RunResult, Supervisor, WorkerFailure)
from repro_torch.runtime.straggler import DeadlineBarrier, HeartbeatTracker  # noqa: F401

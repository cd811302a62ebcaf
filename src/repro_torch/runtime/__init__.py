"""Runtime substrate of the port: failure injection, restart accounting and
replica health for the async server. The training ``Supervisor`` is not ported
yet."""
from repro_torch.runtime.supervisor import (  # noqa: F401
    FailureInjector, ReplicaHealth, RestartTracker, WorkerFailure)

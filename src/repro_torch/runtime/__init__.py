from repro_torch.runtime.fault import (HeartbeatMonitor, RestartPolicy,
                                       StragglerReport, run_with_restarts)

__all__ = ["HeartbeatMonitor", "RestartPolicy", "StragglerReport",
           "run_with_restarts"]

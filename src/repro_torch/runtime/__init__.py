from repro_torch.runtime.fault import (HeartbeatMonitor, RestartPolicy,
                                       StallWatchdog, StragglerReport,
                                       run_with_restarts)

__all__ = ["HeartbeatMonitor", "RestartPolicy", "StallWatchdog",
           "StragglerReport", "run_with_restarts"]

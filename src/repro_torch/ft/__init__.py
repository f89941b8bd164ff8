from repro_torch.ft.runner import (FaultTolerantTrainer, Preempted,
                                   StragglerMonitor)

__all__ = ["FaultTolerantTrainer", "StragglerMonitor", "Preempted"]

# Shared discrete-event simulation substrate.  Both the Kubernetes cluster
# simulator (repro_torch.cluster) and the serving fleet
# (repro_torch.serving.fleet) are thin domain adapters over this core.
from repro_torch.sim.events import EventQueue
from repro_torch.sim.core import (ArrayServerPool, CompletionLog, ServerPool,
                                  SimCore, WindowAccumulator,
                                  WindowedExporter, account_busy,
                                  drain_window, waterfill_placement)
from repro_torch.sim.chaos import ChaosConfig, ChaosSchedule

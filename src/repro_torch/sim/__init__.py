# Shared discrete-event simulation substrate: the Kubernetes cluster
# simulator (repro_torch.cluster) is a thin domain adapter over this core.
from repro_torch.sim.events import EventQueue
from repro_torch.sim.core import (ArrayServerPool, CompletionLog, ServerPool,
                                  SimCore, WindowAccumulator,
                                  WindowedExporter, account_busy,
                                  drain_window, waterfill_placement)

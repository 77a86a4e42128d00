from repro_torch.workloads.random_access import random_access
from repro_torch.workloads.nasa import nasa_trace, nasa_requests
from repro_torch.workloads.bursty import bursty_trace, bursty_requests
from repro_torch.workloads.fleet_scale import (WindowedArrivals,
                                               poisson_arrivals)
from repro_torch.workloads.scenarios import (ChaosScenario, ClientConfig,
                                             ClosedLoopClient,
                                             make_chaos_scenario)

from repro_torch.serving.engine import DecodeEngine, SlotState
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.fleet import ServingFleet, FleetConfig
from repro_torch.serving.multi_fleet import (ChipBudgetArbiter, FleetSpec,
                                             MultiFleetSim)

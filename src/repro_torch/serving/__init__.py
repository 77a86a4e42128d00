from repro_torch.serving.engine import DecodeEngine, SlotState
from repro_torch.serving.batcher import ContinuousBatcher, Request

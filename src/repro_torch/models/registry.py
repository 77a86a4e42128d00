"""build_model(cfg) -> DecoderLM | EncDecLM."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return DecoderLM(cfg)

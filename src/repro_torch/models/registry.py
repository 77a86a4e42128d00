"""build_model(cfg) -> DecoderLM (the dense and ssm families; the others
raise)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    """The MoE, hybrid and encoder-decoder families raise
    ``NotImplementedError`` naming their ROADMAP.md item."""
    return DecoderLM(cfg)

"""build_model(cfg) -> DecoderLM (the dense family; the others raise)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    """The encoder-decoder family and the non-dense decoders raise
    ``NotImplementedError`` naming their ROADMAP.md item."""
    return DecoderLM(cfg)

"""Sampler of the port's engine: greedy decoding.

Greedy is exact argmax over the raw f32 logits, ties going to the first
index, as in the reference. Seeded sampling (temperature, top-k, top-p)
cannot reproduce the reference's threefry bits and is not ported yet
(ROADMAP queue 1, item 5); asking for it raises.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature > 0 or self.top_k or self.top_p < 1.0:
            raise NotImplementedError(
                "seeded sampling (temperature/top-k/top-p) is not ported "
                "yet: ROADMAP queue 1, item 5; the port decodes greedily")


def sample(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int64 token ids (greedy argmax)."""
    del cfg
    return torch.argmax(logits, dim=-1)

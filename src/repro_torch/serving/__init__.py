"""Serving of the port: the paged block pool, the greedy sampler and the
continuous-batching engine."""

from .engine import Engine, Request  # noqa: F401
from .sampler import SamplerConfig  # noqa: F401

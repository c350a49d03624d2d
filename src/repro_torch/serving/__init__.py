"""Serving of the port: continuous batching over a paged, refcounted,
prefix-shared KV cache.

  Engine            the serving engine (chunked, batched or whole-prompt
                    prefill, paged decode, admission control, preemption,
                    prefix sharing, seeded sampling, speculative decoding)
  Request           one generation request
  BlockPool         host-side refcounting block allocator
  RadixCache        prefix-sharing radix index over the block pool
  ContinuousBatcher legacy fixed-slot API, a shim over Engine
  init_paged_cache  paged cache tree constructor
  SamplerConfig     engine-wide sampler defaults
"""

from .cache import BlockPool, init_paged_cache  # noqa: F401
from .engine import Engine, Request  # noqa: F401
from .radix import RadixCache  # noqa: F401
from .sampler import SamplerConfig  # noqa: F401
from .scheduler import ContinuousBatcher  # noqa: F401

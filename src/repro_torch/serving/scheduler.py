"""The legacy continuous-batching API, a shim over the paged Engine.

The port's counterpart of ``repro/serving/scheduler.py``:
``ContinuousBatcher`` keeps the pre-paged interface (a fixed slot table,
``submit`` / ``step`` / ``run``) and delegates to ``Engine`` with
``prefill="whole"``: one whole-prompt forward per admitted request, which
implies ``prefill_batch`` 1 and no prefix sharing. The pool backs every
slot at full ``max_len``, so nothing is ever preempted, and the queue is
unbounded. The reference's ``sample`` hook is not ported: the engine
decodes greedily unless given a ``SamplerConfig``. ``run`` returns the
engine's ``metrics()``, so the shim reports the engine's counters, and with
a ``tracer`` (an engine keyword) its ``latency`` and ``phases``.
"""

from __future__ import annotations

from .engine import Engine, Request  # noqa: F401  (Request re-exported)


class ContinuousBatcher:
    """Drives the paged Engine with the legacy dense batcher's semantics.

    ``cfg, params`` (model config and packed parameters), ``n_slots`` (the
    decode batch), ``max_len`` (context rows a slot); ``engine_kw`` reaches
    ``Engine`` (a ``sampler``, an ``attn_backend``, ``ring``, a
    ``tracer``)."""

    def __init__(self, cfg, params, *, n_slots: int, max_len: int, **engine_kw):
        block_size = 16
        while max_len % block_size:
            block_size //= 2
        self.engine = Engine(
            cfg, params, n_slots=n_slots, max_len=max_len,
            block_size=block_size,
            n_blocks=n_slots * (max_len // block_size) + 1,  # never preempts
            max_queue=10 ** 9, prefill="whole", prefill_batch=1,
            prefix_cache=False, **engine_kw)
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len

    @property
    def queue(self):
        """The engine's admission deque (pending Request objects)."""
        return self.engine.queue

    @property
    def steps(self) -> int:
        """Decode steps taken so far (legacy name)."""
        return self.engine.decode_steps

    @property
    def busy_slot_steps(self) -> int:
        """Sum over decode steps of the number of active slots."""
        return self.engine.busy_slot_steps

    def submit(self, req: Request) -> bool:
        """Queue a request: True unless the prompt cannot fit a slot (P >
        max_len - 1)."""
        return self.engine.submit(req)

    def step(self) -> int:
        """Admit with whole-prompt prefill, then one batched decode step.
        Returns the number of occupied slots."""
        return self.engine.step()

    def run(self, max_steps: int = 10_000) -> dict:
        """Drain the queue and the slots; returns the engine's
        ``metrics()``."""
        return self.engine.run(max_steps)

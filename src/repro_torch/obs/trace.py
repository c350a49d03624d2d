"""Request-lifecycle tracing and the engine's step-phase timeline.

The port's copy of ``repro/obs/trace.py``, with the same hooks, the same
derived summaries and the same export schema, so that the reference's and
the port's exports of the same hooks under a ``FakeClock`` are
byte-identical.

Host-side only: the tracer is fed from the engine's Python scheduling loop,
stores plain floats and ints, and imports no torch. A hook never
synchronises the device, reads a tensor or launches a kernel, so tracing
cannot change what the engine computes. With no tracer attached every
engine hook is one ``is None`` check.

Time comes from an injectable zero-argument monotonic clock (default
``time.monotonic``); every stamp is relative to the tracer's construction,
so a ``FakeClock`` makes a whole trace deterministic.

Per-request lifecycle (one trace per Request for its whole life, across
preemption and requeue):

  queued    submit -> admit, and again preempt -> re-admit
  prefill   admit -> first token (plus one ``prefill_chunk`` span per
            chunk launch the request took part in)
  decode    first token -> finished (or preempt)
  preempt   instant event each time the request was evicted

Derived per request: queue time, TTFT (submit -> first token), TPOT (mean
inter-token gap), inter-token latencies, end-to-end time, aggregated by
``latency_summary()`` into p50/p95/p99 through ``obs.metrics.summarize``.

Per engine step: a phase breakdown (admit / prefill / draft_prefill /
decode, with evict / preempt / compile sub-slices nested inside whichever
phase triggered them) and gauges sampled at step end (free, used and
tree-held blocks, active slots, queue depth, radix hit ratio).

Exports:

  to_jsonl(path)         one JSON object per line (meta, then requests,
                         then steps)
  to_chrome_trace(path)  Chrome-trace / Perfetto ``trace.json``: step
                         phases on the "engine" process, one thread per
                         request on the "requests" process, gauge counter
                         tracks, and a top-level ``repro`` key with the
                         derived summaries (Perfetto ignores it;
                         ``analysis/report.py trace`` reads it)

Phase times are the host's view. The reference's ``compile:<fn>`` slices
time a jit call that compiled; the port runs eagerly, and its compile
slices time an engine forward during which ``kernels/build.py`` built or
loaded a kernel library on first use. Device work runs asynchronously
until a phase reads a result back (the decode phase's sampled tokens).
"""

from __future__ import annotations

import json
import time
from typing import Optional

from .metrics import summarize

class FakeClock:
    """Deterministic injectable clock: every read advances by ``tick``."""

    def __init__(self, start: float = 0.0, tick: float = 1e-3):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


class Span:
    """One named interval (slotted: one is made per lifecycle transition)."""

    __slots__ = ("name", "t0", "t1")

    def __init__(self, name: str, t0: float, t1: Optional[float] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1}


class _Phase:
    """Timing context for one scheduling phase: a plain slotted object, not
    a @contextmanager generator, which costs more per step."""

    __slots__ = ("tr", "name", "t0")

    def __init__(self, tr: "Tracer", name: str):
        self.tr = tr
        self.name = name

    def __enter__(self):
        tr = self.tr
        if tr._cur is None:                  # phase outside step: still sum
            tr.step_begin(len(tr.steps))
        self.t0 = tr.now()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tr
        t1 = tr.now()
        cur = tr._cur
        cur["phases"][self.name] = \
            cur["phases"].get(self.name, 0.0) + (t1 - self.t0)
        cur["slices"].append((self.name, self.t0, t1))
        return False


class _ReqTrace:
    """One request's whole life (kept across preemption/requeue)."""

    __slots__ = ("uid", "prompt_len", "submitted", "finished", "rejected",
                 "spans", "open", "token_times", "preempt_times",
                 "shared_tokens")

    def __init__(self, uid):
        self.uid = uid
        self.prompt_len: Optional[int] = None
        self.submitted: Optional[float] = None
        self.finished: Optional[float] = None
        self.rejected = False
        self.spans: list[Span] = []
        self.open: dict[str, Span] = {}     # name -> currently-open span
        self.token_times: list[float] = []
        self.preempt_times: list[float] = []
        self.shared_tokens = 0

    def begin(self, name: str, t: float) -> None:
        span = Span(name, t)
        self.open[name] = span
        self.spans.append(span)

    def end(self, name: str, t: float) -> None:
        span = self.open.pop(name, None)
        if span is not None:
            span.t1 = t

    def end_all(self, t: float) -> None:
        for name in list(self.open):
            self.end(name, t)

    # ---- derived ----

    def queue_s(self) -> Optional[float]:
        qs = [s for s in self.spans if s.name == "queued" and s.t1 is not None]
        return sum(s.t1 - s.t0 for s in qs) if qs else None

    def ttft_s(self) -> Optional[float]:
        if self.submitted is None or not self.token_times:
            return None
        return self.token_times[0] - self.submitted

    def itl_s(self) -> list[float]:
        tt = self.token_times
        return [b - a for a, b in zip(tt, tt[1:])]

    def tpot_s(self) -> Optional[float]:
        itl = self.itl_s()
        return sum(itl) / len(itl) if itl else None

    def e2e_s(self) -> Optional[float]:
        if self.submitted is None or self.finished is None:
            return None
        return self.finished - self.submitted

    def summary(self) -> dict:
        return {
            "uid": self.uid,
            "prompt_len": self.prompt_len,
            "shared_tokens": self.shared_tokens,
            "n_tokens": len(self.token_times),
            "n_preempted": len(self.preempt_times),
            "rejected": self.rejected,
            "queue_s": self.queue_s(),
            "ttft_s": self.ttft_s(),
            "tpot_s": self.tpot_s(),
            "e2e_s": self.e2e_s(),
        }


class Tracer:
    """Collects request lifecycle spans and the step-phase timeline (see
    the module docstring). Give it to ``Engine(tracer=...)`` or
    ``engine.attach_tracer(...)``."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else time.monotonic
        self._epoch = self.clock()
        self.requests: dict = {}            # uid -> _ReqTrace (insert order)
        self.steps: list[dict] = []
        self._cur: Optional[dict] = None

    def now(self) -> float:
        return self.clock() - self._epoch

    def _req(self, uid) -> _ReqTrace:
        r = self.requests.get(uid)
        if r is None:
            r = self.requests[uid] = _ReqTrace(uid)
        return r

    # ---------------- request lifecycle hooks ----------------

    def on_submit(self, uid, prompt_len: int) -> None:
        t = self.now()
        r = self._req(uid)
        r.prompt_len = prompt_len
        r.submitted = t
        r.begin("queued", t)

    def on_reject(self, uid, prompt_len: int) -> None:
        r = self._req(uid)
        r.prompt_len = prompt_len
        r.rejected = True

    def on_admit(self, uid, *, shared_tokens: int = 0) -> None:
        t = self.now()
        r = self._req(uid)
        r.shared_tokens = shared_tokens
        r.end("queued", t)
        r.begin("prefill", t)

    def on_prefill_chunk(self, uid, *, start: int, rows: int,
                         t0: float, t1: float) -> None:
        r = self._req(uid)
        span = Span("prefill_chunk", t0, t1)
        r.spans.append(span)

    def on_token(self, uid, token: int, done: bool) -> None:
        t = self.now()
        r = self._req(uid)
        if not r.token_times:                # first token: prefill is over
            r.end("prefill", t)
            r.begin("decode", t)
        r.token_times.append(t)

    def on_preempt(self, uid) -> None:
        t = self.now()
        r = self._req(uid)
        r.preempt_times.append(t)
        r.end_all(t)
        r.begin("queued", t)                 # requeued; same trace continues

    def on_finish(self, uid) -> None:
        t = self.now()
        r = self._req(uid)
        r.end_all(t)
        r.finished = t

    # ---------------- step-phase timeline ----------------

    def step_begin(self, step_ix: int) -> None:
        self._cur = {"step": step_ix, "t0": self.now(),
                     "phases": {}, "slices": []}

    def phase(self, name: str) -> _Phase:
        """Time a (possibly nested) scheduling phase of the current step."""
        return _Phase(self, name)

    def add_slice(self, name: str, t0: float, t1: float) -> None:
        """Record an externally timed sub-slice (a first-use kernel build)."""
        if self._cur is None:
            self.step_begin(len(self.steps))
        self._cur["phases"][name.split(":")[0]] = \
            self._cur["phases"].get(name.split(":")[0], 0.0) + (t1 - t0)
        self._cur["slices"].append((name, t0, t1))

    def step_end(self, gauges: Optional[dict] = None) -> None:
        cur = self._cur
        if cur is None:
            return
        cur["t1"] = self.now()
        cur["gauges"] = dict(gauges or {})
        self.steps.append(cur)
        self._cur = None

    # ---------------- derived summaries ----------------

    def request_summaries(self) -> list[dict]:
        return [r.summary() for r in self.requests.values()]

    def latency_summary(self) -> dict:
        """p50/p95/p99 (+count/mean/min/max) of TTFT, TPOT, inter-token
        latency, queue time, and end-to-end time over all traced requests."""
        reqs = list(self.requests.values())

        def col(fn):
            return [v for v in (fn(r) for r in reqs) if v is not None]

        itl = [v for r in reqs for v in r.itl_s()]
        return {
            "ttft_s": summarize(col(_ReqTrace.ttft_s)),
            "tpot_s": summarize(col(_ReqTrace.tpot_s)),
            "itl_s": summarize(itl),
            "queue_s": summarize(col(_ReqTrace.queue_s)),
            "e2e_s": summarize(col(_ReqTrace.e2e_s)),
        }

    def phase_summary(self) -> dict:
        """Total and per-step-mean seconds per scheduling phase. admit /
        prefill / decode partition the step; evict / preempt / compile are
        sub-slices nested inside them (so the groups overlap by design)."""
        total: dict[str, float] = {}
        for s in self.steps:
            for k, v in s["phases"].items():
                total[k] = total.get(k, 0.0) + v
        n = max(len(self.steps), 1)
        wall = sum(s["t1"] - s["t0"] for s in self.steps)
        return {
            "n_steps": len(self.steps),
            "wall_s": wall,
            "total_s": {k: total[k] for k in sorted(total)},
            "per_step_mean_s": {k: total[k] / n for k in sorted(total)},
        }

    # ---------------- exports ----------------

    def _close_open(self) -> None:
        """Close dangling spans (export during a live run) at `now`."""
        t = self.now()
        for r in self.requests.values():
            for span in r.open.values():
                if span.t1 is None:
                    span.t1 = t

    def to_jsonl(self, path: str) -> None:
        self._close_open()
        with open(path, "w") as fh:
            fh.write(json.dumps({"type": "meta",
                                 "latency": self.latency_summary(),
                                 "phases": self.phase_summary()}) + "\n")
            for r in self.requests.values():
                rec = r.summary()
                rec["type"] = "request"
                rec["spans"] = [s.as_dict() for s in r.spans]
                rec["token_times"] = r.token_times
                rec["preempt_times"] = r.preempt_times
                fh.write(json.dumps(rec) + "\n")
            for s in self.steps:
                rec = {"type": "step", "step": s["step"], "t0": s["t0"],
                       "t1": s["t1"], "phases": s["phases"],
                       "gauges": s["gauges"],
                       "slices": [list(sl) for sl in s["slices"]]}
                fh.write(json.dumps(rec) + "\n")

    def chrome_trace(self) -> dict:
        """Chrome-trace 'JSON object format': engine step phases on pid 0,
        one thread per request on pid 1, gauges as counter tracks. Load in
        Perfetto (ui.perfetto.dev) or chrome://tracing."""
        self._close_open()
        us = 1e6
        ev: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "requests"}},
        ]
        for s in self.steps:
            for name, t0, t1 in s["slices"]:
                ev.append({"name": name, "ph": "X", "pid": 0, "tid": 0,
                           "ts": t0 * us, "dur": max(t1 - t0, 0.0) * us,
                           "cat": "phase"})
            g = s["gauges"]
            if g:
                ts = s["t1"] * us
                blocks = {k: g[k] for k in
                          ("free_blocks", "used_blocks", "tree_blocks")
                          if k in g}
                if blocks:
                    ev.append({"name": "blocks", "ph": "C", "pid": 0,
                               "ts": ts, "args": blocks})
                sched = {k: g[k] for k in ("active_slots", "queue_depth")
                         if k in g}
                if sched:
                    ev.append({"name": "sched", "ph": "C", "pid": 0,
                               "ts": ts, "args": sched})
                if g.get("radix_hit_ratio") is not None:
                    ev.append({"name": "radix_hit_ratio", "ph": "C",
                               "pid": 0, "ts": ts,
                               "args": {"ratio": g["radix_hit_ratio"]}})
        for tid, r in enumerate(self.requests.values()):
            ev.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": f"req {r.uid}"}})
            for span in r.spans:
                if span.t1 is None:
                    continue
                ev.append({"name": span.name, "ph": "X", "pid": 1,
                           "tid": tid, "ts": span.t0 * us,
                           "dur": max(span.t1 - span.t0, 0.0) * us,
                           "cat": "request", "args": {"uid": r.uid}})
            if r.token_times:
                ev.append({"name": "first_token", "ph": "i", "pid": 1,
                           "tid": tid, "ts": r.token_times[0] * us,
                           "s": "t"})
            for t in r.preempt_times:
                ev.append({"name": "preempt", "ph": "i", "pid": 1,
                           "tid": tid, "ts": t * us, "s": "t"})
        return {
            "traceEvents": ev,
            "displayTimeUnit": "ms",
            # extra key (Perfetto and chrome ignore it): the derived
            # summaries, so analysis/report.py renders from the file alone
            "repro": {
                "requests": self.request_summaries(),
                "latency": self.latency_summary(),
                "phases": self.phase_summary(),
            },
        }

    def to_chrome_trace(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)

    def export(self, path: str) -> None:
        """Write ``path``: Chrome-trace JSON, or JSONL when the suffix is
        ``.jsonl``."""
        if path.endswith(".jsonl"):
            self.to_jsonl(path)
        else:
            self.to_chrome_trace(path)

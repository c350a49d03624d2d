"""The port's request tracer (``obs/trace.py``), its metrics additions and
its trace report (``analysis/report.py``) against the reference's, and the
engine's tracer hooks.

The same hook sequence through the reference's ``Tracer`` and the port's,
under a ``FakeClock``, gives byte-identical JSONL and Chrome-trace exports,
and both reports render them alike. On the reduced qwen1.5-0.5b (two
layers, float32, w2a16, int8 pool; the port's own seeded weights, no JAX
needed), with a pool small enough to preempt: the engine gives the same
tokens and counters with and without a tracer, a preempted request's
trace reopens its queued span, a rejected request is traced, and the
``ContinuousBatcher`` shim reports the tracer's summaries. The serve CLI's
``--trace-out`` writes a trace that ``repro_torch.analysis.report trace``
renders.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import torch

from repro.analysis import report as jreport
from repro.obs import FakeClock as JFakeClock, Tracer as JTracer
from repro.obs import metrics as jmetrics
from repro_torch.analysis import report
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.models import lm
from repro_torch.obs import FakeClock, Tracer, metrics
from repro_torch.serving import ContinuousBatcher, Engine, Request


def _drive(tr):
    """A lifecycle of three requests and a rejection over three steps: a
    prefix hit, chunks, tokens, a preemption and re-admission, a nested
    evict / preempt / compile slice, gauges with and without a ratio."""
    tr.on_submit(0, 12)
    tr.on_submit(1, 10)
    tr.on_reject("big", 500)
    tr.step_begin(0)
    with tr.phase("admit"):
        tr.on_admit(0, shared_tokens=8)
        tr.on_admit(1)
    with tr.phase("prefill"):
        t0 = tr.now()
        tr.on_prefill_chunk(0, start=8, rows=4, t0=t0, t1=tr.now())
        tr.on_prefill_chunk(1, start=0, rows=8, t0=t0, t1=tr.now())
    with tr.phase("decode"):
        t0 = tr.now()
        tr.add_slice("compile:decode", t0, tr.now())
        tr.on_token(0, 7, False)
    tr.step_end({"free_blocks": 3, "used_blocks": 2, "tree_blocks": 1,
                 "active_slots": 2, "queue_depth": 0, "radix_hit_ratio": 0.4})
    tr.step_begin(1)
    with tr.phase("decode"):
        with tr.phase("preempt"):
            tr.on_preempt(1)
        tr.on_token(0, 9, True)
        tr.on_finish(0)
    tr.step_end({"free_blocks": 5, "used_blocks": 0, "tree_blocks": 0,
                 "active_slots": 0, "queue_depth": 1, "radix_hit_ratio": None})
    tr.on_submit(2, 4)
    tr.step_begin(2)
    with tr.phase("admit"):
        tr.on_admit(1)
        tr.on_admit(2)
    with tr.phase("decode"):
        for i in range(3):
            tr.on_token(1, 5 + i, i == 2)
        tr.on_finish(1)
        tr.on_token(2, 3, False)          # left open: export closes it
    tr.step_end()


def test_exports_are_byte_identical_to_the_reference(tmp_path):
    ref, port = JTracer(clock=JFakeClock()), Tracer(clock=FakeClock())
    _drive(ref)
    _drive(port)
    assert port.latency_summary() == ref.latency_summary()
    assert port.phase_summary() == ref.phase_summary()
    for name in ("t.jsonl", "t.json"):
        ref.export(str(tmp_path / f"ref_{name}"))
        port.export(str(tmp_path / f"port_{name}"))
        assert (tmp_path / f"port_{name}").read_bytes() == \
            (tmp_path / f"ref_{name}").read_bytes()
        for r in (jreport, report):
            assert r.trace_report(r.load_trace(str(tmp_path / f"port_{name}"))) == \
                jreport.trace_report(jreport.load_trace(str(tmp_path / f"ref_{name}")))


def test_percentile_summarize_and_histograms_match_the_reference():
    xs = np.random.default_rng(0).random(37).tolist()
    for q in (0, 10, 50, 95, 99, 100):
        assert metrics.percentile(xs, q) == jmetrics.percentile(xs, q)
    for vals in ([], [3.0], xs):
        assert metrics.summarize(vals) == jmetrics.summarize(vals)
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        r.observe("h", 1.0, fn="a")
        r.observe("h", 3.0, fn="a")
        r.set_gauge("g", 7, kind="ring")
    assert reg.snapshot() == jreg.snapshot()
    with metrics.scoped() as outer:
        metrics.observe("t_obs", 2.0)
        metrics.set_gauge("t_gauge", 4)
    snap = outer.snapshot()
    assert snap["histograms"]["t_obs"]["count"] == 1 and snap["gauges"]["t_gauge"] == 4


_CFG = {}


def _tiny():
    """Reduced qwen1.5-0.5b, two layers, float32, w2a16, int8 pool, with
    the port's own seeded packed weights."""
    if not _CFG:
        cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-0.5b")),
                                  n_layers=2, dtype="float32", kv_cache_dtype="int8",
                                  quant=qplan.make_plan(w_bits=2))
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", pack=True)
        _CFG["t"] = (cfg, params)
    return _CFG["t"]


def _tight(tracer=None):
    """A pool three requests cannot share: it preempts (the reference's
    tests/test_obs.py::_tight_engine)."""
    cfg, params = _tiny()
    eng = Engine(cfg, params, n_slots=2, max_len=64, block_size=8, chunk_size=8,
                 n_blocks=6, max_queue=8, tracer=tracer)
    reqs = [Request(uid=uid, prompt=np.arange(1, plen + 1), max_new=mnt, priority=pr)
            for uid, (plen, mnt, pr) in enumerate([(12, 10, 0), (10, 12, 5), (9, 8, 0)])]
    for r in reqs:
        assert eng.submit(r)
    return eng, reqs


def test_tracer_leaves_tokens_and_counters_unchanged_and_covers_every_step():
    traced, r1 = _tight(Tracer(clock=FakeClock()))
    plain, r2 = _tight()
    m1, m2 = traced.run(), plain.run()
    assert [r.out for r in r1] == [r.out for r in r2]
    assert m1["metrics"]["counters"] == m2["metrics"]["counters"]
    assert m1["preemptions"] >= 1
    assert "latency" not in m2 and m1["latency"]["ttft_s"]["count"] == 3
    tr = traced.tracer
    assert m1["phases"] == tr.phase_summary()
    assert m1["phases"]["n_steps"] == m1["engine_steps"] == len(tr.steps)
    assert {"admit", "prefill", "decode", "preempt"} <= set(m1["phases"]["total_s"])
    assert all(s["gauges"]["free_blocks"] is not None for s in tr.steps)
    assert all(r.finished is not None for r in tr.requests.values())
    # a preempted request keeps one trace, its queued span reopened
    pre = [r for r in tr.requests.values() if r.preempt_times]
    assert pre
    for r in pre:
        names = [s.name for s in r.spans]
        assert names.count("queued") == 1 + len(r.preempt_times)
        assert all(s.t1 is not None for s in r.spans)
    chunks = sum(1 for r in tr.requests.values() for s in r.spans
                 if s.name == "prefill_chunk")
    assert chunks == m1["prefill_chunks"]             # one request a chunk
    assert sum(len(r.token_times) for r in tr.requests.values()) == \
        sum(len(r.out) for r in r1)


def test_rejected_request_is_traced():
    cfg, params = _tiny()
    tr = Tracer(clock=FakeClock())
    eng = Engine(cfg, params, n_slots=2, max_len=64, block_size=8, tracer=tr)
    assert not eng.submit(Request(uid="long", prompt=np.zeros(64, np.int64)))
    assert tr.requests["long"].rejected and tr.requests["long"].prompt_len == 64
    assert eng.metrics()["latency"]["ttft_s"]["count"] == 0


def test_attach_tracer_and_continuous_batcher_forward_the_summaries():
    cfg, params = _tiny()
    cb = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                           tracer=Tracer(clock=FakeClock()))
    r = Request(uid=0, prompt=[1, 2, 3], max_new=4)
    assert cb.submit(r)
    m = cb.run()
    assert r.done and m["prefill_tokens_computed"] == 3
    assert m["latency"]["ttft_s"]["count"] == 1 and m["phases"]["n_steps"] > 0
    eng, reqs = _tight()
    eng.step()
    eng.attach_tracer(Tracer(clock=FakeClock()))      # after an untraced step
    m = eng.run()
    assert m["phases"]["n_steps"] == m["engine_steps"] - 1


def test_serve_trace_out_writes_a_trace_the_report_renders(tmp_path, capsys):
    path = str(tmp_path / "trace.json")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b",
         "--smoke", "--paged", "--device", "cpu", "--requests", "4", "--gen", "4",
         "--trace-out", path],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr
    assert "4/4 requests" in out.stdout and "latency: ttft_s p50/p95/p99" in out.stdout
    assert f"trace written to {path}" in out.stdout
    assert report.main(["trace", path]) == 0
    txt = capsys.readouterr().out
    assert "# Serving trace: 4 requests (4 accepted, 0 rejected), 16 tokens" in txt
    assert "| ttft |" in txt and "| decode |" in txt

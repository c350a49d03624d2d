"""Report of a serving trace written by the port's tracer.

The port's counterpart of ``repro/analysis/report.py``, its ``trace``
subcommand only (``load_trace`` and ``trace_report``, the reference's
report.py:90-170): it reads a trace that ``serve --trace-out`` wrote,
Chrome-trace JSON or JSONL (obs/trace.py), and renders the latency
percentiles, the step-phase breakdown and the per-request table as
markdown. The reference's roofline subcommand waits for the dry-run
(ROADMAP queue 1, item 11).

  PYTHONPATH=src python -m repro_torch.analysis.report trace trace.json
"""

from __future__ import annotations

import argparse
import json
import sys


def load_trace(path: str) -> dict:
    """Normalize either trace format to {latency, phases, requests}.

    Chrome-trace JSON carries the derived summaries under the extra
    top-level ``repro`` key (Perfetto ignores it); JSONL carries a ``meta``
    line plus one ``request`` record per traced request."""
    with open(path) as fh:
        if path.endswith(".jsonl"):
            latency, phases, requests = {}, {}, []
            for line in fh:
                rec = json.loads(line)
                if rec.get("type") == "meta":
                    latency = rec.get("latency", {})
                    phases = rec.get("phases", {})
                elif rec.get("type") == "request":
                    requests.append(rec)
            return {"latency": latency, "phases": phases,
                    "requests": requests}
        doc = json.load(fh)
    repro = doc.get("repro")
    if repro is None:
        raise SystemExit(
            f"{path}: no 'repro' summary key: not a trace written by the "
            "port's Tracer (obs/trace.py)")
    return repro


def _ms(x) -> str:
    return "—" if x is None else f"{1e3 * x:.1f}"


def trace_report(doc: dict) -> str:
    reqs = doc.get("requests", [])
    lat = doc.get("latency", {})
    ph = doc.get("phases", {})
    done = sum(1 for r in reqs if not r.get("rejected"))
    npre = sum(r.get("n_preempted", 0) for r in reqs)
    ntok = sum(r.get("n_tokens", 0) for r in reqs)
    out = [f"# Serving trace: {len(reqs)} requests "
           f"({done} accepted, {len(reqs) - done} rejected), "
           f"{ntok} tokens, {npre} preemptions",
           "",
           "## Latency percentiles (ms)",
           "",
           "| stat | count | mean | p50 | p95 | p99 | max |",
           "|---|---|---|---|---|---|---|"]
    for stat in ("queue_s", "ttft_s", "tpot_s", "itl_s", "e2e_s"):
        s = lat.get(stat)
        if not s:
            continue
        out.append(f"| {stat[:-2]} | {s['count']} | {_ms(s['mean'])} | "
                   f"{_ms(s['p50'])} | {_ms(s['p95'])} | {_ms(s['p99'])} | "
                   f"{_ms(s['max'])} |")
    if ph:
        out += ["", f"## Step phases ({ph.get('n_steps', 0)} engine steps, "
                    f"{ph.get('wall_s', 0):.3f}s wall)",
                "",
                "| phase | total s | mean ms/step |",
                "|---|---|---|"]
        means = ph.get("per_step_mean_s", {})
        for k, v in sorted(ph.get("total_s", {}).items()):
            out.append(f"| {k} | {v:.4f} | {_ms(means.get(k))} |")
    if reqs:
        out += ["", "## Requests", "",
                "| uid | prompt | shared | tokens | preempts | "
                "queue ms | ttft ms | tpot ms | e2e ms |",
                "|---|---|---|---|---|---|---|---|---|"]
        for r in reqs:
            if r.get("rejected"):
                out.append(f"| {r['uid']} | {r['prompt_len']} | — | — | — | "
                           "rejected | | | |")
                continue
            out.append(
                f"| {r['uid']} | {r['prompt_len']} | "
                f"{r.get('shared_tokens', 0)} | {r.get('n_tokens', 0)} | "
                f"{r.get('n_preempted', 0)} | {_ms(r.get('queue_s'))} | "
                f"{_ms(r.get('ttft_s'))} | {_ms(r.get('tpot_s'))} | "
                f"{_ms(r.get('e2e_s'))} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Report of a serving trace.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_trace = sub.add_parser("trace", help="serving-trace report")
    ap_trace.add_argument("file", help="trace.json / trace.jsonl from serve "
                                       "--trace-out")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    print(trace_report(load_trace(args.file)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Compare bs_sweep.py runs of two or more trees, row by row.

  python3 sweep_compare.py parent=p1.txt,p2.txt,p3.txt change=c1.txt,c2.txt,c3.txt

Each argument names a tree and the bs_sweep.py outputs of its runs (the
trees run in turns within one call to the card, as bs_sweep.py's --src
describes). For every row (op, configuration, E, M, K, N at the chosen
tiling) it prints each tree's median kernel time, its ratio to the first
tree's median, and the first tree's own spread (slowest / fastest run);
then, for each later tree, the range and median of the ratios and the
rows whose runs all lie above (slower) or all below (faster) every run of
the first tree, with the margin between the ranges. With ``--plain`` it
compares the plain versions' times (``plain=``) instead.
"""

from __future__ import annotations

import re
import statistics
import sys

ROW = re.compile(r"^\s+(\w+)\s+(\S+)\s+(?:E=(\S+)\s+)?M=(\d+)\s+K=(\d+)\s+N=(\d+)\s")


def read(path: str, plain: bool) -> dict:
    rows = {}
    with open(path) as f:
        for line in f:
            if line.startswith("["):
                if "sweep" in line:         # only the chosen tiling's rows
                    break
                continue
            m = ROW.match(line)
            t = re.search(r"\splain=\s*([\d.]+)us" if plain else r"\skernel=\s*([\d.]+)us", line)
            if m and t:
                key = (f"{m.group(1)} {m.group(2)} E={m.group(3) or 1} M={m.group(4)} "
                       f"K={m.group(5)} N={m.group(6)}")
                rows[key] = float(t.group(1))
    return rows


def main(argv: list[str]) -> int:
    plain = "--plain" in argv
    trees = [a.split("=", 1) for a in argv if not a.startswith("--")]
    if len(trees) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = {name: [read(p, plain) for p in files.split(",")] for name, files in trees}
    names = [name for name, _ in trees]
    base = names[0]
    keys = [k for k in runs[base][0] if all(k in r for n in names for r in runs[n])]
    ratios = {n: [] for n in names[1:]}
    above = {n: [] for n in names[1:]}
    below = {n: [] for n in names[1:]}
    for k in keys:
        b = [r[k] for r in runs[base]]
        text = f"{k:52s} {base} {statistics.median(b):9.2f} (spread {max(b) / min(b):.3f})"
        for n in names[1:]:
            v = [r[k] for r in runs[n]]
            q = statistics.median(v) / statistics.median(b)
            ratios[n].append(q)
            text += f" | {n} {statistics.median(v):9.2f} x{q:.3f}"
            if min(v) > max(b):
                above[n].append((k, min(v) / max(b)))
                text += " SLOWER"
            elif max(v) < min(b):
                below[n].append((k, min(b) / max(v)))
                text += " faster"
        print(text)
    spread = [max(b) / min(b) for b in ([r[k] for r in runs[base]] for k in keys)]
    print(f"[{len(keys)} rows; {base}'s spread: median {statistics.median(spread):.3f}, "
          f"largest {max(spread):.3f}]")
    for n in names[1:]:
        q = ratios[n]
        print(f"{n} / {base}: x{min(q):.3f}-x{max(q):.3f}, median x{statistics.median(q):.3f}; "
              f"all runs slower at {len(above[n])} rows, all faster at {len(below[n])}")
        for k, gap in above[n]:
            print(f"  slower: {k} (fastest {n} run {gap:.3f}x the slowest {base} run)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

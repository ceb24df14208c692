"""Summarize an observability trace (and optionally cross-check a snapshot)
(counterpart of ``repro.launch.obs_report``, pure Python: reading a trace
needs no JAX).

  PYTHONPATH=src python -m repro_torch.launch.obs_report /tmp/trace.jsonl \
      [--snapshot /tmp/snap.json] [--to-json /tmp/trace.chrome.json]

Reads the Chrome-trace JSONL written by ``--trace-out`` (one event object
per line, Trace Event Format phases X/i/C/M) and prints a human summary:
event counts, per-phase wall-time by span name, request outcomes, tier
transitions, and the last shadow rel-err counter samples.

Exit codes (CI smoke-gates on these):
  0  trace parsed and non-trivial
  2  empty trace, no parseable events, or malformed lines
  3  ``--snapshot`` reconciliation failed (tiers in the snapshot's
     tokens_by_tier disagree with tiers seen in the trace spans)

``--to-json`` re-emits the events as a single Chrome JSON array file that
``chrome://tracing`` / Perfetto load directly.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter, defaultdict


def load_events(path: str):
    """Parse JSONL trace events. Returns (events, n_bad_lines)."""
    events, bad = [], 0
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError as e:
        print(f"obs_report: cannot open {path}: {e}", file=sys.stderr)
        return [], 1
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if not isinstance(ev, dict) or "ph" not in ev \
                    or "name" not in ev:
                bad += 1
                continue
            events.append(ev)
    return events, bad


def summarize(events) -> dict:
    """Aggregate the parsed events into the printed/reconciled summary."""
    by_phase = Counter(e["ph"] for e in events)
    span_ms = defaultdict(float)
    span_n = Counter()
    step_tiers = Counter()      # device_step:<tier> -> count
    outcomes = Counter()
    transitions = []
    shed = 0
    shadow_last = {}
    for e in events:
        ph, name = e["ph"], e["name"]
        if ph == "X":
            span_n[name] += 1
            span_ms[name] += e.get("dur", 0) / 1e3
            if name.startswith("device_step:"):
                step_tiers[name.split(":", 1)[1]] += 1
            elif name == "request":
                outcomes[e.get("args", {}).get("outcome", "ok")] += 1
        elif ph == "i":
            if name == "tier_transition":
                a = e.get("args", {})
                transitions.append((a.get("step"), a.get("tier")))
            elif name == "shed":
                shed += 1
        elif ph == "C" and name == "shadow_rel_err":
            shadow_last = e.get("args", {})
    return {"by_phase": dict(by_phase), "span_ms": dict(span_ms),
            "span_n": dict(span_n), "step_tiers": dict(step_tiers),
            "outcomes": dict(outcomes), "transitions": transitions,
            "shed": shed, "shadow_last": shadow_last}


def reconcile(summary: dict, snapshot: dict):
    """Check the snapshot's tokens_by_tier against tiers seen in the trace.

    Every tier that emitted tokens per the harvested device counters must
    have at least one ``device_step:<tier>`` span in the trace (and vice
    versa for tiers that stepped enough to harvest). Returns a list of
    mismatch strings (empty = reconciled).
    """
    problems = []
    harvest = snapshot.get("harvest", {})
    tok_by_tier = {t: v for t, v in
                   harvest.get("tokens_by_tier", {}).items() if v}
    traced = summary["step_tiers"]
    for t in tok_by_tier:
        if t not in traced:
            problems.append(
                f"tier {t!r} emitted {tok_by_tier[t]} tokens per snapshot "
                f"but has no device_step span in the trace")
    snap_total = harvest.get("tokens_total")
    if snap_total is not None and tok_by_tier:
        s = sum(tok_by_tier.values())
        if s != snap_total:
            problems.append(
                f"tokens_by_tier sums to {s} but tokens_total is "
                f"{snap_total}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.obs_report",
        description="summarize a --trace-out observability trace")
    ap.add_argument("trace", help="JSONL trace written by --trace-out")
    ap.add_argument("--snapshot", default=None,
                    help="metrics snapshot JSON to reconcile against")
    ap.add_argument("--to-json", default=None, metavar="PATH",
                    help="also write a Chrome JSON array trace to PATH")
    args = ap.parse_args(argv)

    events, bad = load_events(args.trace)
    if bad:
        print(f"obs_report: {bad} malformed line(s) in {args.trace}",
              file=sys.stderr)
        return 2
    if not events:
        print(f"obs_report: no events in {args.trace}", file=sys.stderr)
        return 2

    s = summarize(events)
    print(f"trace {args.trace}: {len(events)} events "
          f"(phases {s['by_phase']})")
    if s["step_tiers"]:
        steps = ", ".join(f"{t}:{n}" for t, n in
                          sorted(s["step_tiers"].items()))
        print(f"  device steps by tier: {steps}")
    for name in sorted(s["span_ms"], key=s["span_ms"].get, reverse=True):
        print(f"  span {name:<24s} n={s['span_n'][name]:<5d} "
              f"total {s['span_ms'][name]:9.2f} ms")
    if s["outcomes"]:
        print(f"  request outcomes: {s['outcomes']}  (shed events: "
              f"{s['shed']})")
    if s["transitions"]:
        path = " -> ".join(f"{t}@{step}" for step, t in s["transitions"])
        print(f"  tier transitions: {path}")
    if s["shadow_last"]:
        live = ", ".join(f"{t}:{v:.3e}" for t, v in
                         sorted(s["shadow_last"].items()))
        print(f"  last shadow rel-err by tier: {live}")

    if args.to_json:
        with open(args.to_json, "w", encoding="utf-8") as fh:
            json.dump({"traceEvents": events}, fh)
        print(f"  wrote chrome trace: {args.to_json}")

    if args.snapshot:
        try:
            with open(args.snapshot, "r", encoding="utf-8") as fh:
                snap = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"obs_report: cannot read snapshot {args.snapshot}: {e}",
                  file=sys.stderr)
            return 3
        problems = reconcile(s, snap)
        if problems:
            for p in problems:
                print(f"obs_report: RECONCILE FAIL: {p}", file=sys.stderr)
            return 3
        print(f"  snapshot {args.snapshot}: reconciled "
              f"(tokens_by_tier consistent with traced tiers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

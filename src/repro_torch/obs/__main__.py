"""CLI: render the per-request latency table from an exported trace.

    python -m repro_torch.obs report trace.json [--json]

Port of `python -m repro.obs`.  Reads the `repro_records` block a
ServeTracer embeds alongside the Chrome `traceEvents` (the trace stays
Perfetto-loadable; the records carry the derived quantities so the table
needs no span re-assembly) and prints one row per request — queue wait,
ttft, inter-token p50/p99, prefill vs decode split, finish reason — plus
the run summary.  `--json` dumps the records + summary as JSON instead
of the table.
"""
from __future__ import annotations

import argparse
import json
import sys

COLUMNS = [
    ("rid", "rid", "d"),
    ("prompt", "prompt_len", "d"),
    ("toks", "tokens", "d"),
    ("queue_ms", "queue_wait_s", "ms"),
    ("ttft_ms", "ttft_s", "ms"),
    ("itl_p50_ms", "inter_token_p50_s", "ms"),
    ("itl_p99_ms", "inter_token_p99_s", "ms"),
    ("prefill_ms", "prefill_s", "ms"),
    ("decode_ms", "decode_s", "ms"),
    ("total_ms", "total_s", "ms"),
    ("reason", "finish_reason", "s"),
]


def _fmt(value, kind: str) -> str:
    if value is None:
        return "-"
    if kind == "ms":
        return f"{value * 1e3:.2f}"
    if kind == "d":
        return f"{value:d}"
    return str(value)


def format_table(records: list) -> str:
    rows = [[head for head, _, _ in COLUMNS]]
    for rec in records:
        rows.append([_fmt(rec.get(key), kind)
                     for _, key, kind in COLUMNS])
    widths = [max(len(r[i]) for r in rows) for i in range(len(COLUMNS))]
    return "\n".join(
        "  ".join(cell.rjust(w) for cell, w in zip(row, widths))
        for row in rows)


def report(path: str, as_json: bool = False) -> int:
    with open(path) as f:
        doc = json.load(f)
    records = doc.get("repro_records")
    if records is None:
        print(f"{path}: no repro_records block — was this trace "
              f"exported by repro_torch.obs.ServeTracer.export_chrome_trace?",
              file=sys.stderr)
        return 1
    summary = doc.get("repro_summary", {})
    if as_json:
        print(json.dumps({"records": records, "summary": summary},
                         indent=1))
        return 0
    print(format_table(records))
    if summary:
        occ = summary.get("occupancy")
        print(f"\n{summary.get('finished')}/{summary.get('requests')} "
              f"requests finished, {summary.get('tokens')} tokens over "
              f"{summary.get('steps')} engine steps"
              + ("" if occ is None else f", mean occupancy {occ:.2f}"))
        for key in ("ttft_ms", "inter_token_ms", "queue_wait_ms"):
            ps = summary.get(key) or {}
            print(f"  {key}: p50={ps.get('p50')} p99={ps.get('p99')}")
    unclosed = [r["rid"] for r in records if not r.get("closed")]
    if unclosed:
        print(f"  WARNING: unfinished request span(s): {unclosed}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="request-lifecycle trace reporting")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report",
                         help="per-request latency table from a trace")
    rep.add_argument("trace", help="trace.json written by --trace-out "
                                   "or ServeTracer.export_chrome_trace")
    rep.add_argument("--json", action="store_true",
                     help="emit records + summary as JSON, not a table")
    args = ap.parse_args(argv)
    return report(args.trace, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())

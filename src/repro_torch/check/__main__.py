"""CLI: run every analyzer pass, print findings, write the JSON report.

    python -m repro_torch.check [--strict] [--json PATH]
                                [--only autograd,bounds,smem,registry,lint]
                                [--device cuda|cpu]

Exit status: 0 when clean (always, without --strict); --strict exits 1 on
any finding.  The default device is the card; without one the run raises
unless `--device cpu` asks for the static part alone.  The report carries
the findings and the coverage records that show what was audited.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.check import PASSES, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="static kernel-contract analyzer of the port")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any finding")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the JSON report here")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of passes "
                         f"({','.join(PASSES)})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): also the card half; cpu: the "
                         "static part alone")
    args = ap.parse_args(argv)

    only = None
    if args.only:
        only = {p.strip() for p in args.only.split(",") if p.strip()}
        unknown = only - set(PASSES)
        if unknown:
            ap.error(f"unknown pass(es) {sorted(unknown)}; "
                     f"known: {sorted(PASSES)}")

    report = run_all(only=only, device=args.device)
    for f in report["findings"]:
        print(f"{f['rule']} {f['where']}: {f['detail']}")
    audited = [c for c in report["coverage"] if "impl" in c]
    print(f"check,done,{len(report['findings'])} findings,"
          f"{len(audited)} (family,impl) cells audited,"
          f"device {report['device']}")

    if args.json:
        parent = os.path.dirname(args.json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"check,report,{args.json}")

    if args.strict and report["findings"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

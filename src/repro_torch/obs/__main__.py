"""``python -m repro_torch.obs report <result.json> [...]`` renders the
telemetry envelope of result JSON files (the port's or the reference's) and
exits 0 on a readable file: the report is a diagnostic, not a gate."""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .report import report_file


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render telemetry from result JSON")
    rep.add_argument("paths", nargs="+", help="ExperimentResult JSON files")
    args = p.parse_args(argv)
    if args.cmd == "report":
        for path in args.paths:
            print(report_file(path))
    return 0


if __name__ == "__main__":
    sys.exit(main())

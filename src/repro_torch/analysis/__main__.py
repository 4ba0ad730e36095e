"""``python -m repro_torch.analysis`` — the port's static-analysis gate.

Runs both layers (the contract passes over every registered strategy /
workload / aggregator / metric, then the repo AST lint) and prints the
findings — human-readable by default, ``--json`` for machines.  Exit code 0
iff no error-severity findings.  ``--device`` is where the passes trace
(default: the card; ``--device cpu`` on a host without one).
"""
from __future__ import annotations

import argparse
import sys

from .ast_checks import run_repo_checks
from .contracts import check_registries
from .diagnostics import Findings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Registry contract verifier + repo AST lint")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    parser.add_argument("--no-contracts", action="store_true",
                        help="skip the contract passes")
    parser.add_argument("--no-ast", action="store_true",
                        help="skip the repo AST lint")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress info-severity findings in text output")
    parser.add_argument("--root", default=None,
                        help="repo root for the AST layer (default: derived "
                             "from the package location)")
    parser.add_argument("--device", default=None,
                        help="device the contract passes trace on (default: "
                             "cuda)")
    args = parser.parse_args(argv)

    findings = Findings()
    if not args.no_contracts:
        findings.extend(check_registries(device=args.device))
    if not args.no_ast:
        findings.extend(run_repo_checks(args.root))

    if args.json:
        print(findings.to_json(indent=2))
    else:
        shown = Findings(d for d in findings
                         if not (args.quiet and d.severity == "info"))
        print(shown.render())
        errs = len(findings.errors())
        print(f"-- {len(findings)} finding(s), {errs} error(s)")
    return 1 if findings.errors() else 0


if __name__ == "__main__":
    sys.exit(main())

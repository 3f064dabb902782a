"""``python -m repro_torch.analysis`` — the port's lint gate.

With no arguments, runs the full rule catalog over the ``repro_torch``
package source (``src/repro_torch`` in a checkout).  Exit codes, as
`repro`'s: 0 = clean, 1 = findings, 2 = bad invocation.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.engine import analyze_paths, findings_json
from repro_torch.analysis.rules import all_rules


def _default_target() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST contract checker of the port: fake rules and obs "
                    "calls, determinism, collective discipline, kernel "
                    "bindings and triples, instrumentation drift, guard "
                    "hygiene.")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze "
                         "(default: the repro_torch package source)")
    ap.add_argument("--root", default=None,
                    help="project root for vocabulary discovery "
                         "(obs/registry.py, guard/chaos.py, …); "
                         "defaults to the common path of the targets")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--output", default=None, metavar="FILE",
                    help="also write the JSON findings report to FILE")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id:<8s} {r.name}  (repro {r.repro_id})")
            print(f"         {r.rationale}")
        return 0

    paths = args.paths or [_default_target()]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    diags = analyze_paths(paths, root=args.root, rules=rules)
    report = findings_json(diags, rules=rules)
    if args.output:
        d = os.path.dirname(args.output)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.output, "w") as f:
            f.write(report)
    if args.format == "json":
        print(report)
    else:
        for diag in diags:
            print(diag.render())
        n_files = len({d.path for d in diags})
        if diags:
            print(f"\n{len(diags)} finding(s) in {n_files} file(s)")
        else:
            print("repro_torch.analysis: clean "
                  f"({len(rules)} rules over {', '.join(paths)})")
    return 1 if diags else 0


if __name__ == "__main__":
    sys.exit(main())

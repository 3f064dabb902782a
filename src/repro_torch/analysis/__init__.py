"""`repro_torch.analysis` — the port's AST contract checker (port of
`repro.analysis`).

The port has conventions that runtime tests see only on the paths they
happen to run: ``register_fake`` rules and obs calls read no device
values, every random draw takes an explicit generator, protocol functions
issue one collective a sweep, axis names come from the meshes and rule
tables, every kernel ships as a cuda/ref/ops triple whose ctypes
prototypes match their CUDA functions and whose dispatch never falls back,
and every span, metric, chaos site and guard code is declared.  This
package checks all of them at lint time, on every code path:

* :mod:`repro_torch.analysis.engine` — the visitor framework: per-file AST
  walk with scope tracking (rules know when they are inside a
  ``register_fake`` rule, a ``group``/``rules`` protocol function, a
  kernel's ``ref.py``, a loop body), ``# repro: ignore[RULE]``
  suppressions, JSON + human diagnostics.
* :mod:`repro_torch.analysis.rules` — the rule catalog (see
  ``src/repro_torch/analysis/README.md``).
* ``python -m repro_torch.analysis`` — the CLI; runs the full catalog over
  ``src/repro_torch`` and exits non-zero on findings.
"""

from repro_torch.analysis.engine import (
    Diagnostic,
    Project,
    Rule,
    analyze_paths,
    analyze_source,
)
from repro_torch.analysis.rules import all_rules

__all__ = ["Diagnostic", "Project", "Rule", "analyze_paths",
           "analyze_source", "all_rules"]

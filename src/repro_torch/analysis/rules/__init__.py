"""The rule catalog: one counterpart for each of `repro`'s 13 rules.  Ids
are stable (suppressions reference them); a rule that is `repro`'s keeps
its id, one whose torch form differs takes the 1xx number of its family
(``repro_id`` names `repro`'s).  See ``src/repro_torch/analysis/README.md``
for the table."""

from repro_torch.analysis.rules.collective_rules import (CollectiveInLoop,
                                                         UnknownAxisName)
from repro_torch.analysis.rules.determinism_rules import (SetIterationOrder,
                                                          UnseededRandom,
                                                          WallClock)
from repro_torch.analysis.rules.guard_rules import (GuardCodeDiscipline,
                                                    UnknownChaosSite)
from repro_torch.analysis.rules.kernel_rules import BindingArity, KernelTriple
from repro_torch.analysis.rules.obs_rules import (UndeclaredSpan,
                                                  UnregisteredMetric)
from repro_torch.analysis.rules.trace_rules import HostSync, ValueBranch

_CATALOG = (
    HostSync,
    ValueBranch,
    WallClock,
    UnseededRandom,
    SetIterationOrder,
    CollectiveInLoop,
    UnknownAxisName,
    BindingArity,
    KernelTriple,
    UndeclaredSpan,
    UnregisteredMetric,
    UnknownChaosSite,
    GuardCodeDiscipline,
)


def all_rules() -> list:
    """Fresh instances of every catalog rule (rules may carry per-run
    state for ``observe_module``/``finalize``)."""
    return [cls() for cls in _CATALOG]


def rule_ids() -> list:
    return [cls.id for cls in _CATALOG]

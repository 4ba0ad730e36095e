"""Static analysis for the registry axes (``python -m repro_torch.analysis``).

The port of ``repro.analysis``: two layers over one :class:`Diagnostic`
vocabulary (the reference's codes):

* **Contract passes over aten graphs** (:mod:`repro_torch.analysis.contracts`)
  — every registered strategy / workload / aggregator / metric runs over
  fake tensors: SelectionResult and ``materialize`` schemas, static budgets,
  traceability, host round trips, seeded keys, and the block-separability
  classification (:mod:`repro_torch.analysis.separability`) that
  ``repro_torch.fl.population``'s block engines gate on.
* **Repo AST lint** (:mod:`repro_torch.analysis.ast_checks`) — engine
  payload-agnosticism, import-time-only registration, slow markers on
  compile-heavy tests, no numpy in traced bodies.

Entry points: ``python -m repro_torch.analysis`` (CI),
``ExperimentSpec.validate(deep=True)`` (before a run, exactly the spec's
resolved entries), and the ``check=True`` keyword on ``register_strategy``
/ ``register_workload`` / ``register_aggregator`` / ``register_metric``
(registration-time opt-in).  Each takes ``device`` (``None``: the card).
"""
from .contracts import (assert_aggregator_contract, assert_metric_contract,
                        assert_strategy_contract, assert_workload_contract,
                        check_aggregator, check_metric, check_registries,
                        check_spec, check_strategy, check_workload)
from .diagnostics import ContractError, Diagnostic, Findings
from .separability import SeparabilityVerdict, classify_strategy
from .ast_checks import run_repo_checks

__all__ = [
    "ContractError", "Diagnostic", "Findings",
    "SeparabilityVerdict", "classify_strategy",
    "check_strategy", "check_workload", "check_aggregator", "check_metric",
    "check_spec", "check_registries",
    "assert_strategy_contract", "assert_workload_contract",
    "assert_aggregator_contract", "assert_metric_contract",
    "run_repo_checks",
]

"""Structured findings shared by every analysis layer.

The contract passes over aten graphs (repro_torch.analysis.contracts), the
block-separability classifier (repro_torch.analysis.separability) and the
repo AST lint (repro_torch.analysis.ast_checks) all report through one
:class:`Diagnostic` shape, so ``python -m repro_torch.analysis`` can render
them uniformly (text or JSON) and ``ExperimentSpec.validate(deep=True)`` can
raise one :class:`ContractError` carrying the full finding list instead of
whatever stack trace the first bad registry entry would have produced
mid-round.  The codes and their meanings are the reference's
(``repro.analysis.diagnostics``); where the reference speaks of a jaxpr,
the port reads the aten graph ``make_fx`` traces over fake tensors.

Diagnostic codes (stable — tests pin them):

==========  ==========================================================
``A001``    strategy untraceable (data-dependent control flow or
            host conversion under the fake tracer)
``A002``    strategy raised a non-tracer error under abstract eval
``A003``    SelectionResult schema violation (mask/scores/order)
``A004``    SelectionResult.budget is not a static Python int
``A005``    host round trip in a traced body (copy to the host,
            ``.numpy()``, ``.tolist()``: the port's callback)
``A006``    constant-seeded PRNG inside a traced body
            (``rng.PRNGKey``'s ``repro_torch::random_seed`` node)
``A007``    block-separability classification (info — never an error)
``A101``    workload ``materialize`` schema violation
``A102``    workload untraceable (materialize/init/loss/eval)
``A103``    workload eval metrics missing ``"accuracy"``
``A201``    aggregator ``reduce`` schema violation
``A202``    aggregator untraceable
``A301``    metric fn untraceable over the canonical round state
``A302``    metric output schema violation (leaves / size / axes rank)
``L001``    engine module imports model/dataset code
``L002``    registry mutated outside ``register_*`` at import time
``L003``    compile-heavy test missing ``@pytest.mark.slow``
``L004``    numpy call inside a traced (``torch.func`` /
            ``autograd.Function``) function body
==========  ==========================================================
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Iterator, List

SEVERITIES = ("error", "warning", "info")

KINDS = ("strategy", "workload", "aggregator", "engine", "transform", "file",
         "metric")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analysis finding: stable code + severity + subject + message.

    ``kind``/``name`` identify the subject — a registry entry (``kind`` one
    of the registry axes, ``name`` the registered name) or a source
    file (``kind="file"``, ``name`` the repo-relative path).  ``detail`` is
    a JSON-able payload of machine-readable evidence (shapes, dtypes, line
    numbers, aten op names …)."""
    code: str
    severity: str
    kind: str
    name: str
    message: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}; "
                             f"got {self.severity!r}")
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}; got {self.kind!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "severity": self.severity,
                "kind": self.kind, "name": self.name,
                "message": self.message, "detail": dict(self.detail)}

    def render(self) -> str:
        loc = f":{self.detail['line']}" if "line" in self.detail else ""
        return (f"{self.severity:7s} {self.code} "
                f"{self.kind}:{self.name}{loc} — {self.message}")


class Findings:
    """An ordered collection of :class:`Diagnostic` with render helpers."""

    def __init__(self, items: Iterable[Diagnostic] = ()):
        self._items: List[Diagnostic] = list(items)

    def append(self, d: Diagnostic) -> None:
        self._items.append(d)

    def extend(self, ds: Iterable[Diagnostic]) -> None:
        self._items.extend(ds)

    def add(self, code: str, severity: str, kind: str, name: str,
            message: str, **detail: Any) -> None:
        self.append(Diagnostic(code, severity, kind, name, message, detail))

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self._items if d.severity == "error"]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self._items if d.code == code]

    def to_json(self, **json_kw: Any) -> str:
        return json.dumps({"findings": [d.to_dict() for d in self._items],
                           "errors": len(self.errors())}, **json_kw)

    def render(self) -> str:
        if not self._items:
            return "no findings"
        return "\n".join(d.render() for d in self._items)


class ContractError(ValueError):
    """A registry entry violates its contract — raised by
    ``ExperimentSpec.validate(deep=True)`` and the ``check=True``
    registration paths, carrying the structured findings instead of the
    stack trace the violation would otherwise produce mid-round."""

    def __init__(self, findings: Findings):
        self.findings = findings
        self.diagnostics = list(findings)
        errs = findings.errors()
        super().__init__(
            f"{len(errs)} registry contract violation(s):\n"
            + "\n".join(d.render() for d in errs))

"""Repo-specific AST lint — rules a generic linter can't know.

The port of ``repro/analysis/ast_checks.py``, over the port's tree.  Four
rules, each encoding an architectural invariant this codebase's design
depends on (diagnostic codes L001–L004, see
repro_torch.analysis.diagnostics):

* **L001 — engines are payload-agnostic.**  The engine modules
  (``src/repro_torch/fl/{sim,sharded,population,loop,round}.py``) must not
  import model or dataset code (``repro_torch.models``, or the dataset and
  model names below, by absolute or relative import): everything
  model-shaped reaches them through the workload registry.

* **L002 — registries mutate only through ``register_*`` at import time.**
  Direct subscript writes to a registry dict outside its home module, or a
  ``register_*`` call inside a function/method body (registration order is
  the append-only id ledger — it must be deterministic, i.e. import-time),
  are flagged.  Test files are exempt (they register throwaway entries).

* **L003 — compile-heavy tests carry ``@pytest.mark.slow``.**  A test that
  forces a multi-device topology (``xla_force_host_platform_device_count``)
  recompiles the whole engine stack and belongs in the weekly tier; the
  marker is what keeps tier-1 fast.  It scans ``tests/`` as the reference
  does.

* **L004 — no numpy ops inside traced function bodies.**  A traced body is
  a function whose own body calls a ``torch.func`` transform (``vmap``,
  ``grad``, ``grad_and_value``, ``vjp``, ``functional_call``), or the
  ``forward``/``backward``/``vmap`` of a ``torch.autograd.Function``; it
  must not call ``np.*`` — numpy cannot see a batched or fake tensor, and
  bakes host constants into a body that runs per client or per launch.
  Dtype constructors (``np.float32(x)`` …) are allowed.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional

from .diagnostics import Findings

# -- rule tables ------------------------------------------------------------

ENGINE_MODULES = tuple(f"src/repro_torch/fl/{m}.py" for m in (
    "sim", "sharded", "population", "loop", "round"))

# Model/dataset surface engines must never touch directly.
FORBIDDEN_ENGINE_MODULES = ("repro_torch.models",)
FORBIDDEN_ENGINE_NAMES = frozenset({
    "ImageDataset", "TokenDataset", "materialize_round", "cnn_init",
    "cnn_loss", "cnn_batch_loss"})

# Registry dict → home module allowed to mutate it.
REGISTRY_HOMES = {
    "STRATEGIES": "src/repro_torch/core/selection.py",
    "AGGREGATORS": "src/repro_torch/core/aggregation.py",
    "_WORKLOADS": "src/repro_torch/fl/workloads.py",
    "_ENGINES": "src/repro_torch/fl/experiment.py",
    "_TRANSFORMS": "src/repro_torch/fl/experiment.py",
}

REGISTER_FNS = frozenset({
    "register_strategy", "register_aggregator", "register_workload",
    "register_engine", "register_transform"})

COMPILE_HEAVY_MARKER = "xla_force_host_platform_device_count"

# torch.func transforms whose caller's own body counts as traced (L004), and
# the autograd.Function methods that run under autograd's or vmap's tracing.
FUNC_TRANSFORMS = frozenset({"vmap", "grad", "grad_and_value", "vjp",
                             "functional_call"})
AUTOGRAD_METHODS = frozenset({"forward", "backward", "vmap"})

# numpy attributes that are dtype/constant names, fine anywhere.
NP_DTYPE_WHITELIST = frozenset({
    "float32", "float64", "float16", "int8", "int16", "int32", "int64",
    "uint8", "uint32", "uint64", "bool_", "ndarray", "dtype", "newaxis",
    "pi", "inf", "nan"})


def repo_root() -> Optional[Path]:
    """The repo root this installed package lives in (src layout), or
    ``None`` when running from an installed wheel with no repo around —
    the AST layer then skips gracefully."""
    root = Path(__file__).resolve().parents[3]
    if (root / "src" / "repro_torch").is_dir():
        return root
    return None


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(), filename=str(path))
    except (OSError, SyntaxError):
        return None


# ---------------------------------------------------------------------------
# L001 — engine modules carry zero model/dataset imports
# ---------------------------------------------------------------------------

def _absolute_module(rel: str, node: ast.ImportFrom) -> str:
    """The absolute module an ``ImportFrom`` in the file ``rel``
    (``src/<package path>.py``) names: ``from ..models import x`` in
    ``src/repro_torch/fl/sim.py`` is ``repro_torch.models``."""
    mod = node.module or ""
    if not node.level:
        return mod
    package = Path(rel).with_suffix("").parts[1:-1]
    base = package[:len(package) - (node.level - 1)]
    return ".".join(base + ((mod,) if mod else ()))


def _check_engine_imports(root: Path, out: Findings) -> None:
    for rel in ENGINE_MODULES:
        path = root / rel
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if any(alias.name == m or alias.name.startswith(m + ".")
                           for m in FORBIDDEN_ENGINE_MODULES):
                        out.add("L001", "error", "file", rel,
                                f"engine module imports {alias.name!r}; "
                                "model code must arrive via the workload "
                                "registry", line=node.lineno,
                                imported=alias.name)
            elif isinstance(node, ast.ImportFrom):
                mod = _absolute_module(rel, node)
                if any(mod == m or mod.startswith(m + ".")
                       for m in FORBIDDEN_ENGINE_MODULES):
                    out.add("L001", "error", "file", rel,
                            f"engine module imports from {mod!r}; model "
                            "code must arrive via the workload registry",
                            line=node.lineno, imported=mod)
                    continue
                for alias in node.names:
                    if alias.name in FORBIDDEN_ENGINE_NAMES:
                        out.add("L001", "error", "file", rel,
                                f"engine module imports {alias.name!r} from "
                                f"{mod!r}; engines are payload-agnostic",
                                line=node.lineno, imported=alias.name)


# ---------------------------------------------------------------------------
# L002 — registries touched only via register_* at import time
# ---------------------------------------------------------------------------

def _enclosing_functions(tree: ast.Module):
    """Yield (node, innermost_enclosing_FunctionDef_or_None) pairs."""
    parents = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    def owner(node) -> Optional[ast.AST]:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = parents.get(cur)
        return None

    for node in ast.walk(tree):
        yield node, owner(node)


def _check_registry_mutation(root: Path, out: Findings) -> None:
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")):
        rel = str(path.relative_to(root))
        tree = _parse(path)
        if tree is None:
            continue
        for node, fn in _enclosing_functions(tree):
            # Direct subscript writes: REGISTRY[name] = ...  / del / .pop()
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = (node.targets if isinstance(node, (ast.Assign,
                                                             ast.Delete))
                           else [node.target])
                for t in targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in REGISTRY_HOMES
                            and rel != REGISTRY_HOMES[t.value.id]):
                        out.add("L002", "error", "file", rel,
                                f"direct write to registry "
                                f"{t.value.id}[...] outside its home module "
                                f"({REGISTRY_HOMES[t.value.id]}); go through "
                                "register_*", line=node.lineno,
                                registry=t.value.id)
            # register_* calls inside function bodies (not import time).
            if isinstance(node, ast.Call):
                fname = None
                if isinstance(node.func, ast.Name):
                    fname = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    fname = node.func.attr
                if fname in REGISTER_FNS and fn is not None:
                    # The registry module's own register_* definition bodies
                    # are the implementation, not a call site.
                    if rel in REGISTRY_HOMES.values() and fn.name in \
                            REGISTER_FNS:
                        continue
                    out.add("L002", "error", "file", rel,
                            f"{fname}() called inside {fn.name}(); "
                            "registration must happen at import time so the "
                            "append-only id ledger stays deterministic",
                            line=node.lineno, function=fn.name)


# ---------------------------------------------------------------------------
# L003 — compile-heavy tests must be @pytest.mark.slow
# ---------------------------------------------------------------------------

def _has_slow_marker(node) -> bool:
    for dec in getattr(node, "decorator_list", []):
        if COMPILE_HEAVY_MARKER:  # decorator shapes: pytest.mark.slow
            d = dec
            if isinstance(d, ast.Call):
                d = d.func
            parts = []
            while isinstance(d, ast.Attribute):
                parts.append(d.attr)
                d = d.value
            if isinstance(d, ast.Name):
                parts.append(d.id)
            if parts[:1] == ["slow"] and "mark" in parts:
                return True
    return False


def _module_is_slow(tree: ast.Module) -> bool:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "pytestmark":
                    return "slow" in ast.dump(node.value)
    return False


def _check_slow_markers(root: Path, out: Findings) -> None:
    tests = root / "tests"
    if not tests.is_dir():
        return
    for path in sorted(tests.glob("test_*.py")):
        rel = str(path.relative_to(root))
        src = path.read_text()
        if COMPILE_HEAVY_MARKER not in src:
            continue
        tree = _parse(path)
        if tree is None or _module_is_slow(tree):
            continue

        def check_def(node, cls_slow: bool):
            seg = ast.get_source_segment(src, node) or ""
            if COMPILE_HEAVY_MARKER not in seg:
                return
            if not (cls_slow or _has_slow_marker(node)):
                out.add("L003", "error", "file", rel,
                        f"{node.name} forces a multi-device topology "
                        f"({COMPILE_HEAVY_MARKER}) but carries no "
                        "@pytest.mark.slow — compile-heavy tests belong in "
                        "the weekly tier", line=node.lineno, test=node.name)

        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
                cls_slow = _has_slow_marker(node)
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and \
                            sub.name.startswith("test"):
                        check_def(sub, cls_slow)
            elif isinstance(node, ast.FunctionDef) and \
                    node.name.startswith("test"):
                check_def(node, False)


# ---------------------------------------------------------------------------
# L004 — no numpy calls inside traced function bodies
# ---------------------------------------------------------------------------

def _direct_body_nodes(fn) -> Iterable[ast.AST]:
    """Walk a function's own body, stopping at nested function boundaries."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    """Does ``cls`` subclass ``torch.autograd.Function`` (by any spelling
    that ends in ``autograd.Function`` or is a bare ``Function``)?"""
    for base in cls.bases:
        if isinstance(base, ast.Attribute) and base.attr == "Function" \
                and "'autograd'" in ast.dump(base.value):
            return True
        if isinstance(base, ast.Name) and base.id == "Function":
            return True
    return False


def _is_traced_fn(fn, owner: Optional[ast.ClassDef]) -> bool:
    """Does this function's OWN body run under a transform — a method
    ``forward``/``backward``/``vmap`` of an ``autograd.Function``, or a
    function that calls a ``torch.func`` transform directly?"""
    if owner is not None and fn.name in AUTOGRAD_METHODS \
            and _is_autograd_function(owner):
        return True
    for node in _direct_body_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in FUNC_TRANSFORMS:
            return True
        if isinstance(f, ast.Attribute) and f.attr in FUNC_TRANSFORMS \
                and "'func'" in ast.dump(f.value):
            return True
    return False


def _check_numpy_in_traced(root: Path, out: Findings) -> None:
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")):
        rel = str(path.relative_to(root))
        tree = _parse(path)
        if tree is None:
            continue
        owners = {child: node for node in ast.walk(tree)
                  if isinstance(node, ast.ClassDef) for child in node.body}
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_traced_fn(fn, owners.get(fn)):
                continue
            for node in _direct_body_nodes(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in ("np", "numpy")
                        and node.func.attr not in NP_DTYPE_WHITELIST):
                    out.add("L004", "error", "file", rel,
                            f"np.{node.func.attr}() inside traced function "
                            f"{fn.name}() — numpy cannot see a batched or "
                            "fake tensor and bakes host constants into the "
                            "traced body",
                            line=node.lineno, function=fn.name,
                            call=f"np.{node.func.attr}")


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def run_repo_checks(root: "Optional[Path | str]" = None) -> Findings:
    """Run all four AST rules over the repo; one Findings for the CLI."""
    out = Findings()
    root = Path(root) if root is not None else repo_root()
    if root is None or not (root / "src" / "repro_torch").is_dir():
        out.add("L001", "info", "file", "<repo>",
                "no src/repro_torch tree found relative to the installed "
                "package; AST lint skipped")
        return out
    _check_engine_imports(root, out)
    _check_registry_mutation(root, out)
    _check_slow_markers(root, out)
    _check_numpy_in_traced(root, out)
    return out

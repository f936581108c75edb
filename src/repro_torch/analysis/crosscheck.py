"""R4/R6: cross-file contract checks (status taxonomy + metric keys).

Three wire contracts span several modules and silently rot without a
mechanical check:

* **Status taxonomy** (R4) — every HTTP status the gateway path can emit
  (the ALL-CAPS constants in ``core/web_gateway.py``/``core/tenancy.py``
  and every status passed to ``error_for_status``) must appear in the
  ``api/errors.py`` taxonomy (``ERROR_TABLE`` + ``SUCCESS_STATUSES``);
  with ``--check-goldens`` the ``GOLDEN`` table in ``tests/test_api.py``
  must cover exactly the same set.
* **Metric keys** (R4) — every engine-snapshot key the MetricsGateway or
  a routing policy reads must be emitted by ``engine/metrics.snapshot``,
  and every metric an ``AlertRule`` references must be emitted by the
  scrape aggregation (dangling-metric detection): an alert rule watching
  a key nobody emits never fires, which is an autoscaler outage, not a
  visible error.
* **Metric registry** (R6) — the inverse direction: every series key the
  scrape/telemetry layer EMITS (``agg[...]``/``snap``/``out`` stores in
  ``core/metrics_gateway.py`` and ``core/telemetry.py``, f-string keys
  expanded over pools / SLO classes / span kinds) must appear in the
  declared ``METRIC_REGISTRY`` of ``core/telemetry.py`` — a typo'd
  emission creates a series nothing can ever reference, invisible until
  a dashboard or rule silently reads zeros.  The check activates only
  when ``core/telemetry.py`` declares a parsable registry.

All checks are static (AST only) so they run in CI before any test.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Optional

from repro_torch.analysis import lint as _lint

#: f-string metric templates are expanded over the disagg pool names
_POOLS = ("prefill", "decode")
#: receivers whose subscripts/gets are engine-snapshot reads by convention
_SNAP_RECEIVERS = {"s", "snap"}


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(), filename=str(path))
    except (OSError, SyntaxError):
        return None


def _dict_int_keys(tree: ast.Module, name: str) -> set[int]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in targets) and isinstance(node.value, ast.Dict):
                return {k.value for k in node.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, int)}
    return set()


def _status_constants(tree: ast.Module) -> dict[str, tuple[int, int]]:
    """ALL-CAPS int constants in the HTTP range: name -> (value, line)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.isupper() \
                and isinstance(node.value, ast.Constant) \
                and type(node.value.value) is int \
                and 100 <= node.value.value <= 599:
            out[node.targets[0].id] = (node.value.value, node.lineno)
    return out


def _error_for_status_args(tree: ast.Module) -> list[tuple[ast.AST, int]]:
    """(first-arg node, line) of every error_for_status(...) call."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            fname = f.id if isinstance(f, ast.Name) \
                else f.attr if isinstance(f, ast.Attribute) else None
            if fname == "error_for_status" and node.args:
                out.append((node.args[0], node.lineno))
    return out


def _snapshot_keys(tree: ast.Module) -> set[str]:
    """String keys of the dict literal returned by snapshot()."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "snapshot":
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) \
                        and isinstance(ret.value, ast.Dict):
                    return {k.value for k in ret.value.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str)}
    return set()


def _expand_fstring(node: ast.JoinedStr,
                    varmap: Optional[dict] = None) -> list[str]:
    """Expand f"...{var}..." over each known variable's value set
    (default: just the disagg pools); [] if unexpandable."""
    varmap = varmap if varmap is not None else {"pool": _POOLS}
    out = [""]
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            out = [o + part.value for o in out]
        elif isinstance(part, ast.FormattedValue) \
                and isinstance(part.value, ast.Name) \
                and part.value.id in varmap:
            out = [o + p for p in varmap[part.value.id] for o in out]
        else:
            return []
    return out


def _agg_keys(tree: ast.Module) -> set[str]:
    """Metric keys the scrape aggregation emits: every dict literal
    assigned to a name `agg` plus every `agg[...]` subscript store
    (f-string keys expanded over the pools)."""
    keys: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "agg" \
                        and isinstance(node.value, ast.Dict):
                    keys.update(k.value for k in node.value.keys
                                if isinstance(k, ast.Constant)
                                and isinstance(k.value, str))
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "agg":
                    sl = t.slice
                    if isinstance(sl, ast.Constant) \
                            and isinstance(sl.value, str):
                        keys.add(sl.value)
                    elif isinstance(sl, ast.JoinedStr):
                        keys.update(_expand_fstring(sl))
    return keys


def _snapshot_reads(tree: ast.Module) -> list[tuple[str, int]]:
    """(key, line) of engine-snapshot reads: `s[...]`/`snap[...]`
    subscripts and `.get("...")` calls on those receivers or on a
    `load_fn(...)` result."""
    reads = []

    def _is_snap_receiver(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name) and expr.id in _SNAP_RECEIVERS:
            return True
        # (self.load_fn(key) or {}).get(...) — chained through BoolOp
        for n in ast.walk(expr):
            if isinstance(n, ast.Attribute) and n.attr == "load_fn":
                return True
            if isinstance(n, ast.Name) and n.id == "load_fn":
                return True
        return False

    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str) \
                and _is_snap_receiver(node.value):
            reads.append((node.slice.value, node.lineno))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and _is_snap_receiver(node.func.value):
            reads.append((node.args[0].value, node.lineno))
    return reads


def _tuple_str_constant(tree: Optional[ast.Module], name: str) -> tuple:
    """Module-level ``NAME = ("a", "b", ...)`` string tuple, or ()."""
    if tree is None:
        return ()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            vals = tuple(e.value for e in node.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str))
            if vals:
                return vals
    return ()


#: the registry's closed vocabulary of series types
_METRIC_TYPES = ("counter", "gauge", "histogram", "exemplars")


def _metric_registry(tree: Optional[ast.Module]):
    """Parse ``METRIC_REGISTRY = {...}`` from core/telemetry.py:
    name -> (value node, line).  None when absent or not a dict literal —
    the R6 gate (a tree without a declared registry is not checked)."""
    if tree is None:
        return None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "METRIC_REGISTRY":
            if not isinstance(node.value, ast.Dict):
                return None
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out[k.value] = (v, k.lineno)
            return out
    return None


def _expand_braces(name: str, varmap: dict) -> list[str]:
    """Expand ``"...{pool}..."``-style registry templates over each known
    variable's value set (plain strings pass through unchanged)."""
    out = [name]
    for var, vals in varmap.items():
        tok = "{%s}" % var
        nxt = []
        for o in out:
            nxt.extend([o.replace(tok, v) for v in vals]
                       if tok in o else [o])
        out = nxt
    return out


def _emitted_keys(tree: ast.Module, receivers: set[str],
                  varmap: dict) -> list[tuple[str, int]]:
    """(series key, line) of every emission into a scrape/telemetry
    output dict: dict literals assigned to a receiver name plus every
    ``recv[...]`` subscript store, f-string keys expanded over
    `varmap`."""
    keys: list[tuple[str, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in receivers \
                    and isinstance(node.value, ast.Dict):
                keys.extend((k.value, k.lineno) for k in node.value.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str))
            if isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id in receivers:
                sl = t.slice
                if isinstance(sl, ast.Constant) \
                        and isinstance(sl.value, str):
                    keys.append((sl.value, t.lineno))
                elif isinstance(sl, ast.JoinedStr):
                    keys.extend((k, t.lineno)
                                for k in _expand_fstring(sl, varmap))
    return keys


def _alert_rule_metrics(tree: ast.Module) -> list[tuple[str, int]]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            fname = f.id if isinstance(f, ast.Name) \
                else f.attr if isinstance(f, ast.Attribute) else None
            if fname != "AlertRule":
                continue
            for kw in node.keywords:
                if kw.arg == "metric" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    out.append((kw.value.value, node.lineno))
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                out.append((node.args[1].value, node.lineno))
    return out


# ---------------------------------------------------------------------------

def crosscheck(repro_root: Path,
               goldens_dir: Optional[Path] = None) -> list:
    """Run the R4 checks against a repro package root (…/src/repro).
    `goldens_dir` (the tests/ directory) additionally validates the
    GOLDEN status table stays in sync with the taxonomy."""
    Finding = _lint.Finding
    findings: list = []
    errors_py = repro_root / "api" / "errors.py"
    errors_tree = _parse(errors_py)
    if errors_tree is None:
        return [Finding(str(errors_py), 0, "R4",
                        "cannot parse api/errors.py for the taxonomy check")]
    taxonomy = _dict_int_keys(errors_tree, "ERROR_TABLE") \
        | _dict_int_keys(errors_tree, "SUCCESS_STATUSES")

    # -- status constants + error_for_status call sites --------------------
    status_files = [repro_root / "core" / "web_gateway.py",
                    repro_root / "core" / "tenancy.py"]
    const_map: dict[str, int] = {}
    trees: dict[Path, ast.Module] = {}
    for p in status_files:
        t = _parse(p)
        if t is None:
            continue
        trees[p] = t
        for name, (value, line) in _status_constants(t).items():
            const_map[name] = value
            if value not in taxonomy:
                findings.append(Finding(
                    str(p), line, "R4",
                    f"status constant {name}={value} is missing from the "
                    f"api/errors.py taxonomy (ERROR_TABLE/SUCCESS_STATUSES)"))
    # every error_for_status() call in core/ + api/ must use a tabulated
    # status (the function raises KeyError at runtime otherwise — this
    # catches it before any test runs)
    for sub in ("core", "api"):
        for p in sorted((repro_root / sub).glob("*.py")):
            t = trees.get(p) or _parse(p)
            if t is None:
                continue
            for arg, line in _error_for_status_args(t):
                status = None
                if isinstance(arg, ast.Constant) and type(arg.value) is int:
                    status = arg.value
                elif isinstance(arg, ast.Name):
                    status = const_map.get(arg.id)
                if status is not None and status not in taxonomy:
                    findings.append(Finding(
                        str(p), line, "R4",
                        f"error_for_status({status}) has no taxonomy row"))

    # -- golden table (tests/) ---------------------------------------------
    if goldens_dir is not None:
        golden_py = Path(goldens_dir) / "test_api.py"
        golden_tree = _parse(golden_py)
        if golden_tree is None:
            findings.append(Finding(str(golden_py), 0, "R4",
                                    "GOLDEN table not found/parsable"))
        else:
            golden = _dict_int_keys(golden_tree, "GOLDEN")
            for missing in sorted(taxonomy - golden):
                findings.append(Finding(
                    str(golden_py), 1, "R4",
                    f"status {missing} is in the taxonomy but missing from "
                    f"the GOLDEN table"))
            for extra in sorted(golden - taxonomy):
                findings.append(Finding(
                    str(golden_py), 1, "R4",
                    f"status {extra} is in the GOLDEN table but not in the "
                    f"taxonomy"))

    # -- metric keys -------------------------------------------------------
    metrics_tree = _parse(repro_root / "engine" / "metrics.py")
    gw_path = repro_root / "core" / "metrics_gateway.py"
    gw_tree = _parse(gw_path)
    engine_keys = _snapshot_keys(metrics_tree) if metrics_tree else set()
    agg_keys = _agg_keys(gw_tree) if gw_tree else set()
    if engine_keys:
        for p in (gw_path, repro_root / "core" / "router.py"):
            t = _parse(p)
            if t is None:
                continue
            for key, line in _snapshot_reads(t):
                if key not in engine_keys:
                    findings.append(Finding(
                        str(p), line, "R4",
                        f"engine-snapshot key '{key}' is read here but "
                        f"never emitted by engine/metrics.snapshot() "
                        f"(dangling metric)"))
    tele_path = repro_root / "core" / "telemetry.py"
    tele_tree = _parse(tele_path)
    varmap = {
        "pool": _POOLS,
        "cls": _tuple_str_constant(_parse(repro_root / "config.py"),
                                   "SLO_CLASSES")
        or ("interactive", "standard", "batch"),
        "kind": _tuple_str_constant(_parse(repro_root / "core"
                                           / "tracing.py"), "SPAN_KINDS")
        or ("request", "engine.prefill", "engine.decode"),
    }
    if agg_keys:
        # alert rules may also watch telemetry-registry series the scrape
        # re-emits (burn rates, attainment) — expand the registry too so
        # the R4 dangling-metric check and R6 agree on what exists
        rule_universe = set(agg_keys)
        if tele_tree is not None:
            registry = _metric_registry(tele_tree) or {}
            for name in registry:
                rule_universe.update(_expand_braces(name, varmap))
        for p in sorted((repro_root / "core").glob("*.py")):
            t = trees.get(p) or _parse(p)
            if t is None:
                continue
            for metric, line in _alert_rule_metrics(t):
                if metric not in rule_universe:
                    findings.append(Finding(
                        str(p), line, "R4",
                        f"AlertRule references metric '{metric}' which the "
                        f"MetricsGateway scrape never emits (the rule can "
                        f"never fire — dangling metric)"))

    # -- R6: emitted series must be declared in the metric registry --------
    registry = _metric_registry(tele_tree)
    if registry is not None:
        registered: set[str] = set()
        for name, (value, line) in registry.items():
            registered.update(_expand_braces(name, varmap))
            # shape: every entry is {"type": <closed vocab>, "labels": (...)}
            if not isinstance(value, ast.Dict):
                findings.append(Finding(
                    str(tele_path), line, "R6",
                    f"METRIC_REGISTRY entry '{name}' is not a dict literal"))
                continue
            entry = {k.value: v for k, v in zip(value.keys, value.values)
                     if isinstance(k, ast.Constant)}
            mtype = entry.get("type")
            if not (isinstance(mtype, ast.Constant)
                    and mtype.value in _METRIC_TYPES):
                findings.append(Finding(
                    str(tele_path), line, "R6",
                    f"METRIC_REGISTRY entry '{name}' needs a 'type' in "
                    f"{list(_METRIC_TYPES)}"))
        for p in (gw_path, tele_path):
            t = _parse(p)
            if t is None:
                continue
            for key, line in _emitted_keys(t, {"agg", "snap", "out"},
                                           varmap):
                if key not in registered:
                    findings.append(Finding(
                        str(p), line, "R6",
                        f"series '{key}' is emitted here but not declared "
                        f"in core/telemetry.METRIC_REGISTRY (unregistered "
                        f"emission — nothing can reference it by "
                        f"contract)"))
    return findings

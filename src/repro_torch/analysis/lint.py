"""repro-lint core: AST invariant checks R1-R3/R5 + suppression handling.

Rules (see docs/analysis.md for the full catalogue):

* **R1** — wall-clock reads (``time.time``/``monotonic``/``perf_counter``,
  ``datetime.now``), unseeded randomness (module-level ``random.*``,
  argless ``np.random.default_rng()``/``RandomState()``, the
  ``np.random.*`` global RNG) and the salted builtin ``hash()`` in
  sim-executed code.  Any of these makes two runs of the "fully
  deterministic" EventLoop diverge.
* **R2** — order-sensitive consumption of unordered sets: iterating a
  set (or ``min``/``max``/``list``/... over one) feeds scheduling or
  routing order that then depends on PYTHONHASHSEED.  ``sorted(...)``
  over a set is the sanctioned form.  Dicts are insertion-ordered in
  Python 3.7+, so plain dict iteration is deterministic as long as
  population order is — which R1/R3 guard.
* **R3** — the zombie-closure rule: a callback scheduled via
  ``call_at``/``call_after``/``every`` that captures an endpoint /
  instance / deployment / request-ish object must re-check liveness
  *inside the callback* (``.alive``/``.closed``/``.state``/dispatch
  ``epoch``/registry ``in``/``is None`` re-check), because the object
  can die between scheduling and firing (the PR-6 zombie-endpoint bug).
* **R5** — the span-leak rule (``repro_torch/core`` only): a span handle bound
  from ``.start_span(...)`` must either be closed on every code path
  (an unconditional ``handle.close(...)`` in the same function) or
  escape to an owner who will (returned, stored, passed on).  A span
  closed only inside a branch leaks open on the other paths and is
  force-closed with a bogus end time at trace finish.  Unassigned
  ``start_span(...)`` calls are trace-owned by construction (the
  `RequestTrace` closes leftovers) and are never flagged.
* **LINT** — a ``# repro-lint: disable=RULE(...)`` suppression must
  carry a non-empty reason.

Scope: only modules the simulation executes (``repro_torch/{core,engine,api,
data}``).  ``train/``, ``launch/``, ``distributed/`` etc. run on real
wall clocks by design and are exempt.  R5 further restricts itself to
``repro_torch/core`` — the layer that owns tracing instrumentation.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

#: repro subpackages executed under the sim EventLoop (rule R1-R3 scope)
SIM_PACKAGES = ("core", "engine", "api", "data")

_WALLCLOCK_TIME_FNS = {"time", "monotonic", "perf_counter", "time_ns",
                       "monotonic_ns", "perf_counter_ns"}
_DATETIME_NOW_FNS = {"now", "utcnow", "today"}
#: seedable RNG constructors: allowed iff called WITH a seed argument
_SEEDABLE_RNG = {"default_rng", "RandomState", "Random"}

#: identifier tokens that mark a captured object as liveness-relevant (R3)
_R3_CAPTURE_TOKENS = {"inst", "instance", "ep", "eps", "endpoint",
                      "endpoints", "dep", "deployment", "replica",
                      "req", "request", "stream", "job", "node"}
#: tokens in a callback body that count as a liveness re-check (R3)
_R3_GUARD_TOKENS = {"alive", "closed", "cancelled", "stopped", "dead",
                    "draining", "state", "epoch"}
#: order-sensitive consumers of an iterable (R2); `sorted` is the fix
_R2_CONSUMERS = {"min", "max", "list", "tuple", "next", "iter", "enumerate"}

_DIRECTIVE_RE = re.compile(
    r"#\s*repro-lint:\s*(disable|disable-next-line)=(.*)$")
_ENTRY_RE = re.compile(r"([A-Z]+\d*)(?:\(([^()]*)\))?")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def parse_suppressions(source: str, path: str
                       ) -> tuple[dict[int, dict[str, str]], list[Finding]]:
    """Line -> {rule: reason} map plus LINT findings for reasonless
    directives.  ``disable`` applies to its own line,
    ``disable-next-line`` to the following one."""
    suppressed: dict[int, dict[str, str]] = {}
    bad: list[Finding] = []
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DIRECTIVE_RE.search(line)
        if m is None:
            continue
        target = i + 1 if m.group(1) == "disable-next-line" else i
        for rule, reason in _ENTRY_RE.findall(m.group(2)):
            if not (reason or "").strip():
                bad.append(Finding(
                    path, i, "LINT",
                    f"suppression of {rule} must carry a reason: "
                    f"disable={rule}(<why this is safe>)"))
                continue
            suppressed.setdefault(target, {})[rule] = reason.strip()
    return suppressed, bad


# ---------------------------------------------------------------------------
# R1: wall clock / unseeded randomness / salted hash
# ---------------------------------------------------------------------------

class _R1Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self.time_aliases: set[str] = set()
        self.random_aliases: set[str] = set()
        self.numpy_aliases: set[str] = set()
        self.datetime_aliases: set[str] = set()
        self.datetime_classes: set[str] = set()     # from datetime import …
        self.from_time: set[str] = set()            # from time import …
        self.from_random: set[str] = set()          # from random import …

    def _flag(self, node: ast.AST, msg: str):
        self.findings.append(Finding(self.path, node.lineno, "R1", msg))

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            bound = a.asname or a.name.split(".")[0]
            if a.name in ("time",):
                self.time_aliases.add(bound)
            elif a.name in ("random",):
                self.random_aliases.add(bound)
            elif a.name in ("numpy", "numpy.random"):
                self.numpy_aliases.add(bound)
            elif a.name in ("datetime",):
                self.datetime_aliases.add(bound)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        for a in node.names:
            bound = a.asname or a.name
            if node.module == "time" and a.name in _WALLCLOCK_TIME_FNS:
                self.from_time.add(bound)
            elif node.module == "random":
                self.from_random.add(bound)
            elif node.module == "datetime" and a.name in ("datetime", "date"):
                self.datetime_classes.add(bound)
        self.generic_visit(node)

    def _numpy_random_attr(self, func: ast.Attribute) -> Optional[str]:
        """'default_rng' for np.random.default_rng etc.; None otherwise."""
        v = func.value
        if isinstance(v, ast.Attribute) and v.attr == "random" \
                and isinstance(v.value, ast.Name) \
                and v.value.id in self.numpy_aliases:
            return func.attr
        return None

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            if f.id == "hash":
                self._flag(node, "builtin hash() is salted by "
                                 "PYTHONHASHSEED for str/bytes; use a "
                                 "keyed digest (router._stable_hash) or "
                                 "suppress if the input is int-only")
            elif f.id in self.from_time:
                self._flag(node, f"wall-clock read {f.id}() in sim code; "
                                 f"use the EventLoop's `now`")
            elif f.id in self.from_random:
                if f.id in _SEEDABLE_RNG and node.args:
                    pass                      # seeded constructor
                else:
                    self._flag(node, f"unseeded randomness {f.id}() in sim "
                                     f"code; use a seeded np RNG")
        elif isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                if base.id in self.time_aliases \
                        and f.attr in _WALLCLOCK_TIME_FNS:
                    self._flag(node, f"wall-clock read {base.id}.{f.attr}() "
                                     f"in sim code; use the EventLoop's "
                                     f"`now`")
                elif base.id in self.random_aliases:
                    if f.attr in _SEEDABLE_RNG and node.args:
                        pass                  # random.Random(seed)
                    else:
                        self._flag(node, f"{base.id}.{f.attr}() uses the "
                                         f"process-global (unseeded) RNG")
                elif base.id in self.datetime_aliases \
                        and f.attr in _DATETIME_NOW_FNS:
                    self._flag(node, f"wall-clock read {base.id}.{f.attr}()")
                elif base.id in self.datetime_classes \
                        and f.attr in _DATETIME_NOW_FNS:
                    self._flag(node, f"wall-clock read {base.id}.{f.attr}()")
            np_attr = self._numpy_random_attr(f)
            if np_attr is not None:
                if np_attr in _SEEDABLE_RNG:
                    if not node.args and not node.keywords:
                        self._flag(node, f"np.random.{np_attr}() without a "
                                         f"seed is entropy-seeded; pass an "
                                         f"explicit seed")
                else:
                    self._flag(node, f"np.random.{np_attr}() uses the "
                                     f"process-global RNG; use a seeded "
                                     f"Generator")
            # datetime.datetime.now() spelled through the module
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id in self.datetime_aliases \
                    and base.attr in ("datetime", "date") \
                    and f.attr in _DATETIME_NOW_FNS:
                self._flag(node, f"wall-clock read datetime.{base.attr}."
                                 f"{f.attr}()")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# R2: order-sensitive consumption of unordered sets
# ---------------------------------------------------------------------------

def _assigned_names(target: ast.AST) -> Iterable[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _assigned_names(e)


class _R2Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self._scopes: list[set[str]] = [set()]   # set-typed names per scope
        self._class_set_attrs: list[set[str]] = []

    # -- set-expression classification ---------------------------------
    def _is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        if isinstance(node, ast.Name):
            return any(node.id in scope for scope in self._scopes)
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and self._class_set_attrs:
            return node.attr in self._class_set_attrs[-1]
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return self._is_set_expr(node.left) \
                or self._is_set_expr(node.right)
        return False

    def _collect_set_bindings(self, body: list[ast.stmt], scope: set[str]):
        for stmt in ast.walk(ast.Module(body=body, type_ignores=[])):
            value, targets = None, []
            if isinstance(stmt, ast.Assign):
                value, targets = stmt.value, stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                value, targets = stmt.value, [stmt.target]
            if value is not None and self._is_set_expr(value):
                for t in targets:
                    scope.update(_assigned_names(t))

    def _collect_set_attrs(self, cls: ast.ClassDef) -> set[str]:
        attrs: set[str] = set()
        for stmt in ast.walk(cls):
            value, targets = None, []
            if isinstance(stmt, ast.Assign):
                value, targets = stmt.value, stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                value, targets = stmt.value, [stmt.target]
            if value is None or not self._is_set_expr(value):
                continue
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    attrs.add(t.attr)
        return attrs

    # -- scope management ----------------------------------------------
    def visit_Module(self, node: ast.Module):
        self._collect_set_bindings(node.body, self._scopes[0])
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef):
        self._class_set_attrs.append(self._collect_set_attrs(node))
        self.generic_visit(node)
        self._class_set_attrs.pop()

    def _visit_function(self, node):
        scope: set[str] = set()
        self._collect_set_bindings(node.body, scope)
        self._scopes.append(scope)
        self.generic_visit(node)
        self._scopes.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- flagged consumption sites -------------------------------------
    def _flag(self, node: ast.AST, what: str):
        self.findings.append(Finding(
            self.path, node.lineno, "R2",
            f"{what} over an unordered set feeds iteration-order-dependent "
            f"logic (varies with PYTHONHASHSEED); wrap in sorted(...) or "
            f"keep a deterministically ordered list/dict"))

    def visit_For(self, node: ast.For):
        if self._is_set_expr(node.iter):
            self._flag(node.iter, "for-loop")
        self.generic_visit(node)

    def _visit_comp(self, node, kind: str):
        # building a *set* from a set is order-free; every other
        # comprehension materialises iteration order
        if not isinstance(node, ast.SetComp):
            for gen in node.generators:
                if self._is_set_expr(gen.iter):
                    self._flag(gen.iter, kind)
        self.generic_visit(node)

    def visit_ListComp(self, node):
        self._visit_comp(node, "list comprehension")

    def visit_DictComp(self, node):
        self._visit_comp(node, "dict comprehension")

    def visit_GeneratorExp(self, node):
        self._visit_comp(node, "generator expression")

    def visit_SetComp(self, node):
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in _R2_CONSUMERS \
                and node.args and self._is_set_expr(node.args[0]):
            self._flag(node, f"{f.id}(...)")
        # set.pop() removes an arbitrary (hash-ordered) element
        if isinstance(f, ast.Attribute) and f.attr == "pop" \
                and not node.args and self._is_set_expr(f.value):
            self._flag(node, "set.pop()")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# R3: zombie closures scheduled on the EventLoop
# ---------------------------------------------------------------------------

def _tokens(identifier: str) -> set[str]:
    """snake_case AND CamelCase parts, lowercased."""
    parts = re.split(r"[_]+", identifier)
    camel = re.findall(r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z]+|[A-Z]+|\d+",
                       identifier)
    return {p.lower() for p in parts + camel if p}


def _bound_names(fn_node) -> set[str]:
    """Parameter names + names assigned within the function body."""
    bound: set[str] = set()
    args = fn_node.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        bound.add(a.arg)
    body = fn_node.body if isinstance(fn_node.body, list) else [fn_node.body]
    for stmt in ast.walk(ast.Module(body=[ast.Expr(value=b)
                                          if isinstance(b, ast.expr) else b
                                          for b in body], type_ignores=[])):
        if isinstance(stmt, ast.Name) and isinstance(stmt.ctx, ast.Store):
            bound.add(stmt.id)
    return bound


def _free_names(fn_node) -> set[str]:
    bound = _bound_names(fn_node)
    free: set[str] = set()
    body = fn_node.body if isinstance(fn_node.body, list) else [fn_node.body]
    for b in body:
        for n in ast.walk(b):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id not in bound:
                free.add(n.id)
    # default-argument values are captured at definition time too
    for d in fn_node.args.defaults + [d for d in fn_node.args.kw_defaults
                                      if d is not None]:
        for n in ast.walk(d):
            if isinstance(n, ast.Name):
                free.add(n.id)
    return free


def _body_has_liveness_guard(fn_node) -> bool:
    body = fn_node.body if isinstance(fn_node.body, list) else [fn_node.body]
    for b in body:
        for n in ast.walk(b):
            if isinstance(n, ast.Attribute) \
                    and n.attr in _R3_GUARD_TOKENS:
                return True
            if isinstance(n, ast.Name) and n.id in _R3_GUARD_TOKENS:
                return True
            if isinstance(n, ast.keyword) and n.arg in _R3_GUARD_TOKENS:
                return True
            if isinstance(n, ast.Compare):
                for op, cmp in zip(n.ops, n.comparators):
                    if isinstance(op, (ast.Is, ast.IsNot)) \
                            and isinstance(cmp, ast.Constant) \
                            and cmp.value is None:
                        return True
                    if isinstance(op, (ast.In, ast.NotIn)):
                        return True
    return False


class _R3Visitor(ast.NodeVisitor):
    SCHEDULERS = {"call_at", "call_after", "every"}

    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self._class_stack: list[tuple[str, dict]] = []   # (name, methods)
        self._local_defs: list[dict] = [{}]              # name -> FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef):
        methods = {s.name: s for s in node.body
                   if isinstance(s, ast.FunctionDef)}
        self._class_stack.append((node.name, methods))
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_function(self, node):
        self._local_defs.append({s.name: s for s in ast.walk(node)
                                 if isinstance(s, ast.FunctionDef)
                                 and s is not node})
        self.generic_visit(node)
        self._local_defs.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _resolve(self, cb: ast.AST):
        """(fn_node, captured_names, label) for a callback expression, or
        None when it cannot be analysed statically."""
        if isinstance(cb, ast.Lambda):
            return cb, _free_names(cb), "lambda"
        if isinstance(cb, ast.Name):
            for scope in reversed(self._local_defs):
                fn = scope.get(cb.id)
                if fn is not None:
                    return fn, _free_names(fn), cb.id
            return None
        if isinstance(cb, ast.Attribute) and isinstance(cb.value, ast.Name) \
                and cb.value.id == "self" and self._class_stack:
            cls_name, methods = self._class_stack[-1]
            fn = methods.get(cb.attr)
            if fn is None:
                return None
            captured = {"self"} if _tokens(cls_name) & _R3_CAPTURE_TOKENS \
                else set()
            return fn, captured | _free_names(fn), f"self.{cb.attr}"
        return None

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in self.SCHEDULERS \
                and len(node.args) >= 2:
            resolved = self._resolve(node.args[1])
            if resolved is not None:
                fn, captured, label = resolved
                # `self` only marks a liveness-relevant capture when the
                # enclosing class is itself an instance/endpoint-ish object
                self_rel = bool(self._class_stack) and bool(
                    _tokens(self._class_stack[-1][0]) & _R3_CAPTURE_TOKENS)
                relevant = sorted(
                    n for n in captured
                    if (_tokens(n) & _R3_CAPTURE_TOKENS)
                    or (n == "self" and self_rel))
                if relevant and not _body_has_liveness_guard(fn):
                    self.findings.append(Finding(
                        self.path, node.args[1].lineno, "R3",
                        f"closure '{label}' scheduled via {f.attr}() "
                        f"captures {', '.join(relevant)} but never "
                        f"re-checks liveness; the object can die between "
                        f"scheduling and firing (zombie-closure rule) — "
                        f"re-check .alive/.closed/.state/epoch inside the "
                        f"callback"))
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# R5: span handles must be closed on all code paths (core/ only)
# ---------------------------------------------------------------------------

def _r5_own_statements(fn) -> Iterable[ast.stmt]:
    """Every statement of `fn`'s own body (nested defs are excluded —
    they are visited as functions of their own)."""
    todo = list(fn.body)
    while todo:
        s = todo.pop(0)
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield s
        for fname in ("body", "orelse", "finalbody"):
            todo.extend(getattr(s, fname, None) or [])
        for h in getattr(s, "handlers", None) or []:
            todo.extend(h.body)


def _r5_unguarded_statements(fn) -> Iterable[ast.stmt]:
    """Statements that execute on EVERY path through `fn`: the straight-
    line body, `try` bodies (they run until an exception) and `finally`
    blocks.  If/While/For bodies, except handlers and `orelse` blocks
    are conditional and excluded."""
    todo = list(fn.body)
    while todo:
        s = todo.pop(0)
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.If, ast.While, ast.For, ast.AsyncFor)):
            continue
        if isinstance(s, ast.Try):
            todo.extend(s.body)
            todo.extend(s.finalbody)
            continue
        if isinstance(s, (ast.With, ast.AsyncWith)):
            todo.extend(s.body)
            continue
        yield s


def _r5_closes_here(node: ast.AST, name: str) -> bool:
    """True when `name.close(...)` is evaluated unconditionally within
    this (already unconditionally-reached) expression tree: IfExp arms,
    boolean short-circuit tails and lambda bodies are conditional."""
    if isinstance(node, ast.Lambda):
        return False
    if isinstance(node, ast.IfExp):
        return _r5_closes_here(node.test, name)
    if isinstance(node, ast.BoolOp):
        return _r5_closes_here(node.values[0], name) if node.values \
            else False
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "close" \
            and isinstance(node.func.value, ast.Name) \
            and node.func.value.id == name:
        return True
    return any(_r5_closes_here(c, name)
               for c in ast.iter_child_nodes(node)
               if not isinstance(c, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)))


def _r5_escapes(fn, name: str) -> bool:
    """True when the handle leaves the function's hands: returned,
    yielded, passed as an argument, stored into a container/attribute or
    captured by a nested def — its new owner is responsible for closing
    it.  Attribute access on the handle itself (``h.close()``,
    ``h.attrs``) and identity comparisons are not escapes."""
    parents: dict = {}
    for n in ast.walk(fn):
        for c in ast.iter_child_nodes(n):
            parents[c] = n
    for n in ast.walk(fn):
        if not (isinstance(n, ast.Name) and n.id == name
                and isinstance(n.ctx, ast.Load)):
            continue
        p = parents.get(n)
        if isinstance(p, ast.Attribute) and p.value is n:
            continue
        if isinstance(p, ast.Compare):
            continue
        return True
    return False


class _R5Visitor(ast.NodeVisitor):
    """Span-leak check: ``x = <expr>.start_span(...)`` must reach an
    unconditional ``x.close(...)`` in the same function, or hand the
    handle off (escape).  Unassigned ``start_span`` calls are
    trace-owned and exempt."""

    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []

    def _visit_function(self, node):
        for stmt in _r5_own_statements(node):
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)
                    and isinstance(stmt.value.func, ast.Attribute)
                    and stmt.value.func.attr == "start_span"):
                continue
            name = stmt.targets[0].id
            closed = any(_r5_closes_here(s, name)
                         for s in _r5_unguarded_statements(node))
            if not closed and not _r5_escapes(node, name):
                self.findings.append(Finding(
                    self.path, stmt.lineno, "R5",
                    f"span handle '{name}' from start_span() is not "
                    f"closed on all code paths of {node.name}() and "
                    f"never escapes — a leaked span is force-closed "
                    f"with a bogus end time at trace finish; close it "
                    f"unconditionally, hand it off, or drop the binding "
                    f"(unassigned spans are trace-owned)"))
        self.generic_visit(node)

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function


# ---------------------------------------------------------------------------
# file / path runners
# ---------------------------------------------------------------------------

def in_core_scope(path: Path) -> bool:
    """True for files under ``repro_torch/core`` (the R5 scope: the layer that
    owns tracing instrumentation)."""
    parts = path.parts
    for i, p in enumerate(parts[:-1]):
        if p == "repro_torch" and parts[i + 1] == "core":
            return True
    return False


def in_sim_scope(path: Path) -> bool:
    parts = path.parts
    for i, p in enumerate(parts[:-1]):
        if p == "repro_torch" and parts[i + 1] in SIM_PACKAGES:
            return True
    return False


def lint_file(path: Path) -> list[Finding]:
    source = path.read_text()
    rel = str(path)
    suppressed, findings = parse_suppressions(source, rel)
    if in_sim_scope(path):
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            return [Finding(rel, e.lineno or 0, "LINT",
                            f"syntax error: {e.msg}")]
        visitors = [_R1Visitor, _R2Visitor, _R3Visitor]
        if in_core_scope(path):
            visitors.append(_R5Visitor)
        for visitor_cls in visitors:
            v = visitor_cls(rel)
            v.visit(tree)
            findings.extend(v.findings)
    return [f for f in findings
            if f.rule not in suppressed.get(f.line, {})]


def lint_paths(paths: Iterable[Path],
               goldens_dir: Optional[Path] = None) -> list[Finding]:
    """Lint every .py under `paths` (R1-R3/R5 on sim-scope files) and run
    the R4/R6 cross-file checks when a repro package root is among
    them."""
    from repro_torch.analysis.crosscheck import crosscheck

    files: list[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: list[Finding] = []
    for f in files:
        findings.extend(lint_file(f))
    repro_root = next(
        (f.parent.parent for f in files
         if f.name == "web_gateway.py" and f.parent.name == "core"), None)
    if repro_root is not None:
        findings.extend(crosscheck(repro_root, goldens_dir))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))

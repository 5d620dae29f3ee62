"""graftlint rule engine: module context, suppressions, file driver.

The engine parses each file once, builds a ModuleContext (import alias
resolution, parent links, jit-traced function set, actor classes) and
hands it to every rule. Rules yield Findings; suppression comments
(`# graftlint: disable=RT001` on the finding's line or the line above,
`disable=all` to silence everything) are filtered here so individual
rules never re-implement them.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

# anywhere in the line's comment, so it stacks after `# noqa: ...`
_SUPPRESS_RE = re.compile(
    r"#.*?graftlint:\s*disable=([A-Za-z0-9_,\s]+)")

# Decorator/callable names that mean "this class/function is remote".
REMOTE_NAMES = {"ray_tpu_torch.remote", "ray.remote", "remote"}

# Callables whose function argument is traced by XLA. jax.jit & friends
# trace the decorated/wrapped callable; lax control-flow primitives trace
# their body/cond callables.
JIT_WRAPPERS = {"jax.jit", "jax.pmap", "jax.vmap.jit", "jit", "pjit",
                "jax.experimental.pjit.pjit"}
TRACING_CALLS = {"jax.lax.scan", "jax.lax.fori_loop", "jax.lax.while_loop",
                 "jax.lax.map", "jax.lax.cond", "jax.lax.switch",
                 "jax.checkpoint", "jax.remat"}


@dataclass(frozen=True)
class Finding:
    rule_id: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"{self.rule_id} {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule_id, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


@dataclass
class ModuleContext:
    """Everything rules need, computed once per file."""

    path: str
    tree: ast.Module
    source_lines: List[str]
    aliases: Dict[str, str] = field(default_factory=dict)
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)
    traced_fns: Set[ast.AST] = field(default_factory=set)
    actor_classes: Set[ast.ClassDef] = field(default_factory=set)
    remote_fns: Set[ast.AST] = field(default_factory=set)

    # ---- name resolution --------------------------------------------

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of an expression, resolving import
        aliases at the root (`rt.get` -> `ray_tpu_torch.get` after
        `import ray_tpu_torch as rt`); None for non-name expressions."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.dotted(node.value)
            if base is None:
                return None
            return f"{base}.{node.attr}"
        return None

    def call_name(self, node: ast.Call) -> Optional[str]:
        return self.dotted(node.func)

    # ---- tree navigation --------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        return [a for a in self.ancestors(node)
                if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))]

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for anc in self.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    def in_traced_code(self, node: ast.AST) -> bool:
        """True when node sits inside any jit/scan-traced function."""
        return any(fn in self.traced_fns
                   for fn in self.enclosing_functions(node))

    def loops_between(self, node: ast.AST) -> List[ast.AST]:
        """For/While/comprehension nodes between node and its enclosing
        function whose BODY repeats node (loops in OUTER functions don't
        serialize this call, and a call in a `for`/comprehension's
        iterable expression is evaluated once, not per iteration)."""
        out = []
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break
            if isinstance(anc, (ast.For, ast.AsyncFor)):
                if not self._within(anc.iter, node):
                    out.append(anc)
            elif isinstance(anc, ast.While):
                out.append(anc)
            elif isinstance(anc, (ast.ListComp, ast.SetComp, ast.DictComp,
                                  ast.GeneratorExp)):
                # the first generator's source iterable runs once
                if not self._within(anc.generators[0].iter, node):
                    out.append(anc)
        return out

    def _within(self, container: ast.AST, node: ast.AST) -> bool:
        return node is container or any(n is node
                                        for n in ast.walk(container))


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _is_remote_decorated(node, ctx: ModuleContext) -> bool:
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if ctx.dotted(target) in REMOTE_NAMES:
            return True
    return False


def _jit_decorated(node, ctx: ModuleContext) -> bool:
    for dec in getattr(node, "decorator_list", []):
        name = ctx.dotted(dec)
        if name in JIT_WRAPPERS:
            return True
        if isinstance(dec, ast.Call):
            fname = ctx.dotted(dec.func)
            if fname in JIT_WRAPPERS:
                return True
            # @partial(jax.jit, static_argnums=...)
            if fname in ("functools.partial", "partial") and dec.args \
                    and ctx.dotted(dec.args[0]) in JIT_WRAPPERS:
                return True
    return False


def _mark_traced(ctx: ModuleContext) -> None:
    """Populate ctx.traced_fns: decorator-jitted functions, functions
    passed to jit()/lax.scan()-style tracers, and their nested defs."""
    # function name -> def nodes (disambiguated by scope at the use site)
    defs_by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)
            if _jit_decorated(node, ctx):
                ctx.traced_fns.add(node)

    def mark_arg(arg: ast.AST, use_site: ast.AST) -> None:
        if isinstance(arg, ast.Lambda):
            ctx.traced_fns.add(arg)
        elif isinstance(arg, ast.Name):
            # Resolve the name lexically: only defs whose scope encloses
            # the use site are candidates (a method named `update` must
            # not be marked because a nested `def update` was jitted).
            visible_scopes = [None] + ctx.enclosing_functions(use_site)
            candidates = [
                d for d in defs_by_name.get(arg.id, [])
                if ctx.enclosing_function(d) in visible_scopes]
            if candidates:
                # innermost visible scope wins
                def depth(d: ast.AST) -> int:
                    return len(ctx.enclosing_functions(d))
                best = max(depth(d) for d in candidates)
                for d in candidates:
                    if depth(d) == best:
                        ctx.traced_fns.add(d)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = ctx.call_name(node)
        if fname in JIT_WRAPPERS:
            # jax.jit(f) / jax.jit(f, donate_argnums=...)
            for arg in node.args[:1]:
                mark_arg(arg, node)
        elif fname in TRACING_CALLS:
            # lax.scan(body, ...), lax.cond(p, t, f, ...): every leading
            # callable argument is traced
            for arg in node.args:
                if isinstance(arg, (ast.Lambda, ast.Name)):
                    mark_arg(arg, node)
        elif fname in ("functools.partial", "partial") and node.args \
                and ctx.dotted(node.args[0]) in JIT_WRAPPERS:
            for arg in node.args[1:2]:
                mark_arg(arg, node)
    # nested defs inside a traced function trace with it
    changed = True
    while changed:
        changed = False
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) \
                    and node not in ctx.traced_fns \
                    and any(fn in ctx.traced_fns
                            for fn in ctx.enclosing_functions(node)):
                ctx.traced_fns.add(node)
                changed = True


def build_context(source: str, path: str) -> ModuleContext:
    tree = ast.parse(source, filename=path)
    ctx = ModuleContext(path=path, tree=tree,
                        source_lines=source.splitlines())
    ctx.aliases = _collect_aliases(tree)
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            ctx.parents[child] = node
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _is_remote_decorated(node, ctx):
            ctx.actor_classes.add(node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _is_remote_decorated(node, ctx):
            ctx.remote_fns.add(node)
    _mark_traced(ctx)
    return ctx


def _suppressions(source_lines: List[str]) -> Dict[int, Set[str]]:
    """1-based line -> set of suppressed rule ids ('ALL' wildcards)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source_lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            rules = {r.strip().upper() for r in m.group(1).split(",")
                     if r.strip()}
            out[i] = rules
    return out


def _suppressed(finding: Finding, supp: Dict[int, Set[str]]) -> bool:
    for line in (finding.line, finding.line - 1):
        rules = supp.get(line)
        if rules and (finding.rule_id.upper() in rules or "ALL" in rules):
            return True
    return False


def _is_project_rule(rule) -> bool:
    """Project rules extract JSON-able per-file FACTS (cache-friendly)
    and analyze them across the whole linted set (RT016's lock-order
    graph spans files); the engine never calls their per-file check."""
    return hasattr(rule, "collect_facts")


def _check_file(ctx: ModuleContext) -> tuple:
    """All per-file findings (suppressions applied) + per-rule facts
    for project rules. Always computed for the FULL rule set so cache
    entries stay valid whatever --select/--ignore the next run uses."""
    from ray_tpu_torch.lint.rules import ALL_RULES
    supp = _suppressions(ctx.source_lines)
    findings: List[Finding] = []
    facts: Dict[str, object] = {}
    for rule in ALL_RULES:
        if _is_project_rule(rule):
            facts[rule.id] = rule.collect_facts(ctx)
            continue
        for f in rule.check(ctx):
            if not _suppressed(f, supp):
                findings.append(f)
    return findings, facts, supp


def _project_findings(facts_by_rule: Dict[str, Dict[str, object]],
                      supp_by_path: Dict[str, Dict[int, Set[str]]]
                      ) -> List[Finding]:
    from ray_tpu_torch.lint.rules import ALL_RULES
    findings: List[Finding] = []
    for rule in ALL_RULES:
        if not _is_project_rule(rule):
            continue
        for f in rule.project_check(facts_by_rule.get(rule.id, {})):
            supp = supp_by_path.get(f.path, {})
            if not _suppressed(f, supp):
                findings.append(f)
    return findings


def _filtered(findings: List[Finding],
              select: Optional[Sequence[str]],
              ignore: Optional[Sequence[str]]) -> List[Finding]:
    selected = {s.upper() for s in select} if select else None
    ignored = {s.upper() for s in ignore} if ignore else set()
    out = [f for f in findings
           if (selected is None or f.rule_id in selected)
           and f.rule_id not in ignored]
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return out


def lint_source(source: str, path: str = "<string>",
                select: Optional[Sequence[str]] = None,
                ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    try:
        ctx = build_context(source, path)
    except SyntaxError as e:
        return [Finding("RT000", path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}")]
    findings, facts, supp = _check_file(ctx)
    findings += _project_findings(
        {rid: {path: fct} for rid, fct in facts.items()}, {path: supp})
    return _filtered(findings, select, ignore)


def lint_file(path: str, select: Optional[Sequence[str]] = None,
              ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path, select=select, ignore=ignore)


def iter_python_files(paths: Sequence[str]) -> List[str]:
    """Expand paths to .py files. A path that does not exist raises —
    silently linting nothing would turn a typo'd CI invocation into a
    green zero-findings gate."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git", "native")]
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        elif os.path.isfile(p):
            # explicitly-named files are linted regardless of suffix
            out.append(p)
        else:
            raise FileNotFoundError(f"no such file or directory: {p!r}")
    return out


# ---------------------------------------------------------------------
# Incremental lint: on-disk cache keyed by file content hash
# ---------------------------------------------------------------------


# Cached-payload schema: bumped when the cache's SHAPE changes (finding
# dict fields, project-fact formats) so entries written by an older
# engine can never be misread, even in the degenerate case where the
# package sources hash identically (e.g. a revert). 2 = the jaxrules
# layer's donation/leak fact schemas (RT020..RT023).
CACHE_SCHEMA = 2


def _ruleset_fingerprint() -> str:
    """Hash of the lint package's own sources (+ CACHE_SCHEMA): an
    edited rule must invalidate every cache entry, or stale findings
    would gate CI."""
    import hashlib
    h = hashlib.sha1()
    h.update(str(CACHE_SCHEMA).encode())
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(pkg_dir)):
        if name.endswith(".py"):
            with open(os.path.join(pkg_dir, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()


def _load_cache(cache_path: str) -> Dict[str, object]:
    import json
    try:
        with open(cache_path, "r", encoding="utf-8") as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return {"files": {}}
    if cache.get("version") != _ruleset_fingerprint():
        return {"files": {}}
    return cache


def _save_cache(cache_path: str, cache: Dict[str, object]) -> None:
    import json
    cache["version"] = _ruleset_fingerprint()
    tmp = f"{cache_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(cache, f)
        os.replace(tmp, cache_path)  # atomic: a raced run sees old or new
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:  # noqa: BLE001 - cache is an optimization; a
            pass         # read-only tree just lints uncached


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None,
               cache_path: Optional[str] = None,
               only_files: Optional[Sequence[str]] = None
               ) -> List[Finding]:
    """Lint files/directories. With `cache_path`, per-file findings and
    project-rule facts are reused when the file's content hash matches
    (rule-set fingerprinted), so a warm zero-findings baseline run
    costs one hash per file instead of a parse + 16 rules. Project
    rules always re-analyze over the (cached or fresh) facts of EVERY
    enumerated file — cross-file lock-order cycles stay sound under
    incremental runs. `only_files` restricts which files' findings are
    REPORTED (tools/lint.py --changed) without shrinking the project
    graph."""
    import hashlib
    files = iter_python_files(paths)
    cache = _load_cache(cache_path) if cache_path else {"files": {}}
    cached_files: Dict[str, Dict] = cache.get("files", {})  # type: ignore
    new_files: Dict[str, Dict] = {}
    findings: List[Finding] = []
    facts_by_rule: Dict[str, Dict[str, object]] = {}
    supp_by_path: Dict[str, Dict[int, Set[str]]] = {}
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            findings.append(Finding("RT000", path, 1, 0,
                                    f"unreadable: {e}"))
            continue
        key = os.path.abspath(path)
        h = hashlib.sha1(source.encode("utf-8",
                                       "surrogatepass")).hexdigest()
        ent = cached_files.get(key)
        if ent is not None and ent.get("hash") == h:
            file_findings = [Finding(**fd) for fd in ent["findings"]]
            facts = ent.get("facts", {})
            supp = {int(ln): set(rs)
                    for ln, rs in ent.get("supp", {}).items()}
        else:
            try:
                ctx = build_context(source, path)
            except SyntaxError as e:
                findings.append(Finding("RT000", path, e.lineno or 1,
                                        e.offset or 0,
                                        f"syntax error: {e.msg}"))
                continue
            file_findings, facts, supp = _check_file(ctx)
        new_files[key] = {
            "hash": h,
            "findings": [{"rule_id": f.rule_id, "path": f.path,
                          "line": f.line, "col": f.col,
                          "message": f.message} for f in file_findings],
            "facts": facts,
            "supp": {str(ln): sorted(rs) for ln, rs in supp.items()},
        }
        findings.extend(file_findings)
        supp_by_path[path] = supp
        for rid, fct in facts.items():
            facts_by_rule.setdefault(rid, {})[path] = fct
    findings += _project_findings(facts_by_rule, supp_by_path)
    if cache_path:
        _save_cache(cache_path, {"files": new_files})
    if only_files is not None:
        wanted = {os.path.abspath(p) for p in only_files}
        findings = [f for f in findings
                    if os.path.abspath(f.path) in wanted]
    return _filtered(findings, select, ignore)

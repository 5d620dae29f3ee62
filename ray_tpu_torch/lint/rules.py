"""graftlint rule set: 23 framework-aware checks.

Each rule has a stable id (RT001..RT023), a one-line rationale, and a
`check(ctx)` generator yielding Findings. Rules are deliberately
conservative: a finding should be actionable, and intentional
exceptions are silenced in-place with `# graftlint: disable=RTxxx`
comments that double as documentation.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator, List, Optional, Set

from ray_tpu_torch.lint.engine import Finding, ModuleContext

# Calls that block the calling worker thread until remote work finishes.
BLOCKING_GET = {"ray_tpu_torch.get", "ray.get"}
BLOCKING_WAIT = {"ray_tpu_torch.wait", "ray.wait"}

# Host-side-effect callables that silently bake into (or retrigger) an
# XLA trace instead of running per step.
HOST_EFFECT_EXACT = {"print", "input", "open", "breakpoint"}
HOST_EFFECT_PREFIX = ("time.", "numpy.random.", "np.random.", "os.system",
                      "subprocess.", "logging.", "random.")
# jax.debug.* and jax.random are the traced-safe alternatives.
HOST_EFFECT_ALLOWED_PREFIX = ("jax.",)

MUTATING_METHODS = {"append", "extend", "add", "update", "insert",
                    "setdefault", "popitem", "clear", "remove",
                    "discard"}


class Rule:
    id: str = "RT000"
    name: str = "base"
    rationale: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


def _blocking_calls(ctx: ModuleContext, include_wait: bool = True
                    ) -> Iterator[ast.Call]:
    names = BLOCKING_GET | (BLOCKING_WAIT if include_wait else set())
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and ctx.call_name(node) in names:
            yield node


def _in_remote_context(ctx: ModuleContext, node: ast.AST) -> Optional[str]:
    """Name of the enclosing actor method / remote function, if any."""
    fns = ctx.enclosing_functions(node)
    for fn in fns:
        if fn in ctx.remote_fns:
            return f"remote function '{getattr(fn, 'name', '<lambda>')}'"
    # a method of a @remote class: innermost non-lambda function whose
    # enclosing class is an actor class
    for fn in fns:
        cls = ctx.enclosing_class(fn)
        if cls is not None and cls in ctx.actor_classes:
            return (f"actor method "
                    f"'{cls.name}.{getattr(fn, 'name', '<lambda>')}'")
    return None


class NestedBlockingGet(Rule):
    id = "RT001"
    name = "nested-blocking-get"
    rationale = ("blocking get()/wait() inside an actor method or remote "
                 "function holds its executor thread while waiting on "
                 "other remote work - mutual calls deadlock the cluster")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for call in _blocking_calls(ctx):
            where = _in_remote_context(ctx, call)
            if where is not None:
                fn = ctx.call_name(call)
                yield self.finding(
                    ctx, call,
                    f"blocking {fn}() inside {where}: a cycle of such "
                    f"calls deadlocks (return the ObjectRef, use an "
                    f"async method, or raise max_concurrency)")


class GetInLoop(Rule):
    id = "RT002"
    name = "get-in-loop"
    rationale = ("get() in a loop serializes the trajectory plane: each "
                 "iteration round-trips before the next task is even "
                 "looked at")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for call in _blocking_calls(ctx, include_wait=False):
            loops = ctx.loops_between(call)
            if loops:
                fn = ctx.call_name(call)
                yield self.finding(
                    ctx, call,
                    f"{fn}() inside a loop serializes on each result: "
                    f"batch refs and call {fn}(refs) once, or drain "
                    f"with wait(refs) as results land")


class HostEffectInJit(Rule):
    id = "RT003"
    name = "host-side-effect-in-jit"
    rationale = ("host callables inside jit/scan bodies run once at trace "
                 "time (stale values baked in) or force retraces - use "
                 "jax.debug.print / jax.random instead")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or not ctx.in_traced_code(node):
                continue
            name = ctx.call_name(node)
            if name is None:
                continue
            if name.startswith(HOST_EFFECT_ALLOWED_PREFIX):
                continue
            if name in HOST_EFFECT_EXACT or \
                    name.startswith(HOST_EFFECT_PREFIX):
                yield self.finding(
                    ctx, node,
                    f"host call {name}() inside a jit/scan-traced "
                    f"function executes at trace time, not per step "
                    f"(use jax.debug.print / jax.random, or hoist it "
                    f"out of the traced body)")


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names bound inside a function: params, assignments, loop/with
    targets, comprehension targets, local defs."""
    bound: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            bound.add(a.arg)
        if args.vararg:
            bound.add(args.vararg.arg)
        if args.kwarg:
            bound.add(args.kwarg.arg)

    def add_target(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            bound.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add_target(e)
        elif isinstance(t, ast.Starred):
            add_target(t.value)

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                add_target(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            add_target(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            add_target(node.target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    add_target(item.optional_vars)
        elif isinstance(node, ast.comprehension):
            add_target(node.target)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and node is not fn:
            bound.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                bound.add((a.asname or a.name).split(".")[0])
    return bound


class ClosureMutationInJit(Rule):
    id = "RT004"
    name = "closure-mutation-in-jit"
    rationale = ("mutating closed-over state inside a traced function "
                 "happens once at trace time - subsequent calls reuse "
                 "the compiled program and the mutation never reruns")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ctx.traced_fns:
            if isinstance(fn, ast.Lambda):
                continue  # lambdas cannot contain statements
            bound = _bound_names(fn)
            for node in ast.walk(fn):
                if node is fn:
                    continue
                # nested defs are themselves in traced_fns; their bodies
                # report against their own (tighter) bound-name sets
                if ctx.enclosing_function(node) is not fn:
                    continue
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    yield self.finding(
                        ctx, node,
                        f"{'global' if isinstance(node, ast.Global) else 'nonlocal'} "
                        f"write inside a traced function only happens at "
                        f"trace time; thread state through the function's "
                        f"inputs/outputs instead")
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            yield self.finding(
                                ctx, t,
                                f"assignment to self.{t.attr} inside a "
                                f"traced function mutates untraced host "
                                f"state; return the new value instead")
                        elif isinstance(t, ast.Subscript) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id not in bound:
                            yield self.finding(
                                ctx, t,
                                f"item assignment on closed-over "
                                f"'{t.value.id}' inside a traced function "
                                f"is a trace-time side effect")
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in MUTATING_METHODS and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id not in bound and \
                        node.func.value.id != "self" and \
                        isinstance(ctx.parent(node), ast.Expr):
                    # result discarded => called for the side effect;
                    # `u, s = optimizer.update(...)`-style pure APIs
                    # (optax) assign the result and are fine
                    yield self.finding(
                        ctx, node,
                        f"mutating call "
                        f"{node.func.value.id}.{node.func.attr}() on "
                        f"closed-over state inside a traced function is "
                        f"a trace-time side effect")


class ActorCallWithoutRemote(Rule):
    id = "RT005"
    name = "actor-call-without-remote"
    rationale = ("calling handle.method(...) runs nothing: actor methods "
                 "execute only via handle.method.remote(...)")

    _HANDLE_OK_ATTRS = {"remote", "options", "bind"}

    def _scope_nodes(self, fn: ast.AST, ctx: ModuleContext):
        """Nodes belonging directly to this scope (module scope must not
        re-walk function bodies — they are their own scopes)."""
        scope = None if fn is ctx.tree else fn
        for node in ast.walk(fn):
            if ctx.enclosing_function(node) is scope:
                yield node

    def _handle_names(self, fn: ast.AST, ctx: ModuleContext) -> Set[str]:
        """Names assigned from ActorClass.remote(...) /
        .options(...).remote(...) within this scope, where ActorClass
        is a @remote class defined in this module."""
        actor_names = {c.name for c in ctx.actor_classes}
        handles: Set[str] = set()
        for node in self._scope_nodes(fn, ctx):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            call = node.value
            func = call.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr == "remote"):
                continue
            root = func.value
            # unwrap Class.options(...).remote(...)
            if isinstance(root, ast.Call) and \
                    isinstance(root.func, ast.Attribute) and \
                    root.func.attr == "options":
                root = root.func.value
            if isinstance(root, ast.Name) and root.id in actor_names:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        handles.add(t.id)
        return handles

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        fns = [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        fns.append(ctx.tree)
        for fn in fns:
            handles = self._handle_names(fn, ctx)
            if not handles:
                continue
            for node in self._scope_nodes(fn, ctx):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id in handles and \
                        node.func.attr not in self._HANDLE_OK_ATTRS and \
                        not node.func.attr.startswith("_"):
                    yield self.finding(
                        ctx, node,
                        f"'{node.func.value.id}.{node.func.attr}(...)' "
                        f"calls an actor method without .remote() - it "
                        f"raises at runtime; use "
                        f".{node.func.attr}.remote(...)")


class LeakedObjectRef(Rule):
    id = "RT006"
    name = "leaked-objectref"
    rationale = ("a .remote() result that is never stored, awaited or "
                 "passed on cannot be gotten, waited or cancelled - the "
                 "task's result (and error!) vanish")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Expr) and \
                    isinstance(node.value, ast.Call) and \
                    isinstance(node.value.func, ast.Attribute) and \
                    node.value.func.attr == "remote":
                yield self.finding(
                    ctx, node,
                    "discarded .remote() call leaks its ObjectRef: "
                    "errors are silently dropped and the result is "
                    "unreachable; keep the ref (get/wait it) or note "
                    "why fire-and-forget is safe")


class DictOrderPytree(Rule):
    id = "RT007"
    name = "dict-order-pytree"
    rationale = ("pytree construction by dict iteration inside traced "
                 "code bakes one process's insertion order into the "
                 "compiled program - ranks built in a different order "
                 "desync collectives/checkpoints; iterate sorted(...)")

    _DICT_ITERS = {"items", "keys", "values"}

    def _uses_trees(self, fn: ast.AST, ctx: ModuleContext) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = ctx.call_name(node) or ""
                if name.startswith(("jax.tree", "jax.tree_util",
                                    "tree_map", "tree_flatten")):
                    return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            iters: List[ast.AST] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                if not (isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Attribute)
                        and it.func.attr in self._DICT_ITERS):
                    continue
                fn = ctx.enclosing_function(node)
                traced = ctx.in_traced_code(node)
                treey = fn is not None and self._uses_trees(fn, ctx)
                if traced or treey:
                    yield self.finding(
                        ctx, it,
                        f"pytree built by iterating .{it.func.attr}() in "
                        f"{'traced' if traced else 'tree-manipulating'} "
                        f"code depends on dict insertion order; wrap in "
                        f"sorted(...) for a rank-stable structure")


class SwallowedException(Rule):
    id = "RT008"
    name = "swallowed-exception"
    rationale = ("a bare except (or except-pass in a forever loop) eats "
                 "KeyboardInterrupt/SystemExit and turns actor-loop "
                 "crashes into silent hangs")

    def _is_forever_loop(self, node: ast.While) -> bool:
        return isinstance(node.test, ast.Constant) and \
            bool(node.test.value)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            has_raise = any(isinstance(n, ast.Raise)
                            for n in ast.walk(node))
            if node.type is None and not has_raise:
                yield self.finding(
                    ctx, node,
                    "bare 'except:' swallows KeyboardInterrupt and "
                    "SystemExit; catch Exception (or narrower) and "
                    "log/handle it")
                continue
            # except Exception: pass  inside a while True loop: the
            # actor event-loop keeps spinning with the failure invisible
            body_is_noop = all(isinstance(n, (ast.Pass, ast.Continue))
                               for n in node.body)
            if body_is_noop and node.type is not None and \
                    ctx.dotted(node.type) in ("Exception", "BaseException"):
                in_forever = any(
                    isinstance(a, ast.While) and self._is_forever_loop(a)
                    for a in ctx.ancestors(node))
                fn_between = ctx.enclosing_function(node)
                loop_fn_ok = True
                if in_forever and fn_between is not None:
                    # the while True must be in the same function
                    loop_fn_ok = any(
                        isinstance(a, ast.While)
                        and self._is_forever_loop(a)
                        for a in ctx.ancestors(node)
                        if ctx.enclosing_function(a) is fn_between)
                if in_forever and loop_fn_ok:
                    yield self.finding(
                        ctx, node,
                        "except-and-ignore inside a forever loop hides "
                        "every failure of this event loop; at minimum "
                        "log the exception before continuing")


class StoreViewCopy(Rule):
    id = "RT009"
    name = "store-view-copy"
    rationale = ("bytes(view) / memoryview(bytes(...)) on a "
                 "store-returned buffer copies the payload and defeats "
                 "the zero-copy object plane - hold the view (pin the "
                 "object for long-lived use) instead")

    # The store implementation itself legitimately materializes bytes
    # (chunked cross-node reads, small-object RPC payloads).
    _EXEMPT_SUFFIXES = ("_private/object_store.py", "native/__init__.py")

    # attribute calls whose result is a shm-backed view when the
    # receiver is store-/arena-shaped
    _VIEW_METHODS = {"view", "pull", "get"}

    def _store_like(self, ctx: ModuleContext, node: ast.AST) -> bool:
        name = ctx.dotted(node)
        if name is None:
            # self.store.get(...): dotted() fails on self-attributes;
            # fall back to the attribute chain's text
            parts = []
            cur = node
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                parts.append(cur.id)
            name = ".".join(reversed(parts))
        return "store" in name.lower() or "arena" in name.lower()

    def _is_view_call(self, ctx: ModuleContext, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self._VIEW_METHODS
                and self._store_like(ctx, node.func.value))

    def _view_names(self, fn: ast.AST, ctx: ModuleContext) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    self._is_view_call(ctx, node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.path.replace("\\", "/").endswith(self._EXEMPT_SUFFIXES):
            return
        view_names_cache: dict = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            if node.func.id == "memoryview" and node.args and \
                    isinstance(node.args[0], ast.Call) and \
                    isinstance(node.args[0].func, ast.Name) and \
                    node.args[0].func.id == "bytes":
                yield self.finding(
                    ctx, node,
                    "memoryview(bytes(...)) materializes a full copy of "
                    "the buffer; keep the original view (pin the object "
                    "if it must outlive the ref)")
                continue
            if node.func.id != "bytes" or not node.args:
                continue
            arg = node.args[0]
            # unwrap bytes(store.get([...])[oid]) / slices of a view
            while isinstance(arg, ast.Subscript):
                arg = arg.value
            if self._is_view_call(ctx, arg):
                yield self.finding(
                    ctx, node,
                    "bytes(...) over a store view copies the whole "
                    "payload out of shared memory; use the view "
                    "zero-copy (pin the object for long-lived use)")
            elif isinstance(arg, ast.Name):
                scope = ctx.enclosing_function(node) or ctx.tree
                if scope not in view_names_cache:
                    view_names_cache[scope] = self._view_names(scope, ctx)
                if arg.id in view_names_cache[scope]:
                    yield self.finding(
                        ctx, node,
                        f"bytes({arg.id}) copies a store-returned view "
                        f"out of shared memory; use it zero-copy (pin "
                        f"the object for long-lived use)")


class WallClockDuration(Rule):
    id = "RT010"
    name = "wall-clock-duration"
    rationale = ("time.time() differences measure the WALL clock, which "
                 "jumps under NTP slew/suspend - durations, deadlines "
                 "and span/metric timings must use time.monotonic() or "
                 "time.perf_counter()")

    _WALL_CALLS = {"time.time"}

    def _is_wall_call(self, ctx: ModuleContext, node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            ctx.call_name(node) in self._WALL_CALLS

    def _wall_names(self, scope: ast.AST, ctx: ModuleContext) -> Set[str]:
        """Names assigned (in this scope) from an expression containing a
        direct time.time() call — `t0 = time.time()`,
        `deadline = time.time() + timeout`, conditional variants."""
        names: Set[str] = set()
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            if ctx.enclosing_function(node) is not (
                    None if scope is ctx.tree else scope):
                continue
            if any(self._is_wall_call(ctx, n)
                   for n in ast.walk(node.value)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names

    _ORDER_OPS = (ast.Lt, ast.LtE, ast.Gt, ast.GtE)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        wall_names_cache: dict = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                operands = (node.left, node.right)
            elif isinstance(node, ast.Compare) and any(
                    isinstance(op, self._ORDER_OPS) for op in node.ops):
                # Ordering comparisons are the deadline/TTL-expiry form:
                # `time.time() < deadline`, `entry_ts <= now`.
                operands = (node.left, *node.comparators)
            else:
                continue
            direct = any(self._is_wall_call(ctx, o) for o in operands)
            via_name = False
            if not direct:
                scope = ctx.enclosing_function(node) or ctx.tree
                if scope not in wall_names_cache:
                    wall_names_cache[scope] = self._wall_names(scope, ctx)
                via_name = any(isinstance(o, ast.Name)
                               and o.id in wall_names_cache[scope]
                               for o in operands)
            if direct or via_name:
                yield self.finding(
                    ctx, node,
                    "duration computed from time.time() jumps when the "
                    "wall clock is adjusted; use time.monotonic() (for "
                    "deadlines) or time.perf_counter() (for timings)")


class MetricNameConvention(Rule):
    id = "RT011"
    name = "metric-name-convention"
    rationale = ("Prometheus-convention metric names keep the merged "
                 "cluster endpoint queryable: counters end in _total, "
                 "timing/size histograms carry _seconds/_bytes units, "
                 "and per-entity id tag keys explode series cardinality")

    _METRIC_MODULES = ("ray_tpu_torch.util.metrics.", "ray.util.metrics.")
    _KINDS = {"Counter", "Gauge", "Histogram"}
    # spellings of units that have one canonical suffix
    _BAD_UNIT_SUFFIXES = ("_ms", "_us", "_msec", "_usec", "_sec",
                          "_secs", "_time", "_kb", "_mb", "_gb",
                          "_size")
    _GOOD_HIST_SUFFIXES = ("_seconds", "_bytes")
    # tag keys whose value space grows with cluster activity: one series
    # per object/task would melt any scrape backend
    _HIGH_CARDINALITY_KEYS = {"object_id", "task_id", "actor_id",
                              "worker_id", "lease_id", "trace_id",
                              "oid", "ref", "object_ref", "pid"}

    def _metric_kind(self, ctx: ModuleContext,
                     node: ast.Call) -> Optional[str]:
        """'Counter'/'Gauge'/'Histogram' when this call constructs a
        ray_tpu metric (direct constructor or get_or_create(Cls, ...)),
        resolved through import aliases so unrelated locally-defined
        classes that happen to share a name are not flagged."""
        name = ctx.call_name(node)
        if name is None:
            return None
        if name.split(".")[-1] == "get_or_create":
            if not node.args:
                return None
            cls = ctx.dotted(node.args[0])
        else:
            cls = name
        if cls is None:
            return None
        qualified = any(s.startswith(self._METRIC_MODULES)
                        for s in (name, cls))
        if not qualified:
            return None
        kind = cls.split(".")[-1]
        return kind if kind in self._KINDS else None

    @staticmethod
    def _const_str(node: Optional[ast.AST]) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    def _call_arg(self, node: ast.Call, pos: int,
                  kw: str) -> Optional[ast.AST]:
        for k in node.keywords:
            if k.arg == kw:
                return k.value
        return node.args[pos] if len(node.args) > pos else None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = self._metric_kind(ctx, node)
            if kind is None:
                continue
            is_factory = (ctx.call_name(node) or "").endswith(
                "get_or_create")
            name_pos = 1 if is_factory else 0
            name = self._const_str(
                self._call_arg(node, name_pos, "name"))
            if name is not None:
                if kind == "Counter" and not name.endswith("_total"):
                    yield self.finding(
                        ctx, node,
                        f"counter {name!r} must end in '_total' "
                        f"(Prometheus counter convention; rate() "
                        f"queries key on it)")
                if kind != "Counter" and name.endswith("_total"):
                    yield self.finding(
                        ctx, node,
                        f"{kind.lower()} {name!r} ends in '_total', "
                        f"which marks counters; pick a point-in-time "
                        f"name")
                if name.endswith(self._BAD_UNIT_SUFFIXES):
                    yield self.finding(
                        ctx, node,
                        f"metric {name!r} uses a non-canonical unit "
                        f"suffix; use base units '_seconds' / '_bytes'")
                elif kind == "Histogram" and not name.endswith(
                        self._GOOD_HIST_SUFFIXES):
                    yield self.finding(
                        ctx, node,
                        f"histogram {name!r} should name its unit with "
                        f"a '_seconds' or '_bytes' suffix (histograms "
                        f"measure durations or sizes)")
            # tag_keys position in the constructors: Counter/Gauge
            # (name, description, tag_keys), Histogram adds boundaries
            # before it; get_or_create passes them as kwargs only
            pos = 99 if is_factory else (3 if kind == "Histogram" else 2)
            tag_keys = self._call_arg(node, pos, "tag_keys")
            if isinstance(tag_keys, (ast.Tuple, ast.List)):
                for elt in tag_keys.elts:
                    key = self._const_str(elt)
                    if key is not None and \
                            key in self._HIGH_CARDINALITY_KEYS:
                        yield self.finding(
                            ctx, elt,
                            f"tag key {key!r} is per-entity: one "
                            f"series per {key} makes cardinality grow "
                            f"with cluster activity; aggregate or put "
                            f"the id in logs/events instead")


class BarePrintInFramework(Rule):
    id = "RT012"
    name = "bare-print-in-framework"
    rationale = ("framework diagnostics must go through `logging` so "
                 "they enter the log plane (attribution-stamped, "
                 "tail-indexed, flood-controlled — see "
                 "_private/log_plane.py); a bare print() line is "
                 "unstamped and invisible to `ray_tpu logs` filters")

    # Paths whose whole PURPOSE is writing to a terminal: tests, dev
    # tools, examples, CLI entry points. Everything else in the
    # framework tree is daemon/library code whose output lands in (or
    # should land in) worker log files.
    _EXEMPT_DIR_PARTS = frozenset(
        {"tests", "test", "tools", "examples", "benchmarks", "scripts"})

    def _exempt(self, path: str) -> bool:
        parts = [p for p in re.split(r"[\\/]", path) if p]
        if set(parts) & self._EXEMPT_DIR_PARTS:
            return True
        base = os.path.basename(path)
        return base == "__main__.py" or base.startswith("test_")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if self._exempt(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and ctx.call_name(node) == "print":
                yield self.finding(
                    ctx, node,
                    "bare print() in framework code: route diagnostics "
                    "through `logging` so the line enters the log "
                    "plane with task/actor/trace attribution (stdout "
                    "sinks — CLIs, machine-readable handshakes — "
                    "suppress with `# graftlint: disable=RT012`)")


class SilentExceptionSwallow(Rule):
    id = "RT013"
    name = "silent-exception-swallow"
    rationale = ("a broad `except Exception: pass` on a framework "
                 "fan-out/state path makes partial failures invisible "
                 "— a node silently missing from a gather reads as a "
                 "healthy empty result; the handler must log the "
                 "error, record it (counter, reply field, unreachable "
                 "list), or carry a written justification of why "
                 "swallowing is correct")

    # Same surface split as RT012: code whose purpose is a terminal.
    _EXEMPT_DIR_PARTS = frozenset(
        {"tests", "test", "tools", "examples", "benchmarks", "scripts"})
    # lint-code chunks that do NOT count as justification prose
    _CODES_RE = re.compile(
        r"noqa:?\s*[A-Z0-9, ]*|graftlint:\s*disable=[A-Za-z0-9_,\s]*")

    def _exempt(self, path: str) -> bool:
        parts = [p for p in re.split(r"[\\/]", path) if p]
        if set(parts) & self._EXEMPT_DIR_PARTS:
            return True
        base = os.path.basename(path)
        return base == "__main__.py" or base.startswith("test_")

    def _prose(self, comment: str) -> bool:
        """True when the comment contains an actual explanation beyond
        lint codes — `# noqa: BLE001 - peer gone mid-collect` is a
        justified suppression, bare `# noqa: BLE001` is not."""
        text = self._CODES_RE.sub("", comment).strip(" #-—:\t")
        return len(text) >= 8 and any(c.isalpha() for c in text)

    def _justified(self, ctx: ModuleContext, node: ast.ExceptHandler
                   ) -> bool:
        end = max(s.lineno for s in node.body)
        for lineno in range(node.lineno, end + 1):
            line = ctx.source_lines[lineno - 1] \
                if lineno - 1 < len(ctx.source_lines) else ""
            if "#" in line and self._prose(line[line.index("#"):]):
                return True
        # comment-only lines directly ABOVE the except count too (the
        # idiomatic spot when the reason doesn't fit the except line)
        for lineno in range(node.lineno - 1, max(0, node.lineno - 3), -1):
            line = ctx.source_lines[lineno - 1].strip() \
                if lineno - 1 < len(ctx.source_lines) else ""
            if not line.startswith("#"):
                break
            if self._prose(line):
                return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if self._exempt(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler) \
                    or node.type is None:
                continue  # bare except is RT008's
            elts = node.type.elts if isinstance(node.type, ast.Tuple) \
                else [node.type]
            names = {ctx.dotted(e) for e in elts}
            if not names & {"Exception", "BaseException"}:
                continue
            if not all(isinstance(s, (ast.Pass, ast.Continue))
                       for s in node.body):
                continue  # handler does SOMETHING with the failure
            if self._justified(ctx, node):
                continue
            yield self.finding(
                ctx, node,
                "except Exception with a pass-only body silently "
                "swallows every failure here; log it, record it "
                "(counter / reply field / unreachable list), or state "
                "the reason swallowing is safe in the comment "
                "(`# noqa: BLE001 - <why>`)")


class UnboundedWaitInServingPath(Rule):
    id = "RT017"
    name = "unbounded-wait-in-serving-path"
    rationale = ("blocking ray_tpu_torch.get()/wait() without an explicit "
                 "finite timeout in request-serving paths (serve/, "
                 "dashboard/) turns overload into hangs: one stuck "
                 "replica or store pull parks a proxy/handler thread "
                 "forever, and a saturated thread pool collapses "
                 "instead of shedding load")

    # Directories whose code sits on a request-serving path: every
    # thread there is a bounded resource a client is waiting on.
    _SERVING_DIR_PARTS = frozenset({"serve", "dashboard"})

    def _serving(self, path: str) -> bool:
        # DIRECTORY parts only — tools/bench_serve.py is a harness, not
        # a serving path; its basename merely contains "serve"
        parts = [p for p in re.split(r"[\\/]", path) if p][:-1]
        return bool(set(parts) & self._SERVING_DIR_PARTS)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not self._serving(ctx.path):
            return
        for call in _blocking_calls(ctx):
            fn = ctx.call_name(call)
            timeout = next((k.value for k in call.keywords
                            if k.arg == "timeout"), None)
            unbounded = timeout is None or (
                isinstance(timeout, ast.Constant)
                and timeout.value is None)
            if unbounded:
                yield self.finding(
                    ctx, call,
                    f"{fn}() on a request-serving path without an "
                    f"explicit finite timeout= waits forever when a "
                    f"replica/store wedges — bound it (e.g. "
                    f"Config.serve_request_timeout_s) so overload "
                    f"sheds instead of hanging")


class OwnershipBookkeepingDiscipline(Rule):
    id = "RT018"
    name = "ownership-bookkeeping-discipline"
    rationale = ("the ownership protocol's count dicts (refcounts, pins, "
                 "borrower registrations, reader leases, lease "
                 "slots/parked/pipeline accounting) are state machines "
                 "whose invariants live in _private/ownership.py — a "
                 "direct mutation elsewhere bypasses the transition() "
                 "choke point, so double-releases and negative counts "
                 "corrupt silently instead of raising, and the "
                 "transition ring no longer explains the object")

    # Attribute names that ARE ownership-protocol state wherever they
    # appear in the framework (chosen to be distinctive; `leases` and
    # `pinned` exist only on protocol objects here).
    PROTECTED = frozenset({
        "local_refs", "arg_pins", "borrower_pins", "borrowed",
        "replica_leases", "_replica_leases", "nested_borrows",
        "_nested_borrows", "ttl_pins", "_ttl_pins", "_lease_running",
        "lease_inflight", "requests_in_flight", "parked_at", "leases",
        "pinned",
    })

    _MUTATORS = frozenset({
        "pop", "popitem", "setdefault", "clear", "update", "append",
        "appendleft", "extend", "remove", "discard", "add", "insert",
        "popleft",
    })

    _EXEMPT_SUFFIX = ("_private/ownership.py", "_private\\ownership.py")

    def _protected_attr(self, node: ast.AST) -> Optional[str]:
        """The protected attribute a mutation target reaches, if any:
        `x.arg_pins` itself or `x.arg_pins[...]`."""
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and node.attr in self.PROTECTED:
            return node.attr
        return None

    def _msg(self, attr: str, how: str) -> str:
        return (f"direct {how} of ownership-protocol state `{attr}` "
                f"outside _private/ownership.py bypasses the "
                f"transition() choke point — route it through the "
                f"RefTable/LeaseTable/store-ledger methods (or suppress "
                f"with `# graftlint: disable=RT018` if this attribute "
                f"is not protocol state)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.path.replace("\\", "/").endswith(
                self._EXEMPT_SUFFIX[0]):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    attr = self._protected_attr(tgt)
                    if attr is None:
                        continue
                    if isinstance(tgt, ast.Attribute):
                        # plain rebinding: aliasing another component's
                        # table (`self.arg_pins = self._own.arg_pins`)
                        # and constructing a ledger from the ownership
                        # module are the two legitimate forms
                        if isinstance(node.value, ast.Attribute):
                            continue
                        if isinstance(node.value, ast.Call):
                            fname = ctx.call_name(node.value) or ""
                            if "ownership" in fname:
                                continue
                    yield self.finding(ctx, node,
                                       self._msg(attr, "assignment"))
            elif isinstance(node, ast.AugAssign):
                attr = self._protected_attr(node.target)
                if attr is not None:
                    yield self.finding(
                        ctx, node, self._msg(attr, "augmented assignment"))
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    attr = self._protected_attr(tgt)
                    if attr is not None:
                        yield self.finding(ctx, node,
                                           self._msg(attr, "delete"))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self._MUTATORS:
                attr = self._protected_attr(node.func.value)
                if attr is not None:
                    yield self.finding(
                        ctx, node,
                        self._msg(attr, f"`.{node.func.attr}()` call"))


class BlockingCallInAsync(Rule):
    id = "RT019"
    name = "blocking-call-in-async"
    rationale = ("a blocking call (time.sleep, ray_tpu_torch.get/wait, raw "
                 "socket/file/subprocess ops) directly inside an "
                 "`async def` body stalls the whole event loop: every "
                 "other coroutine on that loop — every other request "
                 "on an ingress proxy — freezes for the call's "
                 "duration; bridge through run_in_executor or the "
                 "done-callback bridge (proxy_fleet/async_bridge.py) "
                 "instead")

    # beyond the shared blocking registry: calls that read files or
    # hit the network synchronously (the "raw file read" class)
    _EXTRA_DOTTED = frozenset({
        "open", "urllib.request.urlopen", "requests.get",
        "requests.post", "requests.put", "requests.delete",
        "socket.socket", "socket.getaddrinfo",
    })

    def _nearest_fn(self, ctx: ModuleContext, node: ast.AST):
        fns = ctx.enclosing_functions(node)
        return fns[0] if fns else None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        from ray_tpu_torch.lint.concurrency import match_blocking_call
        async_fns = [n for n in ast.walk(ctx.tree)
                     if isinstance(n, ast.AsyncFunctionDef)]
        for fn in async_fns:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                # only calls whose NEAREST enclosing function is this
                # async def: a sync closure/lambda shipped to
                # run_in_executor is the bridge pattern, not a finding
                if self._nearest_fn(ctx, node) is not fn:
                    continue
                # a call under an `await` expression is (part of) an
                # async call chain — asyncio.Event.wait(),
                # asyncio.wait_for(x.wait(), t) — not a thread block
                if any(isinstance(a, ast.Await)
                       for a in ctx.ancestors(node)):
                    continue
                desc = match_blocking_call(ctx, node)
                if desc is None:
                    dotted = ctx.call_name(node)
                    if dotted in self._EXTRA_DOTTED:
                        desc = f"{dotted}()"
                if desc is None:
                    continue
                yield self.finding(
                    ctx, node,
                    f"blocking {desc} inside async def "
                    f"'{fn.name}' stalls the event loop (and every "
                    f"request riding it) — await an async "
                    f"equivalent, run_in_executor, or the "
                    f"done-callback bridge")


# Concurrency layer (class-level guard maps + lock-order graph) lives
# in its own module; the rules plug into the same catalogue.
from ray_tpu_torch.lint.concurrency import (BlockingUnderLock,  # noqa: E402
                                      LockOrderCycle, MixedGuardAccess)
# Tensor hot-path layer (hidden syncs, leak-on-raise, unattributed
# sleeps) — the static half of the cuda_sentinel / goodput-ledger
# pairing. The JAX package's RT020 (jit recompiles) and RT022 (buffer
# donation) name mechanisms the eager port does not use.
from ray_tpu_torch.lint.torchrules import (HiddenHostSync,  # noqa: E402
                                           LeakOnRaise, UnattributedSleep)

ALL_RULES: List[Rule] = [
    NestedBlockingGet(), GetInLoop(), HostEffectInJit(),
    ClosureMutationInJit(), ActorCallWithoutRemote(), LeakedObjectRef(),
    DictOrderPytree(), SwallowedException(), StoreViewCopy(),
    WallClockDuration(), MetricNameConvention(), BarePrintInFramework(),
    SilentExceptionSwallow(), MixedGuardAccess(), BlockingUnderLock(),
    LockOrderCycle(), UnboundedWaitInServingPath(),
    OwnershipBookkeepingDiscipline(), BlockingCallInAsync(),
    HiddenHostSync(), LeakOnRaise(), UnattributedSleep(),
]

RULES_BY_ID = {r.id: r for r in ALL_RULES}

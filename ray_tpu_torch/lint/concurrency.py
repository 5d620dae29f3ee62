"""Concurrency analysis layer: guard maps, blocking registry, RT014-016.

Class-level (not just statement-level) analysis shared by the three
concurrency rules:

  - a **guard map** per class: which attributes are mutated under
    ``with self._lock:`` and which code paths touch them without it
    (RT014 mixed-guard access — the "unlocked insert racing a locked
    iteration" bug class);
  - a **blocking-call registry** (:data:`BLOCKING_DOTTED` /
    :data:`BLOCKING_ATTRS`): calls that park the calling thread on I/O
    or time, flagged while any lock is held (RT015 — one blocking RPC
    under a hot lock stalls every other path through that lock for the
    full RPC timeout). Condition-variable waits RELEASE the lock they
    guard and are allowlisted;
  - a **lock-order graph** over the whole linted tree: nested
    acquisitions produce directed edges, and a cycle means two paths
    take the same locks in opposite orders — a deadlock waiting for
    the right interleaving (RT016; the runtime twin is
    ray_tpu/util/locks.py's TracedLock edge graph + watchdog probe).

Cross-function inference: a private helper whose every intra-class
call site holds lock L is analyzed as running under L (the
``*_locked``-suffix naming convention is honored the same way), so a
blocking call or unguarded access two frames below the ``with`` block
is still attributed to the lock.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from ray_tpu_torch.lint.engine import Finding, ModuleContext

# ---------------------------------------------------------------------
# Blocking-call registry (RT015). Extend by appending — see README
# "Concurrency analysis".
# ---------------------------------------------------------------------

#: Dotted callable names that block the calling thread.
BLOCKING_DOTTED: Set[str] = {
    "time.sleep",
    "ray_tpu_torch.get", "ray.get", "ray_tpu_torch.wait", "ray.wait",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "socket.create_connection", "select.select",
}

#: Method names that block regardless of receiver type, with an
#: optional receiver-text regex narrowing the match (None = any
#: receiver). The receiver text is the dotted/source form of the
#: expression the method is called on.
BLOCKING_ATTRS: Dict[str, Optional[str]] = {
    # RPC round trips (RpcClient.call, gcs.call, pool.get(...).call)
    "call": None,
    # object-store client ops that wait on data
    "store_pull": None,
    "store_wait": None,
    # StoreClient methods that are RPC round trips under the hood
    # (object_store.py StoreClient.delete/pin/unpin/pull/stats/seal)
    "delete": r"(store|arena)",
    "pin": r"(store|arena)",
    "unpin": r"(store|arena)",
    "pull": r"(store|arena)",
    "stats": r"(store|arena)",
    "seal": r"(store|arena)",
    # raw socket ops
    "recv": None, "recv_into": None, "accept": None,
    "sendall": None, "makefile": None,
    "connect": r"(sock|conn)",
    # subprocess / futures
    "communicate": None,
    "result": r"(fut|future|promise)",
    # thread / process joins (str.join excluded by the receiver filter)
    "join": r"(thread|proc|worker|monitor|pool)",
}

#: ``.get(timeout=...)`` blocks (queue.Queue.get and friends); a
#: timeout keyword is what distinguishes it from dict.get.
BLOCKING_GET_WITH_TIMEOUT = "get"

#: ``.wait(...)`` blocks (Event.wait, Thread joins, bare waits) —
#: UNLESS the receiver is a condition variable built over the held
#: lock, whose wait() releases it. Receivers matching this regex are
#: treated as condition variables when type inference can't see the
#: ``threading.Condition(...)`` assignment.
_CONDVAR_NAME_RE = re.compile(r"(cond|_cv\b|cv$|not_empty|not_full)",
                              re.IGNORECASE)

_LOCK_NAME_RE = re.compile(r"lock|mutex", re.IGNORECASE)

# constructor name (last dotted component) -> lock kind
_LOCK_FACTORIES = {
    "Lock": "lock", "RLock": "rlock",
    "TracedLock": "lock", "TracedRLock": "rlock",
}

_MUTATING_METHODS = {
    "append", "extend", "add", "update", "insert", "setdefault",
    "pop", "popitem", "popleft", "appendleft", "clear", "remove",
    "discard", "sort", "reverse",
}

_ITERATING_CALLS = {"list", "tuple", "set", "dict", "sorted", "sum",
                    "min", "max", "any", "all", "frozenset"}

_DICT_ITERS = {"items", "keys", "values"}


def _attr_chain_text(node: ast.AST) -> Optional[str]:
    """Source-ish text of an attribute chain (``self._pool.conn`` ->
    "self._pool.conn"); None for non-chain expressions."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call):
        inner = _attr_chain_text(cur.func)
        parts.append(f"{inner}()" if inner else "()")
    else:
        return None
    return ".".join(reversed(parts))


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


# ---------------------------------------------------------------------
# Per-class lock analysis
# ---------------------------------------------------------------------


class ClassLocks:
    """Lock/guard structure of one class."""

    def __init__(self, ctx: ModuleContext, cls: ast.ClassDef):
        self.ctx = ctx
        self.cls = cls
        self.lock_attrs: Dict[str, str] = {}   # attr -> kind
        self.cond_attrs: Dict[str, Optional[str]] = {}  # cond -> lock attr
        self.methods: Dict[str, ast.AST] = {}
        self.callback_refs: Set[str] = set()   # methods passed as values
        self._held_cache: Dict[ast.AST, Tuple[str, ...]] = {}
        self._find_locks()
        self._find_methods()
        self.guarded_methods = self._infer_guarded_methods()
        self.init_only = self._init_only_methods()
        self.public_path = self._public_path_methods()

    # -- discovery ----------------------------------------------------

    def _find_locks(self) -> None:
        for node in ast.walk(self.cls):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            name = self.ctx.call_name(node.value)
            kind = _LOCK_FACTORIES.get((name or "").split(".")[-1])
            is_cond = (name or "").split(".")[-1] == "Condition"
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if kind is not None:
                    self.lock_attrs[attr] = kind
                elif is_cond:
                    arg = node.value.args[0] if node.value.args else None
                    self.cond_attrs[attr] = _self_attr(arg) \
                        if arg is not None else None

    def _find_methods(self) -> None:
        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
        # methods referenced without a call (thread targets, callbacks)
        # run on foreign threads: treat them as public entry points
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and node.attr in self.methods \
                    and not isinstance(self.ctx.parent(node), ast.Call):
                self.callback_refs.add(node.attr)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self.methods:
                # self.m passed as an ARGUMENT (Thread(target=self.m))
                for arg in list(node.args) + [k.value
                                              for k in node.keywords]:
                    a = _self_attr(arg)
                    if a in self.methods:
                        self.callback_refs.add(a)

    def is_lock_expr(self, expr: ast.AST) -> Optional[str]:
        """Lock id (attr name) when `expr` acquires one of this class's
        locks: a known lock attr, a condition attr (entering a
        condition acquires its lock), or a lock-named self attribute
        whose construction we couldn't see."""
        attr = _self_attr(expr)
        if attr is None:
            return None
        if attr in self.lock_attrs:
            return attr
        if attr in self.cond_attrs:
            return self.cond_attrs[attr] or attr
        if _LOCK_NAME_RE.search(attr):
            return attr
        return None

    # -- held-lock computation ----------------------------------------

    def held_at(self, node: ast.AST) -> Tuple[str, ...]:
        """Lock ids held at `node`, outermost first: lexically enclosing
        ``with`` acquisitions within the same method, plus locks the
        whole method is inferred to run under (guarded_methods)."""
        cached = self._held_cache.get(node)
        if cached is not None:
            return cached
        held: List[str] = []
        fn = self.ctx.enclosing_function(node)
        if fn is not None:
            mname = getattr(fn, "name", None)
            for lk in self.guarded_methods.get(mname, ()):
                held.append(lk)
        for anc in reversed(list(self.ctx.ancestors(node))):
            if isinstance(anc, (ast.With, ast.AsyncWith)) \
                    and self.ctx.enclosing_function(anc) is fn:
                in_body = any(self.ctx._within(s, node)
                              for s in anc.body)
                if not in_body:
                    continue
                for item in anc.items:
                    lk = self.is_lock_expr(item.context_expr)
                    if lk is not None and lk not in held:
                        held.append(lk)
        out = tuple(held)
        self._held_cache[node] = out
        return out

    def _direct_with_locks(self, fn: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)) \
                    and self.ctx.enclosing_function(node) is fn:
                for item in node.items:
                    lk = self.is_lock_expr(item.context_expr)
                    if lk is not None:
                        out.add(lk)
        return out

    def _self_calls(self, fn: ast.AST) -> List[Tuple[str, ast.Call]]:
        out: List[Tuple[str, ast.Call]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                attr = _self_attr(node.func)
                if attr is not None and attr in self.methods:
                    out.append((attr, node))
        return out

    def _infer_guarded_methods(self) -> Dict[str, Tuple[str, ...]]:
        """method name -> lock ids its whole body runs under.

        Inference: a private, internally-called method whose EVERY
        intra-class call site holds L runs under L (this also covers
        the ``*_locked`` naming convention without trusting it — the
        same suffix means "caller holds the lock" in core_worker and
        "takes the lock itself" in rpc.py). Public methods are
        callable from outside with no locks held and are never
        inferred. Iterated to fixpoint because a caller's guarded-ness
        extends its callees' held sets."""
        guarded: Dict[str, Tuple[str, ...]] = {}
        for _round in range(len(self.methods) + 1):
            self._held_cache.clear()
            self.guarded_methods = guarded
            changed = False
            for name, fn in self.methods.items():
                candidate = (name.startswith("_")
                             and not name.startswith("__")) \
                    or name.endswith("_locked")
                if name in guarded or not candidate \
                        or name in self.callback_refs:
                    continue
                sites: List[ast.Call] = []
                for mname, mfn in self.methods.items():
                    if mname == name:
                        # self-recursive sites inherit the conclusion;
                        # counting them blocks the inference forever
                        continue
                    for callee, call in self._self_calls(mfn):
                        if callee == name:
                            sites.append(call)
                if not sites:
                    continue
                held_sets = [set(self.held_at(c)) for c in sites]
                common = set.intersection(*held_sets) if held_sets \
                    else set()
                if common:
                    guarded[name] = tuple(sorted(common))
                    changed = True
            if not changed:
                break
        self._held_cache.clear()
        self.guarded_methods = guarded
        return guarded

    def _reachable(self, roots: Set[str]) -> Set[str]:
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            cur = frontier.pop()
            fn = self.methods.get(cur)
            if fn is None:
                continue
            for callee, _call in self._self_calls(fn):
                if callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen

    def _init_only_methods(self) -> Set[str]:
        """Methods reachable ONLY from __init__ run before any other
        thread can see the object: their unguarded accesses are
        construction, not races."""
        init_reach = self._reachable({"__init__"}) \
            if "__init__" in self.methods else set()
        other_roots = {n for n in self.methods
                       if n != "__init__"
                       and (not n.startswith("_")
                            or n in self.callback_refs
                            or n.startswith("__"))}
        other_reach = self._reachable(other_roots)
        return (init_reach - other_reach) | {"__init__"}

    def _public_path_methods(self) -> Set[str]:
        """Methods reachable from outside the class: public methods,
        dunder protocol hooks, and callback-referenced methods (thread
        targets run on their own thread), plus everything they call."""
        roots = {n for n in self.methods
                 if not n.startswith("_")
                 or n in self.callback_refs
                 or (n.startswith("__") and n != "__init__")}
        return self._reachable(roots)

    def effective_acquires(self) -> Dict[str, Set[str]]:
        """method -> lock ids acquired anywhere in it, directly or via
        intra-class callees (bounded fixpoint) — RT016's cross-function
        edge source."""
        acq = {name: self._direct_with_locks(fn)
               for name, fn in self.methods.items()}
        calls = {name: [c for c, _ in self._self_calls(fn)]
                 for name, fn in self.methods.items()}
        for _round in range(len(self.methods) + 1):
            changed = False
            for name in acq:
                for callee in calls[name]:
                    extra = acq.get(callee, set()) - acq[name]
                    if extra:
                        acq[name] |= extra
                        changed = True
            if not changed:
                break
        return acq


def _module_locks(ctx: ModuleContext) -> Dict[str, str]:
    """Module-level lock variables: NAME = threading.Lock()."""
    out: Dict[str, str] = {}
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call):
            kind = _LOCK_FACTORIES.get(
                (ctx.call_name(node.value) or "").split(".")[-1])
            if kind is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = kind
    return out


def _class_infos(ctx: ModuleContext) -> List[ClassLocks]:
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            info = ClassLocks(ctx, node)
            if info.lock_attrs or info.cond_attrs:
                out.append(info)
    return out


# ---------------------------------------------------------------------
# Blocking-call matching (shared by RT015; the registry above)
# ---------------------------------------------------------------------


def _is_condvar_receiver(info: Optional[ClassLocks],
                         recv_text: str, recv_attr: Optional[str]) -> bool:
    if info is not None and recv_attr is not None \
            and recv_attr in info.cond_attrs:
        return True
    return bool(_CONDVAR_NAME_RE.search(recv_text))


def match_blocking_call(ctx: ModuleContext, call: ast.Call,
                        info: Optional[ClassLocks] = None
                        ) -> Optional[str]:
    """A human-readable description when `call` is in the blocking
    registry, else None. `info` (the enclosing class's lock analysis)
    enables the condition-variable allowlist."""
    dotted = ctx.call_name(call)
    if dotted in BLOCKING_DOTTED:
        return f"{dotted}()"
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    recv_text = _attr_chain_text(func.value) or ""
    recv_attr = _self_attr(func.value)
    if attr == "wait":
        if _is_condvar_receiver(info, recv_text, recv_attr):
            return None  # Condition.wait releases the held lock
        return f"{recv_text or '<expr>'}.wait()"
    if attr == BLOCKING_GET_WITH_TIMEOUT:
        if any(k.arg == "timeout" for k in call.keywords):
            return f"{recv_text or '<expr>'}.get(timeout=...)"
        return None
    if attr in BLOCKING_ATTRS:
        pat = BLOCKING_ATTRS[attr]
        if isinstance(func.value, ast.Constant):
            return None  # "sep".join(...) and friends
        if pat is None or re.search(pat, recv_text, re.IGNORECASE):
            return f"{recv_text or '<expr>'}.{attr}()"
    return None


# ---------------------------------------------------------------------
# RT014: mixed-guard attribute access
# ---------------------------------------------------------------------


class _Access:
    __slots__ = ("node", "kind", "method", "guarded")

    def __init__(self, node, kind, method, guarded):
        self.node = node
        self.kind = kind          # 'write' | 'mutcall' | 'iter'
        self.method = method
        self.guarded = guarded


def _classify_accesses(info: ClassLocks) -> Dict[str, List[_Access]]:
    ctx = info.ctx
    out: Dict[str, List[_Access]] = {}

    def add(attr_node: ast.Attribute, kind: str) -> None:
        attr = attr_node.attr
        if attr in info.lock_attrs or attr in info.cond_attrs:
            return
        fn = ctx.enclosing_function(attr_node)
        mname = getattr(fn, "name", None)
        if mname not in info.methods:
            return  # nested function/lambda: skip (its thread context
            #         is the enclosing method's, but targets vary)
        guarded = bool(info.held_at(attr_node))
        out.setdefault(attr, []).append(
            _Access(attr_node, kind, mname, guarded))

    for node in ast.walk(info.cls):
        # writes: self.X = / self.X += / del self.X / self.X[k] =
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = node.targets
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATING_METHODS:
            a = node.func.value
            if _self_attr(a) is not None:
                add(a, "mutcall")
            continue
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            it = node.iter
            if isinstance(it, ast.Call) \
                    and isinstance(it.func, ast.Attribute) \
                    and it.func.attr in _DICT_ITERS:
                it = it.func.value
            if _self_attr(it) is not None:
                add(it, "iter")
            continue
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                it = gen.iter
                if isinstance(it, ast.Call) \
                        and isinstance(it.func, ast.Attribute) \
                        and it.func.attr in _DICT_ITERS:
                    it = it.func.value
                if _self_attr(it) is not None:
                    add(it, "iter")
            continue
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Name) \
                and node.func.id in _ITERATING_CALLS and node.args:
            it = node.args[0]
            if isinstance(it, ast.Call) \
                    and isinstance(it.func, ast.Attribute) \
                    and it.func.attr in _DICT_ITERS:
                it = it.func.value
            if _self_attr(it) is not None:
                add(it, "iter")
            continue
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Subscript):
                t = t.value
            if _self_attr(t) is not None:
                add(t, "write")
    return out


# ---------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------


class MixedGuardAccess:
    id = "RT014"
    name = "mixed-guard-access"
    rationale = ("an attribute mutated under a class lock on one path "
                 "but mutated/iterated without it on another public "
                 "path races: the unlocked access interleaves with the "
                 "locked critical section it was fenced against")

    def finding(self, ctx, node, message):
        return Finding(self.id, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)

    _KIND_VERB = {"write": "written", "mutcall": "mutated",
                  "iter": "iterated"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for info in _class_infos(ctx):
            if not info.lock_attrs:
                continue
            lock_name = sorted(info.lock_attrs)[0]
            for attr, accesses in sorted(
                    _classify_accesses(info).items()):
                evidence = [a for a in accesses
                            if a.guarded and a.kind in ("write", "mutcall")
                            and a.method not in info.init_only]
                if not evidence:
                    continue
                ev_methods = sorted({a.method for a in evidence})
                for a in accesses:
                    if a.guarded or a.method in info.init_only:
                        continue
                    if a.method not in info.public_path:
                        continue
                    yield self.finding(
                        ctx, a.node,
                        f"self.{attr} is guarded by "
                        f"{info.cls.name}.{lock_name} in "
                        f"{', '.join(m + '()' for m in ev_methods[:3])} "
                        f"but {self._KIND_VERB[a.kind]} without it in "
                        f"{a.method}() — take the lock here or justify "
                        f"why this access cannot race")


class BlockingUnderLock:
    id = "RT015"
    name = "blocking-under-lock"
    rationale = ("a blocking call (RPC, sleep, socket/subprocess wait) "
                 "made while a lock is held stalls EVERY thread that "
                 "needs that lock for the call's full timeout; move "
                 "the call off the critical section (condition-variable "
                 "waits that release the lock are allowed)")

    def finding(self, ctx, node, message):
        return Finding(self.id, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        mod_locks = _module_locks(ctx)
        infos = {info.cls: info for info in _class_infos(ctx)}

        def held_for(node: ast.AST) -> Tuple[Optional[ClassLocks],
                                             Tuple[str, ...]]:
            cls = ctx.enclosing_class(node)
            info = infos.get(cls) if cls is not None else None
            held: Tuple[str, ...] = ()
            if info is not None:
                held = info.held_at(node)
            # module-level with-blocks (module lock vars) stack on top
            fn = ctx.enclosing_function(node)
            extra: List[str] = []
            for anc in ctx.ancestors(node):
                if isinstance(anc, (ast.With, ast.AsyncWith)) \
                        and ctx.enclosing_function(anc) is fn:
                    if not any(ctx._within(s, node) for s in anc.body):
                        continue
                    for item in anc.items:
                        ce = item.context_expr
                        if isinstance(ce, ast.Name) \
                                and (ce.id in mod_locks
                                     or _LOCK_NAME_RE.search(ce.id)):
                            extra.append(ce.id)
            return info, tuple(held) + tuple(extra)

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            info, held = held_for(node)
            if not held:
                continue
            desc = match_blocking_call(ctx, node, info)
            if desc is None:
                continue
            lock_desc = ", ".join(held)
            yield self.finding(
                ctx, node,
                f"blocking call {desc} while holding lock(s) "
                f"[{lock_desc}]: every thread contending on the lock "
                f"stalls for this call's full duration/timeout — "
                f"snapshot state under the lock, call outside it "
                f"(registry: lint/concurrency.py BLOCKING_*)")


class LockOrderCycle:
    id = "RT016"
    name = "lock-order-cycle"
    rationale = ("two code paths acquiring the same locks in opposite "
                 "orders deadlock when their threads interleave; the "
                 "lock-order graph over every nested acquisition must "
                 "stay acyclic (runtime twin: the TracedLock watchdog "
                 "probe)")

    def finding_at(self, path, line, col, message):
        return Finding(self.id, path, line, col, message)

    # -- per-file fact extraction (cache-friendly) --------------------

    def collect_facts(self, ctx: ModuleContext) -> Dict[str, Any]:
        """Edges as [from_id, to_id, line, col]; reentrant lock ids
        (self-edges on RLocks are legal re-acquisition, not
        inversion)."""
        edges: List[List[Any]] = []
        reentrant: Set[str] = set()
        mod = ctx.path.replace("\\", "/").rsplit("/", 1)[-1]
        mod = mod[:-3] if mod.endswith(".py") else mod
        mod_locks = _module_locks(ctx)
        for name, kind in mod_locks.items():
            if kind == "rlock":
                reentrant.add(f"{mod}.{name}")

        def lock_id(info: Optional[ClassLocks], attr_or_name: str,
                    is_attr: bool) -> str:
            if is_attr and info is not None:
                return f"{info.cls.name}.{attr_or_name}"
            return f"{mod}.{attr_or_name}"

        infos = _class_infos(ctx)
        for info in infos:
            for attr, kind in info.lock_attrs.items():
                if kind == "rlock":
                    reentrant.add(f"{info.cls.name}.{attr}")
            eff = info.effective_acquires()
            for node in ast.walk(info.cls):
                # lexical nesting: acquiring while holding
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    held = info.held_at(node)
                    acquired: List[str] = []
                    for item in node.items:
                        lk = info.is_lock_expr(item.context_expr)
                        if lk is not None:
                            acquired.append(lk)
                    stack = list(held)
                    for lk in acquired:
                        if lk in stack:
                            # re-acquiring a held lock: self-edge
                            # (deadlock unless the lock is reentrant)
                            lid = lock_id(info, lk, True)
                            edges.append([lid, lid, node.lineno,
                                          node.col_offset])
                        elif stack:
                            edges.append([
                                lock_id(info, stack[-1], True),
                                lock_id(info, lk, True),
                                node.lineno, node.col_offset])
                        stack.append(lk)
                # cross-function: self.m() under a lock, m acquires
                elif isinstance(node, ast.Call):
                    callee = _self_attr(node.func)
                    if callee is None or callee not in info.methods:
                        continue
                    held = info.held_at(node)
                    if not held:
                        continue
                    outer = held[-1]
                    for inner in sorted(eff.get(callee, ())):
                        if inner in held:
                            lid = lock_id(info, inner, True)
                            edges.append([lid, lid, node.lineno,
                                          node.col_offset])
                        else:
                            edges.append([
                                lock_id(info, outer, True),
                                lock_id(info, inner, True),
                                node.lineno, node.col_offset])
        # module-level lock nesting (rare; functions outside classes)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if ctx.enclosing_class(node) is not None:
                continue
            held: List[str] = []
            for anc in reversed(list(ctx.ancestors(node))):
                if isinstance(anc, (ast.With, ast.AsyncWith)) \
                        and any(ctx._within(s, node) for s in anc.body):
                    for item in anc.items:
                        ce = item.context_expr
                        if isinstance(ce, ast.Name) and ce.id in mod_locks:
                            held.append(ce.id)
            acquired = [item.context_expr.id for item in node.items
                        if isinstance(item.context_expr, ast.Name)
                        and item.context_expr.id in mod_locks]
            prev = held[-1] if held else None
            for lk in acquired:
                if prev is not None and prev != lk:
                    edges.append([f"{mod}.{prev}", f"{mod}.{lk}",
                                  node.lineno, node.col_offset])
                prev = lk
        return {"edges": edges, "reentrant": sorted(reentrant)}

    # -- project-level cycle detection --------------------------------

    def project_check(self, facts: Dict[str, Dict[str, Any]]
                      ) -> Iterator[Finding]:
        # first-seen site per edge, scanned in deterministic order
        sites: Dict[Tuple[str, str], Tuple[str, int, int]] = {}
        reentrant: Set[str] = set()
        for path in sorted(facts):
            f = facts[path] or {}
            reentrant.update(f.get("reentrant", ()))
            for a, b, line, col in f.get("edges", ()):
                key = (a, b)
                if key not in sites:
                    sites[key] = (path, line, col)
        adj: Dict[str, List[str]] = {}
        for (a, b) in sites:
            if a == b:
                continue
            adj.setdefault(a, []).append(b)
        for k in adj:
            adj[k].sort()
        # self-edges on non-reentrant locks deadlock a single thread
        for (a, b), (path, line, col) in sorted(sites.items()):
            if a == b and a not in reentrant:
                yield self.finding_at(
                    path, line, col,
                    f"lock {a} is acquired while already held on this "
                    f"path; a non-reentrant lock self-deadlocks here "
                    f"(use an RLock or restructure)")
        reported: Set[Tuple[str, ...]] = set()
        state: Dict[str, int] = {}

        def dfs(nd: str, path_nodes: List[str]
                ) -> Optional[List[str]]:
            state[nd] = 1
            path_nodes.append(nd)
            for nxt in adj.get(nd, ()):
                s = state.get(nxt)
                if s == 1:
                    return path_nodes[path_nodes.index(nxt):] + [nxt]
                if s is None:
                    got = dfs(nxt, path_nodes)
                    if got:
                        return got
            path_nodes.pop()
            state[nd] = 2
            return None

        cycles: List[List[str]] = []
        for start in sorted(adj):
            if state.get(start) is None:
                got = dfs(start, [])
                while got:
                    # canonical rotation for dedupe
                    body = got[:-1]
                    i = body.index(min(body))
                    canon = tuple(body[i:] + body[:i])
                    if canon not in reported:
                        reported.add(canon)
                        cycles.append(list(canon) + [canon[0]])
                    # remove one edge of the cycle and rescan from
                    # scratch so distinct cycles each get reported
                    a, b = got[0], got[1]
                    adj[a] = [x for x in adj[a] if x != b]
                    state.clear()
                    got = dfs(start, []) if start in adj else None
        for cyc in cycles:
            edge_sites = []
            for a, b in zip(cyc, cyc[1:]):
                p, line, col = sites[(a, b)]
                edge_sites.append(f"{b} under {a} at {p}:{line}")
            anchor = min(sites[(a, b)]
                         for a, b in zip(cyc, cyc[1:]))
            yield self.finding_at(
                anchor[0], anchor[1], anchor[2],
                f"lock-order cycle {' -> '.join(cyc)}: threads taking "
                f"these paths concurrently deadlock "
                f"({'; '.join(edge_sites)}) — pick one global order")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        """Single-file form (lint_source/fixtures): project check over
        just this file's facts."""
        yield from self.project_check({ctx.path: self.collect_facts(ctx)})

"""Tensor hot-path rule family: RT021, RT023, RT024.

Eager PyTorch gives speed back silently too: an implicit device->host
sync inside the learner loop (RT021), a pin/lease/slot acquired without
an exception-safe release (RT023), or a bare time.sleep inside a
goodput-instrumented loop (RT024 — phantom idle in the wall-time
ledger). These rules are the static half of the pairing whose runtime
half is ray_tpu_torch/util/cuda_sentinel.py (build counters + transfer
accounting on the live learner) and _private/goodput.py (the ledger).
They are the port's counterparts of the JAX package's
ray_tpu/lint/jaxrules.py, whose RT020 (jit recompile hazards) and RT022
(buffer donation) name mechanisms the eager port does not use.

RT021 keeps a **device-taint lattice** per function: values produced by
`torch.*` factories given a (non-CPU) device, by `.to(<device>)` /
`.cuda()`, by calling an `nn.Module` (constructed from `torch.nn`, or a
class of the module that subclasses it) or a step function (the names
`make_train_step` returns, and the module's own functions and methods
named "...step"), and by ops on such values, are device values. Taint
flows through assignment, unpacking, loop and comprehension targets,
subscripts and arithmetic. It stops at the sanctioned forcing point, a
blocking copy of the whole value to the host (`.cpu()`, `.to("cpu")`),
which plays jax.device_get's part: one explicit copy per step, counted
by the sentinel, never flagged here. What is flagged on a device value:
`.item()`, `.tolist()`, `.numpy()`, float()/int()/bool(), np.asarray /
np.array and print(), each a hidden sync per call; and the explicit
barrier `torch.cuda.synchronize()`.

RT023 and RT024 are framework-free and are the JAX package's rules as
they stand (RT023 is a project rule: collect_facts + project_check).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from ray_tpu_torch.lint.engine import Finding, ModuleContext


class _TorchRule:
    """Duck-typed rule base (same shape as rules.Rule; not imported
    from there so `import ray_tpu_torch.lint.torchrules` works
    standalone without a circular import through the catalogue
    module)."""

    id: str = "RT000"
    name: str = ""
    rationale: str = ""

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)

# Directories whose code never runs on the training hot path; RT021's
# sync findings are actionable only where a sync costs a step.
_EXEMPT_DIR_PARTS = {"tests", "test", "examples", "benchmarks",
                     "scripts", "tools", "docs"}

# torch namespaces whose calls return host objects (streams, events,
# modules, devices, generators, settings), never tensor data
_TORCH_HOST_PREFIX = (
    "torch.cuda.", "torch.nn.", "torch.distributed.", "torch.profiler.",
    "torch.backends.", "torch.utils.", "torch.autograd.", "torch.library.",
    "torch.testing.", "torch.set_", "torch.get_", "torch.is_",
)
_TORCH_HOST_EXACT = {
    "torch.device", "torch.Generator", "torch.manual_seed", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.from_numpy",
    "torch.finfo", "torch.iinfo", "torch.Size", "torch.dtype",
}

# Attributes of tensors that are host metadata, not device data.
_HOST_META_ATTRS = {"shape", "ndim", "dtype", "device", "nbytes",
                    "itemsize", "is_cuda", "is_cpu", "requires_grad",
                    "layout", "placements", "device_mesh"}

_NUMPY_COERCIONS = {"numpy.asarray", "numpy.array", "np.asarray",
                    "np.array"}

# methods whose result is host data: the sanctioned copy to the host,
# and the coercions RT021 flags
_HOST_RESULT_METHODS = {"cpu", "item", "tolist", "numpy", "size",
                        "dim", "numel", "element_size", "stride",
                        "data_ptr", "get_device", "is_contiguous"}

_MODULE_BASES = {"torch.nn.Module", "nn.Module"}

# ---------------------------------------------------------------------
# RT023 resource pair registry. Extend by appending — names are the
# TERMINAL component of the called attribute/function.
# ---------------------------------------------------------------------

_ACQUIRE_KIND: Dict[str, str] = {
    "store_pin": "pin", "pin": "pin", "pin_arg": "pin", "pin_refs": "pin",
    "store_lease": "lease", "lease": "lease",
    "acquire_slot": "slot", "take_slot": "slot",
    "_acquire": "stage_slot",
    "remote": "actor",  # setup paths only, see _SETUP_FN_NAMES
}
_RELEASE_KIND: Dict[str, str] = {
    "store_unpin": "pin", "unpin": "pin", "unpin_arg": "pin",
    "store_unlease": "lease", "unlease": "lease",
    "release_slot": "slot", "release_slots": "slot",
    "_release": "stage_slot",
    "kill": "actor", "shutdown": "actor", "terminate": "actor",
}
# `.remote()` is every task submission, not just actor construction;
# only treat it as an acquire inside construction/setup functions where
# a matching kill/shutdown is plausibly owed.
_SETUP_FN_NAMES = {"__init__", "setup", "start", "_start", "build",
                   "launch", "_launch", "restart", "_restart"}


def _path_exempt(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(p in _EXEMPT_DIR_PARTS for p in parts)


def _terminal(node: ast.AST) -> Optional[str]:
    """Terminal component of a call target: `self._store.pin` -> 'pin',
    `unpin` -> 'unpin'. None for anything unnamed."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _self_attr_name(node: ast.AST) -> Optional[str]:
    """'X' for a `self.X` expression, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _cpu_literal(node: ast.AST, ctx: ModuleContext) -> bool:
    """A device expression that names the host: "cpu", "cpu:0",
    torch.device("cpu")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and ctx.call_name(node) == "torch.device" \
            and node.args:
        return _cpu_literal(node.args[0], ctx)
    return False


def _dtype_expr(node: ast.AST, ctx: ModuleContext) -> bool:
    """`torch.float32`, `torch.bfloat16`, ...: a dtype, not a device."""
    dn = ctx.dotted(node) or ""
    return dn.startswith("torch.") and dn.count(".") == 1 and \
        any(k in dn for k in ("float", "int", "bool", "half", "complex",
                              "uint", "double", "long", "short"))


def _module_bindings(ctx: ModuleContext) -> Tuple[Set[str], Set[str]]:
    """(names, self_attrs) holding callables whose calls give device
    values: nn.Modules (torch.nn constructors, classes of this module
    subclassing nn.Module, and .to()/.cuda() of either) and step
    functions (those make_train_step returns, and the module's own
    functions and methods whose names end in "step")."""
    classes = {n.name for n in ast.walk(ctx.tree)
               if isinstance(n, ast.ClassDef)
               and any(ctx.dotted(b) in _MODULE_BASES for b in n.bases)}

    def module_expr(e: ast.AST) -> bool:
        if not isinstance(e, ast.Call):
            return False
        dn = ctx.call_name(e) or ""
        if dn.startswith("torch.nn.") and dn.rsplit(".", 1)[1][:1].isupper():
            return True
        if dn in classes:
            return True
        f = e.func
        if isinstance(f, ast.Attribute) and f.attr in ("to", "cuda"):
            return module_expr(f.value)
        return False

    names: Set[str] = set()
    attrs: Set[str] = set()
    for node in ast.walk(ctx.tree):
        # the module's own step functions and methods (`_step`,
        # `train_step`, `_full_batch_step`)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.endswith("step"):
            names.add(node.name)
            attrs.add(node.name)
        if not isinstance(node, ast.Assign):
            continue
        step = isinstance(node.value, ast.Call) and \
            (ctx.call_name(node.value) or "").rsplit(".", 1)[-1] \
            == "make_train_step"
        if not (step or module_expr(node.value)):
            continue
        for t in node.targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                if isinstance(e, ast.Name):
                    names.add(e.id)
                a = _self_attr_name(e)
                if a:
                    attrs.add(a)
    return names, attrs


# =====================================================================
# RT021: hidden host syncs
# =====================================================================


class HiddenHostSync(_TorchRule):
    id = "RT021"
    name = "hidden-host-sync"
    rationale = ("`.item()`, `.tolist()`, `.numpy()`, float()/int()/"
                 "bool(), np.asarray and print on a device tensor block "
                 "the Python thread until the device catches up — one "
                 "per step serializes the pipeline; batch reads through "
                 "a single .cpu() forcing point instead")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if _path_exempt(ctx.path):
            return
        names, attrs = _module_bindings(ctx)
        attr_taint = self._attr_taint(ctx, names, attrs)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn in ctx.traced_fns:
                continue  # host effects in traced code are RT003's beat
            yield from self._check_fn(ctx, fn, names, attrs, attr_taint)

    # -- device-value production --------------------------------------

    def _produces_device(self, ctx: ModuleContext, expr: ast.AST,
                         tainted: Set[str], names: Set[str],
                         attrs: Set[str], attr_taint: Set[str]) -> bool:
        def dev(e: ast.AST) -> bool:
            if isinstance(e, ast.Name):
                return e.id in tainted
            if isinstance(e, ast.Attribute):
                if e.attr in _HOST_META_ATTRS:
                    return False
                a = _self_attr_name(e)
                if a is not None:
                    return a in attr_taint
                return dev(e.value)
            if isinstance(e, ast.Subscript):
                return dev(e.value)
            if isinstance(e, (ast.Tuple, ast.List)):
                return any(dev(x) for x in e.elts)
            if isinstance(e, ast.BinOp):
                return dev(e.left) or dev(e.right)
            if isinstance(e, ast.UnaryOp):
                return dev(e.operand)
            if isinstance(e, ast.IfExp):
                return dev(e.body) or dev(e.orelse)
            if isinstance(e, ast.Call):
                return call(e)
            return False

        def call(e: ast.Call) -> bool:
            f = e.func
            dn = ctx.call_name(e)
            if isinstance(f, ast.Name) and f.id in names:
                return True
            a = _self_attr_name(f)
            if a is not None and a in attrs:
                return True
            if isinstance(f, ast.Attribute):
                if f.attr == "cuda":
                    return True
                if f.attr == "to":
                    return self._to_device(ctx, e, dev)
                if f.attr in _HOST_RESULT_METHODS:
                    return False
                # a module's forward, or a method on a device receiver
                # (x.sum(), x.float(), x.detach())
                if f.attr == "forward" and (
                        (isinstance(f.value, ast.Name)
                         and f.value.id in names)
                        or _self_attr_name(f.value) in attrs):
                    return True
                if dn is None or not dn.startswith("torch."):
                    return dev(f.value)
            if dn is None or not dn.startswith("torch."):
                return False
            if dn in _TORCH_HOST_EXACT or dn.startswith(_TORCH_HOST_PREFIX):
                return False
            for kw in e.keywords:
                if kw.arg == "device":
                    return not _cpu_literal(kw.value, ctx)
            # an op on device inputs (torch.stack([x, y]), torch.where)
            return any(dev(x) for x in e.args) or any(
                dev(kw.value) for kw in e.keywords)

        return dev(expr)

    @staticmethod
    def _to_device(ctx: ModuleContext, e: ast.Call, dev) -> bool:
        """`x.to(...)`: the host for a CPU target, x's own place for a
        dtype, the device for any other target (a device variable)."""
        target = e.args[0] if e.args else None
        for kw in e.keywords:
            if kw.arg == "device":
                target = kw.value
        if target is None or _dtype_expr(target, ctx):
            return dev(e.func.value)
        if _cpu_literal(target, ctx):
            return False
        return True

    def _attr_taint(self, ctx: ModuleContext, names: Set[str],
                    attrs: Set[str]) -> Set[str]:
        """self-attrs assigned device values anywhere in the module
        (`self._buf = torch.zeros(n, device=dev)`)."""
        taint: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Assign):
                    continue
                if not self._produces_device(ctx, node.value, set(),
                                             names, attrs, taint):
                    continue
                for t in node.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for e in elts:
                        a = _self_attr_name(e)
                        if a and a not in taint and a not in attrs:
                            taint.add(a)
                            changed = True
        return taint

    # -- per-function taint + triggers --------------------------------

    def _fn_nodes(self, fn: ast.AST) -> Iterator[ast.AST]:
        """Walk fn's body skipping nested function subtrees: each def
        is analyzed with its own taint set."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def _check_fn(self, ctx: ModuleContext, fn: ast.AST,
                  names: Set[str], attrs: Set[str],
                  attr_taint: Set[str]) -> Iterator[Finding]:
        tainted: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for node in self._fn_nodes(fn):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    targets, value = [node.target], node.value
                elif isinstance(node, (ast.For, ast.AsyncFor,
                                       ast.comprehension)):
                    targets, value = [node.target], node.iter
                if value is None or not self._produces_device(
                        ctx, value, tainted, names, attrs, attr_taint):
                    continue
                for t in targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for e in elts:
                        if isinstance(e, ast.Starred):
                            e = e.value
                        if isinstance(e, ast.Name) and e.id not in tainted:
                            tainted.add(e.id)
                            changed = True

        def dev(e: ast.AST) -> bool:
            return self._produces_device(ctx, e, tainted, names, attrs,
                                         attr_taint)

        for node in self._fn_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            dn = ctx.call_name(node)
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in ("item", "tolist", "numpy") \
                    and dev(f.value):
                yield self.finding(
                    ctx, node,
                    f"`.{f.attr}()` on a device tensor blocks until the "
                    f"device catches up — a hidden sync per call; batch "
                    f"reads through one .cpu() forcing point")
            elif dn in ("float", "int", "bool") and len(node.args) == 1 \
                    and dev(node.args[0]):
                yield self.finding(
                    ctx, node,
                    f"{dn}() coerces a device tensor through a hidden "
                    f"device->host sync — copy once with .cpu() and "
                    f"convert on the host")
            elif dn in _NUMPY_COERCIONS and node.args \
                    and any(dev(a) for a in node.args):
                yield self.finding(
                    ctx, node,
                    f"{dn.split('.')[0]}.{dn.split('.')[-1]}() on a "
                    f"device tensor is a blocking device->host copy per "
                    f"call — batch the reads through a single .cpu() "
                    f"forcing point")
            elif dn == "print" and any(dev(a) for a in node.args):
                yield self.finding(
                    ctx, node,
                    "print() of a device tensor syncs the device on the "
                    "hot path — copy it with .cpu() first")
            elif dn == "torch.cuda.synchronize":
                yield self.finding(
                    ctx, node,
                    "torch.cuda.synchronize() is an explicit device "
                    "barrier: correct at a staging boundary, a stall "
                    "anywhere else — if intentional, keep it under a "
                    "justified `# graftlint: disable=RT021`")


# =====================================================================
# RT023: leak on raise (project rule)
# =====================================================================


class _Acq:
    __slots__ = ("kind", "line", "col", "risks", "helpers", "close_idx")

    def __init__(self, kind: str, line: int, col: int):
        self.kind = kind
        self.line = line
        self.col = col
        self.risks: List[Dict[str, Any]] = []
        self.helpers: List[Dict[str, Any]] = []
        self.close_idx: Optional[int] = None


class LeakOnRaise(_TorchRule):
    id = "RT023"
    name = "leak-on-raise"
    rationale = ("an acquired pin/lease/slot/actor whose matching "
                 "release is not reached on an exception edge leaks the "
                 "resource for the owner's lifetime — the bug class the "
                 "ownership chaos fuzzer keeps re-finding; releases "
                 "belong in try/finally, a context manager, or an "
                 "except branch that re-raises")

    def finding_at(self, path: str, line: int, col: int,
                   message: str) -> Finding:
        return Finding(self.id, path, line, col, message)

    # -- facts ---------------------------------------------------------

    def collect_facts(self, ctx: ModuleContext) -> Dict[str, Any]:
        releases: Dict[str, List[str]] = {}
        records: List[Dict[str, Any]] = []
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            kinds = sorted({_RELEASE_KIND[t] for t in
                            self._called_terminals(fn)
                            if t in _RELEASE_KIND})
            if kinds:
                releases.setdefault(fn.name, [])
                for k in kinds:
                    if k not in releases[fn.name]:
                        releases[fn.name].append(k)
            records.extend(self._scan_fn(ctx, fn))
        return {"releases": releases, "records": records}

    @staticmethod
    def _called_terminals(fn: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                t = _terminal(node.func)
                if t:
                    out.add(t)
        return out

    # -- per-function event scan --------------------------------------

    def _scan_fn(self, ctx: ModuleContext, fn: ast.AST
                 ) -> List[Dict[str, Any]]:
        setup = fn.name in _SETUP_FN_NAMES
        seq = [0]
        open_acqs: List[_Acq] = []
        records: List[_Acq] = []

        def acquire_kind(call: ast.Call) -> Optional[str]:
            t = _terminal(call.func)
            kind = _ACQUIRE_KIND.get(t or "")
            if kind == "actor" and not setup:
                return None
            return kind

        def release_event(kind: str) -> None:
            for acq in reversed(open_acqs):
                if acq.kind == kind and acq.close_idx is None:
                    acq.close_idx = seq[0]
                    open_acqs.remove(acq)
                    records.append(acq)
                    return

        def risk_event(protectors: frozenset, ckinds: frozenset,
                       line: int) -> None:
            for acq in open_acqs:
                if acq.kind in ckinds:
                    continue
                acq.risks.append({"idx": seq[0], "line": line,
                                  "protectors": sorted(protectors)})

        def helper_event(name: str, line: int) -> None:
            for acq in open_acqs:
                acq.helpers.append({"idx": seq[0], "name": name,
                                    "line": line})

        def leaf(node: ast.AST, ckinds: frozenset, chelpers: frozenset,
                 managed: bool = False) -> None:
            events: List[Tuple[int, int, str, Any]] = []
            for n in ast.walk(node):
                if isinstance(n, ast.Call):
                    t = _terminal(n.func)
                    if t in _RELEASE_KIND:
                        events.append((n.lineno, n.col_offset,
                                       "release", _RELEASE_KIND[t]))
                    elif acquire_kind(n):
                        events.append((n.lineno, n.col_offset,
                                       "acquire", n))
                    elif t:
                        events.append((n.lineno, n.col_offset,
                                       "call", t))
                    else:
                        events.append((n.lineno, n.col_offset,
                                       "call", "<dynamic>"))
                elif isinstance(n, (ast.Name, ast.Attribute)) \
                        and isinstance(getattr(n, "ctx", None), ast.Load):
                    # a release method handed off as a callback
                    # (`release_cb=self._release`) transfers release
                    # responsibility to the callee
                    t = _terminal(n)
                    parent = ctx.parent(n)
                    is_func = isinstance(parent, ast.Call) \
                        and parent.func is n
                    if t in _RELEASE_KIND and not is_func:
                        events.append((n.lineno, n.col_offset,
                                       "release", _RELEASE_KIND[t]))
                elif isinstance(n, ast.Raise):
                    events.append((n.lineno, n.col_offset, "raise", None))
            for line, _col, ev, payload in sorted(
                    events, key=lambda e: (e[0], e[1])):
                seq[0] += 1
                if ev == "release":
                    release_event(payload)
                elif ev == "acquire":
                    if managed:
                        continue
                    call = payload
                    open_acqs.append(_Acq(acquire_kind(call),
                                          call.lineno, call.col_offset))
                elif ev == "call":
                    risk_event(chelpers, ckinds, line)
                    helper_event(payload, line)
                elif ev == "raise":
                    risk_event(chelpers, ckinds, line)

        def protection(tr: ast.Try) -> Tuple[frozenset, frozenset]:
            kinds: Set[str] = set()
            helpers: Set[str] = set()
            bodies = list(tr.finalbody)
            for h in tr.handlers:
                bodies.extend(h.body)
            for st in bodies:
                for n in ast.walk(st):
                    if isinstance(n, ast.Call):
                        t = _terminal(n.func)
                        if t in _RELEASE_KIND:
                            kinds.add(_RELEASE_KIND[t])
                        elif t:
                            helpers.add(t)
            return frozenset(kinds), frozenset(helpers)

        def scan(stmts: List[ast.stmt], ckinds: frozenset,
                 chelpers: frozenset) -> None:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue
                if isinstance(st, ast.Try) or \
                        st.__class__.__name__ == "TryStar":
                    pk, ph = protection(st)
                    scan(st.body, ckinds | pk, chelpers | ph)
                    for h in st.handlers:
                        scan(h.body, ckinds, chelpers)
                    scan(st.orelse, ckinds, chelpers)
                    scan(st.finalbody, ckinds, chelpers)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        leaf(item.context_expr, ckinds, chelpers,
                             managed=True)
                    scan(st.body, ckinds, chelpers)
                elif isinstance(st, (ast.For, ast.AsyncFor)):
                    leaf(st.iter, ckinds, chelpers)
                    scan(st.body, ckinds, chelpers)
                    scan(st.orelse, ckinds, chelpers)
                elif isinstance(st, (ast.While, ast.If)):
                    leaf(st.test, ckinds, chelpers)
                    scan(st.body, ckinds, chelpers)
                    scan(st.orelse, ckinds, chelpers)
                else:
                    leaf(st, ckinds, chelpers)

        scan(fn.body, frozenset(), frozenset())
        records.extend(open_acqs)
        out = []
        for acq in records:
            out.append({"kind": acq.kind, "line": acq.line,
                        "col": acq.col, "fn": fn.name,
                        "risks": acq.risks, "helpers": acq.helpers,
                        "close_idx": acq.close_idx})
        return out

    # -- project analysis ---------------------------------------------

    def project_check(self, facts: Dict[str, Dict[str, Any]]
                      ) -> Iterator[Finding]:
        rel_by_fn: Dict[str, Set[str]] = {}
        for fct in facts.values():
            for name, kinds in (fct or {}).get("releases", {}).items():
                rel_by_fn.setdefault(name, set()).update(kinds)

        def releases(name: str, kind: str) -> bool:
            if _RELEASE_KIND.get(name) == kind:
                return True
            return kind in rel_by_fn.get(name, set())

        for path, fct in facts.items():
            for rec in (fct or {}).get("records", []):
                kind = rec["kind"]
                cutoff = rec["close_idx"]
                if cutoff is None:
                    rel_helpers = [h for h in rec["helpers"]
                                   if releases(h["name"], kind)]
                    if not rel_helpers:
                        # no matching release in reach: the resource is
                        # lifecycle-managed or ownership moved elsewhere
                        continue
                    cutoff = rel_helpers[0]["idx"]
                risky = [r for r in rec["risks"]
                         if r["idx"] < cutoff
                         and not any(releases(p, kind)
                                     for p in r["protectors"])]
                if not risky:
                    continue
                first = risky[0]
                yield self.finding_at(
                    path, rec["line"], rec["col"],
                    f"'{kind}' resource acquired in '{rec['fn']}' can "
                    f"leak: the statement at line {first['line']} can "
                    f"raise before the matching release runs — move "
                    f"the release into try/finally or a context "
                    f"manager, or release in an except branch before "
                    f"re-raising")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        yield from self.project_check({ctx.path: self.collect_facts(ctx)})


# =====================================================================
# RT024: unattributed sleep in a goodput-instrumented training path
# =====================================================================


class UnattributedSleep(_TorchRule):
    id = "RT024"
    name = "unattributed-sleep-in-training-path"
    rationale = ("the goodput ledger classifies every second of a "
                 "bound thread's wall time; a bare time.sleep inside an "
                 "instrumented loop lands in whatever bucket happens to "
                 "be open (or reads as phantom idle) with no signal "
                 "why — the wait must be named")

    _SLEEP_NAMES = {"time.sleep", "sleep"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if _path_exempt(ctx.path):
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not self._instrumented(ctx, fn):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if ctx.dotted(node.func) not in self._SLEEP_NAMES:
                    continue
                if self._inside_bucket(ctx, node, fn):
                    continue
                yield self.finding(
                    ctx, node,
                    f"bare time.sleep in goodput-instrumented "
                    f"'{fn.name}': the blocked wall time is "
                    f"unattributed (phantom idle in the job's goodput "
                    f"ledger) — wrap it in `with goodput.bucket(...)` "
                    f"naming the wait, or move the pacing out of the "
                    f"instrumented path")

    @staticmethod
    def _goodput_call(ctx: ModuleContext, call: ast.Call) -> bool:
        """A call into the ledger API: goodput.bucket/charge/enter/
        ledger(...) (module alias included — anything dotted through a
        name ending in 'goodput')."""
        dotted = ctx.dotted(call.func) or ""
        head, _, tail = dotted.rpartition(".")
        return head.endswith("goodput") and \
            tail in ("bucket", "charge", "enter", "ledger")

    def _instrumented(self, ctx: ModuleContext, fn: ast.AST) -> bool:
        """The function participates in ledger accounting: it opens
        bucket scopes, charges time, or binds a ledger."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and self._goodput_call(ctx, node):
                return True
        return False

    def _inside_bucket(self, ctx: ModuleContext, node: ast.AST,
                       fn: ast.AST) -> bool:
        """Lexically under a `with goodput.bucket(...)` (or a ledger
        method's .bucket(...)) — the sleep's wall time IS attributed."""
        for anc in ctx.ancestors(node):
            if anc is fn:
                return False
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    e = item.context_expr
                    if not isinstance(e, ast.Call):
                        continue
                    dotted = ctx.dotted(e.func) or ""
                    if dotted.rpartition(".")[2] == "bucket":
                        return True
        return False

"""ray_tpu_torch.dag: lazy task graphs (DAGNode API).

reference parity: python/ray/dag — DAGNode (dag_node.py:23),
FunctionNode, ClassNode/ClassMethodNode, InputNode: `.bind()` builds the
graph lazily; `.execute()` walks it, submitting each node as a task (or
actor call) with upstream results passed as ObjectRefs — used by Serve
app graphs and Workflow.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

_node_counter = [0]
_counter_lock = threading.Lock()


def _next_id() -> int:
    with _counter_lock:
        _node_counter[0] += 1
        return _node_counter[0]


class DAGNode:
    """Base graph node. Subclasses define _execute_impl."""

    def __init__(self, args: tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._id = _next_id()

    # -- traversal -----------------------------------------------------

    def _children(self) -> List["DAGNode"]:
        out = [a for a in self._bound_args if isinstance(a, DAGNode)]
        out += [v for v in self._bound_kwargs.values()
                if isinstance(v, DAGNode)]
        return out

    def _resolve_args(self, memo: Dict[int, Any],
                      dag_input: Any) -> Tuple[tuple, Dict[str, Any]]:
        def res(x: Any) -> Any:
            if isinstance(x, DAGNode):
                return x._execute_memo(memo, dag_input)
            return x
        return (tuple(res(a) for a in self._bound_args),
                {k: res(v) for k, v in self._bound_kwargs.items()})

    def _execute_memo(self, memo: Dict[int, Any], dag_input: Any) -> Any:
        if self._id not in memo:
            memo[self._id] = self._execute_impl(memo, dag_input)
        return memo[self._id]

    def _execute_impl(self, memo: Dict[int, Any], dag_input: Any) -> Any:
        raise NotImplementedError

    def execute(self, dag_input: Any = None) -> Any:
        """Run the graph; returns this node's result (an ObjectRef for
        task/method nodes — ray_tpu_torch.get() it)."""
        return self._execute_memo({}, dag_input)

    def experimental_compile(self) -> "CompiledDAG":
        """Pre-resolve the static parts of this graph for repeated
        execution (reference: ray.dag experimental_compile / aDAG).

        The interpreted `.execute()` re-walks the whole graph every
        call — in particular every ClassNode instantiates a FRESH
        actor (lease round trip + worker startup) per execution. A
        compiled DAG instantiates each ClassNode's actor ONCE at
        compile time and reuses it across `.execute()` calls, so a
        repeat execution costs only the method submits.

        If a cached actor dies, the next `.execute()` notices (owner-
        side death record, no RPC), tears the compiled channels down
        and falls back to the interpreted path — correct results,
        interpreted cost. `.teardown()` kills the compile-created
        actors."""
        return CompiledDAG(self)


class InputNode(DAGNode):
    """Placeholder for the value passed to execute() (reference
    input_node.py)."""

    def __init__(self) -> None:
        super().__init__((), {})

    def _execute_impl(self, memo, dag_input):
        return dag_input

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        pass


class FunctionNode(DAGNode):
    """A @remote function bound into the graph (reference
    function_node.py)."""

    def __init__(self, remote_fn: Any, args: tuple,
                 kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, memo, dag_input):
        args, kwargs = self._resolve_args(memo, dag_input)
        return self._remote_fn.remote(*args, **kwargs)

    @property
    def name(self) -> str:
        return getattr(self._remote_fn, "_fn", self._remote_fn).__name__


class ClassNode(DAGNode):
    """An actor class bound into the graph (reference class_node.py);
    attribute access yields bindable methods."""

    def __init__(self, actor_cls: Any, args: tuple,
                 kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def _execute_impl(self, memo, dag_input):
        args, kwargs = self._resolve_args(memo, dag_input)
        return self._actor_cls.remote(*args, **kwargs)

    def __getattr__(self, method_name: str) -> "_BindableMethod":
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        return _BindableMethod(self, method_name)


class _BindableMethod:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args: Any, **kwargs: Any) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name,
                               args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str,
                 args: tuple, kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self) -> List[DAGNode]:
        return super()._children() + [self._class_node]

    def _execute_impl(self, memo, dag_input):
        actor = self._class_node._execute_memo(memo, dag_input)
        args, kwargs = self._resolve_args(memo, dag_input)
        return getattr(actor, self._method_name).remote(*args, **kwargs)


class CompiledDAG:
    """A DAG whose static structure was resolved once up front.

    Compilation walks the graph, instantiates every ClassNode's actor
    immediately (memoized per node id — the graph's sharing structure
    is preserved) and caches the topological order. `execute()` seeds
    the interpreter memo with the cached actor handles, so repeated
    executions skip the per-node actor-creation round trips that
    dominate the interpreted path.

    Liveness: before each execute the cached actors are checked
    against the owner's local death records (a dict lookup — the death
    pubsub keeps it current, no RPC on the hot path). Any dead actor
    invalidates the compiled plan: remaining compile-created actors
    are torn down and this and all later `execute()` calls run the
    plain interpreted path (fresh actors per execution). Explicit
    `teardown()` does the same eagerly.

    Restriction: an actor constructor whose arguments depend on
    InputNode cannot be hoisted out of `execute()`; compiling such a
    graph raises ValueError.
    """

    def __init__(self, output_node: DAGNode):
        self._output = output_node
        self._nodes = self._collect(output_node)
        class_nodes = [n for n in self._nodes if isinstance(n, ClassNode)]
        input_reachable = self._input_reachable()
        for cn in class_nodes:
            if cn._id in input_reachable:
                raise ValueError(
                    "cannot compile: actor constructor depends on "
                    "InputNode (its value is only known at execute())")
        # instantiate every actor ONCE, sharing one memo so diamond-
        # shaped graphs (two method nodes on one ClassNode) get one
        # actor, exactly like a single interpreted execution would
        seed: Dict[int, Any] = {}
        for cn in class_nodes:
            cn._execute_memo(seed, None)
        self._actor_seed = {cn._id: seed[cn._id] for cn in class_nodes}
        self._valid = True
        self._lock = threading.Lock()
        self.executions = 0
        self.fallbacks = 0

    # -- graph analysis ------------------------------------------------

    @staticmethod
    def _collect(root: DAGNode) -> List[DAGNode]:
        out: List[DAGNode] = []
        seen: set = set()
        stack = [root]
        while stack:
            n = stack.pop()
            if n._id in seen:
                continue
            seen.add(n._id)
            out.append(n)
            stack.extend(n._children())
        return out

    def _input_reachable(self) -> set:
        """Node ids whose subtree contains an InputNode."""
        reach: set = set()
        # nodes were collected root-first; children resolve before
        # parents when walked in reverse
        for n in reversed(self._nodes):
            if isinstance(n, InputNode) or any(
                    c._id in reach for c in n._children()):
                reach.add(n._id)
        return reach

    # -- execution -----------------------------------------------------

    def _actors_alive(self) -> bool:
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod.global_worker_or_none()
        if w is None:
            return False
        for handle in self._actor_seed.values():
            if w.core_worker.actor_is_dead(handle._actor_id):
                return False
        return True

    def execute(self, dag_input: Any = None) -> Any:
        with self._lock:
            if self._valid and not self._actors_alive():
                self._invalidate_locked()
            valid = self._valid
        if not valid:
            self.fallbacks += 1
            return self._output._execute_memo({}, dag_input)
        self.executions += 1
        memo: Dict[int, Any] = dict(self._actor_seed)
        return self._output._execute_memo(memo, dag_input)

    def _invalidate_locked(self) -> None:
        self._valid = False
        from ray_tpu_torch import api
        for handle in self._actor_seed.values():
            try:
                api.kill(handle)
            except Exception:  # noqa: BLE001 - teardown of an already-
                # dead or unreachable actor must not mask the fallback
                pass

    def teardown(self) -> None:
        """Kill the compile-created actors and drop to interpreted
        execution for any later `execute()` calls."""
        with self._lock:
            if self._valid:
                self._invalidate_locked()


__all__ = ["DAGNode", "InputNode", "FunctionNode", "ClassNode",
           "ClassMethodNode", "CompiledDAG"]

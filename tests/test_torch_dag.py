"""The port's lazy task graphs (dag/, a copy of the JAX package's under
the rename rule) and trace propagation (util/tracing.py), on the CPU.

Mirrors of the dag cases of tests/test_misc_parity.py and of
tests/test_tracing_appo.py's trace propagation on ray_tpu_torch, with
their assertions, plus a compiled DAG's reuse of its actor and its
teardown, and use_trace adopting an external id. One cluster for the
module (ray_tpu_torch.init(num_cpus=4)).
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import tracing


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_dag_function_graph(cluster):
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    def plus(a, b):
        return a + b

    @ray_tpu_torch.remote
    def times(a, b):
        return a * b

    with InputNode() as inp:
        dag = times.bind(plus.bind(inp, 10), 2)
    assert ray_tpu_torch.get(dag.execute(5)) == 30
    assert ray_tpu_torch.get(dag.execute(0)) == 20


def test_dag_diamond_executes_shared_node_once(cluster, tmp_path):
    counter = str(tmp_path / f"dag_count_{os.getpid()}")

    @ray_tpu_torch.remote
    def base(path):
        with open(path, "a") as f:
            f.write("x")
        return 3

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    shared = base.bind(counter)
    dag = add.bind(shared, shared)
    assert ray_tpu_torch.get(dag.execute()) == 6
    assert os.path.getsize(counter) == 1, "shared node ran twice"


def test_dag_actor_graph(cluster):
    @ray_tpu_torch.remote
    class Acc:
        def __init__(self, start):
            self.v = start

        def add(self, x):
            self.v += x
            return self.v

    node = Acc.options(num_cpus=0.1).bind(100)
    dag = node.add.bind(5)
    assert ray_tpu_torch.get(dag.execute()) == 105


def test_compiled_dag_reuses_its_actor_then_tears_down(cluster):
    """experimental_compile() builds the ClassNode's actor once: state
    carries over between executions, and teardown() kills the actor and
    drops later executions to the interpreted path (a fresh actor)."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Acc:
        def __init__(self, start):
            self.v = start

        def add(self, x):
            self.v += x
            return self.v

    with InputNode() as inp:
        dag = Acc.options(num_cpus=0.1).bind(100).add.bind(inp)
    compiled = dag.experimental_compile()
    assert [ray_tpu_torch.get(compiled.execute(x), timeout=60)
            for x in (1, 2, 3)] == [101, 103, 106]
    assert compiled.executions == 3 and compiled.fallbacks == 0
    compiled.teardown()
    assert ray_tpu_torch.get(compiled.execute(1), timeout=60) == 101
    assert compiled.fallbacks == 1


def test_trace_propagates_to_children(cluster):
    @ray_tpu_torch.remote
    def child(x):
        return x + 1

    @ray_tpu_torch.remote
    def parent_task(x):
        return ray_tpu_torch.get(child.remote(x)) * 10

    with tracing.start_trace("op") as trace_id:
        assert ray_tpu_torch.get(parent_task.remote(1)) == 20
    deadline = time.time() + 10
    recs = []
    while time.time() < deadline and len(recs) < 2:
        recs = tracing.get_trace(trace_id)
        time.sleep(0.3)
    names = {r["name"] for r in recs}
    assert {"parent_task", "child"} <= names, names
    child_rec = next(r for r in recs if r["name"] == "child")
    parent_rec = next(r for r in recs if r["name"] == "parent_task")
    assert child_rec["parent_task_id"] == parent_rec["task_id"]
    tree = tracing.trace_tree(trace_id)
    assert parent_rec["task_id"] in tree


def test_use_trace_adopts_an_external_id(cluster):
    """use_trace (what the Serve proxies wrap each request in): tasks
    submitted inside the block carry the given id, and the caller's
    trace is restored after it."""
    @ray_tpu_torch.remote
    def leaf():
        return tracing.get_current_trace_id()

    assert tracing.get_current_trace_id() is None
    with tracing.use_trace("ingress0001", name="req"):
        assert ray_tpu_torch.get(leaf.remote(), timeout=60) == "ingress0001"
    assert tracing.get_current_trace_id() is None
    deadline = time.time() + 10
    recs = []
    while time.time() < deadline and not recs:
        recs = tracing.get_trace("ingress0001")
        time.sleep(0.3)
    assert [r["name"] for r in recs] == ["leaf"]

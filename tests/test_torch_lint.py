"""The port's linter (ray_tpu_torch/lint/) against the JAX package's
(ray_tpu/lint/), on the CPU.

Every rule the port copies (RT001-RT019 in lint/rules.py and
lint/concurrency.py, RT023 and RT024 in lint/torchrules.py) must find the
same things at the same lines as the reference: over the sources of
ray_tpu/rllib/ and ray_tpu_torch/_private/, file by file, and over the
reference's own per-rule fixtures (tests/test_lint.py). The rules of
lint/concurrency.py, a verbatim copy (VERBATIM in test_torch_runtime.py),
are held over a few sources that take locks: their class analysis costs
seconds a file on the largest runtime modules, and the byte comparison
already holds the rest. Each linter reads
a source under its own package's names (the rename rule of
tests/test_torch_runtime.py, which keeps every line where it is): the
framework names its rules know, such as `ray_tpu.remote`, are its own
package's. RT021 is rewritten for tensors: each JAX fixture of
tests/test_lint.py:1639-1730 stands beside its translation, line for
line, and both give the same rule id at the same lines; more fixtures
hold the tensor-specific taint rules.
"""

import ast
import importlib
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from ray_tpu.lint import lint_source as ref_lint
from ray_tpu_torch.lint import lint_source as port_lint
from ray_tpu_torch.lint.rules import ALL_RULES as PORT_RULES

REPO = Path(__file__).resolve().parent.parent

# the rules the port copies as they are; those of the verbatim
# lint/concurrency.py apart
COPIED = sorted(r.id for r in PORT_RULES if r.id != "RT021")
CONCURRENCY = sorted(r.id for r in PORT_RULES
                     if type(r).__module__.endswith(".concurrency"))


def rename(src: str) -> str:
    """The JAX package's names -> the port's (test_torch_runtime.py)."""
    src = re.sub(r"\bray_tpu\.", "ray_tpu_torch.", src)
    src = re.sub(r"\bfrom ray_tpu import\b", "from ray_tpu_torch import",
                 src)
    return re.sub(r"\bimport ray_tpu\b(?![.\w])", "import ray_tpu_torch",
                  src)


def unrename(src: str) -> str:
    """The port's names -> the JAX package's."""
    src = re.sub(r"\bray_tpu_torch\b", "ray_tpu", src)
    return src


def _found(findings, rules):
    return sorted((f.rule_id, f.line) for f in findings
                  if f.rule_id in rules)


def test_port_catalogue_is_the_reference_minus_jax_mechanisms():
    from ray_tpu.lint.rules import ALL_RULES as REF_RULES
    ref = {r.id: type(r).__name__ for r in REF_RULES}
    port = {r.id: type(r).__name__ for r in PORT_RULES}
    assert set(ref) - set(port) == {"RT020", "RT022"}
    assert port == {k: v for k, v in ref.items()
                    if k not in ("RT020", "RT022")}


# ---- the same sources: ray_tpu/rllib/ and ray_tpu_torch/_private/ --------

SOURCES = sorted(
    [str(p.relative_to(REPO)) for p in (REPO / "ray_tpu/rllib").rglob("*.py")]
    + [str(p.relative_to(REPO))
       for p in (REPO / "ray_tpu_torch/_private").rglob("*.py")])


def _checked(pkg, src, path, rules):
    """(rule id, line) of the given rules alone on one source, with its
    suppressions, as lint_source finds them (it runs every rule)."""
    engine = importlib.import_module(pkg + ".lint.engine")
    all_rules = importlib.import_module(pkg + ".lint.rules").ALL_RULES
    ctx = engine.build_context(src, path)
    supp = engine._suppressions(ctx.source_lines)
    return sorted((f.rule_id, f.line) for r in all_rules if r.id in rules
                  for f in r.check(ctx) if not engine._suppressed(f, supp))


def _both(path):
    src = (REPO / path).read_text()
    if path.startswith("ray_tpu/"):
        return src, rename(src)
    return unrename(src), src


@pytest.mark.parametrize("path", SOURCES)
def test_copied_rules_find_the_same_in_the_same_sources(path):
    ref_src, port_src = _both(path)
    rules = set(COPIED) - set(CONCURRENCY)
    assert _checked("ray_tpu_torch", port_src, path, rules) == \
        _checked("ray_tpu", ref_src, path, rules)


# sources that take locks, one of each kind of user
LOCKED = ("ray_tpu/rllib/core/learner.py", "ray_tpu_torch/_private/spans.py",
          "ray_tpu_torch/_private/ownership.py",
          "ray_tpu_torch/_private/rpc.py")


@pytest.mark.parametrize("path", LOCKED)
def test_concurrency_rules_find_the_same_in_sources_with_locks(path):
    assert path in SOURCES
    ref_src, port_src = _both(path)
    assert _found(port_lint(port_src, path, select=CONCURRENCY),
                  CONCURRENCY) == \
        _found(ref_lint(ref_src, path, select=CONCURRENCY), CONCURRENCY)


# ---- the reference's own fixtures, for every copied rule ----------------

def _fixtures():
    """tests/test_lint.py's module-level per-rule fixture sources."""
    tree = ast.parse((REPO / "tests/test_lint.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and re.match(r"RT\d{3}_", node.targets[0].id) \
                and isinstance(node.value, ast.Constant):
            out[node.targets[0].id] = textwrap.dedent(node.value.value)
    return out


FIXTURES = _fixtures()
COPIED_FIXTURES = sorted(n for n in FIXTURES if n[:5] in COPIED)


@pytest.mark.parametrize("name", COPIED_FIXTURES)
def test_copied_rules_on_the_reference_fixtures(name):
    src = FIXTURES[name]
    # RT017 judges request-serving paths only, as its own tests lint it
    path = "serve/fix.py" if name.startswith("RT017") else "fix.py"
    ref = _found(ref_lint(src, path), COPIED)
    assert _found(port_lint(rename(src), path), COPIED) == ref
    # a positive fixture is found, a suppressed or negative one is not
    hit = any(rid == name[:5] for rid, _line in ref)
    assert hit == ("_POS" in name or name[5:] in (
        "_SLEEP", "_GET", "_WAIT", "_SOCKET", "_OPEN"))


# ---- RT021: each JAX fixture beside its translation, line for line ------

RT021_PAIRS = {
    # tests/test_lint.py RT021_POS and RT021_SUPPRESSED
    "pos": (FIXTURES["RT021_POS"], """
        import torch

        def _fwd(x):
            return x

        step = torch.nn.Linear(4, 4)

        def train(x):
            y = step(x)
            return y.item()
    """),
    "suppressed": (FIXTURES["RT021_SUPPRESSED"], """
        import torch

        def _fwd(x):
            return x

        step = torch.nn.Linear(4, 4)

        def train(x):
            y = step(x)
            return y.item()  # graftlint: disable=RT021
    """),
    # test_rt021_coercions_print_and_barrier
    "coercions_print_barrier": ("""
        import jax
        import numpy as np

        def _fwd(x):
            return x

        step = jax.jit(_fwd)

        def train(x):
            y = step(x)
            a = float(y)
            b = np.asarray(y)
            print(y)
            y.block_until_ready()
            return a, b
    """, """
        import torch
        import numpy as np

        def _fwd(x):
            return x

        step = torch.nn.Linear(4, 4)

        def train(x):
            y = step(x)
            a = float(y)
            b = np.asarray(y)
            print(y)
            torch.cuda.synchronize()
            return a, b
    """),
    # test_rt021_device_get_and_meta_fine: the sanctioned copy to the host
    "sanctioned_copy_and_meta": ("""
        import jax

        def _fwd(x):
            return x

        step = jax.jit(_fwd)

        def train(x):
            y = step(x)
            host = jax.device_get(y)
            n = y.shape[0]
            return host.item(), n
    """, """
        import torch

        def _fwd(x):
            return x

        step = torch.nn.Linear(4, 4)

        def train(x):
            y = step(x)
            host = y.cpu()
            n = y.shape[0]
            return host.item(), n
    """),
}
# test_rt021_exempt_paths: the positive fixture under each path
RT021_PATHS = ("fix.py", "tests/fix.py", "tools/dump.py", "scripts/run.py")


@pytest.mark.parametrize("path", RT021_PATHS)
@pytest.mark.parametrize("pair", sorted(RT021_PAIRS))
def test_rt021_translated_fixtures_match(pair, path):
    jax_src, torch_src = (textwrap.dedent(s) for s in RT021_PAIRS[pair])
    assert len(jax_src.splitlines()) == len(torch_src.splitlines())
    ref = _found(ref_lint(jax_src, path), {"RT021"})
    assert _found(port_lint(torch_src, path), {"RT021"}) == ref
    want = {"pos": 1, "coercions_print_barrier": 4}.get(pair, 0)
    assert len(ref) == (want if path == "fix.py" else 0)


# tensor fixtures: the source and the lines RT021 must flag (line 1 is
# the blank line after the opening quotes)
RT021_TORCH = {
    "factory_on_a_device": ("""
        import torch

        def f(dev):
            x = torch.zeros(3, device=dev)
            y = torch.ones(3)
            z = torch.zeros(3, device="cpu")
            return x.tolist(), y.tolist(), z.tolist()
    """, [8]),
    "to_device_cuda_and_host": ("""
        import torch

        def f(t, dev):
            a = t.to(dev)
            b = t.cuda()
            c = a.to("cpu")
            d = t.to(torch.float32)
            e = b.to(torch.bfloat16)
            return a.numpy(), int(b), c.item(), d.item(), bool(e)
    """, [10, 10, 10]),
    "ops_on_device_values": ("""
        import torch

        def f(dev):
            x = torch.randn(4, device=dev)
            y = torch.stack([x, x]).sum()
            host = torch.stack([x, x]).cpu()
            return float(y), float(host[0]), x.shape[0]
    """, [8]),
    "make_train_step": ("""
        from ray_tpu_torch.parallel.train_step import make_train_step

        def train(loss_fn, state, batches):
            init_state, train_step = make_train_step(loss_fn)
            for batch in batches:
                state, metrics = train_step(state, batch)
                print(metrics["loss"])
            return metrics["loss"].item()
    """, [8, 9]),
    "module_subclass_and_self_attr": ("""
        import torch
        from torch import nn

        class Net(nn.Module):
            pass

        class Learner:
            def __init__(self):
                self.model = torch.nn.Linear(4, 4).cuda()
                self.net = Net().to("cuda")

            def update(self, x):
                y = self.model(x)
                z = self.net(x)
                return float(y), z.tolist()
    """, [16, 16]),
    "step_method_stats_in_a_comprehension": ("""
        class Learner:
            def _full_batch_step(self, batch):
                return self.compute(batch)

            def update(self, batch):
                stats = self._full_batch_step(batch)
                return {k: v.item() for k, v in stats.items()}
    """, [8]),
    "exempt_and_suppressed_barrier": ("""
        import torch

        def wait():
            torch.cuda.synchronize()  # graftlint: disable=RT021
    """, []),
}


@pytest.mark.parametrize("case", sorted(RT021_TORCH))
def test_rt021_tensor_taint(case):
    src, lines = RT021_TORCH[case]
    found = port_lint(textwrap.dedent(src), "fix.py")
    assert sorted(f.line for f in found if f.rule_id == "RT021") == lines


def test_cli_runs_over_the_port():
    """`python -m ray_tpu_torch.lint` over a port module: the catalogue
    without RT020/RT022, and its JSON header."""
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.lint", "--list-rules"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    ids = [line.split()[0] for line in out.stdout.splitlines()]
    assert ids == [r.id for r in PORT_RULES] and "RT020" not in ids
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.lint", "--format=json",
         "ray_tpu_torch/util/cuda_sentinel.py"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert '"findings": []' in out.stdout

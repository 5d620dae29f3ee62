"""graftlint: framework-aware static analysis for ray_tpu programs.

Generic linters cannot see the bug surface of the paper's programming
model — CPU actors shipping trajectories through an object store into
JIT'd XLA learners. graftlint knows the framework idioms and flags the
failure shapes that actually take clusters down: nested blocking gets
(distributed deadlock), serialized get-in-a-loop (trajectory-plane
throttling), host side effects and closed-over state mutation inside
traced jit/scan bodies (silent staleness, retrace storms), leaked
ObjectRefs, and swallowed exceptions in actor event loops.

Usage:

    python -m ray_tpu_torch.lint [paths...] [--format=text|json]
    python tools/lint.py ray_tpu/

Suppress a finding with a trailing (or preceding-line) comment:

    ref = ray_tpu_torch.get(inner)  # graftlint: disable=RT001

See README.md ("Static analysis") for the rule catalogue.
"""

from ray_tpu_torch.lint.engine import (Finding, lint_paths, lint_file,  # noqa: F401
                                 lint_source)
from ray_tpu_torch.lint.rules import ALL_RULES, Rule  # noqa: F401

__all__ = ["Finding", "Rule", "ALL_RULES", "lint_paths", "lint_file",
           "lint_source"]

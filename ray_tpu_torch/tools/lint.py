#!/usr/bin/env python
"""CI lint runner: `python -m ray_tpu_torch.tools.lint [paths...]`.

Thin wrapper over `python -m ray_tpu_torch.lint` that defaults to
linting the ray_tpu_torch package itself, its examples/ and tools/
apart (the JAX package keeps those at the repo root, outside what
tools/lint.py lints), the zero-findings baseline, WITH the on-disk
incremental cache enabled (.graftlint-torch-cache.json at the repo
root, a file of its own: tests/test_lint.py writes the JAX package's),
keyed by file content hash + rule-set fingerprint, so the tier-1
baseline test re-parses only files that changed since the last run.
`--changed` limits reporting to git-changed files. Exits non-zero on
any finding so CI fails the PR; `--format=json` feeds dashboards.
Fast and JAX_PLATFORMS=cpu-safe: pure AST analysis, nothing under test
is imported.
"""

from __future__ import annotations

import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_PATH = os.path.join(_REPO_ROOT, ".graftlint-torch-cache.json")
# what lies outside the JAX package, at the repo root
OUTSIDE = ("examples", "tools")


def main(argv=None) -> int:
    sys.path.insert(0, _REPO_ROOT)
    from ray_tpu_torch.lint.__main__ import main as lint_main
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(not a.startswith("-") for a in argv):
        pkg = os.path.join(_REPO_ROOT, "ray_tpu_torch")
        argv += sorted(os.path.join(pkg, n) for n in os.listdir(pkg)
                       if n not in OUTSIDE)
    has_cache_flag = any(a == "--cache" or a.startswith("--cache=")
                         for a in argv)
    if not has_cache_flag and "--no-cache" not in argv:
        argv += ["--cache", CACHE_PATH]
    argv = [a for a in argv if a != "--no-cache"]
    return lint_main(argv)


if __name__ == "__main__":
    sys.exit(main())

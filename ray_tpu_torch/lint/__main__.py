"""graftlint CLI: `python -m ray_tpu_torch.lint [paths...]`.

Exit codes: 0 clean, 1 findings, 2 usage error. `--format=json` emits a
machine-readable object for CI tooling and dashboards: a `graftlint`
header naming the effective --select/--ignore filter (so a green run is
auditable — "clean under WHICH rules?"), then the `findings` array.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence


def _git_changed_files() -> Optional[List[str]]:
    """Absolute paths of .py files changed vs HEAD (worktree + index)
    plus untracked ones; None when git is unavailable/not a repo."""
    import os
    import subprocess
    out: List[str] = []
    try:
        root = subprocess.check_output(
            ["git", "rev-parse", "--show-toplevel"],
            stderr=subprocess.DEVNULL, text=True).strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            got = subprocess.check_output(
                cmd, stderr=subprocess.DEVNULL, text=True, cwd=root)
        except (OSError, subprocess.CalledProcessError):
            continue  # e.g. a fresh repo with no HEAD yet
        out.extend(os.path.join(root, line)
                   for line in got.splitlines()
                   if line.endswith(".py"))
    return sorted({p for p in out if os.path.isfile(p)})


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ray_tpu_torch.lint.engine import lint_paths
    from ray_tpu_torch.lint.rules import ALL_RULES

    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.lint",
        description="framework-aware static analysis for ray_tpu programs")
    parser.add_argument("paths", nargs="*", default=["."],
                        help="files or directories to lint (default: .)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text", dest="fmt",
                        help="output format (default: text)")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--ignore", default=None,
                        help="comma-separated rule ids to skip")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    parser.add_argument("--cache", default=None, metavar="PATH",
                        help="on-disk findings cache keyed by file "
                             "content hash (+ rule-set fingerprint); "
                             "unchanged files skip parsing entirely")
    parser.add_argument("--changed", action="store_true",
                        help="report findings only for files git "
                             "considers changed (worktree + index + "
                             "untracked); the whole tree is still "
                             "enumerated so cross-file lock-order "
                             "analysis (RT016) stays sound — pair "
                             "with --cache to make that cheap")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id} {rule.name}: {rule.rationale}")
        return 0

    select = [s for s in (args.select or "").split(",") if s] or None
    ignore = [s for s in (args.ignore or "").split(",") if s] or None
    from ray_tpu_torch.lint.rules import RULES_BY_ID
    unknown = [s for s in (select or []) + (ignore or [])
               if s.upper() not in RULES_BY_ID]
    if unknown:
        # a typo'd rule id must not turn the CI gate into a green
        # zero-findings run of zero rules
        print(f"error: unknown rule id(s) {', '.join(unknown)} "
              f"(known: {', '.join(sorted(RULES_BY_ID))})",
              file=sys.stderr)
        return 2
    paths: List[str] = args.paths or ["."]
    only_files = None
    if args.changed:
        only_files = _git_changed_files()
        if only_files is None:
            print("error: --changed requires a git checkout "
                  "(git diff failed)", file=sys.stderr)
            return 2
        if not only_files:
            print("no changed python files")
            return 0
    try:
        findings = lint_paths(paths, select=select, ignore=ignore,
                              cache_path=args.cache,
                              only_files=only_files)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.fmt == "json":
        ran = [r.id for r in ALL_RULES
               if (select is None or r.id in {s.upper()
                                              for s in select})
               and (ignore is None or r.id not in {s.upper()
                                                   for s in ignore})]
        print(json.dumps({
            "graftlint": {"select": select, "ignore": ignore,
                          "rules": ran},
            "findings": [f.to_dict() for f in findings]}, indent=1))
    else:
        for f in findings:
            print(f.format())
        if findings:
            print(f"\n{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

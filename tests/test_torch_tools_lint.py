"""The port's lint runner (ray_tpu_torch/tools/lint.py, the JAX
package's tools/lint.py under the rename rule with the edits REPAIRED
lists in test_torch_runtime.py) on the CPU.

`python -m ray_tpu_torch.tools.lint` exits 0 over the port (its default
paths: the package without its examples/ and tools/, which the JAX
package keeps at the repo root, outside what tools/lint.py lints) with
its own cache file, which it writes: the zero-findings baseline. It
exits 1 on a finding. A cold run lints every file (about a minute on
one core: core_worker.py's class analysis alone takes ~14 s).
"""

import json
import subprocess
import sys
from pathlib import Path

from ray_tpu_torch.tools import lint as port_lint

REPO = Path(__file__).resolve().parent.parent


def test_lint_tool_lints_the_port_clean_with_its_own_cache(tmp_path):
    cache = Path(port_lint.CACHE_PATH)
    assert cache.parent == REPO and cache.name != ".graftlint-cache.json"
    assert cache.name in (REPO / ".gitignore").read_text().split()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.lint"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert cache.exists()
    linted = json.loads(cache.read_text())
    assert json.dumps(linted).count("ray_tpu_torch/_private/core_worker.py")
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\n"
                   "def f():\n"
                   "    t0 = time.time()\n"
                   "    return time.time() - t0\n")
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.lint", "--no-cache",
         str(bad)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "RT010" in out.stdout, out.stdout

"""The port's operator tooling on the CPU: the CLI (scripts/cli.py and
`python -m ray_tpu_torch`) and job submission (job/), copies of the JAX
package's under the rename rule.

Mirrors of tests/test_ops_tooling.py's CLI and job cases on
ray_tpu_torch (the memory-monitor and autoscaler cases wait for the
autoscaler's slice), with the CLI called in process through
scripts.cli.main as the reference's later CLI tests call it; a job whose
entrypoint computes the port's TINY f32 loss from the JAX package's
parameters (numpy, saved here), held to the JAX package's
Transformer.loss within 1e-5; and one `python -m ray_tpu_torch` in a
fresh process, which loads no jax, optax or ray_tpu module; and one
`start --head` with a TMPDIR of its own, whose head file goes with it.
The CLI over Serve, the replay plane and the other planes is in
test_torch_cli_planes.py. No case calls `stop`: it kills by pattern
across the machine. One cluster for the module
(ray_tpu_torch.init(num_cpus=4)).
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.job import JobSubmissionClient
from ray_tpu_torch.scripts.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def address():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch.get_gcs_address()
    ray_tpu_torch.shutdown()


def test_cli_status_and_list(address, capsys):
    @ray_tpu_torch.remote
    def touch():
        return 1

    ray_tpu_torch.get(touch.remote())
    assert cli_main(["status", "--address", address]) == 0
    out = capsys.readouterr().out
    assert "alive" in out and "CPU" in out

    assert cli_main(["list", "nodes", "--address", address]) == 0
    assert "ALIVE" in capsys.readouterr().out

    time.sleep(1.5)  # task event flush
    assert cli_main(["list", "tasks", "--address", address]) == 0
    assert "touch" in capsys.readouterr().out

    assert cli_main(["summary", "--address", address]) == 0
    assert "FINISHED" in capsys.readouterr().out


def test_cli_timeline_and_memory(address, capsys, tmp_path):
    @ray_tpu_torch.remote
    def work():
        time.sleep(0.01)
        return 1

    ray_tpu_torch.get([work.remote() for _ in range(3)])
    time.sleep(1.5)
    out_file = str(tmp_path / "tl.json")
    assert cli_main(["timeline", "-o", out_file, "--address", address]) == 0
    assert json.load(open(out_file)), "empty timeline"
    assert cli_main(["memory", "--address", address]) == 0
    assert "bytes" in capsys.readouterr().out


def test_job_submission_end_to_end(address, tmp_path):
    script = tmp_path / "job_script.py"
    script.write_text(
        "import os, ray_tpu_torch\n"
        "ray_tpu_torch.init(os.environ['RAY_TPU_ADDRESS'])\n"
        "@ray_tpu_torch.remote\n"
        "def f(x):\n"
        "    return x + 1\n"
        "print('JOB RESULT:', ray_tpu_torch.get(f.remote(41)))\n"
        "ray_tpu_torch.shutdown()\n")
    client = JobSubmissionClient(address)
    job_id = client.submit_job(entrypoint=f"{sys.executable} {script}",
                               working_dir=REPO)
    status = client.wait(job_id, timeout=180)
    logs = client.get_job_logs(job_id)
    assert status == "SUCCEEDED", logs
    assert "JOB RESULT: 42" in logs
    assert any(j["job_id"] == job_id and j["status"] == "SUCCEEDED"
               for j in client.list_jobs())


def test_job_failure_status(address):
    client = JobSubmissionClient(address)
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    assert client.wait(job_id, timeout=120) == "FAILED"


def test_job_loss_matches_jax(address, capsys, tmp_path):
    """`job submit --wait` of a script that computes the port's TINY f32
    loss on the CPU from the JAX package's parameters; the loss it prints
    is the JAX package's within 1e-5, and `job status`, `job logs` and
    `job list` show the job."""
    import jax

    from ray_tpu.models import TINY as JTINY
    from ray_tpu.models import Transformer as JTransformer

    jcfg = JTINY.replace(dtype="float32")
    params = jax.jit(lambda k: JTransformer.init(k, jcfg))(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    want = float(jax.jit(lambda p: JTransformer.loss(
        p, {"tokens": tokens}, jcfg))(params))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    np.save(tmp_path / "tokens.npy", tokens)
    script = tmp_path / "loss_job.py"
    script.write_text(
        "import pickle, sys\n"
        "import numpy as np, torch\n"
        "from ray_tpu_torch.models import TINY, Transformer\n"
        "from ray_tpu_torch.models.convert import params_from_jax\n"
        f"tree = pickle.load(open({str(tmp_path / 'params.pkl')!r}, 'rb'))\n"
        f"tokens = np.load({str(tmp_path / 'tokens.npy')!r})\n"
        "cfg = TINY.replace(dtype='float32')\n"
        "model = Transformer(cfg, device='cpu')\n"
        "model.load_state_dict(params_from_jax(tree, cfg, device='cpu'))\n"
        "with torch.no_grad():\n"
        "    loss = model.loss({'tokens': torch.from_numpy(tokens)})\n"
        "assert not any(m.split('.')[0] in ('jax', 'ray_tpu')\n"
        "               for m in sys.modules)\n"
        "print('JOB LOSS', repr(loss.item()))\n")
    # the entrypoint as one argument right after "submit": the CLI joins
    # its words with spaces, and the argparse of some Python 3.12
    # releases fills the optional job_id and entrypoint positionals at
    # "submit" when options follow it
    assert cli_main(["job", "submit", f"{sys.executable} {script}",
                     "--address", address, "--wait",
                     "--working-dir", REPO]) == 0
    out = capsys.readouterr().out
    job_id = out.split("submitted: ")[1].split()[0]
    assert "status: SUCCEEDED" in out
    assert cli_main(["job", "status", job_id, "--address", address]) == 0
    assert capsys.readouterr().out.strip() == "SUCCEEDED"
    assert cli_main(["job", "logs", job_id, "--address", address]) == 0
    logs = capsys.readouterr().out
    got = float(logs.split("JOB LOSS ")[1].split()[0])
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)
    assert cli_main(["job", "list", "--address", address]) == 0
    assert job_id in capsys.readouterr().out


def test_python_m_runs_the_ports_cli_without_jax(address):
    """`python -m ray_tpu_torch status` in a fresh process: the port's
    CLI, and no jax, optax or ray_tpu module among those it imports
    (-X importtime lists every module an interpreter imports)."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ray_tpu_torch",
         "status"], capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, RAY_TPU_ADDRESS=address))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "alive" in out.stdout and "CPU" in out.stdout
    imported = {line.rsplit("|", 1)[1].strip()
                for line in out.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "ray_tpu_torch.scripts.cli" in imported
    assert not {m for m in imported if m.split(".")[0] in
                ("jax", "jaxlib", "optax", "ray_tpu")}


def _catches_sigterm(pid):
    with open(f"/proc/{pid}/status") as f:
        caught = next(ln for ln in f if ln.startswith("SigCgt:"))
    return bool(int(caught.split()[1], 16) >> (signal.SIGTERM - 1) & 1)


def test_head_file_under_tmpdir_goes_with_its_head(tmp_path):
    """The reference's `start --head` writes its address and pid to the
    fixed /tmp/ray_tpu_head.json, which every checkout and both packages
    share, and leaves the file behind when SIGTERM ends the head: it then
    names a dead head, whose pid a later `stop` signals. The port's head
    writes the file under TMPDIR and removes it as it exits. The head
    runs with TMPDIR set to this case's own directory, and no case calls
    `stop`."""
    ref = open(os.path.join(REPO, "ray_tpu/scripts/cli.py")).read()
    assert 'HEAD_INFO_PATH = "/tmp/ray_tpu_head.json"\n' in ref
    assert "unlink" not in ref[ref.index("def cmd_start"):
                               ref.index("def cmd_stop")]

    path = tmp_path / "ray_tpu_head.json"
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("RAY_TPU_ADDRESS", None)
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--block",
         "--num-cpus", "1"], stdout=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        info = json.loads(head.stdout.readline())
        assert info["pid"] == head.pid
        assert json.loads(path.read_text()) == info
        # the head prints before it catches SIGTERM: wait for its handler
        deadline = time.monotonic() + 60
        while not _catches_sigterm(head.pid):
            assert time.monotonic() < deadline, "the head never caught SIGTERM"
            time.sleep(0.05)
        head.terminate()
        assert head.wait(60) == 0
        assert not path.exists()
    finally:
        if head.poll() is None:
            head.kill()
            head.wait()
        head.stdout.close()

"""Job supervisor actor + submission client.

reference parity: dashboard/modules/job/job_manager.py (JobSupervisor
runs the entrypoint as a subprocess, streams status) and sdk.py
(JobSubmissionClient.submit_job/get_job_status/get_job_logs).
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

_KV_PREFIX = "job::"

PENDING, RUNNING, SUCCEEDED, FAILED = \
    "PENDING", "RUNNING", "SUCCEEDED", "FAILED"
TERMINAL = (SUCCEEDED, FAILED)


class JobSupervisor:
    """Runs one job's entrypoint as a subprocess on its node; writes
    status + logs into the GCS KV (reference job_manager.py
    JobSupervisor.run)."""

    def __init__(self, job_id: str, entrypoint: str,
                 working_dir: Optional[str], gcs_address: str,
                 env_vars: Optional[Dict[str, str]] = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.working_dir = working_dir
        self.gcs_address = gcs_address
        self.env_vars = env_vars or {}
        self._proc: Optional[subprocess.Popen] = None
        threading.Thread(target=self._run, daemon=True,
                         name=f"job-{job_id}").start()

    def _kv_put(self, suffix: str, value: Any) -> None:
        import ray_tpu_torch
        cw = ray_tpu_torch._private.worker.global_worker().core_worker
        cw._gcs.call("kv_put", key=f"{_KV_PREFIX}{self.job_id}::{suffix}",
                     value=json.dumps(value).encode())

    def _set_status(self, status: str, message: str = "") -> None:
        self._kv_put("status", {"status": status, "message": message,
                                "ts": time.time()})

    def _run(self) -> None:
        import tempfile
        self._set_status(RUNNING)
        log_path = os.path.join(tempfile.gettempdir(),
                                f"ray_tpu_job_{self.job_id}.log")
        env = dict(os.environ)
        env["RAY_TPU_ADDRESS"] = self.gcs_address
        env.update(self.env_vars)
        try:
            with open(log_path, "wb") as log:
                self._proc = subprocess.Popen(
                    self.entrypoint, shell=True, stdout=log,
                    stderr=subprocess.STDOUT, env=env,
                    cwd=self.working_dir or None)
                rc = self._proc.wait()
            with open(log_path, "rb") as f:
                logs = f.read()[-200_000:].decode(errors="replace")
            self._kv_put("logs", logs)
            self._set_status(SUCCEEDED if rc == 0 else FAILED,
                             f"exit code {rc}")
        except Exception as e:  # noqa: BLE001
            self._set_status(FAILED, repr(e))

    def ping(self) -> str:
        return "pong"

    def stop_job(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()


class JobSubmissionClient:
    """reference dashboard/modules/job/sdk.py, over the core API instead
    of REST (the HTTP surface can front this 1:1)."""

    def __init__(self, address: str):
        import ray_tpu_torch
        ray_tpu_torch.init(address, ignore_reinit_error=True)
        self._rt = ray_tpu_torch
        self._address = address

    def _gcs(self):
        return self._rt._private.worker.global_worker().core_worker._gcs

    def submit_job(self, *, entrypoint: str,
                   working_dir: Optional[str] = None,
                   env_vars: Optional[Dict[str, str]] = None) -> str:
        job_id = f"job_{uuid.uuid4().hex[:10]}"
        self._gcs().call(
            "kv_put", key=f"{_KV_PREFIX}{job_id}::meta",
            value=json.dumps({"entrypoint": entrypoint,
                              "submitted_at": time.time()}).encode())
        self._gcs().call(
            "kv_put", key=f"{_KV_PREFIX}{job_id}::status",
            value=json.dumps({"status": PENDING}).encode())
        cls = self._rt.remote(JobSupervisor)
        supervisor = cls.options(
            name=f"JOB_SUPERVISOR::{job_id}", namespace="job",
            num_cpus=0.1).remote(job_id, entrypoint, working_dir,
                                 self._address, env_vars)
        self._rt.get(supervisor.ping.remote(), timeout=120)
        return job_id

    def _kv_get(self, job_id: str, suffix: str) -> Optional[Any]:
        raw = self._gcs().call("kv_get",
                               key=f"{_KV_PREFIX}{job_id}::{suffix}")
        return json.loads(raw) if raw else None

    def get_job_status(self, job_id: str) -> str:
        st = self._kv_get(job_id, "status")
        return st["status"] if st else "NOT_FOUND"

    def get_job_logs(self, job_id: str) -> str:
        return self._kv_get(job_id, "logs") or ""

    def list_jobs(self) -> List[Dict[str, Any]]:
        keys = self._gcs().call("kv_keys", prefix=_KV_PREFIX)
        out = []
        for key in keys:
            if not key.endswith("::meta"):
                continue
            job_id = key[len(_KV_PREFIX):-len("::meta")]
            meta = self._kv_get(job_id, "meta") or {}
            out.append({"job_id": job_id,
                        "status": self.get_job_status(job_id),
                        "entrypoint": meta.get("entrypoint", "")})
        return out

    def wait(self, job_id: str, timeout: float = 600.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in TERMINAL:
                return status
            time.sleep(0.5)
        return self.get_job_status(job_id)

    def stop_job(self, job_id: str) -> None:
        try:
            sup = self._rt.get_actor(f"JOB_SUPERVISOR::{job_id}",
                                     namespace="job")
            self._rt.get(sup.stop_job.remote(), timeout=60)
        except Exception:  # noqa: BLE001 - supervisor already gone; nothing to stop
            pass

"""Job submission: run driver scripts on the cluster with tracked status.

reference parity: dashboard/modules/job/ — job_manager.py (drivers run as
child processes of an agent-managed supervisor actor), sdk.py
(JobSubmissionClient with submit/status/logs), cli.py. Here the
supervisor is a detached-ish named actor per job; status and logs
persist in the GCS KV so any client can query them.
"""

from ray_tpu_torch.job.manager import JobSubmissionClient, JobSupervisor  # noqa: F401

__all__ = ["JobSubmissionClient", "JobSupervisor"]

"""Job submission API (reference: python/ray/job_submission)."""
from .core.jobs import JobStatus, JobSubmissionClient

__all__ = ["JobStatus", "JobSubmissionClient"]

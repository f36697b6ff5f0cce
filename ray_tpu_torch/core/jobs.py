"""Job submission: run driver scripts under the cluster's supervision.

Reference counterpart: python/ray/job_submission (JobSubmissionClient:
submit_job/stop_job/get_job_status/get_job_logs/tail_job_logs) and
dashboard job manager. Local scope (SURVEY.md §2.8 O9): the entrypoint
runs as a subprocess with captured logs; runtime_env env_vars/working_dir
apply to it.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class _Job:
    def __init__(self, submission_id: str, entrypoint: str,
                 proc: subprocess.Popen, log_path: str, metadata):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.proc = proc
        self.log_path = log_path
        self.metadata = metadata or {}
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.stopped = False

    def status(self) -> str:
        rc = self.proc.poll()
        if rc is None:
            return JobStatus.RUNNING
        if self.end_time is None:
            self.end_time = time.time()
        if self.stopped:
            return JobStatus.STOPPED
        return JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED


class JobSubmissionClient:
    """Reference-parity client (python/ray/job_submission). Two modes:

    * local (address=None): jobs run as subprocesses of THIS process.
    * HTTP (address="http://host:port"): every call proxies to a
      dashboard's /api/jobs endpoints (observability/dashboard.py), the
      way the reference client talks to the dashboard job head — submit
      from any process, logs stream back over chunked HTTP.
    """

    def __init__(self, address: Optional[str] = None,
                 log_dir: Optional[str] = None):
        self._address = (address.rstrip("/")
                         if address and address.startswith("http")
                         else None)
        self._jobs: Dict[str, _Job] = {}
        self._log_dir = log_dir or tempfile.mkdtemp(prefix="ray_tpu_jobs_")

    # ---- HTTP proxy plumbing ----
    def _http(self, route: str, payload=None, timeout: float = 30.0):
        import json as json_mod
        import urllib.request
        req = urllib.request.Request(
            self._address + route,
            data=(json_mod.dumps(payload).encode()
                  if payload is not None else None),
            headers={"Content-Type": "application/json"},
            method="POST" if payload is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                out = json_mod.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                msg = json_mod.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise ValueError(msg) from None
        if isinstance(out, dict) and "error" in out:
            raise ValueError(out["error"])
        return out

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        if self._address:
            return self._http("/api/jobs", {
                "entrypoint": entrypoint, "runtime_env": runtime_env,
                "submission_id": submission_id,
                "metadata": metadata})["submission_id"]
        from . import runtime_env as renv_mod
        renv = renv_mod.validate(runtime_env)
        sid = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        if sid in self._jobs:
            raise ValueError(f"submission_id {sid!r} already used")
        env = dict(os.environ)
        env.update(renv.get("env_vars", {}))
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_root, *(renv.get("py_modules") or []),
             *[p for p in env.get("PYTHONPATH", "").split(os.pathsep)
               if p]])
        cwd = renv.get("working_dir") or os.getcwd()
        log_path = os.path.join(self._log_dir, f"{sid}.log")
        logf = open(log_path, "wb")
        proc = subprocess.Popen(
            entrypoint, shell=True, cwd=cwd, env=env,
            stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True)   # own pgid: stop_job kills the tree
        logf.close()
        self._jobs[sid] = _Job(sid, entrypoint, proc, log_path, metadata)
        return sid

    def _job(self, sid: str) -> _Job:
        if sid not in self._jobs:
            raise ValueError(f"unknown job {sid!r}")
        return self._jobs[sid]

    def get_job_status(self, submission_id: str) -> str:
        if self._address:
            return self.get_job_info(submission_id)["status"]
        return self._job(submission_id).status()

    def get_job_info(self, submission_id: str) -> Dict[str, Any]:
        if self._address:
            return self._http(f"/api/jobs/{submission_id}")
        j = self._job(submission_id)
        return {"submission_id": j.submission_id, "status": j.status(),
                "entrypoint": j.entrypoint, "metadata": j.metadata,
                "start_time": j.start_time, "end_time": j.end_time}

    def list_jobs(self) -> List[Dict[str, Any]]:
        if self._address:
            return self._http("/api/jobs")
        return [self.get_job_info(sid) for sid in self._jobs]

    def get_job_logs(self, submission_id: str) -> str:
        if self._address:
            return self._http(f"/api/jobs/{submission_id}/logs")["logs"]
        j = self._job(submission_id)
        try:
            with open(j.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def tail_job_logs(self, submission_id: str,
                      poll_interval_s: float = 0.1) -> Iterator[str]:
        if self._address:
            yield from self._tail_http(submission_id)
            return
        j = self._job(submission_id)
        pos = 0
        while True:
            with open(j.log_path, "rb") as f:
                f.seek(pos)
                chunk = f.read()
                pos = f.tell()
            if chunk:
                yield chunk.decode(errors="replace")
            elif j.status() != JobStatus.RUNNING:
                return
            else:
                time.sleep(poll_interval_s)

    def _tail_http(self, submission_id: str) -> Iterator[str]:
        """Stream the dashboard's chunked follow endpoint until EOF."""
        import codecs
        import urllib.request
        url = (f"{self._address}/api/jobs/{submission_id}/logs"
               f"?follow=1")
        # incremental decoder: a multi-byte UTF-8 char split across
        # read1 chunks must not turn into replacement garbage
        dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
        try:
            with urllib.request.urlopen(url, timeout=None) as r:
                while True:
                    piece = r.read1(65536)
                    if not piece:
                        tail = dec.decode(b"", final=True)
                        if tail:
                            yield tail
                        return
                    text = dec.decode(piece)
                    if text:
                        yield text
        except urllib.error.HTTPError as e:
            raise ValueError(f"tail failed: {e}") from None

    def stop_job(self, submission_id: str) -> bool:
        if self._address:
            return self._http(f"/api/jobs/{submission_id}/stop",
                              {})["stopped"]
        j = self._job(submission_id)
        if j.proc.poll() is not None:
            return False
        j.stopped = True
        try:
            os.killpg(j.proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            j.proc.terminate()
        try:
            j.proc.wait(timeout=3.0)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(j.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                j.proc.kill()
        return True

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(submission_id)
            if st not in (JobStatus.PENDING, JobStatus.RUNNING):
                return st
            time.sleep(0.05)
        raise TimeoutError(f"job {submission_id} still running "
                           f"after {timeout}s")

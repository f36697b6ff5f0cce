"""Worker log capture + driver streaming + per-task attribution.

Reference counterpart: python/ray/_private/ray_logging — per-worker log
files under the session dir, with `log_to_driver=True` tailing them into
the driver's stdout prefixed `(worker_id pid)` the way `(raylet)` /
`(pid=...)` prefixes work in the reference.

Capture is fd-level (dup2), so C/C++ native prints (XLA, the shm arena)
land in the file too, not just Python's sys.stdout.

Per-task attribution (failure forensics): the worker writes a marker
line straight to fd 1 whenever the currently-executing task changes, so
every captured line between two markers belongs to that task — native
prints included, since everything shares the one appended fd. The
driver side strips markers from the echoed stream (tagging the prefix
instead) and `task_log_tail()` reassembles one task's lines for
post-mortem bundles. With actor max_concurrency > 1 several tasks share
the process; attribution is then last-marker-wins (best effort, same as
the reference's out-of-band prints).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..util import knobs

# Marker line format: TASK_MARKER<task_id or "-">TASK_MARKER_END + "\n".
# Chosen to never collide with ordinary output and to survive
# line-splitting readers (always written as one whole line).
TASK_MARKER = "::ray_tpu::task::"
TASK_MARKER_END = "::"

_redirected = False
_marker_lock = threading.Lock()


def redirect_process_output(log_path: str) -> None:
    """In the worker: point fd 1/2 at log_path (line-buffered)."""
    global _redirected
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    # rebind the Python-level streams to the new fds, line-buffered
    sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    _redirected = True


def mark_current_task(task_id: Optional[str]) -> None:
    """Stamp the log with the task now executing (None = idle). A raw
    os.write to fd 1 keeps ordering with both Python prints (flushed
    first) and native writes, which share the O_APPEND fd. No-op when
    output was never redirected (interactive worker: no file to tag)."""
    try:
        # the sampling profiler shares the task markers: tell it which
        # task now owns this thread BEFORE the redirect check, so
        # attribution works even in interactive (unredirected) workers
        from ..observability import sampling_profiler  # noqa: PLC0415
        sampling_profiler.mark_thread(task_id)
    except Exception:
        pass
    if not _redirected:
        return
    try:
        with _marker_lock:
            sys.stdout.flush()
            sys.stderr.flush()
            os.write(1, (f"{TASK_MARKER}{task_id or '-'}"
                         f"{TASK_MARKER_END}\n").encode())
    except Exception:
        pass  # attribution must never fail user work


def parse_marker(line: str) -> Optional[Optional[str]]:
    """task_id if `line` is a marker ("-" -> None idle marker);
    a non-marker line returns the sentinel string "__not_marker__"."""
    s = line.strip()
    if s.startswith(TASK_MARKER) and s.endswith(TASK_MARKER_END):
        tid = s[len(TASK_MARKER):-len(TASK_MARKER_END)]
        return None if tid == "-" else tid
    return "__not_marker__"


def attribute_lines(text: str, current: Optional[str] = None
                    ) -> Tuple[List[Tuple[Optional[str], str]],
                               Optional[str]]:
    """Split captured text into (task_id, line) pairs, threading the
    marker state; returns (pairs, final_current) so a tailing caller
    can carry attribution across chunks."""
    pairs: List[Tuple[Optional[str], str]] = []
    for line in text.splitlines():
        mk = parse_marker(line)
        if mk != "__not_marker__":
            current = mk
            continue
        pairs.append((current, line))
    return pairs, current


# Only the newest max_lines survive a tail query, so reading a whole
# multi-GB worker log to answer one would be pure waste — read at most
# this many trailing bytes per file. A task whose attribution marker
# fell before the window loses its oldest lines (best effort, same as
# any tail).
TAIL_READ_BYTES = knobs.get_int("RAY_TPU_LOG_TAIL_BYTES")


def read_log_tail(path: str,
                  max_bytes: int = 0) -> str:
    """The trailing `max_bytes` (default TAIL_READ_BYTES) of a log
    file, starting at a whole line."""
    max_bytes = max_bytes or TAIL_READ_BYTES
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - max_bytes))
        raw = f.read()
    if size > max_bytes:
        # drop the (possibly split) first line of the window
        cut = raw.find(b"\n") + 1
        raw = raw[cut:]
    return raw.decode("utf-8", errors="replace")


def task_log_tail(log_dir: str, task_id: str,
                  max_lines: int = 200) -> List[Dict[str, str]]:
    """The tail of every captured line attributed to `task_id` across
    this node's worker log files (newest last), for post-mortem
    bundles: [{"worker": "worker-w0001", "line": ...}, ...]."""
    out: List[Dict[str, str]] = []
    try:
        names = sorted(os.listdir(log_dir))
    except OSError:
        return out
    for fname in names:
        if not fname.endswith(".log"):
            continue
        try:
            text = read_log_tail(os.path.join(log_dir, fname))
        except OSError:
            continue
        for tid, line in attribute_lines(text)[0]:
            if tid == task_id and line.strip():
                out.append({"worker": fname.rsplit(".", 1)[0],
                            "line": line})
    return out[-max_lines:]


class LogStreamer:
    """In the driver: tail every worker log file, prefix, and echo.
    Marker lines are consumed (not echoed); while a task is attributed
    to a file, its lines stream prefixed `(worker-wNNNN task=<id>)`."""

    def __init__(self, log_dir: str, *, out=None, poll_interval_s: float = 0.2):
        self.log_dir = log_dir
        self.out = out or sys.stdout
        self.poll_interval_s = poll_interval_s
        self._pos: Dict[str, int] = {}
        self._task: Dict[str, Optional[str]] = {}   # fname -> current task
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-log-stream")
        self._thread.start()

    def _emit(self, fname: str, chunk: str) -> None:
        label = fname.rsplit(".", 1)[0]          # worker-w0001
        pairs, self._task[fname] = attribute_lines(
            chunk, self._task.get(fname))
        for tid, line in pairs:
            if not line.strip():
                continue
            if tid:
                self.out.write(f"({label} task={tid}) {line}\n")
            else:
                self.out.write(f"({label}) {line}\n")
        try:
            self.out.flush()
        except Exception:
            pass

    def _scan_once(self, final: bool = False) -> None:
        try:
            names = sorted(os.listdir(self.log_dir))
        except OSError:
            return
        for fname in names:
            if not fname.endswith(".log"):
                continue
            path = os.path.join(self.log_dir, fname)
            pos = self._pos.get(fname, 0)
            try:
                with open(path, "rb") as f:
                    f.seek(pos)
                    raw = f.read()
            except OSError:
                continue
            if not raw:
                continue
            # consume only whole lines so a poll landing mid-write never
            # splits a line (or a multi-byte char); the final drain takes
            # whatever remains.
            cut = len(raw) if final else raw.rfind(b"\n") + 1
            if cut <= 0:
                continue
            self._pos[fname] = pos + cut
            self._emit(fname, raw[:cut].decode("utf-8", errors="replace"))

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self._scan_once()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)   # no concurrent scans
        self._scan_once(final=True)      # drain, including partial lines

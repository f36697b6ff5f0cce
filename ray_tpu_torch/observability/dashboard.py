"""Dashboard: HTTP JSON endpoints over the state API.

Reference counterpart: python/ray/dashboard (head modules serving
/api/...). No JS frontend (documented gap in SURVEY.md §2.8 O2); every
panel the reference renders is available as JSON:

  GET /api/cluster     — cluster summary
  GET /api/persistence — control-plane WAL/snapshot health
  GET /api/dispatch    — batched-dispatch plane counters (submit
                         batches, worker leases, direct actor calls)
  GET /api/nodes       — node table
  GET /api/actors      — actor table
  GET /api/tasks       — task table
  GET /api/objects     — object summary + rows
  GET /api/workers     — worker processes
  GET /api/placement_groups
  GET /api/timeline    — chrome-trace events
  GET /api/profile     — sampling-profiler aggregate
                         (?format=summary|collapsed|speedscope,
                          ?worker=<wid>, ?task=<task id>)
  GET /api/waits       — cluster wait chains with root causes
                         (?id=<subject>, ?min_age=<seconds>)
  GET /api/waitgraph   — folded waits-on graph + watchdog findings
  GET /metrics         — Prometheus text exposition

Job submission over HTTP (reference: python/ray/dashboard/modules/job/
job_head.py + job_manager.py — submit/status/logs via the dashboard):

  POST /api/jobs                 {"entrypoint": ..., "runtime_env": ...}
  GET  /api/jobs                 — job table
  GET  /api/jobs/<sid>           — one job's info
  GET  /api/jobs/<sid>/logs      — captured logs (?follow=1 streams
                                   chunked text until the job exits)
  POST /api/jobs/<sid>/stop      — SIGTERM the job's process group
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from ..util import metrics as metrics_mod
from ..util import state as state_mod
from . import timeline as timeline_mod


_jobs_client = None
_jobs_lock = threading.Lock()


def _jobs():
    """One shared JobSubmissionClient behind the HTTP surface (jobs
    submitted over HTTP and via this process's Python client share a
    table the way the reference's JobManager does)."""
    global _jobs_client
    with _jobs_lock:
        if _jobs_client is None:
            from ..core.jobs import JobSubmissionClient
            _jobs_client = JobSubmissionClient()
        return _jobs_client


class _Handler(BaseHTTPRequestHandler):
    # chunked Transfer-Encoding (log follow) is only legal on HTTP/1.1;
    # everything else sends Content-Length so keep-alive stays correct
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):       # silence per-request stderr noise
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj: Any, code: int = 200) -> None:
        self._send(code, json.dumps(obj, default=str).encode())

    def do_GET(self):
        try:
            parsed = urlparse(self.path)
            q = parse_qs(parsed.query)
        except ValueError:
            self._json({"error": "malformed query string"}, 400)
            return
        try:
            limit = int(q.get("limit", ["100"])[0])
            since_seq = int(q.get("since", ["0"])[0])
        except (ValueError, TypeError):
            # a malformed query param is the CLIENT's error, not a 500
            self._json({"error": "limit/since must be integers"}, 400)
            return
        route = parsed.path.rstrip("/")
        try:
            if route == "/api/cluster":
                self._json(state_mod.cluster_summary())
            elif route == "/api/persistence":
                self._json(state_mod.persistence_summary())
            elif route == "/api/dispatch":
                self._json(state_mod.dispatch_summary())
            elif route == "/api/nodes":
                self._json(state_mod.list_nodes(limit=limit))
            elif route == "/api/actors":
                self._json(state_mod.list_actors(limit=limit))
            elif route == "/api/tasks":
                self._json(state_mod.list_tasks(limit=limit))
            elif route == "/api/objects":
                self._json({"summary": state_mod.summarize_objects(),
                            "objects": state_mod.list_objects(limit=limit)})
            elif route == "/api/workers":
                self._json(state_mod.list_workers(limit=limit))
            elif route == "/api/placement_groups":
                self._json(state_mod.list_placement_groups(limit=limit))
            elif route == "/api/summary/tasks":
                self._json(state_mod.summarize_tasks())
            elif route == "/api/summary/actors":
                self._json(state_mod.summarize_actors())
            elif route == "/api/summary/objects":
                self._json(state_mod.summarize_objects())
            elif route == "/api/events":
                ids = [v for key in ("id", "task_id", "actor_id",
                                     "object_id", "node_id",
                                     "worker_id")
                       for v in q.get(key, [])]
                types = q.get("type") or None
                sevs = q.get("severity") or None
                rows = state_mod.list_events(
                    limit=limit, ids=ids or None, types=types,
                    severities=sevs, since_seq=since_seq)
                self._json({"events": list(rows),
                            "total": rows.total,
                            "truncated": rows.truncated})
            elif route == "/api/summary/events":
                self._json(state_mod.summarize_events())
            elif route == "/api/post_mortem":
                sid = (q.get("id") or [""])[0]
                if not sid:
                    self._json({"error": "missing ?id=<task|actor id>"},
                               400)
                else:
                    from . import forensics
                    self._json(forensics.build_post_mortem(sid))
            elif route == "/api/waits":
                sid = (q.get("id") or [None])[0]
                try:
                    min_age = float((q.get("min_age") or ["0"])[0])
                except (ValueError, TypeError):
                    self._json({"error": "min_age must be a number"},
                               400)
                    return
                self._json({"waits": state_mod.wait_chains(
                    subject_id=sid, min_age_s=min_age)})
            elif route == "/api/waitgraph":
                self._json(state_mod.waitgraph())
            elif route == "/api/timeline":
                self._json(timeline_mod.timeline_events())
            elif route == "/api/profile":
                from ..core.runtime import get_runtime
                store = get_runtime().profile_store
                fmt = (q.get("format") or ["summary"])[0]
                worker = (q.get("worker") or [None])[0]
                task = (q.get("task") or [None])[0]
                if fmt == "collapsed":
                    self._send(200,
                               store.collapsed(worker, task).encode(),
                               "text/plain; charset=utf-8")
                elif fmt == "speedscope":
                    self._json(store.speedscope(worker, task))
                else:
                    self._json(store.summary())
            elif route == "/api/serve":
                self._json(_serve_status())
            elif route == "/api/serve/router":
                self._json(state_mod.serve_router_table())
            elif route == "/api/serve/autoscaler":
                self._json(state_mod.serve_autoscaler_status())
            elif route == "/api/jobs":
                self._json(_jobs().list_jobs())
            elif route.startswith("/api/jobs/"):
                parts = route.split("/")  # ['', 'api', 'jobs', sid, ...]
                sid = parts[3]
                if len(parts) == 4:
                    self._json(_jobs().get_job_info(sid))
                elif parts[4] == "logs" and q.get("follow", ["0"])[0] \
                        in ("1", "true"):
                    self._stream_logs(sid)
                elif parts[4] == "logs":
                    self._json({"submission_id": sid,
                                "logs": _jobs().get_job_logs(sid)})
                else:
                    self._json({"error": f"no route {route}"}, 404)
            elif route == "/metrics":
                # merged cluster exposition: local registry + every
                # worker/node snapshot shipped to the driver (series
                # tagged node_id/worker_id)
                self._send(200, metrics_mod.cluster_exposition().encode(),
                           "text/plain; version=0.0.4")
            elif route in ("", "/"):
                self._send(200, _INDEX_HTML.encode(),
                           "text/html; charset=utf-8")
            elif route == "/api":
                self._json({"routes": ["/api/cluster", "/api/nodes",
                                       "/api/actors", "/api/tasks",
                                       "/api/objects", "/api/workers",
                                       "/api/placement_groups",
                                       "/api/dispatch",
                                       "/api/serve",
                                       "/api/serve/router",
                                       "/api/serve/autoscaler",
                                       "/api/summary/tasks",
                                       "/api/summary/actors",
                                       "/api/summary/objects",
                                       "/api/summary/events",
                                       "/api/events",
                                       "/api/post_mortem",
                                       "/api/jobs",
                                       "/api/waits", "/api/waitgraph",
                                       "/api/timeline", "/api/profile",
                                       "/metrics"]})
            else:
                self._json({"error": f"no route {route}"}, 404)
        except (BrokenPipeError, ConnectionResetError):
            # client hung up mid-response: writing an error body would
            # raise again and leak a 500 into the server log — just
            # drop the connection
            self.close_connection = True
        except ValueError as e:      # unknown job id etc.
            self._json({"error": str(e)}, 404)
        except Exception as e:  # surface errors as JSON, keep serving
            try:
                self._json({"error": repr(e)}, 500)
            except OSError:
                self.close_connection = True

    def do_POST(self):
        route = urlparse(self.path).path.rstrip("/")
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}") if n else {}
            if route == "/api/jobs":
                sid = _jobs().submit_job(
                    entrypoint=body["entrypoint"],
                    runtime_env=body.get("runtime_env"),
                    submission_id=body.get("submission_id"),
                    metadata=body.get("metadata"))
                self._json({"submission_id": sid})
            elif route.startswith("/api/jobs/") and \
                    route.endswith("/stop"):
                sid = route.split("/")[3]
                self._json({"submission_id": sid,
                            "stopped": _jobs().stop_job(sid)})
            elif route == "/api/profile":
                # drive one worker's sampling profiler:
                # {"worker": wid, "action": start|stop|snapshot|status,
                #  "hz": 100}  (core/worker.py profile_ctl verb)
                from ..core.runtime import get_runtime
                self._json(get_runtime().profile_ctl(
                    body["worker"], body.get("action", "status"),
                    body.get("hz")))
            else:
                self._json({"error": f"no route {route}"}, 404)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        except KeyError as e:
            self._json({"error": f"missing field {e}"}, 400)
        except json.JSONDecodeError as e:
            # malformed request body is the client's error, not a 404
            self._json({"error": f"malformed JSON body: {e}"}, 400)
        except ValueError as e:
            self._json({"error": str(e)}, 404)
        except Exception as e:  # noqa: BLE001
            try:
                self._json({"error": repr(e)}, 500)
            except OSError:
                self.close_connection = True

    def _stream_logs(self, sid: str) -> None:
        """Chunked text/plain tail of a job's logs until it exits
        (reference: JobSubmissionClient.tail_job_logs)."""
        _jobs().get_job_info(sid)   # raise ValueError BEFORE headers
        gen = _jobs().tail_job_logs(sid)
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data + b"\r\n")
            self.wfile.flush()

        try:
            for piece in gen:
                if piece:
                    chunk(piece.encode(errors="replace"))
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass                      # client hung up mid-tail
        except Exception:  # noqa: BLE001
            # mid-stream failure AFTER headers went out (e.g. the log
            # file vanished): a second HTTP response would corrupt the
            # chunked framing — terminate the stream and drop the
            # connection instead
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
            self.close_connection = True


def _serve_status() -> Any:
    """Serve application/deployment table if a controller is running."""
    import ray_tpu_torch
    from ..serve.controller import CONTROLLER_NAME
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME, timeout=0.2)
    except ValueError:
        return {"running": False, "applications": {}}
    try:
        apps = ray_tpu_torch.get(ctrl.list_applications.remote(), timeout=5.0)
        detail = {a: ray_tpu_torch.get(ctrl.get_app_status.remote(a),
                                       timeout=5.0) for a in apps}
        return {"running": True, "applications": detail}
    except Exception as e:  # noqa: BLE001
        return {"running": True, "error": repr(e)}


# Single-file status page: fetches the JSON endpoints client-side and
# renders tables (no build step — the documented JS-frontend scope cut
# stays; this is the reference dashboard's overview page, not its SPA).
_INDEX_HTML = """<!doctype html>
<meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body{font:13px system-ui,sans-serif;margin:1.2em;background:#fafafa}
 h1{font-size:18px} h2{font-size:14px;margin:1.2em 0 .3em}
 table{border-collapse:collapse;background:#fff;min-width:40em}
 td,th{border:1px solid #ddd;padding:.25em .6em;text-align:left}
 th{background:#f0f0f0} code{background:#eee;padding:0 .3em}
 #err{color:#b00}
</style>
<h1>ray_tpu_torch dashboard</h1>
<div id=err></div>
<h2>Cluster</h2><table id=cluster></table>
<h2>Nodes</h2><table id=nodes></table>
<h2>Actors</h2><table id=actors></table>
<h2>Task summary</h2><table id=tasks></table>
<h2>Serve</h2><table id=serve></table>
<h2>Jobs</h2><table id=jobs></table>
<h2>Recent warnings &amp; errors</h2><table id=events></table>
<script>
const cell = v => typeof v === 'object' && v !== null
  ? JSON.stringify(v) : String(v);
function rows(el, list){
  const t = document.getElementById(el);
  if (!Array.isArray(list)) list = Object.entries(list).map(
    ([k, v]) => ({key: k, value: v}));
  if (!list.length) { t.innerHTML = '<tr><td>-</td></tr>'; return; }
  const cols = Object.keys(list[0]);
  t.innerHTML = '<tr>' + cols.map(c => `<th>${c}</th>`).join('')
    + '</tr>' + list.map(r => '<tr>' + cols.map(
      c => `<td>${cell(r[c])}</td>`).join('') + '</tr>').join('');
}
async function refresh(){
  try {
    const get = p => fetch(p).then(r => r.json());
    rows('cluster', await get('/api/cluster'));
    rows('nodes', await get('/api/nodes'));
    rows('actors', await get('/api/actors?limit=50'));
    rows('tasks', await get('/api/summary/tasks'));
    const s = await get('/api/serve');
    rows('serve', s.running ? s.applications : {running: false});
    rows('jobs', await get('/api/jobs'));
    const ev = await get(
      '/api/events?severity=warning&severity=error&limit=20');
    rows('events', (ev.events || []).map(e => ({
      seq: e.seq, type: e.type, severity: e.severity,
      message: e.message || '',
      id: e.task_id || e.actor_id || e.object_id || e.node_id || ''})));
    document.getElementById('err').textContent = '';
  } catch (e) {
    document.getElementById('err').textContent = 'refresh failed: ' + e;
  }
}
refresh(); setInterval(refresh, 3000);
</script>"""


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="rtpu-dashboard")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


_dashboard: Optional[Dashboard] = None


def start_dashboard(host: str = "127.0.0.1", port: int = 0) -> Dashboard:
    global _dashboard
    if _dashboard is None:
        _dashboard = Dashboard(host, port)
    return _dashboard


def stop_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        _dashboard.stop()
        _dashboard = None

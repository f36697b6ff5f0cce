"""The port's front doors (cli.py, `python -m ray_tpu_torch`, the
dashboard, memory_monitor, job_submission) against the reference's:
each program runs once under `ray_tpu` and once under `ray_tpu_torch`,
each in a subprocess of its own (never two runtimes in one process), and
their JSON must be equal.

- The dashboard's routes and the keys they answer with, and the CLI
  reading them (tests/test_observability.py's dashboard, CLI and serve
  endpoint cases); `memory_summary`.
- Job submission over HTTP and the CLI's job verbs
  (tests/test_job_http.py).
- `serve run module:app` of a small deployment, ended by SIGINT
  (tests/test_observability.py's serve run case); the port's
  `--dashboard-port` serves `serve status`.
- `python -m ray_tpu_torch lint` applies raylint's checks to the port
  and exits 0 on it; a seeded fault in a copy of the package is
  reported under the copy's own path.

Deliberate differences, normalised before comparing: a worker row's
`tpu_capable` is the port's `gpu_capable`, and the port adds the cards
a worker holds (`gpu_ids`).
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r'''
import io, json, os, sys, tempfile, time, urllib.error, urllib.request
from contextlib import redirect_stdout
from importlib import import_module
pkg = sys.argv[1]
rt = import_module(pkg)
cli = import_module(pkg + ".cli")
obs = import_module(pkg + ".observability")
js = import_module(pkg + ".job_submission")
JobStatus, JobSubmissionClient = js.JobStatus, js.JobSubmissionClient
out = {}


def keys(obj):
    if isinstance(obj, dict):
        return sorted(obj)
    if isinstance(obj, list):
        return sorted({k for row in obj if isinstance(row, dict)
                       for k in row})
    return type(obj).__name__


def fetch(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def run_cli(*argv):
    buf = io.StringIO()
    code = 0
    with redirect_stdout(buf):
        try:
            cli.main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


@rt.remote
def square(x):
    return x * x


@rt.remote
class Doubler:
    def double(self, x):
        return 2 * x


rt.init(num_cpus=2)
rt.get([square.remote(i) for i in range(3)])
d = Doubler.remote()
rt.get(d.double.remote(4))
dash = obs.start_dashboard(port=0)
url = dash.url

routes = {}
for route in ("/api/cluster", "/api/nodes", "/api/actors", "/api/tasks",
              "/api/objects", "/api/workers", "/api/placement_groups",
              "/api/summary/tasks", "/api/summary/actors",
              "/api/summary/objects", "/api/persistence", "/api/dispatch",
              "/api/events", "/api/serve", "/api/waitgraph", "/api/waits"):
    status, ctype, body = fetch(url + route)
    routes[route] = [status, "json" in ctype, keys(json.loads(body))]
status, ctype, body = fetch(url + "/api/timeline")
spans = [e for e in json.loads(body) if e.get("ph") == "X"]
routes["/api/timeline"] = [status, bool(spans),
                           all("ts" in e and "dur" in e for e in spans)]
status, ctype, body = fetch(url + "/metrics")
routes["/metrics"] = [status, "# TYPE" in body.decode()]
status, ctype, body = fetch(url + "/")
routes["/"] = [status, "text/html" in ctype,
               f"{pkg} dashboard" in body.decode()]
try:
    fetch(url + "/nope")
    routes["/nope"] = "no error"
except urllib.error.HTTPError as e:
    routes["/nope"] = e.code
out["routes"] = routes

cluster = json.loads(run_cli("--address", url, "status")[1])
code, text = run_cli("--address", url, "list", "tasks", "--json")
tasks = json.loads(text)
tl = os.path.join(tempfile.mkdtemp(), "tl.json")
run_cli("--address", url, "timeline", "-o", tl)
summary = json.loads(run_cli("--address", url, "summary", "tasks")[1])
actors = run_cli("--address", url, "list", "actors")[1]
workers = run_cli("--address", url, "list", "workers")[1]
metrics = run_cli("--address", url, "metrics")[1]
out["cli"] = [cluster["nodes"], any(t["state"] == "FINISHED" for t in tasks),
              bool(json.load(open(tl))), summary["total"] >= 1,
              "Doubler" in actors, workers.split()[:4],
              "(counter)" in metrics or "(gauge)" in metrics]

mem = obs.memory_summary()
actor_wid = next(a["worker_id"] for a in
                 json.loads(run_cli("--address", url, "list", "actors",
                                    "--json")[1])
                 if a["class_name"] == "Doubler")
out["memory_summary"] = [
    sorted(mem), mem["host_total_bytes"] > 0, mem["driver_rss_bytes"] > 0,
    mem["store_capacity_bytes"] is not None,
    all(w["rss_bytes"] > 0 for w in mem["workers"]),
    any(w["worker_id"] == actor_wid for w in mem["workers"])]

client = JobSubmissionClient(address=url)
jobs = {}
sid = client.submit_job(
    entrypoint=f"{sys.executable} -c \"print('from-http-job')\"",
    metadata={"who": "test"})
jobs["submit"] = [client.wait_until_finished(sid, timeout=60),
                  "from-http-job" in client.get_job_logs(sid),
                  client.get_job_info(sid)["metadata"],
                  any(j["submission_id"] == sid for j in client.list_jobs())]
req = urllib.request.Request(url + "/api/jobs", data=b"{}",
                             headers={"Content-Type": "application/json"})
try:
    urllib.request.urlopen(req, timeout=10)
    raw = "no error"
except urllib.error.HTTPError as e:
    raw = e.code
try:
    client.get_job_info("nope")
    unknown = "no raise"
except ValueError:
    unknown = "ValueError"
jobs["raw_and_unknown"] = [raw, unknown]
script = ("import time\n"
          "for i in range(5): print('line', i, flush=True); "
          "time.sleep(0.1)\n")
sid = client.submit_job(entrypoint=f"{sys.executable} -c \"{script}\"")
got = "".join(client.tail_job_logs(sid))
jobs["follow"] = [all(f"line {i}" in got for i in range(5)),
                  client.get_job_status(sid)]
sid = client.submit_job(
    entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
deadline = time.time() + 10
while (client.get_job_status(sid) != JobStatus.RUNNING
       and time.time() < deadline):
    time.sleep(0.05)
stopped = client.stop_job(sid)
deadline = time.time() + 10
while (client.get_job_status(sid) == JobStatus.RUNNING
       and time.time() < deadline):
    time.sleep(0.05)
jobs["stop"] = [stopped, client.get_job_status(sid)]
code, text = run_cli("--address", url, "job", "submit", "--remote", "--",
                     sys.executable, "-c", "\"print('cli-job-ok')\"")
cli_jobs = [code, "cli-job-ok" in text and "SUCCEEDED" in text]
code, text = run_cli("--address", url, "job", "submit", "--remote",
                     "--no-wait", "--", sys.executable, "-c", "\"print('x')\"")
sid = text.strip()
client.wait_until_finished(sid, timeout=30)
cli_jobs += [run_cli("--address", url, "job", "status", sid)[1].strip(),
             "x" in run_cli("--address", url, "job", "logs", sid)[1],
             sid in run_cli("--address", url, "job", "list")[1]]
jobs["cli"] = cli_jobs
out["jobs"] = jobs
obs.stop_dashboard()
rt.shutdown()
print("RESULT " + json.dumps(out))
'''

APP = '''from {pkg} import serve


@serve.deployment
def hello(body):
    return {{"hello": body}}


app = hello.bind()
'''

SERVE_RUN = r'''
import json, os, signal, subprocess, sys, time, urllib.request
import psutil
pkg, app_dir = sys.argv[1], sys.argv[2]
env = dict(os.environ)
env["PYTHONPATH"] = os.pathsep.join([app_dir, env["PYTHONPATH"]])
extra = ["--dashboard-port", "0"] if pkg == "ray_tpu_torch" else []
proc = subprocess.Popen(
    [sys.executable, "-m", pkg, "serve", "run", "myapp:app", "--port", "0",
     *extra], env=env, cwd=app_dir, stdout=subprocess.PIPE, text=True)
out = {}
try:
    line = proc.stdout.readline()
    out["banner"] = "serving myapp:app on http://" in line
    url = line.strip().rsplit(" ", 1)[-1]
    if extra:
        dash = proc.stdout.readline().strip().rsplit(" ", 1)[-1]
    deadline = time.time() + 60
    reply = None
    while time.time() < deadline:
        try:
            req = urllib.request.Request(
                url + "/", data=json.dumps(7).encode(),
                headers={"Content-Type": "application/json"})
            reply = json.loads(urllib.request.urlopen(req, timeout=5).read())
            break
        except Exception:
            time.sleep(0.3)
    out["reply"] = reply
    if extra:
        st = subprocess.run(
            [sys.executable, "-m", pkg, "--address", dash, "serve",
             "status"], env=env, capture_output=True, text=True,
            timeout=60)
        status = json.loads(st.stdout)
        out["serve_status"] = [st.returncode, status["running"],
                               sorted(status["applications"])]
    kids = psutil.Process(proc.pid).children(recursive=True)
    out["workers"] = sum("core.worker" in " ".join(k.cmdline())
                         for k in kids) > 0
    proc.send_signal(signal.SIGINT)
    out["exit"] = proc.wait(timeout=60)
    deadline = time.time() + 20
    while time.time() < deadline:
        alive = [k for k in kids if k.is_running()
                 and k.status() != psutil.STATUS_ZOMBIE]
        if not alive:
            break
        time.sleep(0.2)
    out["left"] = len(alive)
finally:
    if proc.poll() is None:
        proc.kill()
print("RESULT " + json.dumps(out))
'''


def _spawn(code, *argv):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code, *argv], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, label):
    try:
        stdout, stderr = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (
        f"{label} run failed (rc {proc.returncode}):\n{stdout[-3000:]}\n"
        f"{stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    procs = {pkg: _spawn(PROGRAM, pkg) for pkg in ("ray_tpu",
                                                   "ray_tpu_torch")}
    try:
        return {pkg: _result(p, pkg) for pkg, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


def _gpu_names(keys):
    """The reference's worker-row keys in the port's names."""
    return sorted(k.replace("tpu", "gpu") for k in keys)


def test_dashboard_routes_and_keys(runs):
    ref, port = runs["ray_tpu"]["routes"], runs["ray_tpu_torch"]["routes"]
    ref["/api/workers"][2] = _gpu_names(ref["/api/workers"][2])
    port_workers = port["/api/workers"][2]
    port_workers.remove("gpu_ids")
    assert port == ref
    assert all(port[r][:2] == [200, True] for r in port
               if r.startswith("/api/") and r != "/api/timeline")
    assert port["/api/timeline"] == [200, True, True]
    assert port["/metrics"] == [200, True]
    assert port["/"] == [200, True, True]
    assert port["/nope"] == 404
    assert "resources_total" in port["/api/cluster"][2]


def test_cli_reads_the_dashboard(runs):
    ref, port = runs["ray_tpu"]["cli"], runs["ray_tpu_torch"]["cli"]
    assert port[5] == ["worker_id", "pid", "state", "actor_id"]
    assert ref[:5] == port[:5] == [1, True, True, True, True]
    assert ref[6] is port[6] is True


def test_memory_summary(runs):
    ref = runs["ray_tpu"]["memory_summary"]
    port = runs["ray_tpu_torch"]["memory_summary"]
    assert port == ref
    assert port[1:] == [True] * 5


@pytest.mark.parametrize("case,want", [
    ("submit", ["SUCCEEDED", True, {"who": "test"}, True]),
    ("raw_and_unknown", [400, "ValueError"]),
    ("follow", [True, "SUCCEEDED"]),
    ("stop", [True, "STOPPED"]),
    ("cli", [0, True, "SUCCEEDED", True, True])])
def test_job_verbs_over_http(runs, case, want):
    assert runs["ray_tpu_torch"]["jobs"][case] == \
        runs["ray_tpu"]["jobs"][case] == want


def test_serve_run_serves_until_sigint(tmp_path):
    """`python -m <pkg> serve run myapp:app` under both packages at once:
    the reply over HTTP, `serve status` through the port's
    `--dashboard-port`, and after SIGINT the process exits 0 and leaves
    no worker."""
    procs = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        app_dir = tmp_path / pkg
        app_dir.mkdir()
        (app_dir / "myapp.py").write_text(APP.format(pkg=pkg))
        procs[pkg] = _spawn(SERVE_RUN, pkg, str(app_dir))
    try:
        got = {pkg: _result(p, f"serve run ({pkg})")
               for pkg, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    status = got["ray_tpu_torch"].pop("serve_status")
    assert got["ray_tpu_torch"] == got["ray_tpu"] == {
        "banner": True, "reply": {"hello": 7}, "workers": True, "exit": 0,
        "left": 0}
    assert status == [0, True, ["default"]]


def _lint(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", "lint",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


def test_lint_applies_raylint_to_the_port():
    """`python -m ray_tpu_torch lint` exits 0 on the port, having applied
    the checks: every suppression comment the port carries silences a
    finding (an unused one would be an RT000 finding)."""
    res = _lint("--", "-o", "json")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    report = json.loads(res.stdout)
    n_files = sum(name.endswith(".py") for _, _, files in
                  os.walk(os.path.join(REPO, "ray_tpu_torch"))
                  for name in files)
    assert report["files_scanned"] == n_files
    assert report["counts"]["active"] == 0
    assert report["counts"]["suppressed"] > 0
    suppressed = {f["code"] for f in report["findings"] if f["suppressed"]}
    assert {"RT001", "RT003"} <= suppressed
    assert all(f["path"].startswith("ray_tpu_torch/")
               for f in report["findings"])


FAULTY = '''import os
import threading
import time

_lock = threading.Lock()


def slow():
    with _lock:
        time.sleep(1.0)


def knob():
    return os.environ.get("RAY_TPU_NOT_A_KNOB")
'''


def test_lint_reports_a_seeded_fault(tmp_path):
    """A copy of the package's registries and catalogs with a faulty
    core module: blocking under a lock (RT001) and a bare read of an
    undeclared knob (RT005) are reported under the copy's path."""
    src = os.path.join(REPO, "ray_tpu_torch")
    pkg = tmp_path / "ray_tpu_torch"
    for rel in ("__init__.py", "util/__init__.py", "util/knobs.py",
                "util/events_catalog.py", "util/metrics_catalog.py",
                "core/__init__.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(src, rel), pkg / rel)
    (pkg / "core" / "faulty.py").write_text(FAULTY)
    res = _lint(str(pkg))
    assert res.returncode == 1, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("ray_tpu_torch/core/faulty.py:")]
    assert [ln.split()[1] for ln in lines] == ["RT001", "RT005"]
    assert "2 findings" in res.stdout

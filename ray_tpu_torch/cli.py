"""`python -m ray_tpu_torch` — cluster state CLI (counterpart of
ray_tpu/cli.py; `lint` checks this package, `node` joins a host as the
port's node agent).

Reference counterpart: the `ray` CLI (`ray status`, `ray summary
tasks|actors|objects`, `ray list actors|tasks|...`, `ray timeline`,
`ray job submit|status|logs`). Single-controller twist: there is no
long-lived head node to dial into from a cold process, so state
subcommands attach to a live driver via its dashboard URL (--address),
while `job` runs locally.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request


def _open(address: str, route: str) -> bytes:
    url = address.rstrip("/") + route
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.read()
    except urllib.error.HTTPError as e:       # dashboard is up: show body
        body = e.read().decode(errors="replace")
        sys.stderr.write(f"error: {url} -> HTTP {e.code}: {body}\n")
        sys.exit(2)
    except (urllib.error.URLError, OSError) as e:
        sys.stderr.write(
            f"error: cannot reach dashboard at {address} ({e}).\n"
            "Start one in the driver with "
            "ray_tpu_torch.observability.start_dashboard(port=8265) and pass "
            "--address.\n")
        sys.exit(2)


def _fetch(address: str, route: str):
    return json.loads(_open(address, route))


def _print_table(rows, columns):
    if not rows:
        print("(empty)")
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    print("  ".join(c.ljust(widths[c]) for c in columns))
    print("  ".join("-" * widths[c] for c in columns))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c])
                        for c in columns))


def cmd_status(args):
    s = _fetch(args.address, "/api/cluster")
    print(json.dumps(s, indent=2))


def cmd_persistence(args):
    """Control-plane persistence health: driver incarnation, WAL
    length/bytes, last-snapshot age, replayed records after a resume."""
    s = _fetch(args.address, "/api/persistence")
    if args.json:
        print(json.dumps(s, indent=2))
        return
    if not s.get("enabled"):
        print("persistence: disabled (set RAY_TPU_STATE_DIR or "
              "init(state_dir=...) to make driver state durable)")
        print(f"driver incarnation: {s.get('driver_incarnation', 0)}")
        return
    print(f"state dir:           {s.get('state_dir')}")
    print(f"driver incarnation:  {s.get('driver_incarnation')}"
          + ("  (resumed)" if s.get("resumed") else ""))
    print(f"WAL records:         {s.get('wal_records')}"
          f"  ({s.get('wal_bytes')} bytes since last snapshot)")
    print(f"snapshots taken:     {s.get('snapshots_taken')}"
          f"  (last {s.get('last_snapshot_age_s')}s ago)")
    print(f"replayed on resume:  {s.get('replayed_records')}"
          + ("  [torn WAL tail truncated]"
             if s.get("torn_tail_recovered") else ""))
    if s.get("reattach_awaiting_objects"):
        print(f"awaiting reattach:   "
              f"{s['reattach_awaiting_objects']} objects parked for "
              "restored nodes")


def cmd_dispatch(args):
    """Batched-dispatch plane health: submit batch sizes, worker-lease
    grants/revokes, direct actor calls, control messages per direction
    (docs/SCHEDULING.md)."""
    s = _fetch(args.address, "/api/dispatch")
    if args.json:
        print(json.dumps(s, indent=2))
        return
    if not s.get("enabled"):
        print("dispatch stats unavailable on this runtime")
        return
    print(f"batching:            "
          f"{'on' if s.get('batching_enabled') else 'OFF (RAY_TPU_BATCH=0)'}"
          f"  (flush {s.get('flush_max_tasks')} tasks / "
          f"{s.get('flush_window_s')}s window)")
    print(f"binary wire:         "
          f"{'on' if s.get('binary_wire_enabled') else 'OFF'}")
    print(f"submit batches:      {s.get('submit_batches')}"
          f"  ({s.get('batched_submits')} tasks, avg "
          f"{s.get('avg_submit_batch')})")
    print(f"explicit submit_many:{s.get('submit_many_calls')}")
    print(f"leases:              {s.get('lease_grants')} granted / "
          f"{s.get('lease_revokes')} revoked "
          f"(cap {s.get('lease_slots')} slots; actor pipeline "
          f"{s.get('actor_pipeline')})")
    print(f"dispatch frames:     {s.get('dispatch_frames')}"
          f"  ({s.get('dispatched_tasks')} tasks)")
    if s.get("node_leases_enabled"):
        print(f"node leases:         {s.get('node_lease_grants')} "
              f"granted / {s.get('node_lease_extends')} extended / "
              f"{s.get('node_leases_open')} open "
              f"(cap {s.get('node_lease_slots')} slots/worker; "
              f"{s.get('node_lease_tasks')} tasks agent-dispatched)")
        print(f"spillbacks:          {s.get('spillbacks')}")
    else:
        print("node leases:         OFF (RAY_TPU_NODE_LEASES=0)")
    print(f"direct actor calls:  {s.get('direct_actor_calls', 0)}"
          f"  ({s.get('direct_call_fallbacks', 0)} fell back to the "
          f"driver path)")
    print(f"inbound ctrl frames: {s.get('ctrl_frames_in')}")
    msgs = s.get("ctrl_msgs_in") or {}
    top = sorted(msgs.items(), key=lambda kv: -kv[1])[:8]
    if top:
        print("inbound ctrl msgs:   "
              + ", ".join(f"{k}={v}" for k, v in top))


# The static-analysis checks scope themselves by package-anchored paths
# under `ray_tpu/` (each check's `applies(rel)`). The port's files go to
# the engine under that anchor and are reported under their own paths.
_LINT_ANCHOR = "ray_tpu/"


def _raylint():
    """tools.raylint's engine and checks, from the checkout that holds
    this package when tools/ is not importable from the working
    directory."""
    try:
        from tools.raylint import checks, engine
    except ImportError:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path.insert(0, repo)
        try:
            from tools.raylint import checks, engine
        except ImportError:
            sys.stderr.write(
                "error: raylint needs the repo checkout (tools/raylint "
                "is not shipped in the installed package)\n")
            sys.exit(2)
    return checks, engine


def _package_rel(path) -> tuple:
    """(package root, path relative to the root's parent) of a source
    file: the climb out of its __init__.py chain that raylint's engine
    makes for its own paths."""
    from pathlib import Path
    path = Path(path).resolve()
    root = path.parent
    while (root.parent / "__init__.py").is_file():
        root = root.parent
    if not (root / "__init__.py").is_file():
        return None, path.name
    return root, path.relative_to(root.parent).as_posix()


def lint(paths=None, *, select=None, disable=None):
    """raylint's checks over the port's sources (default: this package).
    Every file must lie in one `ray_tpu_torch` package tree (this one or
    a copy of it): the checks see it as `ray_tpu/<rest>`, and the knob
    and telemetry checks read that tree's util/knobs.py registry and
    catalogs. Returns raylint's Report, with the files' own paths."""
    from pathlib import Path
    checks_mod, engine = _raylint()
    checks = checks_mod.select_checks(select, disable)
    pkg = os.path.dirname(os.path.abspath(__file__))
    root, units, shown, errors = None, [], {}, []
    for f in engine.iter_py_files([Path(p) for p in (paths or [pkg])]):
        froot, rel = _package_rel(f)
        head, _, rest = rel.partition("/")
        if froot is None or head != "ray_tpu_torch" \
                or root not in (None, froot):
            raise ValueError(f"{f}: not a file of the ray_tpu_torch tree "
                             f"being linted")
        root = froot
        shown[_LINT_ANCHOR + rest] = rel
        try:
            units.append(engine.FileUnit(_LINT_ANCHOR + rest, f.read_text()))
        except SyntaxError as e:
            errors.append(f"{rel}: {e}")
    report = engine.run_units(units, checks, engine.Project(package_dir=root))
    for finding in report.findings:
        finding.path = shown[finding.path]
    report.parse_errors = errors
    return report


def cmd_lint(args):
    """Run the raylint static-analysis gate (tools/raylint) over the
    port: the concurrency/invariant checks RT001-RT005, exiting non-zero
    on any unsuppressed finding (docs/STATIC_ANALYSIS.md). Runs locally
    against source — no driver needed. raylint's checks apply to paths
    under `ray_tpu/`; `lint` hands them the port's files under that
    anchor (see `lint()`), so every check runs on the port."""
    import time as _time
    argv = list(args.raylint_args or [])
    if argv and argv[0] == "--":   # `ray_tpu_torch lint -- -o json`
        argv = argv[1:]
    ap = argparse.ArgumentParser(
        prog="ray_tpu_torch lint",
        description="raylint's checks over ray_tpu_torch sources")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories of a ray_tpu_torch tree "
                         "(default: this package)")
    ap.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    ap.add_argument("--select", default=None,
                    help="comma list of check codes to run")
    ap.add_argument("--disable", default=None,
                    help="comma list of check codes to skip")
    ap.add_argument("--show-suppressed", action="store_true")
    la = ap.parse_args(argv)
    missing = [p for p in la.paths or () if not os.path.exists(p)]
    if missing:
        sys.stderr.write(f"error: no such path(s): {missing}\n")
        sys.exit(2)
    t0 = _time.monotonic()
    try:
        report = lint(la.paths or None,
                      select=la.select.split(",") if la.select else None,
                      disable=la.disable.split(",") if la.disable else None)
    except (KeyError, ValueError) as e:
        sys.stderr.write(f"error: {e}\n")
        sys.exit(2)
    report.duration_s = _time.monotonic() - t0
    failed = bool(report.active or report.parse_errors)
    if la.output == "json":
        print(json.dumps(report.to_dict(), indent=2))
        sys.exit(1 if failed else 0)
    for f in report.active:
        print(f.render())
    if la.show_suppressed:
        for f in report.suppressed:
            print(f"[suppressed: {f.suppress_reason}] {f.render()}")
    for err in report.parse_errors:
        print(f"parse error: {err}")
    n = len(report.active)
    print(f"raylint: {report.files_scanned} files, {n} finding"
          f"{'s' if n != 1 else ''} ({len(report.suppressed)} suppressed) "
          f"in {report.duration_s:.2f}s")
    sys.exit(1 if failed else 0)


def cmd_list(args):
    route = {"actors": "/api/actors", "tasks": "/api/tasks",
             "objects": "/api/objects", "nodes": "/api/nodes",
             "workers": "/api/workers",
             "placement-groups": "/api/placement_groups"}[args.kind]
    data = _fetch(args.address, route + f"?limit={args.limit}")
    if args.kind == "objects":
        data = data["objects"]
    if args.json:
        print(json.dumps(data, indent=2))
        return
    cols = {
        "actors": ["actor_id", "class_name", "state", "name", "worker_id"],
        "tasks": ["task_id", "name", "state", "worker_id", "duration_s"],
        "objects": ["object_id", "state", "size_bytes", "store_kind"],
        "nodes": ["node_id", "hostname", "alive"],
        "workers": ["worker_id", "pid", "state", "actor_id", "gpu_ids"],
        "placement-groups": ["placement_group_id", "name", "strategy",
                             "state"],
    }[args.kind]
    _print_table(data, cols)


def cmd_summary(args):
    print(json.dumps(_fetch(args.address, f"/api/summary/{args.kind}"),
                     indent=2))


def cmd_timeline(args):
    events = _fetch(args.address, "/api/timeline")
    with open(args.output, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {args.output} "
          "(load in chrome://tracing or Perfetto)")


def _parse_prometheus(text: str):
    """Parse a Prometheus text exposition into
    (meta {name: (kind, help)}, samples [(name, {label: val}, value)]).
    Histogram _bucket/_sum/_count samples keep their suffixed names."""
    import re
    meta = {}
    samples = []
    line_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$')
    label_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            kind = meta.get(name, ("untyped", ""))[0]
            meta[name] = (kind, help_)
        elif line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            help_ = meta.get(name, ("", ""))[1]
            meta[name] = (kind.strip(), help_)
        elif not line.startswith("#"):
            m = line_re.match(line)
            if not m:
                continue
            labels = {k: v for k, v in
                      label_re.findall(m.group(3) or "")}
            try:
                value = float(m.group(4))
            except ValueError:
                continue
            samples.append((m.group(1), labels, value))
    return meta, samples


def _format_metrics(text: str, needle: str = "") -> str:
    """Pretty-print a merged exposition grouped by metric: counters and
    gauges one line per series; histograms as count/sum/mean."""
    meta, samples = _parse_prometheus(text)
    by_base = {}
    for name, labels, value in samples:
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in meta \
                    and meta[name[:-len(suffix)]][0] == "histogram":
                base = name[:-len(suffix)]
                break
        by_base.setdefault(base, []).append((name, labels, value))
    out = []
    for base in sorted(by_base):
        if needle and needle not in base:
            continue
        kind, help_ = meta.get(base, ("untyped", ""))
        out.append(f"{base} ({kind})" + (f" — {help_}" if help_ else ""))
        rows = by_base[base]
        if kind == "histogram":
            # one row per tag set: count / sum / mean
            hist = {}
            for name, labels, value in rows:
                key = tuple(sorted((k, v) for k, v in labels.items()
                                   if k != "le"))
                ent = hist.setdefault(key, {"count": 0.0, "sum": 0.0})
                if name.endswith("_count"):
                    ent["count"] = value
                elif name.endswith("_sum"):
                    ent["sum"] = value
            for key in sorted(hist):
                ent = hist[key]
                tags = ",".join(f'{k}="{v}"' for k, v in key)
                mean = (ent["sum"] / ent["count"]) if ent["count"] else 0
                out.append(f"  {{{tags}}}  count={ent['count']:g} "
                           f"sum={ent['sum']:.6g} mean={mean:.6g}")
        else:
            for name, labels, value in sorted(
                    rows, key=lambda r: sorted(r[1].items())):
                tags = ",".join(f'{k}="{v}"'
                                for k, v in sorted(labels.items()))
                out.append(f"  {{{tags}}}  {value:g}")
        out.append("")
    return "\n".join(out)


def cmd_metrics(args):
    text = _open(args.address, "/metrics").decode()
    if args.raw:
        sys.stdout.write(text)
        return
    sys.stdout.write(_format_metrics(text, needle=args.grep or ""))


def _events_query(args, since: int = 0) -> str:
    from urllib.parse import urlencode
    params = [("limit", args.limit)]
    if since:
        params.append(("since", since))
    for key, flag in (("task_id", "task"), ("actor_id", "actor"),
                      ("object_id", "object"), ("node_id", "node"),
                      ("worker_id", "worker")):
        v = getattr(args, flag, None)
        if v:
            params.append((key, v))
    for t in args.type or ():
        params.append(("type", t))
    for s in args.severity or ():
        params.append(("severity", s))
    return "/api/events?" + urlencode(params)


def _print_events(rows) -> None:
    import datetime
    for ev in rows:
        ts = datetime.datetime.fromtimestamp(
            ev.get("ts", 0)).strftime("%H:%M:%S.%f")[:-3]
        ids = " ".join(
            f"{k}={ev[k]}" for k in ("task_id", "actor_id", "object_id",
                                     "node_id", "worker_id")
            if ev.get(k))
        msg = ev.get("message") or ""
        line = (f"{ev.get('seq', '?'):>6} {ts} "
                f"{ev.get('severity', 'info'):<7} "
                f"{ev.get('type', '?'):<26} {ids}")
        print(line + (f"  | {msg}" if msg else ""))


def cmd_events(args):
    """`ray_tpu_torch events` — cluster lifecycle event log, filterable by
    id/type/severity; --follow tails new events; -o exports JSONL."""
    data = _fetch(args.address, _events_query(args))
    rows = data["events"]
    if args.output:
        with open(args.output, "w") as f:
            for ev in rows:
                f.write(json.dumps(ev, default=str) + "\n")
        print(f"wrote {len(rows)} events to {args.output}"
              + (f" (truncated; {data['total']} matched)"
                 if data.get("truncated") else ""))
        return
    if args.json:
        print(json.dumps(data, indent=2, default=str))
        return
    _print_events(rows)
    if data.get("truncated"):
        print(f"... truncated: showing {len(rows)} of {data['total']} "
              f"matching events (raise --limit)")
    if not args.follow:
        return
    last = max((ev.get("seq", 0) for ev in rows), default=0)
    try:
        while True:
            time.sleep(args.interval)
            data = _fetch(args.address, _events_query(args, since=last))
            fresh = data["events"]
            if fresh:
                if data.get("truncated"):
                    # a burst bigger than --limit landed between polls:
                    # the server kept only the newest window — say so
                    # instead of silently skipping the gap
                    print(f"... gap: {data['total'] - len(fresh)} "
                          f"events since seq {last} not shown "
                          f"(raise --limit)")
                _print_events(fresh)
                last = max(ev.get("seq", last) for ev in fresh)
    except KeyboardInterrupt:
        return


def cmd_post_mortem(args):
    """`ray_tpu_torch post-mortem <task_id|actor_id>` — assemble the failure
    bundle (event chain + span subtree + tagged log tail + metrics
    snapshot) from the live driver and write one JSON artifact."""
    from urllib.parse import urlencode
    bundle = _fetch(args.address,
                    "/api/post_mortem?" + urlencode({"id": args.id}))
    out = args.output or f"post-mortem-{args.id}.json"
    with open(out, "w") as f:
        json.dump(bundle, f, indent=1, default=str)
    subj = bundle.get("subject", {})
    logs = bundle.get("log_tail", {}) or {}
    print(f"wrote {out}: kind={subj.get('kind')} "
          f"events={len(bundle.get('events', []))} "
          f"spans={len(bundle.get('spans', []))} "
          f"log_lines={len(logs.get('lines', []))}")
    if subj.get("kind") == "task":
        t = subj["task"]
        print(f"  task {t['name']} state={t['state']} "
              f"worker={t['worker_id']}")
    elif subj.get("kind") == "actor":
        a = subj["actor"]
        print(f"  actor {a['class_name']} state={a['state']} "
              f"death_cause={a['death_cause'] or '-'}")


def _post(address: str, route: str, payload: dict):
    url = address.rstrip("/") + route
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        sys.stderr.write(f"error: {url} -> HTTP {e.code}: {body}\n")
        sys.exit(2)
    except (urllib.error.URLError, OSError) as e:
        sys.stderr.write(
            f"error: cannot reach dashboard at {address} ({e})\n")
        sys.exit(2)


def _collapsed_from_payload(payload: dict) -> str:
    """Worker snapshot payload -> collapsed-stack text (same format as
    the driver store's aggregate export)."""
    merged = {}
    for task, stack, n in payload.get("samples") or ():
        line = f"task:{task};{stack}" if task else stack
        merged[line] = merged.get(line, 0) + n
    return "\n".join(f"{s} {n}" for s, n in
                     sorted(merged.items(), key=lambda kv: -kv[1]))


def cmd_profile(args):
    """`ray_tpu_torch profile` — the always-on sampling profiler
    (docs/OBSERVABILITY.md). `show` (default) exports the driver-side
    aggregate; start/stop/snapshot/status drive one worker's sampler
    live over the control plane."""
    action = args.action
    if action in ("start", "stop", "snapshot", "status"):
        if not args.worker:
            sys.stderr.write(f"error: profile {action} needs "
                             "--worker <worker id>\n")
            sys.exit(2)
        payload = {"worker": args.worker, "action": action}
        if action == "start":
            payload["hz"] = args.hz
        reply = _post(args.address, "/api/profile", payload)
        if action == "snapshot" and args.format == "collapsed":
            text = _collapsed_from_payload(reply)
            if args.output:
                with open(args.output, "w") as f:
                    f.write(text + "\n")
                print(f"wrote {args.output}")
            else:
                print(text)
            return
        print(json.dumps(reply, indent=2))
        return
    # show: driver-side aggregate, collapsed / speedscope / summary
    from urllib.parse import urlencode
    params = {"format": args.format}
    if args.worker:
        params["worker"] = args.worker
    if args.task:
        params["task"] = args.task
    route = "/api/profile?" + urlencode(params)
    if args.format == "collapsed":
        text = _open(args.address, route).decode()
        if args.output:
            with open(args.output, "w") as f:
                f.write(text + "\n")
            print(f"wrote {args.output} (flamegraph.pl or paste into "
                  "speedscope.app)")
        else:
            print(text)
        return
    data = _fetch(args.address, route)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(data, f)
        print(f"wrote {args.output}"
              + (" (open at https://www.speedscope.app)"
                 if args.format == "speedscope" else ""))
    else:
        print(json.dumps(data, indent=2))


def cmd_stuck(args):
    """`ray_tpu_torch stuck [id]` — why is the cluster (or one task/actor/
    worker) not making progress: detected deadlock cycles first, then
    every wait chain with its resolved root cause, oldest first."""
    from urllib.parse import urlencode
    graph = _fetch(args.address, "/api/waitgraph")
    params = {"min_age": args.min_age}
    if args.id:
        params["id"] = args.id
    waits = _fetch(args.address,
                   "/api/waits?" + urlencode(params)).get("waits", [])
    if args.json:
        print(json.dumps({"waitgraph": graph, "waits": waits},
                         indent=2, default=str))
        return
    cycles = graph.get("cycles") or []
    probe = graph.get("last_probe") or {}
    if cycles:
        print(f"DEADLOCK: {len(cycles)} waits-on cycle(s) detected")
        labels = {n.get("key"): n for n in graph.get("nodes", [])}
        for cyc in cycles:
            print("  cycle:")
            for k in cyc:
                n = labels.get(k, {})
                extra = ", ".join(str(n[f]) for f in
                                  ("name", "state", "worker_id")
                                  if n.get(f))
                print(f"    {k}" + (f"  ({extra})" if extra else ""))
            edges = [e for e in graph.get("edges", [])
                     if e["src"] in cyc and e["dst"] in cyc]
            for e in edges:
                print(f"      {e['src']} -[{e['why']}]-> {e['dst']}")
    for s in probe.get("stragglers") or []:
        print(f"STRAGGLER: group {s.get('group')!r} seq "
              f"{s.get('seq')} stuck {s.get('stuck_s')}s — missing "
              f"ranks {s.get('missing_ranks')}, behind "
              f"{s.get('behind_ranks')}")
    if not waits:
        if not cycles and not probe.get("stragglers"):
            print("nothing is stuck: no wait records"
                  + (f" touching {args.id!r}" if args.id else ""))
        return
    print(f"{len(waits)} wait(s)"
          + (f" touching {args.id!r}" if args.id else "") + ":")
    for w in waits:
        who = w.get("waiter") or w.get("worker_id")
        print(f"  [{w['age_s']:>7.1f}s] {who} on "
              f"{w['kind']}:{w['rid']}")
        print(f"            {w['root_cause']}")


def cmd_stack(args):
    """`ray_tpu_torch stack` — one-shot stack dump of every live worker (the
    in-process `py-spy dump` across the cluster, with task
    attribution), riding the profile_ctl control plane."""
    workers = _fetch(args.address, "/api/workers")
    wids = [w["worker_id"] for w in workers
            if w.get("state") not in ("dead",)]
    if args.worker:
        wids = [w for w in wids if w == args.worker]
    dumps = []
    for wid in wids:
        try:
            dumps.append(_post(args.address, "/api/profile",
                               {"worker": wid, "action": "stack"}))
        except SystemExit:
            # a worker that died mid-iteration is a skip, not an abort
            dumps.append({"worker_id": wid,
                          "error": "unreachable"})
    if args.format == "speedscope":
        # each thread's current stack becomes one weight-1 sample
        frames, fidx, samples = [], {}, []
        for d in dumps:
            for t in d.get("threads") or ():
                parts = [f"worker:{d.get('worker_id')}",
                         f"thread:{t.get('name')}"]
                if t.get("task_id"):
                    parts.append(f"task:{t['task_id']}")
                parts.extend(p for p in (t.get("stack") or "")
                             .split(";") if p)
                row = []
                for p in parts:
                    if p not in fidx:
                        fidx[p] = len(frames)
                        frames.append({"name": p})
                    row.append(fidx[p])
                samples.append(row)
        out = {"$schema":
               "https://www.speedscope.app/file-format-schema.json",
               "name": "ray_tpu_torch stack",
               "shared": {"frames": frames},
               "profiles": [{"type": "sampled",
                             "name": "ray_tpu_torch stack", "unit": "none",
                             "startValue": 0,
                             "endValue": len(samples),
                             "samples": samples,
                             "weights": [1] * len(samples)}]}
        text = json.dumps(out)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
            print(f"wrote {args.output} "
                  "(open at https://www.speedscope.app)")
        else:
            print(text)
        return
    for d in dumps:
        wid = d.get("worker_id", "?")
        if d.get("error"):
            print(f"== {wid}: {d['error']}")
            continue
        print(f"== {wid} ({len(d.get('threads') or [])} threads)")
        for t in d.get("threads") or ():
            task = f"  [task {t['task_id']}]" if t.get("task_id") else ""
            print(f"  -- {t.get('name')}{task}")
            for fr in (t.get("stack") or "").split(";"):
                if fr:
                    print(f"       {fr}")


def cmd_job(args):
    from .core.jobs import JobSubmissionClient
    # submit runs the entrypoint as a local child unless --remote sends
    # it to the --address dashboard's /api/jobs (reference: ray job CLI
    # -> dashboard job head). The query verbs (status/logs/stop/list)
    # ALWAYS go over HTTP: a fresh CLI process has no local job table,
    # so local mode could never find anything.
    remote = (args.job_cmd != "submit"
              or getattr(args, "remote", False))
    client = JobSubmissionClient(address=args.address if remote else None)
    if args.job_cmd == "submit":
        entry = list(args.entrypoint)
        if entry and entry[0] == "--":       # `job submit -- cmd ...`
            entry = entry[1:]
        if not entry:
            sys.stderr.write("error: job submit needs an entrypoint, e.g. "
                             "`ray_tpu_torch job submit -- python x.py`\n")
            sys.exit(2)
        sid = client.submit_job(entrypoint=" ".join(entry))
        if args.no_wait:
            print(sid)
            return
        try:
            status = client.wait_until_finished(sid, timeout=args.timeout)
        except TimeoutError:
            client.stop_job(sid)             # don't orphan the subprocess
            print(client.get_job_logs(sid), end="")
            print(f"job {sid}: TIMEOUT after {args.timeout}s (stopped)")
            sys.exit(1)
        print(client.get_job_logs(sid), end="")
        print(f"job {sid}: {status}")
        sys.exit(0 if status == "SUCCEEDED" else 1)
    elif args.job_cmd == "list":
        try:
            _print_table(client.list_jobs(),
                         ["submission_id", "status", "entrypoint"])
        except ValueError as e:
            sys.stderr.write(f"error: {e}\n")
            sys.exit(1)
        except OSError as e:
            sys.stderr.write(f"error: cannot reach dashboard at "
                             f"{args.address}: {e}\n")
            sys.exit(1)
    else:
        try:
            if args.job_cmd == "status":
                print(client.get_job_status(args.submission_id))
            elif args.job_cmd == "logs":
                if args.follow:
                    for piece in client.tail_job_logs(
                            args.submission_id):
                        sys.stdout.write(piece)
                        sys.stdout.flush()
                else:
                    sys.stdout.write(
                        client.get_job_logs(args.submission_id))
            elif args.job_cmd == "stop":
                stopped = client.stop_job(args.submission_id)
                print(f"job {args.submission_id}: "
                      f"{'stopped' if stopped else 'already finished'}")
        except ValueError as e:
            sys.stderr.write(f"error: {e}\n")
            sys.exit(1)
        except OSError as e:
            sys.stderr.write(f"error: cannot reach dashboard at "
                             f"{args.address}: {e}\n")
            sys.exit(1)


def cmd_serve(args):
    """`ray_tpu_torch serve run module:app` — import an Application and
    serve it, blocking (reference: `serve run` CLI). `serve status` reads
    the live driver's dashboard (--address; `serve run --dashboard-port`
    starts one in the serving driver); there is no remote shutdown —
    Ctrl-C the `serve run` process (SIGTERM ends it at once: its workers
    watch its socket and exit)."""
    import importlib

    import ray_tpu_torch
    from ray_tpu_torch import serve as serve_mod

    if args.serve_cmd == "run":
        if ":" not in args.target:
            sys.stderr.write("error: target must be module:attribute, "
                             "e.g. myapp:app\n")
            sys.exit(2)
        mod_name, attr = args.target.split(":", 1)
        sys.path.insert(0, os.getcwd())
        app = getattr(importlib.import_module(mod_name), attr)
        ray_tpu_torch.init()
        kwargs = {}
        if args.route_prefix is not None:
            kwargs["route_prefix"] = args.route_prefix
        serve_mod.run(app, name=args.name, **kwargs)
        from .serve.http_proxy import start_proxy
        _proxy, port = start_proxy(host=args.host, port=args.port)
        print(f"serving {args.target} on http://{args.host}:{port}",
              flush=True)
        if args.dashboard_port is not None:
            # this process is the driver: `serve status --address` and
            # the other state verbs read it through this dashboard
            from .observability.dashboard import start_dashboard
            dash = start_dashboard(host=args.host, port=args.dashboard_port)
            print(f"dashboard at {dash.url}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            serve_mod.shutdown()
        return
    if args.serve_cmd == "status":
        # read-only: attach to the LIVE driver via its dashboard (an
        # in-process runtime would report an empty fresh cluster)
        print(json.dumps(_fetch(args.address, "/api/serve"), indent=2))
        return
    if args.serve_cmd == "router":
        # scale-out router table: ring membership, registered prefixes
        # + owners, recent sticky session bindings
        print(json.dumps(_fetch(args.address, "/api/serve/router"),
                         indent=2))
        return
    if args.serve_cmd == "autoscaler":
        # autoscaler targets + the recent scale_up/scale_down decisions
        print(json.dumps(_fetch(args.address, "/api/serve/autoscaler"),
                         indent=2))
        return


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch cluster state CLI")
    p.add_argument("--address", default="http://127.0.0.1:8265",
                   help="dashboard URL of a live driver "
                        "(start one with ray_tpu_torch.observability."
                        "start_dashboard(port=8265))")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("status", help="cluster summary").set_defaults(
        fn=cmd_status)

    pp = sub.add_parser(
        "persistence",
        help="control-plane WAL/snapshot health (driver incarnation, "
             "WAL length, last-snapshot age, resume replay count)")
    pp.add_argument("--json", action="store_true")
    pp.set_defaults(fn=cmd_persistence)

    dpp = sub.add_parser(
        "dispatch",
        help="batched-dispatch plane health (submit batches, worker "
             "leases, direct actor calls, control-message counts)")
    dpp.add_argument("--json", action="store_true")
    dpp.set_defaults(fn=cmd_dispatch)

    ltp = sub.add_parser(
        "lint",
        help="raylint static-analysis gate (RT001-RT005 over "
             "ray_tpu_torch/; docs/STATIC_ANALYSIS.md); extra args pass "
             "through, e.g. `ray_tpu_torch lint -- -o json`")
    ltp.add_argument("raylint_args", nargs=argparse.REMAINDER,
                     help="paths and raylint options (-o, --select, "
                          "--disable, --show-suppressed)")
    ltp.set_defaults(fn=cmd_lint)

    lp = sub.add_parser("list", help="list cluster entities")
    lp.add_argument("kind", choices=["actors", "tasks", "objects", "nodes",
                                     "workers", "placement-groups"])
    lp.add_argument("--limit", type=int, default=100)
    lp.add_argument("--json", action="store_true")
    lp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="rollups by name/state")
    sp.add_argument("kind", choices=["tasks", "actors", "objects"])
    sp.set_defaults(fn=cmd_summary)

    tp = sub.add_parser("timeline", help="export chrome-trace JSON")
    tp.add_argument("-o", "--output", default="timeline.json")
    tp.set_defaults(fn=cmd_timeline)

    ep = sub.add_parser(
        "events", help="cluster lifecycle event log (filter by "
                       "id/type/severity; --follow tails)")
    ep.add_argument("--task", help="filter: events referencing task id")
    ep.add_argument("--actor", help="filter: events referencing actor id")
    ep.add_argument("--object",
                    help="filter: events referencing object id")
    ep.add_argument("--node", help="filter: events referencing node id")
    ep.add_argument("--worker",
                    help="filter: events referencing worker id")
    ep.add_argument("--type", action="append",
                    help="filter: event type (repeatable), e.g. "
                         "task.retry")
    ep.add_argument("--severity", action="append",
                    choices=["info", "warning", "error"],
                    help="filter: severity (repeatable)")
    ep.add_argument("--limit", type=int, default=100)
    ep.add_argument("--json", action="store_true")
    ep.add_argument("--follow", action="store_true",
                    help="keep polling for new events (Ctrl-C stops)")
    ep.add_argument("--interval", type=float, default=1.0,
                    help="--follow poll interval seconds")
    ep.add_argument("-o", "--output", default=None,
                    help="export matching events as JSONL")
    ep.set_defaults(fn=cmd_events)

    pmp = sub.add_parser(
        "post-mortem", help="assemble a failure bundle for a task or "
                            "actor id (events + spans + tagged logs + "
                            "metrics)")
    pmp.add_argument("id", help="task_id (tsk-...) or actor_id (act-...)")
    pmp.add_argument("-o", "--output", default=None,
                     help="bundle path (default post-mortem-<id>.json)")
    pmp.set_defaults(fn=cmd_post_mortem)

    mp = sub.add_parser(
        "metrics", help="merged cluster metrics (pretty-printed; "
                        "--raw for the Prometheus text)")
    mp.add_argument("--raw", action="store_true",
                    help="dump the raw Prometheus exposition")
    mp.add_argument("--grep", default="",
                    help="only show metrics whose name contains this")
    mp.set_defaults(fn=cmd_metrics)

    prp = sub.add_parser(
        "profile", help="sampling profiler: export the cluster "
                        "aggregate or start/stop/snapshot one worker's "
                        "sampler live")
    prp.add_argument("action", nargs="?", default="show",
                     choices=["show", "start", "stop", "snapshot",
                              "status"])
    prp.add_argument("--worker", default=None,
                     help="worker id (required for start/stop/"
                          "snapshot/status; filters `show`)")
    prp.add_argument("--task", default=None,
                     help="filter `show` to one task id")
    prp.add_argument("--hz", type=float, default=100.0,
                     help="sampling rate for `start` (default 100)")
    prp.add_argument("--format", default="collapsed",
                     choices=["collapsed", "speedscope", "summary"],
                     help="`show`/`snapshot` output format")
    prp.add_argument("-o", "--output", default=None)
    prp.set_defaults(fn=cmd_profile)

    stp = sub.add_parser(
        "stuck", help="why is it stuck: deadlock cycles, stragglers, "
                      "and every wait chain with its root cause")
    stp.add_argument("id", nargs="?", default=None,
                     help="restrict to chains touching this task/"
                          "actor/worker/object id (prefix ok)")
    stp.add_argument("--min-age", type=float, default=0.0,
                     help="hide waits younger than this many seconds")
    stp.add_argument("--json", action="store_true",
                     help="raw waitgraph + chains as JSON")
    stp.set_defaults(fn=cmd_stuck)

    skp = sub.add_parser(
        "stack", help="one-shot stack dump of every live worker "
                      "(py-spy-dump equivalent, task-attributed)")
    skp.add_argument("--worker", default=None,
                     help="dump just this worker id")
    skp.add_argument("--format", default="plain",
                     choices=["plain", "speedscope"])
    skp.add_argument("-o", "--output", default=None,
                     help="write speedscope JSON here instead of "
                          "stdout")
    skp.set_defaults(fn=cmd_stack)

    svp = sub.add_parser("serve", help="serve an Application over HTTP")
    svsub = svp.add_subparsers(dest="serve_cmd", required=True)
    svr = svsub.add_parser("run", help="import module:app and serve it")
    svr.add_argument("target")
    svr.add_argument("--name", default="default")
    svr.add_argument("--route-prefix", default=None)
    svr.add_argument("--host", default="127.0.0.1")
    svr.add_argument("--port", type=int, default=8000)
    svr.add_argument("--dashboard-port", type=int, default=None,
                     help="also start this driver's dashboard on this port "
                          "(0 = ephemeral) for `serve status --address`")
    svr.set_defaults(fn=cmd_serve)
    svst = svsub.add_parser(
        "status", help="serve apps of the live driver (via --address "
                       "dashboard); stop a served app with Ctrl-C on "
                       "its `serve run` process")
    svst.set_defaults(fn=cmd_serve)
    svrt = svsub.add_parser(
        "router", help="scale-out router table: replica ring, "
                       "registered prefixes + owners, sticky bindings")
    svrt.set_defaults(fn=cmd_serve)
    svas = svsub.add_parser(
        "autoscaler", help="serve autoscaler targets + recent "
                           "scale_up/scale_down decisions")
    svas.set_defaults(fn=cmd_serve)

    jp = sub.add_parser("job", help="run a driver script as a job")
    jsub = jp.add_subparsers(dest="job_cmd", required=True)
    jsp = jsub.add_parser("submit")
    jsp.add_argument("--timeout", type=float, default=3600.0)
    jsp.add_argument("--no-wait", action="store_true",
                     help="print the submission id and return")
    jsp.add_argument("--remote", action="store_true",
                     help="submit via --address dashboard /api/jobs")
    jsp.add_argument("entrypoint", nargs=argparse.REMAINDER)
    jsp.set_defaults(fn=cmd_job)
    jls = jsub.add_parser("list", help="jobs on the --address dashboard")
    jls.set_defaults(fn=cmd_job)
    for verb in ("status", "logs", "stop"):
        jv = jsub.add_parser(verb,
                             help=f"{verb} via the --address dashboard")
        jv.add_argument("submission_id")
        if verb == "logs":
            jv.add_argument("--follow", action="store_true")
        jv.set_defaults(fn=cmd_job)

    npp = sub.add_parser(
        "node", help="join this host to a driver as a node agent "
                     "(alias of python -m ray_tpu_torch.core.node)",
        add_help=False)
    del npp  # listed in top-level help; dispatch happens below

    # `node` forwards EVERYTHING after it (flags in any order, --help
    # included) to the agent's own parser; parse_known_args would eat its
    # flags. The only global option (--address) may precede it.
    argv = sys.argv[1:] if argv is None else list(argv)
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--address":
            i += 2
            continue
        if tok.startswith("--address="):
            i += 1
            continue
        break
    if i < len(argv) and argv[i] == "node":
        from .core import node as node_mod
        sys.argv = ["ray_tpu_torch node", *argv[i + 1:]]
        node_mod.main()
        return

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

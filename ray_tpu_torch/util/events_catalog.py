"""Catalog of every built-in cluster lifecycle event type.

One place declares type / default severity / help for the structured
event plane (`util/events.py`), mirroring `metrics_catalog.py` for
metrics: docs/OBSERVABILITY.md renders this table and a tier-1 lint
test asserts every event type emitted by package code is cataloged and
follows the `<subsystem>.<event>` naming rule.

Reference counterpart: the task-event/export subsystem behind
`ray list tasks --detail` (src/ray/gcs task events + the export API) —
collapsed to a single catalog because the single-controller driver is
the only consumer-facing store.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

# type -> (default_severity, help)
_SPEC = Tuple[str, str]

SEVERITIES = ("info", "warning", "error")

# <subsystem>.<event> up to <subsystem>.<service>.<object>.<event>
# (the serve plane namespaces per object: serve.replica.*; the data
# service namespaces per verb: data.service.shard.grant)
NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+){1,3}$")

BUILTIN: Dict[str, _SPEC] = {
    # ---- task lifecycle (driver dispatcher) ----
    "task.submit": (
        "info", "task registered with the scheduler"),
    "task.sched": (
        "info", "task dispatched to a worker (submit -> running)"),
    "task.retry": (
        "warning", "task re-queued after a worker/node death or "
        "lineage reconstruction (message holds the cause)"),
    "task.finish": (
        "info", "task completed successfully"),
    "task.lease.grant": (
        "info", "a worker was granted a multi-slot task lease (one "
        "dispatch frame carrying several queued tasks; attrs carry the "
        "slot count)"),
    "task.lease.revoke": (
        "warning", "a task lease ended before every slot ran: the "
        "worker died, or its running head blocked in get() and the "
        "unstarted slots were reclaimed for other workers (zero lost "
        "tasks either way — unstarted slots re-queue without burning "
        "a retry)"),
    "task.lease.node_grant": (
        "info", "a node AGENT was granted a bulk lease (two-level "
        "scheduling, docs/SCHEDULING.md): one frame carrying a worker "
        "set plus a task batch; the agent fans the batch across its "
        "local workers and refills them without driver round trips "
        "(attrs carry worker and slot counts)"),
    "task.spillback": (
        "warning", "a node agent handed granted tasks back to the "
        "driver queue (placement timeout, worker death, or a fenced "
        "lease); unstarted tasks re-queue without burning a retry "
        "(attrs carry the reason and count)"),
    "task.dispatch.local": (
        "info", "a direct worker->worker call channel was established "
        "via the sys.actor_addr directory; steady-state calls on it "
        "bypass the driver entirely"),
    "task.fail": (
        "error", "task reached FAILED (message holds the error)"),
    "task.cancel": (
        "warning", "task cancelled"),
    # ---- actor lifecycle ----
    "actor.create": (
        "info", "actor creation registered"),
    "actor.alive": (
        "info", "actor constructor finished; actor is ALIVE"),
    "actor.restart": (
        "warning", "actor worker died; restart scheduled "
        "(restart budget remaining)"),
    "actor.death": (
        "error", "actor reached DEAD (message holds death_cause)"),
    "actor.checkpoint": (
        "info", "actor shipped a __ray_save__ state checkpoint to the "
        "driver (restored via __ray_restore__ around a restart)"),
    "actor.restore": (
        "info", "restarted actor resumed from its last __ray_save__ "
        "checkpoint via __ray_restore__"),
    # ---- object lifecycle ----
    "object.seal": (
        "info", "object payload sealed into a store"),
    "object.spill": (
        "info", "object copied to disk by the watermark spiller"),
    "object.transfer": (
        "info", "object copy landed on another node "
        "(peer pull or relay re-host)"),
    "object.free": (
        "info", "object freed and its payloads reclaimed"),
    "object.lost": (
        "error", "object payload lost with no live copy (severity "
        "warning when lineage reconstruction follows; error when the "
        "producer is not re-executable)"),
    "object.reconstruct": (
        "warning", "lost object's producing task re-queued from the "
        "driver's lineage table (the Ray-paper availability trick: a "
        "lost object is a re-execution, not an error)"),
    # ---- driver / control-plane persistence ----
    "driver.restart": (
        "warning", "a driver resumed from persisted state "
        "(RAY_TPU_STATE_DIR) under a bumped incarnation; attrs carry "
        "replayed WAL record count and torn-tail/clean flags"),
    "gcs.snapshot": (
        "info", "control-plane snapshot written and WAL rotated "
        "(bounds replay time after a driver crash)"),
    # ---- node lifecycle ----
    "node.register": (
        "info", "node agent joined the cluster"),
    "node.reattach": (
        "info", "a node agent (with its surviving object store) "
        "re-registered with a RESTARTED driver; its restored objects "
        "were re-sealed and are ready again"),
    "node.heartbeat_miss": (
        "warning", "node stopped heartbeating (stale or connection "
        "lost); death determination may follow"),
    "node.death": (
        "error", "node declared dead (socket close or heartbeat "
        "silence past RAY_TPU_NODE_DEATH_TIMEOUT_S); its work fails "
        "over and its object copies are pruned"),
    "node.rejoin": (
        "info", "a dead-declared node re-registered under a new "
        "incarnation; queued work may flow to it again"),
    "node.fence": (
        "warning", "traffic from a superseded node incarnation dropped "
        "(stalled agent recovered after its death determination)"),
    "node.memory_pressure": (
        "warning", "host available memory crossed the pressure "
        "threshold (the RSS watchdog may kill a worker next)"),
    # ---- worker pool ----
    "worker.start": (
        "info", "worker process spawned"),
    "worker.death": (
        "warning", "worker process died or was terminated"),
    "worker.profile.start": (
        "info", "a worker's sampling profiler started (or changed "
        "rate) via RAY_TPU_PROFILE_HZ or an on-demand profile_ctl "
        "request; attrs carry the hz"),
    "worker.profile.stop": (
        "info", "a worker's sampling profiler stopped via an "
        "on-demand profile_ctl request"),
    # ---- compiled DAGs (docs/DAG.md) ----
    "dag.compile": (
        "info", "compiled-DAG pipeline placed and wired: attrs carry "
        "stage, pinned-worker, and channel counts (schedule once — "
        "every execute() after this costs zero driver messages)"),
    "dag.channel.open": (
        "info", "one reusable object channel connected (same-node: "
        "rewritten shm segment; cross-node: persistent socket)"),
    "dag.channel.close": (
        "info", "a compiled DAG's channels released at teardown "
        "(segments unlinked, sockets closed)"),
    "dag.teardown": (
        "info", "compiled-DAG pipeline released its pinned workers; "
        "attrs carry the reason (close(), failure cause, shutdown)"),
    "dag.fail": (
        "error", "compiled-DAG pipeline infrastructure failed "
        "(participant death / channel loss); in-flight executions got "
        "CompiledDagError and the next execute() re-compiles"),
    "dag.exec.fallback": (
        "info", "compiled DAG running on the dynamic level-batched "
        "path (RAY_TPU_COMPILED_DAGS=0 or a pipeline-ineligible graph "
        "shape; attrs carry the reason)"),
    # ---- scheduler ----
    "scheduler.backpressure": (
        "warning", "task/actor pending past the stuck-warning window "
        "with nowhere to place it"),
    # ---- wait-graph hang detection (observability/waitgraph.py) ----
    "sched.deadlock.detected": (
        "error", "the wait-graph watchdog found a cycle (e.g. two "
        "actors ray.get-ing each other's pending calls): attrs name "
        "every participant and edge of the cycle; the workload cannot "
        "make progress without intervention"),
    "sched.hang.suspected": (
        "warning", "a wait older than RAY_TPU_HANG_WARN_S with its "
        "live root cause attached (the far end of the wait chain), or "
        "an existing hang mitigation firing (consumer-stall TTL, "
        "driver-silence watchdog)"),
    "sched.hang.resolved": (
        "info", "a previously suspected hang's wait chain drained — "
        "on its own, or via a mitigation like the consumer-stall TTL "
        "(attrs carry how long it was stuck)"),
    # ---- serve LLM engine ----
    "llm_engine.request_admit": (
        "info", "request took a decode slot (prefill dispatching)"),
    "llm_engine.request_preempt": (
        "warning", "request held back at admission (KV page pool "
        "exhausted); re-admitted when pages free"),
    "llm_engine.request_finish": (
        "info", "request released its slot (finished or errored)"),
    "llm_engine.request_abort": (
        "warning", "request aborted by the client"),
    "llm_engine.wedged": (
        "error", "generation loop made no forward progress past "
        "RAY_TPU_ENGINE_WATCHDOG_S with requests admitted; in-flight "
        "requests aborted with EngineWedgedError and the replica's "
        "health check fails with a `wedged` cause"),
    # ---- serve fault-tolerance plane ----
    "serve.replica.unhealthy": (
        "error", "replica failed RAY_TPU_SERVE_HEALTH_THRESHOLD "
        "consecutive controller health probes (message holds the "
        "cause, e.g. wedged / timeout / ActorDiedError); it is killed "
        "and replaced"),
    "serve.replica.replaced": (
        "warning", "controller started a replacement replica for one "
        "that died or went unhealthy (attrs link old -> new ids)"),
    "serve.replica.drain": (
        "info", "replica finished (or timed out) its graceful drain on "
        "rolling update / scale-down / shutdown and was stopped"),
    "serve.request.failover": (
        "warning", "a request was resubmitted to a different replica "
        "after its serving replica died, wedged, or started draining"),
    "serve.request.shed": (
        "warning", "a request was shed instead of executed (propagated "
        "deadline expired before admission, or the replica is "
        "draining); the proxy surfaces 503 + Retry-After"),
    # ---- serve scale-out plane (router + autoscaler) ----
    "serve.router.affinity_hit": (
        "info", "a session/prefix-keyed request reached its warm bound "
        "replica; emitted at binding creation (per-request hits are "
        "counted by ray_tpu_serve_router_requests_total)"),
    "serve.router.affinity_miss": (
        "warning", "a session/prefix-keyed request could not reach its "
        "warm replica (suspect / draining / over the bounded-load cap "
        "/ gone) and was re-bound to another replica (cold prefill, "
        "never an error)"),
    "serve.autoscaler.scale_up": (
        "info", "the serve autoscaler raised a deployment's replica "
        "target from live engine metrics (attrs: from/to, reason, "
        "bin-packed feasible_now, placement group when reserved)"),
    "serve.autoscaler.scale_down": (
        "info", "the serve autoscaler lowered a deployment's replica "
        "target; the controller gracefully drains the least-busy "
        "replicas first"),
    # ---- elastic training fault tolerance ----
    "train.gang.rank_death": (
        "error", "a rank actor of a supervised SPMD gang died "
        "(preempted host, killed worker); the supervisor fails parked "
        "collective rounds fast (CollectiveRankDiedError) and arms a "
        "gang reform"),
    "train.gang.reform": (
        "warning", "the gang tore down its doomed torch.distributed "
        "world and re-ganged under a bumped generation (attrs: "
        "old_world -> world, seconds; kind replaced|resharded)"),
    "train.gang.reshard": (
        "warning", "no replacement capacity for the requested gang "
        "size: the gang reformed RESHARDED onto the surviving world "
        "(dp axis shrunk; mesh layout is a function of the surviving "
        "world, not fixed job state)"),
    "train.restore": (
        "info", "a (re)formed gang restored the last committed "
        "checkpoint onto its mesh and resumed from state.step (attrs: "
        "step, world, generation, seconds)"),
    # ---- event plane itself ----
    "events.dropped": (
        "warning", "a process's local event buffer overflowed between "
        "flushes; this many events were lost before shipping"),
    # ---- data executor ----
    "data.executor_stall": (
        "warning", "streaming stage producer stalled on the in-flight "
        "backpressure budget"),
    # ---- data service (shared data plane) ----
    "data.service.register": (
        "info", "dataset plan or consumer job registered with the "
        "data-service dispatcher (also emitted on dispatcher restore)"),
    "data.service.epoch": (
        "info", "epoch lifecycle: production complete for an epoch, or "
        "a job's consumers crossed the epoch barrier"),
    "data.service.shard.grant": (
        "info", "a produced block was leased to a consumer (at-most-"
        "once handout; consumer acks retire the grant)"),
    "data.service.shard.revoke": (
        "warning", "outstanding shard grants returned to the pool "
        "(lease expiry, consumer re-attach, or data-worker death)"),
    "data.service.worker.scale": (
        "info", "data-worker pool scaled up or down by the dispatcher "
        "autoscaler"),
}


def spec(event_type: str) -> Tuple[str, str]:
    """(default_severity, help) for a cataloged type; uncataloged user
    types default to ("info", "")."""
    return BUILTIN.get(event_type, ("info", ""))

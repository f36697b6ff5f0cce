"""Catalog of every built-in `ray_tpu_`-prefixed metric.

One place declares name / kind / help / tags / unit for the runtime's
own telemetry (docs/OBSERVABILITY.md renders this table; a tier-1 test
asserts the naming rules). Hot paths call `get(name)` — it returns the
live registry entry, re-creating it if tests cleared the registry, so
instrumentation sites never hold a stale Metric across clears.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from . import metrics as metrics_mod

# name -> (kind, help, tag_keys, unit, boundaries|None)
_SPEC = Tuple[str, str, Tuple[str, ...], str,
              Optional[Sequence[float]]]

# Sub-second latency boundaries for per-token / per-step observations.
_FAST = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 5)

BUILTIN: Dict[str, _SPEC] = {
    # ---- core runtime (driver side) ----
    "ray_tpu_tasks_submitted_total": (
        "counter", "tasks registered with the scheduler", ("kind",),
        "tasks", None),
    "ray_tpu_tasks_finished_total": (
        "counter", "tasks reaching a terminal state", ("state",),
        "tasks", None),
    "ray_tpu_task_sched_latency_s": (
        "histogram", "submit -> dispatch latency", (), "seconds", None),
    "ray_tpu_task_run_s": (
        "histogram", "dispatch -> completion latency (driver view)",
        (), "seconds", None),
    "ray_tpu_workers": (
        "gauge", "worker processes by state", ("state",), "workers",
        None),
    "ray_tpu_pending_tasks": (
        "gauge", "tasks waiting for placement", (), "tasks", None),
    "ray_tpu_object_store_used_bytes": (
        "gauge", "bytes sealed in the local object store", (), "bytes",
        None),
    "ray_tpu_object_store_capacity_bytes": (
        "gauge", "local object-store capacity", (), "bytes", None),
    "ray_tpu_object_store_objects": (
        "gauge", "objects resident in the local arena", (), "objects",
        None),
    "ray_tpu_object_store_reads_total": (
        "counter", "object reads by outcome "
        "(inline / hit / spill fallback)", ("result",), "reads", None),
    "ray_tpu_object_reconstructions_total": (
        "counter", "lost objects whose producing task was re-queued "
        "from the lineage table", (), "objects", None),
    "ray_tpu_actor_checkpoints_total": (
        "counter", "actor __ray_save__ checkpoints shipped to the "
        "driver", (), "checkpoints", None),
    # ---- control-plane persistence (core/persistence.py) ----
    "ray_tpu_driver_incarnation": (
        "gauge", "driver restart generation (0 = first life; bumps on "
        "every init(resume=...) from persisted state)", (),
        "incarnations", None),
    "ray_tpu_wal_records": (
        "gauge", "control-plane WAL records appended this driver life",
        (), "records", None),
    "ray_tpu_wal_bytes": (
        "gauge", "bytes in the active control-plane WAL since the last "
        "snapshot rotation", (), "bytes", None),
    "ray_tpu_gcs_snapshots_total": (
        "counter", "control-plane snapshots written (each rotates the "
        "WAL)", (), "snapshots", None),
    # ---- batched dispatch plane (docs/SCHEDULING.md) ----
    "ray_tpu_submit_batch_size": (
        "histogram", "tasks per flushed api_submit_many batch (the "
        "size+time flush window coalescing .remote() storms)", (),
        "tasks", (1, 2, 4, 8, 16, 32, 64, 128, 256)),
    "ray_tpu_dispatch_batch_size": (
        "histogram", "tasks per multi-slot dispatch frame (worker "
        "lease grants and pipelined actor batches)", (), "tasks",
        (2, 4, 8, 16, 32, 64, 128)),
    "ray_tpu_lease_grants_total": (
        "counter", "multi-slot worker task leases granted", (),
        "leases", None),
    "ray_tpu_lease_revokes_total": (
        "counter", "worker task leases revoked before every slot ran "
        "(worker death, or reclaimed from a blocked worker)",
        ("reason",), "leases", None),
    "ray_tpu_node_lease_grants_total": (
        "counter", "bulk NODE leases granted to node agents (two-"
        "level scheduling: one frame hands an agent a worker set plus "
        "a task batch to fan out locally)", (), "leases", None),
    "ray_tpu_spillbacks_total": (
        "counter", "tasks a node agent handed back to the driver "
        "queue (couldn't place within its lease budget, or lost the "
        "worker mid-run)", ("reason",), "tasks", None),
    "ray_tpu_agent_dispatch_batch_size": (
        "histogram", "tasks per node-lease grant/extend frame (the "
        "driver->agent analogue of ray_tpu_dispatch_batch_size)", (),
        "tasks", (2, 4, 8, 16, 32, 64, 128, 256)),
    "ray_tpu_direct_actor_calls_total": (
        "counter", "actor calls dispatched over a direct worker->"
        "worker channel, bypassing the driver", (), "calls", None),
    "ray_tpu_direct_call_fallbacks_total": (
        "counter", "actor calls that fell back to the driver dispatch "
        "path (no direct address, or the channel died)", ("reason",),
        "calls", None),
    "ray_tpu_node_memory_pressure": (
        "gauge", "host memory pressure (1 - available/total); the RSS "
        "watchdog kills a worker as it approaches 1.0", (), "ratio",
        None),
    # ---- compiled-DAG plane (docs/DAG.md) ----
    "ray_tpu_dag_execs_total": (
        "counter", "compiled-DAG executions by mode (pipelined = "
        "channel pipeline, zero driver messages; batched = dynamic "
        "level-batched fallback)", ("mode",), "execs", None),
    "ray_tpu_dag_channel_reuse_total": (
        "counter", "channel writes that reused an already-open channel "
        "(every write after a channel's first — the allocate/seal/free "
        "work the pipeline avoids)", (), "writes", None),
    "ray_tpu_dag_stage_exec_seconds": (
        "histogram", "one compiled-DAG stage's compute time per "
        "execution, measured in the pinned worker (the per-stage view "
        "behind the flight-recorder spans)", ("dag_id", "sid"),
        "seconds", _FAST),
    "ray_tpu_dag_channel_stall_seconds": (
        "counter", "seconds compiled-DAG channel writers spent blocked "
        "on the consumer ack window (backpressure: the downstream "
        "stage is the bottleneck)", (), "seconds", None),
    "ray_tpu_wire_fallbacks_total": (
        "counter", "control frames of a wire-eligible kind that fell "
        "back to cloudpickle framing (should stay 0 in steady state; "
        "a payload the msgpack codec cannot express)", ("kind",),
        "frames", None),
    # ---- peer-to-peer object transfer plane (core/object_transfer.py) ----
    "ray_tpu_transfer_bytes_pulled_total": (
        "counter", "object bytes pulled directly from holder nodes",
        (), "bytes", None),
    "ray_tpu_transfer_bytes_served_total": (
        "counter", "object bytes served to peer nodes by the local "
        "transfer server", (), "bytes", None),
    "ray_tpu_transfer_chunks_total": (
        "counter", "transfer chunks moved by direction (in = pulled, "
        "out = served)", ("dir",), "chunks", None),
    "ray_tpu_transfer_pulls_total": (
        "counter", "pull requests by outcome (ok / error / dedup "
        "wait / local hit)", ("result",), "pulls", None),
    "ray_tpu_transfer_pull_retries_total": (
        "counter", "pull retry rounds (backoff + alternate holders)",
        (), "retries", None),
    "ray_tpu_transfer_pull_latency_s": (
        "histogram", "single successful pull wall time", (), "seconds",
        None),
    "ray_tpu_transfer_relay_bytes_total": (
        "counter", "object bytes that fell back to the driver-relay "
        "path (peer path unavailable or failed)", (), "bytes", None),
    # ---- wait-state plane (util/waits.py, observability/waitgraph.py) ----
    "ray_tpu_wait_records": (
        "gauge", "in-progress waits registered in this process's wait "
        "table (parked get/wait/collective/DAG/lease/data-grant "
        "edges)", (), "waits", None),
    "ray_tpu_wait_seconds": (
        "counter", "seconds spent in completed waits, by waited-on "
        "resource kind (object / actor-call / collective-round / "
        "dag-channel / lease-slot / data-grant)", ("kind",), "seconds",
        None),
    "ray_tpu_hangs_detected_total": (
        "counter", "wait-graph watchdog detections by kind (deadlock "
        "/ stale / straggler)", ("kind",), "hangs", None),
    # ---- worker processes (shipped to the driver exposition) ----
    "ray_tpu_worker_task_run_s": (
        "histogram", "task execution latency measured IN the worker",
        (), "seconds", None),
    "ray_tpu_worker_tasks_total": (
        "counter", "tasks executed by this worker", ("status",),
        "tasks", None),
    "ray_tpu_profile_samples_total": (
        "counter", "stack samples taken by the always-on sampling "
        "profiler (RAY_TPU_PROFILE_HZ / profile_ctl)", (), "samples",
        None),
    "ray_tpu_trace_spans_dropped_total": (
        "counter", "fast-path spans dropped because the bounded "
        "flight-recorder ring overflowed between telemetry flushes",
        (), "spans", None),
    "ray_tpu_worker_hbm_used_bytes": (
        "gauge", "accelerator memory in use per local device "
        "(torch.cuda.memory_allocated; absent where CUDA is not "
        "in use)", ("device",), "bytes", None),
    "ray_tpu_worker_host_rss_bytes": (
        "gauge", "worker process resident set size", (), "bytes",
        None),
    # ---- serve LLM engine ----
    "ray_tpu_llm_engine_tokens_generated": (
        "counter", "tokens sampled across all requests", ("engine",),
        "tokens", None),
    "ray_tpu_llm_engine_active_slots": (
        "gauge", "requests currently decoding", ("engine",), "requests",
        None),
    "ray_tpu_llm_engine_waiting_requests": (
        "gauge", "requests awaiting a slot", ("engine",), "requests",
        None),
    "ray_tpu_llm_engine_batch_occupancy": (
        "gauge", "active slots / max_slots", ("engine",), "ratio", None),
    "ray_tpu_llm_engine_kv_page_utilization": (
        "gauge", "KV pages in use / pool pages (paged engines)",
        ("engine",), "ratio", None),
    "ray_tpu_llm_engine_ttft_s": (
        "histogram", "submit -> first token", ("engine",), "seconds",
        None),
    "ray_tpu_llm_engine_tpot_s": (
        "histogram", "mean time per output token after the first",
        ("engine",), "seconds", _FAST),
    # ---- serve fault-tolerance plane ----
    "ray_tpu_serve_health_probe_failures_total": (
        "counter", "controller health probes that failed or timed out "
        "(one replica replacement per RAY_TPU_SERVE_HEALTH_THRESHOLD "
        "consecutive failures)", ("deployment",), "probes", None),
    "ray_tpu_serve_requests_shed_total": (
        "counter", "requests shed instead of executed (expired "
        "propagated deadline at admission, or replica draining)",
        ("reason",), "requests", None),
    "ray_tpu_serve_failovers_total": (
        "counter", "requests resubmitted to a different replica after "
        "a replica death / wedged engine / drain rejection",
        ("kind",), "requests", None),
    # ---- serve scale-out plane (router + autoscaler) ----
    "ray_tpu_serve_router_requests_total": (
        "counter", "affinity-keyed requests routed, by outcome "
        "(affinity_hit = reached the bound warm replica, affinity_miss "
        "= diverted/re-bound)", ("deployment", "outcome"), "requests",
        None),
    "ray_tpu_serve_router_sessions": (
        "gauge", "session/prefix keys currently bound to a replica in "
        "this process's router", ("deployment",), "sessions", None),
    "ray_tpu_serve_autoscaler_target_replicas": (
        "gauge", "replica target the serve autoscaler reconciles the "
        "deployment toward", ("deployment",), "replicas", None),
    "ray_tpu_serve_autoscaler_scale_events_total": (
        "counter", "serve autoscaler target changes",
        ("deployment", "direction"), "decisions", None),
    # ---- data executor ----
    "ray_tpu_data_inflight_bytes": (
        "gauge", "bytes of blocks in flight in a streaming stage",
        ("stage",), "bytes", None),
    "ray_tpu_data_backpressure_stall_s_total": (
        "counter", "seconds the producer stalled on the in-flight "
        "byte/count budget", ("stage",), "seconds", None),
    "ray_tpu_data_blocks_total": (
        "counter", "blocks processed by a streaming stage", ("stage",),
        "blocks", None),
    # ---- data service (shared data plane) ----
    "ray_tpu_data_service_queue_depth": (
        "gauge", "produced blocks held by the data service awaiting "
        "consumption (per dataset, current epoch)", ("dataset",),
        "blocks", None),
    "ray_tpu_data_service_outstanding_shards": (
        "gauge", "shard grants handed to consumers and not yet acked",
        ("job",), "shards", None),
    "ray_tpu_data_service_consumer_lag": (
        "gauge", "blocks of the current epoch a consumer has not yet "
        "acked (eligible minus consumed)", ("job", "consumer"),
        "blocks", None),
    "ray_tpu_data_service_shards_granted_total": (
        "counter", "shard grants issued by the dispatcher",
        ("job", "mode"), "shards", None),
    # ---- train loop ----
    "ray_tpu_train_step_time_s": (
        "histogram", "wall time between session.report() calls",
        (), "seconds", None),
    "ray_tpu_train_reports_total": (
        "counter", "session.report() calls", (), "reports", None),
    "ray_tpu_train_tokens_per_s": (
        "gauge", "training throughput (mirrors the reported "
        "tokens_per_s metric)", (), "tokens/s", None),
    "ray_tpu_train_mfu": (
        "gauge", "model FLOPs utilization (mirrors the reported mfu "
        "metric)", (), "ratio", None),
    # ---- elastic training fault tolerance ----
    "ray_tpu_train_gang_reforms_total": (
        "counter", "supervised SPMD gang reforms after a rank death "
        "(kind: replaced = full size on fresh capacity, resharded = "
        "shrunk onto the surviving world)", ("kind",), "reforms", None),
    "ray_tpu_train_restore_seconds": (
        "histogram", "committed-checkpoint restore time onto the "
        "(re)formed gang's mesh (the dominant share of training MTTR "
        "after a preemption)", (), "seconds", None),
}

_create_lock = threading.Lock()


def get(name: str) -> metrics_mod.Metric:
    """The live registry Metric for a catalog name (created on first use
    and re-created after clear_registry)."""
    m = metrics_mod.get_metric(name)
    if m is not None:
        return m
    spec = BUILTIN.get(name)
    if spec is None:
        raise KeyError(f"{name!r} is not a cataloged built-in metric")
    kind, help_, tag_keys, _unit, boundaries = spec
    with _create_lock:
        m = metrics_mod.get_metric(name)
        if m is not None:
            return m
        if kind == "counter":
            return metrics_mod.Counter(name, help_, tag_keys=tag_keys)
        if kind == "gauge":
            return metrics_mod.Gauge(name, help_, tag_keys=tag_keys)
        return metrics_mod.Histogram(
            name, help_,
            boundaries=boundaries or metrics_mod.DEFAULT_BOUNDARIES,
            tag_keys=tag_keys)

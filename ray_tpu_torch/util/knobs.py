"""Central registry of every `RAY_TPU_*` environment knob the port reads
(counterpart of ray_tpu/util/knobs.py). It copies the reference's
declarations of the knobs that port modules read, under the same names:
a deployment configures either runtime the same way. A knob whose
reader is not ported yet is declared with that reader.

One `_declare` per knob states the type, canonical default and doc
string; every read goes through the typed getters here. The table
prints as markdown with `python -m ray_tpu_torch.util.knobs`.

Getter semantics, as in the reference:

  * the environment is read at CALL time (tests monkeypatch env vars
    after import; values must not be baked in at module load);
  * unset OR empty-string values fall back to the default;
  * a malformed value falls back to the default instead of crashing
    whatever process read it;
  * `get_bool` treats `0 / false / no / off / ""` (any case) as False,
    everything else as True;
  * a site may pass `default=` to override the declared default;
  * reading an UNDECLARED knob raises KeyError.

Knobs marked "wiring" are set by the runtime for its child processes.

Below the registry are the port's own named accessors (engine watchdog,
the launcher's rank block, the loader's prefetch depth).

Deliberate difference: `RAY_TPU_CHIPS` (the local TPU chip count) is
`RAY_TPU_GPUS` here, the local GPU count; the TPU pod labels
(`RAY_TPU_POD_TYPE`, `RAY_TPU_SLICE`, `RAY_TPU_WORKER_ID`) have no
counterpart.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

_UNSET = object()

_FALSEY = ("0", "false", "no", "off", "")


@dataclass(frozen=True)
class Knob:
    name: str
    type: str          # "int" | "float" | "bool" | "str"
    default: Any       # canonical default; None = unset
    doc: str
    subsystem: str
    wiring: bool = False   # set by the runtime for child processes


REGISTRY: Dict[str, Knob] = {}


def _declare(name: str, type_: str, default: Any, doc: str,
             subsystem: str, wiring: bool = False) -> None:
    assert name.startswith("RAY_TPU_"), name
    assert type_ in ("int", "float", "bool", "str"), type_
    assert name not in REGISTRY, f"duplicate knob {name}"
    REGISTRY[name] = Knob(name, type_, default, doc, subsystem, wiring)


# ---------------------------------------------------------------------------
# core: dispatch plane (docs/SCHEDULING.md)

_declare("RAY_TPU_BATCH", "bool", True,
         "Batched control-plane messaging: driver-side submit "
         "coalescing and the worker completion batcher. 0 forces one "
         "frame per message (the unbatched wire).", "core dispatch")
_declare("RAY_TPU_BATCH_FLUSH_N", "int", 64,
         "Messages coalesced into one batch frame before a size "
         "flush.", "core dispatch")
_declare("RAY_TPU_BATCH_FLUSH_S", "float", 0.001,
         "Batch flush window in seconds (time flush).",
         "core dispatch")
_declare("RAY_TPU_LEASE_SLOTS", "int", 32,
         "Queued tasks granted to one worker in a multi-slot lease "
         "frame.", "core dispatch")
_declare("RAY_TPU_ACTOR_PIPELINE", "int", 32,
         "Actor-call slots dispatched to a worker beyond each lane's "
         "concurrency limit (pipelining; the worker enforces the "
         "execution bound).", "core dispatch")
_declare("RAY_TPU_LEASE_HEAD_S", "float", 1.0,
         "Seconds a leased FIFO head may stay parked in get()/wait() "
         "before the driver reclaims its unstarted slots "
         "(0 disables).", "core dispatch")
_declare("RAY_TPU_NODE_LEASES", "bool", True,
         "Two-level scheduling (docs/SCHEDULING.md): the driver grants "
         "whole batches of compatible queued tasks to a remote node "
         "agent in one frame, and the agent fans them across its local "
         "workers without driver round trips. 0 falls back to "
         "per-worker leases.", "core dispatch")
_declare("RAY_TPU_NODE_LEASE_SLOTS", "int", 128,
         "Per-worker queue depth inside a node-level bulk lease (the "
         "lease budget is leased-workers x this). Deep on purpose: "
         "the agent owns its backlog, and a shallow budget starves it "
         "into per-completion ack/extend chatter.", "core dispatch")
_declare("RAY_TPU_NODE_LEASE_DEPTH", "int", 8,
         "Tasks a node agent keeps in flight per local worker within "
         "a bulk lease (FIFO at the worker). Depth >1 pipelines the "
         "dispatch round trip so sub-millisecond tasks never leave a "
         "worker idle; only the FIFO head can have started, so spill "
         "accounting stays exact.", "core dispatch")
_declare("RAY_TPU_NODE_LEASE_SPILL_S", "float", 5.0,
         "Seconds a node agent may hold an unplaceable leased task "
         "(all local workers busy/dead) before spilling it back to "
         "the driver queue.", "core dispatch")
_declare("RAY_TPU_NODE_LEASE_IDLE_S", "float", 2.0,
         "Linger for a drained standing node lease (agent-local "
         "nested submissions): workers release back to the driver "
         "after this long with no agent-local traffic.",
         "core dispatch")
_declare("RAY_TPU_AGENT_ADDR", "str", "",
         "Agent-local dispatch socket a node agent passes to the "
         "workers it spawns (internal wiring).", "core dispatch",
         wiring=True)
_declare("RAY_TPU_DIRECT_CALLS", "bool", True,
         "Direct worker->worker actor-call channels (zero driver "
         "messages steady-state). 0 pins every call to the driver "
         "path.", "core dispatch")
_declare("RAY_TPU_WIRE", "bool", True,
         "Compact msgpack codec for hot control-frame kinds. 0 forces "
         "legacy all-pickle framing.", "core dispatch")
_declare("RAY_TPU_COMPILED_DAGS", "bool", True,
         "Compiled-DAG pipelined execution (docs/DAG.md): compile "
         "resolves placement once, pins a worker per stage and "
         "pre-opens reusable channels; execute() pushes input with "
         "zero driver control messages. 0 falls back to the "
         "level-batched dynamic path (one submit_many per level).",
         "core dispatch")
_declare("RAY_TPU_DAG_CHANNEL_BYTES", "int", 1 << 20,
         "Initial capacity of a compiled-DAG same-node channel "
         "segment. A payload larger than the current capacity grows "
         "the channel into a fresh generation-suffixed segment (the "
         "old one is unlinked); cross-node edges are unaffected (they "
         "ride the peer socket frame).", "core dispatch")
_declare("RAY_TPU_DAG_CHANNEL_DEPTH", "int", 16,
         "Ack window of a compiled-DAG channel for inline payloads: a "
         "writer may run this many seqnos ahead of its reader before "
         "blocking, which is what lets pipeline stages overlap. "
         "Shared-memory segment payloads always gate at depth 1 (the "
         "segment is rewritten in place, so the previous payload must "
         "be consumed first).", "core dispatch")
_declare("RAY_TPU_DAG_COMPILE_TIMEOUT_S", "float", 30.0,
         "Deadline for a compiled DAG's placement + channel install "
         "handshake. Expiry raises CompiledDagError and releases any "
         "partially pinned workers.", "core dispatch")

# ---------------------------------------------------------------------------
# core: runtime + object store

_declare("RAY_TPU_MAX_WORKERS", "int", 16,
         "Driver-local worker-pool size cap.", "core runtime")
_declare("RAY_TPU_STORE_BYTES", "int", 8 << 30,
         "Shared-memory object-store arena capacity in bytes (node "
         "agents default to 2 GiB).", "core runtime")
_declare("RAY_TPU_SPILL_THRESHOLD", "float", 0.6,
         "Arena-fullness watermark where the spiller starts copying "
         "segments to disk.", "core runtime")
_declare("RAY_TPU_SPILL_DIR", "str", None,
         "Spill directory. The driver/agent sets it for its workers; "
         "operators may pre-set it to pick the disk.", "core runtime")
_declare("RAY_TPU_FETCH_CHUNK", "int", 64 << 20,
         "Max bytes per relay/fetch stream frame on the driver-relay "
         "path.", "core runtime")
_declare("RAY_TPU_LISTEN", "str", None,
         "tcp://host:port control listener enabling multi-host "
         "clusters (unset = unix socket only).", "core runtime")
_declare("RAY_TPU_LOG_DIR", "str", None,
         "Per-job worker log directory (enables output redirection "
         "and per-task log attribution).", "core runtime")
_declare("RAY_TPU_LOG_TAIL_BYTES", "int", 4 << 20,
         "Trailing bytes read per worker log file when building "
         "task-attributed tails.", "core runtime")
_declare("RAY_TPU_DEVICE_OBJECTS", "bool", True,
         "Device-resident object store (TPU buffers stay in HBM "
         "between tasks).", "core runtime")
_declare("RAY_TPU_DEVICE_OBJECTS_MAX", "int", 256,
         "Max device-resident object entries before LRU eviction to "
         "host.", "core runtime")
_declare("RAY_TPU_NODE_ID", "str", None,
         "This process's node id.", "core runtime", wiring=True)
_declare("RAY_TPU_NODE_VISIBLE_DEVICES", "str", None,
         "CUDA_VISIBLE_DEVICES of the node that spawned this worker: "
         "its granted GPU ids index this list (unset: the ids are the "
         "cards' own indices).", "core runtime", wiring=True)
_declare("RAY_TPU_JOB_ID", "str", "job-default",
         "Job id stamped on work from this process.", "core runtime",
         wiring=True)
_declare("RAY_TPU_ARENA_NAME", "str", None,
         "Shared-memory arena name workers attach to (native store "
         "backend).", "core runtime", wiring=True)

# ---------------------------------------------------------------------------
# core: fault tolerance (docs/FAULT_TOLERANCE.md)

_declare("RAY_TPU_LINEAGE", "bool", True,
         "Lineage-based object reconstruction (0 = lost objects are "
         "errors, never re-executions).", "fault tolerance")
_declare("RAY_TPU_LINEAGE_BYTES", "int", 64 << 20,
         "Byte budget for retained finished TaskSpecs in the lineage "
         "table.", "fault tolerance")
_declare("RAY_TPU_MAX_RECONSTRUCTION_DEPTH", "int", 16,
         "Max producer-chain depth one reconstruction may re-execute.",
         "fault tolerance")
_declare("RAY_TPU_MAX_RECONSTRUCTIONS", "int", 20,
         "Per-task cap on reconstruction re-runs (repeat-loss "
         "breaker).", "fault tolerance")
_declare("RAY_TPU_RECONSTRUCTION_WAIT_S", "float", 60,
         "How long a reader blocks for a reconstruction it "
         "triggered.", "fault tolerance")
_declare("RAY_TPU_METRICS_INTERVAL_S", "float", 1.0,
         "Telemetry ship interval for workers and node agents "
         "(metrics/spans/events deltas; <= 0 disables).",
         "fault tolerance")
_declare("RAY_TPU_NODE_HEARTBEAT_S", "float", 2.0,
         "Node-agent heartbeat interval (<= 0 disables heartbeats "
         "AND the agent-side driver-silence watchdog).",
         "fault tolerance")
_declare("RAY_TPU_NODE_HEARTBEAT_TIMEOUT_S", "float", 10,
         "Heartbeat silence after which the driver flags "
         "node.heartbeat_miss.", "fault tolerance")
_declare("RAY_TPU_NODE_DEATH_TIMEOUT_S", "float", None,
         "Heartbeat silence after which the driver DECLARES the node "
         "dead without waiting for the socket to close (default: 2x "
         "the heartbeat timeout; 0 disables heartbeat-declared "
         "death).", "fault tolerance")
_declare("RAY_TPU_DRIVER_SILENCE_S", "float", 30,
         "Agent-side mirror of heartbeat-declared death: total driver "
         "silence (no frames, no heartbeat acks) past this long makes "
         "the agent treat the connection as half-open-dead and enter "
         "its rejoin loop instead of parking in recv() for the ~15min "
         "TCP retransmit timeout (<= 0 disables).", "fault tolerance")
_declare("RAY_TPU_NODE_REJOIN_S", "float", 30,
         "Window an agent that lost its driver connection keeps "
         "trying to re-register under a new incarnation "
         "(0 disables).", "fault tolerance")
_declare("RAY_TPU_ACTOR_CHECKPOINT_INTERVAL_S", "float", 0,
         "Cluster-wide default throttle between actor __ray_save__ "
         "checkpoints (per-actor checkpoint_interval_s option wins; "
         "0 = checkpoint after every completed call).",
         "fault tolerance")
_declare("RAY_TPU_PG_INFEASIBLE_GRACE_S", "float", 10,
         "How long a pending placement group may be infeasible "
         "against the live topology before it is declared "
         "impossible.", "fault tolerance")

# ---------------------------------------------------------------------------
# core: peer-to-peer object transfer (docs/OBJECT_TRANSFER.md)

_declare("RAY_TPU_TRANSFER_CHUNK", "int", 4 << 20,
         "Chunk size for peer-to-peer object streaming.",
         "object transfer")
_declare("RAY_TPU_TRANSFER_RETRIES", "int", 3,
         "Pull retry rounds across candidate holders.",
         "object transfer")
_declare("RAY_TPU_TRANSFER_TIMEOUT_S", "float", 20,
         "Socket timeout for one transfer attempt.",
         "object transfer")
_declare("RAY_TPU_TRANSFER_BACKOFF_S", "float", 0.05,
         "Base backoff between pull retry rounds (jittered, "
         "doubling).", "object transfer")
_declare("RAY_TPU_PULL_DEADLINE_S", "float", 30,
         "Total wall-clock budget for one pull across all retries "
         "and holders.", "object transfer")

# ---------------------------------------------------------------------------
# core: control-plane persistence (docs/FAULT_TOLERANCE.md)

_declare("RAY_TPU_STATE_DIR", "str", None,
         "Directory for the GCS WAL + snapshots; setting it makes "
         "driver state durable and enables init(resume=True).",
         "persistence")
_declare("RAY_TPU_WAL_FSYNC", "bool", False,
         "fsync every WAL append (durability over throughput).",
         "persistence")
_declare("RAY_TPU_GCS_SNAPSHOT_INTERVAL_S", "float", 30,
         "Seconds between control-plane snapshots (each rotates the "
         "WAL).", "persistence")
_declare("RAY_TPU_GCS_SNAPSHOT_WAL_BYTES", "int", 32 << 20,
         "WAL size that forces a snapshot before the interval "
         "elapses.", "persistence")
_declare("RAY_TPU_RESUME_REATTACH_GRACE_S", "float", None,
         "How long a resumed driver parks restored remote-held "
         "objects awaiting their agent's reattach before falling "
         "back to lineage reconstruction (default: the rejoin "
         "window).", "persistence")

# ---------------------------------------------------------------------------
# telemetry (docs/OBSERVABILITY.md)

_declare("RAY_TPU_EVENTS", "bool", True,
         "Structured event plane (0 disables all emit()s).",
         "telemetry")
_declare("RAY_TPU_EVENT_BUFFER", "int", 4096,
         "Per-process event ring size between telemetry flushes "
         "(overflow counts surface as events.dropped).", "telemetry")
_declare("RAY_TPU_EVENT_STORE", "int", 16384,
         "Driver-side cluster event store ring size.", "telemetry")
_declare("RAY_TPU_FASTPATH_SPANS", "bool", True,
         "Trace spans on the zero-driver fast paths (direct "
         "worker->worker calls, task leases, compiled-DAG stages); "
         "spans ride the existing telemetry heartbeat, never the "
         "control plane.", "telemetry")
_declare("RAY_TPU_PROFILE_HZ", "float", 0,
         "Always-on sampling profiler rate per worker (stack samples "
         "per second; 0 disables the sampler thread). Can be raised "
         "per worker at runtime via the profile control plane.",
         "telemetry")
_declare("RAY_TPU_PROFILE_MAX_STACKS", "int", 2048,
         "Distinct folded stacks a worker aggregates between "
         "telemetry flushes; overflow collapses into a single "
         "'(overflow)' bucket so profiler memory stays bounded.",
         "telemetry")
_declare("RAY_TPU_PROFILE_DEPTH", "int", 24,
         "Max frames kept per sampled stack (deepest frames beyond "
         "this are truncated).", "telemetry")
_declare("RAY_TPU_WAITS", "bool", True,
         "Wait-state plane (docs/OBSERVABILITY.md): every blocking "
         "edge registers a WaitRecord; the driver folds them into the "
         "cluster wait graph behind `ray_tpu stuck`, hang/deadlock/"
         "straggler detection, and /api/waitgraph. 0 makes park a "
         "no-op and disables the watchdog.", "telemetry")
_declare("RAY_TPU_HANG_PROBE_S", "float", 5.0,
         "Wait-graph watchdog cadence: the driver assembles the "
         "cluster wait graph and probes it for cycles, stale waits, "
         "and collective stragglers this often (<= 0 disables the "
         "watchdog; the wait plane itself stays on).", "telemetry")
_declare("RAY_TPU_HANG_WARN_S", "float", 30.0,
         "Age past which a wait is flagged sched.hang.suspected with "
         "its live root cause attached (deadlock cycles and "
         "straggler detection do not wait for this).", "telemetry")

# ---------------------------------------------------------------------------
# serve plane (docs/SERVING.md)

_declare("RAY_TPU_ENGINE_WATCHDOG_S", "float", 30,
         "LLM engine no-forward-progress watchdog; in-dispatch "
         "stalls get 10x grace for first-use jit compiles "
         "(<= 0 disables).", "serve")
_declare("RAY_TPU_SERVE_HEALTH_PERIOD_S", "float", None,
         "Cluster-wide health-probe period override (unset: each "
         "deployment's health_check_period_s wins; read by "
         "serve/controller.py).", "serve")
_declare("RAY_TPU_SERVE_HEALTH_TIMEOUT_S", "float", None,
         "Cluster-wide health-probe timeout override (read by "
         "serve/controller.py).", "serve")
_declare("RAY_TPU_SERVE_HEALTH_THRESHOLD", "float", None,
         "Cluster-wide consecutive-failure threshold override (read by "
         "serve/controller.py).", "serve")
_declare("RAY_TPU_SERVE_REQUEST_TIMEOUT_S", "float", 60,
         "Per-request budget when the client supplies no deadline "
         "(HTTP X-Serve-Timeout-S; read by serve/config.py for the "
         "HTTP proxy).", "serve")
_declare("RAY_TPU_SERVE_AFFINITY_BOUND", "float", 2.0,
         "Consistent-hash bounded-load factor c: an affinity home "
         "over c*(mean+1) in-flight diverts to the ring walk (read by "
         "serve/router.py).", "serve")
_declare("RAY_TPU_SERVE_AFFINITY_SESSIONS", "int", 4096,
         "Session/prefix bindings kept per handle (LRU beyond it; read "
         "by serve/router.py).", "serve")

# ---------------------------------------------------------------------------
# train plane (docs/FAULT_TOLERANCE.md, elastic gangs)

_declare("RAY_TPU_GANG_PROBE_S", "float", 0.25,
         "Gang supervisor poll interval over the rank actors' GCS "
         "state.", "train")
_declare("RAY_TPU_GANG_REFORM_TIMEOUT_S", "float", 120,
         "Total budget for one gang reform (capacity wait + re-gang "
         "+ join).", "train")
_declare("RAY_TPU_GANG_REPLACE_WAIT_S", "float", 5,
         "How long reform waits for FULL replacement capacity before "
         "settling for a resharded (smaller) world.", "train")
_declare("RAY_TPU_TRAIN_MAX_FAILURES", "int", 8,
         "Gang failures an elastic fit() survives before giving up.",
         "train")
_declare("RAY_TPU_TRAIN_RANK", "int", 0,
         "This rank process's index in the SPMD world.", "train",
         wiring=True)
_declare("RAY_TPU_TRAIN_WORLD", "int", 1,
         "SPMD world size for this rank process.", "train",
         wiring=True)
_declare("RAY_TPU_COORDINATOR", "str", None,
         "Rendezvous address (tcp:// or file://) of a rank "
         "process's torch.distributed world.", "train", wiring=True)

# ---------------------------------------------------------------------------
# data plane

_declare("RAY_TPU_DATA_PREFETCH_DEPTH", "int", 2,
         "device_put_iterator prefetch depth: host batches staged "
         "into device memory ahead of the consumer.", "data")

# ---------------------------------------------------------------------------
# GPU topology

_declare("RAY_TPU_GPUS", "int", None,
         "Local GPU count override (else torch.cuda.device_count() "
         "within CUDA_VISIBLE_DEVICES); 0 forces a node without GPUs.",
         "topology")
_declare("RAY_TPU_NODE_TYPE", "str", None,
         "Autoscaler node-type label this agent registers with.",
         "topology")

# ---------------------------------------------------------------------------
# typed getters


def _resolve(name: str, default: Any) -> Any:
    try:
        spec = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not a declared knob; declare it in "
            "ray_tpu_torch/util/knobs.py (default, type, doc) first") \
            from None
    return spec.default if default is _UNSET else default


def get_raw(name: str) -> Optional[str]:
    """The raw env value ("" treated as unset), or None."""
    _resolve(name, _UNSET)   # declaration teeth
    raw = os.environ.get(name)
    return raw if raw not in (None, "") else None


def get_str(name: str, default: Any = _UNSET) -> Optional[str]:
    raw = os.environ.get(name)
    if raw in (None, ""):
        return _resolve(name, default)
    _resolve(name, default)
    return raw


def get_int(name: str, default: Any = _UNSET) -> Optional[int]:
    fallback = _resolve(name, default)
    raw = os.environ.get(name)
    if raw in (None, ""):
        return fallback
    try:
        return int(raw)
    except ValueError:
        return fallback


def get_float(name: str, default: Any = _UNSET) -> Optional[float]:
    fallback = _resolve(name, default)
    raw = os.environ.get(name)
    if raw in (None, ""):
        return fallback
    try:
        return float(raw)
    except ValueError:
        return fallback


def get_bool(name: str, default: Any = _UNSET) -> bool:
    fallback = _resolve(name, default)
    raw = os.environ.get(name)
    if raw in (None, ""):
        return bool(fallback)
    return raw.strip().lower() not in _FALSEY


def declared(name: str) -> bool:
    return name in REGISTRY


# ---------------------------------------------------------------------------
# docs generation


def _display_default(k: Knob) -> str:
    if k.default is None:
        return "(unset)"
    if k.type == "bool":
        return "1" if k.default else "0"
    return str(k.default)


def render_markdown() -> str:
    """The knob table as markdown
    (`python -m ray_tpu_torch.util.knobs`)."""
    lines: List[str] = [
        "# Configuration knobs",
        "",
        "Every `RAY_TPU_*` environment knob of ray_tpu_torch, "
        "generated from `ray_tpu_torch/util/knobs.py`; unset or "
        "malformed values fall back to the default shown. Knobs "
        "marked *(wiring)* are set by the runtime for its child "
        "processes, not by operators.",
    ]
    order: List[str] = []
    for k in REGISTRY.values():
        if k.subsystem not in order:
            order.append(k.subsystem)
    for subsystem in order:
        lines += ["", f"## {subsystem}", "",
                  "| knob | type | default | description |",
                  "| --- | --- | --- | --- |"]
        for k in REGISTRY.values():
            if k.subsystem != subsystem:
                continue
            doc = k.doc.replace("|", "\\|")
            if k.wiring:
                doc = "*(wiring)* " + doc
            lines.append(f"| `{k.name}` | {k.type} | "
                         f"`{_display_default(k)}` | {doc} |")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the port's named accessors

ENGINE_WATCHDOG_S = "RAY_TPU_ENGINE_WATCHDOG_S"


def engine_watchdog_s() -> float:
    """The LLM engine's no-forward-progress window in seconds (<= 0
    disables the watchdog): RAY_TPU_ENGINE_WATCHDOG_S, default 30; a
    value that is not a number reads as the default."""
    return float(get_float(ENGINE_WATCHDOG_S))


# the launcher's rank block (the reference's train knobs, same names): a
# worker's rank, its world size and the rank-0 rendezvous
TRAIN_RANK = "RAY_TPU_TRAIN_RANK"
TRAIN_WORLD = "RAY_TPU_TRAIN_WORLD"
COORDINATOR = "RAY_TPU_COORDINATOR"


def train_rank() -> int:
    """RAY_TPU_TRAIN_RANK, default 0."""
    return get_int(TRAIN_RANK)


def train_world() -> int:
    """RAY_TPU_TRAIN_WORLD, default 1."""
    return get_int(TRAIN_WORLD)


def coordinator() -> "str | None":
    """RAY_TPU_COORDINATOR, the rendezvous address, default none."""
    return get_raw(COORDINATOR)


DATA_PREFETCH_DEPTH = "RAY_TPU_DATA_PREFETCH_DEPTH"


def data_prefetch_depth() -> int:
    """device_put_iterator's prefetch depth, the host batches staged on
    the device ahead of the consumer: RAY_TPU_DATA_PREFETCH_DEPTH,
    default 2."""
    return get_int(DATA_PREFETCH_DEPTH)


if __name__ == "__main__":
    print(render_markdown(), end="")

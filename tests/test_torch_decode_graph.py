"""The serving engine's decode graphs (models/decode_graph.py).

On the CPU: the page-table widths the engine captures and the keys a
forward is replayed under; which decode steps take a graph (CUDA and
the paged cache only; never a guided, penalised or verify step); and
the engine's plumbing round a graph, with a stand-in that runs the
captured forward again at each replay: tokens equal to the eager
engine's, the model's forward hook once a decode step, the counters of
a replay equal to the eager step's, `set_params` seen by the next
replay, a rebound weight dropping the graphs.

On the card (marker `chip`; they skip without one): real CUDA graphs
on small Llama and Mixtral configurations over the paged cache and K3,
against the eager forward (bf16 logits) and the eager engine (fp32
tokens). Run them there with

    python -m pytest --noconftest -m chip tests/test_torch_decode_graph.py

This file imports no JAX.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import Llama, LlamaConfig, decode_graph
from ray_tpu_torch.models.mixtral import Mixtral, MixtralConfig
from ray_tpu_torch.observability import profiler
from ray_tpu_torch.ops.attention import PagedKV
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig, TokenFSM

ENGINE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
              kv_page_size=4, max_prefill_batch=2, eos_token_id=None)
# (prompt length, new tokens): more requests than slots, so slots join
# and leave; the longest slot grows from 6 to 70 tokens, so the window
# crosses 2, 4, 8, 16 and 32 pages of 4
JOBS = ((3, 30), (4, 20), (5, 40), (6, 64), (40, 30), (12, 50))


def _model(family: str, dtype, device, seed: int = 0):
    if family == "llama":
        return Llama(LlamaConfig.debug(dtype=dtype, param_dtype=dtype),
                     device=device, seed=seed)
    # capacity factor n_experts / k: no token drops, so a row's output
    # does not depend on the rows beside it
    return Mixtral(MixtralConfig.debug(dtype=dtype, param_dtype=dtype,
                                       capacity_factor=2.0),
                   device=device, seed=seed)


def _engine(model, device, graphs: bool = True, **kw):
    engine = LLMEngine(model, None, LLMEngineConfig(**{**ENGINE, **kw}),
                       device=device)
    if not graphs:
        engine._graphs = None     # before any request: every step eager
    return engine


def _serve(engine, jobs, seed: int = 0, **submit):
    """Submit every job on the loop thread at once (so two engines see
    one schedule) and return each request's tokens."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 256, n) for n, _ in jobs]
    rids = []
    engine._run_on_loop(lambda: rids.extend(
        engine.submit(p, max_new_tokens=m, **submit)
        for p, (_, m) in zip(prompts, jobs)))
    return [list(engine.stream(r)) for r in rids]


def _traced(engine, tmp_path, fn):
    """fn()'s result and the counters kept while it ran under a capture
    on the engine's loop thread."""
    profiler.counters(reset=True)
    with profiler.trace(str(tmp_path), engine=engine):
        out = fn()
    return out, profiler.counters(reset=True)


def _hook_decode_steps(model):
    """A forward pre-hook on the model recording the page-table width of
    each call that hands the model the decode graphs; (list, handle)."""
    widths = []

    def hook(module, args, kwargs):
        if kwargs.get("graphs") is not None:
            widths.append(kwargs["cache"][0].page_table.shape[1])

    return widths, model.register_forward_pre_hook(hook, with_kwargs=True)


def _drained(engine, dispatched: int) -> int:
    """The engine's decode steps once it has drained the `dispatched`
    ones: the steps lagging behind the last request's end drain after
    its stream closes."""
    deadline = time.monotonic() + 30
    while (engine.get_stats()["decode_steps"] < dispatched
           and time.monotonic() < deadline):
        time.sleep(0.01)
    return engine.get_stats()["decode_steps"]


def _serve_both(family, device, tmp_path):
    """JOBS on an engine with decode graphs and on one without, both fp32
    under a capture: {graphs: (tokens, counters, drained decode steps,
    the widths the forward hook saw, replays, get_stats()'s
    "decode_graphs", K3's launches, the widths captured, layers)}."""
    from ray_tpu_torch.ops.kernels import paged_attention as k3
    out = {}
    for graphs in (True, False):
        model = _model(family, torch.float32, device)
        engine = _engine(model, device, graphs=graphs)
        widths, handle = _hook_decode_steps(model)
        launches = k3.paged_decode_attention.launches
        try:
            tokens, counts = _traced(engine, tmp_path / str(graphs),
                                     lambda: _serve(engine, JOBS))
            steps = _drained(engine, len(widths) if graphs else
                             counts["llm.decode_eager_steps"])
            replays = engine._graphs.replays if graphs else 0
            state = engine.get_stats()["decode_graphs"]
            captured = len(engine._graph_widths())
        finally:
            handle.remove()
            engine.shutdown()
        out[graphs] = (tokens, counts, steps, widths, replays, state,
                       k3.paged_decode_attention.launches - launches,
                       captured, model.cfg.n_layers)
    return out


def _check_graphed_engine(out, family, device):
    tokens, counts, steps, widths, replays, state, k3, captured, layers = \
        out[True]
    assert tokens == out[False][0]
    assert [len(t) for t in tokens] == [m for _, m in JOBS]
    assert steps >= 64 and steps == len(widths) == replays
    assert state == "captured" and out[False][5] == "off"
    if torch.device(device).type == "cuda":
        # K3 counts where it launches: each capture's side-stream pass
        # and each replay, not the pass under capture
        assert k3 == (replays + captured) * layers
        assert out[False][6] == out[False][2] * layers
    assert set(widths) >= {2, 4, 8, 16, 32}
    assert counts["llm.decode_graph_steps"] == steps
    assert "llm.decode_eager_steps" not in counts
    eager, eager_steps = out[False][1], out[False][2]
    assert eager["llm.decode_eager_steps"] == eager_steps == steps
    assert "llm.decode_graph_steps" not in eager
    for name in ("llm.decode_tokens", "llm.decode_keys", "moe.rows_computed"):
        assert counts.get(name) == eager.get(name), name
    assert (family == "mixtral") == ("moe.rows_computed" in counts)


@pytest.fixture
def stand_in(monkeypatch):
    """Decode graphs on the CPU: `available` says yes, and a "graph" is
    its forward run again at each replay on the static inputs, its
    results written into the outputs of the capture. Returns the list
    of captures made."""
    captures = []

    def capture(fn, pool):
        out = fn()
        captures.append(out)

        def replay():
            with profiler.recording_counts():   # counted from the capture
                (logits, cache), _, _ = fn()
            out[0][0].copy_(logits)
            for old, new in zip(out[0][1], cache):
                old.lengths.copy_(new.lengths)

        return replay, out, pool

    monkeypatch.setattr(decode_graph, "available", lambda device: True)
    monkeypatch.setattr(decode_graph, "_capture_graph", capture)
    return captures


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and K3 run only "
                    "there")
    return torch.device("cuda", 0)


# ---- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("max_seq_len,page,block", [
    (128, 4, 1), (128, 16, 1), (100, 8, 4), (8192, 16, 1)])
def test_graph_widths_cover_every_window(max_seq_len, page, block):
    """The widths captured are the powers of two below the page table's
    width and the table itself (10 at the chat cell's 8192 tokens in
    pages of 16), and every window a decode step can take is one."""
    model = Llama(dataclasses.replace(LlamaConfig.debug(
        dtype=torch.float32), max_seq_len=max_seq_len), device="cpu")
    engine = LLMEngine(model, None, LLMEngineConfig(
        max_slots=2, max_seq_len=max_seq_len, prefill_buckets=(16,),
        kv_page_size=page, decode_block=block), device="cpu")
    try:
        table = engine._pages_per_slot
        widths = engine._graph_widths()
        assert widths == [2 ** i for i in range(table.bit_length())
                          if 2 ** i < table] + [table]
        if (max_seq_len, page) == (8192, 16):
            assert len(widths) == 10
        for held in range(max_seq_len - block + 1):
            engine._disp_len = {0: held}
            window = engine._decode_window_pages(block)
            assert (window or table) in widths
        engine._disp_len = {}
    finally:
        engine.shutdown()


def test_decode_key(monkeypatch):
    """A one-token forward over paged layers sharing one table and one
    lengths tensor is keyed (rows, table width, page size, paged route);
    prefills, several tokens, the contiguous cache, tables that differ
    by layer and a call without positions are not."""
    pool = torch.zeros((40, 2, 16))
    table = torch.zeros((3, 8), dtype=torch.int32)
    lengths = torch.zeros((3,), dtype=torch.int32)
    one, pos = torch.zeros((3, 1), dtype=torch.int32), torch.zeros(
        (3, 1), dtype=torch.int32)
    paged = [PagedKV(pool, pool, table, lengths, 4) for _ in range(2)]
    key = decode_graph.decode_key
    assert key(one, paged, pos) == (3, 8, 4, "auto")
    monkeypatch.setenv("RAY_TPU_PAGED_ATTN_IMPL", "gather")
    assert key(one, paged, pos) == (3, 8, 4, "gather")
    assert key(one, paged, None) is None
    assert key(torch.zeros((3, 2), dtype=torch.int32), paged, pos) is None
    assert key(one, [PagedKV(pool, pool, table, lengths, 4, fresh=True)],
               pos) is None
    assert key(one, [(pool, pool, lengths)], pos) is None
    assert key(one, [paged[0], PagedKV(pool, pool, table.clone(), lengths,
                                       4)], pos) is None


def test_graphs_only_on_cuda_and_the_paged_cache(stand_in, monkeypatch):
    """An engine keeps decode graphs only where they can run: on the CPU
    none; where they are available, the paged cache with a model whose
    forward takes them, and not the contiguous cache."""
    def graphs(device_ok, **kw):
        monkeypatch.setattr(decode_graph, "available",
                            lambda device: device_ok)
        engine = _engine(_model("llama", torch.float32, "cpu"), "cpu", **kw)
        engine.shutdown()
        return engine._graphs

    assert graphs(False) is None
    assert isinstance(graphs(True), decode_graph.DecodeGraphs)
    assert graphs(True, kv_page_size=0) is None

    class NoGraphs(Llama):
        def forward(self, tokens, cache=None, positions=None):
            return super().forward(tokens, cache=cache, positions=positions)

    engine = LLMEngine(NoGraphs(LlamaConfig.debug(dtype=torch.float32),
                                device="cpu"), None,
                       LLMEngineConfig(**ENGINE), device="cpu")
    engine.shutdown()
    assert engine._graphs is None


def test_which_steps_replay(stand_in, tmp_path):
    """A plain step replays; a guided or a penalised step runs the
    forward eagerly, and so does a verify step. The first plain step
    captures every width at once."""
    engine = _engine(_model("llama", torch.float32, "cpu"), "cpu")
    try:
        box = []
        engine._run_on_loop(lambda: box.extend([
            engine._step_graphs(np.ones(1), None),
            engine._step_graphs(None, object())]))
        assert box == [None, None] and not stand_in
        engine._run_on_loop(lambda: box.append(
            engine._step_graphs(None, None)))
        assert box[-1] is engine._graphs
        assert [k[1] for k in engine._graphs.keys()] == \
            engine._graph_widths() == [1, 2, 4, 8, 16, 32]
        assert len(stand_in) == 6
        fsm = TokenFSM.from_choices([[11, 12, 13]], vocab_size=256,
                                    eos_id=255)
        for submit in (dict(guided_fsm=fsm), dict(presence_penalty=1.0),
                       dict(logit_bias={7: 2.0})):
            _, counts = _traced(engine, tmp_path / str(len(box)), lambda:
                                _serve(engine, [(6, 3)], **submit))
            box.append(submit)
            assert counts.get("llm.decode_graph_steps", 0) == 0
            assert counts["llm.decode_eager_steps"] >= 1
        # a plain request replays every decode step, lagged ones too
        before = engine.get_stats()["decode_steps"]
        _, counts = _traced(engine, tmp_path / "plain",
                            lambda: _serve(engine, [(6, 5)], seed=1))
        assert counts["llm.decode_graph_steps"] == \
            engine.get_stats()["decode_steps"] - before >= 4
        assert counts.get("llm.decode_eager_steps", 0) == 0
        assert len(stand_in) == 6      # nothing captured again
    finally:
        engine.shutdown()
    # greedy and repetitive: n-gram proposals, so verify steps
    engine = _engine(_model("llama", torch.float32, "cpu"), "cpu",
                     ngram_speculation=3)
    try:
        rid = []
        engine._run_on_loop(lambda: rid.append(engine.submit(
            np.tile([5, 6, 7, 8], 6), max_new_tokens=12)))
        _, counts = _traced(engine, tmp_path / "spec",
                            lambda: list(engine.stream(rid[0])))
        spec = engine.get_stats()["spec_steps"]
    finally:
        engine.shutdown()
    assert spec > 0
    assert counts["llm.decode_eager_steps"] >= spec


def test_decode_graphs_state_in_stats(stand_in, monkeypatch):
    """get_stats()["decode_graphs"]: "off" on an engine without graphs,
    "pending" before the first plain step and "captured" after it; a
    capture that raises leaves the engine eager, serving the eager
    engine's tokens, with the error in the state."""
    eager = _engine(_model("llama", torch.float32, "cpu"), "cpu",
                    graphs=False)
    try:
        assert eager.get_stats()["decode_graphs"] == "off"
        want = _serve(eager, JOBS[:2])
    finally:
        eager.shutdown()
    engine = _engine(_model("llama", torch.float32, "cpu"), "cpu")
    try:
        assert engine.get_stats()["decode_graphs"] == "pending"
        assert _serve(engine, JOBS[:2]) == want
        assert engine.get_stats()["decode_graphs"] == "captured"
    finally:
        engine.shutdown()

    def fails(fn, pool):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(decode_graph, "_capture_graph", fails)
    engine = _engine(_model("llama", torch.float32, "cpu"), "cpu")
    try:
        assert _serve(engine, JOBS[:2]) == want
        assert engine.get_stats()["decode_graphs"] == \
            "failed: RuntimeError: capture refused"
        assert engine._graphs is None
    finally:
        engine.shutdown()


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_stand_in_graphs_serve_the_eager_tokens(stand_in, tmp_path, family):
    """Over a schedule whose slots join and leave and whose windows cross
    from 2 to 32 pages: the same tokens as the eager engine, every
    decode step replayed (the model's forward hook sees each once), the
    counters of the replays equal to the eager steps'."""
    _check_graphed_engine(_serve_both(family, "cpu", tmp_path), family,
                          "cpu")


def test_set_params_seen_and_a_rebound_weight_drops_graphs(stand_in):
    """Weights copied in by set_params are read by the next replay, with
    no new capture; a weight rebound to other storage drops the graphs
    (that step runs eagerly) and the next step captures again."""
    other = _model("llama", torch.float32, "cpu", seed=1)
    eager = _engine(other, "cpu", graphs=False)
    try:
        want = _serve(eager, JOBS[:2], seed=3)
    finally:
        eager.shutdown()
    engine = _engine(_model("llama", torch.float32, "cpu"), "cpu")
    try:
        first = _serve(engine, JOBS[:2], seed=3)
        assert first != want and len(stand_in) == 6
        engine.set_params(other.state_dict())
        assert _serve(engine, JOBS[:2], seed=3) == want
        assert len(stand_in) == 6
        rebound = {k: v.clone() for k, v in
                   _model("llama", torch.float32, "cpu").state_dict().items()}
        engine._run_on_loop(lambda: engine.model.load_state_dict(
            rebound, assign=True))
        assert _serve(engine, JOBS[:2], seed=3) == first
        assert len(stand_in) == 12
    finally:
        engine.shutdown()


# ---- the card ----------------------------------------------------------------

def _pools(model, n_pages: int, page: int, device, gen):
    cfg = model.cfg
    shape = ((n_pages + 1) * page, cfg.n_kv_heads, cfg.head_dim)
    return [tuple(torch.randn(shape, generator=gen, device=device)
                  .to(cfg.dtype) for _ in range(2))
            for _ in range(cfg.n_layers)]


@pytest.mark.chip
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_card_replay_matches_the_eager_forward(card, family):
    """bf16, pages of 16, 6 rows over 64 steps on random KV: rows join
    and leave (a row that is out points at the trash page at length 0)
    and the window crosses 1, 2, 4 and 8 pages. The capture counts K3's
    launches of its side-stream passes alone. Each step runs the eager
    forward, then the replay, on the same inputs: equal new lengths, the
    same counters, K3 counted a layer each by both; and the rows in's
    logits within bf16's tolerance: against the same weights in fp32
    (its own copy of the pools), the replay's error is the eager
    forward's (cuBLAS may take other kernels under capture, and a bf16
    rounding that differs moves a logit by bf16's precision). The rows
    out write their keys to one trash row, which of them lands is not
    fixed, and they read it: their logits are noise, as an idle slot's
    are in the engine."""
    from ray_tpu_torch.ops.kernels import paged_attention as k3
    torch.manual_seed(0)
    gen = torch.Generator(device=card).manual_seed(0)
    model = _model(family, torch.bfloat16, card).eval()
    fp32 = _model(family, torch.float32, card).eval()
    fp32.load_state_dict(model.state_dict())
    rows, page, table_pages = 6, 16, 8
    trash = rows * table_pages
    pools = _pools(model, trash, page, card, gen)
    fp32_pools = [(k.float(), v.float()) for k, v in pools]
    errors = {"eager": [], "replay": []}
    graphs = decode_graph.DecodeGraphs()
    before = k3.paged_decode_attention.launches
    process_replays = decode_graph.DecodeGraphs.replay.launches
    with torch.no_grad():
        graphs.capture(model, pools, page, rows, [1, 2, 4, 8], trash)
    assert [k[1] for k in graphs.keys()] == [1, 2, 4, 8]
    # a capture counts the launches of its side-stream pass alone, and
    # each replay (below) a forward's
    assert k3.paged_decode_attention.launches - before == \
        4 * model.cfg.n_layers
    own = torch.arange(trash, dtype=torch.int32, device=card).view(
        rows, table_pages)
    seen = set()
    for step in range(64):
        # every 8 steps a third of the rows leave and others join; the
        # longest row ramps from 16 keys to the table's 128
        active = [(r + step // 8) % 3 != 0 for r in range(rows)]
        lengths = torch.tensor([min(127, 2 * step + 3 * r) if a else 0
                                for r, a in enumerate(active)],
                               dtype=torch.int32, device=card)
        table = torch.where(torch.tensor(active, device=card)[:, None], own,
                            trash).int()
        pages = -(-(int(lengths.max()) + 1) // page)
        width = 1 << (pages - 1).bit_length()
        seen.add(width)
        window = table[:, :width].contiguous()
        cache = [PagedKV(k, v, window, lengths, page) for k, v in pools]
        tokens = torch.randint(0, 256, (rows, 1), device=card,
                               dtype=torch.int32)
        positions = lengths[:, None]
        with torch.no_grad():
            launches = k3.paged_decode_attention.launches
            with profiler.recording_counts() as eager_counts:
                logits, new = model(tokens, cache=cache, positions=positions)
            eager_k3 = k3.paged_decode_attention.launches - launches
            with profiler.recording_counts() as replay_counts:
                g_logits, g_new = model(tokens, cache=cache,
                                        positions=positions, graphs=graphs)
            replay_k3 = (k3.paged_decode_attention.launches - launches
                         - eager_k3)
            want, _ = fp32(tokens, cache=[PagedKV(k, v, window, lengths, page)
                                          for k, v in fp32_pools],
                           positions=positions)
        assert torch.equal(g_new[0].lengths, new[0].lengths)
        assert dict(replay_counts) == dict(eager_counts)
        assert replay_k3 == eager_k3 == model.cfg.n_layers
        rows_in = torch.tensor(active, device=card)
        errors["eager"].append((logits - want)[rows_in].abs().flatten())
        errors["replay"].append((g_logits - want)[rows_in].abs().flatten())
    assert graphs.replays == 64 and seen == {1, 2, 4, 8}
    assert decode_graph.DecodeGraphs.replay.launches - process_replays == 64
    eager, replay = (torch.cat(errors[k]) for k in ("eager", "replay"))
    report = (f"error against fp32: eager mean {eager.mean():.3e} max "
              f"{eager.max():.3e}, replay mean {replay.mean():.3e} max "
              f"{replay.max():.3e}")
    assert replay.mean() <= 1.1 * eager.mean(), report
    assert replay.max() <= 2 * eager.max(), report
    print(report)


@pytest.mark.chip
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_card_graphed_engine_serves_the_eager_tokens(card, family, tmp_path):
    """fp32 (TF32 off), pages of 4, the stand-in test's schedule on real
    graphs: the eager engine's tokens, every decode step replayed and
    seen once by the model's forward hook, the replays' counters equal
    to the eager steps'."""
    assert not torch.backends.cuda.matmul.allow_tf32
    _check_graphed_engine(_serve_both(family, card, tmp_path), family,
                          card)


@pytest.mark.chip
def test_card_set_params_seen_by_the_next_replay(card):
    """fp32: after set_params the graphed engine serves what an eager
    engine on the new weights serves, with the graphs captured before."""
    other = _model("llama", torch.float32, card, seed=1)
    eager = _engine(other, card, graphs=False)
    try:
        want = _serve(eager, JOBS[:2], seed=3)
    finally:
        eager.shutdown()
    engine = _engine(_model("llama", torch.float32, card), card)
    try:
        assert _serve(engine, JOBS[:2], seed=3) != want
        graphs = engine._graphs
        before = graphs.replays
        engine.set_params(other.state_dict())
        assert _serve(engine, JOBS[:2], seed=3) == want
        assert engine._graphs is graphs and graphs.captured
        assert graphs.replays > before
    finally:
        engine.shutdown()

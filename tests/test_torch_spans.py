"""The spans and counters of ``utils/profiling.py`` on the CPU.

Off (no collector, every end-to-end run), a Trainer step is the same bit
for bit as with them on, records nothing and puts no node in the autograd
graph. The spans are nested host events of a CPU ``torch.profiler`` trace.
On, ``Trainer.time_parts`` holds the step's spans, ``host_serial`` from the
second step on, and the MoE counters, which equal a count of the same
routing by expert capacity (remat on and off: the recompute counts
nothing). A device region's backward interval opens after the
checkpoint's recompute (CUDA events replaced by a host tally).
``generate_grouped`` yields its prefill, decode and read spans.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, generate_grouped, init_params
from dynamictreeattn_tpu_torch.models import qwen3
from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer
from dynamictreeattn_tpu_torch.utils import profiling
from dynamictreeattn_tpu_torch.utils.profiling import span

from helpers import random_trie_batch

tgen = sys.modules["dynamictreeattn_tpu_torch.models.generate"]

# drops at capacity 0.75, none at 1.5 (the default)
MOE = dataclasses.replace(MODEL_CONFIGS["qwen3-moe-tiny"], moe_capacity_factor=0.75)
DENSE = MODEL_CONFIGS["qwen3-tiny"]
PREPARE = ("prepare.partition", "prepare.trie", "prepare.flatten", "prepare.meta", "prepare.upload")
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _nothing_collects():
    """Every test starts and ends with no collector."""
    profiling.collect(None)
    yield
    profiling.collect(None)


def _batches(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [random_trie_batch(rng, n_seqs=8, vocab=vocab, max_len=20) for _ in range(n)]


def _trainer(config, remat=False, params=None):
    ec = EngineConfig(block_q=32, block_kv=32, remat=remat, attn_backend="reference", loss_mode="vocab")
    tr = Trainer(config, ec, TrainConfig(learning_rate=1e-3, param_dtype="fp32"), device="cpu")
    if params is None:
        tr.init(seed=0)
    else:
        tr.set_params(params)
    return tr


def _host_events(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("config", [DENSE, MOE], ids=["dense", "moe"])
def test_parts_change_no_number_and_off_record_nothing(config):
    """Two steps with the parts off and on leave the same params bit for
    bit and the same losses; off, nothing collects and no part is kept."""
    off = _trainer(config)
    on = _trainer(config, params=off.params)
    on.time_parts = True
    for seqs, attachs in _batches(2, config.vocab_size):
        rec_on = on.train_step(seqs, attachs)
        assert profiling.collecting() is on._parts
        on.time_parts = False
        rec_off = off.train_step(seqs, attachs)
        on.time_parts = True
        assert rec_on["loss"] == rec_off["loss"]
    assert off.last_parts_ms is None and not off.time_parts
    for a, b in zip(_leaves(off.params), _leaves(on.params)):
        assert torch.equal(a, b)
    on.time_parts = False
    assert profiling.collecting() is None


def _leaves(tree):
    return [t for v in tree.values() for t in (_leaves(v) if isinstance(v, dict) else [v])]


def _graph_nodes(loss) -> list[str]:
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


def _moe_layer_loss():
    c = MOE
    params = init_params(c, torch.Generator().manual_seed(0), dtype=torch.float32)
    lp = {name: w[0].detach().requires_grad_() for name, w in params["layers"].items()}
    x = torch.randn(40, c.hidden_size, generator=torch.Generator().manual_seed(1), requires_grad=True)
    pos = torch.arange(40)
    cos, sin = qwen3.rope_tables(pos, c.head_dim, c.rope_theta, c.rope_scaling_tuple)

    def attn(q, k, v):
        return torch.softmax(q @ k.repeat_interleave(q.shape[0] // k.shape[0], 0).transpose(1, 2), -1) @ \
            v.repeat_interleave(q.shape[0] // v.shape[0], 0)

    y, lb = qwen3._layer(x, lp, cos, sin, c, attn)
    return y.sum() + lb


def test_off_adds_no_autograd_node(monkeypatch):
    """Off, a MoE layer's graph has the nodes of the layer without any
    region (``device_region`` replaced by a bare call) and no mark; a card's
    collector adds the two marks."""
    names = _graph_nodes(_moe_layer_loss())
    monkeypatch.setattr(qwen3, "device_region", lambda name, fn, x: fn(x))
    assert sorted(_graph_nodes(_moe_layer_loss())) == sorted(names)
    assert not any("Mark" in n for n in names)
    monkeypatch.undo()
    monkeypatch.setattr(profiling.Parts, "_event", staticmethod(lambda: _FakeEvent([])))
    profiling.collect(profiling.Parts(device_events=True))
    marked = _graph_nodes(_moe_layer_loss())
    assert sum("Mark" in n for n in marked) == 2 and len(marked) == len(names) + 2


def test_parts_lose_no_addition_across_threads():
    """Autograd's threads add to the one Parts under its lock: 16 threads
    at a short switch interval lose no addition."""
    parts = profiling.Parts(device_events=False)
    one = torch.ones((), dtype=torch.int64)

    def work():
        for _ in range(500):
            parts.add_host("h", 1.0)
            parts.count("c", one)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert int(parts.take_counts()["c"]) == 8000 and parts.take()["h"] == 8000.0


def test_spans_are_nested_host_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer.a"):
            torch.ones(3).sum()
            with span("inner.b"):
                torch.ones(3).mul(2)
    ev = {name: (s, e) for name, s, e in _host_events(prof)}
    assert ev["outer.a"][0] <= ev["inner.b"][0] <= ev["inner.b"][1] <= ev["outer.a"][1]
    mul = next((s, e) for name, s, e in _host_events(prof) if name == "aten::mul")
    assert ev["inner.b"][0] <= mul[0] <= mul[1] <= ev["inner.b"][1]


def test_a_traced_step_holds_its_spans():
    """A MoE Trainer step under a CPU trace, parts off: the prepare, step
    and MoE spans are host events, the MoE spans inside "step.launch"."""
    tr = _trainer(MOE)
    seqs, attachs = _batches(1, MOE.vocab_size)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(seqs, attachs)
    events = _host_events(prof)
    names = {name for name, _, _ in events}
    assert set(PREPARE + ("step.launch", "step.read", "step.record") + MOE_SPANS) <= names
    launch = next((s, e) for name, s, e in events if name == "step.launch")
    for name, s, e in events:
        if name.startswith("moe."):
            assert launch[0] <= s <= e <= launch[1]


def test_time_parts_hold_the_spans_and_host_serial():
    """On the CPU: no device part; "host_serial" from the second step on;
    its children ("step.record" of the step before, "prepare.*") sum to no
    more than it, the MoE spans to no more than "step.launch"."""
    tr = _trainer(MOE)
    tr.time_parts = True
    parts = []
    for seqs, attachs in _batches(3, MOE.vocab_size):
        tr.train_step(seqs, attachs)
        parts.append(dict(tr.last_parts_ms))
    assert "host_serial" not in parts[0] and "step.record" not in parts[0]
    for p in parts:
        assert set(PREPARE + ("step.launch", "step.read") + MOE_SPANS) <= set(p)
        assert not {"engine", "clip", "adamw", "moe"} & set(p)
        assert sum(p[name] for name in MOE_SPANS) <= p["step.launch"]
    for p in parts[1:]:
        assert p["host_serial"] > 0
        assert p["step.record"] + sum(p[name] for name in PREPARE) <= p["host_serial"]


class _FakeEvent:
    """A CUDA event's stand-in: the host tally of its record."""

    clock = 0

    def __init__(self, log):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock
        log.append(self)

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_counters_equal_the_capacity_count(monkeypatch, remat):
    """"moe.pairs" / "moe.dropped" after one step equal a count of the
    step's routing by expert capacity (Σ_e n_e, Σ_e max(0, n_e − capacity)
    over the forward's pack_pairs calls), with remat on and off: the
    recompute calls pack_pairs again and counts nothing."""
    calls = []
    real = qwen3.pack_pairs

    def recording(idx, buckets, capacity):
        calls.append((idx.clone(), buckets, capacity))
        return real(idx, buckets, capacity)

    monkeypatch.setattr(qwen3, "pack_pairs", recording)
    tr = _trainer(MOE, remat=remat)
    tr.time_parts = True
    tr.train_step(*_batches(1, MOE.vocab_size, seed=3)[0])
    L = MOE.num_hidden_layers
    assert len(calls) == (2 * L if remat else L)
    pairs = dropped = 0
    for idx, E, cap in calls[:L]:
        n_e = torch.bincount(idx[(idx >= 0) & (idx < E)], minlength=E)
        pairs += int(n_e.sum())
        dropped += int(torch.clamp(n_e - cap, min=0).sum())
    parts = tr.last_parts_ms
    assert (parts["moe.pairs"], parts["moe.dropped"]) == (pairs, dropped)
    assert 0 < dropped < pairs


def test_region_backward_opens_after_the_recompute(monkeypatch):
    """A MoE step with remat under a card's collector (events faked): three
    intervals a layer (forward, recompute, backward), the backward's
    opening after the recompute's close, and the "moe" part their sum."""
    log = []
    monkeypatch.setattr(profiling.Parts, "_event", staticmethod(lambda: _FakeEvent(log)))
    parts = profiling.Parts(device_events=True)
    profiling.collect(parts)
    tr = _trainer(MOE, remat=True)
    batch, _ = tr.prepare_step(*_batches(1, MOE.vocab_size, seed=4)[0])
    loss, _, _ = tr._step_fn.engine.loss_and_grad(tr.params, batch.batches[0])
    intervals = list(parts._intervals)
    L = MOE.num_hidden_layers
    assert len(intervals) == 3 * L
    fwd, rest = intervals[:L], intervals[L:]
    assert all(a.t < b.t for _, a, b in intervals)
    # backward: layer L-1 first; each layer's recompute closes before its backward opens
    for i in range(L):
        recompute, backward = rest[2 * i], rest[2 * i + 1]
        assert recompute[2].t < backward[1].t
    assert max(b.t for _, _, b in fwd) < min(a.t for _, a, _ in rest)
    assert parts.take()["moe"] == sum(float(b.t - a.t) for _, a, b in intervals)


def test_generate_grouped_spans(monkeypatch):
    """On the CPU (no graph, so no capture): prefill, decode, read, in that
    order, and every one of the max_new - 1 decode steps inside the
    decode span."""
    c = DENSE
    params = init_params(c, torch.Generator().manual_seed(0), dtype=torch.float32)
    prompts = np.random.default_rng(5).integers(1, c.vocab_size, size=(2, 6)).astype(np.int32)
    real = tgen._decode_step_grouped

    def step(*args, **kwargs):
        with span("probe.step"):
            return real(*args, **kwargs)

    monkeypatch.setattr(tgen, "_decode_step_grouped", step)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate_grouped(params, c, prompts, np.array([6, 4], np.int32), 2, 5, greedy=True)
    events = _host_events(prof)
    order = [name for name, _, _ in sorted(events, key=lambda e: e[1]) if name.startswith("generate.")]
    assert order == ["generate.prefill", "generate.decode", "generate.read"]
    decode = next((s, e) for name, s, e in events if name == "generate.decode")
    steps = [(s, e) for name, s, e in events if name == "probe.step"]
    assert len(steps) == 4 and all(decode[0] <= s <= e <= decode[1] for s, e in steps)

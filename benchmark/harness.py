"""The harness: finds a cell's files by name, sets up the run, reads device
traces, and prints the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
named in its ``configs`` entry) and a traffic mix (``traffic/<name>.json``),
whose ``entry`` names the driver (``drivers/<entry>.py``, a ``run(ctx)``
that returns a ``Run``); each per-layer metric is a reader
(``metrics/<name>.py``, a ``read(run)`` that returns a number or None) and
each cell's limits of the numbers that decide ``correct`` are in
``limits/<cell>.json``. A later cell or metric only adds such files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamictreeattn_tpu")
TOP_OPS = 10


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_env() -> None:
    """Caches inside the checkout at fixed paths; libraries kept off JAX."""
    cache = ROOT / ".bench_cache"
    for key, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[key] = str(cache / sub)
    for key in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[key] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # the workloads entry
    cfg: dict  # the configuration file
    mix: dict  # the traffic file
    limits: dict  # {number: limit}
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def reports(metric: dict, cell: str) -> bool:
    """A metric with no ``workloads`` is read in every cell; its reader
    returns nothing where it finds nothing to read."""
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or, for a quantity split by the end-to-end
    metric it moves (``<quantity>.<kind>``), ``metrics/<quantity>.py``."""
    own = BENCH / "metrics" / f"{name}.py"
    return own if own.is_file() or "." not in name else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, spec, load_json(root / conf["file"]), load_json(BENCH / "traffic" / f"{spec['traffic']}.json"),
                load_json(BENCH / "limits" / f"{name}.json"), e2e, layer)


def port_config(cfg: dict):
    """The port's ``Qwen3Config`` of a configuration file."""
    from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config

    assumed = cfg.get("assumed", {})
    kw = dict(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
              num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
              num_key_value_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
              rms_norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
              tie_word_embeddings=cfg["tie_word_embeddings"], use_qk_norm=True,
              attention_bias=cfg.get("attention_bias", False))
    if cfg.get("num_experts", 0):
        kw.update(num_experts=cfg["num_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
                  moe_intermediate_size=cfg["moe_intermediate_size"], norm_topk_prob=cfg["norm_topk_prob"],
                  router_aux_coef=cfg["router_aux_loss_coef"], moe_capacity_factor=assumed["moe_capacity_factor"])
    if cfg.get("rope_scaling") is not None:
        raise ValueError("rope scaling is not mapped")
    return Qwen3Config(**kw)


class Ctx:
    """What a driver gets: the cell, the run's arguments and device, and the
    set-up clock (started when the process started its work)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float):
        self.cell, self.seed, self.seconds, self.trace, self.device = cell, seed, seconds, trace, device
        self.cfg, self.mix, self.t0 = cell.cfg, cell.mix, t0
        self.setup_s = None

    def sync(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t0


@dataclasses.dataclass
class Run:
    """A run's record for the metric readers."""

    cfg: dict
    mix: dict
    units: list  # one dict per unit of work in the window (a step or a rollout)
    traces: list  # one Trace per traced unit
    e2e: dict  # end-to-end values
    checks: dict  # {number: (value, limit)}
    attempted: int
    failed: int
    memory_peak_bytes: int = 0
    cache: dict = dataclasses.field(default_factory=dict)

    def untraced(self) -> list:
        return [u for u in self.units if not u.get("traced")]

    def batch_work(self, b: int) -> tuple[int, int]:
        """(trie tokens, visible pairs) of the training pool's batch b."""
        from work import trie_work

        key = ("work", b)
        if key not in self.cache:
            self.cache[key] = trie_work(self.cache["pool"][b][0])
        return self.cache[key]

    def kernel_share(self, time_tags, bound_of) -> float | None:
        """Percent of the roofline over the traced units: the sum of
        bound_of(trace) (seconds) over the device time of the kernels whose
        names hold one of `time_tags`; None where none ran."""
        bound = busy = 0.0
        for tr in self.traces:
            ks = [k for k in tr.device if any(tag in k[0] for tag in time_tags)]
            if ks:
                bound += bound_of(tr)
                busy += sum(e - s for _, s, e in ks) / 1e9
        return 100.0 * bound / busy if busy > 0 else None

    def idle_share(self) -> float | None:
        """Percent of a unit's untraced wall time in which no device
        operation ran: 1 - the traced units' busy time (the union of their
        device intervals) over the median wall time of the untraced units
        of the same work (``unit["work"]``), so that the profiler's own host
        cost stays out; None where a traced unit has no untraced twin."""
        busy = wall = 0.0
        for tr in self.traces:
            twins = [u["wall_s"] for u in self.untraced() if u.get("work") == tr.unit.get("work")]
            if not twins:
                return None
            busy += tr.busy_ns() / 1e9
            wall += statistics.median(twins)
        return 100.0 * (1 - busy / wall) if wall else None


# --------------------------------------------------------------------- traces


@dataclasses.dataclass
class Trace:
    """One traced unit: its device operations [(name, start_ns, end_ns)], the
    host's events, and the unit's window on the same clock."""

    device: list
    host: list
    window: tuple
    unit: dict

    def busy_ns(self) -> int:
        return union_ns([(s, e) for _, s, e in self.device], self.window)

    def kernels(self, tag: str) -> list:
        return [(n, s, e) for n, s, e in self.device if tag in n]


def union_ns(intervals, window) -> int:
    """Length of the union of intervals, clipped to the window."""
    lo, hi = window
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def idle_gaps(intervals, window) -> list:
    """[(start, end)] of the window's stretches with no device operation."""
    lo, hi = window
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    return [(s, e) for s, e in gaps if e > s]


UNIT_SPAN = "bench.unit"


def profiled(fn):
    """(result, Trace) of fn() under torch.profiler; the unit's window is a
    host span around it. A trace with no device operation is an error."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(UNIT_SPAN):
            out = fn()
            torch.cuda.synchronize()
    # a host span's device-side copy (a "gpu_user_annotation") is no device operation
    return out, collect((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.device_type() == DeviceType.CUDA)
                        for e in prof.profiler.kineto_results.events()
                        if not (e.device_type() == DeviceType.CUDA and e.name() == UNIT_SPAN))


def collect(events) -> Trace:
    """A Trace of (name, start_ns, end_ns, on_device) events, the unit's
    window from its span; no device operation or no span is an error."""
    device, host, window = [], [], None
    for name, s, e, on_device in events:
        if on_device:
            device.append((name, s, e))
        elif name == UNIT_SPAN:
            window = (s, e)
        else:
            host.append((name, s, e))
    if window is None or not device:
        raise RuntimeError(f"the profiler traced {len(device)} device operations and "
                           f"{'no' if window is None else 'a'} unit span: device time not measured")
    return Trace(device, host, window, {})


def breakdown(traces: list) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by the innermost host event under way at their middle."""
    import numpy as np

    by_op: dict = {}
    for tr in traces:
        for name, s, e in tr.device:
            by_op[name] = by_op.get(name, 0) + (e - s)
    by_host: dict = {}
    for tr in traces:
        gaps = sorted(idle_gaps([(s, e) for _, s, e in tr.device], tr.window), key=lambda g: g[0] - g[1])[:500]
        if not tr.host:
            continue
        starts = np.array([s for _, s, _ in tr.host])
        ends = np.array([e for _, _, e in tr.host])
        for gs, ge in gaps:
            mid = (gs + ge) // 2
            under = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = tr.host[under[np.argmax(starts[under])]][0] if len(under) else "(no host event)"
            by_host[label] = by_host.get(label, 0) + (ge - gs)
    top = lambda d: [[k[:160], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP_OPS]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def layer_times(traces: list) -> dict:
    """Seconds of device operations by layer (``work.kernel_layer``), summed
    over the traced units, largest first."""
    from work import kernel_layer

    out: dict = {}
    for tr in traces:
        for name, s, e in tr.device:
            out[kernel_layer(name)] = out.get(kernel_layer(name), 0) + (e - s) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# --------------------------------------------------------------------- result


def device_info(device: str, chips: int) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"


def result_line(cell: Cell, run: Run, trace: bool, device: dict, readers: dict) -> dict:
    """The result object; "checks" comes last."""
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    correct = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = readers[m["name"]](run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    dev = dict(device, memory_peak_bytes=run.memory_peak_bytes)
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = sum(t.busy_ns() for t in run.traces) / 1e9
        dev["window_s"] = sum(t.window[1] - t.window[0] for t in run.traces) / 1e9
        out["breakdown"] = breakdown(run.traces)
    out["checks"] = checks
    return out

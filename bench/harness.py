"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

  the cell        an entry of ``workloads``: a configuration and a traffic;
  configuration   ``configs[].file`` (JSON): the network, its sizes, the
                  compute mode, the planner's and the tier's settings, the
                  pool of images and the limit of the check;
  reference       ``bench/reference/<network>.py``: the frozen copy of the
                  network, run by ``bench/reference/ops.py``;
  layer kinds     ``bench/reference/kinds/<kind>.py`` for each kind of the
                  network that ``ops.py`` does not build in (``Cell.kinds``);
  traffic         ``bench/traffic/<traffic>.json``, read by ``generator.py``;
  metrics         ``bench/metrics/<metric>.py``, one reader each, for the
                  end-to-end metrics that apply to the cell (trace 0) or
                  its per-layer metrics (trace 1).

A run: draw weights and images from the seed, ``synthesize`` the program,
build a ``ReplicaSet``, warm every bucket the tier can release, drive the
window, wait for every answer, read the peak memory, free the program, run
the reference over the pool and compare every answer of the window with it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import inputs
from bench.generator import ANSWERED, SHED, Generator, Log, Traffic
from bench.profiling import DeviceWindow, Profiler
from bench.reference.ops import Kinds, forward, param_shapes

ROOT = Path(__file__).resolve().parents[1]
#: How long after the window's close an answer may still come.
DRAIN_S = 60.0
CALIBRATION_IMAGES = 16
#: The traced run's profiled phase after the window: its first seconds,
#: while the closed loop fills, and its device window.
PROFILE_SETTLE_S, PROFILE_S = 0.5, 3.0


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        spec = json.loads((root / "BENCHMARK.json").read_text())
        w = _by_name(spec["workloads"], name, "workload")
        cfg = _by_name(spec["configs"], w["config"], "config")
        e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        per_layer = [m for m in spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m
                         else m["moves"] in moved)]
        return cls(name, json.loads((root / cfg["file"]).read_text()),
                   json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text()),
                   e2e, per_layer, root)

    def reference(self):
        net = self.config["network"]
        return _load_module(self.root / "bench" / "reference" / f"{net}.py",
                            f"bench.reference.{net}")

    def kinds(self) -> Kinds:
        """The layer kinds of this cell's checkout."""
        return Kinds(self.root)

    def reader(self, metric: str):
        return _load_module(self.root / "bench" / "metrics" / f"{metric}.py",
                            "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def _tier_stats(tier) -> Dict[str, object]:
    batches = completed = padded = 0
    buckets: Dict[int, int] = {}
    for r in tier.replicas:
        s = r.server.stats
        batches, completed, padded = batches + s.batches, completed + s.completed, \
            padded + s.padded_slots
        for b, n in s.bucket_counts.items():
            buckets[b] = buckets.get(b, 0) + n
    return {"batches": batches, "completed": completed, "padded_slots": padded,
            "bucket_counts": buckets}


def _stats_diff(a: dict, b: dict) -> dict:
    out = {k: b[k] - a[k] for k in ("batches", "completed", "padded_slots")}
    out["bucket_counts"] = {k: v - a["bucket_counts"].get(k, 0)
                            for k, v in b["bucket_counts"].items()
                            if v - a["bucket_counts"].get(k, 0)}
    return out


def host_counters(threads: Dict[str, int]) -> Dict[str, float]:
    """The process's CPU seconds, and each named thread's where ``/proc``
    gives them: with the answers, they tell a slower host from a busier
    one."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": r.ru_utime + r.ru_stime}
    tick = os.sysconf("SC_CLK_TCK")
    for name, tid in threads.items():
        try:
            f = Path(f"/proc/self/task/{tid}/stat").read_text().rsplit(")", 1)[1].split()
            out[f"{name}.cpu_s"] = (int(f[11]) + int(f[12])) / tick
        except (OSError, IndexError, ValueError):
            pass
    return out


def host_delta(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """``host_counters`` over the window."""
    return {k: v - a[k] for k, v in b.items() if k in a}


def _sleep_until(t: float) -> None:
    wait = t - time.perf_counter()
    if wait > 0:
        time.sleep(wait)


@dataclass
class Run:
    """What the metric readers read: one window of one cell."""
    cell: Cell
    seed: int
    seconds: float
    t0: float
    t_end: float
    log: Log                            # every request sent in the window
    lateness: List[float]
    stats: dict                         # the tier's counters over the window
    setup_s: float = 0.0
    synth_s: float = 0.0
    stage_d_s: float = 0.0
    spans: list = field(default_factory=list)
    device: Optional[DeviceWindow] = None                   # the profiled phase's
    routing: Dict[str, str] = field(default_factory=dict)   # layer -> impl
    layers: list = field(default_factory=list)
    input_shape: Tuple[int, ...] = ()
    kinds: Optional[Kinds] = None       # the layers' kinds (Cell.kinds)
    gc_pauses: List[float] = field(default_factory=list)    # full collections, s
    host: Dict[str, float] = field(default_factory=dict)    # host_delta over the window

    def count(self, *states: int) -> int:
        return sum(1 for s in self.log.state if s in states)

    @property
    def completed_in_window(self) -> int:
        log = self.log
        return sum(1 for s, t in zip(log.state, log.t_done) if s == ANSWERED and t <= self.t_end)

    def latencies(self) -> List[float]:
        """Seconds from due or send time to the answer, every request sent
        in the window; a shed or failed request is infinitely late."""
        log = self.log
        return [t - r if s == ANSWERED else math.inf
                for s, r, t in zip(log.state, log.t_ref, log.t_done)]

    def answers(self) -> List[Tuple[int, np.ndarray]]:
        """(pool index, answer) of every request answered with a result."""
        log = self.log
        return [(i, a) for s, i, a in zip(log.state, log.pool_index, log.answer)
                if s == ANSWERED]

    def spans_named(self, name: str) -> list:
        """The spans of that name that start in the window."""
        return [s for s in self.spans if s.name == name and self.t0 <= s.t_start < self.t_end]


class Session:
    """The set-up of one run: weights, program, tier, warm buckets, pool."""

    def __init__(self, cell: Cell, seed: int, *, device: str = "cuda",
                 trace: bool = False, mode: Optional[str] = None):
        from repro_torch.cnn import WORKLOADS
        from repro_torch.core import PlannerConfig, synthesize
        from repro_torch.core.precision import ComputeMode
        from repro_torch.obs import Tracer
        from repro_torch.serving import ReplicaSet, ServingConfig, warm_replicas

        cfg = self.config = cell.config
        self.cell, self.seed, self.device_name = cell, seed, device
        hw, classes, scale = cfg["input_hw"], cfg["num_classes"], cfg.get("scale", 1.0)
        self.input_shape = (3, hw, hw)
        self.layers = cell.reference().layers(scale=scale, num_classes=classes)
        self.kinds = cell.kinds()
        gen = inputs.generator(seed, device)
        params = inputs.draw_weights(gen, self.layers, self.input_shape, device, self.kinds)
        pool = inputs.draw_images(gen, cfg["pool_images"], self.input_shape, device)
        calib = inputs.draw_images(gen, CALIBRATION_IMAGES, self.input_shape, device)
        self.images = pool.cpu().numpy()
        del pool
        self.mode = ComputeMode(mode or cfg["mode"])
        net = WORKLOADS[cfg["network"]](scale=scale, num_classes=classes, input_hw=hw)
        self.tracer = Tracer() if trace else None
        self.program = synthesize(
            net, params, device=cfg["planner"]["device"],
            planner_config=PlannerConfig(**{k: v for k, v in cfg["planner"].items()
                                            if k != "device"}),
            forced_mode=self.mode, tracer=self.tracer,
            autotune_input=calib if self.mode is ComputeMode.IMPRECISE_INT8 else None)
        del params, calib
        self.routing = {n: self.program.plan.for_layer(n).impl
                        for n, *_ in param_shapes(self.layers, self.input_shape, self.kinds)}
        self.tier = ReplicaSet(self.program, config=ServingConfig(**cfg["serving"]),
                               tracer=self.tracer)
        self.stage_d_s = sum(warm_replicas(self.tier))
        self.tier.start()
        # The tier's own path at every bucket it can release, on real images.
        b = 1
        while b <= self.tier.config.max_batch:
            futures = [self.tier.submit(self.images[i % len(self.images)]) for i in range(b)]
            for f in futures:
                f.result(DRAIN_S)
            b *= 2

    def window(self, traffic: dict, seconds: float, seed: int, *,
               profile: bool = False) -> Run:
        """The measured window; with ``profile``, then a short phase of the
        same traffic under the profiler (:meth:`profiled_phase`)."""
        submit = self.tier.submit
        if self.tracer is not None:
            tracer, inner = self.tracer, submit

            def submit(image):
                with tracer.span("bench.submit"):
                    return inner(image)
        n_pool = len(self.images)
        order = inputs.pool_order(seed, n_pool, n_pool * 16)
        t0 = time.perf_counter() + 0.05
        t_end = t0 + seconds
        pauses, began = [], []

        def on_gc(phase, info):         # full collections, for the notes
            if info["generation"] == 2:
                if phase == "start":
                    began[:] = [time.perf_counter()]
                elif began:
                    pauses.append(time.perf_counter() - began[0])

        gc.callbacks.append(on_gc)
        gen = self._drive(submit, traffic, order, t0, seconds, seed)
        threads = {t.name: t.native_id for t in threading.enumerate()}
        _sleep_until(t0)
        before, host0 = _tier_stats(self.tier), host_counters(threads)
        _sleep_until(t_end)
        after, host1 = _tier_stats(self.tier), host_counters(threads)
        self._settle(gen, t_end)
        gc.callbacks.remove(on_gc)
        device = self.profiled_phase(submit, traffic, order, seed) if profile else None
        return Run(self.cell, seed, seconds, t0, t_end, gen.log, gen.lateness,
                   _stats_diff(before, after), synth_s=self.program.synthesis_seconds,
                   stage_d_s=self.stage_d_s,
                   spans=self.tracer.finished() if self.tracer is not None else [],
                   device=device, routing=dict(self.routing), layers=self.layers,
                   input_shape=self.input_shape, kinds=self.kinds, gc_pauses=pauses,
                   host=host_delta(host0, host1))

    def profiled_phase(self, submit, traffic: dict, order, seed: int) -> Optional[DeviceWindow]:
        """``PROFILE_SETTLE_S + PROFILE_S`` seconds of the same traffic after
        the window, with the profiler started before it and stopped after
        its last answer, both while the tier is idle: started or stopped
        while the tier launched graphs, it hung 2 of 14 traced runs.  The
        device window is the phase less its first ``PROFILE_SETTLE_S``."""
        prof = Profiler()
        prof.start()
        t0 = time.perf_counter() + 0.05
        length = PROFILE_SETTLE_S + PROFILE_S
        self._settle(self._drive(submit, traffic, order, t0, length, seed), t0 + length)
        return prof.stop(t0 + PROFILE_SETTLE_S, t0 + length)

    def _drive(self, submit, traffic: dict, order, t0: float, seconds: float,
               seed: int) -> Generator:
        from repro_torch.serving import LoadShedError
        return Generator(submit, LoadShedError, Traffic.from_dict(traffic), self.images,
                         order, t0, seconds, seed, DRAIN_S).start()

    @staticmethod
    def _settle(gen: Generator, t_end: float) -> None:
        """Wait for the generator and for every answer still out."""
        if not gen.join(t_end - time.perf_counter() + DRAIN_S + 5.0):
            raise RuntimeError("the traffic generator did not finish")
        if gen.error is not None:
            raise gen.error
        gen.finish(t_end + DRAIN_S)

    def close(self) -> None:
        """Stop the tier and free the program."""
        self.tier.stop(drain=True)
        del self.tier, self.program
        gc.collect()
        if self.device_name != "cpu":
            torch.cuda.empty_cache()


def reference_logprobs(cell: Cell, seed: int, images: np.ndarray, device: str,
                       precision: Optional[str] = None, block: int = 32) -> torch.Tensor:
    """The reference's log-probabilities of every pool image, from weights
    drawn again from the seed, at ``precision`` (by default the one the
    configuration states); float64 on ``device``."""
    cfg = cell.config
    layers = cell.reference().layers(scale=cfg.get("scale", 1.0),
                                      num_classes=cfg["num_classes"])
    shape = (3, cfg["input_hw"], cfg["input_hw"])
    kinds = cell.kinds()
    params = inputs.draw_weights(inputs.generator(seed, device), layers, shape, device, kinds)
    precision = precision or cfg["check"]["reference_precision"]
    out = [forward(layers, params, torch.from_numpy(images[i:i + block]).to(device), precision,
                   kinds)
           for i in range(0, len(images), block)]
    return torch.cat(out)


def _centered(logp: torch.Tensor) -> torch.Tensor:
    """Log-probabilities less their mean over the classes: the logits up to
    the constant that a softmax ignores."""
    return logp - logp.mean(dim=1, keepdim=True)


def answer_errors(run: Run, ref: torch.Tensor, yardstick: torch.Tensor,
                  block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every answered request of the window: the squared error of its
    logits, recovered from the served probabilities up to the softmax's
    constant, against the reference's, summed over the classes; and the
    same for the yardstick (the reference at the configuration's
    precision) on the same image."""
    rows = run.answers()
    errs, yard = [], []
    for i in range(0, len(rows), block):
        part = rows[i:i + block]
        idx = torch.tensor([p for p, _ in part], device=ref.device)
        served = torch.from_numpy(np.stack([o for _, o in part])).to(ref.device).double()
        r = _centered(ref[idx])
        errs.append((_centered(served.clamp_min(1e-300).log()) - r).square().sum(dim=1))
        yard.append((_centered(yardstick[idx]) - r).square().sum(dim=1))
    empty = torch.zeros(0, dtype=torch.float64, device=ref.device)
    return (torch.cat(errs) if errs else empty), (torch.cat(yard) if yard else empty)


def checks_of(run: Run, cell: Cell, ref: torch.Tensor, yardstick: torch.Tensor
              ) -> Dict[str, Dict[str, float]]:
    """The numbers the check compares, each beside its limit:

    compared             answers compared (every answer of the window);
    unanswered           requests admitted but never answered with a result;
    error_power          the answers' squared logit error (logits recovered
                         from the served probabilities up to the softmax's
                         constant) against the float32 reference, over the
                         error the reference itself makes at the
                         configuration's precision on the same images (about
                         1 for a program that rounds as the configuration
                         states);
    widest_answer_power  the largest one answer's error over the yardstick's
                         mean, which a single wrong answer drives up.
    """
    err, yard = answer_errors(run, ref, yardstick)
    limits = cell.config["check"]
    mean_yard = float(yard.mean()) if len(yard) else math.nan
    return {"compared": {"value": len(err), "limit": 1},
            "unanswered": {"value": len(run.log) - run.count(ANSWERED, SHED), "limit": 0},
            "error_power": {"value": float(err.sum() / yard.sum()) if len(err) else math.nan,
                            "limit": limits["error_power_limit"]},
            "widest_answer_power": {"value": float(err.max()) / mean_yard if len(err)
                                    else math.nan,
                                    "limit": limits["widest_answer_power_limit"]}}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    c = checks
    return (c["compared"]["value"] >= c["compared"]["limit"]
            and c["unanswered"]["value"] <= c["unanswered"]["limit"]
            and all(c[k]["limit"] is not None and c[k]["value"] <= c[k]["limit"]
                    for k in ("error_power", "widest_answer_power")))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device: str = "cuda", mode: Optional[str] = None,
             t_process: Optional[float] = None) -> Tuple[dict, List[str]]:
    """One run of cell ``name``: the result object and the lines to print
    before it (the generator's lateness)."""
    t_start = time.perf_counter() if t_process is None else t_process
    cell = Cell.load(name, root)
    session = Session(cell, seed, device=device, trace=trace, mode=mode)
    setup_s = time.perf_counter() - t_start
    on_card = device != "cpu"
    if on_card:
        # The peak of the serving path, not of the set-up's drawing.
        torch.cuda.reset_peak_memory_stats()
    run = session.window(cell.traffic, seconds, seed, profile=trace and device != "cpu")
    run.setup_s = setup_s
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    breakdown = None
    if trace and run.device is not None:
        dev["busy_s"], dev["window_s"] = run.device.busy_s, run.device.seconds
        breakdown = {"device_ops": run.device.top_ops(),
                     "idle_gaps": run.device.idle_by_span(run.spans)}
    images = session.images
    session.close()
    checks = checks_of(run, cell, reference_logprobs(cell, seed, images, device, "float32"),
                       reference_logprobs(cell, seed, images, device))
    notes = []
    if run.device is not None:
        notes.append(f"profiler: {run.device.notes}")
    log = run.log
    per_s = np.bincount([int(t - run.t0) for s, t in zip(log.state, log.t_done)
                         if s == ANSWERED and run.t0 <= t <= run.t_end],
                        minlength=int(run.seconds))
    notes.append(f"answers per second of the window: {per_s.tolist()}; full garbage "
                 f"collections {len(run.gc_pauses)}, {sum(run.gc_pauses)} s in all, "
                 f"longest {max(run.gc_pauses, default=0.0)} s")
    notes.append(f"CPU seconds over the window: {run.host}")
    late = sorted(run.lateness)
    notes += [f"generator: {len(log)} requests sent, {run.count(SHED)} shed, lateness s "
             f"p50 {late[len(late) // 2] if late else 0.0} "
             f"p99 {late[int(0.99 * (len(late) - 1))] if late else 0.0} "
             f"max {late[-1] if late else 0.0}; tier over the window {run.stats}"]
    result = {"correct": is_correct(checks), "attempted": len(log),
              "failed": len(log) - run.count(ANSWERED),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, notes

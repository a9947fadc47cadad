"""Port parity of ``repro_torch.obs`` (metrics, trace spans, exporters).

The port keeps its own copies of the JAX package's ``obs/metrics.py``,
``trace.py`` and ``export.py``.  Each case runs one script of operations
on both packages' objects under the same injected clock and requires the
Prometheus text, the parsed samples, the JSON snapshot, the CLI table and
the span JSONL to be identical (exact: no arithmetic differs).
"""
import math
import threading

import pytest

from repro import obs as jax_obs
from repro_torch import obs


class FakeClock:
    """Deterministic clock: returns ``start`` then advances by ``step``."""

    def __init__(self, start=0.0, step=0.25):
        self.now = start
        self.step = step

    def __call__(self):
        t, self.now = self.now, self.now + self.step
        return t


def _counters_and_gauges(ob, reg):
    c = reg.counter("serving_cache_hits_total", "hits", ("replica",))
    c.inc(3, replica="0")
    c.inc(1, replica=1)
    c.inc(0, replica="2")
    g = reg.gauge("serving_batcher_queue_depth", "depth")
    g.set(7)
    g.add(-2.5)
    ob.pretouch(reg.counter("flush_total", "flushes", ("reason",)),
                [{"reason": r} for r in ("depth", "deadline", "forced")])
    reg.counter("flush_total", "flushes", ("reason",)).inc(reason="depth")


def _histograms(ob, reg):
    h = reg.histogram("serving_dispatch_seconds", "dispatch",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    d = reg.histogram("latency_seconds", "default buckets", ("replica",))
    for i in range(40):
        d.observe(0.0003 * (i + 1) ** 1.7, replica=str(i % 3))
    o = reg.histogram("occ", "occupancy", ("replica",),
                      buckets=ob.FRACTION_BUCKETS)
    for v in (0.125, 0.5, 0.75, 1.0):
        o.observe(v, replica="0")
    t = reg.histogram("timed_seconds", "timed by the registry clock")
    for _ in range(3):
        with t.time():
            pass


def _escaping(ob, reg):
    reg.counter("c_total", "a \"quoted\" help\\line", ("path",)).inc(
        2, path='a"b\\c\nd')
    reg.gauge("nan_gauge", "special values").set(float("inf"))


def _disabled(ob, reg):
    off = ob.MetricsRegistry(enabled=False, clock=reg.clock)
    off.counter("never_total", "x").inc(5)
    off.histogram("never_seconds", "x").observe(1.0)
    reg.counter("after_disabled_total", "y").inc(
        off.counter("never_total").value())


METRIC_SCRIPTS = {"counters_and_gauges": _counters_and_gauges,
                  "histograms": _histograms, "escaping": _escaping,
                  "disabled_registry": _disabled}


def _export_views(ob, script):
    reg = ob.MetricsRegistry(clock=FakeClock())
    script(ob, reg)
    text = ob.to_prometheus(reg)
    return dict(text=text, parsed=ob.parse_prometheus(text),
                snapshot=ob.snapshot_document(reg, meta={"run": "parity"}),
                table=ob.render_table(reg),
                table_prefix=ob.render_table(reg, prefix="serving_"),
                quantiles=[(m.name, m.quantile(q, **m.labels_of(k)))
                           for m in reg.metrics() if m.kind == "histogram"
                           for k in sorted(m.series()) for q in (0.5, 0.95, 0.99)])


@pytest.mark.parametrize("name", sorted(METRIC_SCRIPTS))
def test_metrics_exports_match_reference(name):
    ours = _export_views(obs, METRIC_SCRIPTS[name])
    ref = _export_views(jax_obs, METRIC_SCRIPTS[name])
    assert ours["text"] == ref["text"]
    assert ours["parsed"] == ref["parsed"]
    assert ours["snapshot"] == ref["snapshot"]
    assert ours["table"] == ref["table"]
    assert ours["table_prefix"] == ref["table_prefix"]
    assert [n for n, _ in ours["quantiles"]] == [n for n, _ in ref["quantiles"]]
    for (_, a), (_, b) in zip(ours["quantiles"], ref["quantiles"]):
        assert a == b or (math.isnan(a) and math.isnan(b))


def _nested(ob, tr):
    with tr.span("synthesis.iteration", index=1) as s:
        with tr.span("synthesis.stage_c_probe", index=1):
            tr.event("synthesis.gate_demotion", degradation=0.5, demoted="c1")
        if s is not None:                  # None from a disabled tracer
            s.attrs["fingerprint"] = "abc"
    tr.record_span("serve.batch_wait", 0.1, 0.9, reason="depth", batch=4)


def _error_path(ob, tr):
    with pytest.raises(KeyError):
        with tr.span("serve.dispatch", batch=2):
            raise KeyError("boom")
    tr.event("serve.shed", depths=repr([3, 3]), bound=3, obj=object)


def _threads(ob, tr):
    def work(i):
        with tr.span("serve.dispatch", replica=i):
            pass
    threads = [threading.Thread(target=work, args=(i,), name=f"replica-{i}")
               for i in range(4)]
    for th in threads:
        th.start()
        th.join(timeout=10.0)
    assert not any(th.is_alive() for th in threads)


TRACE_SCRIPTS = {"nested_spans_events": _nested, "error_path": _error_path,
                 "one_thread_after_another": _threads}


@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("name", sorted(TRACE_SCRIPTS))
def test_trace_jsonl_matches_reference(name, enabled, tmp_path):
    out = {}
    for label, ob in (("ours", obs), ("ref", jax_obs)):
        tr = ob.Tracer(clock=FakeClock(start=10.0), enabled=enabled)
        TRACE_SCRIPTS[name](ob, tr)
        path = tmp_path / f"{label}.jsonl"
        n = ob.write_trace_jsonl(str(path), tr)
        out[label] = (tr.to_jsonl(), path.read_text(), n,
                      [s.name for s in tr.finished()], tr.open_spans())
    assert out["ours"] == out["ref"]
    if not enabled:
        assert out["ours"][2] == 0


@pytest.mark.parametrize("case", ["exports", "buckets", "drift_not_ported",
                                  "conflicting_registration"])
def test_obs_surface_matches_reference(case):
    if case == "exports":
        drift = {"GroupDrift", "DriftReport", "measure_drift"}
        assert set(obs.__all__) == set(jax_obs.__all__) - drift
    elif case == "buckets":
        assert obs.LATENCY_BUCKETS_S == jax_obs.LATENCY_BUCKETS_S
        assert obs.FRACTION_BUCKETS == jax_obs.FRACTION_BUCKETS
    elif case == "drift_not_ported":
        for name in ("GroupDrift", "DriftReport", "measure_drift"):
            with pytest.raises(AttributeError, match="item 9"):
                getattr(obs, name)
        with pytest.raises(AttributeError):
            obs.no_such_name
    else:
        for ob in (obs, jax_obs):
            reg = ob.MetricsRegistry()
            reg.counter("x_total", "x", ("a",))
            with pytest.raises(ValueError):
                reg.gauge("x_total", "x", ("a",))
            with pytest.raises(ValueError):
                reg.counter("x_total", "x", ("b",))

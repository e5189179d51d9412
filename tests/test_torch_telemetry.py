"""Port parity: ``accelerate_tpu_torch.telemetry`` and ``serving.faults``
against the JAX package's modules.

The same inputs, drawn from a numpy seed, with fake clocks wherever a
module reads one, go through the JAX module and the port's: the metrics
registry's snapshot and its Prometheus text (byte for byte), span names
and depths, the flight recorder's ring and heartbeat age, a scripted
request waterfall's summary, windowed rates and quantiles of the
time-series store, SLO burn rates, the debug endpoints' bodies, the
watchdog's signature counts, and the fault plan's grammar and firing
sequence.  Port-only pieces are held to their own contracts: a gauge holding
a 0-d tensor reads it at snapshot time, the port's cost table evaluates its
formula, and the card peaks table has NVIDIA's cards and no TPU.
"""

import json

import numpy as np
import pytest
import torch

from accelerate_tpu import telemetry as jtel
from accelerate_tpu.serving import faults as jfaults
from accelerate_tpu.telemetry import flight_recorder as jfr
from accelerate_tpu.telemetry import reqtrace as jrt
from accelerate_tpu.telemetry import server as jserver
from accelerate_tpu.telemetry import slo as jslo
from accelerate_tpu.telemetry import timeseries as jts
from accelerate_tpu.telemetry import tracer as jtracer
from accelerate_tpu.telemetry import watchdog as jwatchdog
from accelerate_tpu_torch import telemetry as ptel
from accelerate_tpu_torch.serving import faults as pfaults
from accelerate_tpu_torch.telemetry import flight_recorder as pfr
from accelerate_tpu_torch.telemetry import reqtrace as prt
from accelerate_tpu_torch.telemetry import server as pserver
from accelerate_tpu_torch.telemetry import slo as pslo
from accelerate_tpu_torch.telemetry import timeseries as pts
from accelerate_tpu_torch.telemetry import tracer as ptracer
from accelerate_tpu_torch.telemetry import watchdog as pwatchdog


class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _fill(tel, seed=0):
    """One registry filled by the same seeded sequence of observations."""
    rng = np.random.default_rng(seed)
    reg = tel.MetricsRegistry()
    c = reg.counter("serve/requests_total", help="requests\nserved")
    g = reg.gauge("serve/queue_depth", help="queued")
    h = reg.histogram("serve/ttft_s", buckets=tuple(1e-4 * 2.0**i for i in range(24)))
    for _ in range(200):
        kind = rng.integers(3)
        if kind == 0:
            c.inc(float(rng.integers(1, 5)))
        elif kind == 1:
            g.set(float(rng.integers(0, 64)))
        else:
            h.observe(float(rng.lognormal(-4.0, 1.5)), n=int(rng.integers(1, 4)))
    reg.histogram("serve/empty_s")
    return reg


def test_metrics_snapshot_and_prometheus_text_match():
    jreg, preg = _fill(jtel), _fill(ptel)
    assert preg.snapshot() == jreg.snapshot()
    assert preg.flat_snapshot() == jreg.flat_snapshot()
    assert preg.prometheus_text() == jreg.prometheus_text()
    h_j, h_p = jreg.get("serve/ttft_s"), preg.get("serve/ttft_s")
    assert h_p.bucket_snapshot() == h_j.bucket_snapshot()
    for q in (0, 12.5, 50, 90, 99, 100):
        assert h_p.percentile(q) == h_j.percentile(q)


def test_gauge_reads_a_tensor_at_snapshot_not_at_set():
    """A gauge holding a 0-d tensor reads it when a snapshot is taken: the
    value the tensor holds then, not when ``set`` ran."""
    reg = ptel.MetricsRegistry()
    value = torch.tensor(1.5)
    gauge = reg.gauge("serve/kv_quant_error")
    gauge.set(value)
    value.fill_(2.5)
    assert reg.snapshot()["serve/kv_quant_error"] == 2.5
    assert "atpu_serve_kv_quant_error 2.5" in reg.prometheus_text()
    value.fill_(4.0)
    assert gauge.value == 4.0
    ptel.set_enabled(False)
    try:
        gauge.set(9.0)  # disabled: a no-op
    finally:
        ptel.set_enabled(True)
    assert gauge.value == 4.0


@pytest.mark.parametrize("device_trace", [False, True])
def test_tracer_span_names_and_depths_match(device_trace):
    """Nested spans give the same (name, depth) events and per-name counts;
    with a device trace active the port's spans also enter
    ``torch.profiler.record_function`` (the reference's TraceAnnotation has
    no counterpart to check here, so the JAX side runs with it off)."""
    def run(tracer_mod):
        tracer = tracer_mod.Tracer(enabled=True)
        with tracer.span("serve/decode_window", occupied=2):
            with tracer.span("serve/paged_attn", kernel="pallas"):
                pass
        for b in (16, 32):
            with tracer.span("serve/prefill_chunk", bucket=b):
                with tracer.span("serve/copy_page"):
                    with tracer.span("serve/spill_d2h"):
                        pass
        return ([(e["name"], e.get("args", {}).get("depth", 0)) for e in tracer.events],
                {k: v["count"] for k, v in tracer.aggregate().items()})

    ptracer.set_device_trace_active(device_trace)
    try:
        got = run(ptracer)
    finally:
        ptracer.set_device_trace_active(False)
    assert got == run(jtracer)
    assert ("serve/spill_d2h", 2) in got[0]


def _record(fr_mod, clock):
    rec = fr_mod.FlightRecorder(capacity=16, clock=clock, registry=None)
    tagged = rec.tagged(engine="e7")
    rng = np.random.default_rng(3)
    for i in range(40):
        clock.t += float(rng.uniform(0.0, 2.0))
        if i % 5 == 0:
            tagged.heartbeat("serve/step", step=i, occupied=int(rng.integers(4)))
        else:
            tagged.record("serve/readback", step=i, wait_ms=float(rng.uniform(0, 3)))
    clock.t += 7.25
    return rec


def test_flight_recorder_ring_heartbeat_and_stall_match():
    jclock, pclock = Clock(), Clock()
    jrec, prec = _record(jfr, jclock), _record(pfr, pclock)
    assert prec.tail() == jrec.tail()
    assert (prec.dropped, prec.events_total, len(prec)) == (
        jrec.dropped, jrec.events_total, len(jrec))
    assert prec.heartbeat_age() == jrec.heartbeat_age()
    jdet = jfr.StallDetector(jrec, timeout_s=5.0)
    pdet = pfr.StallDetector(prec, timeout_s=5.0)
    assert pdet.check() == jdet.check() is True
    assert pdet.check() == jdet.check() is False  # once per stall
    keys = ("reason", "heartbeat_age_s", "events_total", "dropped", "events")
    assert {k: pdet.last_dump[k] for k in keys} == {k: jdet.last_dump[k] for k in keys}


def _lifecycle(rt_mod):
    """A scripted request lifecycle at fixed times (queue wait, chunks,
    decode windows, a preemption, a failover), three requests."""
    reg = rt_mod.RequestTraceRegistry(recent=8, flagged=8, slowest_k=2)
    out = []
    for rid, t0 in enumerate((10.0, 10.5, 11.0)):
        tr = reg.begin(rid=rid, engine="e0", prompt_len=20 + rid, submit_t=t0)
        tr.queue_done = True
        tr.phase("queue_wait", now=t0 + 0.25 * (rid + 1), queue_depth=rid)
        for c in range(2):
            tr.phase("prefill", now=t0 + 0.5 + 0.1 * c, chunk=c, bucket=16, source="fresh")
        tr.phase("decode", now=t0 + 0.9, lanes=2, wait_s=0.01)
        tr.mark_first_token(t0 + 0.9)
        tr.phase("decode", now=t0 + 1.3 + rid, lanes=2, wait_s=0.02)
        if rid == 1:
            tr.phase("failover", now=t0 + 1.5 + rid, from_engine="e0", to_engine="e1")
            reg.rebind(tr, "e1", 7)
        tr.tokens = 8
        out.append(tr)
    for tr in out[:2]:
        reg.complete(tr, status="done")
    return reg, out


def test_reqtrace_summary_matches_for_a_scripted_lifecycle():
    jreg, jtr = _lifecycle(jrt)
    preg, ptr = _lifecycle(prt)
    assert preg.summary() == jreg.summary()
    for engine in ("e0", "e1"):
        assert preg.summary(engine_id=engine) == jreg.summary(engine_id=engine)
    for a, b in zip(ptr, jtr):
        assert [p["phase"] for p in a.phases] == [p["phase"] for p in b.phases]
        assert a.phase_totals() == b.phase_totals()
        assert (a.ttft_s, a.ttft_attributed_s) == (b.ttft_s, b.ttft_attributed_s)
    assert preg.lookup("e1:7") is ptr[1] and jreg.lookup("e1:7") is jtr[1]


def _store(tel, ts_mod, clock):
    reg = tel.MetricsRegistry()
    store = ts_mod.TimeSeriesStore(registry=reg, capacity=64, interval_s=0.0, clock=clock)
    c_sub = reg.counter("serve/requests_submitted_total")
    c_shed = reg.counter("serve/deadline_shed_total")
    c_tok = reg.counter("serve/tokens_generated_total")
    h = reg.histogram("serve/ttft_s", buckets=tuple(1e-3 * 2.0**i for i in range(16)))
    rng = np.random.default_rng(11)
    for _ in range(40):
        clock.t += 10.0
        c_sub.inc(float(rng.integers(5, 15)))
        c_shed.inc(float(rng.integers(0, 3)))
        c_tok.inc(float(rng.integers(50, 200)))
        for v in rng.lognormal(-3.0, 1.0, size=8):
            h.observe(float(v))
        store.sample()
    return reg, store


def test_timeseries_rates_and_quantiles_match():
    jstore = _store(jtel, jts, Clock())[1]
    pstore = _store(ptel, pts, Clock())[1]
    for window in (30.0, 120.0, 400.0):
        for name in ("serve/requests_submitted_total", "serve/tokens_generated_total"):
            assert pstore.rate(name, window) == jstore.rate(name, window)
            assert pstore.delta(name, window) == jstore.delta(name, window)
        for q in (0.5, 0.9, 0.99):
            assert pstore.quantile("serve/ttft_s", q, window) == \
                jstore.quantile("serve/ttft_s", q, window)
        assert pstore.good_fraction("serve/ttft_s", 0.05, window) == \
            jstore.good_fraction("serve/ttft_s", 0.05, window)
    assert pstore.tail(3) == jstore.tail(3)


def test_slo_burn_rates_match():
    def verdicts(tel, ts_mod, slo_mod):
        clock = Clock()
        _, store = _store(tel, ts_mod, clock)
        engine = slo_mod.SloEngine(store, slo_mod.default_specs(ttft_threshold_s=0.05,
                                                                tokens_floor_per_s=8.0),
                                   fast_window_s=60.0, slow_window_s=300.0,
                                   on_fast_burn=lambda name, detail: None)
        return engine.evaluate(), engine.tick()

    assert verdicts(ptel, pts, pslo) == verdicts(jtel, jts, jslo)


def test_endpoint_bodies_match_for_one_registry(monkeypatch):
    """``TelemetryEndpoints.handle``: the same status, content type and body
    for every route, each package's endpoints over its own registry and
    recorder filled alike (fake clocks; no SLO engine installed, then one
    installed on each side)."""
    jclock, pclock = Clock(), Clock()
    jep = jserver.TelemetryEndpoints(registry=_fill(jtel), recorder=_record(jfr, jclock))
    pep = pserver.TelemetryEndpoints(registry=_fill(ptel), recorder=_record(pfr, pclock))
    for path, query in (("/metrics", ""), ("/healthz", ""), ("/debug/flight", "n=5"),
                        ("/debug/slo", ""), ("/nowhere", "")):
        assert pep.handle(path, query) == jep.handle(path, query), path
    monkeypatch.setattr(jrt, "_DEFAULT", _lifecycle(jrt)[0])
    monkeypatch.setattr(prt, "_DEFAULT", _lifecycle(prt)[0])
    for path in ("/debug/requests", "/debug/requests/e0:0", "/debug/requests/e1:7",
                 "/debug/requests/nope"):
        got, want = pep.handle(path), jep.handle(path)
        assert got[:2] == want[:2], path
        # the annotations' wall stamps differ; everything else is equal
        assert json.loads(got[2]).keys() == json.loads(want[2]).keys(), path
    assert json.loads(pep.handle("/debug/requests")[2])["active"] == \
        json.loads(jep.handle("/debug/requests")[2])["active"]
    for slo_mod, ts_mod, tel in ((jslo, jts, jtel), (pslo, pts, ptel)):
        store = _store(tel, ts_mod, Clock())[1]
        monkeypatch.setattr(slo_mod, "_GLOBAL", slo_mod.SloEngine(
            store, slo_mod.default_specs(), on_fast_burn=lambda name, detail: None))
    assert pep.handle("/debug/slo") == jep.handle("/debug/slo")


def test_watchdog_signature_counts_on_tensors():
    """The port keys a call by its tensors' ``(shape, dtype, device)``: the
    same counts as the reference on numpy arrays of the same shapes, and
    ``jit_cache_size`` is the count; ``tensor_signature`` ignores scalars."""
    shapes = [(4, 8), (4, 8), (2, 8), (4, 8), (4, 16), (2, 8)]
    jwd = jwatchdog.RecompileWatchdog(lambda x, k=0: x, name="j", budget=2,
                                      registry=jtel.MetricsRegistry())
    pwd = pwatchdog.RecompileWatchdog(lambda x, k=0: x, name="p", budget=2,
                                      registry=ptel.MetricsRegistry())
    counts_j, counts_p = [], []
    for i, shape in enumerate(shapes):
        jwd(np.zeros(shape, np.float32), k=i % 2)
        pwd(torch.zeros(shape), k=i % 2)
        counts_j.append(jwd.compile_count)
        counts_p.append(pwd.compile_count)
    assert counts_p == counts_j
    assert pwd.jit_cache_size() == pwd.compile_count and pwd.over_budget()
    assert pwatchdog.arg_signature((torch.zeros(2, dtype=torch.int32),), {}) != \
        pwatchdog.arg_signature((torch.zeros(2),), {})
    sig = pwatchdog.tensor_signature
    assert sig((torch.zeros(3), 1, None), {}) == sig((torch.ones(3), 7, 2.5), {})
    scalars = pwatchdog.RecompileWatchdog(lambda *a: None, name="s",
                                          registry=ptel.MetricsRegistry(), signature=sig)
    for page in range(5):
        scalars(torch.zeros(4), page)
    assert scalars.jit_cache_size() == 1


@pytest.mark.parametrize("spec", [
    "seed=7,decode_dispatch=0.25,fetch_slow=0.5,replica_kill@4,slow_ms=2.5",
    "fetch_fail@3,page_exhaustion=0.1,hot_swap_upload@1",
    "seed=123,promote_h2d=1.0",
])
def test_fault_plan_parse_and_firing_sequence_match(spec):
    jplan, pplan = jfaults.FaultPlan.parse(spec), pfaults.FaultPlan.parse(spec)
    assert (pplan.seed, pplan.probs, pplan.at, pplan.slow_ms) == (
        jplan.seed, jplan.probs, jplan.at, jplan.slow_ms)
    assert pfaults.FAULT_POINTS == jfaults.FAULT_POINTS
    jinj = jfaults.FaultInjector(jplan, registry=jtel.MetricsRegistry())
    pinj = pfaults.FaultInjector(pplan, registry=ptel.MetricsRegistry())
    rng = np.random.default_rng(5)
    order = rng.choice(pfaults.FAULT_POINTS, size=300)
    assert [pinj.fire(p) for p in order] == [jinj.fire(p) for p in order]
    for p in pfaults.FAULT_POINTS:
        assert (pinj.checks(p), pinj.fired(p)) == (jinj.checks(p), jinj.fired(p))
    with pytest.raises(ValueError):
        pfaults.FaultPlan.parse("decode_dispatch=0.5,decode_dispatch@2")
    with pytest.raises(ValueError):
        pfaults.FaultPlan.parse("no_such_point=0.5")


def test_fault_install_and_clear():
    try:
        injector = pfaults.install("seed=1,hot_swap_upload@2")
        assert pfaults.ACTIVE is injector
        assert [injector.fire("hot_swap_upload") for _ in range(3)] == [False, True, False]
    finally:
        pfaults.clear()
    assert pfaults.ACTIVE is None


def test_device_peaks_are_nvidia_cards():
    """The card table resolves the H100 names ``torch.cuda.get_device_name``
    gives, keeps the CPU fallback, and has no TPU entry."""
    sxm = ptel.detect_device_peaks("NVIDIA H100 80GB HBM3")
    assert (sxm.flops_per_s, sxm.hbm_bytes_per_s) == (989e12, 3.35e12)
    assert sxm.source.startswith("spec")
    assert ptel.detect_device_peaks("NVIDIA H100 PCIe").kind == "nvidia-h100-pcie"
    assert ptel.detect_device_peaks("cpu") is ptel.CPU_FALLBACK_PEAKS
    assert ptel.detect_device_peaks(torch.device("cpu")) is ptel.CPU_FALLBACK_PEAKS
    assert ptel.detect_device_peaks("Some Other Card") is ptel.CPU_FALLBACK_PEAKS
    names = " ".join(needle + peaks.kind for needle, peaks in ptel.HARDWARE_PEAKS).lower()
    assert "tpu" not in names and "v5" not in names and "v4" not in names
    assert sorted(ptel.__all__) == sorted(jtel.__all__)


def test_cost_table_evaluates_its_formula():
    """``capture`` keeps shapes only; ``analyze`` evaluates the formula,
    publishes the ``cost/<name>/*`` gauges, and ``hbm_peak_bytes`` is what
    was recorded for the program (``None`` when nothing was)."""
    reg = ptel.MetricsRegistry()
    table = ptel.CostTable(reg)
    x = torch.zeros(3, 5)
    assert table.capture("serve/a", None, (x, 2), cost=lambda s: (2.0 * s[0][0][0], 64.0))
    assert not table.capture("serve/a", None, (x,))
    table.capture("serve/b", None, (x,))
    del x
    table.set_hbm_peak_bytes("serve/a", 1000)
    table.set_hbm_peak_bytes("serve/a", 500)
    snap = table.analyze_all()
    assert snap["serve/a"]["shapes"] == [((3, 5), "torch.float32")]
    assert (snap["serve/a"]["flops"], snap["serve/a"]["bytes_accessed"]) == (6.0, 64.0)
    assert snap["serve/a"]["hbm_peak_bytes"] == 1000.0
    assert snap["serve/b"]["flops"] is None and snap["serve/b"]["hbm_peak_bytes"] is None
    assert "no cost formula" in snap["serve/b"]["error"]
    assert reg.snapshot()["cost/serve/a/flops"] == 6.0
    assert table.max_hbm_peak_bytes() == 1000.0


def test_logger_needs_no_process_state():
    """The port's ``get_logger`` logs before any ``PartialState`` exists
    (making one would claim the card)."""
    from accelerate_tpu_torch.logging import get_logger
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    log = get_logger("atpu.test")
    log.warning("telemetry port logger")
    log.warning_once("once")
    assert not PartialState._shared_state.get("_initialized")

"""Port parity: the OpenAI front door over the wire, against the JAX
package's (``tests/test_api_server.py`` and the server cases of
``tests/test_fault_tolerance.py``).

* every function of ``serving/api/protocol.py`` gives the JAX one's output
  on the same inputs: hypothesis bodies, valid and not (an invalid body
  raises the same ``ValidationError`` text and ``param``);
* a port ``ApiServer`` on an ephemeral localhost port, over two replicas
  of ``TransformerConfig.tiny`` at f32 (each on its own copy of the
  weights), answers with the in-process greedy tokens, and with the JAX
  server's response bodies (same weights) apart from ids and timestamps;
* the six contracts of ``tests/test_api_server.py`` (over the wire equals
  in process; SSE frames each token before ``[DONE]``; a queue flood
  answers 429 with ``Retry-After`` and nothing worse; a disconnect cancels
  its lane and frees its pages; a drained replica finishes its lanes; a hot
  swap under traffic fails no request);
* the server cases of ``tests/test_fault_tolerance.py``: ``replica_kill``,
  429 for an unmeetable deadline, 504 for a blown one (the engine's clock
  is a fake one that ticks on every read: no wall time is raced), the
  ``handler_disconnect`` and ``hot_swap_upload`` faults, a driver ticket
  timeout answering 503, and a jittered ``Retry-After``;
* ``serve.build_service`` with ``--replicas 2`` serves.
"""

import dataclasses
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import ReplicaRouter as JRouter
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu.serving.api import ApiServer as JApiServer
from accelerate_tpu.serving.api import FrontDoor as JFrontDoor
from accelerate_tpu.serving.api import protocol as jprotocol
from accelerate_tpu.telemetry import MetricsRegistry as JRegistry
from accelerate_tpu_torch import serve
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.serving import ReplicaRouter, ServingEngine, faults
from accelerate_tpu_torch.serving import engine as engine_module
from accelerate_tpu_torch.serving.api import ApiServer, FrontDoor, protocol
from accelerate_tpu_torch.serving.api.server import _retry_after
from accelerate_tpu_torch.serving.faults import FaultInjected
from accelerate_tpu_torch.telemetry import MetricsRegistry
from accelerate_tpu_torch.weights import params_from_jax

NEW_TOKENS = 6
ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), decode_window=2,
                 max_queue=4, prefix_cache_mb=0, paged=True, page_size=4, num_pages=65)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _http(host, port, method, path, payload=None, timeout=60.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, None if payload is None else json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, dict(resp.getheaders()), raw
    finally:
        conn.close()


def _sse(host, port, payload):
    """The ``data:`` frames of one streamed completion, ``[DONE]`` last."""
    conn = http.client.HTTPConnection(host, port, timeout=60.0)
    try:
        conn.request("POST", "/v1/completions", json.dumps({**payload, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/event-stream")
        frames = []
        for raw in iter(resp.readline, b""):
            line = raw.strip()
            if line.startswith(b"data: "):
                frames.append(line[len(b"data: "):])
            if frames and frames[-1] == b"[DONE]":
                break
        return frames
    finally:
        conn.close()


def _settle(predicate, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _strip(body):
    """A response body without what differs by history: ids, timestamps."""
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in ("id", "created")}
    if isinstance(body, list):
        return [_strip(v) for v in body]
    return body


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, max_seq_len=64)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, max_seq_len=64)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, cfg, port


class Service:
    """Two port replicas, each on its own copy of the weights, behind router
    + front door + HTTP server with a fast circuit breaker; the in-process
    greedy tokens computed before the driver took over."""

    def __init__(self, weights):
        _, _, self.cfg, self.params = weights
        self.registry = MetricsRegistry()
        self.e1, self.e2 = self.build(), self.build()
        rng = np.random.default_rng(7)
        self.prompts = [rng.integers(1, self.cfg.vocab_size, (int(n),)).astype(np.int32)
                        for n in (4, 5, 7, 8)]
        reqs = self.e1.serve(self.prompts, GenerationConfig(max_new_tokens=NEW_TOKENS))
        self.expected = [[int(t) for t in q.tokens] for q in reqs]
        self.router = ReplicaRouter([self.e1, self.e2], registry=self.registry,
                                    breaker_base_s=0.05)
        self.frontdoor = FrontDoor(self.router, model_name="test-model").start()
        self.server = ApiServer(self.frontdoor, registry=self.registry)
        self.host, self.port = self.server.host, self.server.port

    def build(self, params=None):
        own = {k: v.clone() for k, v in (params or self.params).items()}
        return ServingEngine(Transformer(self.cfg, device="meta"), own, device="cpu",
                             registry=self.registry, **ENGINE_KW)

    def post(self, path, payload):
        status, headers, raw = _http(self.host, self.port, "POST", path, payload)
        return status, headers, json.loads(raw)

    def completion(self, prompt, **kw):
        body = {"prompt": [int(t) for t in prompt], "max_tokens": NEW_TOKENS, "temperature": 0}
        body.update(kw)
        return self.post("/v1/completions", body)

    def engines(self):
        """Live replicas and those parked behind the breaker."""
        return list(self.router.engines) + [b["engine"] for b in self.router._breaker.values()]

    def stat(self, key):
        return sum(e.stats[key] for e in self.engines())

    def idle(self):
        return all(not e.has_work for e in self.router.engines)

    def stop(self):
        self.server.stop()
        self.frontdoor.stop()


@pytest.fixture(scope="module")
def svc(weights):
    service = Service(weights)
    yield service
    service.stop()


@pytest.fixture(scope="module")
def jsvc(weights):
    """The JAX service on the same weights: one replica."""
    jmodel, jparams, _, _ = weights
    engine = JEngine(jmodel, jparams, registry=JRegistry(), **ENGINE_KW)
    frontdoor = JFrontDoor(JRouter([engine], registry=JRegistry()),
                           model_name="test-model").start()
    server = JApiServer(frontdoor, registry=JRegistry())
    yield server
    server.stop()
    frontdoor.stop()


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.clear()


# -------------------------------------------------------------- protocol
_ids = hst.lists(hst.integers(-2, 300), max_size=5)
_any = hst.one_of(hst.none(), hst.booleans(), hst.integers(-3, 1 << 21),
                  hst.floats(-1.0, 3.0, allow_nan=False), hst.text(max_size=3), _ids)
_body = hst.fixed_dictionaries({}, optional={
    "prompt": hst.one_of(_ids, hst.text(max_size=4), hst.integers()),
    "max_tokens": _any, "temperature": _any, "top_p": _any, "top_k": _any, "n": _any,
    "stream": _any, "stop": _any, "model": hst.one_of(hst.none(), hst.text(max_size=4),
                                                      hst.integers()),
    "echo": _any, "deadline_s": _any,
    "messages": hst.one_of(hst.lists(hst.fixed_dictionaries(
        {"role": hst.sampled_from(["user", "system", "assistant", "tool", "bot"])},
        optional={"content": hst.one_of(_ids, hst.text(max_size=3))}), max_size=3),
        hst.text(max_size=2)),
})


def _outcome(fn, *args, **kw):
    try:
        return "ok", dataclasses.asdict(fn(*args, **kw))
    except ValueError as exc:
        return type(exc).__name__, str(exc), getattr(exc, "param", None)


@settings(max_examples=150, deadline=None)
@given(body=_body, encode=hst.booleans())
def test_protocol_parse_matches_jax(body, encode):
    enc = (lambda s: [ord(c) % 256 for c in s]) if encode else None
    for name in ("parse_completion_request", "parse_chat_request"):
        port, jax_ = getattr(protocol, name), getattr(jprotocol, name)
        kw = {"encode": enc}
        if name == "parse_chat_request":
            kw["template"] = protocol.ChatTemplate(role_prefix={"user": (1, 2)},
                                                   generation_prefix=(9,))
            jkw = {"encode": enc, "template": jprotocol.ChatTemplate(
                role_prefix={"user": (1, 2)}, generation_prefix=(9,))}
        else:
            jkw = kw
        assert _outcome(port, body, **kw) == _outcome(jax_, body, **jkw)
    assert _outcome(protocol.parse_completion_request, [body]) == \
        _outcome(jprotocol.parse_completion_request, [body])


@settings(max_examples=60, deadline=None)
@given(tokens=hst.lists(hst.integers(0, 255), max_size=6), chat=hst.booleans(),
       echo=hst.booleans(), stop=hst.one_of(hst.none(), hst.integers(0, 255)),
       cancelled=hst.booleans(), first=hst.booleans(),
       token=hst.one_of(hst.none(), hst.integers(0, 255)), decode=hst.booleans())
def test_protocol_render_matches_jax(tokens, chat, echo, stop, cancelled, first, token, decode):
    dec = (lambda ids: ",".join(map(str, ids))) if decode else None
    fields = dict(prompt=[3, 1, 4], max_tokens=6, stop_token_id=stop, echo=echo, chat=chat)
    call, jcall = protocol.CompletionCall(**fields), jprotocol.CompletionCall(**fields)
    args = ("cmpl-1", 17, "m")
    assert protocol.completion_response(call, *args, tokens, eos_token_id=stop,
                                        cancelled=cancelled, decode=dec) == \
        jprotocol.completion_response(jcall, *args, tokens, eos_token_id=stop,
                                      cancelled=cancelled, decode=dec)
    chunk = protocol.completion_chunk(call, *args, token, first, finish_reason="length",
                                      decode=dec)
    assert chunk == jprotocol.completion_chunk(jcall, *args, token, first,
                                               finish_reason="length", decode=dec)
    assert protocol.sse_frame(chunk) == jprotocol.sse_frame(chunk)
    assert protocol.error_body("x", "t", code="c", param="p") == \
        jprotocol.error_body("x", "t", code="c", param="p")
    assert protocol.SSE_DONE == jprotocol.SSE_DONE


# ------------------------------------------------------------ the service
def test_response_bodies_match_the_jax_server(svc, jsvc):
    prompt = [int(t) for t in svc.prompts[1]]
    calls = [("/v1/completions", {"prompt": prompt, "max_tokens": NEW_TOKENS, "temperature": 0}),
             ("/v1/completions", {"prompt": prompt, "max_tokens": 3, "temperature": 0,
                                  "echo": True, "stop": 5}),
             ("/v1/chat/completions", {"messages": [{"role": "user", "content": prompt}],
                                       "max_tokens": NEW_TOKENS, "temperature": 0}),
             ("/v1/completions", {"prompt": "text", "max_tokens": 2}),
             ("/v1/completions", {"prompt": prompt, "max_tokens": 2, "model": "other"}),
             ("/v1/completions", {"prompt": prompt, "max_tokens": 200})]
    for path, payload in calls:
        got = _http(svc.host, svc.port, "POST", path, payload)
        want = _http(jsvc.host, jsvc.port, "POST", path, payload)
        assert got[0] == want[0], (path, payload, got[2])
        assert _strip(json.loads(got[2])) == _strip(json.loads(want[2])), payload
    stream = {"prompt": prompt, "max_tokens": NEW_TOKENS, "temperature": 0}
    got = [_strip(json.loads(f)) for f in _sse(svc.host, svc.port, stream)[:-1]]
    want = [_strip(json.loads(f)) for f in _sse(jsvc.host, jsvc.port, stream)[:-1]]
    assert got == want
    models = [json.loads(_http(h, p, "GET", "/v1/models")[2])
              for h, p in ((svc.host, svc.port), (jsvc.host, jsvc.port))]
    for body in models:
        for entry in body["data"]:
            entry.pop("created")
            entry.pop("replicas", None)
    assert models[0] == models[1]
    assert _http(svc.host, svc.port, "DELETE", "/v1/requests/cmpl-999")[0] == \
        _http(jsvc.host, jsvc.port, "DELETE", "/v1/requests/cmpl-999")[0] == 404


def test_over_the_wire_matches_in_process_submit(svc):
    for prompt, expected in zip(svc.prompts, svc.expected):
        status, headers, body = svc.completion(prompt)
        assert status == 200, body
        assert body["choices"][0]["token_ids"] == expected
        assert body["choices"][0]["finish_reason"] == "length"
        assert body["usage"]["completion_tokens"] == NEW_TOKENS
        assert headers["X-Request-Id"] == body["id"]
    status, _, body = svc.post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": [int(t) for t in svc.prompts[0]]}],
        "max_tokens": NEW_TOKENS, "temperature": 0})
    assert status == 200 and body["object"] == "chat.completion"
    assert body["choices"][0]["token_ids"] == svc.expected[0]


def test_sse_streams_frame_tokens_before_done(svc):
    frames = _sse(svc.host, svc.port, {"prompt": [int(t) for t in svc.prompts[0]],
                                       "max_tokens": NEW_TOKENS, "temperature": 0})
    assert frames[-1] == b"[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    streamed = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    assert streamed == svc.expected[0]
    assert chunks[0]["choices"][0]["token_ids"], "the first frame carries a token"
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["choices"][0]["token_ids"] == []


def test_queue_flood_answers_429_with_retry_after(svc):
    assert _settle(svc.idle)
    n = 32  # far past 2 replicas x (2 slots + max_queue 4)
    results = [None] * n
    start = threading.Barrier(n)

    def fire(k):
        start.wait(timeout=60)  # every request in flight at once
        results[k] = svc.completion(svc.prompts[k % len(svc.prompts)])

    threads = [threading.Thread(target=fire, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    statuses = [s for s, _, _ in results]
    assert set(statuses) <= {200, 429}, statuses
    assert statuses.count(429) >= 1, "the flood never met admission backpressure"
    for status, headers, body in results:
        if status == 429:
            assert "Retry-After" in headers
            assert body["error"]["code"] == "engine_overloaded"
        else:
            assert body["choices"][0]["token_ids"] in svc.expected
    assert svc.registry.snapshot()["serve/http_429_total"] >= 1


def test_client_disconnect_cancels_and_frees_pages(svc):
    assert _settle(svc.idle)
    free_before = [e.kv.allocator.free_count for e in svc.router.engines]
    cancelled_before = svc.stat("cancelled")
    conn = http.client.HTTPConnection(svc.host, svc.port, timeout=60.0)
    conn.request("POST", "/v1/completions", json.dumps({
        "prompt": [int(t) for t in svc.prompts[1]], "max_tokens": 40, "temperature": 0,
        "stream": True}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    resp.close()
    conn.close()
    assert _settle(lambda: svc.stat("cancelled") > cancelled_before), \
        "the disconnect never reached engine.cancel"
    assert _settle(lambda: svc.idle() and [e.kv.allocator.free_count
                                           for e in svc.router.engines] == free_before)


def test_drain_replica_completes_in_flight_lanes(svc):
    third = svc.build()
    rid3 = svc.frontdoor.add_replica(third)
    assert svc.frontdoor.health()["replicas"] == 3
    n = 8
    results = [None] * n

    def fire(k):
        results[k] = svc.completion(svc.prompts[k % len(svc.prompts)])

    threads = [threading.Thread(target=fire, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    assert _settle(lambda: third.has_work or svc.stat("requests_completed") > 0)
    svc.frontdoor.drain_replica(rid3)
    for t in threads:
        t.join()
    for status, _, body in results:
        assert status == 200, body
        assert body["choices"][0]["token_ids"] in svc.expected
    assert _settle(lambda: svc.frontdoor.health()["replicas"] == 2)
    assert third.drained


def test_hot_swap_serves_zero_failed_requests(svc):
    """Each replica holds its own weights: the rolling swap copies the new
    ones into each in turn while the others serve, and captures nothing."""
    assert _settle(svc.idle)
    params2 = {k: v * 1.01 if v.is_floating_point() else v.clone()
               for k, v in svc.params.items()}
    results, lock, stop = [], threading.Lock(), threading.Event()

    def hammer(widx):
        k = 0
        while not stop.is_set():
            out = svc.completion(svc.prompts[(widx + k) % len(svc.prompts)])
            k += 1
            with lock:
                results.append(out)

    workers = [threading.Thread(target=hammer, args=(w,)) for w in range(2)]
    for t in workers:
        t.start()
    assert _settle(lambda: len(results) >= 2)
    swapped = svc.frontdoor.hot_swap(params2, version="v1")
    assert _settle(lambda: len(results) >= 6)
    stop.set()
    for t in workers:
        t.join()
    assert swapped == len(svc.router.engines) == 2
    for status, _, body in results:
        assert status == 200, body
        assert len(body["choices"][0]["token_ids"]) == NEW_TOKENS
    assert svc.frontdoor.model_versions() == {"v1": 2}
    assert svc.registry.snapshot()["serve/hot_swaps_total"] == 2
    ids = {m["id"] for m in json.loads(_http(svc.host, svc.port, "GET", "/v1/models")[2])["data"]}
    assert {"test-model", "test-model@v1"} <= ids
    # back to the first weights for the cases below
    assert svc.frontdoor.hot_swap(svc.params, version="v0") == 2
    status, _, body = svc.completion(svc.prompts[0])
    assert status == 200 and body["choices"][0]["token_ids"] == svc.expected[0]


# ---------------------------------------------------------- fault tolerance
def test_replica_kill_mid_decode_loses_nothing(svc):
    assert _settle(svc.idle)
    n = 6
    results = [None] * n
    submitted = svc.stat("requests_submitted")

    def fire(k):
        results[k] = svc.completion(svc.prompts[k % len(svc.prompts)], max_tokens=40)

    threads = [threading.Thread(target=fire, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    # every submit accepted first (a straggler could otherwise find the lone
    # survivor's queue full), then the router's replica_kill point poisons
    # the busiest replica at its next step, mid-decode
    assert _settle(lambda: svc.stat("requests_submitted") >= submitted + n)
    faults.install("replica_kill@1", registry=svc.registry)
    for t in threads:
        t.join()
    for k, (status, _, body) in enumerate(results):
        assert status == 200, body
        tokens = body["choices"][0]["token_ids"]
        assert len(tokens) == 40 and tokens[:NEW_TOKENS] == svc.expected[k % len(svc.prompts)]
    assert svc.frontdoor.health()["ejections"] >= 1
    assert svc.stat("requests_replayed") >= 1
    assert svc.registry.snapshot()["serve/replica_ejections_total"] >= 1
    faults.clear()
    assert _settle(lambda: svc.frontdoor.health()["replicas"] == 2), \
        f"the breaker never re-admitted the killed replica: {svc.frontdoor.health()}"
    status, _, body = svc.completion(svc.prompts[0])
    assert status == 200 and body["choices"][0]["token_ids"] == svc.expected[0]
    assert _settle(svc.idle)


def test_unmeetable_deadline_refused_429(svc):
    assert _settle(svc.idle)
    shed_before = svc.stat("deadline_shed")
    gen = GenerationConfig(max_new_tokens=24)

    def flood():
        for e in svc.router.engines:
            e._service_ema = 50.0
        for k in range(8):
            svc.router.submit(svc.prompts[k % len(svc.prompts)], config=gen)

    svc.frontdoor._call(flood)
    status, headers, body = svc.completion(svc.prompts[0], deadline_s=0.01)
    assert status == 429, body
    assert "Retry-After" in headers and int(headers["Retry-After"]) >= 1
    assert body["error"]["code"] == "engine_overloaded"
    assert "deadline" in body["error"]["message"]
    assert svc.stat("deadline_shed") >= shed_before + 1
    assert _settle(svc.idle)
    for e in svc.router.engines:
        e._service_ema = 0.0


def test_blown_deadline_cancels_running_lane_504(svc, monkeypatch):
    """Under a fake clock that ticks 10 ms on every read, the lane's 50 ms
    budget is blown after a few engine steps, long before its 48 tokens."""
    assert _settle(svc.idle)
    free_before = [e.kv.allocator.free_count for e in svc.router.engines]
    shed_before = svc.stat("deadline_shed")
    ticks = iter(range(10**9))
    monkeypatch.setattr(engine_module, "clock", lambda: next(ticks) * 0.01)
    status, _, body = svc.completion(svc.prompts[0], deadline_s=0.05, max_tokens=48)
    assert status == 504, body
    assert body["error"]["code"] == "deadline_exceeded"
    assert body["error"]["type"] == "timeout_error"
    assert svc.stat("deadline_shed") == shed_before + 1
    assert _settle(svc.idle)
    assert [e.kv.allocator.free_count for e in svc.router.engines] == free_before


def test_sse_handler_disconnect_cancels_lane_and_frees_pages(svc):
    assert _settle(svc.idle)
    free_before = [e.kv.allocator.free_count for e in svc.router.engines]
    cancelled_before = svc.stat("cancelled")
    faults.install("handler_disconnect@1", registry=svc.registry)
    conn = http.client.HTTPConnection(svc.host, svc.port, timeout=60.0)
    try:
        conn.request("POST", "/v1/completions", json.dumps({
            "prompt": [int(t) for t in svc.prompts[1]], "max_tokens": 40, "temperature": 0,
            "stream": True}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        resp.read()
    finally:
        conn.close()
    assert _settle(lambda: svc.stat("cancelled") > cancelled_before)
    faults.clear()
    assert _settle(lambda: svc.idle() and [e.kv.allocator.free_count
                                           for e in svc.router.engines] == free_before)


def test_hot_swap_upload_fault_keeps_old_weights_serving(svc):
    assert _settle(svc.idle)
    versions = svc.frontdoor.model_versions()
    params2 = {k: v * 1.01 if v.is_floating_point() else v.clone()
               for k, v in svc.params.items()}
    faults.install("hot_swap_upload=1.0", registry=svc.registry)
    with pytest.raises(FaultInjected):
        svc.frontdoor.hot_swap(params2, version="torn")
    faults.clear()
    assert svc.frontdoor.model_versions() == versions
    assert not any(e.admission_paused for e in svc.router.engines)
    status, _, body = svc.completion(svc.prompts[2])
    assert status == 200 and body["choices"][0]["token_ids"] == svc.expected[2]


def test_driver_ticket_timeout_maps_to_503_retry_after(svc, monkeypatch):
    def wedged(call, model_version=None):
        raise TimeoutError("driver did not service the request within 0.0s")

    monkeypatch.setattr(svc.frontdoor, "submit", wedged)
    status, headers, body = svc.completion(svc.prompts[0])
    assert status == 503, body
    assert body["error"]["code"] == "driver_busy"
    assert "Retry-After" in headers and int(headers["Retry-After"]) >= 1


def test_retry_after_values_are_jittered():
    values = {int(_retry_after(20.0)) for _ in range(64)}
    assert len(values) > 1
    assert all(15 <= v <= 26 for v in values), values
    assert int(_retry_after(0.05)) >= 1


def test_build_service_two_replicas():
    args = serve._parser().parse_args(["--preset", "tiny", "--port", "0", "--replicas", "2",
                                       "--paged", "--max-len", "64", "--num-slots", "2"])
    router, frontdoor, server = serve.build_service(args, device="cpu")
    try:
        assert len(router.engines) == 2
        a, b = (e.model.state_dict() for e in router.engines)
        assert all(a[k].data_ptr() != b[k].data_ptr() for k in a)  # each its own weights
        assert all(torch.equal(a[k], b[k]) for k in a)
        status, _, raw = _http(server.host, server.port, "POST", "/v1/completions",
                               {"prompt": [3, 1, 4, 1, 5], "max_tokens": 4, "temperature": 0})
        assert status == 200 and len(json.loads(raw)["choices"][0]["token_ids"]) == 4
        health = json.loads(_http(server.host, server.port, "GET", "/healthz")[2])
        assert health["router"]["replicas"] == 2
    finally:
        server.stop()
        frontdoor.stop()

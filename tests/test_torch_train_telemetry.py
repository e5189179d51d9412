"""Port parity: the ``Accelerator``'s training telemetry against the JAX
``Accelerator``'s.

Both packages train ``TransformerConfig.tiny`` at f32 (the same weights,
carried across by ``params_from_jax``) for the same steps (accumulation 2,
four 8 x 16 token batches), evaluate twice, and save, restore and export
the state, each recording into a private process registry and flight
recorder (both packages' telemetry on only inside this module).  Then:

* the ``train/*``, ``eval/*`` and ``checkpoint/*`` metrics have the same
  names, kinds and help strings in both registries, the same label sets in
  the Prometheus text (a histogram's ``le`` buckets), and the same counts:
  every counter but the byte counters (each package counts its own state's
  layout) and every histogram's count;
* ``Accelerator(metrics_port=0)`` serves ``/metrics`` with the step's
  families;
* the recompile watchdog counts a new batch signature, and only one;
* ``train/step_mfu`` lies in (0, 1], and ``train/model_flops`` equals the
  formula's FLOPs for the step's batch
  (:func:`~accelerate_tpu_torch.telemetry.cost.transformer_train_flops`).
"""

import functools
import re
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.data_loader import SimpleDataLoader as JSimpleDataLoader
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import SimpleDataLoader
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.telemetry import stop_debug_server
from accelerate_tpu_torch.telemetry.cost import transformer_train_flops
from accelerate_tpu_torch.weights import params_from_jax

ROWS, SEQ, N_BATCHES = 8, 16, 4
FAMILIES = ("train/", "eval/", "checkpoint/")
#: counters whose values are bytes of each package's own state layout
#: (orbax trees against one torch.save file): compared only as positive
BYTE_COUNTERS = {"checkpoint/saved_bytes_total", "checkpoint/restored_bytes_total",
                 "checkpoint/model_saved_bytes_total"}


@pytest.fixture(scope="module", autouse=True)
def _private_telemetry():
    """Telemetry on in both packages, each with a process-wide registry and
    recorder of this module's own; the originals come back after."""
    from accelerate_tpu.telemetry import flight_recorder as jfr
    from accelerate_tpu.telemetry import metrics as jmetrics
    from accelerate_tpu_torch.telemetry import flight_recorder as pfr
    from accelerate_tpu_torch.telemetry import metrics as pmetrics

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmetrics, "_ENABLED", True)
        mp.setattr(pmetrics, "_ENABLED", True)
        for mod, fresh in ((jmetrics, jmetrics.MetricsRegistry),
                           (pmetrics, pmetrics.MetricsRegistry),
                           (jfr, jfr.FlightRecorder), (pfr, pfr.FlightRecorder)):
            mp.setattr(mod, "_DEFAULT", fresh())
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _reset():
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


def _dataset(seed=0):
    ids = np.random.default_rng(seed).integers(1, 256, (ROWS * N_BATCHES, SEQ)).astype(np.int32)
    return [{"input_ids": ids[i]} for i in range(len(ids))]


def _eval_batch(n=ROWS):
    return np.random.default_rng(9).integers(1, 256, (n, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Train, evaluate, save, restore and export in each package; returns
    each one's registry and the port's accelerator, state and step."""
    from accelerate_tpu.telemetry import get_registry as jget
    from accelerate_tpu_torch.telemetry import get_registry as pget

    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jmodel = JTransformer(jcfg)
    jparams = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmp = tmp_path_factory.mktemp("train_telemetry")

    _reset()
    jacc = JAccelerator(gradient_accumulation_steps=2)
    jstate = jacc.create_train_state(params=jparams, tx=optax.adamw(1e-3))
    jstep = jacc.compile_train_step(jlm_loss_fn(jmodel), max_grad_norm=1.0)
    for batch in jacc.prepare(JSimpleDataLoader(_dataset(), batch_size=ROWS)):
        jstate, _ = jstep(jstate, batch)
    jeval = jacc.compile_eval_step(jlm_loss_fn(jmodel))
    for _ in range(2):
        jeval(jstate, {"input_ids": jnp.asarray(_eval_batch())})
    jacc.save_state(str(tmp / "jax_state"), state=jstate)
    jacc.load_state(str(tmp / "jax_state"), state=jstate)
    jacc.save_model(jstate, str(tmp / "jax_model"))
    jacc.analyze_costs()
    jreg = jget()

    _reset()
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    acc = Accelerator(gradient_accumulation_steps=2, cpu=True)
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.AdamW, lr=1e-3))
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    for batch in acc.prepare(SimpleDataLoader(_dataset(), batch_size=ROWS)):
        state, _ = step(state, batch)
    peval = acc.compile_eval_step(lm_loss_fn(model))
    for _ in range(2):
        peval(state, {"input_ids": torch.from_numpy(_eval_batch())})
    acc.save_state(str(tmp / "port_state"), state=state)
    acc.load_state(str(tmp / "port_state"), state=state)
    acc.save_model(state, str(tmp / "port_model"))
    acc.analyze_costs()
    yield jreg, pget(), acc, state, step, cfg
    _reset()


def _family(registry):
    return {m.name: m for m in registry if m.name.startswith(FAMILIES)}


def _prom_series(text):
    """``{family: set of label sets}`` of the exposition's sample lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, labels = re.match(r"([^{ ]+)(\{[^}]*\})?", line).groups()
        out.setdefault(name, set()).add(labels or "")
    return out


def test_names_kinds_help_and_counts_match_jax(runs):
    jreg, preg, *_ = runs
    jm, pm = _family(jreg), _family(preg)
    assert set(pm) == set(jm)
    assert {"train/step_time_s", "train/steps_total", "train/tokens_total",
            "train/step_mfu", "train/model_flops", "eval/step_time_s",
            "checkpoint/save_s", "checkpoint/restore_s", "checkpoint/save_model_s"} <= set(pm)
    for name, metric in pm.items():
        want = jm[name]
        assert type(metric).__name__ == type(want).__name__, name
        assert metric.help == want.help, name
        if type(metric).__name__ == "Counter":
            if name in BYTE_COUNTERS:
                assert metric.value > 0 and want.value > 0, name
            else:
                assert metric.value == want.value, name
        elif type(metric).__name__ == "Histogram":
            assert metric.count == want.count, name
            assert metric.bounds == want.bounds, name
    jseries = _prom_series(jreg.prometheus_text())
    pseries = _prom_series(preg.prometheus_text())
    for name in pseries:
        if any(f"atpu_{f[:-1]}_" in name for f in FAMILIES):
            assert pseries[name] == jseries[name], name
    assert pm["train/steps_total"].value == N_BATCHES
    assert pm["train/tokens_total"].value == N_BATCHES * ROWS * SEQ
    assert pm["eval/step_time_s"].count == 2


def test_step_mfu_and_model_flops(runs):
    _, preg, acc, _, _, cfg = runs
    flops = transformer_train_flops(cfg, ROWS, SEQ)
    assert preg.gauge("train/model_flops").value == flops
    assert 0.0 < preg.gauge("train/step_mfu").value <= 1.0
    assert preg.gauge("train/tokens_per_s").value > 0
    loss = preg.gauge("train/loss")
    assert isinstance(loss._value, torch.Tensor) and loss._value.dim() == 0  # deferred
    assert np.isfinite(loss.value) and preg.gauge("train/grad_norm").value > 0
    entries = {k: v for k, v in acc.cost_table.snapshot().items() if k.startswith("train_step/")}
    assert [e["flops"] for e in entries.values()] == [flops]
    assert preg.gauge(f"cost/{next(iter(entries))}/flops").value == flops


def test_watchdog_counts_a_new_signature(runs):
    _, preg, acc, state, step, _ = runs
    name = next(n for n in (m.name for m in preg) if re.fullmatch(r"compile/train_step/.*/count", n))
    before = preg.gauge(name).value
    assert before == 1
    wide = {"input_ids": torch.from_numpy(_eval_batch(4))}
    for _ in range(2):  # one new signature, however often it comes
        state, _ = step(state, wide)
    assert preg.gauge(name).value == before + 1
    assert step._watchdog.jit_cache_size() == 2


def test_metrics_port_serves_the_step(runs, monkeypatch):
    """``Accelerator(metrics_port=0)`` starts the debug server on an
    ephemeral port; a scrape runs ``analyze_costs`` and shows the train
    families."""
    monkeypatch.setenv("ATPU_METRICS_HOST", "127.0.0.1")
    _reset()
    try:
        acc = Accelerator(cpu=True, metrics_port=0)
        assert acc.debug_server is not None and acc.debug_server.port > 0
        model = Transformer(TransformerConfig.tiny(dtype=torch.float32,
                                                   param_dtype=torch.float32), device="cpu")
        state = acc.create_train_state(params=model,
                                       tx=functools.partial(torch.optim.AdamW, lr=1e-3))
        step = acc.compile_train_step(lm_loss_fn(model))
        step(state, {"input_ids": torch.from_numpy(_eval_batch())})
        url = f"http://127.0.0.1:{acc.debug_server.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert "atpu_train_steps_total_total" in text
        assert "atpu_train_model_flops" in text
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            assert resp.status == 200
    finally:
        stop_debug_server()
        _reset()

"""Port parity: the chunked, host-offloaded optimizer (``utils/chunked_update.py``).

Case for case the JAX package's ``tests/test_chunked_update.py``, each run
through both packages on the same numpy parameters and batches (the
``{"w1", "w2", "b"}`` regression of the reference test; 16 rows, which the
JAX Accelerator shards over its 8 virtual CPU devices):

* the partition, slice spec and groups equal the JAX package's exactly (the
  same arithmetic), and ``auto_chunk_bytes`` gives the same bytes;
* where a case compares chunked with unchunked (the chained and sliced math,
  overlap 1 against 2, the nvme tier against host memory, a checkpoint
  round trip) the port is held **bitwise**: torch's AdamW is elementwise,
  so the grouping changes no value;
* where a case compares with the reference, the port's weights after the
  same steps are held against the JAX run within ``ATOL`` (2e-5): optax
  and torch apply AdamW's weight decay and eps in a different order, and the two
  frameworks sum the same f32 products in different orders;
* the error messages are the reference's, word for word.
"""

import copy
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils import chunked_update as jcu
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JFSDP
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import chunked_update as cu
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin as FSDP

ATOL = 2e-5
# optax.adamw's default weight decay, set on both sides; eps 1e-6 (both) keeps
# an entry whose gradient is ~0 from turning the frameworks' last-bit noise
# into a full-size step, as in test_torch_accelerator.py
LR, WD, EPS = 1e-2, 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset():
    yield
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    # two leaves > 1MB/12 elements each: 1 MB chunking yields several groups
    return {"w1": (rng.normal(size=(300, 300)) * 0.05).astype(np.float32),
            "w2": (rng.normal(size=(300, 300)) * 0.05).astype(np.float32),
            "b": np.zeros((300,), np.float32)}


def _np_batch(seed=0):
    rng = np.random.default_rng(seed + 100)
    return {"x": rng.normal(size=(16, 300)).astype(np.float32),
            "y": rng.normal(size=(16, 300)).astype(np.float32)}


class Regression(nn.Module):
    """The reference test's parameter tree as a module (names in its order)."""

    def __init__(self, params):
        super().__init__()
        for name in ("b", "w1", "w2"):  # jax.tree_util's sorted-key order
            setattr(self, name, nn.Parameter(torch.from_numpy(params[name].copy())))


def _loss(p, batch):
    h = torch.tanh(batch["x"].to(p["w1"].dtype) @ p["w1"])
    return ((h @ p["w2"] + p["b"] - batch["y"]) ** 2).mean()


def _jloss(p, batch):
    h = jnp.tanh(batch["x"] @ p["w1"])
    return jnp.mean((h @ p["w2"] + p["b"] - batch["y"]) ** 2)


def _reset_port():
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _reset_jax():
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


def _adamw():
    return functools.partial(torch.optim.AdamW, lr=LR, weight_decay=WD, eps=EPS)


def _train(acc, steps=5, tx=None, seed=0):
    model = Regression(_np_params(seed))
    state = acc.create_train_state(params=model, tx=tx or _adamw())
    step = acc.compile_train_step(_loss, max_grad_norm=1.0)
    batch = {k: torch.from_numpy(v) for k, v in _np_batch().items()}
    metrics = None
    for _ in range(steps):
        state, metrics = step(state, batch)
    return state, metrics


def _jtrain(acc, steps=5, tx=None):
    params = jax.tree_util.tree_map(jnp.asarray, _np_params())
    state = acc.create_train_state(params=params, tx=tx or optax.adamw(LR, eps=EPS, weight_decay=WD),
                                   seed=0)
    step = acc.compile_train_step(_jloss, max_grad_norm=1.0)
    batch = jax.tree_util.tree_map(jnp.asarray, _np_batch())
    for _ in range(steps):
        state, _ = step(state, batch)
    return state


def _port(**plugin):
    _reset_port()
    if not plugin:
        return Accelerator(cpu=True)
    return Accelerator(cpu=True, fsdp_plugin=FSDP(sharding_strategy="NO_SHARD", **plugin))


def _jax(**plugin):
    _reset_jax()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # offload-unsupported fallback on the CPU
        if not plugin:
            return JAccelerator()
        return JAccelerator(fsdp_plugin=JFSDP(sharding_strategy="NO_SHARD", **plugin))


def _params(state):
    return {name: p.detach().float().numpy().copy() for name, p in state.model.named_parameters()}


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _assert_near_jax(port_state, jstate):
    got = _params(port_state)
    for name, want in jstate.params.items():
        np.testing.assert_allclose(got[name], np.asarray(want, np.float32), atol=ATOL,
                                   err_msg=name)


def _assert_state_bitwise(opt_a, opt_b):
    """Every master and per-element state tensor of two chunked optimizers
    equal, and every chunk's step count."""
    for key in (["master"] if opt_a.master_dtype is not None else []) + list(opt_a.state_keys):
        for a, b in zip(opt_a.host_state(key), opt_b.host_state(key)):
            assert a is not None and torch.equal(a, b), key
    for a, b in zip(opt_a.chunks, opt_b.chunks):
        for sa, sb in zip(a.staging, b.staging):
            assert torch.equal(a.opt.state[sa]["step"], b.opt.state[sb]["step"])


def _step_plain_and_chunked(params, chunk_bytes):
    """One AdamW step of ones-gradients through a plain optimizer and a
    ChunkedOptimizer: their results, the chunked optimizer and the plain
    one's first moments."""
    out = []
    for chunked in (False, True):
        ps = [nn.Parameter(torch.from_numpy(v.copy())) for v in params]
        for p in ps:
            p.grad = torch.ones_like(p)
        opt = (cu.ChunkedOptimizer(ps, _adamw(), chunk_bytes) if chunked
               else _adamw()(ps))
        opt.step()
        out.append([p.detach().numpy().copy() for p in ps])
        if chunked:
            layout = opt
        else:
            moments = [opt.state[p]["exp_avg"] for p in ps]
    return out, layout, moments


class TestPartition:
    def test_partition_respects_budget(self):
        shapes = [v.shape for v in _np_params().values()]
        groups = cu.partition_leaves(shapes, 300 * 300 * 12 + 1)
        jgroups = jcu.partition_leaves(_np_params(), 300 * 300 * 12 + 1)
        assert len(groups) >= 2 and sorted(i for g in groups for i in g) == [0, 1, 2]
        assert groups == jgroups

    def test_single_group_returns_original_tx(self):
        tx = _adamw()
        out_tx, info = cu.build_chunked_tx(tx, [v.shape for v in _np_params().values()], 10**12)
        assert out_tx is tx and info is None
        assert jcu.build_chunked_tx(optax.adamw(1e-3), _np_params(), 10**12)[1] is None

    def test_chained_tx_math_matches_plain(self):
        params = [_np_params()[k] for k in ("b", "w1", "w2")]
        budget = 300 * 300 * 12 + 1
        (plain, chunked), opt, _ = _step_plain_and_chunked(params, budget)
        assert len(opt.groups) >= 2
        for a, b in zip(plain, chunked):
            np.testing.assert_array_equal(a, b)
        _, info = jcu.build_chunked_tx(optax.adamw(1e-3), dict(zip("abc", params)), budget)
        assert opt.groups == info["groups"] and opt.spec == info["spec"]

    def test_sliced_view_math_matches_plain(self):
        stack = (np.random.default_rng(0).normal(size=(48, 64, 64)) * 0.1).astype(np.float32)
        chunk_bytes = 8 * 64 * 64 * 12  # ~8 rows a slice
        (plain, chunked), opt, moments = _step_plain_and_chunked([stack], chunk_bytes)
        assert len(opt.spec[0]) >= 6 and len(opt.groups) >= 6
        np.testing.assert_array_equal(plain[0], chunked[0])
        _, info = jcu.build_chunked_tx(optax.adamw(1e-3), {"stack": stack}, chunk_bytes)
        assert opt.spec == info["spec"] and opt.groups == info["groups"]
        # the slices' state put back together is the whole parameter's
        assert torch.equal(opt.host_state("exp_avg")[0], moments[0])


class TestChunkedTraining:
    def test_matches_unchunked_training(self):
        acc = _port(offload_optimizer=True, offload_update_chunk_mb=1)
        state_c, _ = _train(acc)
        assert acc._chunk_info is not None and len(acc._chunk_info["groups"]) >= 2
        state_p, _ = _train(_port())
        _assert_bitwise(_params(state_c), _params(state_p))
        assert state_c.step == state_p.step == 5
        jacc = _jax(offload_optimizer=True, offload_update_chunk_mb=1)
        jstate = _jtrain(jacc)
        assert len(jacc._chunk_info["groups"]) == len(acc._chunk_info["groups"])
        _assert_near_jax(state_c, jstate)

    def test_with_gradient_accumulation(self):
        _reset_port()
        acc = Accelerator(cpu=True, gradient_accumulation_steps=2, fsdp_plugin=FSDP(
            sharding_strategy="NO_SHARD", offload_optimizer=True, offload_update_chunk_mb=1))
        model = Regression(_np_params())
        state = acc.create_train_state(params=model,
                                       tx=functools.partial(torch.optim.SGD, lr=0.1))
        step = acc.compile_train_step(_loss)
        batch = {k: torch.from_numpy(v) for k, v in _np_batch().items()}
        p0 = model.w1.detach().clone()
        state, _ = step(state, batch)          # micro-step: no update
        assert torch.equal(model.w1, p0) and state.step == 0
        state, _ = step(state, batch)          # sync: the chunked update applies
        assert state.step == 1 and not torch.equal(model.w1, p0)
        _reset_jax()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jacc = JAccelerator(gradient_accumulation_steps=2, fsdp_plugin=JFSDP(
                sharding_strategy="NO_SHARD", offload_optimizer=True,
                offload_update_chunk_mb=1))
        params = jax.tree_util.tree_map(jnp.asarray, _np_params())
        jstate = jacc.create_train_state(params=params, tx=optax.sgd(0.1), seed=0)
        jstep = jacc.compile_train_step(_jloss)
        jbatch = jax.tree_util.tree_map(jnp.asarray, _np_batch())
        for _ in range(2):
            jstate, _ = jstep(jstate, jbatch)
        _assert_near_jax(state, jstate)

    def test_checkpoint_roundtrip(self, tmp_path):
        acc = _port(offload_optimizer=True, offload_update_chunk_mb=1)
        state, _ = _train(acc, steps=2)
        want = copy.deepcopy(state.optimizer.state_dict())
        acc.save_state(str(tmp_path / "ck"), state=state)
        # scribble over the live state, then restore it
        for chunk in state.optimizer.chunks:
            state.optimizer.store.read(chunk.index).fill_(7)
            for sp in chunk.staging:
                chunk.opt.state[sp]["step"].fill_(9)
        acc.load_state(str(tmp_path / "ck"), state=state)
        got = state.optimizer.state_dict()
        for a, b in zip(want["chunks"], got["chunks"]):
            assert torch.equal(a["buffer"], b["buffer"])
            assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
            for k in a["optimizer"]["state"]:
                assert torch.equal(a["optimizer"]["state"][k]["step"],
                                   b["optimizer"]["state"][k]["step"])


class TestOverlapWindow:
    """Chunks in flight (``offload_update_overlap``): the window changes when
    the host waits, never what is computed."""

    def _train(self, overlap, steps=4):
        acc = _port(offload_optimizer=True, offload_update_chunk_mb=1,
                    offload_update_overlap=overlap)
        state, _ = _train(acc, steps=steps)
        assert acc._chunk_info["overlap"] == overlap
        return state

    def test_overlap_matches_serialized(self):
        s1, s2 = self._train(1), self._train(2)
        _assert_bitwise(_params(s1), _params(s2))
        _assert_state_bitwise(s1.optimizer, s2.optimizer)


class TestAutoChunkBytes:
    SHAPE = (2_130_000, 1000)

    def _both(self, shape, **kw):
        got = cu.auto_chunk_bytes([shape], **kw)
        want = jcu.auto_chunk_bytes({"w": jax.ShapeDtypeStruct(shape, jnp.float32)}, **kw)
        assert got == want
        return got

    def test_fills_headroom(self):
        chunk = self._both(self.SHAPE, working_bytes_per_element=2, grad_bytes_per_element=2,
                           shard_degree=1, overlap=1, hbm_bytes=16 << 30)
        assert (700 << 20) < chunk < (1200 << 20)

    def test_sharding_scales_global_chunk(self):
        kw = dict(working_bytes_per_element=2, grad_bytes_per_element=2, overlap=2,
                  hbm_bytes=16 << 30)
        c1 = self._both(self.SHAPE, shard_degree=1, **kw)
        c4 = self._both(self.SHAPE, shard_degree=4, **kw)
        assert c4 > 2 * c1

    def test_clamps_to_floor_when_no_headroom(self):
        chunk = self._both((8_000_000, 1000), working_bytes_per_element=2,
                           grad_bytes_per_element=2, overlap=2, hbm_bytes=16 << 30)
        assert chunk == 64 << 20

    def test_detect_hbm_has_fallback(self):
        assert cu.detect_hbm_bytes("cpu") == 16 << 30
        assert cu.detect_hbm_bytes() >= 8 << 30

    def test_accelerator_resolves_auto(self):
        acc = _port(offload_optimizer=True, offload_update_chunk_mb=-1)
        state = acc.create_train_state(params=Regression(_np_params()), tx=_adamw())
        jacc = _jax(offload_optimizer=True, offload_update_chunk_mb=-1)
        jacc.create_train_state(params=_np_params(), tx=optax.adamw(LR), seed=0)
        # tiny params on a >= 16 GB budget: one chunk, chunking dissolves
        assert acc._chunk_info is None and jacc._chunk_info is None
        assert len(state.optimizer.chunks) == 1


class TestNvmeTier:
    """The state in files (``offload_optimizer_nvme_path``): bitwise the
    host-memory path; the state lives in ``.dat`` files, not in memory."""

    def test_matches_in_memory_training(self, tmp_path):
        acc_d = _port(offload_optimizer=True, offload_optimizer_nvme_path=str(tmp_path / "opt"),
                      offload_update_chunk_mb=1)
        state_d, _ = _train(acc_d, steps=4)
        store = acc_d._chunk_info.get("disk_store")
        assert isinstance(store, cu.DiskChunkStore) and state_d.optimizer.store is store
        dats = [f for _, _, files in os.walk(tmp_path / "opt") for f in files
                if f.endswith(".dat")]
        assert len(dats) == len(acc_d._chunk_info["groups"])
        state_h, _ = _train(_port(offload_optimizer=True, offload_update_chunk_mb=1), steps=4)
        _assert_bitwise(_params(state_d), _params(state_h))
        _assert_state_bitwise(state_d.optimizer, state_h.optimizer)
        jacc = _jax(offload_optimizer=True, offload_optimizer_nvme_path=str(tmp_path / "jopt"),
                    offload_update_chunk_mb=1)
        _assert_near_jax(state_d, _jtrain(jacc, steps=4))

    def test_rejects_unchunkable_state(self, tmp_path):
        kw = dict(offload_optimizer=True, offload_optimizer_nvme_path=str(tmp_path / "opt"),
                  offload_update_chunk_mb=1024)  # the whole tiny state fits one chunk
        with pytest.raises(ValueError, match="single chunk") as got:
            _port(**kw).create_train_state(params=Regression(_np_params()), tx=_adamw())
        with pytest.raises(ValueError, match="single chunk") as want:
            _jax(**kw).create_train_state(params=_np_params(), tx=optax.adamw(LR), seed=0)
        assert str(got.value) == str(want.value)
        kw = dict(offload_optimizer=False, offload_optimizer_nvme_path=str(tmp_path / "opt"))
        with pytest.raises(ValueError, match="requires offload_optimizer") as got:
            _port(**kw).create_train_state(params=Regression(_np_params()), tx=_adamw())
        with pytest.raises(ValueError, match="requires offload_optimizer") as want:
            _jax(**kw).create_train_state(params=_np_params(), tx=optax.adamw(LR), seed=0)
        assert str(got.value) == str(want.value)

    def test_gradient_accumulation_on_disk(self, tmp_path):
        _reset_port()
        acc = Accelerator(cpu=True, gradient_accumulation_steps=2, fsdp_plugin=FSDP(
            sharding_strategy="NO_SHARD", offload_optimizer=True,
            offload_optimizer_nvme_path=str(tmp_path / "opt"), offload_update_chunk_mb=1))
        model = Regression(_np_params())
        state = acc.create_train_state(params=model, tx=_adamw())
        step = acc.compile_train_step(_loss)
        batch = {k: torch.from_numpy(v) for k, v in _np_batch().items()}
        p0 = model.w1.detach().clone()
        state, _ = step(state, batch)
        assert torch.equal(model.w1, p0)
        state, _ = step(state, batch)
        assert state.step == 1 and not torch.equal(model.w1, p0)


class TestMasterWeights:
    """f32 masters inside the (offloaded) optimizer state, the module in the
    compute dtype (``with_master_weights``)."""

    def test_fp32_wrapper_matches_plain(self):
        params = [_np_params()[k] for k in ("b", "w1", "w2")]
        runs = []
        for wrap in (False, True):
            ps = [nn.Parameter(torch.from_numpy(v.copy())) for v in params]
            opt = (cu.with_master_weights(_adamw()) if wrap else _adamw())(ps)
            for _ in range(3):
                for p in ps:
                    p.grad = torch.full_like(p, 0.01)
                opt.step()
            runs.append([p.detach().numpy().copy() for p in ps])
        for a, b in zip(*runs):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        # and the JAX wrapper's
        jparams = dict(zip(("b", "w1", "w2"), params))
        tx = jcu.with_master_weights(optax.adamw(LR, eps=EPS, weight_decay=WD))
        js = tx.init(jparams)
        jp = jparams
        for _ in range(3):
            u, js = tx.update(jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), jp), js, jp)
            jp = optax.apply_updates(jp, u)
        for a, name in zip(runs[1], ("b", "w1", "w2")):
            np.testing.assert_allclose(a, np.asarray(jp[name]), atol=ATOL, err_msg=name)

    def test_bf16_training_with_masters(self):
        _reset_port()
        acc = Accelerator(cpu=True, mixed_precision="bf16", fsdp_plugin=FSDP(
            sharding_strategy="NO_SHARD", offload_optimizer=True, offload_update_chunk_mb=1))
        model = Regression(_np_params())
        state = acc.create_train_state(params=model, tx=_adamw())
        # the module holds compute-dtype working weights; the f32 masters live
        # in the offloaded state
        assert model.w1.dtype == torch.bfloat16 and acc._offload_master
        masters = state.optimizer.host_state("master")
        assert all(m.dtype == torch.float32 for m in masters)
        np.testing.assert_array_equal(masters[1].numpy(), _np_params()["w1"])
        step = acc.compile_train_step(_loss, max_grad_norm=1.0)
        batch = {k: torch.from_numpy(v) for k, v in _np_batch().items()}
        first = None
        for _ in range(30):
            state, metrics = step(state, batch)
            first = first if first is not None else float(metrics["loss"])
        assert float(metrics["loss"]) < first * 0.7
        # the working weights track cast(master) within the rounding of the
        # delta add
        masters = state.optimizer.host_state("master")
        for p, m in zip(model.parameters(), masters):
            np.testing.assert_allclose(p.detach().float().numpy(),
                                       m.to(torch.bfloat16).float().numpy(),
                                       rtol=2e-2, atol=1e-3)


class TestHostStore:
    """The pinned host tier never falls back to pageable memory."""

    def test_failed_registration_raises(self, monkeypatch):
        class Cudart:
            def cudaHostRegister(self, ptr, nbytes, flags):
                return 2                                  # cudaErrorMemoryAllocation

        monkeypatch.setattr(torch.cuda, "cudart", Cudart)
        store = cu.HostChunkStore(pin=True)
        store.allocate(0, 1000)
        with pytest.raises(RuntimeError, match="cudaHostRegister"):
            store.commit()
        assert store.pinned_bytes() == 0

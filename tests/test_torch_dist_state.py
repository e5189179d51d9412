"""Port parity across processes: launchers, process state, collectives and the sharded data loaders.

The index math (``BatchSamplerShard``, ``IterableDatasetShard``, the skip
samplers) and the pure tree operations are held against the JAX package's
own functions in this process, for every process index of worlds of 2, 3
and 4.  What needs real processes runs in one ``gloo`` world of 2 spawned
through the port's ``debug_launcher`` (the rank functions are in
``tests/torch_dist_workers.py``): the state a rank sees, ``gather``,
``gather_object``, ``pad_across_processes``, ``reduce``, ``broadcast``,
the prepared loaders (even and uneven, ``split_batches``, ``drop_last``,
the seedable shuffle over two epochs, ``dispatch_batches``),
``gather_for_metrics`` and debug mode.  Each rank's rows are held against
the rows the JAX package places on the mesh position of the same index
(one process, a ``dp`` mesh of 2 CPU devices), and the collectives against
the JAX package's results on the global arrays those ranks' values make.
Everything compared is integers or exact sums: the tolerance is zero.
"""

import datetime
import itertools
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu import data_loader as jdl
from accelerate_tpu.parallel.mesh import build_mesh as jbuild_mesh
from accelerate_tpu.parallel.mesh import data_sharding as jdata_sharding
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils import operations as jops
from accelerate_tpu_torch import data_loader as dl
from accelerate_tpu_torch import launchers
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.utils import operations as ops

import torch_dist_workers as workers

N_ROWS = 22
LOADERS = {
    "even": dict(batch_size=4),
    "uneven": dict(batch_size=3),
    "uneven_not_even": dict(batch_size=3, even=False),
    "split": dict(batch_size=4, split=True),
    "split_uneven": dict(batch_size=6, split=True),
    "drop_last": dict(batch_size=4, drop_last=True),
    "shuffle": dict(batch_size=4, shuffle=True, seed=7, epochs=2),
    "dispatch_split": dict(batch_size=4, split=True, dispatch=True),
    "dispatch": dict(batch_size=3, dispatch=True),
}

@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """The JAX train step beats the process-wide flight recorder's heartbeat.
    With telemetry off it beats none, so a ``/healthz`` check that runs later
    in the same process does not find this module's heartbeat gone stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)



def _dataset():
    return [{"x": np.array([i], dtype=np.int64)} for i in range(N_ROWS)]


# ------------------------------------------------------------- index math
@pytest.mark.parametrize("n,batch_size,split,even,drop_last", [
    (n, bs, split, even, drop)
    for n, bs, split, even, drop in itertools.product((2, 3, 4), (2, 3, 4, 6), (False, True),
                                                      (True, False), (False, True))
    if not split or bs % n == 0
])
@pytest.mark.parametrize("length", [3, 16, 21, 24])
def test_batch_sampler_shard_matches_jax(n, batch_size, split, even, drop_last, length):
    for i in range(n):
        inner = dl.BatchSampler(range(length), batch_size, drop_last)
        jinner = jdl.BatchSampler(range(length), batch_size, drop_last)
        got = dl.BatchSamplerShard(inner, n, i, split_batches=split, even_batches=even)
        want = jdl.BatchSamplerShard(jinner, n, i, split_batches=split, even_batches=even)
        assert list(got) == list(want)
        assert len(got) == len(want)


def test_batch_sampler_shard_refuses_what_the_reference_refuses():
    for mod in (dl, jdl):
        with pytest.raises(ValueError, match="round multiple"):
            mod.BatchSamplerShard(mod.BatchSampler(range(8), 3), 2, 0, split_batches=True)


@pytest.mark.parametrize("n,batch_size,split,even,drop_last", [
    (n, bs, split, even, drop)
    for n, bs, split, even, drop in itertools.product((2, 3), (2, 4, 6), (False, True),
                                                      (True, False), (False, True))
    if not split or bs % n == 0
])
@pytest.mark.parametrize("length", [5, 16, 23])
def test_iterable_dataset_shard_matches_jax(n, batch_size, split, even, drop_last, length):
    for i in range(n):
        kw = dict(batch_size=batch_size, drop_last=drop_last, num_processes=n,
                  process_index=i, split_batches=split, even_batches=even)
        got = dl.IterableDatasetShard(list(range(length)), **kw)
        want = jdl.IterableDatasetShard(list(range(length)), **kw)
        assert list(got) == list(want)
        assert len(got) == len(want)


def test_skip_samplers_match_jax():
    for skip in (0, 1, 3):
        got = dl.SkipBatchSampler(dl.BatchSampler(range(10), 3), skip)
        want = jdl.SkipBatchSampler(jdl.BatchSampler(range(10), 3), skip)
        assert list(got) == list(want) and len(got) == len(want)
        assert got.total_length == want.total_length
        assert list(dl.SkipDataLoader([[1], [2], [3]], skip)) == \
            list(jdl.SkipDataLoader([[1], [2], [3]], skip))


class _Topology:
    def __init__(self, n, i):
        self.num_processes, self.process_index = n, i


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("padding", [False, True])
def test_split_between_processes_matches_jax(n, padding):
    inputs = [list(range(7)), {"a": list(range(5)), "b": list("abcde")}, np.arange(9)]
    for i in range(n):
        for value in inputs:
            with PartialState.split_between_processes(_Topology(n, i), value,
                                                      apply_padding=padding) as got, \
                    JPartialState.split_between_processes(_Topology(n, i), value,
                                                          apply_padding=padding) as want:
                if isinstance(want, dict):
                    assert {k: list(v) for k, v in got.items()} == \
                        {k: list(v) for k, v in want.items()}
                else:
                    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --------------------------------------------------------- pure operations
def test_tree_operations_match_jax():
    tree = {"a": np.arange(6).reshape(3, 2), "b": [np.arange(3), (np.ones(3),)]}
    assert ops.find_batch_size(tree) == jops.find_batch_size(tree) == 3
    assert ops.ignorant_find_batch_size({"s": 1}) is jops.ignorant_find_batch_size({"s": 1})
    assert ops.listify(tree) == jops.listify(tree)
    np.testing.assert_array_equal(ops.pad_input_tensors(np.arange(5), 5, 4),
                                  jops.pad_input_tensors(np.arange(5), 5, 4))
    got = ops.pad_input_tensors(torch.arange(10).reshape(5, 2), 5, 3)
    np.testing.assert_array_equal(got.numpy(), jops.pad_input_tensors(np.arange(10).reshape(5, 2),
                                                                      5, 3))
    parts = [{"x": np.arange(2)}, {"x": np.arange(2, 5)}]
    np.testing.assert_array_equal(ops.concatenate(parts)["x"], jops.concatenate(parts)["x"])
    np.testing.assert_array_equal(ops.slice_tensors(tree, slice(1, 2))["a"],
                                  jops.slice_tensors(tree, slice(1, 2))["a"])
    half = {"h": torch.ones(2, dtype=torch.bfloat16), "i": torch.ones(2, dtype=torch.int32)}
    out = ops.convert_to_fp32(half)
    assert out["h"].dtype == torch.float32 and out["i"].dtype == torch.int32
    wrapped = ops.convert_outputs_to_fp32(lambda: torch.ones(1, dtype=torch.float16))
    assert pickle.loads(pickle.dumps(ops.ConvertOutputsToFp32(_half)))().dtype == torch.float32
    assert wrapped().dtype == torch.float32
    from collections import namedtuple

    Pair = namedtuple("Pair", "a b")
    assert ops.honor_type(Pair(1, 2), iter([3, 4])) == jops.honor_type(Pair(1, 2), iter([3, 4]))
    with pytest.raises(TypeError):
        ops.recursively_apply(lambda x: x, {"s": "str"}, error_on_other_type=True)


def _half():
    return torch.ones(1, dtype=torch.float16)


# ---------------------------------------------------------------- launchers
def test_notebook_launcher_gives_each_rank_a_card(monkeypatch):
    # a call that runs the function here sets its precision in this process:
    # the monkeypatch takes it out again after the test
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 card"):
        launchers.notebook_launcher(print, num_processes=2)
    with pytest.raises(ValueError, match="mixed_precision"):
        launchers.notebook_launcher(print, mixed_precision="fp64")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launchers.notebook_launcher(lambda x: x + 1, (1,)) == 2


def test_notebook_launcher_without_a_card_raises(monkeypatch):
    """Several ranks and no card: the launcher raises and names the CPU's
    launcher, rather than running the function on the host."""
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card is visible.*debug_launcher"):
        launchers.notebook_launcher(print, num_processes=2)
    with pytest.raises(RuntimeError, match="no card is visible"):
        launchers.notebook_launcher(print, num_nodes=2)
    assert os.environ["ACCELERATE_MIXED_PRECISION"] == ""  # a refused launch sets nothing


def test_ranks_past_the_deadline_fail_the_launch():
    """Both ranks outlive the deadline (as in a deadlocked collective): the
    launcher stops them and raises."""
    envs = launchers._envs(2, f"127.0.0.1:{launchers._free_port()}")
    with pytest.raises(RuntimeError, match=r"workers \[0, 1\] failed \(stopped at the 1.0 s"):
        launchers._spawn(workers.sleeps, (120,), envs, cpu=True, what="test",
                         rendezvous=False, deadline_s=1.0)


def test_a_failing_rank_fails_the_launch(monkeypatch):
    """Rank 1 raises while rank 0 waits in a barrier it can never leave:
    the launcher stops rank 0 after the grace period and raises with rank
    1's traceback."""
    monkeypatch.setattr(launchers, "FAILURE_GRACE_S", 1.0)
    with pytest.raises(RuntimeError, match="rank one fails on purpose") as info:
        launchers.debug_launcher(workers.fails_on_rank_one, num_processes=2)
    assert "debug_launcher workers" in str(info.value)


# ------------------------------------------------------------- one world
def _load(out_dir, tag, world=2):
    out = []
    for r in range(world):
        with open(out_dir / f"{tag}_rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dist_state")
    samples = {"dataset": _dataset(), "loaders": LOADERS, "iterable_n": 13}
    launchers.debug_launcher(workers.state_world, (str(out_dir), samples, 10), num_processes=2)
    own = tmp_path_factory.mktemp("own_rendezvous")
    envs = launchers._envs(2, f"127.0.0.1:{launchers._free_port()}")
    for env in envs:
        # two nodes of one process each (local index 0): the hybrid mesh's dp
        env["ACCELERATE_USE_CPU"] = "true"
        env["ACCELERATE_LOCAL_PROCESS_ID"] = "0"
    launchers._spawn(workers.own_rendezvous, (str(own),), envs, cpu=True, what="test",
                     rendezvous=False)
    # torchrun's group: two nodes of one process each, both LOCAL_RANK 0
    torchrun = tmp_path_factory.mktemp("torchrun")
    port = str(launchers._free_port())
    envs = [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "RANK": str(r),
             "LOCAL_RANK": "0", "WORLD_SIZE": "2"} for r in range(2)]
    launchers._spawn(workers.torchrun_group, (str(torchrun),), envs, cpu=True, what="test",
                     rendezvous=False)
    return {"state": _load(out_dir, "state"), "metrics": _load(out_dir, "metrics"),
            "debug": _load(out_dir, "debug"), "own": _load(own, "own"),
            "torchrun": _load(torchrun, "torchrun")}


def test_each_rank_sees_the_process_group(world):
    for rank, out in enumerate(world["state"]):
        assert (out["num_processes"], out["process_index"], out["local_process_index"]) == \
            (2, rank, rank)
        assert out["distributed_type"] == "MULTI_CPU"  # the reference's, for processes on a host
        assert out["device"] == "cpu" and out["backend"] == "gloo"
        assert out["is_main"] == (rank == 0) and out["is_last"] == (rank == 1)
        with JPartialState.split_between_processes(_Topology(2, rank), list(range(7))) as want:
            assert out["split"] == want
        with JPartialState.split_between_processes(_Topology(2, rank), list(range(7)),
                                                   apply_padding=True) as want:
            assert out["split_padded"] == want


def test_init_process_group_kwargs_reach_the_rendezvous(world):
    for rank, out in enumerate(world["own"]):
        assert (out["backend"], out["world"], out["rank"], out["device"]) == \
            ("gloo", 2, rank, "cpu")
        assert out["same"] and out["mesh"] == {"dp": 2}
        assert out["env"]["ACCELERATE_NUM_PROCESSES"] == "2"
        assert out["env"]["ACCELERATE_PROCESS_ID"] == str(rank)
        assert out["env"]["ACCELERATE_LOCAL_PROCESS_ID"] == "0"
        # HYBRID_SHARD over two nodes: dp spans the nodes, fsdp (size 1) drops out
        assert out["default_meshes"]["hybrid"] == {"dp": 2}


def test_a_torchrun_group_takes_local_rank(world):
    """A group made before the state, with torchrun's variables only: the
    local index is ``LOCAL_RANK`` (not the global rank, which would name a
    card the node lacks), so the two processes count as two nodes."""
    for rank, out in enumerate(world["torchrun"]):
        assert out == {"local": 0, "rank": rank, "world": 2, "nodes": 2, "local_main": True}


@pytest.mark.parametrize("name,want", [
    ("none", {"dp": 2}), ("tp2", {"dp": 1, "tp": 2}), ("full_shard", {"dp": 1, "fsdp": 2}),
    ("hybrid", {"dp": 1, "fsdp": 2}), ("no_shard", {"dp": 2}), ("zero1", {"dp": 1, "fsdp": 2}),
])
def test_plugins_derive_the_reference_mesh(world, name, want):
    """``_default_mesh`` on a world of 2 processes of one node: the mesh the
    JAX package derives for 2 devices with the same plugin."""
    from accelerate_tpu.accelerator import Accelerator as JAccelerator
    from accelerate_tpu.state import AcceleratorState as JAcceleratorState
    from accelerate_tpu.state import GradientState as JGradientState
    from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JFSDP
    from accelerate_tpu.utils.dataclasses import ModelParallelPlugin as JMP
    from accelerate_tpu.utils.dataclasses import ZeroPlugin as JZero

    kw = {"none": {}, "tp2": dict(megatron_lm_plugin=JMP(2)),
          "full_shard": dict(fsdp_plugin=JFSDP()),
          "hybrid": dict(fsdp_plugin=JFSDP(sharding_strategy="HYBRID_SHARD")),
          "no_shard": dict(fsdp_plugin=JFSDP(sharding_strategy="NO_SHARD")),
          "zero1": dict(deepspeed_plugin=JZero(zero_stage=1))}[name]
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)
    try:
        ref = JAccelerator(mesh=None, **kw)
        # the reference over 8 devices: its axes scaled to 2 (dp and fsdp fill)
        ref_axes = dict(ref.mesh.shape)
    finally:
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)
    for out in world["state"]:
        assert out["default_meshes"][name] == want
    assert set(want) == set(ref_axes), (want, ref_axes)


def test_hybrid_mesh_validates_dcn_axes_as_the_reference(world):
    for out in world["state"]:
        assert out["dcn_mesh"] == {"dp": 2}
        assert "must divide" in out["dcn_not_dividing"]
        assert "not present" in out["dcn_unknown"]


def _jax_global(per_rank):
    """The reference's global array over a dp mesh of the ranks' values
    (rank i's value on mesh position i)."""
    mesh = jbuild_mesh({"dp": len(per_rank)})
    return jax.device_put(np.concatenate(per_rank), jdata_sharding(mesh))


def test_collectives_match_jax(world):
    outs = world["state"]
    values = [np.arange(3, dtype=np.float32) + 10 * r for r in range(2)]
    want_gather = np.asarray(jops.gather(_jax_global(values)))
    want_sum = np.asarray(jops.reduce(_jax_global([np.array([1.0, 2.0]) * (r + 1)
                                                   for r in range(2)]), "sum"))
    want_mean = np.asarray(jops.reduce(_jax_global([np.array([1.0, 2.0]) * (r + 1)
                                                    for r in range(2)]), "mean", scale=2.0))
    for out in outs:
        np.testing.assert_array_equal(out["gather"], want_gather)
        np.testing.assert_array_equal(out["gather_scalar"], [0.0, 1.0])
        assert out["gather_object"] == [{"rank": 0}, {"rank": 1}]
        assert out["gather_object_list"] == [0, 0, 1, 1]
        np.testing.assert_array_equal(out["reduce_sum"], want_sum)
        np.testing.assert_array_equal(out["reduce_mean"], want_mean)
        np.testing.assert_array_equal(out["broadcast"], [1.0, 1.0])
        assert out["broadcast_objects"] == ["from 0", {"k": 0}]
    # pad_across_processes: every rank's rows padded to the longest (2) with pad_index
    np.testing.assert_array_equal(outs[0]["pad"], [[1, 1], [-1, -1]])
    np.testing.assert_array_equal(outs[0]["pad_first"], [[-1, -1], [1, 1]])
    np.testing.assert_array_equal(outs[1]["pad"], [[2, 2], [2, 2]])


def test_debug_mode_raises_on_every_rank_instead_of_deadlocking(world):
    for out in world["debug"]:
        for name in ("gather", "reduce", "pad_across_processes"):
            assert out[name] is not None and "shape mismatches" in out[name], name
        assert "Process 0: [[1, 3]]" in out["gather"] and "Process 1: [[2, 3]]" in out["gather"]
        # chained, as the reference chains it: the outer operation named
        assert out["pad_across_processes"].startswith("Error found while calling")
        assert out["same_shape_ok"] == 4


def _jax_positions(kw):
    """Per epoch, per global batch, the rows the reference places on mesh
    positions 0 and 1 of a dp mesh of 2 (one process)."""
    from accelerate_tpu.accelerator import Accelerator as JAccelerator
    from accelerate_tpu.state import AcceleratorState as JAcceleratorState
    from accelerate_tpu.state import GradientState as JGradientState
    from accelerate_tpu.utils.dataclasses import DataLoaderConfiguration as JDLC

    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)
    try:
        acc = JAccelerator(mesh={"dp": 2}, dataloader_config=JDLC(
            split_batches=True, dispatch_batches=kw.get("dispatch", False),
            use_seedable_sampler=kw.get("shuffle", False)))
        global_batch = kw["batch_size"] * 2 if not kw.get("split") else kw["batch_size"]
        base = jdl.SimpleDataLoader(_dataset(), batch_size=global_batch,
                                    shuffle=kw.get("shuffle", False), seed=kw.get("seed", 0),
                                    drop_last=kw.get("drop_last", False))
        loader = acc.prepare(base)
        epochs = []
        for _ in range(kw.get("epochs", 1)):
            batches = []
            for batch in loader:
                x = batch["x"]
                shards = sorted(x.addressable_shards, key=lambda s: s.index[0].start or 0)
                if x.shape[0] != global_batch:
                    # a ragged last batch: one process splits (or replicates)
                    # what is there, several even it out by the samplers'
                    # index math, which the test holds instead
                    batches.append(None)
                else:
                    batches.append([np.asarray(s.data)[:, 0] for s in shards])
            epochs.append(batches)
        return epochs
    finally:
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)


@pytest.mark.parametrize("name", list(LOADERS))
def test_each_rank_gets_its_mesh_positions_rows(world, name):
    """A prepared loader's batches on rank ``i``: the rows the reference
    puts on mesh position ``i`` for the same global batches; a ragged last
    batch is held against the reference's index math across processes
    (``BatchSamplerShard`` / the dispatcher's padding)."""
    kw = LOADERS[name]
    outs = [out["loaders"][name] for out in world["state"]]
    want = _jax_positions(kw)
    for epoch, want_batches in enumerate(want):
        got = [outs[r][epoch] for r in range(2)]
        assert len(got[0]) == len(got[1])
        full = [b for b in want_batches if b is not None]
        for b, pair in enumerate(want_batches):
            if pair is None:
                continue
            for r in range(2):
                np.testing.assert_array_equal(got[r][b]["x"][:, 0], pair[r])
        assert len(full) <= len(got[0])
        for r in range(2):
            assert [b["end"] for b in got[r]] == [False] * (len(got[r]) - 1) + [True]
    if kw.get("shuffle"):
        # the seedable shuffle reseeds per epoch, the same on both ranks
        assert not np.array_equal(outs[0][0][0]["x"], outs[0][1][0]["x"])
    if not kw.get("dispatch"):
        base = dl.BatchSampler(range(N_ROWS), kw["batch_size"], kw.get("drop_last", False))
        for r in range(2):
            shard = dl.BatchSamplerShard(base, 2, r, split_batches=kw.get("split", False),
                                         even_batches=kw.get("even", True))
            if not kw.get("shuffle"):
                assert [list(b["x"][:, 0]) for b in outs[r][0]] == list(shard)


def test_dispatched_ragged_batch_is_padded_and_dropped_by_remainder(world):
    """``dispatch``: 22 rows in global batches of 6 (3 a rank): the last, 4
    rows, is split 2 + 2; ``dispatch_split`` (4 a global batch): the last
    2 rows split 1 + 1.  ``remainder`` is what ``gather_for_metrics``
    keeps."""
    outs = [out["loaders"]["dispatch"][0] for out in world["state"]]
    assert [list(b["x"][:, 0]) for b in outs[0]][-1] == [18, 19]
    assert [list(b["x"][:, 0]) for b in outs[1]][-1] == [20, 21]
    assert outs[0][-1]["remainder"] == N_ROWS % 6
    split = [out["loaders"]["dispatch_split"][0] for out in world["state"]]
    assert [list(b["x"][:, 0]) for b in split[0]][-1] == [20]
    assert [list(b["x"][:, 0]) for b in split[1]][-1] == [21]


def test_iterable_dataset_shard_in_the_world(world):
    for rank, out in enumerate(world["state"]):
        want = jdl.IterableDatasetShard(list(range(13)), batch_size=4, num_processes=2,
                                        process_index=rank)
        assert out["iterable"] == list(want)
        want = jdl.IterableDatasetShard(list(range(13)), batch_size=4, num_processes=2,
                                        process_index=rank, split_batches=True)
        assert out["iterable_split"] == list(want)


def test_gather_for_metrics_drops_the_remainder(world):
    """10 rows in global batches of 8 (4 a rank): the last global batch is
    2 real rows padded to 8 by ``even_batches``; gathered, the remainder
    keeps the first 2."""
    for out in world["metrics"]:
        seen = out["seen"]
        assert [list(s) for s in seen] == [[0, 1, 2, 3, 4, 5, 6, 7], [8, 9]]
        assert out["objects"] == ["a", "a"]


def test_timeout_is_taken_by_the_single_process_state(monkeypatch):
    """``PartialState(timeout=...)``, ``backend=`` and ``init_method=`` are
    taken (they reach the rendezvous when there is one; the world test
    holds that), and an unknown backend raises."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    for key in ("ACCELERATE_COORDINATOR_ADDRESS", "ACCELERATE_NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    try:
        state = PartialState(cpu=True, timeout=datetime.timedelta(seconds=5), backend="gloo")
        assert state.num_processes == 1 and state.distributed_type == "NO"
        PartialState._reset_state()
        with pytest.raises(ValueError, match="backend"):
            PartialState(cpu=True, backend="mpi")
    finally:
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)


def test_replica_meshes_split_the_processes(monkeypatch):
    """``replica_meshes`` over one process: one replica of one rank, and more
    replicas than processes refused with the reference's message."""
    from accelerate_tpu.parallel.mesh import replica_meshes as jreplica_meshes
    from accelerate_tpu_torch.parallel.mesh import replica_meshes
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    for key in ("ACCELERATE_COORDINATOR_ADDRESS", "ACCELERATE_NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    try:
        PartialState(cpu=True)
        meshes = replica_meshes(1)
        assert [dict(m.shape) for m in meshes] == [dict(m.shape) for m in jreplica_meshes(
            1, devices=jax.devices()[:1])] == [{"dp": 1}]
        assert meshes[0].devices.tolist() == [0] and meshes[0].device_mesh is None
        with pytest.raises(ValueError, match="exceeds"):
            replica_meshes(2)
        with pytest.raises(ValueError, match="exceeds"):
            jreplica_meshes(2, devices=jax.devices()[:1])
    finally:
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)

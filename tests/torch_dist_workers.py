"""Rank functions of the port's multi-process tests.

Each runs inside a process that ``accelerate_tpu_torch.launchers.
debug_launcher`` spawned (``gloo`` over localhost, one CPU "device" a
process).  This module imports torch, numpy and the port only — never
JAX, which the test files run in the pytest process — and takes numpy
arrays; each rank writes what the test compares into ``out_dir`` as a
pickle (``<tag>_rank<i>.pkl``).
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np
import torch


def _setup():
    torch.set_num_threads(1)


def _reset():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    GradientState._reset_state()
    AcceleratorState._reset_state()


def _dump(out_dir, tag, obj):
    import torch.distributed as dist

    with open(os.path.join(out_dir, f"{tag}_rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().float().numpy() if tree.is_floating_point() \
            else tree.detach().cpu().numpy()
    return tree


# ------------------------------------------------------------------ training
def make_accelerator(case: dict, accum: int = 2):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import (
        CollectiveKwargs,
        FullyShardedDataParallelPlugin,
        ModelParallelPlugin,
        ZeroPlugin,
    )

    kw = {}
    if case.get("fsdp") is not None:
        kw["fsdp_plugin"] = FullyShardedDataParallelPlugin(**case["fsdp"])
    if case.get("zero") is not None:
        kw["deepspeed_plugin"] = ZeroPlugin(zero_stage=case["zero"])
    if case.get("tp"):
        kw["megatron_lm_plugin"] = ModelParallelPlugin(tp_degree=case["tp"])
    if case.get("powersgd"):
        kw["kwargs_handlers"] = [CollectiveKwargs(comm_hook="powersgd",
                                                  powersgd_rank=case["powersgd"],
                                                  comm_hook_min_size=case.get("min_size", 4096))]
    return Accelerator(cpu=True, gradient_accumulation_steps=accum, mesh=case.get("mesh"), **kw)


def make_model(jparams, cfg_kw=None):
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.weights import params_from_jax

    model = Transformer(TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                               attention_impl="pallas", **(cfg_kw or {})),
                        device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    return model


def train_cases(out_dir, cases, jparams, ids, rows, hyper):
    """Each case: a fresh Accelerator over ``case["mesh"]`` with its
    plugins, AdamW, the loader of ``ids`` (``rows`` global rows a batch,
    this rank's shard of them), ``compile_train_step`` with
    ``max_grad_norm``; per call the loss, grad norm and applied flag, and
    after each applied step the whole parameters (gathered).  PowerSGD
    cases start from the JAX state handed in ``case["comm_state"]``."""
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.models.transformer import lm_loss_fn

    _setup()
    for case in cases:
        _reset()
        acc = make_accelerator(case)
        model = make_model(jparams)
        state = acc.create_train_state(params=model, tx=functools.partial(
            torch.optim.AdamW, lr=hyper["lr"], betas=hyper["betas"], eps=hyper["eps"],
            weight_decay=hyper["wd"]))
        if case.get("comm_state") is not None:
            rank = acc.mesh.axis_index("dp")
            state.comm_state = {
                name: None if st is None else {
                    "q": torch.from_numpy(st["q"]).float(),
                    "error": torch.from_numpy(st["error"][rank]).float()}
                for name, st in case["comm_state"].items()}
        n_data = acc.mesh.size // (acc.mesh.shape.get("tp", 1))
        data = [{"input_ids": ids[i]} for i in range(len(ids))]
        loader = acc.prepare(SimpleDataLoader(data, batch_size=rows // n_data))
        step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=hyper["max_grad_norm"])
        records = []
        for batch in loader:
            state, m = step(state, batch)
            rec = {k: float(m[k]) for k in ("loss", "grad_norm")}
            rec["applied"] = bool(m["applied"])
            rec["rows"] = batch["input_ids"][:, 0].numpy().copy()
            if rec["applied"]:
                rec["params"] = _np(acc.get_state_dict(state))
            records.append(rec)
        # the eval step on this rank's rows of the first global batch,
        # averaged over the processes (ranks of one tp group hold the same rows)
        from accelerate_tpu_torch.parallel.mesh import data_shard_index

        lo = data_shard_index(acc.mesh) * (rows // n_data)
        ev = acc.compile_eval_step(lm_loss_fn(model))(
            state, {"input_ids": torch.from_numpy(ids[lo:lo + rows // n_data])})
        eval_loss = float(acc.reduce(ev.reshape(1), "mean")[0])
        shardings = {name: (tuple(p.shape), tuple(p.atpu_sharding.spec))
                     for name, p in model.named_parameters()}
        masters = {name: e["master"] is not None for name, e in state.layout.entries.items()}
        _dump(out_dir, case["tag"], {"records": records, "shardings": shardings,
                                     "masters": masters, "eval_loss": eval_loss,
                                     "optimizer": type(state.optimizer).__name__,
                                     "chunks": len(getattr(state.optimizer, "chunks", ())),
                                     "distributed_type": str(acc.distributed_type),
                                     "mesh": dict(acc.mesh.shape)})


# ------------------------------------------------ state, operations, loader
def state_and_ops(out_dir, samples):
    """The process group, the state's surface, the collectives and the
    data loaders, on the world the launcher made."""
    import torch.distributed as dist

    from accelerate_tpu_torch.data_loader import (
        IterableDatasetShard,
        SimpleDataLoader,
        prepare_data_loader,
    )
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import operations as ops

    _setup()
    state = PartialState()
    rank, world = state.process_index, state.num_processes
    out = {"num_processes": world, "process_index": rank,
           "local_process_index": state.local_process_index,
           "distributed_type": str(state.distributed_type), "device": str(state.device),
           "backend": dist.get_backend(), "is_main": state.is_main_process,
           "is_last": state.is_last_process}
    with state.split_between_processes(list(range(7))) as part:
        out["split"] = part
    with state.split_between_processes(list(range(7)), apply_padding=True) as part:
        out["split_padded"] = part
    with state.main_process_first():
        out["first"] = rank
    out["gather"] = ops.gather(torch.arange(3, dtype=torch.float32) + 10 * rank).numpy()
    out["gather_scalar"] = ops.gather(torch.tensor(float(rank))).numpy()
    out["gather_object"] = ops.gather_object({"rank": rank})
    out["gather_object_list"] = ops.gather_object([rank, rank])
    ragged = torch.ones(rank + 1, 2) * (rank + 1)
    out["pad"] = ops.pad_across_processes(ragged, dim=0, pad_index=-1).numpy()
    out["pad_first"] = ops.pad_across_processes(ragged, dim=0, pad_index=-1,
                                                pad_first=True).numpy()
    out["reduce_sum"] = ops.reduce(torch.tensor([1.0, 2.0]) * (rank + 1), "sum").numpy()
    out["reduce_mean"] = ops.reduce(torch.tensor([1.0, 2.0]) * (rank + 1), "mean",
                                    scale=2.0).numpy()
    out["broadcast"] = ops.broadcast(torch.full((2,), float(rank)), from_process=world - 1).numpy()
    objs = [f"from {rank}", {"k": rank}]
    ops.broadcast_object_list(objs, from_process=0)
    out["broadcast_objects"] = objs

    # the samplers, by each sampler's own index math
    loaders = {}
    for name, kw in samples["loaders"].items():
        base = SimpleDataLoader(samples["dataset"], batch_size=kw["batch_size"],
                                drop_last=kw.get("drop_last", False),
                                shuffle=kw.get("shuffle", False), seed=kw.get("seed", 0))
        dl = prepare_data_loader(base, device="cpu", split_batches=kw.get("split", False),
                                 even_batches=kw.get("even", True),
                                 dispatch_batches=kw.get("dispatch", False),
                                 use_seedable_sampler=kw.get("shuffle", False))
        epochs = []
        for epoch in range(kw.get("epochs", 1)):
            batches = []
            for batch in dl:
                batches.append({"x": batch["x"].numpy().copy(),
                                "end": dl.end_of_dataloader, "remainder": dl.remainder})
            epochs.append(batches)
        loaders[name] = epochs
    out["loaders"] = loaders
    it = IterableDatasetShard(list(range(samples["iterable_n"])), batch_size=4,
                              num_processes=world, process_index=rank)
    out["iterable"] = list(it)
    it_split = IterableDatasetShard(list(range(samples["iterable_n"])), batch_size=4,
                                    num_processes=world, process_index=rank, split_batches=True)
    out["iterable_split"] = list(it_split)
    # meshes: the hybrid mesh's dcn validation, and the meshes the plugins derive
    from accelerate_tpu_torch.parallel.mesh import build_mesh

    out["dcn_mesh"] = dict(build_mesh({"dp": 2}, dcn_axes={"dp": 2}).shape)
    for key, dcn in (("dcn_not_dividing", {"dp": 4}), ("dcn_unknown", {"pp": 2})):
        try:
            build_mesh({"dp": 2}, dcn_axes=dcn)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    out["default_meshes"] = _plugin_meshes()
    _dump(out_dir, "state", out)


def _plugin_meshes():
    """The mesh each plugin derives on this world (``_default_mesh``)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import (
        FullyShardedDataParallelPlugin,
        ModelParallelPlugin,
        ZeroPlugin,
    )

    meshes = {}
    for name, kw in (("none", {}), ("tp2", dict(megatron_lm_plugin=ModelParallelPlugin(2))),
                     ("full_shard", dict(fsdp_plugin=FullyShardedDataParallelPlugin())),
                     ("hybrid", dict(fsdp_plugin=FullyShardedDataParallelPlugin(
                         sharding_strategy="HYBRID_SHARD"))),
                     ("no_shard", dict(fsdp_plugin=FullyShardedDataParallelPlugin(
                         sharding_strategy="NO_SHARD"))),
                     ("zero1", dict(deepspeed_plugin=ZeroPlugin(zero_stage=1)))):
        _reset()
        meshes[name] = dict(Accelerator(cpu=True, **kw).mesh.shape)
    _reset()
    return meshes


def debug_mode_raises(out_dir):
    """``ACCELERATE_DEBUG_MODE``: a collective over rank-dependent shapes
    raises ``DistributedOperationException`` on every rank."""
    os.environ["ACCELERATE_DEBUG_MODE"] = "1"
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import operations as ops

    _setup()
    PartialState._reset_state()
    state = PartialState(cpu=True)
    rank = state.process_index
    raised = {}
    for name, fn in (("gather", ops.gather), ("reduce", ops.reduce),
                     ("pad_across_processes", ops.pad_across_processes)):
        try:
            fn(torch.zeros(rank + 1, 3))
            raised[name] = None
        except ops.DistributedOperationException as e:
            raised[name] = str(e) + (f"\n{e.__cause__}" if e.__cause__ else "")
    raised["same_shape_ok"] = ops.gather(torch.zeros(2, 3)).shape[0]
    _dump(out_dir, "debug", raised)


def gather_for_metrics(out_dir, n_rows):
    """``gather_for_metrics`` over an uneven last batch: the remainder's
    padding dropped."""
    from accelerate_tpu_torch.data_loader import SimpleDataLoader

    _setup()
    _reset()
    acc = make_accelerator({"mesh": None}, accum=1)
    data = [{"x": np.array([i], dtype=np.int64)} for i in range(n_rows)]
    loader = acc.prepare(SimpleDataLoader(data, batch_size=4))
    seen = []
    for batch in loader:
        seen.append(acc.gather_for_metrics(batch["x"][:, 0]).numpy())
    objects = acc.gather_for_metrics(["a"], use_gather_object=True)
    _dump(out_dir, "metrics", {"seen": seen, "objects": objects})


def state_world(out_dir, samples, n_metric_rows):
    """One world's checks in turn: the state and collectives, the loaders,
    ``gather_for_metrics``, then debug mode (it sets its environment)."""
    state_and_ops(out_dir, samples)
    gather_for_metrics(out_dir, n_metric_rows)
    debug_mode_raises(out_dir)


def own_rendezvous(out_dir):
    """A rank that joins the group itself: ``Accelerator`` with
    ``InitProcessGroupKwargs`` (``backend``, ``timeout``) over the
    reference's environment, then ``PartialState(timeout=...)`` again."""
    import datetime

    import torch.distributed as dist

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.dataclasses import InitProcessGroupKwargs

    _setup()
    assert not dist.is_initialized()
    acc = Accelerator(kwargs_handlers=[InitProcessGroupKwargs(
        backend="gloo", timeout=datetime.timedelta(seconds=120))])
    same = PartialState(timeout=datetime.timedelta(seconds=5))
    acc.wait_for_everyone()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "rank": dist.get_rank(), "device": str(acc.device),
           "same": same.process_index == acc.process_index,
           "env": {k: os.environ[k] for k in (
               "ACCELERATE_COORDINATOR_ADDRESS", "ACCELERATE_NUM_PROCESSES",
               "ACCELERATE_PROCESS_ID", "ACCELERATE_LOCAL_PROCESS_ID")},
           "mesh": dict(acc.mesh.shape)}
    out["default_meshes"] = _plugin_meshes()
    _dump(out_dir, "own", out)


def torchrun_group(out_dir):
    """A rank of a group joined before any state, as torchrun leaves it
    (``env://`` from ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``LOCAL_RANK``/``WORLD_SIZE``, none of the reference's variables): the
    state's local index, rank, world and node count."""
    import torch.distributed as dist

    from accelerate_tpu_torch.accelerator import Accelerator

    _setup()
    for key in ("ACCELERATE_COORDINATOR_ADDRESS", "ACCELERATE_NUM_PROCESSES",
                "ACCELERATE_PROCESS_ID", "ACCELERATE_LOCAL_PROCESS_ID"):
        os.environ.pop(key, None)
    dist.init_process_group("gloo")
    acc = Accelerator(cpu=True)
    _dump(out_dir, "torchrun", {
        "local": acc.local_process_index, "rank": acc.process_index,
        "world": acc.num_processes, "nodes": acc._num_nodes(),
        "local_main": acc.is_local_main_process})


def sleeps(seconds):
    """Every rank sleeps (a stand-in for a rank stuck in a collective)."""
    import time

    time.sleep(seconds)


def fails_on_rank_one():
    """Rank 1 raises; rank 0 waits in a barrier it will never leave."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()


# --------------------------------------------------------------- checkpoints
def _full_state(acc, state):
    """Every tensor of a (possibly sharded) train state, whole, as numpy:
    weights, optimizer state and accumulation buffer by parameter name."""
    from accelerate_tpu_torch.parallel.sharding import all_gather_along, gather_axes_order

    layout = state.layout
    opt = {}
    grads = {}
    for name, p in state.model.named_parameters():
        e = None if layout is None else layout.entries[name]
        holder = p if e is None or e["master"] is None else e["master"]
        spec = None if e is None else (e["ospec"] if holder is not p else e["pspec"])

        def whole(t, spec=spec):
            if spec is None or t.ndim == 0:
                return t
            for d, axis in gather_axes_order(spec):
                t = all_gather_along(t, d, layout.mesh.group(axis))
            return t

        # sorted: every rank gathers the same tensor at the same time
        opt[name] = {k: _np(whole(v) if isinstance(v, torch.Tensor) else torch.tensor(v))
                     for k, v in sorted(state.optimizer.state.get(holder, {}).items())}
        on_master = e is not None and e["master"] is not None and layout.shards_grads
        g = (e["master"] if on_master else p).grad if e is not None else p.grad
        if g is not None:
            grads[name] = _np(whole(g, e["ospec"] if on_master else spec)
                              if e is not None else g)
    return {"params": _np(acc.get_state_dict(state)), "opt": opt, "grads": grads,
            "step": state.step, "micro_step": state.micro_step}


def _adamw(hyper):
    return functools.partial(torch.optim.AdamW, lr=hyper["lr"], betas=hyper["betas"],
                             eps=hyper["eps"], weight_decay=hyper["wd"])


def _train(acc, state, model, ids, rows, hyper, calls, skip=0):
    from accelerate_tpu_torch.data_loader import SimpleDataLoader, skip_first_batches
    from accelerate_tpu_torch.models.transformer import lm_loss_fn

    n_data = acc.mesh.size // acc.mesh.shape.get("tp", 1)
    loader = acc.prepare(SimpleDataLoader([{"input_ids": r} for r in ids],
                                          batch_size=rows // n_data))
    if skip:
        loader = skip_first_batches(loader, skip)
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=hyper["max_grad_norm"])
    for i, batch in enumerate(loader):
        if i >= calls:
            break
        state, _ = step(state, batch)
    return state


def ckpt_save(out_dir, case, jparams, ids, rows, hyper, calls, ckpt_dir):
    """Train ``calls`` micro-steps (an odd count: the window is open), save
    the state, and dump it whole."""
    _setup()
    _reset()
    acc = make_accelerator(case)
    model = make_model(jparams)
    state = acc.create_train_state(params=model, tx=_adamw(hyper))
    state = _train(acc, state, model, ids, rows, hyper, calls)
    acc.save_state(ckpt_dir, state=state)
    _dump(out_dir, case["tag"], _full_state(acc, state))


def ckpt_load(out_dir, loads, jparams, hyper):
    """Each ``(tag, case, ckpt_dir)``: a fresh state on this world's mesh,
    ``load_state``, dumped whole."""
    _setup()
    for tag, case, ckpt_dir in loads:
        _reset()
        acc = make_accelerator(case)
        model = make_model(jparams)
        state = acc.create_train_state(params=model, tx=_adamw(hyper))
        acc.load_state(ckpt_dir, state=state)
        _dump(out_dir, tag, _full_state(acc, state))


def ckpt_resume(out_dir, case, jparams, ids, rows, hyper, calls, split, ckpt_dir, model_dir):
    """An uninterrupted run of ``calls`` against one saved after ``split``
    and resumed from the checkpoint by a fresh Accelerator and state; and
    ``save_model`` of the sharded state."""
    _setup()
    _reset()
    acc = make_accelerator(case)
    model = make_model(jparams)
    state = _train(acc, acc.create_train_state(params=model, tx=_adamw(hyper)), model, ids,
                   rows, hyper, calls)
    whole = _full_state(acc, state)
    acc.save_model(state, model_dir)
    _reset()
    acc = make_accelerator(case)
    model = make_model(jparams)
    state = _train(acc, acc.create_train_state(params=model, tx=_adamw(hyper)), model, ids,
                   rows, hyper, split)
    acc.save_state(ckpt_dir, state=state)
    _reset()
    acc = make_accelerator(case)
    model = make_model(jparams)
    state = acc.create_train_state(params=model, tx=_adamw(hyper))
    acc.load_state(ckpt_dir, state=state)
    state = _train(acc, state, model, ids, rows, hyper, calls - split, skip=split)
    _dump(out_dir, case["tag"], {"whole": whole, "resumed": _full_state(acc, state)})


def powersgd_pmean(out_dir, grads, comm_state):
    """``compressed_pmean`` over the world's ``dp`` group: rank ``i`` gives
    ``grads[i]`` with its slice of the error feedback."""
    from accelerate_tpu_torch.parallel.compression import compressed_pmean, compression_stats
    from accelerate_tpu_torch.parallel.mesh import build_mesh

    _setup()
    mesh = build_mesh({"dp": 2})
    rank = mesh.axis_index("dp")
    g = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    st = {k: None if v is None else {"q": torch.from_numpy(v["q"]),
                                     "error": torch.from_numpy(v["error"][rank])}
          for k, v in comm_state.items()}
    ghat, new = compressed_pmean(g, st, mesh.group("dp"))
    _dump(out_dir, "pmean", {"ghat": _np(ghat),
                             "state": {k: None if v is None else _np(v) for k, v in new.items()},
                             "stats": compression_stats(g, st)})


def sequence(steps):
    """Several rank functions in one world, in turn: ``[(name, args), ...]``
    (one spawn instead of one each)."""
    for name, args in steps:
        globals()[name](*args)

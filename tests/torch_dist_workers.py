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

    model = Transformer(TransformerConfig.tiny(
        dtype=torch.float32, param_dtype=torch.float32,
        **{"attention_impl": "pallas", **(cfg_kw or {})}), device="cpu")
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


# ------------------------------------------- pipeline, sequence and experts
def ring_cases(out_dir, cases, arrays):
    """Each case: ``ring_attention_sharded`` over the case's mesh on the
    whole arrays (every rank the same ones); the output and the gradients
    of ``sum(out * dout)``."""
    from accelerate_tpu_torch.parallel.mesh import build_mesh
    from accelerate_tpu_torch.parallel.ring_attention import ring_attention_sharded

    _setup()
    meshes = {}
    for case in cases:
        key = tuple(case["mesh"].items())
        if key not in meshes:
            meshes[key] = build_mesh(dict(case["mesh"]))
        a = arrays[case["arrays"]]
        q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in ("q", "k", "v"))
        seg = torch.from_numpy(a["seg"]) if case.get("seg") else None
        out = ring_attention_sharded(q, k, v, meshes[key], causal=case["causal"],
                                     segment_ids=seg, layout=case["layout"],
                                     remat=case.get("remat", False))
        (out * torch.from_numpy(a["dout"])).sum().backward()
        _dump(out_dir, case["tag"], {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
                                     "dv": _np(v.grad)})


def _mp_accelerator(case, accum=2):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import (
        FullyShardedDataParallelPlugin,
        ModelParallelPlugin,
    )

    kw = {}
    if case.get("mp"):
        kw["megatron_lm_plugin"] = ModelParallelPlugin(**case["mp"])
    if case.get("fsdp"):
        kw["fsdp_plugin"] = FullyShardedDataParallelPlugin(**case["fsdp"])
    return Accelerator(cpu=True, gradient_accumulation_steps=accum, mesh=case.get("mesh"),
                       **kw)


def _loss_of(case, model):
    from accelerate_tpu_torch.models.transformer import lm_loss_fn
    from accelerate_tpu_torch.parallel.pipeline import pipeline_lm_loss_fn

    if case.get("schedule"):
        return pipeline_lm_loss_fn(model, num_microbatches=case.get("micro"),
                                   schedule=case["schedule"])
    return lm_loss_fn(model)


def _held_state(state):
    """This rank's whole weights, optimizer state and buffers of the
    parameters it holds (gathered over the axes that cut them; another
    pipeline stage's are left out)."""
    from accelerate_tpu_torch.parallel.sharding import all_gather_along, gather_axes_order

    layout = state.layout
    out = {"params": {}, "opt": {}, "grads": {}}
    for name, p in state.model.named_parameters():
        e = layout.entries[name]
        if not e["owned"]:
            continue

        def whole(t, spec):
            if t.ndim == 0:
                return t
            for d, axis in gather_axes_order(spec):
                t = all_gather_along(t, d, layout.mesh.group(axis))
            return t

        holder = p if e["master"] is None else e["master"]
        spec = e["ospec"] if holder is not p else e["pspec"]
        out["params"][name] = _np(whole(p.detach(), e["pspec"]))
        out["opt"][name] = {k: _np(whole(v, spec) if isinstance(v, torch.Tensor)
                                   else torch.tensor(v))
                            for k, v in sorted(state.optimizer.state.get(holder, {}).items())}
        on_master = e["master"] is not None and layout.shards_grads
        g = (e["master"] if on_master else p).grad
        if g is not None:
            out["grads"][name] = _np(whole(g, e["ospec"] if on_master else e["pspec"]))
    out["step"], out["micro_step"] = state.step, state.micro_step
    return out


def mp_train_cases(out_dir, cases, jparams_by_model, ids, rows, hyper):
    """Each case: an Accelerator over its mesh and ModelParallelPlugin, the
    model from the JAX package's weights (``case["model"]``), AdamW, its
    data shard's rows of ``ids`` (``rows`` a global batch), ``case["calls"]``
    micro-steps of ``compile_train_step`` with the case's loss; per call
    the loss, grad norm and applied flag, after each applied step the whole
    weights; ``save`` writes a checkpoint after the loop, ``load`` restores
    one first (then nothing is trained); the held state is dumped."""
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.parallel.mesh import num_data_shards

    _setup()
    for case in cases:
        _reset()
        acc = _mp_accelerator(case)
        model = make_model(jparams_by_model[case.get("model", "dense")], case.get("cfg"))
        state = acc.create_train_state(params=model, tx=_adamw(hyper))
        records = []
        loss_fn = _loss_of(case, model)
        if case.get("load"):
            acc.load_state(case["load"], state=state)
        else:
            loader = acc.prepare(SimpleDataLoader([{"input_ids": r} for r in ids],
                                                  batch_size=rows // num_data_shards(acc.mesh)))
            step = acc.compile_train_step(loss_fn, max_grad_norm=hyper["max_grad_norm"])
            for i, batch in enumerate(loader):
                if i >= case.get("calls", 10**9):
                    break
                state, m = step(state, batch)
                rec = {k: float(m[k]) for k in ("loss", "grad_norm")}
                rec["applied"] = bool(m["applied"])
                if rec["applied"]:
                    rec["params"] = _np(acc.get_state_dict(state))
                records.append(rec)
        if case.get("save"):
            acc.save_state(case["save"], state=state)
        shardings = {name: (tuple(p.shape), tuple(p.atpu_sharding.spec))
                     for name, p in model.named_parameters()}
        experts = {name: getattr(model.get_submodule(name.split(".experts.")[0]), "_atpu_ep",
                                 None) is not None
                   for name, _ in model.named_parameters() if ".moe_mlp.experts." in name}
        _dump(out_dir, case["tag"], {"records": records, "shardings": shardings,
                                     "held": _held_state(state), "experts_cut": experts,
                                     "stash_peak": getattr(loss_fn, "stash_peak", None),
                                     "mesh": dict(acc.mesh.shape)})


def pipeline_fn_cases(out_dir, cases, arrays, jparams_by_model):
    """Each case: a pipeline function on the whole inputs over its mesh, no
    Accelerator: ``apply`` (``pipeline_apply`` of ``tanh(h @ w)`` layers:
    outputs and the gradients of ``sum(out * dout)``) or ``loss``
    (``pipeline_lm_loss_fn`` on the model from the JAX weights: the loss and
    this rank's gradients, each rank its part); with ``forward``,
    ``prepare_pipeline``'s logits too."""
    from accelerate_tpu_torch.parallel.mesh import build_mesh
    from accelerate_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        pipeline_lm_loss_fn,
        prepare_pipeline,
    )

    _setup()
    meshes = {}
    for case in cases:
        key = tuple(case["mesh"].items())
        if key not in meshes:
            meshes[key] = build_mesh(dict(case["mesh"]))
        mesh = meshes[key]
        if case["kind"] == "apply":
            a = arrays[case["arrays"]]
            w = torch.from_numpy(a["w"]).requires_grad_()
            mbs = torch.from_numpy(a["mbs"]).requires_grad_()

            def stage_fn(local, x):
                for i in range(local["w"].shape[0]):
                    x = torch.tanh(x @ local["w"][i])
                return x

            out = pipeline_apply(stage_fn, {"w": w}, mbs, mesh=mesh)
            (out * torch.from_numpy(a["dout"])).sum().backward()
            # only the first stage reads the micro-batches
            dmbs = np.zeros_like(a["mbs"]) if mbs.grad is None else _np(mbs.grad)
            _dump(out_dir, case["tag"], {"out": _np(out), "dw": _np(w.grad), "dmbs": dmbs})
            continue
        model = make_model(jparams_by_model[case["model"]], case.get("cfg"))
        params = {n: p for n, p in model.named_parameters()}
        batch = {"input_ids": torch.from_numpy(arrays[case["arrays"]]["ids"])}
        loss_fn = pipeline_lm_loss_fn(model, mesh=mesh, num_microbatches=case["micro"],
                                      schedule=case["schedule"])
        loss = loss_fn(params, batch)
        loss.backward()
        grads = {n: _np(p.grad) for n, p in params.items() if p.grad is not None}
        out = {"loss": float(loss), "grads": grads,
               "stash_peak": getattr(loss_fn, "stash_peak", None)}
        if case.get("forward"):
            with torch.no_grad():
                out["logits"] = _np(prepare_pipeline(model, None, mesh=mesh,
                                                     num_microbatches=case["micro"])(
                    params, batch["input_ids"]))
        _dump(out_dir, case["tag"], out)


def ring_whole_inputs():
    """q, k, v ``[2, 16, 4, 16]`` f32 of a whole-sequence ring forward."""
    rng = np.random.default_rng(6)
    return [rng.standard_normal((2, 16, 4, 16)).astype(np.float32) for _ in range(3)]


def ring_refusals(out_dir):
    """On a ``dp=2 x sp=2`` mesh: each refusal's exception type and message;
    whether a batch-1 whole-sequence forward warned and gave the flash
    arm's values; a whole-sequence forward that splits over the mesh (the
    ring, through ``ring_attention_sharded``)."""
    import logging

    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
    from accelerate_tpu_torch.ops.attention import dot_product_attention
    from accelerate_tpu_torch.weights import init_params

    _setup()
    _reset()
    acc = _mp_accelerator(dict(mesh={"dp": 2, "sp": 2}, mp=dict(sp_degree=2)))
    out = {}

    def caught(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 (the refusal is what is recorded)
            return type(e).__name__, str(e)
        return None

    q = torch.zeros(2, 15, 4, 16)
    out["indivisible_seq"] = caught(lambda: dot_product_attention(q, q, q,
                                                                  implementation="ring"))
    said = []
    handler = logging.Handler()
    handler.emit = lambda record: said.append(record.getMessage())
    logging.getLogger("accelerate_tpu_torch.ops.attention").addHandler(handler)
    q1 = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 16, 4, 16))
                          .astype(np.float32))
    got = dot_product_attention(q1, q1, q1, implementation="ring")
    out["batch1_warned"] = any("UNSHARDED" in m for m in said) or torch.distributed.get_rank()
    # a ring of one: the flash kernels' arm (their plain versions here)
    out["batch1_close"] = torch.equal(got, dot_product_attention(q1, q1, q1,
                                                                 implementation="pallas"))
    # a whole sequence that splits over the mesh: the ring over it, unwarned
    said.clear()
    qkv = [torch.from_numpy(a) for a in ring_whole_inputs()]
    out["whole_seq"] = _np(dot_product_attention(*qkv, implementation="ring",
                                                 ring_layout="zigzag"))
    out["whole_seq_warned"] = any("UNSHARDED" in m for m in said)
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 attention_impl="ring", ring_attention_layout="zigzag")
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, seed=0, device="cpu"))
    ids = torch.ones(2, 6, dtype=torch.long)
    out["zigzag_seq"] = caught(lambda: lm_loss_fn(model)(dict(model.named_parameters()),
                                                         {"input_ids": ids}))
    out["guard"] = caught(lambda: acc.compile_train_step(lambda p, b: torch.zeros(())))
    _dump(out_dir, "refusals", out)


def single_state(state):
    """A one-process train state's weights, optimizer state and buffers by
    parameter name, as numpy (``_held_state``'s layout)."""
    out = {"params": {}, "opt": {}, "grads": {}}
    for name, p in state.model.named_parameters():
        out["params"][name] = _np(p.detach())
        out["opt"][name] = {k: _np(v if isinstance(v, torch.Tensor) else torch.tensor(v))
                            for k, v in sorted(state.optimizer.state.get(p, {}).items())}
        if p.grad is not None:
            out["grads"][name] = _np(p.grad)
    out["step"], out["micro_step"] = state.step, state.micro_step
    return out


def load_ranks(out_dir, tag, world):
    """Every rank's dump of ``tag``."""
    out = []
    for r in range(world):
        with open(os.path.join(str(out_dir), f"{tag}_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def train_single(jparams, cfg_kw, ids, rows, hyper, calls, save=None):
    """``calls`` micro-steps of the one-process port (no process group) at
    accumulation 2, ``save_state`` to ``save``; returns the whole state."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.models.transformer import lm_loss_fn
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
        model = make_model(jparams, cfg_kw)
        state = acc.create_train_state(params=model, tx=_adamw(hyper))
        loader = acc.prepare(SimpleDataLoader([{"input_ids": r} for r in ids], batch_size=rows))
        step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=hyper["max_grad_norm"])
        for i, batch in enumerate(loader):
            if i >= calls:
                break
            state, _ = step(state, batch)
        if save:
            acc.save_state(save, state=state)
        return single_state(state)
    finally:
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)


def restore_single(jparams, cfg_kw, hyper, ckpt_dir):
    """A fresh one-process state restored from ``ckpt_dir``, whole."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
        model = make_model(jparams, cfg_kw)
        state = acc.create_train_state(params=model, tx=_adamw(hyper))
        acc.load_state(ckpt_dir, state=state)
        return single_state(state)
    finally:
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)


def pipeline_refusals(out_dir):
    """The pipeline's refusals across processes: layers that do not split
    into the stages (the loss and ``pipeline_apply``), and a loss not
    marked ``_pp_aware`` on a ``pp`` mesh."""
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.parallel.mesh import build_mesh
    from accelerate_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_lm_loss_fn
    from accelerate_tpu_torch.weights import init_params

    _setup()
    _reset()

    def caught(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 (the refusal is what is recorded)
            return type(e).__name__, str(e)
        return None

    mesh = build_mesh({"pp": 4})
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, seed=0, device="cpu"))
    batch = {"input_ids": torch.ones(4, 8, dtype=torch.long)}
    out = {"loss_layers": caught(lambda: pipeline_lm_loss_fn(model, mesh=mesh,
                                                             num_microbatches=2)(
        dict(model.named_parameters()), batch)),
        "apply_layers": caught(lambda: pipeline_apply(
            lambda p, x: x, {"w": torch.zeros(6, 2)}, torch.zeros(2, 1, 2), mesh=mesh))}
    acc = _mp_accelerator(dict(mesh={"dp": 2, "pp": 2}, mp=dict(pp_degree=2)))
    out["guard"] = caught(lambda: acc.compile_train_step(lambda p, b: torch.zeros(())))
    _dump(out_dir, "refusals", out)


# ------------------------------------------------------- tensor-parallel serving
def _serve_model(jparams, cfg_kw=None):
    """The tiny f32 model (``max_seq_len=64``) on the CPU with ``jparams``."""
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.weights import params_from_jax

    model = Transformer(TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                               max_seq_len=64, **(cfg_kw or {})), device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"), assign=True)
    return model


def _follow(door, router):
    """``door.follow()`` on a follower rank; returns the requests it
    mirrored from rank 0's submit tickets, in ticket order."""
    seen = []
    submit = router.submit

    def recording(*args, **kw):
        seen.append(submit(*args, **kw))
        return seen[-1]

    router.submit = recording
    try:
        door.follow()
    finally:
        del router.submit
    return seen


def _gen_config(gen):
    from accelerate_tpu_torch.models.generation import GenerationConfig

    return GenerationConfig(**gen)


def _serve_engine(model, mesh, kw):
    from accelerate_tpu_torch.serving import ServingEngine
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    return ServingEngine(model, None, device="cpu", registry=MetricsRegistry(),
                         mesh=mesh, **kw)


SERVE_STATS = ("prefill_chunks", "decode_steps", "prefix_hit_tokens", "prefix_hit_tokens_host",
               "spec_drafted", "spec_accepted", "verify_forwards", "interleaved_chunks",
               "kv_quant_error", "graph_captures", "requests_completed")


def _serve_case(case, jparams_by_model, mesh):
    """One engine over ``mesh`` serving the case's prompts: tokens, the
    counters of :data:`SERVE_STATS`, the pool's bytes on this rank and the
    files its disk tier wrote."""
    model = _serve_model(jparams_by_model[case.get("model", "llama")], case.get("cfg"))
    kw = dict(case["kw"])
    disk = kw.get("prefix_disk_dir")
    eng = _serve_engine(model, mesh, kw)
    prompts = [np.asarray(p, np.int32) for p in case["prompts"]]
    reqs = eng.serve(prompts, _gen_config(case["gen"]))
    out = {"tokens": [list(r.tokens) for r in reqs],
           "stats": {k: eng.stats[k] for k in SERVE_STATS},
           "kv_pool_bytes": eng.kv_pool_bytes(), "tp_degree": eng.tp_degree}
    if disk:
        torch.distributed.barrier()  # both ranks' files are written
        out["disk"] = {d: sorted(os.listdir(os.path.join(disk, d)))
                       for d in sorted(os.listdir(disk))}
        out["disk_dir"] = os.path.relpath(eng.prefix_cache.disk_dir, disk)
        out["prefix"] = eng.prefix_cache_stats()
    return out


def _geometry(jparams_by_model, mesh):
    """The sharded pool and params of ``test_serving_mesh.py::
    TestShardedPoolGeometry``."""
    from accelerate_tpu_torch.models.transformer import TransformerConfig
    from accelerate_tpu_torch.serving import PagedKVPool
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    pool = PagedKVPool(cfg, num_slots=2, max_len=64, page_size=8, num_pages=17, mesh=mesh,
                       device="cpu", registry=MetricsRegistry())
    out = {"pool": dict(pages=tuple(pool.pages_k.shape), scales=tuple(pool.k_scales.shape),
                        tp_degree=pool.tp_degree, kv_bytes=pool.kv_bytes(),
                        per_device=pool.kv_bytes_per_device())}
    kw = dict(num_slots=4, max_len=64, prefill_buckets=(8, 16), decode_window=4)
    for paged in (False, True):
        model = _serve_model(jparams_by_model["llama"])
        full = {n: tuple(t.shape) for n, t in model.state_dict().items()}
        eng = _serve_engine(model, mesh, dict(kw, paged=paged))
        out[f"bytes_paged{paged}"] = eng.kv_pool_bytes()
        out[f"tp_gauge_paged{paged}"] = eng.metrics.gauge("serve/tp_degree").value
        out["sharded"] = {n: tuple(t.shape) != full[n]
                          for n, t in eng.model.state_dict().items()}
    try:
        _serve_engine(_serve_model(jparams_by_model["odd"],
                                   dict(hidden_size=48, num_heads=6, num_kv_heads=3)), mesh, kw)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _swap(case, jparams_by_model, mesh):
    """Serve, swap to the full weights of another model, serve again."""
    from accelerate_tpu_torch.weights import params_from_jax

    model = _serve_model(jparams_by_model["llama"])
    eng = _serve_engine(model, mesh, dict(case["kw"]))
    gen = _gen_config(case["gen"])
    prompts = [np.asarray(p, np.int32) for p in case["prompts"]]
    before = [list(r.tokens) for r in eng.serve(prompts, gen)]
    eng.swap_params(params_from_jax(jparams_by_model["swap"], device="cpu"), version="v1")
    after = [list(r.tokens) for r in eng.serve(prompts, gen)]
    return {"before": before, "after": after, "version": eng.weights_version}


def _migrate(case, jparams_by_model, mesh):
    """``test_disagg.py::_migrate_pair`` on one mesh: an unmoved baseline,
    then each lane moved mid-generation between two engines of the mesh
    (d2d), then a prefill->decode handoff through the router."""
    from accelerate_tpu_torch.serving import ReplicaRouter
    from accelerate_tpu_torch.serving.transfer import PageMigrator
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    model = _serve_model(jparams_by_model["llama"])
    kw = dict(case["kw"])
    prompts = [np.asarray(p, np.int32) for p in case["prompts"]]
    gens = [_gen_config(g) for g in case["gens"]]
    base = _serve_engine(model, mesh, kw)
    breqs = [base.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
    base.run()
    src, dst = _serve_engine(model, mesh, kw), _serve_engine(model, mesh, kw)
    mig = PageMigrator(registry=MetricsRegistry())
    reqs = [src.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
    for r in reqs:
        while len(r.tokens) < case["migrate_at"]:
            src.step()
    for r in reqs:
        mig.migrate(src, dst, next(s for s in range(src.num_slots) if src._slot_req[s] is r),
                    mode="d2d")
    dst.run()
    pre = _serve_engine(model, mesh, dict(kw, role="prefill"))
    dec = _serve_engine(model, mesh, dict(kw, role="decode"))
    router = ReplicaRouter([pre, dec], policy="disaggregated", registry=MetricsRegistry())
    handed = router.serve([p.copy() for p in prompts], gens[0])
    return {"baseline": [list(r.tokens) for r in breqs],
            "migrated": [list(r.tokens) for r in reqs],
            "handoff": [list(r.tokens) for r in handed],
            "handoffs": dec.stats["requests_completed"]}


def _lifted(case, jparams_by_model, mesh):
    """What a mesh engine refused before the router over processes and the
    serving of every model under a mesh: each now serves, on the JAX
    package's weights, tokens the test holds against the JAX engine's.
    Weight-quantized, fp8 and MoE models over ``mesh`` (``case["models"]``:
    name -> config); the front door over a router of a mesh engine (rank 0
    drives and submits as the API server does, rank 1 follows and records
    its mirrors' tokens); a router over a single-rank mesh replica beside a mesh-less
    engine on the other rank (``mixed_router``); one single-rank replica a
    rank (``disjoint``).  Then what still refuses: a mesh-less engine on
    every rank beside a replica over both (``overlap``)."""
    from accelerate_tpu_torch.models.generation import GenerationConfig
    from accelerate_tpu_torch.parallel.mesh import replica_meshes
    from accelerate_tpu_torch.serving import ReplicaRouter
    from accelerate_tpu_torch.serving.api.frontdoor import FrontDoor
    from accelerate_tpu_torch.serving.api.protocol import CompletionCall
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    rank = torch.distributed.get_rank()
    kw = dict(case["kw"])
    prompts = [np.asarray(p, np.int32) for p in case["prompts"]]
    gen = GenerationConfig(**case["gen"])

    def tokens(reqs):
        return [list(r.tokens) for r in reqs]

    def llama():
        return _serve_model(jparams_by_model["llama"])

    out = {}
    for name, cfg in case["models"].items():
        got = tokens(_serve_engine(_serve_model(jparams_by_model[name], cfg), mesh, kw)
                     .serve(prompts, gen))
        out[name] = dict(tokens=got, served=sum(map(len, got)))
    router = ReplicaRouter([_serve_engine(llama(), mesh, kw)], registry=MetricsRegistry())
    door = FrontDoor(router)
    if rank == 0:
        door.start()
        streams = [door.submit(CompletionCall(prompt=[int(t) for t in p],
                                              max_tokens=gen.max_new_tokens,
                                              temperature=0.0))[1] for p in prompts]
        for stream in streams:
            stream.wait_done(60.0)
        door.stop()
        got = [s.final_tokens for s in streams]
    else:
        got = tokens(_follow(door, router))
    out["frontdoor"] = dict(tokens=got, served=sum(map(len, got)))
    one, other = replica_meshes(2)
    mine = one if rank in one else other
    mixed = [_serve_engine(llama(), one, kw) if rank == 0 else one,
             other if rank == 0 else _serve_engine(llama(), None, kw)]
    got = tokens(ReplicaRouter(mixed, registry=MetricsRegistry()).serve(prompts, gen))
    out["mixed_router"] = dict(tokens=got, served=sum(map(len, got)))
    disjoint = [_serve_engine(llama(), m, kw) if m is mine else m for m in (one, other)]
    router = ReplicaRouter(disjoint, registry=MetricsRegistry())
    got = tokens(router.serve(prompts, gen))
    out["disjoint"] = dict(tokens=got, served=sum(map(len, got)),
                           tp=[r["tp_degree"] for r in router.health()["per_replica"]])
    eng = _serve_engine(llama(), mesh, kw)
    here = _serve_engine(llama(), None, kw)
    try:
        ReplicaRouter([eng, here], registry=MetricsRegistry())
        out["overlap"] = None
    except ValueError as e:
        out["overlap"] = [type(e).__name__, str(e)]
    return out


def serve_mesh_cases(out_dir, jparams_by_model, cases):
    """Every tensor-parallel serving scenario of one world, in order (each
    rank runs them all alike); each case's result goes to ``<tag>``."""
    from accelerate_tpu_torch.parallel.mesh import build_mesh

    _setup()
    mesh = build_mesh({"tp": torch.distributed.get_world_size()})
    for case in cases:
        kind = case.get("kind", "serve")
        if kind == "geometry":
            res = _geometry(jparams_by_model, mesh)
        elif kind == "swap":
            res = _swap(case, jparams_by_model, mesh)
        elif kind == "migrate":
            res = _migrate(case, jparams_by_model, mesh)
        elif kind == "lifted":
            res = _lifted(case, jparams_by_model, mesh)
        elif kind == "router_failures":
            res = _router_failures(case, jparams_by_model, mesh)
        else:
            res = _serve_case(case, jparams_by_model, mesh)
        _dump(out_dir, case["tag"], res)


def _router_failures(case, jparams_by_model, mesh):
    """A failing step of a mesh replica under the router: one rank submits
    a request more to a replica, one rank alone kills a replica, every rank
    kills it.  The first two raise on every rank (type and message
    recorded, and whether within ``deadline_s``) instead of hanging; the
    third ejects the replica on every rank and replays its requests on the
    other (the tokens recorded)."""
    import time

    from accelerate_tpu_torch.serving import ReplicaRouter
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    rank = torch.distributed.get_rank()
    prompts = [np.asarray(p, np.int32) for p in case["prompts"]]
    gen = _gen_config(case["gen"])
    fail = {"diverge": lambda e: rank == 1 and e.submit(prompts[0].copy(), config=gen),
            "kill_one": lambda e: rank == 0 and e.kill("killed on rank 0"),
            "kill_all": lambda e: e.kill("killed on every rank")}
    model = _serve_model(jparams_by_model["llama"])
    router = ReplicaRouter([_serve_engine(model, mesh, dict(case["kw"])) for _ in range(2)],
                           policy="round_robin", registry=MetricsRegistry())
    out = {"undisturbed": [list(r.tokens) for r in router.serve(
        [p.copy() for p in prompts], gen)]}
    for what, act in fail.items():
        model = _serve_model(jparams_by_model["llama"])
        engines = [_serve_engine(model, mesh, dict(case["kw"])) for _ in range(2)]
        # round robin: the first replica holds two of the three requests
        router = ReplicaRouter(engines, policy="round_robin", registry=MetricsRegistry())
        reqs = [router.submit(p.copy(), config=gen) for p in prompts]
        router.step()
        act(engines[0])
        t0 = time.perf_counter()
        try:
            router.run(max_steps=100)
            out[what] = dict(tokens=[list(r.tokens) for r in reqs],
                             ejections=router.health()["ejections"],
                             replayed=router.stats()["requests_replayed"])
        except Exception as e:  # noqa: BLE001 (the raise is what is recorded)
            out[what] = [type(e).__name__, str(e),
                         time.perf_counter() - t0 < case["deadline_s"]]
    return out


def serve_mesh_diverge(jparams, prompts):
    """Rank 1 submits one request more than rank 0, then both step: the
    plan exchange must raise on every rank instead of hanging."""
    from accelerate_tpu_torch.parallel.mesh import build_mesh

    _setup()
    mesh = build_mesh({"tp": torch.distributed.get_world_size()})
    eng = _serve_engine(_serve_model(jparams), mesh,
                        dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), decode_window=2))
    gen = _gen_config(dict(max_new_tokens=4))
    for p in prompts:
        eng.submit(np.asarray(p, np.int32), config=gen)
    if torch.distributed.get_rank() == 1:
        eng.submit(np.asarray(prompts[0], np.int32), config=gen)
    eng.run()

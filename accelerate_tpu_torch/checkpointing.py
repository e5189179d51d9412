"""Checkpoints: ``save_state``/``load_state`` to resume a run, and the safetensors export.

Port of :mod:`accelerate_tpu.checkpointing`.  The directory layout, the
automatic naming (``<project_dir>/checkpoints/checkpoint_{i}``) and its
``total_limit`` rotation, the pre-hooks and the JSON files are the JAX
package's; the train state is one ``torch.save`` file where the JAX package
writes an orbax tree::

    <dir>/
      train_state/train_state.pt  # step, micro_step, model, optimizer, loss_scale, grad
      custom_checkpoint_{i}.pkl
      sampler_{i}.json            # the loader's iteration and sampler state
      scheduler_{i}.json
      random_states_{rank}.pkl    # python, numpy and torch generators
      accelerator_state.json

``grad`` is the accumulation buffer (the parameters' ``.grad``, the JAX
state's ``grad_accum``), saved whenever ``micro_step > 0``: without it a
run saved mid-window would resume with the window's earlier micro-steps
lost.

A state sharded across processes (``TrainState.layout``) is written the
way the reference's orbax tree is (``accelerate_tpu/checkpointing.py:
129-220``): each rank writes only its own blocks (a pipeline stage's
layers only on that stage's ranks, experts cut over ``ep``), to
``train_state/rank_{process_index}.pt`` — for every parameter its block of
the weights, of each optimizer-state tensor and of the buffer, each with
its box (``[start, stop)`` per dim) in the whole tensor — and the main
process writes the metadata, ``num_processes`` included.  ``load_state``
re-shards onto the live mesh: each block of the live state is copied
together from the saved blocks it overlaps, whatever the world size or
mesh of the save (a one-process ``train_state.pt`` included, read as one
whole block), so the values are the saved ones bit for bit.  PowerSGD's
state goes with its rank, and comes back when the world is the save's.  ``load_state`` writes into the given state in place and returns it.
An offloaded optimizer (``utils/chunked_update.py``) saves each chunk's
state buffer, read from the host or from its files, and loads it back
there, bit for bit.

``save_model`` writes ``model.safetensors`` (or shards and an index past
``max_shard_size``) keyed by the port's state-dict names, with the port's
own writer (:func:`save_file`; :func:`load_file` reads): an 8-byte
little-endian header length, a JSON header of ``dtype``/``shape``/
``data_offsets`` a tensor padded with spaces to 8 bytes, then the tensors'
raw little-endian bytes.

Instrumented as in the reference: ``checkpoint/save``, ``checkpoint/restore``
and ``checkpoint/save_model`` spans, the ``checkpoint/save_s``,
``checkpoint/restore_s`` and ``checkpoint/save_model_s`` histograms (host
wall), and the ``checkpoint/saved_bytes_total``,
``checkpoint/restored_bytes_total`` (the train state's tensor bytes) and
``checkpoint/model_saved_bytes_total`` (shard bytes) counters.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import random
import re
import shutil
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .data_loader import SeedableRandomSampler
from .telemetry import get_registry, get_tracer
from .train_state import TrainState

MODEL_SAFE_NAME = "model.safetensors"
SAFE_INDEX_NAME = "model.safetensors.index.json"
TRAIN_STATE_FILE = os.path.join("train_state", "train_state.pt")

_SAFE_DTYPES = {
    torch.float32: "F32",
    torch.bfloat16: "BF16",
    torch.float16: "F16",
    torch.int32: "I32",
    torch.int64: "I64",
    torch.float8_e4m3fn: "F8_E4M3",
}
_TORCH_DTYPES = {name: dtype for dtype, name in _SAFE_DTYPES.items()}


# ---------------------------------------------------------------- safetensors
def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` as one safetensors file (widest dtypes first, then
    by name, so that every tensor starts at a multiple of its item size)."""
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, flat, offset = {}, [], 0
    for name in names:
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _SAFE_DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here "
                             f"(supported: {sorted(_TORCH_DTYPES)})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFE_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        flat.append(t.reshape(-1).view(torch.uint8))
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in flat:
            f.write(t.numpy())


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """A safetensors file's header (name -> ``dtype``, ``shape``,
    ``data_offsets``) and the byte offset where its data starts, reading no
    tensor bytes."""
    with open(path, "rb") as f:
        (length,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(length))
    header.pop("__metadata__", None)
    for name, info in header.items():
        if info["dtype"] not in _TORCH_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the port "
                             f"does not read (supported: {sorted(_TORCH_DTYPES)})")
    return header, 8 + length


def tensor_dtype(info: dict) -> torch.dtype:
    """The torch dtype of a header entry."""
    return _TORCH_DTYPES[info["dtype"]]


def map_tensor(path: str, info: dict, base: int) -> torch.Tensor:
    """One tensor of a safetensors file as a zero-copy view of its bytes: a
    copy-on-write memory map of its byte range (``info`` and ``base`` from
    :func:`read_header`), so that a read faults in only what is touched and
    nothing is ever written back to the file."""
    start, end = info["data_offsets"]
    if end == start:
        return torch.empty(info["shape"], dtype=tensor_dtype(info))
    raw = np.memmap(path, dtype=np.uint8, mode="c", offset=base + start, shape=(end - start,))
    return torch.from_numpy(raw).view(tensor_dtype(info)).reshape(info["shape"])


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a safetensors file into host tensors."""
    header, base = read_header(path)
    out = {}
    with open(path, "rb") as f:
        for name, info in header.items():
            start, end = info["data_offsets"]
            buf = torch.empty(end - start, dtype=torch.uint8)
            f.seek(base + start)
            if f.readinto(buf.numpy()) != end - start:
                raise ValueError(f"{path}: {name}'s bytes are truncated")
            out[name] = buf.view(_TORCH_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


# ------------------------------------------------------------------ weights
def _named_tensors(state_or_params) -> Dict[str, torch.Tensor]:
    if isinstance(state_or_params, TrainState):
        return state_or_params.model.state_dict()
    if isinstance(state_or_params, nn.Module):
        return state_or_params.state_dict()
    return dict(state_or_params)


def host_state_dict(state_or_params, dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """Host copies of the weights of a :class:`TrainState`, a module or a
    name -> tensor dict; floating tensors cast to ``dtype`` (on their own
    device, before the copy) when it is given.  A sharded state's weights
    are gathered whole (every process must call this)."""
    layout = getattr(state_or_params, "layout", None)
    out = {}
    for name, t in _named_tensors(state_or_params).items():
        if layout is not None and name in layout.entries:
            t = layout.full_tensor(name, t)
        t = t.detach()
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to("cpu", copy=True)
    return out


def parse_size(size) -> int:
    if isinstance(size, int):
        return size
    m = re.fullmatch(r"(\d+)\s*([KMGT]?B)", size.strip(), re.IGNORECASE)
    if not m:
        raise ValueError(f"Cannot parse size {size!r}")
    mult = {"B": 1, "KB": 10**3, "MB": 10**6, "GB": 10**9, "TB": 10**12}[m.group(2).upper()]
    return int(m.group(1)) * mult


def _state_nbytes(state: TrainState) -> int:
    """Bytes of the train state's tensors: weights, optimizer state and,
    mid-window, the accumulation buffer."""
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk({"model": state.model.state_dict(), **state.state_dict()})
    return total


def save_model(accelerator, state_or_params, save_directory: str, max_shard_size="10GB",
               safe_serialization: bool = True,
               save_dtype: Optional[torch.dtype] = None) -> List[str]:
    """Export the weights as safetensors: ``model.safetensors``, or shards of
    at most ``max_shard_size`` (a tensor larger than that has a shard of
    its own) named ``model-0000i-of-0000n.safetensors`` and an index
    ``model.safetensors.index.json``.  ``save_dtype`` casts the floating
    weights (the masters stay as they are).  Returns the files written.
    ``safe_serialization`` is accepted for the reference's signature: the
    export is always safetensors."""
    t0 = time.perf_counter()
    with get_tracer().span("checkpoint/save_model"):
        written = _save_model_impl(accelerator, state_or_params, save_directory,
                                   max_shard_size, save_dtype)
    get_registry().histogram("checkpoint/save_model_s", help="save_model wall time").observe(
        time.perf_counter() - t0)
    return written


def _save_model_impl(accelerator, state_or_params, save_directory: str, max_shard_size,
                     save_dtype: Optional[torch.dtype]) -> List[str]:
    host = host_state_dict(state_or_params, save_dtype)
    if not accelerator.is_main_process:
        accelerator.wait_for_everyone()
        return []
    os.makedirs(save_directory, exist_ok=True)
    limit = parse_size(max_shard_size)
    shards: List[Dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for key in sorted(host):
        nbytes = host[key].numel() * host[key].element_size()
        if sizes[-1] + nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][key] = host[key]
        sizes[-1] += nbytes
    get_registry().counter("checkpoint/model_saved_bytes_total",
                           help="safetensors shard bytes written").inc(sum(sizes))
    written: List[str] = []
    if len(shards) == 1:
        written.append(os.path.join(save_directory, MODEL_SAFE_NAME))
        save_file(shards[0], written[0])
    else:
        index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
        n = len(shards)
        for i, shard in enumerate(shards):
            name = MODEL_SAFE_NAME.replace(".safetensors", f"-{i + 1:05d}-of-{n:05d}.safetensors")
            written.append(os.path.join(save_directory, name))
            save_file(shard, written[-1])
            index["weight_map"].update(dict.fromkeys(shard, name))
        with open(os.path.join(save_directory, SAFE_INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2)
    accelerator.wait_for_everyone()
    return written


def load_model_params(load_directory: str, target=None) -> Dict[str, torch.Tensor]:
    """The host tensors :func:`save_model` wrote (one file or the index's
    shards), by name: ``model.load_state_dict`` takes them.  With a
    ``target`` (a TrainState, module or name -> tensor dict) the names must
    be the target's."""
    index_path = os.path.join(load_directory, SAFE_INDEX_NAME)
    flat: Dict[str, torch.Tensor] = {}
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        for name in sorted(set(index["weight_map"].values())):
            flat.update(load_file(os.path.join(load_directory, name)))
    else:
        flat = load_file(os.path.join(load_directory, MODEL_SAFE_NAME))
    if target is not None:
        want = set(_named_tensors(target))
        missing, unexpected = want - set(flat), set(flat) - want
        if missing or unexpected:
            raise ValueError(f"Checkpoint mismatch. Missing: {sorted(missing)[:5]} "
                             f"Unexpected: {sorted(unexpected)[:5]}")
    return flat


# ------------------------------------------------------- sharded train state
def _box(mesh, spec, shape) -> List[Tuple[int, int]]:
    from .parallel.mesh import local_slice

    return [(sl.start or 0, size if sl.stop is None else sl.stop)
            for sl, size in zip(local_slice(mesh, spec, shape), shape)]


def _opt_state_by_name(state: TrainState) -> Tuple[Dict[str, dict], list]:
    """The optimizer's per-parameter state by parameter name, and its
    param groups."""
    sd = state.optimizer.state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    return {names[i]: v for i, v in sd.get("state", {}).items()}, sd["param_groups"]


def _save_sharded(state: TrainState, output_dir: str, process_index: int) -> None:
    """This rank's blocks of ``state`` (see the module docstring)."""
    from .utils.chunked_update import ChunkedOptimizer

    layout = state.layout
    pieces = {}
    chunked = isinstance(state.optimizer, ChunkedOptimizer)
    opt_state, groups = ({}, None) if chunked else _opt_state_by_name(state)
    bufs = layout.buffers(state.model)
    for name, p in state.model.named_parameters():
        e = layout.entries[name]
        if not e["owned"]:  # another pipeline stage's: that stage writes it
            continue
        on_master = e["master"] is not None and layout.shards_grads
        piece = {"shape": list(e["shape"]), "box": _box(layout.mesh, e["pspec"], e["shape"]),
                 "param": p.detach().cpu(),
                 "opt_box": _box(layout.mesh, e["ospec"], e["shape"]),
                 "opt": {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                         for k, v in opt_state.get(name, {}).items()}}
        if state.micro_step > 0 and name in bufs:
            piece["grad"] = bufs[name].detach().cpu()
            piece["grad_box"] = piece["opt_box"] if on_master else piece["box"]
        pieces[name] = piece
    tree = {"format": "sharded", "step": state.step, "micro_step": state.micro_step,
            "mesh": dict(layout.mesh.shape), "process_index": process_index,
            "pieces": pieces, "param_groups": groups,
            "chunked_optimizer": state.optimizer.state_dict() if chunked else None,
            "comm_state": state.comm_state}
    if state.loss_scale is not None:
        tree["loss_scale"] = {"scale": state.loss_scale.scale,
                              "growth_tracker": state.loss_scale.growth_tracker}
    torch.save(tree, os.path.join(output_dir, "train_state", f"rank_{process_index}.pt"))


def _saved_pieces(input_dir: str, load_kwargs: Optional[dict], param_names: List[str]
                  ) -> Tuple[dict, List[dict]]:
    """``(meta, per-rank trees)`` of a checkpoint's train state, in the
    sharded layout; a one-process ``train_state.pt`` becomes one rank
    holding every tensor whole (its optimizer state by position in
    ``param_names``, the live model's parameter order)."""
    kw = {"map_location": "cpu", "weights_only": True, **(load_kwargs or {})}
    base = os.path.join(input_dir, "train_state")
    ranks = sorted((f for f in os.listdir(base) if re.fullmatch(r"rank_\d+\.pt", f)),
                   key=lambda f: int(f[5:-3]))
    if ranks:
        trees = [torch.load(os.path.join(base, f), **kw) for f in ranks]
        return trees[0], trees
    tree = torch.load(os.path.join(input_dir, TRAIN_STATE_FILE), **kw)
    model = tree["model"]
    opt = tree["optimizer"]
    pieces = {}
    state_by_idx = opt.get("state", {})
    for i, name in enumerate(param_names):
        t = model[name]
        box = [(0, d) for d in t.shape]
        piece = {"shape": list(t.shape), "box": box, "param": t, "opt_box": box,
                 "opt": state_by_idx.get(i, {})}
        if name in tree.get("grad", {}):
            piece["grad"], piece["grad_box"] = tree["grad"][name], box
        pieces[name] = piece
    one = {"format": "single", "step": tree["step"], "micro_step": tree["micro_step"],
           "pieces": pieces, "param_groups": opt["param_groups"], "comm_state": None,
           "loss_scale": tree.get("loss_scale"), "chunked_optimizer": None}
    return one, [one]


def _assemble(trees: List[dict], name: str, kind: str, box_key: str,
              box: List[Tuple[int, int]]) -> Optional[torch.Tensor]:
    """The ``box`` of tensor ``name`` copied together from every saved
    block of it that overlaps (``None`` if none was saved)."""
    out = None
    for tree in trees:
        piece = tree["pieces"].get(name)
        if piece is None:
            continue
        src = piece.get(kind) if kind in ("param", "grad") else piece["opt"].get(kind)
        if not isinstance(src, torch.Tensor):
            continue
        sbox = piece[box_key]
        lo = [max(a[0], b[0]) for a, b in zip(box, sbox)]
        hi = [min(a[1], b[1]) for a, b in zip(box, sbox)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        if out is None:
            out = torch.empty([b[1] - b[0] for b in box], dtype=src.dtype)
        dst = tuple(slice(l - b[0], h - b[0]) for l, h, b in zip(lo, hi, box))
        srcs = tuple(slice(l - b[0], h - b[0]) for l, h, b in zip(lo, hi, sbox))
        out[dst] = src[srcs]
    return out


def _load_resharded(state: TrainState, input_dir: str, load_kwargs: Optional[dict]) -> None:
    """Restore a checkpoint of any layout into ``state``, re-sharding each
    tensor onto the live blocks (whole ones for a one-process state)."""
    from .utils.chunked_update import ChunkedOptimizer

    layout = state.layout
    named = list(state.model.named_parameters())
    meta, trees = _saved_pieces(input_dir, load_kwargs, [n for n, _ in named])
    if isinstance(state.optimizer, ChunkedOptimizer) or meta.get("chunked_optimizer"):
        live = state.optimizer if isinstance(state.optimizer, ChunkedOptimizer) else None
        mine = [t for t in trees if t.get("process_index") == state_process_index(state)]
        if (live is None or not meta.get("chunked_optimizer") or len(trees) != layout.world
                or meta.get("mesh") != dict(layout.mesh.shape)):
            raise NotImplementedError(
                "an offloaded (chunked) optimizer's sharded state restores only onto the "
                "world and mesh it was saved from: ROADMAP Queue 1 item 9e-ii")
        live.load_state_dict(mine[0]["chunked_optimizer"])
    opt_state, groups = {}, meta["param_groups"]
    with torch.no_grad():
        for name, p in named:
            if layout is not None and not layout.entries[name]["owned"]:
                continue  # another pipeline stage's parameter
            shape = (layout.entries[name]["shape"] if layout is not None else
                     tuple(next(t["pieces"][name]["shape"] for t in trees
                                if name in t["pieces"])))
            full = [(0, d) for d in shape]
            if layout is None:
                box, obox = full, full
            else:
                e = layout.entries[name]
                box = _box(layout.mesh, e["pspec"], shape)
                obox = _box(layout.mesh, e["ospec"], shape)
            p.data.copy_(_assemble(trees, name, "param", "box", box))
            master = None if layout is None else layout.entries[name]["master"]
            if master is not None:
                master.data.copy_(_assemble(trees, name, "param", "box", obox))
            keys: List[str] = []  # in the saved order, the same on every rank
            for tree in trees:
                keys += [k for k in tree["pieces"].get(name, {}).get("opt", {}) if k not in keys]
            entry = {}
            for key in keys:
                val = next(t["pieces"][name]["opt"][key] for t in trees
                           if key in t["pieces"].get(name, {}).get("opt", {}))
                if isinstance(val, torch.Tensor) and val.ndim > 0:
                    val = _assemble(trees, name, key, "opt_box", obox)
                entry[key] = val
            if entry:
                opt_state[name] = entry
            p.grad = None
            if master is not None:
                master.grad = None
            if meta["micro_step"] > 0:
                on_master = master is not None and layout.shards_grads
                g = _assemble(trees, name, "grad", "grad_box", obox if on_master else box)
                if g is not None:
                    holder = master if on_master else p
                    holder.grad = g.to(device=holder.device, dtype=holder.dtype)
    if not isinstance(state.optimizer, ChunkedOptimizer):
        names = [n for n, _ in named]
        sd = {"state": {i: opt_state[n] for i, n in enumerate(names) if n in opt_state},
              "param_groups": groups}
        for param_state in sd["state"].values():
            if isinstance(param_state.get("step"), torch.Tensor):
                param_state["step"] = param_state["step"].cpu()
        state.optimizer.load_state_dict(sd)
    state.step = int(meta["step"])
    state.micro_step = int(meta["micro_step"])
    if state.loss_scale is not None and meta.get("loss_scale"):
        state.loss_scale = dataclasses.replace(
            state.loss_scale, scale=float(meta["loss_scale"]["scale"]),
            growth_tracker=int(meta["loss_scale"]["growth_tracker"]))
    if state.comm_state is not None:
        mine = [t for t in trees if t.get("process_index") == state_process_index(state)]
        if layout is not None and len(trees) == layout.world and mine and mine[0]["comm_state"]:
            state.comm_state = {k: None if v is None else
                                {kk: vv.to(state.device or "cpu") for kk, vv in v.items()}
                                for k, v in mine[0]["comm_state"].items()}


def state_process_index(state: TrainState) -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


# --------------------------------------------------------------- train state
def _load_into_state(state: TrainState, path: str, load_kwargs: Optional[dict]) -> None:
    from .utils.chunked_update import ChunkedOptimizer

    device = next(state.model.parameters()).device
    if isinstance(state.optimizer, ChunkedOptimizer) or state.offload_params:
        # an offloaded state goes back where it lives, the host (or its
        # files), never whole onto the card
        device = torch.device("cpu")
    tree = torch.load(path, **{"map_location": device, "weights_only": True,
                               **(load_kwargs or {})})
    state.model.load_state_dict(tree.pop("model"))
    state.load_state_dict(tree)


def _checkpoints(base: str) -> List[str]:
    return sorted((d for d in os.listdir(base) if re.fullmatch(r"checkpoint_\d+", d)),
                  key=lambda d: int(d.split("_")[1]))


def _find_seedable_sampler(dl) -> Optional[SeedableRandomSampler]:
    base = getattr(dl, "base_dataloader", dl)
    seen = set()
    node = getattr(base, "batch_sampler", None)
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        if isinstance(node, SeedableRandomSampler):
            return node
        node = getattr(node, "sampler", None) or getattr(node, "batch_sampler", None)
    return None


def save_accelerator_state(accelerator, output_dir: Optional[str],
                           state: Optional[TrainState] = None,
                           safe_serialization: bool = True) -> str:
    """Save everything a run needs to resume; returns the directory.
    ``safe_serialization`` is accepted for the reference's signature."""
    registry = get_registry()
    t0 = time.perf_counter()
    with get_tracer().span("checkpoint/save"):
        out = _save_accelerator_state_impl(accelerator, output_dir, state)
    registry.histogram("checkpoint/save_s", help="save_accelerator_state wall time").observe(
        time.perf_counter() - t0)
    if state is not None:
        registry.counter("checkpoint/saved_bytes_total",
                         help="train-state array bytes written").inc(_state_nbytes(state))
    return out


def _save_accelerator_state_impl(accelerator, output_dir: Optional[str],
                                 state: Optional[TrainState]) -> str:
    pc = accelerator.project_configuration
    if pc.automatic_checkpoint_naming:
        base = os.path.join(accelerator.project_dir or ".", "checkpoints")
        output_dir = os.path.join(base, f"checkpoint_{pc.iteration}")
        if accelerator.is_main_process:
            if os.path.isdir(output_dir):
                raise ValueError(
                    f"Checkpoint directory {output_dir} already exists; do not mix custom "
                    "save paths with automatic_checkpoint_naming.")
            if pc.total_limit is not None and os.path.isdir(base):
                existing = _checkpoints(base)
                while len(existing) + 1 > pc.total_limit:
                    shutil.rmtree(os.path.join(base, existing.pop(0)))
    if output_dir is None:
        raise ValueError("output_dir is required (or enable automatic_checkpoint_naming)")
    if accelerator.is_main_process:
        os.makedirs(output_dir, exist_ok=True)
    accelerator.wait_for_everyone()

    for hook in accelerator._save_model_state_pre_hooks.values():
        hook(accelerator._models, [], output_dir)

    if state is not None:
        path = os.path.join(output_dir, TRAIN_STATE_FILE)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if state.layout is not None:
            _save_sharded(state, output_dir, accelerator.process_index)
        else:
            torch.save({"model": state.model.state_dict(), **state.state_dict()}, path)

    for i, dl in enumerate(accelerator._dataloaders):
        sampler = _find_seedable_sampler(dl)
        if accelerator.is_main_process:
            payload = {"iteration": getattr(dl, "iteration", 0),
                       "sampler": sampler.state_dict() if sampler is not None else None}
            with open(os.path.join(output_dir, f"sampler_{i}.json"), "w") as f:
                json.dump(payload, f)

    for i, sched in enumerate(accelerator._schedulers):
        if accelerator.is_main_process:
            with open(os.path.join(output_dir, f"scheduler_{i}.json"), "w") as f:
                json.dump(sched.state_dict(), f)

    # the torch generators stand in for the JAX state's rng key
    rng_states = {"python": random.getstate(), "numpy": np.random.get_state(),
                  "torch": torch.get_rng_state()}
    if accelerator.device.type == "cuda":
        rng_states["cuda"] = torch.cuda.get_rng_state(accelerator.device)
    with open(os.path.join(output_dir, f"random_states_{accelerator.process_index}.pkl"),
              "wb") as f:
        pickle.dump(rng_states, f)

    for i, obj in enumerate(accelerator._custom_objects):
        if accelerator.is_main_process:
            with open(os.path.join(output_dir, f"custom_checkpoint_{i}.pkl"), "wb") as f:
                pickle.dump(obj.state_dict(), f)

    if accelerator.is_main_process:
        meta = {
            "step": state.step if state is not None else None,
            "gradient_accumulation_steps": accelerator.gradient_accumulation_steps,
            "mixed_precision": accelerator.mixed_precision,
            "num_processes": accelerator.num_processes,
        }
        with open(os.path.join(output_dir, "accelerator_state.json"), "w") as f:
            json.dump(meta, f)
    if pc.automatic_checkpoint_naming:
        pc.iteration += 1
    accelerator.wait_for_everyone()
    return output_dir


def load_accelerator_state(accelerator, input_dir: Optional[str],
                           state: Optional[TrainState] = None,
                           load_kwargs: Optional[dict] = None) -> Optional[TrainState]:
    """Restore what :func:`save_accelerator_state` wrote (the newest
    automatic checkpoint when ``input_dir`` is None) into ``state``, in
    place, and return it.  ``load_kwargs`` go to ``torch.load``.  The
    accelerator's micro-step counter is set to the state's ``micro_step``,
    so that the next :meth:`~Accelerator.accumulate` syncs where the run
    that was saved would have."""
    registry = get_registry()
    t0 = time.perf_counter()
    with get_tracer().span("checkpoint/restore"):
        out = _load_accelerator_state_impl(accelerator, input_dir, state, load_kwargs)
    registry.histogram("checkpoint/restore_s", help="load_accelerator_state wall time").observe(
        time.perf_counter() - t0)
    if out is not None:
        registry.counter("checkpoint/restored_bytes_total",
                         help="train-state array bytes restored").inc(_state_nbytes(out))
    return out


def _load_accelerator_state_impl(accelerator, input_dir: Optional[str],
                                 state: Optional[TrainState],
                                 load_kwargs: Optional[dict]) -> Optional[TrainState]:
    pc = accelerator.project_configuration
    if input_dir is None and pc.automatic_checkpoint_naming:
        base = os.path.join(accelerator.project_dir or ".", "checkpoints")
        existing = _checkpoints(base)
        if not existing:
            raise FileNotFoundError(f"No checkpoints found under {base}")
        input_dir = os.path.join(base, existing[-1])
    if input_dir is None:
        raise ValueError("input_dir is required")

    for hook in accelerator._load_model_state_pre_hooks.values():
        hook(accelerator._models, input_dir)

    if state is not None:
        single = os.path.join(input_dir, TRAIN_STATE_FILE)
        if state.layout is None and os.path.exists(single):
            _load_into_state(state, single, load_kwargs)
        else:
            _load_resharded(state, input_dir, load_kwargs)
        accelerator.step = state.micro_step

    for i, dl in enumerate(accelerator._dataloaders):
        path = os.path.join(input_dir, f"sampler_{i}.json")
        if os.path.exists(path):
            with open(path) as f:
                payload = json.load(f)
            if hasattr(dl, "iteration"):
                dl.iteration = payload.get("iteration", 0)
            sampler = _find_seedable_sampler(dl)
            if sampler is not None and payload.get("sampler") is not None:
                sampler.load_state_dict(payload["sampler"])

    for i, sched in enumerate(accelerator._schedulers):
        path = os.path.join(input_dir, f"scheduler_{i}.json")
        if os.path.exists(path):
            with open(path) as f:
                sched.load_state_dict(json.load(f))

    rng_path = os.path.join(input_dir, f"random_states_{accelerator.process_index}.pkl")
    if os.path.exists(rng_path):
        with open(rng_path, "rb") as f:
            rng_states = pickle.load(f)
        random.setstate(rng_states["python"])
        np.random.set_state(rng_states["numpy"])
        if "torch" in rng_states:
            torch.set_rng_state(rng_states["torch"])
        if "cuda" in rng_states and accelerator.device.type == "cuda":
            torch.cuda.set_rng_state(rng_states["cuda"], accelerator.device)

    for i, obj in enumerate(accelerator._custom_objects):
        path = os.path.join(input_dir, f"custom_checkpoint_{i}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                obj.load_state_dict(pickle.load(f))

    return state

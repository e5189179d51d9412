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
lost.  ``load_state`` writes into the given state in place and returns it.

``save_model`` writes ``model.safetensors`` (or shards and an index past
``max_shard_size``) keyed by the port's state-dict names, with the port's
own writer (:func:`save_file`; :func:`load_file` reads): an 8-byte
little-endian header length, a JSON header of ``dtype``/``shape``/
``data_offsets`` a tensor padded with spaces to 8 bytes, then the tensors'
raw little-endian bytes.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import re
import shutil
import struct
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .data_loader import SeedableRandomSampler
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


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a safetensors file into host tensors."""
    out = {}
    with open(path, "rb") as f:
        (length,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(length))
        header.pop("__metadata__", None)
        base = 8 + length
        for name, info in header.items():
            if info["dtype"] not in _TORCH_DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the port "
                                 f"does not read (supported: {sorted(_TORCH_DTYPES)})")
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
    device, before the copy) when it is given."""
    out = {}
    for name, t in _named_tensors(state_or_params).items():
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


# --------------------------------------------------------------- train state
def _load_into_state(state: TrainState, path: str, load_kwargs: Optional[dict]) -> None:
    device = next(state.model.parameters()).device
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
        _load_into_state(state, os.path.join(input_dir, TRAIN_STATE_FILE), load_kwargs)
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

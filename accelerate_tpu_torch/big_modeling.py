"""Big-model inference: shape-only init, device maps, cpu and disk offload, and
the streaming forward that runs a model larger than the card.

Port of :mod:`accelerate_tpu.big_modeling`, over the port's flat state dicts
(``"layers.3.attn.q_proj.weight"``; the top-level modules are those of
:func:`~accelerate_tpu_torch.utils.modeling.top_level_modules`).

* :func:`init_empty_weights` is the ``meta`` device: every weight's shape
  and dtype, no bytes.  :func:`init_params_on_host` draws seeded weights a
  tensor at a time on the card into one pinned host block.
* :func:`load_checkpoint_and_dispatch` decides the placement from the
  checkpoint's headers before it reads a tensor: modules mapped to the card
  go there, ``"cpu"`` modules into one pinned host block (quantized on the
  host under ``quantization=``), ``"disk"`` modules stay in the checkpoint,
  read zero-copy through memory maps.  :func:`dispatch_params`,
  :func:`cpu_offload` and :func:`disk_offload` do the same for weights in
  memory.  ``device_map="sharded"`` places everything on the one card (a
  mesh of one); a mesh of several cards is ROADMAP item 9e-ii.
* :class:`StreamingExecutor` runs a plan of ``(weights source, fn)`` stages
  with each stage's weights brought to the card just in time: the
  reference's ``AlignDevicesHook`` workload, redesigned for one card and a
  PCIe link.  :class:`StreamingTransformer` is its adapter for the port's
  :class:`~accelerate_tpu_torch.models.transformer.Transformer`, with a
  per-chunk slab KV cache and :meth:`StreamingTransformer.generate`.

How a stage's weights reach the card.  A stage whose tensors are already
on the card runs on them.  The others land in one of two device byte
buffers, each leaf at a 256-byte offset, and the stage runs on views of
that buffer (a shell module built on ``meta`` is called through
``torch.func.functional_call``):

* leaves already in pinned host memory (what :func:`dispatch_params` and
  ``init_params(device_map=...)`` make) are copied as they are, one
  asynchronous copy each: no second host copy of a model that barely fits;
* other host leaves are packed once into pinned host buffers, one per dtype
  of a stage, a *snapshot* keyed on the leaves' identity: a shared module (a
  tied embedding) is packed once, a rebind of the weights is seen, an edit
  in place is not until :meth:`StreamingExecutor.invalidate_cache`;
* memory-mapped leaves (``.dat`` files, safetensors) are gathered into a
  pinned staging buffer first: a copy from pageable memory would not run
  asynchronously.

The copies run on a copy stream, up to two stages ahead of the compute
(double buffering): an event orders each copy after the last compute that
read its buffer, and the compute after its copy; nothing relies on the
caching allocator's timing or on ``record_stream``.  On a CPU exec device
every stage takes this path (the host is the device), which is what the
CPU tests exercise.  Nothing falls back: memory that cannot be pinned, or a
missing card, raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from .checkpointing import map_tensor, read_header, tensor_dtype
from .models.generation import check_cache_room, make_sampler
from .models.transformer import DecoderLayer, KVCache, Transformer, TransformerConfig
from .utils.modeling import (
    SEP,
    DeviceId,
    flatten_tree,
    get_balanced_memory,
    infer_auto_device_map,
    module_of,
    top_level_modules,
    unflatten_tree,
)
from .utils.offload import (
    OffloadedWeightsLoader,
    offload_state_dict,
    pinned_host_buffer,
    pinned_host_views,
)

_ALIGN = 256  # byte offset of each leaf in a transfer buffer


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# --------------------------------------------------------------------- init
def init_empty_weights(config_or_model: Union[TransformerConfig, nn.Module],
                       dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every weight as a ``meta`` tensor: shapes and dtypes, no allocation
    (``accelerate_tpu/big_modeling.py:45``).  A config gives what
    :func:`~accelerate_tpu_torch.weights.init_params` would draw in
    ``dtype`` (quantized shapes under ``quantization``); a module gives its
    own state dict."""
    if isinstance(config_or_model, nn.Module):
        return {k: torch.empty_like(v, device="meta")
                for k, v in config_or_model.state_dict().items()}
    from .weights import _draw_plan

    _, _, plan = _draw_plan(config_or_model, dtype)
    return {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in plan.items()}


def init_params_on_host(config: TransformerConfig, seed: int = 0,
                        dtype: torch.dtype = torch.bfloat16,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Seeded weights in one pinned host block, each tensor drawn on the card
    (``device``) and copied out as it is drawn, so that the card holds one
    tensor at a time (``:55``).  The values are ``init_params(config,
    seed)``'s."""
    from .weights import init_params

    shapes = init_empty_weights(config, dtype)
    return init_params(config, seed, device=device, dtype=dtype,
                       device_map={m: "cpu" for m in top_level_modules(shapes)})


# -------------------------------------------------------------- checkpoints
_BIN_CACHE: Dict[Any, Dict[str, torch.Tensor]] = {}
_BIN_CACHE_MAX = 16  # keyed on (path, mtime, size): a rewritten file is never served stale


def _bin_entries(fname: str) -> Dict[str, torch.Tensor]:
    """A torch ``.bin`` shard as ``{key: host tensor}``, memory-mapped
    (``torch.load(weights_only=True)``); cached, since the format has no
    header-only read."""
    stat = os.stat(fname)
    key = (fname, stat.st_mtime_ns, stat.st_size)
    cached = _BIN_CACHE.get(key)
    if cached is None:
        cached = torch.load(fname, map_location="cpu", mmap=True, weights_only=True)
        for k in [k for k in _BIN_CACHE if k[0] == fname]:
            del _BIN_CACHE[k]
        while len(_BIN_CACHE) >= _BIN_CACHE_MAX:
            del _BIN_CACHE[next(iter(_BIN_CACHE))]
        _BIN_CACHE[key] = cached
    return cached


def _checkpoint_files(checkpoint: str) -> Dict[str, str]:
    """``{tensor name: file}`` of a single file, or of a directory holding
    ``model.safetensors``, ``pytorch_model.bin`` or a sharded
    ``*.index.json`` of either (``:132``)."""
    if os.path.isfile(checkpoint):
        files = [checkpoint]
    else:
        for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
            index_path = os.path.join(checkpoint, index_name)
            if os.path.isfile(index_path):
                with open(index_path) as f:
                    weight_map = json.load(f)["weight_map"]
                return {k: os.path.join(checkpoint, v) for k, v in weight_map.items()}
        for single_name in ("model.safetensors", "pytorch_model.bin"):
            single = os.path.join(checkpoint, single_name)
            if os.path.isfile(single):
                files = [single]
                break
        else:
            raise FileNotFoundError(
                f"No checkpoint found at {checkpoint} (looked for model.safetensors"
                "[.index.json] and pytorch_model.bin[.index.json])")
    mapping: Dict[str, str] = {}
    for fname in files:
        keys = _bin_entries(fname) if fname.endswith(".bin") else read_header(fname)[0]
        mapping.update(dict.fromkeys(keys, fname))
    return mapping


def checkpoint_shapes(checkpoint: str, files: Optional[Dict[str, str]] = None
                      ) -> Dict[str, torch.Tensor]:
    """``{name: meta tensor}`` from the checkpoint's headers: no tensor byte
    is read (``:94``).  A ``.bin`` shard is memory-mapped instead."""
    files = files if files is not None else _checkpoint_files(checkpoint)
    by_file: Dict[str, List[str]] = {}
    for key, fname in files.items():
        by_file.setdefault(fname, []).append(key)
    flat: Dict[str, torch.Tensor] = {}
    for fname, keys in by_file.items():
        if fname.endswith(".bin"):
            entries = _bin_entries(fname)
            for key in keys:
                flat[key] = torch.empty_like(entries[key], device="meta")
            continue
        header, _ = read_header(fname)
        for key in keys:
            flat[key] = torch.empty(header[key]["shape"], dtype=tensor_dtype(header[key]),
                                    device="meta")
    return {k: flat[k] for k in files}


def _placed(name: str, t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A checkpoint tensor in the dtype the model holds it: norm parameters
    and routers f32, quantized codes and scales as stored, the rest in
    ``dtype`` (default: as stored)."""
    from .weights import is_f32_param

    if is_f32_param(name):
        return t.to(torch.float32)
    if dtype is not None and t.is_floating_point() and not name.endswith((".qweight",
                                                                          ".scales")):
        return t.to(dtype)
    return t


def _read_tensors(files: Dict[str, str], keys, dtype=None) -> Dict[str, torch.Tensor]:
    """Host tensors of ``keys``: memory maps of the checkpoint's bytes (a
    cast copies)."""
    headers: Dict[str, Any] = {}
    out = {}
    for k in keys:
        fname = files[k]
        if fname.endswith(".bin"):
            t = _bin_entries(fname)[k]
        else:
            if fname not in headers:
                headers[fname] = read_header(fname)
            header, base = headers[fname]
            t = map_tensor(fname, header[k], base)
        out[k] = _placed(k, t, dtype)
    return out


# ----------------------------------------------------------------- dispatch
def _validate_device_map(device_map: Dict[str, DeviceId], modules, what: str = "model") -> None:
    """An explicit map must cover exactly the top-level modules: a module
    left out silently defaulting to the card would defeat the offload asked
    for (``:226``)."""
    known = set(modules)
    unknown = [k for k in device_map if k not in known]
    missing = [m for m in known if m not in device_map]
    if unknown:
        raise ValueError(
            f"device_map keys {unknown} are not modules of this {what} "
            f"(modules: {sorted(known)}). To pass per-device byte budgets use "
            "max_memory=... with device_map='auto'.")
    if missing:
        raise ValueError(
            f"device_map does not cover modules {sorted(missing)}; every top-level "
            "module needs a placement (device index, 'cpu', or 'disk').")


def _target_device(target: DeviceId, device: torch.device) -> torch.device:
    """The device a map's card entry names: ``device`` itself (index 0, or
    its own index).  Another card is ROADMAP item 9e-ii."""
    index = target.index if isinstance(target, torch.device) else (
        torch.device(target).index if isinstance(target, str) else int(target))
    if index not in (None, 0, device.index):
        raise NotImplementedError(
            f"device_map target {target!r}: a map over several cards is not ported "
            "(ROADMAP Queue 1 item 9e-ii); map the model onto one card, 'cpu' and 'disk'")
    return device


def _pinned_copy(flat: Dict[str, torch.Tensor], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """Copies of ``flat`` in one pinned host block (pageable when the exec
    device is the CPU)."""
    views = pinned_host_views({k: (tuple(t.shape), t.dtype) for k, t in flat.items()},
                              pin=device.type == "cuda")
    for k, t in flat.items():
        views[k].copy_(t)
    return views


def dispatch_params(params: Dict[str, torch.Tensor], device_map: Dict[str, DeviceId],
                    offload_folder: Optional[str] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[OffloadedWeightsLoader]]:
    """Place each top-level module of a state dict per ``device_map``
    (``:246``): a card entry on ``device`` (the card unless
    ``device="cpu"``), ``"cpu"`` modules copied into one pinned host block,
    ``"disk"`` modules written to ``offload_folder`` as ``.dat`` files.
    Returns the placed state dict (disk modules left out) and a loader over
    the cpu and disk entries, which a :class:`StreamingTransformer` reads."""
    device = resolve_device(device)
    _validate_device_map(device_map, top_level_modules(params))
    placed, host, disk = {}, {}, {}
    for name, t in params.items():
        target = device_map[module_of(name)]
        if target == "disk":
            disk[name] = t
        elif target == "cpu":
            host[name] = t
        else:
            placed[name] = t.to(_target_device(target, device))
    if disk and offload_folder is None:
        raise ValueError("device_map places modules on 'disk' but no offload_folder was given.")
    host = _pinned_copy(host, device)
    placed = {k: placed.get(k, host.get(k)) for k in params if k not in disk}
    loader = None
    if disk:
        offload_state_dict(offload_folder, disk)
        loader = OffloadedWeightsLoader(state_dict=host, save_folder=offload_folder)
    elif host:
        loader = OffloadedWeightsLoader(state_dict=host)
    return placed, loader


def _mesh_size(mesh) -> int:
    """The cards of a mesh: a torch ``DeviceMesh`` or an array of devices."""
    if mesh is None:
        return 1
    return int(mesh.size() if callable(getattr(mesh, "size", None)) else np.size(mesh))


def shard_params_for_inference(params: Dict[str, torch.Tensor], mesh=None, axis=None,
                               device: Optional[Union[str, torch.device]] = None
                               ) -> Dict[str, torch.Tensor]:
    """Every weight on the one card of a mesh of one (``:288``).  A mesh of
    several cards (tensor-sharded weights) is ROADMAP item 9e-ii."""
    if _mesh_size(mesh) > 1:
        raise NotImplementedError("sharding weights over a mesh of several cards is not "
                                  "ported (ROADMAP Queue 1 item 9e-ii)")
    device = resolve_device(device)
    return {k: v.to(device) for k, v in params.items()}


def cpu_offload(params: Dict[str, torch.Tensor],
                exec_device_map: Optional[Dict[str, DeviceId]] = None,
                device: Optional[Union[str, torch.device]] = None):
    """Every module on pinned host memory, streamed each forward, except what
    ``exec_device_map`` keeps on the card (``:325``)."""
    device_map = {mod: "cpu" for mod in top_level_modules(params)}
    device_map.update(exec_device_map or {})
    return dispatch_params(params, device_map, device=device)


def disk_offload(params: Dict[str, torch.Tensor], offload_folder: str,
                 device: Optional[Union[str, torch.device]] = None):
    """Every module in ``.dat`` files under ``offload_folder`` (``:334``)."""
    device_map = {mod: "disk" for mod in top_level_modules(params)}
    return dispatch_params(params, device_map, offload_folder=offload_folder, device=device)


def load_checkpoint_and_dispatch(model, checkpoint: str,
                                 device_map: Union[str, Dict[str, DeviceId]] = "auto",
                                 max_memory: Optional[Dict[DeviceId, int]] = None,
                                 offload_folder: Optional[str] = None,
                                 dtype: Optional[torch.dtype] = None, mesh=None,
                                 quantization=None,
                                 device: Optional[Union[str, torch.device]] = None):
    """Load a checkpoint with its placement decided before any tensor is read
    (``:342``).

    ``device_map`` is ``"auto"``/``"balanced"``/``"balanced_low_0"``
    (greedy packing over the budgets of
    :func:`~accelerate_tpu_torch.utils.modeling.get_balanced_memory`,
    spilling to ``"cpu"`` and ``"disk"``), ``"sharded"`` (everything on the
    card) or an explicit ``{module: 0 | "cpu" | "disk"}``.
    ``quantization`` (a
    :class:`~accelerate_tpu_torch.ops.quantization.QuantizationConfig`)
    quantizes the projections as they are read, the budgets seeing the
    quantized sizes: ``"cpu"`` modules on the host, card modules on the
    card.  Disk modules are zero-copy references into the checkpoint, so
    they cannot be quantized.  A HF model directory is converted first
    (:func:`~accelerate_tpu_torch.models.hf_compat.convert_hf_checkpoint`).

    Returns ``(state dict, device_map, loader)``: the state dict holds the
    card and cpu modules, the loader the cpu and disk ones (``None`` when
    there are none).  ``model`` is accepted for the reference's signature."""
    from .models.hf_compat import convert_hf_checkpoint, is_hf_checkpoint
    from .ops.quantization import quantize_flat_tree

    device = resolve_device(device)
    if os.path.isdir(checkpoint) and is_hf_checkpoint(checkpoint):
        checkpoint = convert_hf_checkpoint(checkpoint, dtype=dtype)
    files = _checkpoint_files(checkpoint)
    abstract = {k: _placed(k, t, dtype) for k, t in checkpoint_shapes(checkpoint, files).items()}
    if quantization is not None:
        abstract = quantize_flat_tree(abstract, quantization)

    def read(keys, target: torch.device):
        flat = {k: t.to(target) for k, t in _read_tensors(files, keys, dtype).items()}
        return quantize_flat_tree(flat, quantization) if quantization is not None else flat

    if device_map == "sharded":
        if _mesh_size(mesh) > 1:
            raise NotImplementedError("device_map='sharded' over a mesh of several cards is "
                                      "not ported (ROADMAP Queue 1 item 9e-ii)")
        return read(list(files), device), "sharded", None
    if isinstance(device_map, str):
        if device_map not in ("auto", "balanced", "balanced_low_0"):
            raise ValueError(f"Unknown device_map {device_map!r}")
        budgets = get_balanced_memory(abstract, max_memory,
                                      low_zero=device_map == "balanced_low_0")
        device_map = infer_auto_device_map(abstract, budgets)
    _validate_device_map(device_map, top_level_modules(abstract), what="checkpoint")
    placed: Dict[str, torch.Tensor] = {}
    host: Dict[str, torch.Tensor] = {}
    refs: Dict[str, str] = {}
    for mod in top_level_modules(abstract):
        target = device_map[mod]
        keys = [k for k in files if module_of(k) == mod]
        if target == "disk":
            if quantization is not None:
                raise ValueError(
                    "quantization with disk-mapped modules is not supported: disk entries "
                    "are zero-copy references into the fp checkpoint. Raise max_memory "
                    "(quantized weights are 4-8x smaller) or use 'cpu'.")
            if any(files[k].endswith(".bin") for k in keys):
                raise ValueError(f"module {mod!r} is mapped to 'disk' but lives in a torch "
                                 ".bin shard, which has no byte-range read; save the "
                                 "checkpoint as safetensors")
            refs.update((k, files[k]) for k in keys)
        elif target == "cpu":
            flat = _pinned_copy(read(keys, torch.device("cpu")), device)
            host.update(flat)
            placed.update(flat)
        else:
            placed.update(read(keys, _target_device(target, device)))
    loader = None
    if host or refs:
        loader = OffloadedWeightsLoader(state_dict=host, safetensors_files=refs)
    return placed, device_map, loader


# ------------------------------------------------------- streaming executor
class StageHook:
    """The extension protocol of :class:`StreamingExecutor` (the reference's
    ``ModelHook``; ``:487``): subclass and override any of

    * :meth:`fetch_weights` — where a stage's weights come from (a bespoke
      store); ``None`` falls through to the executor's params and loader;
    * :meth:`pre_stage` / :meth:`post_stage` — observe or replace the carry
      at a stage's entry and exit (``None`` keeps it).

    Hooks run in attach order; ``fetch_weights`` takes the first result
    that is not ``None``.  Every stage's weights are resolved at the start
    of a forward (transfers run ahead of the compute), so ``fetch_weights``
    sees the stages in order before any ``pre_stage``."""

    def fetch_weights(self, executor: "StreamingExecutor", stage_index: int, source):
        return None

    def pre_stage(self, executor: "StreamingExecutor", stage_index: int, carry: tuple):
        return None

    def post_stage(self, executor: "StreamingExecutor", stage_index: int, carry: tuple):
        return None


def _flatten(tree) -> Tuple[list, Any]:
    """Leaves of nested dicts, tuples and lists, and the structure to rebuild
    them with :func:`_unflatten`."""
    if isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
        return [x for ls, _ in parts for x in ls], (dict, list(tree), [s for _, s in parts])
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        return [x for ls, _ in parts for x in ls], (type(tree), None, [s for _, s in parts])
    return [tree], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        vals = [build(sub) for sub in subs]
        return dict(zip(keys, vals)) if kind is dict else kind(vals)

    return build(spec)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _view(buf: torch.Tensor, offset: int, like: torch.Tensor) -> torch.Tensor:
    return buf[offset: offset + _nbytes(like)].view(like.dtype).view(like.shape)


@dataclasses.dataclass
class _Stage:
    """One stage's weights for one forward: ``kind`` says how the leaves
    that travel (``moved``) reach the card: ``"resident"`` (none travel),
    ``"pinned"`` (each from its own pinned tensor), ``"packed"`` (from the
    snapshot ``groups``: ``(host byte buffer, its offset in the device
    buffer)``) or ``"mapped"`` (gathered into the pinned staging buffer)."""

    spec: Any
    tensors: List[torch.Tensor]
    moved: List[int]
    kind: str
    offsets: List[int]
    nbytes: int
    groups: List[Tuple[torch.Tensor, int]] = dataclasses.field(default_factory=list)


class StreamingExecutor:
    """A plan of ``(weights source, fn)`` stages run with just-in-time
    weights (``:526``): ``fn(stage_params, *carry) -> carry`` is any
    function of torch tensors, and a source is a module name (resolved
    against ``params``, then ``weights_loader``) or a callable returning the
    stage's weights (a nested dict/tuple of tensors).  How the weights
    travel is in the module docstring; :meth:`invalidate_cache` drops the
    packed snapshots.  ``exec_device`` is the card unless ``"cpu"``."""

    def __init__(self, plan, params=None, weights_loader=None, exec_device=None, hooks=None):
        self.plan = list(plan)
        if not self.plan:
            raise ValueError("StreamingExecutor needs a non-empty plan")
        self.params = params if params is not None else {}
        self.loader = weights_loader
        self.hooks = list(hooks) if hooks else []
        self.device = resolve_device(exec_device)
        cuda = self.device.type == "cuda"
        # stage -> (leaf refs, host groups, offsets, nbytes): the packed snapshots
        self._packed_cache: Dict[int, Any] = {}
        # (dtype, leaf ids) -> (leaf refs, pinned host buffer), shared by stages
        self._buffer_registry: Dict[Any, Any] = {}
        self._slots: List[Optional[torch.Tensor]] = [None, None]
        self._staging: List[Optional[torch.Tensor]] = [None, None]
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._copied = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._freed = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._mapped_read = False
        #: bytes copied to the card by the last forward
        self.last_bytes_streamed = 0

    # -- hooks -------------------------------------------------------------
    def add_hook(self, hook: StageHook) -> None:
        """Append a :class:`StageHook`.  New tensors a hook returns are picked
        up (the snapshot key is leaf identity); tensors edited in place need
        :meth:`invalidate_cache`."""
        self.hooks.append(hook)

    def remove_hook(self, hook: StageHook) -> None:
        self.hooks.remove(hook)

    def _hook_carry(self, method: str, i: int, carry: tuple) -> tuple:
        for h in self.hooks:
            out = getattr(h, method)(self, i, carry)
            if out is not None:
                carry = out if isinstance(out, tuple) else (out,)
        return carry

    # -- weights -----------------------------------------------------------
    def _stage_params(self, source, stage_index: int):
        for h in self.hooks:
            tree = h.fetch_weights(self, stage_index, source)
            if tree is not None:
                return tree
        return source() if callable(source) else self._module_params(source)

    def _module_params(self, name: str) -> Dict[str, Any]:
        """A module's weights as a nested dict under it: an entry of a nested
        ``params``, else its keys in a flat ``params``, else in the
        loader."""
        if isinstance(self.params.get(name), dict):
            return self.params[name]
        prefix = name + SEP
        flat = {k[len(prefix):]: v for k, v in self.params.items() if k.startswith(prefix)}
        if not flat and self.loader is not None:
            keys = [k for k in self.loader if k.startswith(prefix)]
            self._mapped_read |= any(getattr(self.loader, "is_mapped", lambda _: False)(k)
                                     for k in keys)
            flat = {k[len(prefix):]: self.loader[k] for k in keys}
        if not flat:
            raise KeyError(f"No weights for module {name!r}")
        return unflatten_tree(flat)

    def invalidate_cache(self) -> None:
        """Drop the packed host snapshots (after editing host weights in
        place; a rebind to new tensors is detected without it)."""
        self._sync_copies()
        self._packed_cache.clear()
        self._buffer_registry.clear()

    def _sync_copies(self) -> None:
        if self._copy_stream is not None:
            self._copy_stream.synchronize()

    def _resident(self, t: torch.Tensor) -> bool:
        if self.device.type == "cpu" or t.device.type != "cuda":
            return False
        if t.device != self.device:
            raise NotImplementedError(f"a weight on {t.device} while the stages run on "
                                      f"{self.device}: several cards are ROADMAP item 9e-ii")
        return True

    def _resolve(self, i: int) -> _Stage:
        """Stage ``i``'s weights for this forward, and how they travel."""
        self._mapped_read = False
        leaves, spec = _flatten(self._stage_params(self.plan[i][0], i))
        mapped = self._mapped_read or any(isinstance(x, np.memmap) for x in leaves)
        tensors = [_as_tensor(x) for x in leaves]
        moved = [j for j, t in enumerate(tensors) if not self._resident(t)]
        cuda = self.device.type == "cuda"
        if not moved:
            kind = "resident"
        elif mapped:
            kind = "mapped"
        elif cuda and all(tensors[j].is_pinned() and tensors[j].is_contiguous() for j in moved):
            kind = "pinned"
        else:
            return self._packed(i, leaves, spec, tensors, moved)
        offsets, total = [], 0
        for j in moved:
            offsets.append(total)
            total += _aligned(_nbytes(tensors[j]))
        return _Stage(spec, tensors, moved, kind, offsets, total)

    def _packed(self, i, leaves, spec, tensors, moved) -> _Stage:
        """The snapshot of stage ``i``'s host leaves: one pinned buffer per
        dtype, each shared with any stage whose same-dtype leaves are the
        same objects (a tied embedding packs once).  Valid while the stage
        resolves to the same leaf objects, which the entries hold."""
        refs = tuple(leaves[j] for j in moved)
        cached = self._packed_cache.get(i)
        if cached is None or len(cached[0]) != len(refs) or not all(
                a is b for a, b in zip(cached[0], refs)):
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for j in moved:
                by_dtype.setdefault(tensors[j].dtype, []).append(j)
            groups, where, base = [], {}, 0
            for dtype, js in by_dtype.items():
                buf, inner = self._group_buffer(dtype, [leaves[j] for j in js],
                                                [tensors[j] for j in js])
                groups.append((buf, base))
                where.update((j, base + off) for j, off in zip(js, inner))
                base += _aligned(buf.numel())
            if cached is not None:
                # a rebind superseded the old snapshot: drop the buffers no
                # stage uses any more, or every swap would keep a model copy
                self._sync_copies()
                self._packed_cache[i] = None
                live = {id(b) for entry in self._packed_cache.values() if entry
                        for b, _ in entry[1]} | {id(b) for b, _ in groups}
                self._buffer_registry = {k: v for k, v in self._buffer_registry.items()
                                         if id(v[1]) in live}
            cached = self._packed_cache[i] = (refs, groups, [where[j] for j in moved], base)
        _, groups, offsets, total = cached
        return _Stage(spec, tensors, moved, "packed", offsets, total, groups)

    def _group_buffer(self, dtype, leaves, tensors) -> Tuple[torch.Tensor, List[int]]:
        inner, total = [], 0
        for t in tensors:
            inner.append(total)
            total += _aligned(_nbytes(t))
        key = (dtype, tuple(id(x) for x in leaves))
        entry = self._buffer_registry.get(key)
        if entry is None or not all(a is b for a, b in zip(entry[0], leaves)):
            buf = pinned_host_buffer(total, pin=self.device.type == "cuda")
            for t, off in zip(tensors, inner):
                _view(buf, off, t).copy_(t)
            entry = self._buffer_registry[key] = (tuple(leaves), buf)
        return entry[1], inner

    # -- transfers -----------------------------------------------------------
    def _ensure_slots(self, nbytes: int) -> None:
        if nbytes == 0 or (self._slots[0] is not None and self._slots[0].numel() >= nbytes):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no copy or compute still reads them
        self._slots = [None, None]
        with torch.inference_mode(False):  # written again by later calls, in any mode
            self._slots = [torch.empty(nbytes, dtype=torch.uint8, device=self.device)
                           for _ in range(2)]

    def _staging_buffer(self, s: int, nbytes: int) -> torch.Tensor:
        if self._copied is not None:
            self._copied[s].synchronize()  # the last copy out of it has landed
        buf = self._staging[s]
        if buf is None or buf.numel() < nbytes:
            with torch.inference_mode(False):
                buf = self._staging[s] = pinned_host_buffer(nbytes,
                                                            pin=self.device.type == "cuda")
        return buf

    def _issue(self, st: _Stage, s: int) -> None:
        """Start stage ``st``'s copies into device buffer ``s``."""
        slot = self._slots[s]
        if st.kind == "mapped":
            staging = self._staging_buffer(s, st.nbytes)
            for j, off in zip(st.moved, st.offsets):  # page faults read the files here
                _view(staging, off, st.tensors[j]).copy_(st.tensors[j])
            sources = [(staging[: st.nbytes], 0)]
        elif st.kind == "packed":
            sources = st.groups
        else:
            sources = [(st.tensors[j], off) for j, off in zip(st.moved, st.offsets)]
        stream = self._copy_stream
        if stream is not None:
            stream.wait_event(self._freed[s])
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            for src, off in sources:
                dst = (slot[off: off + src.numel()] if src.dtype == torch.uint8
                       and src.dim() == 1 else _view(slot, off, src))
                dst.copy_(src, non_blocking=stream is not None)
            if stream is not None:
                self._copied[s].record(stream)
        self.last_bytes_streamed += sum(_nbytes(st.tensors[j]) for j in st.moved)

    def _stream(self, step: Callable, carry: tuple, enter: Optional[Callable] = None) -> tuple:
        """Run every stage: ``step(i, stage_params, carry) -> carry``, with the
        hooks around it (after ``enter(i, carry) -> carry``, when given) and
        each moving stage's copies issued as soon as one of the two device
        buffers is free."""
        stages = [self._resolve(i) for i in range(len(self.plan))]
        moving = collections.deque(i for i, st in enumerate(stages) if st.kind != "resident")
        self._ensure_slots(max((stages[i].nbytes for i in moving), default=0))
        self.last_bytes_streamed = 0
        free, slot_of = [0, 1], {}
        compute = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

        def issue():
            while moving and free:
                i, s = moving.popleft(), free.pop(0)
                self._issue(stages[i], s)
                slot_of[i] = s

        with torch.no_grad():
            issue()
            for i, st in enumerate(stages):
                tensors = st.tensors
                if i in slot_of:
                    s = slot_of.pop(i)
                    if compute is not None:
                        compute.wait_event(self._copied[s])
                    tensors = list(tensors)
                    for j, off in zip(st.moved, st.offsets):
                        tensors[j] = _view(self._slots[s], off, st.tensors[j])
                if enter is not None:
                    carry = enter(i, carry)
                carry = self._hook_carry("pre_stage", i, carry)
                out = step(i, _unflatten(st.spec, tensors), carry)
                carry = out if isinstance(out, tuple) else (out,)
                carry = self._hook_carry("post_stage", i, carry)
                if st.kind != "resident":
                    if compute is not None:
                        self._freed[s].record(compute)
                    free.append(s)
                    issue()
        return carry

    def _to_device(self, x):
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def __call__(self, *inputs):
        fns = [fn for _, fn in self.plan]
        carry = self._stream(lambda i, p, c: fns[i](p, *c),
                             tuple(self._to_device(x) for x in inputs))
        return carry[0] if len(carry) == 1 else carry


def make_layer_plan(embed, layers, head):
    """The embed -> layers -> head plan of a decoder stack (``:767``):
    ``embed`` and ``head`` are ``(source, fn)``, ``layers`` an iterable of
    them."""
    return [embed, *layers, head]


class _EmbedShell(Transformer):
    """:meth:`Transformer.embed` as a forward, for ``functional_call``."""

    def forward(self, input_ids, positions):
        return self.embed(input_ids, positions)


class _HeadShell(Transformer):
    """:meth:`Transformer.head` as a forward, for ``functional_call``."""

    def forward(self, x):
        return self.head(x)


class StreamingTransformer(StreamingExecutor):
    """The port's :class:`~accelerate_tpu_torch.models.transformer.Transformer`
    over :class:`StreamingExecutor` (``:778``): an embed stage, the layers in
    chunks of ``layers_per_stage``, and a head stage.  Each stage calls a
    shell module built on ``meta`` (the model's own ``embed``,
    ``DecoderLayer`` and ``head``) through ``torch.func.functional_call``
    with its weights, so the streamed forward computes what the resident
    model computes, on the same kernels (K3 on the no-cache forward under
    ``attention_impl="pallas"``).  Tied embeddings (the head reads
    ``embed_tokens``), BLOOM's ``embed_norm``, learned positions and
    quantized or MoE layers come from the config.

    ``params`` is a flat state dict (what :func:`dispatch_params` and
    :func:`load_checkpoint_and_dispatch` return), the rest in
    ``weights_loader``."""

    def __init__(self, config: TransformerConfig, params=None,
                 device_map: Optional[Dict[str, DeviceId]] = None, weights_loader=None,
                 exec_device=None, layers_per_stage: int = 1, hooks=None):
        cfg = config
        self.config = cfg
        self.device_map = device_map or {}
        k = max(1, int(layers_per_stage))
        self._chunks = [tuple(range(start, min(start + k, cfg.num_layers)))
                        for start in range(0, cfg.num_layers, k)]
        shell_cfg = dataclasses.replace(cfg, num_layers=0)
        self._embed_shell = _EmbedShell(shell_cfg, device="meta")
        self._head_shell = _HeadShell(shell_cfg, device="meta")
        with torch.device("meta"):
            self._layer_shell = DecoderLayer(cfg)
        embed_modules = ["embed_tokens"]
        if cfg.embed_norm:
            embed_modules.append("embed_norm")
        if cfg.positional == "learned":
            embed_modules.append("pos_embed")
        head_modules = ["final_norm", "embed_tokens" if cfg.tie_word_embeddings else "lm_head"]

        def named(modules):
            return lambda: {m: self._module_params(m) for m in modules}

        plan = make_layer_plan(
            embed=(named(embed_modules), self._embed_fn),
            # bind each chunk by default argument (a bare lambda would see the last)
            layers=[(lambda c=chunk: tuple(self._module_params(f"layers{SEP}{i}") for i in c),
                     self._layer_fn) for chunk in self._chunks],
            head=(named(head_modules), self._head_fn),
        )
        super().__init__(plan, params=params, weights_loader=weights_loader,
                         exec_device=exec_device, hooks=hooks)

    # -- stage functions ------------------------------------------------------
    # each stage binds its weights (nested dicts, flattened to the module's
    # own names) to a shell module for one call
    def _embed_fn(self, params, input_ids, positions):
        x = torch.func.functional_call(self._embed_shell, flatten_tree(params),
                                       (input_ids, positions))
        return x, positions

    def _layer_fn(self, chunk_params, x, positions):
        for lp in chunk_params:
            x = torch.func.functional_call(self._layer_shell, flatten_tree(lp), (x, positions))
        return x, positions

    def _cached_layer_fn(self, chunk_params, x, positions, kv: KVCache):
        for j, lp in enumerate(chunk_params):
            x = torch.func.functional_call(self._layer_shell, flatten_tree(lp), (x, positions),
                                           {"cache": kv, "layer": j})
        return x

    def _head_fn(self, params, x, positions=None):
        return torch.func.functional_call(self._head_shell, flatten_tree(params), (x,))

    def _positions(self, input_ids: torch.Tensor, offset=None) -> torch.Tensor:
        b, s = input_ids.shape
        positions = torch.arange(s, device=self.device)[None, :].expand(b, -1)
        return positions if offset is None else positions + offset.long()[:, None]

    def __call__(self, input_ids, positions=None):
        """No-cache forward: ``input_ids [B, S]`` -> f32 logits ``[B, S, V]``."""
        input_ids = self._to_device(torch.as_tensor(input_ids))
        if positions is None:
            positions = self._positions(input_ids)
        return super().__call__(input_ids, self._to_device(positions))

    # -- decode: the weights stream every token, the cache stays on the card --
    def init_cache(self, batch_size: int, max_len: int, dtype: Optional[torch.dtype] = None,
                   per_lane_index: bool = False) -> Dict[str, Any]:
        """``{"chunks": [(k, v), ...], "index": ...}`` on the exec device: a
        slab ``[layers of the chunk, B, max_len, Hkv, D]`` per chunk for K and
        for V, written in place, and the write index, a scalar (every lane at
        one position) or, with ``per_lane_index``, ``[B]`` (each lane at its
        own, the serving pool's contract) (``:946``)."""
        cfg = self.config
        dtype = dtype or cfg.dtype
        chunks = []
        for c in self._chunks:
            shape = (len(c), batch_size, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            chunks.append((torch.zeros(shape, dtype=dtype, device=self.device),
                           torch.zeros(shape, dtype=dtype, device=self.device)))
        index = torch.zeros((batch_size,) if per_lane_index else (), dtype=torch.int32,
                            device=self.device)
        return {"chunks": chunks, "index": index}

    def forward_with_cache(self, input_ids, cache: Dict[str, Any]):
        """Incremental forward (a prompt, or one token a lane) through the
        streamed stages: ``(logits [B, S, V], cache)`` with the index
        advanced by ``S`` (``:975``).  The hooks see the layer stages' carry
        as ``(x, positions, chunk cache)`` on entry and ``(x, positions)`` on
        exit."""
        input_ids = self._to_device(torch.as_tensor(input_ids))
        b, s = input_ids.shape
        index = cache["index"]
        lanes = index.expand(b) if index.dim() == 0 else index
        positions = self._positions(input_ids, lanes)
        last = len(self.plan) - 1

        def step(i, params, carry):
            if i == 0:
                return self._embed_fn(params, *carry)
            if i == last:
                return self._head_fn(params, *carry)
            x, pos, kv = carry
            return self._cached_layer_fn(params, x, pos, kv), pos

        def enter(i, carry):
            if not 0 < i < last:
                return carry
            k, v = cache["chunks"][i - 1]
            return (*carry, KVCache(k=k, v=v, index=lanes))

        (logits,) = self._stream(step, (input_ids, positions), enter)
        return logits, {"chunks": cache["chunks"], "index": index + s}

    def generate(self, input_ids, max_new_tokens: int = 128, do_sample: bool = False,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0, generator: Optional[torch.Generator] = None,
                 cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """A host-driven token loop over :meth:`forward_with_cache`: every
        token streams the weights once (``:1017``).  Lanes that emitted
        ``eos_token_id`` emit ``pad_token_id`` after it; once every lane
        has, no forward runs.  Returns the ``[B, S + max_new_tokens]``
        sequences on the host."""
        input_ids = self._to_device(torch.as_tensor(input_ids))
        b, s = input_ids.shape
        if cache is None:
            cache = self.init_cache(b, s + max_new_tokens)
        else:
            check_cache_room(int(cache["index"].max()), s, max_new_tokens,
                             cache["chunks"][0][0].shape[2])
        sample = make_sampler(do_sample, temperature, top_k, top_p)
        logits, cache = self.forward_with_cache(input_ids, cache)
        tok = sample(logits[:, -1], generator)
        done = np.zeros(b, dtype=bool)
        if eos_token_id is not None:
            done |= tok.cpu().numpy() == eos_token_id
        toks = [tok]
        for _ in range(max_new_tokens - 1):
            if done.all():
                toks.append(torch.full_like(tok, pad_token_id))
                continue
            logits, cache = self.forward_with_cache(toks[-1][:, None], cache)
            nxt = sample(logits[:, -1], generator)
            nxt = torch.where(torch.from_numpy(done).to(nxt.device), pad_token_id, nxt)
            if eos_token_id is not None:
                done |= nxt.cpu().numpy() == eos_token_id
            toks.append(nxt.to(torch.int32))
        seq = torch.cat([input_ids, torch.stack(toks, dim=1).to(input_ids.dtype)], dim=1)
        return seq.cpu()


"""Disk-offloaded weights, and the pinned host memory that offloaded weights
stream from.

Port of :mod:`accelerate_tpu.utils.offload`, in the same on-disk format
byte for byte: :func:`offload_state_dict` writes each tensor's raw bytes to
``<name>.dat`` and one ``index.json`` of its dtype and shape, bf16 stored as
int16 (and fp8 as uint8), so a folder either package writes, the other
reads.  :class:`OffloadedWeightsLoader` is a lazy mapping over in-memory
tensors, those ``.dat`` files and tensors still inside safetensors
checkpoints; the last two come back as zero-copy memory maps
(:meth:`OffloadedWeightsLoader.is_mapped`), read page by page as a transfer
touches them.

:func:`pinned_host_buffer` is the page-locked host memory of the port's
big-model path: an exactly sized block registered with
``cudaHostRegister`` (``pin_memory=True`` goes through torch's caching host
allocator, which rounds a request up to a power of two and keeps freed
blocks).
"""

from __future__ import annotations

import json
import os
import weakref
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..checkpointing import map_tensor, read_header

# dtypes numpy cannot hold: their raw bytes go through an integer of the
# same width (the reference stores bf16 as int16 the same way)
_RAW = {torch.bfloat16: (np.int16, torch.int16), torch.float8_e4m3fn: (np.uint8, torch.uint8),
        torch.float8_e5m2: (np.uint8, torch.uint8)}
_RAW_BY_NAME = {str(t).replace("torch.", ""): (t, raw[0]) for t, raw in _RAW.items()}

_ALIGN = 256  # byte offset of each tensor in a pinned host block


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name the index records (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).replace("torch.", "")


def _as_numpy(weight) -> np.ndarray:
    """A host array of ``weight``'s bytes: bf16 and fp8 as the integer of
    their width."""
    if isinstance(weight, torch.Tensor):
        t = weight.detach().to("cpu").contiguous()
        if t.dtype in _RAW:
            t = t.view(_RAW[t.dtype][1])
        return t.numpy()
    arr = np.asarray(weight)
    if arr.dtype.name in _RAW_BY_NAME:  # an ml_dtypes array (bf16 from JAX)
        return arr.view(_RAW_BY_NAME[arr.dtype.name][1])
    return arr


def offload_weight(weight, weight_name: str, offload_folder: str,
                   index: Optional[Dict] = None, sync: bool = True) -> Dict:
    """Write one tensor (or array) as ``<weight_name>.dat`` (reference
    ``offload_weight``, ``accelerate_tpu/utils/offload.py:21``); a 0-d
    tensor is stored as one element.  ``sync=False`` skips the ``msync``."""
    dtype = (dtype_name(weight.dtype) if isinstance(weight, torch.Tensor)
             else str(np.asarray(weight).dtype))
    arr = _as_numpy(weight)
    array_path = os.path.join(offload_folder, f"{weight_name}.dat")
    os.makedirs(os.path.dirname(array_path), exist_ok=True)
    file_array = np.memmap(array_path, dtype=arr.dtype, mode="w+", shape=arr.shape or (1,))
    if arr.shape == ():
        file_array[0] = arr
    else:
        file_array[:] = arr[:]
    if sync:
        file_array.flush()
    entry = {"dtype": dtype, "shape": list(arr.shape)}
    if index is None:
        return {weight_name: entry}
    index[weight_name] = entry
    return index


def load_offloaded_weight(weight_file: str, weight_info: Dict) -> torch.Tensor:
    """One ``.dat`` file as a host tensor over a copy-on-write memory map:
    zero-copy, and never written back (reference ``load_offloaded_weight``,
    ``:56``)."""
    shape = tuple(weight_info["shape"])
    name = weight_info["dtype"]
    if name in _RAW_BY_NAME:
        dtype, raw_np = _RAW_BY_NAME[name]
        raw = np.memmap(weight_file, dtype=raw_np, mode="c", shape=shape or (1,))
        t = torch.from_numpy(raw).view(dtype)
    else:
        t = torch.from_numpy(np.memmap(weight_file, dtype=np.dtype(name), mode="c",
                                       shape=shape or (1,)))
    return t.reshape(shape)


def offload_state_dict(save_dir: str, state_dict: Dict[str, Any]) -> None:
    """Offload a flat dict of tensors to ``save_dir`` (``:73``)."""
    os.makedirs(save_dir, exist_ok=True)
    index: Dict[str, Dict] = {}
    for name, value in state_dict.items():
        index = offload_weight(value, name, save_dir, index=index)
    save_offload_index(index, save_dir)


def save_offload_index(index: Dict, offload_folder: str) -> None:
    if not index:
        return
    index_path = os.path.join(offload_folder, "index.json")
    if os.path.isfile(index_path):
        with open(index_path) as f:
            existing = json.load(f)
        existing.update(index)
        index = existing
    with open(index_path, "w") as f:
        json.dump(index, f, indent=2)


def load_offload_index(offload_folder: str) -> Dict[str, Dict]:
    index_path = os.path.join(offload_folder, "index.json")
    if not os.path.isfile(index_path):
        return {}
    with open(index_path) as f:
        return json.load(f)


class OffloadedWeightsLoader(Mapping):
    """Lazy mapping over in-memory tensors, ``.dat`` memory maps and tensors
    still inside safetensors files (reference ``OffloadedWeightsLoader``,
    ``:104``).  ``safetensors_files`` maps a tensor's name to the file that
    holds it; the port reads the header once a file and maps the tensor's
    byte range."""

    def __init__(self, state_dict: Optional[Dict[str, Any]] = None,
                 save_folder: Optional[str] = None, index: Optional[Dict[str, Dict]] = None,
                 safetensors_files: Optional[Dict[str, str]] = None):
        if state_dict is None and save_folder is None and not safetensors_files:
            raise ValueError("Need at least one of state_dict, save_folder, safetensors_files.")
        self.state_dict = dict(state_dict or {})
        self.save_folder = save_folder
        self.index = dict(index if index is not None
                          else (load_offload_index(save_folder) if save_folder else {}))
        self.safetensors_files = dict(safetensors_files or {})
        self._headers: Dict[str, Any] = {}
        self.all_keys = list(self.state_dict)
        self.all_keys += [k for k in self.index if k not in self.state_dict]
        seen = set(self.all_keys)
        self.all_keys += [k for k in self.safetensors_files if k not in seen]

    def is_mapped(self, key: str) -> bool:
        """Whether ``self[key]`` is a memory map of a file (pageable, read
        on touch) rather than a tensor held in memory."""
        return key not in self.state_dict and (key in self.index
                                               or key in self.safetensors_files)

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        if key in self.index:
            return load_offloaded_weight(os.path.join(self.save_folder, f"{key}.dat"),
                                         self.index[key])
        if key in self.safetensors_files:
            path = self.safetensors_files[key]
            if path not in self._headers:
                self._headers[path] = read_header(path)
            header, base = self._headers[path]
            return map_tensor(path, header[key], base)
        raise KeyError(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self.all_keys)

    def __len__(self) -> int:
        return len(self.all_keys)


class PrefixedDataset(Mapping):
    """A mapping's entries under a key prefix, prefix stripped (reference
    ``PrefixedDataset``, ``:146``)."""

    def __init__(self, dataset: Mapping, prefix: str):
        self.dataset = dataset
        self.prefix = prefix

    def __getitem__(self, key):
        return self.dataset[f"{self.prefix}{key}"]

    def __iter__(self):
        return iter(k[len(self.prefix):] for k in self.dataset if k.startswith(self.prefix))

    def __len__(self):
        return sum(1 for k in self.dataset if k.startswith(self.prefix))


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pinned_host_buffer(nbytes: int, pin: bool = True) -> torch.Tensor:
    """A zero-filled host byte buffer of exactly ``nbytes``, page-locked with
    ``cudaHostRegister`` when ``pin`` (a CPU run passes ``pin=False``).
    The registration is undone when the buffer's storage dies, so views of
    it stay pinned as long as any of them lives.  A registration that fails
    raises: nothing falls back to pageable memory."""
    buf = torch.zeros(max(int(nbytes), 1), dtype=torch.uint8)
    if pin:
        err = torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), buf.numel(), 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes / 1e9:.3f} GB failed: {err} "
                               "(the host's locked-memory limit, or its free memory)")
        weakref.finalize(buf.untyped_storage(), _unregister, buf.data_ptr())
    return buf


def pinned_host_views(specs: Dict[str, Any], pin: bool = True) -> Dict[str, torch.Tensor]:
    """One :func:`pinned_host_buffer` for every ``name -> (shape, dtype)``
    of ``specs``, and each name's view of it, every tensor at a 256-byte
    offset (the alignment a tensor on the card has)."""
    offsets, total = {}, 0
    for name, (shape, dtype) in specs.items():
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype, device="meta").element_size()
        offsets[name] = (total, nbytes)
        total += -(-nbytes // _ALIGN) * _ALIGN
    block = pinned_host_buffer(total, pin=pin)
    return {name: block[off: off + n].view(specs[name][1]).view(specs[name][0])
            for name, (off, n) in offsets.items()}

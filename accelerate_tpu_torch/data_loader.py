"""Data pipeline of the training path: sharded samplers, device-placing loaders, resume.

Port of :mod:`accelerate_tpu.data_loader`: :class:`SimpleDataLoader` and
:func:`default_collate` (torch-free map-style loading into numpy stacks);
the index math that shards batches over processes, the reference's
exactly (:class:`BatchSamplerShard`, :class:`IterableDatasetShard`);
:class:`DataLoaderShard` (device placement, a prefetch window, the
one-batch lookahead that flags ``end_of_dataloader``, ``remainder``,
registration with :class:`~accelerate_tpu_torch.state.GradientState`, the
RNG synchronized across processes at each epoch's start);
:class:`DataLoaderDispatcher` (process 0 reads, every process gets its
slice of the broadcast batch); :func:`prepare_data_loader` and the
skipping loaders of a mid-epoch resume.

The JAX package shards by host and then splits each host's batch over
the mesh's data axes; here a process is one mesh position, so the shards
are the mesh's data shards: with a ``mesh``, :func:`prepare_data_loader`
gives the rank at data-shard index ``i`` of ``n`` (:func:`~accelerate_tpu_
torch.parallel.mesh.data_shard_index`) the rows the reference places on
that mesh position, and ranks that differ only on model axes (``tp``) the
same rows.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Iterable, List, Optional

import numpy as np

from .state import GradientState, PartialState
from .utils.operations import (
    broadcast,
    broadcast_object_list,
    concatenate,
    find_batch_size,
    pad_input_tensors,
    process_topology,
    recursively_apply,
    send_to_device,
    slice_tensors,
)
from .utils.random import synchronize_rng_states

_PYTORCH_DATALOADER_KWARGS = (
    "batch_size", "shuffle", "sampler", "batch_sampler", "num_workers", "collate_fn",
    "pin_memory", "drop_last", "timeout", "worker_init_fn", "multiprocessing_context",
    "generator", "prefetch_factor", "persistent_workers",
)


class SeedableRandomSampler:
    """Deterministic shuffling sampler, reseeded per epoch (``seed + epoch``)."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def state_dict(self):
        return {"seed": self.seed, "epoch": self.epoch}

    def load_state_dict(self, state):
        self.seed = state["seed"]
        self.epoch = state["epoch"]

    def __len__(self):
        return self.data_source_len

    def __iter__(self):
        yield from np.random.default_rng(self.seed + self.epoch).permutation(
            self.data_source_len).tolist()


class BatchSampler:
    """Groups a sampler's indices into batches."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


class SimpleDataLoader:
    """Torch-free map-style loader: dataset + (batch_)sampler + collate into numpy stacks."""

    def __init__(self, dataset, batch_size: Optional[int] = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 batch_sampler=None, sampler=None, seed: int = 0):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", None)
            self.drop_last = getattr(batch_sampler, "drop_last", False)
        else:
            if sampler is None:
                sampler = (SeedableRandomSampler(len(dataset), seed=seed) if shuffle
                           else range(len(dataset)))
            self.sampler = sampler
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.batch_sampler = BatchSampler(sampler, batch_size, drop_last)

    def set_epoch(self, epoch: int):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        sampler = getattr(self.batch_sampler, "sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for batch_indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in batch_indices])


def default_collate(items: List[Any]):
    """Stack a list of samples into a batch (numpy), recursing into dicts/tuples."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([it[i] for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class BatchSamplerShard:
    """A batch sampler sharded across processes — the reference's index math
    (``accelerate_tpu/data_loader.py:118-233``):

    - ``split_batches=False``: consecutive groups of ``num_processes``
      batches, process ``i`` takes the ``i``-th of each group; with
      ``even_batches`` the epoch's index stream is cycled from its start to
      complete the last group.
    - ``split_batches=True``: each inner batch is a global one, split into
      ``num_processes`` chunks; process ``i`` takes chunk ``i``.
    """

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        if split_batches and getattr(batch_sampler, "batch_size", None) is not None:
            if batch_sampler.batch_size % num_processes != 0:
                raise ValueError(
                    f"To use split_batches, the batch size ({batch_sampler.batch_size}) "
                    f"must be a round multiple of the number of processes ({num_processes}).")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        n = len(self.batch_sampler)
        if self.split_batches:
            return n
        if self.drop_last:
            return n // self.num_processes
        if self.even_batches:
            return math.ceil(n / self.num_processes)
        full, rem = divmod(n, self.num_processes)
        return full + (1 if self.process_index < rem else 0)

    def set_epoch(self, epoch: int):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        sampler = getattr(self.batch_sampler, "sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)

    def __iter__(self):
        yield from (self._iter_split() if self.split_batches else self._iter_no_split())

    def _iter_split(self):
        n, i = self.num_processes, self.process_index
        for batch in self.batch_sampler:
            bs = len(batch)
            if (self.batch_size is None or bs == self.batch_size) and bs % n == 0:
                k = bs // n
                yield batch[i * k:(i + 1) * k]
                continue
            # a ragged last batch
            if self.drop_last:
                continue
            if self.even_batches:
                target = self.batch_size if self.batch_size is not None \
                    else math.ceil(bs / n) * n
                full_batch = list(itertools.islice(itertools.cycle(batch), target))
                k = target // n
                yield full_batch[i * k:(i + 1) * k]
            else:
                k = math.ceil(bs / n)
                yield batch[i * k:(i + 1) * k]

    def _iter_no_split(self):
        n, i = self.num_processes, self.process_index
        batches = list(self.batch_sampler)
        if not batches:
            return
        if self.drop_last:
            full = [b for b in batches if self.batch_size is None or len(b) == self.batch_size]
            for g in range(len(full) // n):
                yield full[g * n + i]
            return
        if not self.even_batches:
            for g in range(math.ceil(len(batches) / n)):
                if g * n + i < len(batches):
                    yield batches[g * n + i]
            return
        batch_size = self.batch_size or max(len(b) for b in batches)
        num_groups = math.ceil(len(batches) / n)
        stream = list(itertools.chain.from_iterable(batches))
        flat = list(itertools.islice(itertools.cycle(stream), num_groups * n * batch_size))
        rebuilt = [flat[b * batch_size:(b + 1) * batch_size] for b in range(num_groups * n)]
        for g in range(num_groups):
            yield rebuilt[g * n + i]


class IterableDatasetShard:
    """An iterable dataset sharded by buffer-and-slice (``accelerate_tpu/
    data_loader.py:236-305``): ``batch_size * num_processes`` items are
    buffered, each process takes its slice; under ``even_batches`` the
    first full buffer pads the last short one."""

    def __init__(self, dataset: Iterable, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False,
                 even_batches: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def real_batch_size(self) -> int:
        return self.batch_size // self.num_processes if self.split_batches else self.batch_size

    def __len__(self):
        n = len(self.dataset)
        real = self.real_batch_size * self.num_processes
        if self.drop_last:
            return (n // real) * self.real_batch_size
        if self.even_batches:
            return math.ceil(n / real) * self.real_batch_size
        return min(self.real_batch_size, max(0, n - self.process_index * self.real_batch_size))

    def __iter__(self):
        rb = self.real_batch_size
        buffer_size = rb * self.num_processes
        lo = self.process_index * rb
        hi = lo + rb
        first_buffer: Optional[List] = None
        buffer: List = []
        for item in self.dataset:
            buffer.append(item)
            if len(buffer) == buffer_size:
                if first_buffer is None:
                    first_buffer = list(buffer)
                yield from buffer[lo:hi]
                buffer = []
        if buffer and not self.drop_last:
            if self.even_batches:
                pad_source = first_buffer if first_buffer is not None else buffer
                k = 0
                while len(buffer) < buffer_size:
                    buffer.append(pad_source[k % len(pad_source)])
                    k += 1
                yield from buffer[lo:hi]
            else:
                yield from buffer[lo:min(hi, len(buffer))]


class DataLoaderStateMixin:
    """``begin``/``end``: registration with :class:`GradientState` and the
    epoch's ``remainder`` (``accelerate_tpu/data_loader.py:308-334``)."""

    end_of_dataloader: bool = False
    remainder: int = -1

    def begin(self):
        self.end_of_dataloader = False
        self.remainder = -1
        length = self.total_dataset_length
        if length is not None and self.total_batch_size:
            self.remainder = length % self.total_batch_size
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)


def _batch_to_numpy(batch):
    def conv(x):
        if type(x).__module__.startswith("torch"):
            return x.detach().cpu().numpy()
        return x

    return recursively_apply(conv, batch, test_type=lambda t: True)


class DevicePlacer:
    """Puts a process's batch on its device as torch tensors (the
    reference's ``DevicePlacer`` makes a global array over the mesh from
    the host's rows; here the rows are this process's shard already)."""

    def __init__(self, device=None, put_on_device: bool = True, non_blocking: bool = False):
        self.device = device
        self.put_on_device = put_on_device
        self.non_blocking = non_blocking

    def place(self, batch):
        if not self.put_on_device:
            return batch
        return send_to_device(batch, self.device, non_blocking=self.non_blocking)


class DataLoaderShard(DataLoaderStateMixin):
    """The loader a prepared dataloader becomes: it places each batch on
    ``device`` as torch tensors, keeps ``prefetch_size`` placed batches
    ahead, and flags ``end_of_dataloader`` as the last batch is yielded, so
    the train step can force a gradient sync on it.  With ``rng_types`` the
    RNGs (``"generator"``: the seedable sampler's) are process 0's at the
    start of every epoch."""

    def __init__(self, base_dataloader, device=None, skip_batches: int = 0,
                 put_on_device: bool = True, prefetch_size: int = 2,
                 non_blocking: bool = False, rng_types=None, synchronized_generator=None):
        self.base_dataloader = base_dataloader
        self.device = device
        self.skip_batches = skip_batches
        self.put_on_device = put_on_device
        self.prefetch_size = max(1, prefetch_size)
        self.non_blocking = non_blocking
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
        self.gradient_state = GradientState()
        self.iteration = 0

    def __getattr__(self, name):
        if name == "base_dataloader":
            raise AttributeError(name)
        return getattr(self.base_dataloader, name)

    def __len__(self):
        return len(self.base_dataloader) - self.skip_batches

    @property
    def dataset(self):
        return getattr(self.base_dataloader, "dataset", None)

    @property
    def total_batch_size(self) -> int:
        """The global batch of one step: the sharded sampler's, or this
        loader's batch times the processes."""
        sampler = getattr(self.base_dataloader, "batch_sampler", None)
        if isinstance(sampler, BatchSamplerShard):
            if sampler.split_batches:
                return sampler.batch_size or 0
            return (sampler.batch_size or 0) * sampler.num_processes
        bs = getattr(self.base_dataloader, "batch_size", None) or 0
        return bs * process_topology()[0]

    @property
    def total_dataset_length(self):
        dataset = self.dataset
        return len(dataset) if dataset is not None and hasattr(dataset, "__len__") else None

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        if hasattr(self.base_dataloader, "set_epoch"):
            self.base_dataloader.set_epoch(epoch)

    def _place(self, batch):
        if not self.put_on_device:
            return batch
        return send_to_device(batch, self.device, non_blocking=self.non_blocking)

    def __iter__(self):
        if self.rng_types is not None:
            synchronize_rng_states(self.rng_types, self.synchronized_generator)
        self.begin()
        self.set_epoch(self.iteration)
        try:
            raw = itertools.islice(iter(self.base_dataloader), self.skip_batches, None)
            window: List[Any] = []
            exhausted = False
            while not exhausted and len(window) < self.prefetch_size:
                try:
                    window.append(self._place(next(raw)))
                except StopIteration:
                    exhausted = True
            while window:
                if exhausted and len(window) == 1:
                    self.end_of_dataloader = True
                current = window.pop(0)
                if not exhausted:
                    try:
                        window.append(self._place(next(raw)))
                    except StopIteration:
                        exhausted = True
                yield current
            self.iteration += 1
        finally:
            self.end()


class DataLoaderDispatcher(DataLoaderStateMixin):
    """Process 0 reads; every batch is broadcast and each process keeps its
    slice (``accelerate_tpu/data_loader.py:510-641``).  Without
    ``split_batches`` process 0 concatenates ``num_processes`` of its
    loader's batches into one global batch.  A ragged last batch is padded
    with its last row under ``even_batches`` (``gather_for_metrics`` drops
    the copies through ``remainder``).  ``num_processes``/
    ``process_index`` are the data shards' (the mesh's), by default the
    process group's."""

    def __init__(self, base_dataloader, split_batches: bool = False, skip_batches: int = 0,
                 put_on_device: bool = True, prefetch_size: int = 2, slice_fn=None,
                 even_batches: bool = True, device=None, num_processes: Optional[int] = None,
                 process_index: Optional[int] = None, non_blocking: bool = False):
        self.base_dataloader = base_dataloader
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.skip_batches = skip_batches
        self.state = PartialState()
        self.num_processes = num_processes or self.state.num_processes
        self.process_index = self.state.process_index if process_index is None \
            else process_index
        self.gradient_state = GradientState()
        self.placer = DevicePlacer(device, put_on_device=put_on_device,
                                   non_blocking=non_blocking)
        self.device = device
        self.put_on_device = put_on_device
        self.prefetch_size = prefetch_size
        self.slice_fn = slice_fn or slice_tensors
        self.iteration = 0

    def __getattr__(self, name):
        if name == "base_dataloader":
            raise AttributeError(name)
        return getattr(self.base_dataloader, name)

    @property
    def dataset(self):
        return getattr(self.base_dataloader, "dataset", None)

    @property
    def total_batch_size(self) -> int:
        bs = getattr(self.base_dataloader, "batch_size", None) or 0
        return bs if self.split_batches else bs * self.num_processes

    @property
    def total_dataset_length(self):
        dataset = self.dataset
        return len(dataset) if dataset is not None and hasattr(dataset, "__len__") else None

    def __len__(self):
        n = len(self.base_dataloader)
        return n if self.split_batches else math.ceil(n / self.num_processes)

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        if hasattr(self.base_dataloader, "set_epoch"):
            self.base_dataloader.set_epoch(epoch)

    def _fetch_and_broadcast(self, raw_iter):
        """Process 0 fetches a global batch; every process receives it
        (``None`` at the end)."""
        batch = None
        if self.state.is_main_process:
            if self.split_batches:
                batch = _batch_to_numpy(next(raw_iter, None))
            else:
                parts = [_batch_to_numpy(b) for b in itertools.islice(raw_iter,
                                                                     self.num_processes)]
                batch = concatenate(parts, dim=0) if parts else None
        if self.state.num_processes > 1:
            batch = _broadcast_batch(batch, self.state)
        return batch

    def _local_slice(self, batch):
        if self.num_processes == 1:
            return batch
        observed = find_batch_size(batch)
        if observed % self.num_processes != 0:
            if not self.even_batches:
                raise ValueError(
                    f"Dispatched global batch of {observed} does not divide "
                    f"{self.num_processes} processes and even_batches is off.")
            batch = pad_input_tensors(batch, observed, self.num_processes)
            observed = find_batch_size(batch)
        chunk = observed // self.num_processes
        lo = self.process_index * chunk
        return self.slice_fn(batch, slice(lo, lo + chunk))

    def __iter__(self):
        self.begin()
        self.set_epoch(self.iteration)
        raw_iter = iter(self.base_dataloader) if self.state.is_main_process else iter(())
        if self.skip_batches and self.state.is_main_process:
            skip = self.skip_batches * (1 if self.split_batches else self.num_processes)
            raw_iter = itertools.islice(raw_iter, skip, None)
        try:
            batch = self._fetch_and_broadcast(raw_iter)
            while batch is not None:
                next_batch = self._fetch_and_broadcast(raw_iter)
                if next_batch is None:
                    self.end_of_dataloader = True
                    observed = find_batch_size(batch)
                    self.remainder = (observed % self.total_batch_size
                                      if self.total_batch_size else -1)
                yield self.placer.place(self._local_slice(batch))
                batch = next_batch
            self.iteration += 1
        finally:
            self.end()


def _broadcast_batch(batch, state):
    """Process 0's numpy batch on every process: its structure and leaf
    shapes as one object, then each leaf as a tensor."""
    flat: List[Any] = []
    if state.is_main_process and batch is not None:
        recursively_apply(flat.append, batch)
    meta = [None if batch is None else
            (recursively_apply(lambda x: None, batch),
             [(tuple(x.shape), str(np.asarray(x).dtype)) for x in flat])]
    broadcast_object_list(meta, from_process=0)
    if meta[0] is None:
        return None
    skeleton, shapes = meta[0]
    if not state.is_main_process:
        flat = [np.zeros(shape, dtype=dtype) for shape, dtype in shapes]
    leaves = iter([broadcast(np.ascontiguousarray(x), from_process=0) for x in flat])
    return recursively_apply(lambda _: next(leaves), skeleton, test_type=lambda x: x is None)


def _is_torch_loader(obj) -> bool:
    import torch.utils.data as tud

    return isinstance(obj, tud.DataLoader)


def prepare_data_loader(dataloader, device=None, num_processes: Optional[int] = None,
                        process_index: Optional[int] = None, split_batches: bool = False,
                        put_on_device: bool = True, rng_types=None,
                        dispatch_batches: Optional[bool] = None, even_batches: bool = True,
                        slice_fn_for_dispatch=None, use_seedable_sampler: bool = False,
                        non_blocking: bool = False, prefetch_size: int = 2, mesh=None):
    """Wrap a dataloader (:class:`SimpleDataLoader`, a torch ``DataLoader``,
    or any iterable of batches) for the train step on ``device``
    (``accelerate_tpu/data_loader.py:726-810``).  Over several shards a
    map-style loader's batch sampler becomes a :class:`BatchSamplerShard`,
    an iterable dataset an :class:`IterableDatasetShard`;
    ``dispatch_batches=True`` makes a :class:`DataLoaderDispatcher`.  The
    shards are ``mesh``'s data shards when a mesh is given (this rank's
    :func:`~accelerate_tpu_torch.parallel.mesh.data_shard_index`), else the
    processes.  ``use_seedable_sampler`` synchronizes the seedable
    sampler's state across processes at each epoch's start."""
    if mesh is not None:
        from .parallel import mesh as mesh_lib

        num_processes = num_processes or mesh_lib.num_data_shards(mesh)
        process_index = (mesh_lib.data_shard_index(mesh) if process_index is None
                         else process_index)
    if num_processes is None or process_index is None:
        world, rank = process_topology()
        num_processes = world if num_processes is None else num_processes
        process_index = rank if process_index is None else process_index
    if dispatch_batches:
        return DataLoaderDispatcher(
            dataloader, split_batches=split_batches, put_on_device=put_on_device,
            prefetch_size=prefetch_size, slice_fn=slice_fn_for_dispatch,
            even_batches=even_batches, device=device, num_processes=num_processes,
            process_index=process_index, non_blocking=non_blocking)
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    new_loader = dataloader
    if num_processes > 1 and (_is_torch_loader(dataloader)
                              or isinstance(dataloader, SimpleDataLoader)):
        batch_sampler = getattr(dataloader, "batch_sampler", None)
        if batch_sampler is not None and not isinstance(batch_sampler, BatchSamplerShard):
            sharded = BatchSamplerShard(batch_sampler, num_processes=num_processes,
                                        process_index=process_index,
                                        split_batches=split_batches, even_batches=even_batches)
            new_loader = _rebuild_with_batch_sampler(dataloader, sharded)
        elif batch_sampler is None and getattr(dataloader, "dataset", None) is not None:
            batch_size = getattr(dataloader, "batch_size", 1) or 1
            sharded_ds = IterableDatasetShard(
                dataloader.dataset, batch_size=batch_size,
                drop_last=getattr(dataloader, "drop_last", False),
                num_processes=num_processes, process_index=process_index,
                split_batches=split_batches, even_batches=even_batches)
            new_loader = _rebuild_with_dataset(
                dataloader, sharded_ds,
                batch_size=batch_size // num_processes if split_batches else batch_size)
    synchronized_generator = None
    if use_seedable_sampler and isinstance(new_loader, SimpleDataLoader):
        node = new_loader.batch_sampler
        while node is not None and not isinstance(node, SeedableRandomSampler):
            node = getattr(node, "sampler", None) or getattr(node, "batch_sampler", None)
        synchronized_generator = node
    if synchronized_generator is not None and rng_types is None:
        rng_types = ["generator"]
    return DataLoaderShard(new_loader, device=device, put_on_device=put_on_device,
                           prefetch_size=prefetch_size, non_blocking=non_blocking,
                           rng_types=rng_types, synchronized_generator=synchronized_generator)


def _loader_kwargs(dataloader, skip) -> dict:
    kwargs = {}
    for k in _PYTORCH_DATALOADER_KWARGS:
        if k in skip or not hasattr(dataloader, k):
            continue
        v = getattr(dataloader, k)
        if k == "prefetch_factor" and v is None:
            continue
        kwargs[k] = v
    return kwargs


def _rebuild_with_dataset(dataloader, dataset, batch_size: int):
    import torch.utils.data as tud

    return tud.DataLoader(dataset, batch_size=batch_size, **_loader_kwargs(
        dataloader, ("batch_size", "shuffle", "sampler", "batch_sampler", "dataset")))


def _rebuild_with_batch_sampler(dataloader, batch_sampler):
    if isinstance(dataloader, SimpleDataLoader):
        return SimpleDataLoader(dataloader.dataset, collate_fn=dataloader.collate_fn,
                                batch_sampler=batch_sampler)
    import torch.utils.data as tud

    return tud.DataLoader(dataloader.dataset, batch_sampler=batch_sampler, **_loader_kwargs(
        dataloader, ("batch_size", "shuffle", "sampler", "batch_sampler", "drop_last")))


class SkipBatchSampler:
    """A batch sampler without its first ``skip_batches``."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    def __iter__(self):
        yield from itertools.islice(iter(self.batch_sampler), self.skip_batches, None)

    def set_epoch(self, epoch: int):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        return len(self.batch_sampler) - self.skip_batches


class SkipDataLoader:
    """An iterable without its first ``skip_batches``."""

    def __init__(self, dataloader, skip_batches: int = 0):
        self.dataloader = dataloader
        self.skip_batches = skip_batches

    def __getattr__(self, name):
        if name == "dataloader":
            raise AttributeError(name)
        return getattr(self.dataloader, name)

    def __iter__(self):
        yield from itertools.islice(iter(self.dataloader), self.skip_batches, None)

    def __len__(self):
        return len(self.dataloader) - self.skip_batches


def skip_first_batches(dataloader, num_batches: int = 0):
    """Mid-epoch resume: the same loader without its first ``num_batches``
    (this process's batches; a dispatcher skips the global ones they make)."""
    if isinstance(dataloader, DataLoaderDispatcher):
        return DataLoaderDispatcher(
            dataloader.base_dataloader, split_batches=dataloader.split_batches,
            skip_batches=num_batches, put_on_device=dataloader.put_on_device,
            prefetch_size=dataloader.prefetch_size, slice_fn=dataloader.slice_fn,
            even_batches=dataloader.even_batches, device=dataloader.device,
            num_processes=dataloader.num_processes, process_index=dataloader.process_index)
    if isinstance(dataloader, DataLoaderShard):
        return DataLoaderShard(dataloader.base_dataloader, device=dataloader.device,
                               skip_batches=num_batches,
                               put_on_device=dataloader.put_on_device,
                               prefetch_size=dataloader.prefetch_size,
                               non_blocking=dataloader.non_blocking,
                               rng_types=dataloader.rng_types,
                               synchronized_generator=dataloader.synchronized_generator)
    return DataLoaderShard(dataloader, put_on_device=False, skip_batches=num_batches)

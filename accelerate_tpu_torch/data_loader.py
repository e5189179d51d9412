"""Data pipeline of the training path, for one process.

Port of the single-process part of :mod:`accelerate_tpu.data_loader`:
:class:`SimpleDataLoader` and :func:`default_collate` (torch-free map-style
loading into numpy stacks), :class:`DataLoaderShard` (device placement, a
prefetch window, the one-batch lookahead that flags ``end_of_dataloader``,
``remainder``, registration with :class:`~accelerate_tpu_torch.state.GradientState`),
:func:`prepare_data_loader` and :func:`skip_first_batches`.  Sharding the
batches over several processes is ROADMAP Queue 1 item 9 (``parallel/``).
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, List, Optional

import numpy as np

from .state import GradientState
from .utils.operations import send_to_device


class SeedableRandomSampler:
    """Deterministic shuffling sampler, reseeded per epoch (``seed + epoch``)."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

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


class DataLoaderShard:
    """The loader a prepared dataloader becomes: it places each batch on
    ``device`` as torch tensors, keeps ``prefetch_size`` placed batches
    ahead, and flags ``end_of_dataloader`` as the last batch is yielded, so
    the train step can force a gradient sync on it."""

    end_of_dataloader: bool = False
    remainder: int = -1

    def __init__(self, base_dataloader, device=None, skip_batches: int = 0,
                 put_on_device: bool = True, prefetch_size: int = 2,
                 non_blocking: bool = False):
        self.base_dataloader = base_dataloader
        self.device = device
        self.skip_batches = skip_batches
        self.put_on_device = put_on_device
        self.prefetch_size = max(1, prefetch_size)
        self.non_blocking = non_blocking
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
        return getattr(self.base_dataloader, "batch_size", None) or 0

    @property
    def total_dataset_length(self):
        dataset = self.dataset
        return len(dataset) if dataset is not None and hasattr(dataset, "__len__") else None

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        if hasattr(self.base_dataloader, "set_epoch"):
            self.base_dataloader.set_epoch(epoch)

    def begin(self):
        self.end_of_dataloader = False
        self.remainder = -1
        length = self.total_dataset_length
        if length is not None and self.total_batch_size:
            self.remainder = length % self.total_batch_size
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    def _place(self, batch):
        if not self.put_on_device:
            return batch
        return send_to_device(batch, self.device, non_blocking=self.non_blocking)

    def __iter__(self):
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


def prepare_data_loader(dataloader, device=None, split_batches: bool = False,
                        put_on_device: bool = True, dispatch_batches: Optional[bool] = None,
                        even_batches: bool = True, use_seedable_sampler: bool = False,
                        non_blocking: bool = False, prefetch_size: int = 2) -> DataLoaderShard:
    """Wrap a dataloader (:class:`SimpleDataLoader`, a torch ``DataLoader``,
    or any iterable of batches) for the train step on ``device``.  With one
    process ``split_batches``, ``even_batches`` and ``use_seedable_sampler``
    change nothing; ``dispatch_batches=True`` is not ported."""
    if dispatch_batches:
        raise NotImplementedError("dispatch_batches=True is not ported: "
                                  "ROADMAP Queue 1 item 9 (parallel/)")
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    return DataLoaderShard(dataloader, device=device, put_on_device=put_on_device,
                           prefetch_size=prefetch_size, non_blocking=non_blocking)


def skip_first_batches(dataloader, num_batches: int = 0):
    """Mid-epoch resume: the same loader without its first ``num_batches``."""
    if isinstance(dataloader, DataLoaderShard):
        return DataLoaderShard(dataloader.base_dataloader, device=dataloader.device,
                               skip_batches=num_batches,
                               put_on_device=dataloader.put_on_device,
                               prefetch_size=dataloader.prefetch_size,
                               non_blocking=dataloader.non_blocking)
    return DataLoaderShard(dataloader, put_on_device=False, skip_batches=num_batches)

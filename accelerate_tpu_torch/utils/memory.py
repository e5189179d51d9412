"""Out-of-memory recovery: retry a function at a smaller batch size.

Port of :mod:`accelerate_tpu.utils.memory`.  The markers are CUDA's:
``torch.cuda.OutOfMemoryError`` (its text is ``"CUDA out of memory"``), a
cuBLAS workspace that could not be allocated, and the host's
``MemoryError``.  A bare ``"out of memory"`` in an unrelated error does not
count (a ``"BLOOM-560m"`` path is no OOM).  Between attempts
``torch.cuda.empty_cache()`` returns the failed attempt's cached blocks to
the card, where the reference clears XLA's compiled executables.
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable, Optional

import torch

_OOM_MARKERS = (
    "CUDA out of memory",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "CUDNN_STATUS_NOT_ENOUGH_WORKSPACE",
)


def release_memory(*objects):
    """Drop references, collect garbage and empty the card's cache
    (``accelerate_tpu/utils/memory.py:33``).  Returns a ``None`` for every
    input, so that callers rebind: ``a, b = release_memory(a, b)``.
    Aliases held elsewhere stay valid: memory is freed when its last
    reference dies."""
    objects = [None for _ in objects]
    clear_device_cache()
    return objects


def should_reduce_batch_size(exception: BaseException) -> bool:
    """Whether ``exception`` says the card's or the host's memory ran out
    (``:60``)."""
    if isinstance(exception, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = str(exception)
    return any(marker in text for marker in _OOM_MARKERS)


def clear_device_cache(garbage_collection: bool = True) -> None:
    """Collect garbage, then return the caching allocator's free blocks to
    the card (``:69``)."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def find_executable_batch_size(function: Optional[Callable] = None,
                               starting_batch_size: int = 128,
                               reduce_batch_size_fn: Optional[Callable[[int], int]] = None):
    """Decorator: call ``function(batch_size, ...)`` and, on an OOM, again
    with a smaller batch size (half, or ``reduce_batch_size_fn``) until it
    succeeds or the size reaches zero (``:86``).  The wrapped function takes
    ``batch_size`` first (after ``self`` for a method)."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size,
                                 reduce_batch_size_fn=reduce_batch_size_fn)

    reduce_fn = reduce_batch_size_fn or (lambda b: b // 2)
    params = list(inspect.signature(function).parameters.keys())
    is_method = bool(params) and params[0] == "self"
    if not params or (is_method and len(params) < 2):
        raise TypeError(f"Batch size was passed into `{function.__name__}` as the first "
                        "argument, but it did not accept one.")

    @functools.wraps(function)
    def decorator(*args, **kwargs):
        batch_size = starting_batch_size
        clear_device_cache(garbage_collection=False)
        while True:
            if batch_size <= 0:
                raise RuntimeError("No executable batch size found, reached zero. "
                                   "The model does not fit on this device even with batch "
                                   "size 1.")
            call_args = ((args[0], batch_size, *args[1:]) if is_method
                         else (batch_size, *args))
            try:
                return function(*call_args, **kwargs)
            except Exception as e:  # noqa: BLE001 - the reference's broad catch
                if not should_reduce_batch_size(e):
                    raise
            # past the handler the failed attempt's frames, which hold its
            # tensors, are released, so the cache can give their memory back
            clear_device_cache()
            batch_size = reduce_fn(batch_size)

    return decorator

"""Host-side n-gram draft proposal for speculative decoding.

Port of :mod:`accelerate_tpu.serving.spec` (host numpy, token-identical).
Prompt-lookup drafting: each lane's draft is the continuation of the most
recent earlier occurrence of its trailing n-gram in its own context (prompt
+ generated tokens).  No second model and no device work; the engine
verifies the K drafted tokens in one ``[slots, K+1]`` forward
(:func:`~accelerate_tpu_torch.serving.pool.verify_window`) and falls back to
the plain decode window when no lane drafts.

* :func:`propose_ngram_draft` — the O(context) rescan.
* :class:`NgramIndex` — the incremental per-lane index the engine drafts
  with: O(max_ngram) per committed token, O(k) per proposal, the same
  drafts as the rescan.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def propose_ngram_draft(context: np.ndarray, k: int, max_ngram: int = 3,
                        min_ngram: int = 1, pad: int = 0) -> Optional[np.ndarray]:
    """Draft ``k`` tokens by prompt-lookup: find the most recent earlier
    occurrence of the longest trailing n-gram of ``context`` and return the
    tokens that followed it.

    n-gram sizes are tried from ``max_ngram`` down to ``min_ngram``.  The
    match must end strictly before the context's tail and have at least one
    following token.  A match at lag ``L`` from the tail implies a local
    period ``L``, so the draft extends cyclically: ``draft[j] =
    context[start + (j % L)]``.  Returns the ``[k]`` int32 draft, or ``None``
    when no n-gram recurs.  ``pad`` is accepted for signature stability but
    never needed (the cyclic extension fills all ``k`` slots)."""
    context = np.ascontiguousarray(context, dtype=np.int32)
    n_ctx = int(context.size)
    if k <= 0 or min_ngram < 1 or n_ctx < min_ngram + 1:
        return None
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        tail = context[n_ctx - n:]
        # windows start at 0 .. n_ctx - n - 1 over context[:-1]: each ends
        # strictly before the tail and leaves a token to draft from
        windows = np.lib.stride_tricks.sliding_window_view(context[: n_ctx - 1], n)
        hits = np.nonzero((windows == tail).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n          # the most recent match wins
            lag = n_ctx - start                # the local period it implies
            return context[start + (np.arange(k) % lag)]
    return None


class NgramIndex:
    """Incremental per-lane suffix index: :func:`propose_ngram_draft` without
    the per-cycle rescan.

    For every n-gram size, a dict maps each window (a token tuple) to the
    latest start where it occurs, kept by :meth:`append` in O(max_ngram) per
    committed token.  :meth:`append` records the window that ends just
    before the new token, so the trailing n-gram itself stays out of the
    index until a later token makes it an earlier occurrence — the rescan's
    strict-before-the-tail rule.  Each start is recorded in increasing
    order, so a window's value is the largest start, the rescan's
    ``hits[-1]``: the drafts are the same."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1) -> None:
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self._ctx: list = []
        self._idx: Dict[int, Dict[Tuple[int, ...], int]] = {
            n: {} for n in range(min_ngram, max_ngram + 1)
        }

    def __len__(self) -> int:
        return len(self._ctx)

    def append(self, token: int) -> None:
        """Commit one token: index every window that ends at the old tail
        (the new token is its follower), then grow the context."""
        ctx, size = self._ctx, len(self._ctx)
        for n in range(self.min_ngram, min(self.max_ngram, size) + 1):
            self._idx[n][tuple(ctx[size - n:])] = size - n
        ctx.append(int(token))

    def extend(self, tokens) -> None:
        for t in np.asarray(tokens, dtype=np.int32).ravel():
            self.append(int(t))

    def propose(self, k: int) -> Optional[np.ndarray]:
        """O(k) draft: the longest trailing n-gram with an earlier start on
        record, extended cyclically as the rescan does."""
        ctx, n_ctx = self._ctx, len(self._ctx)
        if k <= 0 or n_ctx < self.min_ngram + 1:
            return None
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1, -1):
            s = self._idx[n].get(tuple(ctx[n_ctx - n:]))
            if s is not None:
                start = s + n
                lag = n_ctx - start
                return np.asarray([ctx[start + (j % lag)] for j in range(k)], dtype=np.int32)
        return None


__all__ = ["NgramIndex", "propose_ngram_draft"]

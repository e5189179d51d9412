"""Speculation's dispatch stage: drafters, the token-tree topology, the draft forward.

Port of :mod:`accelerate_tpu.serving.spec_exec` (``:49-334``).  Two drafters
feed the engine's verify cycles:

* :class:`NgramDrafter` — host prompt-lookup drafting over the per-lane
  incremental :class:`~accelerate_tpu_torch.serving.spec.NgramIndex`; it
  feeds the linear ``[slots, K+1]`` verify window
  (:func:`~accelerate_tpu_torch.serving.pool.verify_window`, K1's causal
  arm at S = K+1).
* :class:`TreeDrafter` — a draft model on the card (by default the served
  model's first layers, :func:`build_draft`) drafts a ``1 + width * depth``
  node token tree (:class:`TreeSpec`) per lane in one draft forward
  (:func:`make_draft_forward`); the tree verify window
  (:func:`~accelerate_tpu_torch.serving.pool.tree_verify_window`) scores
  every node in one forward under the ancestor mask, through K1's
  tree-mask arm.

The draft forward is stateless: every cycle it re-prefills each lane's
bounded context window
(:class:`~accelerate_tpu_torch.serving.paging.DraftContextWindow`) into a
scratch slab :class:`~accelerate_tpu_torch.models.transformer.KVCache` it
makes itself, attended by plain PyTorch (the reference leaves it to XLA).
It reads nothing but its two arguments, which the engine keeps as static
buffers ``ctx [N, C]`` / ``length [N]`` written in place each cycle, so it
is captured as a CUDA graph of its own, apart from the verify's (its time,
``draft_s``, stays measurable with events around its replay).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import KVCache, Transformer, TransformerConfig
from .spec import NgramIndex


class TreeSpec:
    """Static chains-topology token tree.

    ``width`` sibling branches at the branch point, each a greedy chain of
    ``depth`` draft tokens: ``nodes = 1 + width * depth``.  Node 0 is the
    lane's pending token (the root, depth 0); branch ``b``'s node at level
    ``s`` (1-based) is ``1 + b * depth + (s - 1)``.  Host numpy arrays:

    * ``parent [S]`` — parent node id (the root's parent is itself);
    * ``depth_arr [S]`` — node depth, the position offset from the frontier;
    * ``anc [S, S]`` — ancestor-or-self visibility, the verify's tree mask;
    * ``paths [W, D+1]`` — branch ``b``'s root-to-leaf node chain.
    """

    def __init__(self, width: int, depth: int) -> None:
        if width < 1 or depth < 1:
            raise ValueError(f"need width >= 1 and depth >= 1, got {width}x{depth}")
        self.width = width
        self.depth = depth
        self.nodes = 1 + width * depth
        s = self.nodes
        parent = np.zeros(s, dtype=np.int32)
        depth_arr = np.zeros(s, dtype=np.int32)
        paths = np.zeros((width, depth + 1), dtype=np.int32)
        for b in range(width):
            for lvl in range(1, depth + 1):
                i = 1 + b * depth + (lvl - 1)
                parent[i] = 0 if lvl == 1 else i - 1
                depth_arr[i] = lvl
                paths[b, lvl] = i
        anc = np.zeros((s, s), dtype=bool)
        for i in range(s):
            j = i
            anc[i, j] = True
            while j != 0:
                j = int(parent[j])
                anc[i, j] = True
        self.parent = parent
        self.depth_arr = depth_arr
        self.anc = anc
        self.paths = paths
        self._device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(paths, parent, depth_arr)`` as int64 tensors on ``device``, made
        once per device: a window captured in a CUDA graph copies nothing
        from the host."""
        device = torch.device(device)
        arrays = self._device.get(device)
        if arrays is None:
            arrays = self._device[device] = tuple(
                torch.from_numpy(a.astype(np.int64)).to(device)
                for a in (self.paths, self.parent, self.depth_arr))
        return arrays

    def __repr__(self) -> str:
        return f"TreeSpec(width={self.width}, depth={self.depth}, nodes={self.nodes})"


class NgramDrafter:
    """Host prompt-lookup drafting: one :class:`NgramIndex` per occupied
    slot, fed at propose time only the tokens the lane committed since the
    previous cycle (O(k) per cycle in steady state), the same drafts as
    :func:`~accelerate_tpu_torch.serving.spec.propose_ngram_draft`."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1) -> None:
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self._idx: Dict[int, NgramIndex] = {}

    def propose(self, slot: int, context, k: int) -> Optional[np.ndarray]:
        """Draft ``k`` tokens for ``slot`` whose visible tokens are ``context``
        (a growing sequence; the index appends the unseen tail)."""
        idx = self._idx.get(slot)
        if idx is None or len(idx) > len(context):
            # a new lane, or the slot was reused without retire: rebuild
            idx = self._idx[slot] = NgramIndex(self.max_ngram, self.min_ngram)
        idx.extend(context[len(idx):])
        return idx.propose(k)

    def retire(self, slot: int) -> None:
        self._idx.pop(slot, None)


class TreeDrafter:
    """Draft-model drafting: the tree, the draft's config and its forward.
    The engine hands it the context window's arrays and gets the ``[slots,
    tree.nodes]`` draft tokens on the card, which go straight into the tree
    verify window.  Stateless: the context lives on the host."""

    def __init__(self, tree: TreeSpec, draft_cfg: TransformerConfig, forward) -> None:
        self.tree = tree
        self.draft_cfg = draft_cfg
        self.forward = forward

    def propose_device(self, ctx: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """``(ctx [N, C], length [N]) -> tokens [N, tree.nodes]`` on the card."""
        return self.forward(ctx, length)


# ---------------------------------------------------------------- draft model
_LAYER_KEY = re.compile(r"layers\.(\d+)\.")


def _slice_layers(state_dict: Dict[str, torch.Tensor], num_layers: int
                  ) -> Dict[str, torch.Tensor]:
    """The first ``num_layers`` decoder layers of a state dict, plus every
    key outside the layers (embedding, final norm, head) — the same tensor
    objects, not copies."""
    out = {}
    for key, val in state_dict.items():
        m = _LAYER_KEY.match(key)
        if m is None or int(m.group(1)) < num_layers:
            out[key] = val
    return out


def default_draft_layers(num_layers: int) -> int:
    """Default truncation: a quarter of the served depth, at least one layer."""
    return max(1, num_layers // 4)


def build_draft(cfg: TransformerConfig, state_dict, draft_model, *, draft_ctx: int,
                depth: int, device=None) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """Resolve the engine's ``draft_model`` knob to ``(draft_cfg, state dict)``
    (``accelerate_tpu/serving/spec_exec.py:191-262``).

    * **int n** — self-speculation: the served model's first ``n`` layers
      with its embedding, final norm and head; the state dict holds the
      served model's own tensors (shared, not copied), so the draft computes
      the function of the reference's sliced copy.
    * **str** — a Hugging Face checkpoint directory, ``"dir"`` or
      ``"dir#n"`` (``n`` layers; default :func:`default_draft_layers` of its
      depth), streamed through :mod:`~accelerate_tpu_torch.models.hf_compat`
      with a key map built for the truncated config, so the deeper layers
      are never read into memory; the tensors are placed on ``device``.
    * **(cfg, state_dict)** — an explicit draft, taken as given.

    The draft's config is the served (or checkpoint's) one at ``n`` layers,
    with a ``max_seq_len`` wide enough for the context window plus the
    rollout."""
    if isinstance(draft_model, tuple):
        draft_cfg, draft_sd = draft_model
        return draft_cfg, dict(draft_sd)
    if isinstance(draft_model, bool) or not isinstance(draft_model, (int, str)):
        raise ValueError(f"draft_model must be int (layer count), str (checkpoint dir) or "
                         f"(cfg, state_dict), got {type(draft_model).__name__}")
    min_len = draft_ctx + depth + 1
    if isinstance(draft_model, int):
        n = draft_model
        if not 1 <= n <= cfg.num_layers:
            raise ValueError(f"draft_model={n} layers out of range 1..{cfg.num_layers}")
        draft_cfg = dataclasses.replace(cfg, num_layers=n,
                                        max_seq_len=max(cfg.max_seq_len, min_len))
        return draft_cfg, _slice_layers(state_dict, n)
    from ..models.hf_compat import native_key_map, place, stream_mapped_tensors

    path, _, suffix = draft_model.partition("#")
    base_cfg, _ = native_key_map(path)
    n = int(suffix) if suffix else default_draft_layers(base_cfg.num_layers)
    if not 1 <= n <= base_cfg.num_layers:
        raise ValueError(f"draft_model {draft_model!r}: {n} layers out of range "
                         f"1..{base_cfg.num_layers}")
    draft_cfg = dataclasses.replace(base_cfg, num_layers=n,
                                    max_seq_len=max(base_cfg.max_seq_len, min_len))
    _, mapping = native_key_map(path, draft_cfg)
    return draft_cfg, place(stream_mapped_tensors(path, mapping), device)


def draft_transformer(draft_cfg: TransformerConfig, state_dict, device) -> Transformer:
    """A :class:`Transformer` running on ``state_dict``'s tensors as they are
    (built on the meta device, then the tensors assigned: nothing copied)."""
    model = Transformer(draft_cfg, device="meta")
    model.load_state_dict(state_dict, assign=True)
    if model.device != torch.device(device):
        raise ValueError(f"draft weights lie on {model.device}, the engine runs on {device}")
    return model


def make_draft_forward(model: Transformer, tree: TreeSpec, ctx_len: int):
    """The draft forward: ``(ctx [N, C], length [N]) -> tokens [N,
    tree.nodes]`` int32, the whole draft tree of every lane
    (``accelerate_tpu/serving/spec_exec.py:265-334``).

    1. Context prefill: one forward over the right-padded window into a
       scratch slab cache; the causal mask keeps pad rows invisible.  The
       logits at ``length - 1`` give the top-``width`` branch candidates,
       and the cache index rewinds to ``length`` (the rollout overwrites
       pad rows).
    2. Chain rollout: the cache tiled ``width`` times along the lanes
       (lane-major, as the candidates flatten) and ``depth - 1`` greedy
       one-token steps extend every branch at once.

    Column 0 is the lane's pending token (``ctx[length - 1]``, the root),
    then the branches' chains, branch-major, as :class:`TreeSpec` numbers
    them.  ``ctx_len`` is the window width the engine feeds."""
    width, depth = tree.width, tree.depth
    cfg = model.config

    @torch.inference_mode()
    def draft_forward(ctx: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        n, c = ctx.shape
        if c != ctx_len:
            raise ValueError(f"draft context is {c} tokens wide, the forward takes {ctx_len}")
        dev = ctx.device
        length = torch.clamp(length.long(), min=1)
        lanes = torch.arange(n, device=dev)
        cache = KVCache.create(cfg, n, max_len=c + depth, device=dev)
        logits, cache = model(ctx, cache=cache)
        last = logits[lanes, length - 1]                                  # [N, V]
        cand = torch.topk(last, width, dim=-1).indices.to(torch.int32)    # [N, W]
        # lane-major copies (lane i's branches at rows i*W .. i*W+W-1), by
        # expand and reshape: nothing here may read a count back
        def tile(t, dim):
            shape = list(t.shape)
            t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], width, *shape[dim + 1:])
            return t.reshape(*shape[:dim], shape[dim] * width, *shape[dim + 1:])

        cache = KVCache(k=tile(cache.k, 1), v=tile(cache.v, 1),
                        index=tile(length.to(torch.int32), 0))
        toks = cand.reshape(n * width)
        chain = [toks]
        for _ in range(depth - 1):
            step_logits, cache = model(toks[:, None], cache=cache)
            toks = torch.argmax(step_logits[:, 0], dim=-1).to(torch.int32)
            chain.append(toks)
        tree_tokens = (torch.stack(chain)                 # [D, N*W]
                       .reshape(depth, n, width)
                       .permute(1, 2, 0)                  # [N, W, D] branch-major
                       .reshape(n, width * depth))
        root = ctx[lanes, length - 1].to(torch.int32)
        return torch.cat([root[:, None], tree_tokens], dim=1)

    return draft_forward


__all__ = ["NgramDrafter", "TreeDrafter", "TreeSpec", "build_draft", "default_draft_layers",
           "draft_transformer", "make_draft_forward"]

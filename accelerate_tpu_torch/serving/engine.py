"""Continuous-batching serving engine on the paged KV pool.

Port of :class:`accelerate_tpu.serving.engine.ServingEngine` with
``paged=True``, the synchronous loop (``async_depth=0``), no prefix cache,
no speculation and no mesh.  One engine step:

1. admission — open the FCFS head's prefill when a slot and its pages are
   free, then run prefill chunks (buckets from :func:`.pool.plan_chunks`)
   against the per-step prefill-token budget; each chunk's K/V is written
   straight into newly allocated lane pages by the prefill kernel (K2), and a
   request whose last chunk landed is installed into its lane;
2. one decode window — ``decode_window`` masked steps over every lane
   through the decode kernel (K1), then one readback of the tokens, which
   stream out to their requests.

Greedy outputs are token-identical to the JAX engine's; a request's sampled
tokens depend only on ``(rng_seed, request id)``.  Arguments naming parts of
the JAX engine this slice has not ported raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models.generation import GenerationConfig, lane_generator
from ..models.transformer import Transformer
from .errors import AdmissionError
from .paging import PagedKVPool
from .pool import LaneState, decode_window, plan_chunks, prefill_chunk
from .scheduler import Request, RequestState, Scheduler


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 item {item}")


class ServingEngine:
    """Serve many requests through one paged slot pool with in-flight admission.

    Parameters
    ----------
    model: the port's :class:`~accelerate_tpu_torch.models.transformer.Transformer`.
    params: a state dict loaded into ``model`` (``assign=True``: tensors on
        the engine's device are used as they are), or ``None`` to serve the
        model's own weights.
    num_slots: concurrent request lanes.
    max_len: per-lane KV capacity (default ``config.max_seq_len``).  A request
        needs ``prompt_len + max_new_tokens + decode_window <= max_len``.
    prefill_buckets: chunk sizes for chunked prefill (default ``(128, 512)``
        clipped to ``max_prompt_len``).
    max_prompt_len: longest admissible prompt (default ``max_len``).
    prefill_token_budget: prefill tokens charged per engine step (default:
        the largest bucket).
    decode_window: decode steps per engine step.
    slot_order: slot-id preference for admission (tests permute it).
    page_size: tokens per KV page; default ``gcd(prefill_buckets)``.
    num_pages: physical pages including the null page; default the
        no-preemption worst case ``num_slots * max_len / page_size + 1``.
    kv_dtype: ``None`` (model dtype) or ``"bf16"``.
    device: where the engine runs — the card unless ``device="cpu"``.

    ``paged=False``, ``async_depth=1``, ``prefix_cache_mb > 0``,
    ``speculate_k > 0``, ``draft_model``, quantized ``kv_dtype``, ``mesh`` and
    ``role != "both"`` raise ``NotImplementedError``.  Unlike the JAX engine,
    ``prefix_cache_mb`` defaults to 0 and ``async_depth`` to 0.
    """

    def __init__(
        self,
        model: Transformer,
        params=None,
        num_slots: int = 4,
        max_len: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        max_prompt_len: Optional[int] = None,
        prefill_token_budget: Optional[int] = None,
        decode_window: int = 4,
        pad_token_id: int = 0,
        rng_seed: int = 0,
        slot_order: Optional[Sequence[int]] = None,
        paged: bool = True,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        max_queue: Optional[int] = None,
        prefix_cache_mb: Optional[float] = 0.0,
        async_depth: int = 0,
        speculate_k: int = 0,
        draft_model=None,
        mesh=None,
        role: str = "both",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if not paged:
            raise _not_ported("paged=False (the contiguous slab pool)", "5")
        if async_depth != 0:
            raise _not_ported(f"async_depth={async_depth} (the pipelined loop)", "5")
        if prefix_cache_mb:
            raise _not_ported("prefix_cache_mb > 0 (the prefix KV cache)", "6")
        if speculate_k or draft_model is not None:
            raise _not_ported("speculative decoding (speculate_k / draft_model)", "7")
        if mesh is not None:
            raise _not_ported("mesh= (tensor-parallel serving)", "8")
        if role != "both":
            raise _not_ported(f"role={role!r} (disaggregated prefill/decode)", "8")
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, assign=True)
        if model.device != self.device:
            raise ValueError(f"model weights lie on {model.device}, engine runs on {self.device}")
        cfg = model.config
        self.model = model
        self.num_slots = int(num_slots)
        self.max_len = int(max_len if max_len is not None else cfg.max_seq_len)
        self.max_prompt_len = int(max_prompt_len if max_prompt_len is not None else self.max_len)
        if self.max_prompt_len > self.max_len:
            raise ValueError(f"max_prompt_len {self.max_prompt_len} > slot capacity {self.max_len}")
        if prefill_buckets is None:
            prefill_buckets = [b for b in (128, 512) if b <= self.max_prompt_len]
            if not prefill_buckets:
                prefill_buckets = [self.max_prompt_len]
        self.buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        if self.buckets[-1] > self.max_prompt_len:
            raise ValueError(f"largest prefill bucket {self.buckets[-1]} exceeds "
                             f"max_prompt_len {self.max_prompt_len}")
        self.window = int(decode_window)
        self.pad_token_id = int(pad_token_id)
        self.rng_seed = int(rng_seed)
        if slot_order is None:
            slot_order = range(self.num_slots)
        self.slot_order = tuple(int(s) for s in slot_order)
        if sorted(self.slot_order) != list(range(self.num_slots)):
            raise ValueError(f"slot_order must permute range({self.num_slots}), "
                             f"got {self.slot_order}")
        self.page_size = int(page_size if page_size is not None else math.gcd(*self.buckets))
        if any(b % self.page_size for b in self.buckets):
            raise ValueError(f"page_size {self.page_size} must divide every prefill "
                             f"bucket, got {self.buckets}")
        self.num_pages = int(num_pages if num_pages is not None
                             else self.num_slots * (self.max_len // self.page_size) + 1)
        self.kv = PagedKVPool(cfg, self.num_slots, self.max_len, self.page_size,
                              self.num_pages, kv_dtype=kv_dtype, device=self.device)
        self.scheduler = Scheduler(
            self.buckets,
            prefill_token_budget if prefill_token_budget is not None else self.buckets[-1],
            max_queue=max_queue,
        )

        n = self.num_slots
        # host mirrors of the lane state; ``lanes`` holds the device copy
        self._slot_req: List[Optional[Request]] = [None] * n
        self._active = np.zeros(n, bool)
        self._eos = np.full(n, -1, np.int32)
        # each lane's KV write index: install sets it to prompt_len - 1, decode
        # advances it by the window — exact integer arithmetic on the host
        self._lane_len = np.zeros(n, np.int32)
        self._reserved_slots: set = set()
        self.lanes = LaneState.create(n, self.device)
        self._next_rid = 0
        #: plain counters; ``prefill_s`` / ``decode_s`` are host wall seconds
        #: of each phase, ending in a device synchronisation
        self.stats = {
            "requests_submitted": 0,
            "requests_completed": 0,
            "tokens_generated": 0,
            "prefill_chunks": 0,
            "prefill_tokens": 0,
            "decode_steps": 0,
            "preemptions": 0,
            "prefill_s": 0.0,
            "decode_s": 0.0,
        }

    # ---------------------------------------------------------------- submit
    def submit(self, prompt, config: Optional[GenerationConfig] = None,
               on_token: Optional[Callable[[Request, int], None]] = None,
               **overrides) -> Request:
        """Queue one request; returns its :class:`Request` handle (filled in
        as the engine runs).  ``overrides`` patch the ``GenerationConfig``."""
        gen = config or GenerationConfig()
        if overrides:
            gen = dataclasses.replace(gen, **overrides)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        depth = self.scheduler.queue_depth
        if prompt.size > self.max_prompt_len:
            raise AdmissionError(
                f"prompt length {prompt.size} > max_prompt_len {self.max_prompt_len}",
                queue_depth=depth, retriable=False)
        need = prompt.size + gen.max_new_tokens + self.window
        if need > self.max_len:
            raise AdmissionError(
                f"prompt {prompt.size} + max_new_tokens {gen.max_new_tokens} + "
                f"decode_window {self.window} = {need} exceeds slot capacity {self.max_len}",
                queue_depth=depth, retriable=False)
        padded = sum(b for b, _ in plan_chunks(prompt.size, self.buckets))
        if padded > self.max_len:
            raise AdmissionError(
                f"prompt {prompt.size} pads to {padded} prefill tokens under buckets "
                f"{self.buckets}, exceeding capacity {self.max_len}",
                queue_depth=depth, retriable=False)
        req = Request(rid=self._next_rid, prompt=prompt, config=gen, on_token=on_token)
        self._next_rid += 1
        self.scheduler.submit(req)
        self.stats["requests_submitted"] += 1
        return req

    # ------------------------------------------------------------- admission
    def _next_free_slot(self) -> Optional[int]:
        for s in self.slot_order:
            if not self._active[s] and self._slot_req[s] is None \
                    and s not in self._reserved_slots:
                return s
        return None

    def _reclaim_pages(self, need: int, allow_preempt: bool) -> bool:
        """Free pages until ``need`` are available, preempting the youngest
        running lane when allowed.  False when nothing is left to reclaim."""
        while self.kv.allocator.free_count < need:
            if allow_preempt and self._preempt():
                continue
            return False
        return True

    def _admission_pages_ok(self, req: Request) -> bool:
        """Can the queue head's whole prefill be paged in, without preempting
        a running lane (evicting one to admit behind it would invert FCFS)?"""
        need = sum(b for b, _ in req.chunks) // self.page_size
        return self._reclaim_pages(need, allow_preempt=False)

    def _ensure_prefill_pages(self, req: Request) -> bool:
        """Pages for ``req``'s next chunk (the scheduler's ``ready`` gate)."""
        bucket, _ = req.chunks[req.next_chunk]
        return self._reclaim_pages(bucket // self.page_size, allow_preempt=False)

    def _prefill_chunk(self, req: Request, bucket: int, chunk: np.ndarray,
                       start: int) -> None:
        """Prefill one chunk straight into newly allocated lane pages."""
        s = req.slot
        ids = self.kv.allocator.alloc(bucket // self.page_size)
        if ids is None:  # _ensure_prefill_pages ran first; this cannot happen
            raise RuntimeError("KV page pool exhausted mid-prefill")
        self.kv.lane_append_owned(s, ids)
        kv = self.kv
        tokens = torch.from_numpy(chunk[None]).to(self.device)
        table = torch.from_numpy(kv.tables[s].copy()).to(self.device)
        prefill_chunk(self.model, tokens, kv.pages_k, kv.pages_v, kv.k_scales,
                      kv.v_scales, table, start)

    def _admit(self) -> None:
        budget = self.scheduler.begin_step()
        t0 = time.perf_counter()
        ran = False
        while True:
            sched = self.scheduler
            if sched.queue and sched.prefilling is None:
                slot = self._next_free_slot()
                if slot is not None and self._admission_pages_ok(sched.queue[0]):
                    sched.start_next(slot)
                    self._reserved_slots.add(slot)
            if sched.prefilling is None:
                break
            took = sched.take_chunk(budget, ready=self._ensure_prefill_pages)
            if took is None:
                break  # budget spent or page pressure: retry next step
            req, bucket, valid, start = took
            chunk = np.zeros(bucket, np.int32)
            chunk[:valid] = req.prefill_tokens[start:start + valid]
            self._prefill_chunk(req, bucket, chunk, start)
            ran = True
            budget -= bucket
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += valid
            done = sched.finish_prefill()
            if done is not None:
                self._install(done)
        if ran:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats["prefill_s"] += time.perf_counter() - t0

    def _install(self, req: Request) -> None:
        """Hand a fully prefilled request its lane: its pages already hold the
        prompt's KV; the last prompt token stays pending so the first decode
        step computes the first generated token."""
        s = req.slot
        ptoks = req.prefill_tokens
        self._lane_len[s] = len(ptoks) - 1
        gen = req.config
        eos = -1 if gen.eos_token_id is None else int(gen.eos_token_id)
        sampled = gen.do_sample and gen.temperature > 0.0
        self.lanes.install(
            s, int(ptoks[-1]), eos, float(gen.temperature),
            0 if gen.top_k is None else int(gen.top_k),
            1.0 if gen.top_p is None else float(gen.top_p),
            lane_generator(self.rng_seed, req.rid, self.device) if sampled else None,
        )
        self._active[s] = True
        self._eos[s] = eos
        self._slot_req[s] = req
        self._reserved_slots.discard(s)
        req.state = RequestState.RUNNING

    # ---------------------------------------------------------------- decode
    def _retire_lane(self, slot: int) -> int:
        """Tear down one running lane (finish / preempt); returns pages freed."""
        freed = self.kv.lane_release(slot)
        self.lanes.retire(slot)
        self._active[slot] = False
        self._slot_req[slot] = None
        self._lane_len[slot] = 0
        return freed

    def _preempt(self) -> bool:
        """Preempt the youngest running lane: release its pages and requeue it
        at the FRONT for replay over prompt + generated tokens (greedy replay
        is token-exact; a sampled lane resumes on a re-seeded stream)."""
        victims = sorted((s for s in np.nonzero(self._active)[0]),
                         key=lambda s: self._slot_req[s].rid, reverse=True)
        for s in victims:
            req = self._slot_req[s]
            eff = len(req.prefill_tokens)
            padded = sum(b for b, _ in plan_chunks(eff, self.buckets))
            if eff > self.max_prompt_len or padded > self.max_len:
                continue  # grew past replayability
            self._retire_lane(s)
            self.scheduler.requeue(req)
            self.stats["preemptions"] += 1
            return True
        return False

    def _ensure_decode_capacity(self, width: int) -> None:
        """Map pages for every active lane's next ``width`` KV writes."""
        page = self.page_size
        for s in np.nonzero(self._active)[0]:
            need = (int(self._lane_len[s]) + width - 1) // page + 1
            while self._active[s]:
                missing = need - int(self.kv.lane_npages[s])
                if missing <= 0:
                    break
                ids = self.kv.allocator.alloc(missing)
                if ids is not None:
                    self.kv.lane_append_owned(s, ids)
                    break
                if not self._reclaim_pages(missing, allow_preempt=True):
                    raise RuntimeError("KV page pool exhausted: no lane left to "
                                       "reclaim for a decoding lane")

    def _decode(self) -> None:
        if not self._active.any():
            return
        self._ensure_decode_capacity(self.window)
        if not self._active.any():
            return
        t0 = time.perf_counter()
        kv = self.kv
        tables = torch.from_numpy(kv.tables.copy()).to(self.device)
        index = torch.from_numpy(self._lane_len.copy()).to(self.device)
        toks = decode_window(self.model, self.window, kv.pages_k, kv.pages_v,
                             kv.k_scales, kv.v_scales, tables, index, self.lanes,
                             self.pad_token_id)
        toks = toks.cpu().numpy()  # the one readback per window
        self.stats["decode_s"] += time.perf_counter() - t0
        self._lane_len[self._active] += self.window
        self.stats["decode_steps"] += self.window
        self._emit(toks)

    def _emit(self, toks: np.ndarray) -> None:
        """Land a window's tokens on their requests: cut at each lane's EOS
        and at the request's length cap; finished lanes free their slot."""
        width = toks.shape[1]
        mask = self._active.copy()
        eos = self._eos
        is_eos = mask[:, None] & (toks == eos[:, None]) & (eos >= 0)[:, None]
        has_eos = is_eos.any(axis=1)
        first_eos = np.where(has_eos, is_eos.argmax(axis=1), width)
        n_take = np.where(mask, np.minimum(width, first_eos + 1), 0)
        for s in np.nonzero(n_take > 0)[0]:
            req = self._slot_req[s]
            n = min(int(n_take[s]), req.config.max_new_tokens - len(req.tokens))
            for t in toks[s, :n]:
                req.emit(int(t))
            self.stats["tokens_generated"] += n
            hit_eos = bool(has_eos[s]) and n == int(n_take[s])
            if hit_eos or len(req.tokens) >= req.config.max_new_tokens:
                self._retire_lane(s)
                req.state = RequestState.DONE
                self.stats["requests_completed"] += 1

    # ----------------------------------------------------------------- drive
    def step(self) -> None:
        """One engine iteration: budgeted chunked-prefill admission, then one
        masked decode window over the pool."""
        self._admit()
        self._decode()

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_queued or bool(self._active.any())

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive :meth:`step` until every submitted request completes."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def serve(self, prompts: Sequence, configs=None,
              on_token: Optional[Callable[[Request, int], None]] = None) -> List[Request]:
        """Submit every prompt (``configs`` is one shared or a per-request list
        of ``GenerationConfig``), run to completion, return the requests in
        submission order."""
        reqs = []
        for i, p in enumerate(prompts):
            cfg = configs[i] if isinstance(configs, (list, tuple)) else configs
            reqs.append(self.submit(p, config=cfg, on_token=on_token))
        self.run()
        return reqs

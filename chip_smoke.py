#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card.

    python3 chip_smoke.py            # every phase, from the root of the repo

Phases, each printing one JSON line:

1. ``device``  — the card, torch/CUDA versions, and the kernels' build.
2. ``k1``      — the paged decode kernel against its plain version at the
   serving path's shapes (Llama-2-7B widths) and at a GQA shape, bf16 and f32
   pages: max abs error against the stated tolerance, kernel/plain/bound ms.
   A kernel's ``ms`` is its device time per launch under ``torch.profiler``
   (``wall_ms``, CUDA events around the wrapper's calls, also counts the
   host, which a short kernel does not hide); plain ms are event times.
   Then the shapes that cut its split walk raggedly: a lane of length 0
   beside a 2040-token lane, lengths at and one past page edges, page 16
   (128 pages, many splits), a 3-token verify span at GQA rep 4 (rows of a
   split wholly masked), D 64, and f32.  Then the dequant arm: int8 and
   fp8-e4m3 pages (``pages``) written by the port's own
   ``paged_quantized_insert`` on the card, dead slots poisoned (NaN fp8
   codes, NaN int8 scales), at "main" and at the engine's lanes
   (57/384/700/1000), bf16 q and one f32-q case per format; folded rows
   past the 32 that K1 once took (GQA 8 verifying 5: 40 rows; rep 2 at
   S 17: 34), in row blocks;
   D 16 and 32, native and quantized.  Then the tree-mask arm (tree
   verification) against the plain version with the same ``tree_mask``: the
   9-node tree of ``TreeSpec(2, 4)`` at "main"'s heads over lanes of
   5/700/1500/2000 keys (2040 + S would overrun the table), bf16 and f32,
   beside the causal arm at S 9 and S 5; at the engine's lanes; the 10-node
   ``TreeSpec(3, 3)`` at GQA 32/8 (40 folded rows); the 32-node
   ``TreeSpec(31, 1)`` (word bit 31); a random 20-node tree (the words are
   data); a tree across a page edge (lengths 127/128); int8 and fp8 pages.
   Each record names the ``design`` and the ``arm``,
   its pages per split and row blocks; each is also held per (lane, query,
   head) row, ``||err|| / ||plain||`` against the plain version computed
   in f32 from the same values (codes and scales; ``ROW_REL_TOL``), run
   twice for the same bits, and must leave the arrival counters at zero.
3. ``k2``      — the paged prefill kernel the same, for a 512-token chunk at
   base 0 and a 128-token chunk at base 640 (page 128, the engine's), a
   512-token chunk at page 64 and a 128-token chunk at base 600 at page 16
   (its last tiles straddle the causal frontier and NaN-filled dead pages);
   then int8 and fp8 pages as for K1 (bf16 q on the tensor cores, the codes
   converted to bf16 tiles; f32 q on the CUDA cores), D 16 and 32, and a
   GQA group of 128 query heads per kv head (two q-blocks of 64 heads over
   the same kv head's pages).
   Each record names its ``design`` (``wgmma`` for bf16 q over bf16, int8
   or fp8 pages at D 64/128, ``cuda-cores`` otherwise); every case must
   repeat bit for bit, and the bf16 records are also held per tile of 64
   positions of one head against the plain version computed in f32.
4. ``model``   — the full-width, full-depth Llama-2-7B geometry (random
   weights from a seed): a 512-token prompt prefilled as one paged chunk,
   then 8 decode steps through ``PagedKVCache``, each step's logits held
   against the no-cache causal forward (plain attention, no kernel).
   ``model_int8``, ``model_fp8``: the same into a pool of quantized pages,
   each call held against the same call over a bf16 pool holding the
   quantized pool's dequantized values (through the native arms), within
   the model line's tolerance; the distance to the no-cache forward is
   printed, not gated.
5. ``engine``  — ``ServingEngine(paged=True)`` serves 6 greedy requests as a
   user runs it: every decode, verify and draft window a CUDA graph
   captured at construction and replayed each cycle, the depth-1 pipelined
   loop (``async_depth=1``); the kernel launch counters are zeroed just
   before and read just after (graph replays credit the launches their
   capture counted), the number of graphs must not grow during the serve;
   every output is teacher-forced through the no-cache forward.  Each
   engine line prints ``graph_captures``, ``graph_replays``,
   ``host_overlap_ratio``, ``device_idle_s``, ``prefreed_lanes``,
   ``serve_tokens_per_s`` (tokens over the serve's wall) beside
   ``decode_tokens_per_s`` (tokens over the engine's ``decode_s``: wall
   while a window was in flight) and ``decode_ms_per_step``.
   Each prefill bucket's chunk is a graph too: the engine must hold one per
   bucket, and K2 must launch once a layer per chunk, credited by replays.
   ``engine_sync_eager``: the same requests through the A/B hook
   ``ServingEngine._eager(..., async_depth=0)`` (eager windows and chunks,
   synchronous loop): the same kernels on the same inputs, so its greedy
   tokens must be identical to ``engine``'s.  ``engine_interleave``: the
   same requests with ``interleave_prefill=True`` (each window dispatched
   first, the cycle's chunks queued behind it): identical tokens, and some
   chunk must ride behind a window.  ``engine_cancel``: the same requests,
   the second cancelled once it has 8 tokens and its lane is live in the
   window in flight: no token of it streams after the cancel, its pages
   wait for that window, the others' tokens equal ``engine``'s, and every
   page is free after ``flush_prefix_cache()``.  ``chunk_graphs``: for
   bf16, int8 and fp8 pages, each bucket's graph replay bitwise the eager
   chunk on the same pool state at bases 0, 512 and 640 (32 K2 launches
   credited a replay), ms per chunk replayed and eager beside the chunk's
   bound, and the memory the chunk graphs hold.  ``engine_int8``,
   ``engine_fp8``: the same requests with ``kv_dtype="int8"`` / ``"fp8"``
   (K1's and K2's dequant arms), their own launch counts, the pool's bytes
   per token and GB, and ``kv_quant_error`` held under the format's bound
   (``QUANT_ERR_BOUND`` times the largest page scale any insert left).  The
   largest scale comes from a second, untimed serve of the same requests by
   a new engine whose inserts are watched; that serve must give the same
   tokens and the same ``kv_quant_error``, so the timed serve runs the path
   a user runs and the bound holds for it.  ``engine_tree``: the engine
   line's requests with ``draft_model=8, tree_width=2, tree_depth=4,
   draft_ctx=64`` (an 8-layer draft of the served model drafts a 9-node
   tree a lane, one tree verify forward a cycle through K1's tree-mask
   arm); ``engine_spec``: ``speculate_k=4`` (n-gram drafts, one linear
   verify forward over 5 positions through K1's causal arm) on prompts of a
   random 40-token segment tiled to the same six lengths.  Both hold every
   token to the noise margin, count K1's launches exactly (one a layer per
   decode-window step and per verify forward, the tree arm's apart; the
   draft forward launches none) and print the drafted and accepted tokens,
   tokens per verify forward and the draft's share of decode time.  These
   engine lines run without the prefix cache (``prefix_cache_mb=0``), as
   the workload's prompts share nothing.
   ``engine_prefix``: the same engine with the prefix cache
   (``prefix_cache_mb=1024``) serves 8 greedy requests of one shared
   1024-token prefix (two full 512-token chunks) and distinct tails of
   57-900 tokens; ``engine_prefix_tiers`` and ``engine_prefix_tiers_int8``
   serve 9 requests of three 1024-token prefixes cycled A B C x 3 and tails
   of 57-500 tokens under device, host and disk budgets of one, one and two
   prefix chains, so chains spill to the host ring, then to the disk ring,
   and are promoted back.  Each serves again with ``prefix_cache_mb=0``: the
   greedy tokens must be identical, K2 must launch once a layer per
   prefilled chunk and less than without the cache, no graph may be
   captured during a serve, no promotion may degrade, and every page must
   be free after ``flush_prefix_cache()``; ``engine_prefix`` must hit at
   least 4 x 1024 tokens, the tier lines must spill, write to disk and hit
   the host tier.  Each line prints hit and miss tokens, prefill chunks,
   ``prefill_s`` and serve tokens/s with and without the cache,
   copy-on-write copies, reclaim-ladder evictions, spills and promotions
   with their GB/s (CUDA events around each transfer), the disk ring's
   host seconds and the pinned host bytes in use.
   The slab pool (``paged=False``, the reference's default; plain PyTorch
   attention over ``[L, 4, 2048, Hkv, D]`` slabs and a batch-1 scratch of
   2048, no kernel): ``engine_slab`` serves the engine line's requests (one
   graph per window and per bucket, the count constant over the serve, K1
   and K2 launched 0 times, every token within the noise margin; the pool's
   and the scratch's GB), ``engine_slab_sync_eager`` the same through
   ``_eager(..., async_depth=0)`` (tokens bit-identical to
   ``engine_slab``'s), ``engine_slab_tree`` and ``engine_slab_spec`` with
   the knobs and prompts of ``engine_tree`` and ``engine_spec``, and
   ``engine_slab_prefix`` ``engine_prefix``'s requests at
   ``prefix_cache_mb=1024`` against its cache-off serve (identical tokens,
   at least 4 x 1024 hit tokens, fewer chunks).  Every engine line prints
   the device memory its construction took (``engine_memory``: the pool,
   and the graphs' private pools).  ``slab_attention``: one layer's plain
   slab attention at the decode shape against K1 on the same keys in pages
   and the bytes bounds of the whole slab and of the live keys.
   The other families (the Llama model freed first; one 7B model on the card at
   a time): ``neox_config`` (Pythia-6.9B's published ``config.json`` values,
   ``PYTHIA_6_9B``, through the port's ``hf_compat.config_from_hf_dict``: GPT-NeoX
   with LayerNorm and biases, rotary over 32 of 128 dims, exact gelu, parallel
   residual with two norms, an untied 50432-row head), ``model_neox`` (the
   ``model`` line's check at 32 layers, random bf16 weights from seed 0),
   ``engine_neox`` (the ``engine`` line's engine and six requests: K1 32
   launches a decode step, K2 32 a chunk, every token within the noise margin,
   decode ms a step, serve tokens/s and the peak memory) and
   ``engine_neox_sync_eager`` (tokens identical to ``engine_neox``'s);
   ``model_gpt2`` and ``engine_gpt2``: ``TransformerConfig.gpt2()`` at full
   width and depth (learned positions, tied head, tanh gelu, 12 heads of D 64)
   at ``max_len=1024`` with prompts of ``GPT2_LENS``; ``families``: each
   mapped family's switch set (``FAMILY_SWITCHES``) at hidden 2048 and 2
   layers, a 512-token prefill chunk and 8 decode steps through K2 and K1 held
   against the same forward through their plain versions, and for the
   sliding-window and alibi families (which the kernels refuse, as the
   reference's do) the plain paged forward, launching neither kernel, held
   against the no-cache forward.  K1 and K2 also take the families' shapes:
   GPT-2's 12 heads of D 64 and Falcon-7B's 71 query heads over one kv head.
6. ``k3``, ``k4``, ``k5`` — the flash-attention forward, dQ and dK/dV kernels
   against their plain versions: the training shape (B 2, S 2048, 32 heads,
   D 128, causal) in bf16 and f32, GQA 32/8, three packed segments per row
   at S 1024, non-causal at S 512, and GQA 32/8 at D 64; K4 and K5 run twice
   and must give the same bits.  Each line: max abs error beside its
   tolerance, the largest relative error of a tile of 64 positions of one
   head beside its own tolerance, kernel, plain, bound and library
   (``scaled_dot_product_attention``, device time of all its kernels per
   call) ms, the case's launches, and the kernel's ``design`` (``wgmma`` for
   the bf16 arms, ``cuda-cores`` for the f32 arms).  The device line names
   every kernel whose build spills registers; a tensor-core kernel that
   spills fails the run.
7. ``train``   — the serving model freed, ``TransformerConfig.llama2_7b`` at
   full width and 8 of its 32 layers (f32 masters, bf16 compute, the flash
   path) trains through ``Accelerator(mixed_precision="bf16",
   gradient_accumulation_steps=2)``: AdamW with the Llama-2 recipe, 8
   micro-steps of 2 x 2048 tokens = 4 optimizer steps, the flash launch
   counters zeroed just before and read just after; ``step_ms`` is a
   micro-step's share of an optimizer step (accumulate + apply), the median
   over the optimizer steps after the first, beside the plain mean
   ``step_ms_mean``.  Before that, one micro-step of one sequence is held
   against the ``attention_impl="xla"`` path, with an f32 run of the same
   weights as the yardstick of bf16 noise.
   ``train_api``: the reference's loop shape on ``train``'s model (a fresh
   one from the same seed), batches and recipe: 8 micro-steps of
   ``compute_gradients`` + ``apply_gradients(max_grad_norm=1.0)`` inside
   ``accumulate()``; each call's loss and grad norm (the window's running
   average, as ``train`` reports it) held against ``train``'s within
   ``TRAIN_API_REL_TOL``, K3-K5 counted (8 a call), ``step_ms`` (the two
   calls, not the norm read between them) and the peak memory beside
   ``train``'s (the returned f32 gradients are one more copy of the
   masters).
   ``checkpoint``: full width at 2 of 32 layers (2.7 GB of f32 masters,
   5.3 GB of AdamW moments, 2.7 GB of ``.grad`` mid-window): an
   uninterrupted run of 6 reference-loop calls at accumulation 2, twice
   (the card must repeat itself bit for bit); 3 calls, ``save_state``
   mid-window, a fresh accelerator and a state from another seed,
   ``load_state``, 3 more: losses, grad norms and final params bitwise the
   uninterrupted run's, AdamW's moments on the card; then
   ``save_model(save_dtype=torch.bfloat16, max_shard_size="1GB")`` read back
   by ``load_model_params``, bitwise the masters cast to bf16.  Bytes,
   seconds and GB/s of the save, load, export and import; the free space
   of the temp dir is checked first and the directory removed after.
8. the ``run`` line (the run's total seconds, the build included), the
   ``kernels`` line (each kernel, K1's tree-mask arm with the launches
   of ``engine_tree``, and K1's and K2's dequant arms with the launches of
   their engine runs; K1 and K2 also with ``engine_prefix``'s,
   ``engine_neox``'s and ``engine_gpt2``'s launches,
   K3-K5 also with ``train_api``'s),
   the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero before the last
line.  It needs a CUDA card and the repository beside it; there is no CPU
fallback.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from accelerate_tpu_torch.profile_engine import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    chunk_bound_ms,
    chunk_times,
    device_ms,
    graph_ms,
    paged_bound_ms,
    time_ms,
)

TOL = {  # kernel vs plain version, per page dtype
    "k1": {torch.float32: 1e-4, torch.bfloat16: 2e-2},
    "k2": {torch.float32: 1e-4, torch.bfloat16: 3e-2},
}
# flash kernels vs plain versions, relative to the largest plain value: f32
# sums in another order (measured ~1e-7 relative); in bf16 both versions
# round their output once, after sums in different orders (and p relative to
# another running max in K3), so two bf16 steps at the top of the range
FLASH_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}
# ... and, so that an error confined to one tile cannot hide under the
# largest value (out's first row, dk/dv's first keys), each tile of 64
# positions of one head is held at its own scale: ||err|| / ||plain|| over
# the tile, against 2.5-3x the largest reading of sound kernels on an H100
# over these cases and tests/test_torch_cuda.py's (bf16 0.0031, f32 1.7e-6;
# PERF.md §2 keeps the readings)
FLASH_TILE_TOL = {torch.float32: 5e-6, torch.bfloat16: 2.0**-7}
# K1 against its plain version per (lane, query, head) row: ||err|| / ||plain||
# over the row's D values, the plain version computed in f32 from the same
# inputs.  The kernel keeps f32 sums and rounds its output once (bf16: near
# 2^-9), so 2^-7 catches a wrong merge weight on a long lane, where an
# absolute 2e-2 is over half of a typical output value (about sqrt(e / L)
# for L random keys); f32 sums in another order read ~1e-7
ROW_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
# train phase: the flash path's loss and gradient against the xla path's,
# as a multiple of the xla bf16 path's own distance from an f32 run of the
# same weights (two independent bf16 paths sit ~sqrt(2) x that apart); the
# loss tolerance has a floor of 5e-3 (a mean of 2047 cross entropies of
# bf16 logits, whose step is 2**-8 relative), lest a noise reading that
# happens to fall near zero make the check a coin toss
TRAIN_TOL_FACTOR = 2.0
TRAIN_LOSS_TOL_FLOOR = 5e-3
# train_api against train, call by call, relative: the two run the same
# kernels on the same inputs, and differ only in where the buffer's sums
# happen (autograd's accumulation into .grad against an add of fresh
# gradients; halving before the norm against after it: exact), so f32 sums
# in another order (~1e-6) are all that may differ, and through AdamW a
# weight one f32 step away can flip a bf16 rounding of an activation (2^-8
# of it), which moves a mean of 4094 cross entropies by ~2^-8 / sqrt(4094)
# = 6e-5; 1e-3 is 16x that, while a lost micro-step or a wrong count in the
# average moves the window's grad norm by tens of percent
TRAIN_API_REL_TOL = 1e-3
# bf16 logit tolerance of the paged forward against the no-cache forward, as
# a multiple of the plain bf16 path's own distance from an f32 forward of the
# same weights (measured in the same run): the paged path rounds to bf16 at
# other places (the kernels keep f32 probabilities through PV, the plain
# path casts them to bf16), so it may sit as far from the f32 answer as the
# plain path does, on the other side of it
LOGIT_TOL_FACTOR = 2.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def card_state() -> str:
    """SM clock, power draw and temperature, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def spilling_kernels(logs) -> dict:
    """Mangled kernel name -> its ``ptxas -v`` spill line, for each kernel of
    the build that spills registers to local memory."""
    spills = {}
    for log in logs.values():
        kernel = None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if entry:
                kernel = entry.group(1)
            elif spill and (int(spill.group(1)) or int(spill.group(2))):
                spills[kernel] = line.strip()
    return spills


# ------------------------------------------------------------------ kernels
def paged_case(seed, lengths, s, hq, hkv, d, page, ppl, dtype):
    """A ragged paged-KV state on the card: lanes' tables over a shared pool,
    random K/V, and every dead table slot pointing at a NaN-filled page that
    once belonged to another lane — a kernel that reads past a lane's live
    pages turns its output NaN."""
    n = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    live_pages = n * ppl + 1
    num_pages = live_pages + n
    shape = (num_pages, page, hkv, d)
    pages_k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    pages_v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    pages_k[0] = 0.0
    pages_v[0] = 0.0
    tables = torch.arange(1, live_pages, dtype=torch.int32).reshape(n, ppl)
    for lane, length in enumerate(lengths):
        live = (length + s - 1) // page + 1
        tables[lane, live:] = live_pages + lane
    pages_k[live_pages:] = float("nan")
    pages_v[live_pages:] = float("nan")
    q = torch.randn((n, s, hq, d), generator=gen, device="cuda").to(dtype)
    return (q, pages_k, pages_v, tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def quantized_case(seed, fmt, lengths, s, hq, hkv, d, page, ppl, q_dtype):
    """A ragged state of ``fmt`` pages (int8 or fp8-e4m3) on the card,
    written by the port's own ``paged_quantized_insert``: each lane's
    ``length + s`` random keys and values inserted through its table, then
    every dead table slot pointed at a poisoned page — NaN codes for fp8,
    NaN scales for int8 (whose codes cannot be NaN) — so that a kernel that
    reads past a lane's live pages turns its output NaN.  Returns ``(q,
    pages_k, pages_v, tables, lengths, k_scales, v_scales)``."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    n = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    live_pages = n * ppl + 1
    poisoned = live_pages
    shape = (live_pages + 1, page, hkv, d)
    pages = [torch.zeros(shape, dtype=pa.KV_FORMATS[fmt][0], device="cuda") for _ in range(2)]
    scales = [torch.ones((shape[0], hkv), device="cuda") for _ in range(2)]
    tables = torch.arange(1, live_pages, dtype=torch.int32, device="cuda").reshape(n, ppl)
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    for lane, length in enumerate(lengths):
        for codes, sc in zip(pages, scales):
            new = torch.randn((1, length + s, hkv, d), generator=gen, device="cuda")
            pa.paged_quantized_insert(codes, sc, new, tables[lane:lane + 1], start, one)
        tables[lane, (length + s - 1) // page + 1:] = poisoned
    for codes, sc in zip(pages, scales):
        if fmt == "fp8":
            codes.view(torch.uint8)[poisoned] = 0x7F  # e4m3fn's NaN
        else:
            sc[poisoned] = float("nan")
    q = torch.randn((n, s, hq, d), generator=gen, device="cuda").to(q_dtype)
    return (q, pages[0], pages[1], tables,
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), scales[0], scales[1])


def kernel_phase(name, kernel, plain, fragment, cases, describe, extra_checks):
    """Hold ``kernel`` against ``plain`` on every case ``(label, seed,
    lengths, s, hq, hkv, dtype, page[, d[, fmt[, tree]]])``: native pages of
    ``dtype`` (:func:`paged_case`), or with ``fmt`` pages of that quantized
    format under q of ``dtype`` (:func:`quantized_case`); with ``tree`` (an
    ``[s, s]`` ancestor mask) both take it as ``tree_mask``.  Returns every
    case's record, the first (main-path) case's first.  ``launches`` counts
    the kernel's launches in the case (the checked calls, then the timing
    loops); ``ms`` is its device time per launch (device entries named with
    ``fragment``), ``wall_ms`` the CUDA-event time per call of the
    wrapper.  ``describe(args, kw)`` names the kernel's arm (a dict for the
    record); ``extra_checks(out, args, kw)`` returns the kernel's own
    further readings and ``(passed, message)`` checks."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    records = []
    for label, seed, lengths, s, hq, hkv, dtype, page, *rest in cases:
        d = rest[0] if rest else 128
        fmt = rest[1] if len(rest) > 1 else None
        tree = rest[2] if len(rest) > 2 else None
        if fmt is None:
            args = paged_case(seed, lengths, s, hq, hkv, d, page, 2048 // page, dtype)
        else:
            args = quantized_case(seed, fmt, lengths, s, hq, hkv, d, page, 2048 // page, dtype)
        # one mask object per case: its packed words go to the card once
        kw = {} if tree is None else {"tree_mask": pa.TreeMask(tree)}
        launches0 = kernel.launches
        out = kernel(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[name][dtype]
        check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite output "
              "(a dead or stale page was read)")
        bms, by = paged_bound_ms(lengths, s, hq, hkv, d, dtype, args[1].dtype, page)
        rec = dict(
            case=label, dtype=str(dtype).replace("torch.", ""),
            pages=fmt or str(dtype).replace("torch.", ""), lengths=lengths, s=s,
            hq=hq, hkv=hkv, d=d, page=page, **describe(args, kw), max_abs_err=err,
            tolerance=tol,
        )
        readings, checks = extra_checks(out, args, kw)
        rec.update(readings)
        rec.update(
            ms=device_ms(lambda: kernel(*args, **kw), 20, fragment),
            wall_ms=time_ms(lambda: kernel(*args, **kw), 20),
            plain_ms=time_ms(lambda: plain(*args, **kw), 5),
            bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
        )
        rec["launches"] = kernel.launches - launches0
        emit({"phase": name, **rec})
        check(err <= tol, f"{name} {label}: max abs err {err} > tolerance {tol}")
        for passed, message in checks:
            check(passed, f"{name} {label}: {message}")
        records.append(rec)
    return records


def plain_f32(plain, args, kw=None):
    """The plain version on the same values in f32 (bf16 values and
    quantized codes are exact in f32; codes keep their scales): the
    yardstick that keeps f32 sums, as the kernels do."""
    return plain(*(t.float() for t in args[:3]), *args[3:], **(kw or {}))


def random_tree(seed: int, nodes: int) -> np.ndarray:
    """A random token tree's ``[nodes, nodes]`` ancestor-or-self mask: node
    ``i``'s parent is drawn from ``0 .. i - 1`` (node 0 is the root), so
    the words K1 reads are data, not one of the engine's chains."""
    rng = np.random.default_rng(seed)
    parent = [0] + [int(rng.integers(0, i)) for i in range(1, nodes)]
    anc = np.zeros((nodes, nodes), bool)
    for i in range(nodes):
        j = i
        anc[i, j] = True
        while j:
            j = parent[j]
            anc[i, j] = True
    return anc


def k2_checks(out, args, kw):
    """K2 on a second run must give the same bits; a bf16 case is also held
    per tile of 64 positions of one head against the plain version computed
    in f32 (``FLASH_TILE_TOL``)."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    repeat = torch.equal(out, pa.paged_flash_prefill(*args))
    readings = {"bitwise_repeatable": repeat}
    checks = [(repeat, "two runs gave different bits")]
    if out.dtype == torch.bfloat16:
        err = tile_rel_err(out, plain_f32(pa.paged_flash_prefill_reference, args))
        tol = FLASH_TILE_TOL[torch.bfloat16]
        readings.update(tile_rel_err_vs_f32=err, tile_tolerance=tol)
        checks.append((err <= tol, f"tile relative err {err} > {tol}"))
    return readings, checks


def row_rel_err(got, want) -> float:
    """Largest ``||got - want|| / ||want||`` over the rows of the last
    dimension: 0 on a row where both are 0, infinite where only the plain
    value is."""
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    return torch.where(err == 0, torch.zeros_like(err), err / ref).max().item()


def k1_checks(out, args, kw):
    """K1 per (lane, query, head) row against the plain version in f32
    (``ROW_REL_TOL``), a second run that must give the same bits, and the
    arrival counters, which every launch must leave at zero."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    err = row_rel_err(out, plain_f32(pa.paged_attention_reference, args, kw))
    tol = ROW_REL_TOL[out.dtype]
    repeat = torch.equal(out, pa.paged_attention(*args, **kw))
    pending = pa.pending_split_counters()
    return ({"row_rel_err_vs_f32": err, "row_tolerance": tol, "bitwise_repeatable": repeat,
             "pending_counters": pending},
            [(err <= tol, f"row relative err {err} > {tol}"),
             (repeat, "two runs gave different bits"),
             (pending == 0, f"the arrival counters were left at {pending}")])


def k1_describe(args, kw):
    from accelerate_tpu_torch.ops import paged_attention as pa

    q, pages_k, _, tables = args[:4]
    pps, splits = pa.decode_split_plan(tables.shape[1], q.shape[0], pages_k.shape[2],
                                       pages_k.shape[1], torch.cuda.get_device_properties(
                                           q.device).multi_processor_count)
    gs = q.shape[2] // pages_k.shape[2] * q.shape[1]
    return {"design": pa.DECODE_DESIGN, "arm": "tree" if kw else "causal",
            "pages_per_split": pps, "splits": splits, "rows": gs,
            "row_blocks": pa.decode_row_blocks(gs)[1]}


def k2_describe(args, kw):
    from accelerate_tpu_torch.ops import paged_attention as pa

    q, pages_k = args[:2]
    return {"design": pa.prefill_design(q.dtype, pages_k.dtype, pages_k.shape[1],
                                        q.shape[3])}


# -------------------------------------------------------------------- model
def no_cache_logits(model, ids: np.ndarray) -> torch.Tensor:
    with torch.inference_mode():
        return model(torch.from_numpy(ids[None]).cuda())[0]


def model_phase(model, cfg, rng, name: str = "model") -> float:
    """Paged forward (K2 prefill + 8 K1 decode steps) against the no-cache
    forward in bf16, with an f32 forward of the same weights as the yardstick
    of bf16 noise.  Returns the logit tolerance, which the engine phase uses
    as its noise margin."""
    from accelerate_tpu_torch.models.transformer import PagedKVCache, Transformer
    from accelerate_tpu_torch.serving import PagedKVPool

    prompt = rng.integers(1, cfg.vocab_size, 512).astype(np.int32)
    pool = PagedKVPool(cfg, 1, 1024, 128, 9, device="cuda")
    pool.tables[0] = np.arange(1, 9)
    cache = PagedKVCache(
        pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales,
        tables=torch.from_numpy(pool.tables).cuda(),
        index=torch.zeros(1, dtype=torch.int32, device="cuda"),
        active=torch.ones(1, dtype=torch.bool, device="cuda"), kernel="prefill",
    )
    steps = []
    with torch.inference_mode():
        logits, cache = model(torch.from_numpy(prompt[None]).cuda(), cache=cache)
        steps.append(logits[0])
        cache.kernel = "decode"
        tokens = list(prompt)
        for _ in range(8):
            tokens.append(int(steps[-1][-1].argmax()))
            logits, cache = model(torch.tensor([[tokens[-1]]], device="cuda"), cache=cache)
            steps.append(logits[0])
    ids = np.asarray(tokens, np.int32)
    paged = torch.cat(steps, dim=0)
    ref = no_cache_logits(model, ids)
    # the same weights in f32 (bf16 values are exact in f32), f32 compute
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = Transformer(cfg32, device="cuda", dtype=torch.float32)
    model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()},
                            assign=True)
    ref32 = no_cache_logits(model32, ids)
    del model32
    torch.cuda.empty_cache()
    noise = (ref - ref32).abs().max().item()
    tol = LOGIT_TOL_FACTOR * noise
    err = (paged - ref).abs().max().item()
    emit({"phase": name, "prompt": 512, "decode_steps": 8,
          "max_abs_logit_err": err,
          "decode_max_abs_logit_err": (paged[512:] - ref[512:]).abs().max().item(),
          "tolerance": tol, "plain_bf16_vs_f32": noise,
          "paged_bf16_vs_f32": (paged - ref32).abs().max().item(),
          "logit_std": ref32.std().item()})
    check(err <= tol, f"paged forward logits differ by {err} > {tol}")
    return tol


def quantized_model_phase(model, cfg, rng, fmt: str, tol: float) -> None:
    """A 512-token prompt prefilled through K2 into a pool of ``fmt`` pages,
    then 8 decode steps through K1, each call's logits held against the
    same call over a bf16 pool that holds the dequantized values of the
    quantized pool right after the call (codes x scales, rounded to bf16
    once), attended through the native arms with the call's own writes sent
    to the null page: ``tol`` is the bf16 model line's.  The distance to the
    no-cache forward is printed, not gated: quantization moves it by
    design."""
    from accelerate_tpu_torch.models.transformer import PagedKVCache
    from accelerate_tpu_torch.serving import PagedKVPool

    prompt = rng.integers(1, cfg.vocab_size, 512).astype(np.int32)
    pools = {kv: PagedKVPool(cfg, 1, 1024, 128, 9, kv_dtype=kv, device="cuda")
             for kv in (fmt, "bf16")}
    tables = torch.arange(1, 9, dtype=torch.int32, device="cuda")[None]
    quant, plain = pools[fmt], pools["bf16"]

    def paged(pool, index, kernel, writes):
        return PagedKVCache(pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales,
                            tables=tables, index=index,
                            active=torch.full((1,), writes, device="cuda"), kernel=kernel)

    cache = paged(quant, torch.zeros(1, dtype=torch.int32, device="cuda"), "prefill", True)
    steps, held, feed = [], [], prompt
    tokens = list(prompt)
    with torch.inference_mode():
        for _ in range(9):
            ids = torch.from_numpy(np.asarray(feed, np.int32)[None]).cuda()
            index = cache.index
            logits, cache = model(ids, cache=cache)
            steps.append(logits[0])
            for dst, codes, sc in ((plain.pages_k, quant.pages_k, quant.k_scales),
                                   (plain.pages_v, quant.pages_v, quant.v_scales)):
                for layer in range(cfg.num_layers):
                    dst[layer].copy_(codes[layer].float() * sc[layer][:, None, :, None])
            ref, _ = model(ids, cache=paged(plain, index, cache.kernel, False))
            held.append(ref[0])
            cache.kernel = "decode"
            feed = [int(steps[-1][-1].argmax())]
            tokens.append(feed[0])
    got, want = torch.cat(steps), torch.cat(held)
    err = (got - want).abs().max().item()
    no_cache = no_cache_logits(model, np.asarray(tokens[:-1], np.int32))
    emit({"phase": "model_" + fmt, "prompt": 512, "decode_steps": 8, "pages": fmt,
          "max_abs_logit_err_vs_dequantized_bf16": err,
          "decode_max_abs_logit_err_vs_dequantized_bf16": (got[512:] - want[512:]).abs()
          .max().item(),
          "tolerance": tol,
          "max_abs_logit_dist_to_no_cache": (got - no_cache).abs().max().item(),
          "kv_quant_error": cache.quant_err.item()})
    check(err <= tol, f"{fmt} paged forward logits differ from the dequantized bf16 pool's "
          f"by {err} > {tol}")
    del pools, quant, plain
    torch.cuda.empty_cache()


#: the round-trip error bound of each quantized format, as a multiple of the
#: largest page scale: half a code step for int8; for e4m3, 2^-4 of the
#: amax, which the scale maps to 448 (3 mantissa bits: a relative step of
#: 2^-3 at worst).  The slack covers the f32 rounding of x / s and q * s
#: (a few 2^-24 of 127 steps).
QUANT_ERR_BOUND = {"int8": 0.5, "fp8": 2.0**-4 * 448.0}
QUANT_ERR_SLACK = 1 + 2.0**-10


def tracking_scales(track: torch.Tensor):
    """Wrap the transformer's quantized insert so that ``track`` follows the
    largest page scale any insert leaves in its layer's scale array (a
    device max, never read back during the run); returns an undo.  It adds
    two ops to every insert, so it watches only an untimed serve."""
    from accelerate_tpu_torch.models import transformer

    saved = transformer.paged_quantized_insert

    def insert(pages, scales, new, tables, index, active):
        out = saved(pages, scales, new, tables, index, active)
        torch.maximum(track, out[1].amax(), out=track)
        return out

    transformer.paged_quantized_insert = insert
    return lambda: setattr(transformer, "paged_quantized_insert", saved)


ENGINE_LENS = (57, 100, 384, 700, 1000, 1500)


def engine_phase(model, cfg, rng, gpu, margin: float, kv_dtype=None, spec=None,
                 prompts=None, name=None, eager=False, knobs=None):
    """Serve six greedy requests of 48 new tokens through ``ServingEngine``
    (``spec``: the speculation knobs; ``knobs``: other engine knobs;
    ``prompts``: else drawn from ``rng``), the launch counters zeroed just
    before and read just after.  The engine is the default one (every
    window and each prefill bucket's chunk a CUDA graph captured at
    construction, the depth-1 pipeline), or with ``eager`` the eager windows
    and chunks and the synchronous loop (``ServingEngine._eager(...,
    async_depth=0)``).  K1 must have launched once a layer for each forward
    of a decode window and each linear verify (its causal arm) and each
    tree verify (its tree-mask arm, counted apart), graph replays credited;
    the draft forward launches none; K2 once a layer per prefill chunk.
    The graphs captured (one per bucket among them) must not grow during the
    serve.  Returns the launches, the prompts and the tokens."""
    from accelerate_tpu_torch.models.generation import GenerationConfig
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving import ServingEngine

    if prompts is None:
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in ENGINE_LENS]
    lens = tuple(len(p) for p in prompts)
    gen = GenerationConfig(max_new_tokens=48)

    def new_engine():
        kw = {**dict(num_slots=4, max_len=2048, prefill_buckets=(128, 512), decode_window=4,
                     kv_dtype=kv_dtype, prefix_cache_mb=0, device="cuda"), **(spec or {}),
              **(knobs or {})}
        if eager:
            return ServingEngine._eager(model, None, async_depth=0, **kw)
        return ServingEngine(model, None, **kw)

    # the device memory the engine takes: its pool (and scratch), the
    # graphs' private pools and whatever they keep allocated
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    engine = new_engine()
    torch.cuda.synchronize()
    held = {"allocated_gb": (torch.cuda.memory_allocated() - before[0]) / 1e9,
            "reserved_gb": (torch.cuda.memory_reserved() - before[1]) / 1e9}
    paged = engine.paged
    idle_free = engine.kv.allocator.free_count if paged else None
    quantized = engine.quantized
    captures = engine.stats["graph_captures"]
    check(captures == (0 if eager else len(engine.graphs)) and (eager or captures > 0),
          f"{captures} graphs captured at construction")
    chunk_graphs = sorted(key[1] for key in (engine.graphs.keys() if engine.graphs else ())
                          if key[0] == "prefill")
    check(chunk_graphs == ([] if eager else [128, 512]),
          f"prefill chunk graphs for buckets {chunk_graphs}")
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = engine.serve(prompts, configs=gen)
    wall = time.perf_counter() - t0
    held["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_attention_tree": pa.paged_attention.tree_launches,
                "paged_flash_prefill": pa.paged_flash_prefill.launches}
    st = engine.stats
    check(all(len(r.tokens) == 48 and r.done for r in reqs), "a request did not finish 48 tokens")
    # a verify cycle counts its committed width in decode_steps but runs one
    # forward: K + 1 for the linear arm, tree_depth + 1 for the tree arm
    tree = engine.tree is not None
    width = engine.tree.depth + 1 if tree else engine.speculate_k + 1
    window_forwards = st["decode_steps"] - st["verify_forwards"] * width
    causal = (window_forwards + (0 if tree else st["verify_forwards"])) * cfg.num_layers
    tree_forwards = st["verify_forwards"] if tree else 0
    if not paged:
        # the slab pool attends by plain PyTorch, as the reference by XLA:
        # no kernel of the path may launch
        causal = tree_forwards = 0
    check(launches["paged_attention"] - launches["paged_attention_tree"] == causal
          and (launches["paged_attention"] > 0) == paged,
          f"decode kernel launches {launches['paged_attention']} (tree arm "
          f"{launches['paged_attention_tree']}) != {causal} causal: {window_forwards} window "
          f"steps and {st['verify_forwards']} verify forwards x {cfg.num_layers} layers")
    check(launches["paged_attention_tree"] == tree_forwards * cfg.num_layers,
          f"tree-arm launches {launches['paged_attention_tree']} != {tree_forwards} tree "
          f"verify forwards x {cfg.num_layers} layers")
    if spec:
        check(st["verify_forwards"] > 0 and st["spec_drafted"] > 0,
              f"speculation ran no verify: {st['verify_forwards']} forwards, "
              f"{st['spec_drafted']} drafted")
    chunk_launches = st["prefill_chunks"] * cfg.num_layers if paged else 0
    check(launches["paged_flash_prefill"] == chunk_launches and st["prefill_chunks"] > 0,
          f"prefill kernel launches {launches['paged_flash_prefill']} != {chunk_launches} "
          f"for {st['prefill_chunks']} chunks x {cfg.num_layers} layers")
    check(not paged or engine.kv.allocator.free_count == idle_free, "KV pages leaked")
    check(st["graph_captures"] == captures, f"graphs captured during the serve: "
          f"{captures} -> {st['graph_captures']}")
    check(eager or st["graph_replays"] > 0, "no window replayed a graph")
    if (knobs or {}).get("interleave_prefill"):
        check(st["interleaved_chunks"] > 0, "no chunk queued behind a window of its cycle")
    if quantized:
        # the same serve again, untimed, by a new engine whose inserts are
        # watched for the largest scale they leave; scales of pages no insert
        # wrote read 0, so that the largest is one some write used (an
        # unwritten page is never read: the insert zeroes a fresh page's
        # slots past the frontier itself, whatever its scale)
        # (the tracker goes in before the engine, whose graphs capture it)
        scale_max = torch.zeros((), device="cuda")
        undo = tracking_scales(scale_max)
        try:
            watched = new_engine()
            watched.kv.k_scales.zero_()
            watched.kv.v_scales.zero_()
            scale_max.zero_()
            again = watched.serve(prompts, configs=gen)
        finally:
            undo()
        check([r.tokens for r in again] == [r.tokens for r in reqs],
              f"{kv_dtype} engine tokens differ between two serves of the same requests")
        check(watched.stats["kv_quant_error"] == st["kv_quant_error"],
              f"{kv_dtype} kv_quant_error differs between two serves: "
              f"{watched.stats['kv_quant_error']} against {st['kv_quant_error']}")
        del watched

    agree = total = confident = 0
    deficits = []
    for req in reqs:
        ref = no_cache_logits(model, req.output_ids)
        plen = len(req.prompt)
        rows = ref[plen - 1:plen - 1 + len(req.tokens)].float()
        got = torch.tensor(req.tokens, device=rows.device)
        top2 = rows.topk(2, dim=-1).values
        agree += int((rows.argmax(dim=-1) == got).sum())
        confident += int(((top2[:, 0] - top2[:, 1]) > margin).sum())
        # how far below the reference's best logit the engine's token sits:
        # 0 where they agree, within the noise margin for a near tie
        deficits.append(top2[:, 0] - rows.gather(1, got[:, None])[:, 0])
        total += len(req.tokens)
    deficit = torch.cat(deficits)
    kv_rec = {}
    if quantized:
        bound = QUANT_ERR_BOUND[kv_dtype] * scale_max.item() * QUANT_ERR_SLACK
        kv_rec = {"kv_quant_error": st["kv_quant_error"], "kv_quant_error_bound": bound,
                  "largest_scale": scale_max.item()}
    spec_rec = {}
    if spec:
        spec_rec = {
            "spec": spec, "spec_drafted": st["spec_drafted"],
            "spec_accepted": st["spec_accepted"],
            "accept_rate": st["spec_accepted"] / st["spec_drafted"],
            "tokens_per_verify_forward": st["verify_committed"] / st["verify_forwards"],
            "tokens_per_lane_verify": st["verify_committed"] / st["verify_lanes"],
            "draft_share_of_decode_s": st["draft_s"] / st["decode_s"],
        }
    if paged:
        pool_rec = {"pages": str(engine.kv.storage_dtype).replace("torch.", ""),
                    "kv_pool_gb": engine.kv.kv_bytes() / 1e9,
                    "kv_pool_bytes": engine.kv.kv_bytes()}
    else:
        slab_bytes = 2 * engine.pool.k.numel() * engine.pool.k.element_size()
        scratch_bytes = 2 * engine.scratch.k.numel() * engine.scratch.k.element_size()
        pool_rec = {"pool": "slab", "slab": str(engine.pool.k.dtype).replace("torch.", ""),
                    "slab_pool_gb": slab_bytes / 1e9, "scratch_gb": scratch_bytes / 1e9}
    emit({"phase": name or ("engine" if kv_dtype is None else "engine_" + kv_dtype),
          "windows": ("eager windows and chunks, async_depth=0" if eager
                      else "cuda graphs (windows and chunks), async_depth=1"),
          "knobs": knobs, **spec_rec, "kv_dtype": kv_dtype, **pool_rec,
          "kv_bytes_per_token": st["kv_bytes_per_token"], **kv_rec,
          "engine_memory": held,
          "requests": len(reqs), "prompt_lens": list(lens),
          "new_tokens": 48, "stats": st, "launches": launches, "wall_s": wall,
          "argmax_agree_share": agree / total,
          "margin_above_noise_share": confident / total, "noise_margin": margin,
          "max_logit_deficit": deficit.max().item(),
          "mean_logit_deficit": deficit.mean().item(),
          "decode_tokens_per_s": st["tokens_generated"] / st["decode_s"],
          "serve_tokens_per_s": st["tokens_generated"] / wall,
          "decode_ms_per_step": 1e3 * st["decode_s"] / st["decode_steps"],
          "graph_captures": st["graph_captures"], "graph_replays": st["graph_replays"],
          "host_overlap_ratio": st["host_overlap_ratio"],
          "device_idle_s": st["device_idle_s"], "prefreed_lanes": st["prefreed_lanes"],
          "prefill_tokens_per_s": st["prefill_tokens"] / st["prefill_s"],
          "prefill_s": st["prefill_s"], "prefill_chunks": st["prefill_chunks"],
          "prefill_ms_per_chunk": 1e3 * st["prefill_s"] / st["prefill_chunks"],
          "interleaved_chunks": st["interleaved_chunks"], "gpu": gpu})
    if quantized:
        # quantization moves the logits by design: the tokens are held by
        # the error bound, not by the bf16 noise margin
        check(0.0 < kv_rec["kv_quant_error"] <= kv_rec["kv_quant_error_bound"],
              f"{kv_dtype} kv_quant_error {kv_rec['kv_quant_error']} outside "
              f"(0, {kv_rec['kv_quant_error_bound']}]")
    else:
        check(deficit.max().item() <= margin, "an engine token sits below the no-cache "
              f"forward's best logit by more than the noise margin {margin}")
    return launches, prompts, [r.tokens for r in reqs]


def chunk_graph_phase(model, cfg, gpu) -> None:
    """Each prefill bucket's CUDA graph against the same chunk program run
    launch by launch, at full width, for bf16, int8 and fp8 pages: a
    512-token chunk at base 0, then 128-token chunks at bases 512 and 640
    behind it (their prior pages are the earlier chunks' KV), each replay's
    pages, scales and quantization error bitwise the eager run's on the same
    pool state (the touched pages gathered after the replay, restored, and
    gathered again after the eager run).  Then :func:`~accelerate_tpu_torch.
    profile_engine.chunk_times`: ms per chunk replayed and eager beside the
    bound.  For bf16 pages also the device memory the chunk graphs hold:
    ``memory_allocated`` and ``memory_reserved`` (a graph's private pool is
    reserved, its freed intermediates not allocated) gained by constructing
    the engine with and without them (``ServingEngine._eager_chunks``)."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving import ServingEngine
    from accelerate_tpu_torch.serving.pool import promote_install, spill_extract

    kw = dict(num_slots=4, max_len=2048, prefill_buckets=(128, 512), decode_window=4,
              prefix_cache_mb=0, device="cuda")
    memory = {}
    for kv_dtype in (None, "int8", "fp8"):
        if kv_dtype is None:
            for mode, make in (("without", ServingEngine._eager_chunks),
                               ("with", ServingEngine)):
                gc.collect()
                torch.cuda.empty_cache()
                before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
                engine = make(model, None, **kw)
                torch.cuda.synchronize()
                memory[mode] = (torch.cuda.memory_allocated() - before[0],
                                torch.cuda.memory_reserved() - before[1])
                if mode == "without":
                    del engine
        else:
            engine = ServingEngine(model, None, kv_dtype=kv_dtype, **kw)
        pool = engine._pool
        ids = torch.arange(1, 8, device="cuda")
        engine._chunk_table.copy_(torch.arange(1, engine.kv.pages_per_lane + 1,
                                               dtype=torch.int32)[None])
        gen = torch.Generator(device="cuda").manual_seed(1)
        cases = []
        for bucket, base in ((512, 0), (128, 512), (128, 640)):
            engine._chunk_tokens[bucket].copy_(torch.randint(
                1, cfg.vocab_size, (1, bucket), generator=gen, device="cuda"))
            engine._chunk_base.fill_(base)
            state = spill_extract(pool, ids)
            counts = pa.launch_counts()
            err_graph = engine.graphs.replay(engine._chunk_key(bucket)).clone()
            graph_launches = pa.paged_flash_prefill.launches - counts[-1]
            replayed = spill_extract(pool, ids)
            promote_install(pool, state, ids)
            err_eager = engine._chunks[bucket]()
            eager = spill_extract(pool, ids)
            same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(replayed, eager)) and torch.equal(err_graph, err_eager)
            check(same, f"{kv_dtype or 'bf16'} pages: the {bucket}-token chunk's graph replay "
                        f"at base {base} is not bitwise the eager chunk")
            check(graph_launches == cfg.num_layers,
                  f"a {bucket}-token chunk replay credited {graph_launches} K2 launches, "
                  f"want {cfg.num_layers}")
            cases.append({"bucket": bucket, "base": base, "bitwise": same,
                          "quant_err": err_graph.item()})
        emit({"phase": "chunk_graphs", "kv_dtype": kv_dtype,
              "pages": str(engine.kv.storage_dtype).replace("torch.", ""),
              "bitwise_cases": cases, "chunk_ms": chunk_times(engine),
              **({"engine_allocated_reserved_gb": {k: [v / 1e9 for v in m]
                                                   for k, m in memory.items()},
                  "chunk_graphs_reserved_gb": (memory["with"][1] - memory["without"][1]) / 1e9}
                 if kv_dtype is None else {}),
              "gpu": gpu})
        del engine, pool
        gc.collect()
        torch.cuda.empty_cache()


def cancel_phase(model, cfg, gpu, prompts, tokens) -> None:
    """``engine_cancel``: the ``engine`` phase's requests through the engine
    as a user makes it (graphs, the pipeline, the default prefix cache);
    once the second request has streamed 8 tokens and its lane is live in
    the window in flight, it is cancelled.  No token of it streams after the cancel, every other
    request gives the ``engine`` phase's tokens, K2 launches once a layer
    per chunk, and every page is free after the drain and
    ``flush_prefix_cache()``."""
    from accelerate_tpu_torch.models.generation import GenerationConfig
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving import RequestState, ServingEngine

    engine = ServingEngine(model, None, num_slots=4, max_len=2048, prefill_buckets=(128, 512),
                           decode_window=4, device="cuda")
    idle_free = engine.kv.allocator.free_count
    streamed = []
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, config=GenerationConfig(max_new_tokens=48),
                          on_token=lambda r, t: streamed.append(r.rid)) for p in prompts]
    victim = reqs[1]
    while not (len(victim.tokens) >= 8 and engine._inflight is not None
               and engine._inflight.lane_live(victim.slot)):
        engine.step()
    before = len(victim.tokens)
    deferred = len(engine._inflight.deferred_pages)
    check(engine.cancel(victim), "cancel of a running lane returned False")
    deferred = len(engine._inflight.deferred_pages) - deferred
    engine.run()
    wall = time.perf_counter() - t0
    st = engine.stats
    k2 = pa.paged_flash_prefill.launches
    check(victim.state is RequestState.CANCELLED and len(victim.tokens) == before
          and streamed.count(victim.rid) == before,
          f"the cancelled lane streamed {streamed.count(victim.rid) - before} tokens after "
          "its cancel")
    others = [i for i in range(len(reqs)) if reqs[i] is not victim]
    check(all(reqs[i].done and reqs[i].tokens == tokens[i] for i in others),
          "engine_cancel: a request other than the cancelled one differs from engine's tokens")
    check(k2 == st["prefill_chunks"] * cfg.num_layers,
          f"engine_cancel: K2 launches {k2} != {st['prefill_chunks']} chunks x "
          f"{cfg.num_layers} layers")
    check(deferred > 0, "the cancelled lane's pages were not deferred to its window")
    engine.flush_prefix_cache()
    check(engine.kv.allocator.free_count == idle_free,
          f"engine_cancel: {engine.kv.allocator.free_count} pages free after the flush, "
          f"{idle_free} at construction")
    emit({"phase": "engine_cancel", "cancelled_rid": victim.rid,
          "tokens_before_cancel": before, "deferred_pages": deferred,
          "cancelled": st["cancelled"], "requests_completed": st["requests_completed"],
          "prefill_chunks": st["prefill_chunks"], "launches_k2": k2, "wall_s": wall,
          "graph_captures": st["graph_captures"], "gpu": gpu})
    check(st["cancelled"] == 1 and st["requests_completed"] == len(reqs) - 1,
          f"engine_cancel: cancelled {st['cancelled']}, completed {st['requests_completed']}")


# ------------------------------------------------------------- prefix cache
PREFIX_LEN = 1024  # a shared system prefix: two full 512-token chunks


def chain_mb(cfg, kv_dtype, chains: float) -> float:
    """MiB of ``chains`` cached ``PREFIX_LEN``-token prefixes (two 512-token
    chunks of four 128-token pages) at the page format, scales included:
    the engine's ``chunk_bytes`` unit, so a budget of one chain holds
    exactly one."""
    from accelerate_tpu_torch.ops.paged_attention import kv_storage_dtype

    itemsize = torch.tensor([], dtype=kv_storage_dtype(kv_dtype, cfg.dtype)).element_size()
    page_bytes = 2 * (128 * cfg.num_kv_heads * cfg.resolved_head_dim * cfg.num_layers * itemsize
                      + cfg.num_layers * cfg.num_kv_heads * 4)
    return chains * (PREFIX_LEN // 128) * page_bytes / 2**20


def prefix_prompts(rng, cfg, prefixes: int, tails) -> list:
    """Prompts of a ``PREFIX_LEN``-token prefix (``prefixes`` distinct ones,
    cycled A B C A B C ...) and a distinct random tail of each length in
    ``tails``.  The prefix is exactly the first two chunks of every plan:
    the cacheable ones."""
    from accelerate_tpu_torch.serving.pool import plan_chunks

    heads = [rng.integers(1, cfg.vocab_size, PREFIX_LEN).astype(np.int32)
             for _ in range(prefixes)]
    prompts = []
    for i, n in enumerate(tails):
        prompt = np.concatenate([heads[i % prefixes],
                                 rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)])
        check(plan_chunks(len(prompt), (128, 512))[:2] == ((512, 512), (512, 512)),
              f"a {len(prompt)}-token prompt's plan does not start with two full 512 chunks")
        prompts.append(prompt)
    return prompts


def prefix_engine(model, kv_dtype=None, device="cuda", **knobs):
    """The ``engine`` phase's engine, with the prefix-cache ``knobs``."""
    from accelerate_tpu_torch.serving import ServingEngine

    return ServingEngine(model, None, num_slots=4, max_len=2048, prefill_buckets=(128, 512),
                         decode_window=4, kv_dtype=kv_dtype, device=device, **knobs)


def prefix_phase(model, cfg, gpu, name: str, prompts, kv_dtype=None, **knobs) -> dict:
    """Serve ``prompts`` (48 greedy new tokens each) through the engine of
    the ``engine`` phase with the prefix cache (``knobs``), then through the
    same engine with ``prefix_cache_mb=0``: the greedy tokens must be
    identical (a hit replays the KV a prefill would have written, bit for
    bit, and K2 is deterministic).  The launch counters are zeroed just
    before each serve and read just after: K2 once a layer per prefilled
    chunk, fewer with the cache; K1 once a layer per decode step.  No graph
    is captured during a serve, no promotion degrades, and after
    ``flush_prefix_cache()`` every page is free again."""
    from accelerate_tpu_torch.models.generation import GenerationConfig
    from accelerate_tpu_torch.ops import paged_attention as pa

    gen = GenerationConfig(max_new_tokens=48)
    pool = {k: v for k, v in knobs.items() if k == "paged"}
    runs = {}
    for mode, kw in (("on", knobs), ("off", dict(prefix_cache_mb=0, **pool))):
        engine = prefix_engine(model, kv_dtype, **kw)
        paged = engine.paged
        idle_free = engine.kv.allocator.free_count if paged else None
        captures = engine.stats["graph_captures"]
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = engine.serve(prompts, configs=gen)
        wall = time.perf_counter() - t0
        launches = {"paged_attention": pa.paged_attention.launches,
                    "paged_flash_prefill": pa.paged_flash_prefill.launches}
        st = dict(engine.stats)
        check(all(len(r.tokens) == 48 and r.done for r in reqs),
              f"{name} ({mode}): a request did not finish 48 tokens")
        # the slab pool runs no kernel: both counts must stay 0
        layers = cfg.num_layers if paged else 0
        check(launches["paged_flash_prefill"] == st["prefill_chunks"] * layers,
              f"{name} ({mode}): prefill kernel launches {launches['paged_flash_prefill']} != "
              f"{st['prefill_chunks']} chunks x {layers} layers")
        check(launches["paged_attention"] == st["decode_steps"] * layers
              and st["decode_steps"] > 0,
              f"{name} ({mode}): decode kernel launches {launches['paged_attention']} != "
              f"{st['decode_steps']} steps x {layers} layers")
        check(st["graph_captures"] == captures, f"{name} ({mode}): graphs captured during "
              f"the serve: {captures} -> {st['graph_captures']}")
        cache = engine.prefix_cache_stats()
        # the caching host allocator's pinned bytes in use, before the flush
        # frees the host ring's payloads
        pinned = {k: v for k, v in torch.cuda.host_memory_stats().items()
                  if k in ("allocated_bytes.current", "allocated_bytes.peak")}
        engine.flush_prefix_cache()
        if paged:
            check(engine.kv.allocator.free_count == idle_free,
                  f"{name} ({mode}): KV pages leaked: {engine.kv.allocator.free_count} free "
                  f"after the flush, {idle_free} at construction")
        else:
            check(engine.prefix_cache is None or engine.prefix_cache.bytes == 0,
                  f"{name} ({mode}): cached slabs left after the flush")
        runs[mode] = dict(tokens=[r.tokens for r in reqs], stats=st, cache=cache, wall=wall,
                          launches=launches, pinned=pinned)
        # the cache's hooks are the engine's bound methods: a reference
        # cycle, so the engine's pool and graphs free only at a collection
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs["on"], runs["off"]
    st = on["stats"]
    check(on["tokens"] == off["tokens"],
          f"{name}: greedy tokens with the prefix cache differ from the cache-off serve")
    if paged:
        check(on["launches"]["paged_flash_prefill"] < off["launches"]["paged_flash_prefill"],
              f"{name}: the cache saved no prefill launch ({on['launches']} vs "
              f"{off['launches']})")
    check(st["prefill_chunks"] < off["stats"]["prefill_chunks"],
          f"{name}: the cache saved no chunk ({st['prefill_chunks']} vs "
          f"{off['stats']['prefill_chunks']})")
    check(st["promote_degraded"] == 0, f"{name}: {st['promote_degraded']} promotions degraded")
    tokens = sum(len(t) for t in on["tokens"])

    def gb_per_s(nbytes, seconds):
        return nbytes / seconds / 1e9 if seconds else None

    rec = {
        "phase": name, "kv_dtype": kv_dtype, "knobs": knobs, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts], "new_tokens": 48,
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "prefix_hit_tokens_host": st["prefix_hit_tokens_host"],
        "prefix_miss_tokens": st["prefix_miss_tokens"], "hit_rate": on["cache"]["hit_rate"],
        "cow_copies": st["cow_copies"], "reclaim_evictions": st["reclaim_evictions"],
        "promote_degraded": st["promote_degraded"], "cache": on["cache"],
        "spills": on["cache"]["spills"], "promotions": on["cache"]["promotions"],
        "disk_writes": on["cache"]["disk_writes"],
        "spill_gb_per_s": gb_per_s(st["spill_bytes"], st["spill_s"]),
        "spill_bytes": st["spill_bytes"], "spill_s": st["spill_s"],
        "promote_gb_per_s": gb_per_s(st["promote_bytes"], st["promote_s"]),
        "promote_bytes": st["promote_bytes"], "promote_s": st["promote_s"],
        "host_ring_bytes_at_end": on["cache"]["host_bytes"], "disk_s": on["cache"]["disk_s"],
        "pinned_host_bytes": on["pinned"],
        "prefill_chunks": {"on": st["prefill_chunks"], "off": off["stats"]["prefill_chunks"]},
        "prefill_s": {"on": st["prefill_s"], "off": off["stats"]["prefill_s"]},
        "serve_tokens_per_s": {"on": tokens / on["wall"], "off": tokens / off["wall"]},
        "wall_s": {"on": on["wall"], "off": off["wall"]},
        "launches": {"on": on["launches"], "off": off["launches"]},
        "gpu": gpu,
    }
    emit(rec)
    return rec


def prefix_phases(model, cfg, rng, gpu) -> dict:
    """``engine_prefix``: one shared system prefix before 8 distinct tails of
    57-900 tokens, a 1 GiB device budget; ``engine_prefix_tiers`` (bf16,
    then int8 pages): three prefixes cycled A B C x 3 before tails of
    57-500 tokens, under a device budget of one prefix chain, a host ring
    of one and a disk ring of two, so chains demote to the host, then to
    disk, and come back.  Returns ``engine_prefix``'s launches."""
    shared_prompts = prefix_prompts(rng, cfg, 1, np.linspace(57, 900, 8).astype(int))
    shared = prefix_phase(model, cfg, gpu, "engine_prefix", shared_prompts,
                          prefix_cache_mb=1024.0)
    check(shared["prefix_hit_tokens"] >= 4 * PREFIX_LEN,
          f"engine_prefix: {shared['prefix_hit_tokens']} hit tokens, want >= {4 * PREFIX_LEN}")
    prompts = prefix_prompts(rng, cfg, 3, np.linspace(57, 500, 9).astype(int))
    for kv_dtype in (None, "int8"):
        with tempfile.TemporaryDirectory() as disk:
            rec = prefix_phase(
                model, cfg, gpu, "engine_prefix_tiers" + ("" if kv_dtype is None else "_int8"),
                prompts, kv_dtype=kv_dtype, prefix_cache_mb=chain_mb(cfg, kv_dtype, 1),
                prefix_host_mb=chain_mb(cfg, kv_dtype, 1),
                prefix_disk_mb=chain_mb(cfg, kv_dtype, 2), prefix_disk_dir=disk)
        check(rec["spills"] > 0 and rec["disk_writes"] > 0 and rec["prefix_hit_tokens_host"] > 0,
              f"{rec['phase']}: the tiers were not exercised: {rec['spills']} spills, "
              f"{rec['disk_writes']} disk writes, {rec['prefix_hit_tokens_host']} host hits")
    return shared["launches"]["on"], shared_prompts


def slab_phases(model, cfg, gpu, margin, prompts, spec_prompts, prefix_prompts_) -> None:
    """The slab pool (``paged=False``, the reference's default) at the
    ``engine`` phase's geometry: ``engine_slab`` (the engine line's requests;
    one graph per window and per bucket, K1 and K2 never launched, every
    token within the noise margin), ``engine_slab_sync_eager`` (the same
    through ``_eager(..., async_depth=0)``: bit-identical tokens),
    ``engine_slab_tree`` and ``engine_slab_spec`` (the knobs and prompts of
    ``engine_tree`` and ``engine_spec``), ``engine_slab_prefix``
    (``engine_prefix``'s requests at ``prefix_cache_mb=1024``: tokens
    identical to the cache-off serve, at least 4 x 1024 hit tokens, fewer
    chunks), and ``slab_attention`` (what plain attention over the slab
    costs a decode step)."""
    slab = dict(paged=False)
    _, _, tokens = engine_phase(model, cfg, None, gpu, margin, prompts=prompts,
                                name="engine_slab", knobs=slab)
    _, _, eager = engine_phase(model, cfg, None, gpu, margin, prompts=prompts,
                               name="engine_slab_sync_eager", eager=True, knobs=slab)
    check(eager == tokens, "engine_slab_sync_eager's greedy tokens differ from engine_slab's")
    engine_phase(model, cfg, None, gpu, margin, prompts=prompts, name="engine_slab_tree",
                 spec=dict(draft_model=8, tree_width=2, tree_depth=4, draft_ctx=64), knobs=slab)
    engine_phase(model, cfg, None, gpu, margin, prompts=spec_prompts, name="engine_slab_spec",
                 spec=dict(speculate_k=4), knobs=slab)
    rec = prefix_phase(model, cfg, gpu, "engine_slab_prefix", prefix_prompts_,
                       prefix_cache_mb=1024.0, paged=False)
    check(rec["prefix_hit_tokens"] >= 4 * PREFIX_LEN,
          f"engine_slab_prefix: {rec['prefix_hit_tokens']} hit tokens, want >= {4 * PREFIX_LEN}")
    slab_attention_cost(model, cfg, gpu)


def slab_attention_cost(model, cfg, gpu) -> dict:
    """What plain attention over the slab pool costs a decode step: one
    layer's :func:`~accelerate_tpu_torch.models.transformer.cached_attention`
    at the ``engine_slab`` decode shape (4 lanes of 57/384/700/1000 keys in
    slabs of 2048, 32 heads, D 128, bf16), device ms per call from CUDA
    events around a CUDA graph of the calls, beside the bytes bound of
    reading the whole slab (what plain attention reads) and of reading the
    live keys only (what the paged kernel K1 reads), and beside K1 on the
    same lanes in pages of 128.  Times 32 layers: the step's share.  Then,
    on an idle slab engine of the ``engine_slab`` geometry, the card time
    of one decode window's graph replay (plain attention reads the whole
    slab whatever the lanes hold, so an idle pool costs what a full one
    does), per step, and of each bucket's chunk graph replayed and run
    launch by launch (:func:`time_ms` over 10 back-to-back calls), beside
    the chunk's bound (:func:`chunk_bound_ms`)."""
    from accelerate_tpu_torch.models.transformer import cached_attention
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving import ServingEngine

    lens = [57, 384, 700, 1000]
    n, m, h, d = len(lens), 2048, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((n, 1, cfg.num_heads, d), generator=gen, device="cuda").to(cfg.dtype)
    k = torch.randn((n, m, h, d), generator=gen, device="cuda").to(cfg.dtype)
    v = torch.randn((n, m, h, d), generator=gen, device="cuda").to(cfg.dtype)
    pos = torch.tensor(lens, device="cuda")[:, None]
    slab_ms = graph_ms(lambda: cached_attention(q, k, v, pos), 20)
    # the same keys in pages of 128, one block table row a lane
    pages_k = k.reshape(n * m // 128, 128, h, d)
    pages_v = v.reshape(n * m // 128, 128, h, d)
    tables = torch.arange(n * m // 128, dtype=torch.int32, device="cuda").reshape(n, -1)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    counts = pa.launch_counts()
    k1_ms = graph_ms(lambda: pa.paged_attention(q, pages_k, pages_v, tables, lengths), 20)
    pa.set_launch_counts(counts)     # a measurement, not the path's launches
    item = k.element_size()
    whole = 2 * n * m * h * d * item / HBM_BYTES_PER_S * 1e3
    live = 2 * sum(x + 1 for x in lens) * h * d * item / HBM_BYTES_PER_S * 1e3
    del q, k, v, pages_k, pages_v
    engine = ServingEngine(model, None, paged=False, num_slots=4, max_len=2048,
                           prefill_buckets=(128, 512), decode_window=4, prefix_cache_mb=0,
                           device="cuda")
    window_ms = time_ms(lambda: engine.graphs.replay(engine._graph_key("decode", False)), 10)
    chunks = []
    for bucket, base in ((512, 0), (128, 0), (128, 640)):
        engine._chunk_tokens[bucket].copy_(torch.randint(
            1, cfg.vocab_size, (1, bucket), generator=gen, device="cuda"))
        engine._chunk_base.fill_(base)
        bound, by = chunk_bound_ms(model, bucket, base)
        chunks.append({"bucket": bucket, "base": base,
                       "graph_ms": time_ms(lambda: engine.graphs.replay(
                           engine._chunk_key(bucket)), 10),
                       "eager_ms": time_ms(engine._chunks[bucket], 10),
                       "bound_ms": bound, "bound_by": by})
    check(pa.launch_counts() == counts, "a slab program launched a paged kernel")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "slab_attention", "lanes": lens, "slab_len": m,
           "slab_ms_per_layer": slab_ms, "k1_ms_per_layer": k1_ms,
           "whole_slab_bound_ms": whole, "live_keys_bound_ms": live,
           "slab_ms_per_step": slab_ms * cfg.num_layers,
           "k1_ms_per_step": k1_ms * cfg.num_layers,
           "decode_window_graph_ms_per_step": window_ms / 4, "slab_chunks": chunks, "gpu": gpu}
    emit(rec)
    return rec


# --------------------------------------------------------------- flash attn
# ------------------------------------------------------------ families
#: GPT-2's prompts: the six engine requests cut to its 1024 learned positions
GPT2_LENS = (57, 100, 384, 700, 850, 960)


def family_model(cfg, seed: int = 0, affine_std: float = 0.02):
    """``cfg``'s model on the card in bf16, random weights from ``seed``.
    ``init_params`` draws zero biases and unit norm scales, as Flax does;
    each bias and norm parameter here then gets normal(``affine_std``) noise
    added, so the bias adds and norm shifts do real arithmetic."""
    from accelerate_tpu_torch.models.transformer import Transformer
    from accelerate_tpu_torch.weights import init_params

    sd = init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10_000)
    for t in sd.values():
        if affine_std and t.dim() == 1:  # the biases and the norms' parameters
            t.add_(torch.empty_like(t).normal_(0.0, affine_std, generator=gen))
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(sd, assign=True)
    return model


def neox_phases(gpu) -> dict:
    """Pythia-6.9B (GPT-NeoX: LayerNorm with bias, biased projections,
    rotary over 32 of 128 dims, exact gelu, parallel residual with two
    norms, untied head) at its published widths and full depth, from its
    ``config.json`` values through the port's ``hf_compat`` mapping, bf16,
    random weights from seed 0: ``model_neox`` (the paged forward through
    K2 and K1 against the no-cache forward, the f32 forward of the same
    weights the yardstick of bf16 noise), ``engine_neox`` (the ``engine``
    line's engine and requests: K1 32 launches a decode step, K2 32 a
    chunk, every token within the noise margin) and its ``sync_eager``
    twin, whose tokens must be identical.  Returns ``engine_neox``'s
    launches."""
    from accelerate_tpu_torch.models.hf_compat import PYTHIA_6_9B, config_from_hf_dict
    from accelerate_tpu_torch.models.transformer import state_dict_shapes

    cfg = config_from_hf_dict(PYTHIA_6_9B, dtype=torch.bfloat16)
    params = sum(int(np.prod(shape)) for shape in state_dict_shapes(cfg).values())
    check((cfg.norm_type, cfg.use_bias, cfg.rope_dim, cfg.parallel_residual, cfg.shared_norm,
           cfg.mlp_variant, cfg.tie_word_embeddings, cfg.resolved_head_dim) ==
          ("layernorm", True, 32, True, False, "gelu_exact", False, 128),
          f"pythia-6.9b mapped to an unexpected config: {cfg}")
    emit({"phase": "neox_config", "source": "EleutherAI/pythia-6.9b config.json",
          "config": {k: str(v) if isinstance(v, torch.dtype) else v
                     for k, v in dataclasses.asdict(cfg).items()},
          "params": params, "weights_gb": 2 * params / 1e9})
    model = family_model(cfg)
    rng = np.random.default_rng(0)
    tol = model_phase(model, cfg, rng, name="model_neox")
    launches, prompts, tokens = engine_phase(model, cfg, rng, gpu, tol, name="engine_neox")
    _, _, eager = engine_phase(model, cfg, rng, gpu, tol, prompts=prompts,
                               name="engine_neox_sync_eager", eager=True)
    check(eager == tokens, "engine_neox_sync_eager's greedy tokens differ from engine_neox's")
    del model
    free_card()
    return launches


def gpt2_phase(gpu) -> dict:
    """``TransformerConfig.gpt2()`` at full width and depth (12 layers, 12
    heads of D 64, learned positions, tied head, tanh gelu), bf16, random
    weights from seed 0: ``model_gpt2`` and ``engine_gpt2`` (the engine
    line's engine at ``max_len=1024``, its learned table's length, and six
    prompts of ``GPT2_LENS``).  Returns the engine's launches."""
    from accelerate_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig.gpt2(dtype=torch.bfloat16)
    model = family_model(cfg)
    rng = np.random.default_rng(1)
    tol = model_phase(model, cfg, rng, name="model_gpt2")
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in GPT2_LENS]
    launches, _, _ = engine_phase(model, cfg, rng, gpu, tol, prompts=prompts,
                                  name="engine_gpt2", knobs=dict(max_len=1024))
    del model
    free_card()
    return launches


_FAMILY_BASE = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=2,
                    num_heads=16, num_kv_heads=16, max_seq_len=2048)
_GPT2_SW = dict(norm_type="layernorm", use_bias=True, positional="learned", mlp_variant="gelu",
                tie_word_embeddings=True, num_heads=32, num_kv_heads=32)
_GPTJ_SW = dict(norm_type="layernorm", rope_interleaved=True, rope_dim=64,
                parallel_residual=True, shared_norm=True, attn_bias=False, mlp_bias=True,
                lm_head_bias=True, mlp_variant="gelu")
#: each mapped family's switches at hidden 2048 and 2 layers (D 128 over 16
#: heads, D 64 over 32); the last three take the plain paged versions
FAMILY_SWITCHES = {
    "llama_biased": dict(attn_bias=True, mlp_bias=True, num_kv_heads=4),
    "gpt2": _GPT2_SW,
    "opt": dict(_GPT2_SW, pos_offset=2, mlp_variant="relu"),
    "gptj": _GPTJ_SW,
    "gpt_neox": dict(norm_type="layernorm", rope_dim=32, parallel_residual=True,
                     use_bias=True, mlp_variant="gelu_exact"),
    "qwen2": dict(qkv_bias=True, num_kv_heads=2),
    "gemma_d128": dict(norm_unit_offset=True, embed_scale=True, mlp_variant="geglu",
                       tie_word_embeddings=True, num_kv_heads=1),
    "falcon_mq": dict(norm_type="layernorm", mlp_variant="gelu_exact", parallel_residual=True,
                      shared_norm=True, num_heads=32, num_kv_heads=1),
    "stablelm": dict(norm_type="layernorm", rope_dim=32, qkv_bias=True, num_kv_heads=4),
    "gpt_bigcode": dict(_GPT2_SW, num_kv_heads=1),
    "phi": dict(norm_type="layernorm", use_bias=True, lm_head_bias=True, mlp_variant="gelu",
                parallel_residual=True, shared_norm=True, rope_dim=64),
    "codegen": dict(_GPTJ_SW, rope_dim=32, use_bias=False),
    "mistral_window256": dict(sliding_window=256, num_kv_heads=4),
    "bloom_alibi": dict(norm_type="layernorm", use_bias=True, positional="alibi",
                        embed_norm=True, mlp_variant="gelu", tie_word_embeddings=True),
    "mpt_alibi": dict(norm_type="layernorm", norm_bias=False, positional="alibi",
                      mlp_variant="gelu_exact", tie_word_embeddings=True, num_heads=32,
                      num_kv_heads=32),
}


def paged_logits(model, cfg, ids: np.ndarray, plain: bool) -> torch.Tensor:
    """Logits of ``ids`` (a 512-token prompt, then 8 tokens fed one at a
    time) through the paged path: the prompt as one prefill chunk, then 8
    decode steps, over a fresh pool of 128-token pages; K2 and K1, or with
    ``plain`` their plain versions."""
    from accelerate_tpu_torch.models.transformer import PagedKVCache
    from accelerate_tpu_torch.serving import PagedKVPool

    pool = PagedKVPool(cfg, 1, 1024, 128, 9, device="cuda")
    cache = PagedKVCache(
        pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales,
        tables=torch.arange(1, 9, dtype=torch.int32, device="cuda")[None],
        index=torch.zeros(1, dtype=torch.int32, device="cuda"),
        active=torch.ones(1, dtype=torch.bool, device="cuda"), kernel="prefill", plain=plain)
    feed = torch.from_numpy(ids[None]).cuda()
    out = []
    with torch.inference_mode():
        logits, cache = model(feed[:, :512], cache=cache)
        out.append(logits[0])
        cache.kernel = "decode"
        for i in range(512, ids.shape[0]):
            logits, cache = model(feed[:, i:i + 1], cache=cache)
            out.append(logits[0])
    return torch.cat(out)


def families_phase(gpu) -> None:
    """Every family of ``FAMILY_SWITCHES`` at hidden 2048 and 2 layers, bf16,
    random weights: for the full-causal ones the paged forward through K2
    and K1 (2 and 16 launches) held against the same forward through their
    plain versions; for the sliding-window and alibi ones (which the
    kernels refuse, as the reference's) the plain paged forward, K1 and K2
    launched 0 times, held against the no-cache forward.  The tolerance is
    ``LOGIT_TOL_FACTOR`` times the bf16 no-cache forward's distance from the
    f32 one of the same weights, as for the model line."""
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.ops import paged_attention as pa

    records = []
    for i, (family, sw) in enumerate(FAMILY_SWITCHES.items()):
        cfg = TransformerConfig(**{**_FAMILY_BASE, **sw, "dtype": torch.bfloat16})
        model = family_model(cfg, seed=100 + i)
        ids = np.random.default_rng(100 + i).integers(1, cfg.vocab_size, 520).astype(np.int32)
        ref = no_cache_logits(model, ids)
        model32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32), device="cuda",
                              dtype=torch.float32)
        model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()},
                                assign=True)
        noise = (ref - no_cache_logits(model32, ids)).abs().max().item()
        del model32
        tol = LOGIT_TOL_FACTOR * noise
        kernels = cfg.full_causal
        pa.reset_launch_counts()
        got = paged_logits(model, cfg, ids, plain=not kernels)
        launches = {"paged_attention": pa.paged_attention.launches,
                    "paged_flash_prefill": pa.paged_flash_prefill.launches}
        want = paged_logits(model, cfg, ids, plain=True) if kernels else ref
        err = (got - want).abs().max().item()
        rec = {"family": family, "switches": sw, "head_dim": cfg.resolved_head_dim,
               "heads": [cfg.num_heads, cfg.num_kv_heads],
               "path": "K2 + K1" if kernels else "plain paged",
               "held_against": "plain paged" if kernels else "no-cache forward",
               "max_abs_logit_err": err, "tolerance": tol, "plain_bf16_vs_f32": noise,
               "launches": launches}
        records.append(rec)
        want_launches = ({"paged_attention": 8 * cfg.num_layers,
                          "paged_flash_prefill": cfg.num_layers} if kernels
                         else {"paged_attention": 0, "paged_flash_prefill": 0})
        check(launches == want_launches, f"families {family}: launches {launches}, want "
              f"{want_launches}")
        check(bool(torch.isfinite(got).all()), f"families {family}: non-finite logits")
        check(err <= tol, f"families {family}: paged logits differ by {err} > {tol}")
        del model
        free_card()
    emit({"phase": "families", "hidden": 2048, "layers": 2, "prompt": 512, "decode_steps": 8,
          "records": records, "gpu": gpu})


def flash_inputs(seed, b, s, hq, hkv, d, dtype, segmented):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, dout = (torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    seg = None
    if segmented:
        # three packed sequences per row, cut at different places in each row
        cuts = torch.tensor([[s // 4, s // 2], [s // 3, (3 * s) // 4]], device="cuda")[:b]
        pos = torch.arange(s, device="cuda")
        seg = (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32).contiguous()
    return q, k, v, dout, seg


def visible_pairs(b, s, causal, seg) -> int:
    """(query, key) pairs this run's mask lets through, per head, summed over
    the batch: the work the kernels must do for these inputs."""
    if seg is None:
        per_row = s * (s + 1) // 2 if causal else s * s
        return b * per_row
    total = 0
    for row in seg.cpu().numpy():
        _, lengths = np.unique(row, return_counts=True)
        total += int(sum(n * (n + 1) // 2 if causal else n * n for n in lengths))
    return total


def flash_bound_ms(name, b, s, hq, hkv, d, dtype, pairs, segmented) -> tuple:
    """Least time: every input read once and every output written once, or
    4 / 6 / 8 x D flops per visible pair (K3 / K4 / K5) at the dtype's peak."""
    elem = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, stat_bytes = b * s * hq * d * elem, b * s * hkv * d * elem, b * hq * s * 4
    seg_bytes = b * s * 4 if segmented else 0
    nbytes, flops_per_pair = {
        "k3": (q_bytes + 2 * kv_bytes + q_bytes + stat_bytes + seg_bytes, 4),
        "k4": (2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes + q_bytes, 6),
        "k5": (2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes + 2 * kv_bytes, 8),
    }[name]
    flops = flops_per_pair * d * hq * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_call(q, k, v, dout, causal, backward):
    """``scaled_dot_product_attention`` on the same values in its own
    contiguous BHSD layout, as a call to time: its forward computes K3's
    function, its backward K4's and K5's together."""
    import torch.nn.functional as F

    gqa = q.shape[2] != k.shape[2]
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(backward)
                  for t in (q, k, v))
    if not backward:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    grad = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), grad, retain_graph=True)


def tile_rel_err(got, want, tile=64) -> float:
    """Largest ``||got - want|| / ||want||`` over the tiles of ``tile``
    positions of one head of one batch row of ``[B, S, H, D]`` tensors: 0
    on a tile where both are 0, infinite where only the plain value is."""
    pad = (0, 0, 0, 0, 0, (-want.shape[1]) % tile)
    sums = []
    for x in (got.float() - want.float(), want.float()):
        x = torch.nn.functional.pad(x, pad)
        b, s, h, d = x.shape
        sums.append(x.reshape(b, s // tile, tile, h, d).square().sum(dim=(2, 4)))
    err, ref = sums
    return torch.where(err == 0, torch.zeros_like(err), (err / ref).sqrt()).max().item()


def flash_design(dtype) -> str:
    """How a flash kernel computes: the bf16 arms of K3, K4 and K5 on the
    tensor cores (wgmma), every f32 arm on the CUDA cores."""
    return "wgmma" if dtype == torch.bfloat16 else "cuda-cores"


def flash_case(label, seed, b, s, hq, hkv, dtype, causal, segmented, d=128) -> dict:
    """K3, K4 and K5 against their plain versions on one case (the same
    inputs to both: the plain forward's lse and delta feed both backward
    versions); one record per kernel."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, seg = flash_inputs(seed, b, s, hq, hkv, d, dtype, segmented)
    kw = dict(causal=causal, segment_ids=seg)
    counters = {"k3": fa.flash_fwd, "k4": fa.flash_dq, "k5": fa.flash_dkv}
    launches0 = {name: fn.launches for name, fn in counters.items()}
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    args = (q, k, v, dout, ref_lse, fa.flash_delta(ref_out, dout))
    pairs = visible_pairs(b, s, causal, seg)

    def held(got, want, rel=FLASH_REL_TOL[dtype]):
        err = (got.float() - want.float()).abs().max().item()
        return err, rel * max(want.float().abs().max().item(), 1.0)

    out, lse = fa.flash_fwd(q, k, v, **kw)
    dq = fa.flash_dq(*args, **kw)
    dk, dv = fa.flash_dkv(*args, **kw)
    ref_dq = fa.flash_dq_reference(*args, **kw)
    ref_dk, ref_dv = fa.flash_dkv_reference(*args, **kw)
    checks = {
        "k3": {"out": held(out, ref_out), "lse": held(lse, ref_lse, FLASH_REL_TOL[torch.float32])},
        "k4": {"dq": held(dq, ref_dq)},
        "k5": {"dk": held(dk, ref_dk), "dv": held(dv, ref_dv)},
    }
    tiled = {
        "k3": {"out": tile_rel_err(out, ref_out)},
        "k4": {"dq": tile_rel_err(dq, ref_dq)},
        "k5": {"dk": tile_rel_err(dk, ref_dk), "dv": tile_rel_err(dv, ref_dv)},
    }
    tile_tol = FLASH_TILE_TOL[dtype]
    repeat_dk, repeat_dv = fa.flash_dkv(*args, **kw)
    bitwise = {"k4": torch.equal(dq, fa.flash_dq(*args, **kw)),
               "k5": torch.equal(dk, repeat_dk) and torch.equal(dv, repeat_dv)}
    timings = {
        "k3": (lambda: fa.flash_fwd(q, k, v, **kw),
               lambda: fa.flash_attention_reference(q, k, v, **kw), False, "flash_fwd"),
        "k4": (lambda: fa.flash_dq(*args, **kw),
               lambda: fa.flash_dq_reference(*args, **kw), True, "flash_dq"),
        "k5": (lambda: fa.flash_dkv(*args, **kw),
               lambda: fa.flash_dkv_reference(*args, **kw), True, "flash_dkv"),
    }
    records = {}
    for name, (kernel, plain, backward, fragment) in timings.items():
        errs = checks[name]
        # the kernels line carries the binding check: the largest err / tolerance
        worst = max(errs.values(), key=lambda et: et[0] / et[1])
        bms, by = flash_bound_ms(name, b, s, hq, hkv, d, dtype, pairs, segmented)
        rec = dict(
            case=label, dtype=str(dtype).replace("torch.", ""), b=b, s=s, hq=hq, hkv=hkv, d=d,
            causal=causal, segmented=segmented, visible_pairs=pairs,
            design=flash_design(dtype),
            errors={key: e for key, (e, _) in errs.items()},
            tolerances={key: t for key, (_, t) in errs.items()},
            max_abs_err=worst[0], tolerance=worst[1],
            tile_rel_errors=tiled[name], tile_tolerance=tile_tol,
            ms=device_ms(kernel, 10, fragment), wall_ms=time_ms(kernel, 10),
            plain_ms=time_ms(plain, 3, warmup=1), bound_ms=bms, bound_by=by,
        )
        library = None if segmented else library_call(q, k, v, dout, causal, backward)
        rec["library_ms"] = library and device_ms(library, 10)
        # the case's own launches: the checked calls, then the timing loop
        rec["launches"] = counters[name].launches - launches0[name]
        if name in bitwise:
            rec["bitwise_repeatable"] = bitwise[name]
        emit({"phase": name, **rec})
        for key, (err, tol) in errs.items():
            check(err <= tol, f"{name} {label}: {key} max abs err {err} > tolerance {tol}")
        for key, err in tiled[name].items():
            check(err <= tile_tol, f"{name} {label}: {key} tile relative err {err} > {tile_tol}")
        check(bitwise.get(name, True), f"{name} {label}: two runs gave different bits")
        records[name] = rec
    return records


def flash_phase(cases):
    """Every case through :func:`flash_case`; returns each kernel's record of
    the first (training-shape bf16) case."""
    first = {}
    for case in cases:
        for name, rec in flash_case(*case).items():
            first.setdefault(name, rec)
        torch.cuda.empty_cache()
    return first


# -------------------------------------------------------------------- train
def attention_path_check(accelerator, model, cfg, batch):
    """One micro-step of one sequence through the flash path and the xla
    path (the train step with accumulation 2 only accumulates on its first
    call), against an f32 xla run of the same weights."""
    from accelerate_tpu_torch.models.transformer import Transformer, lm_loss_fn

    params = list(model.parameters())
    results = {}
    for impl in ("xla", "pallas"):
        # the flash model is the trained one; the xla twin holds no weights
        # (meta) and runs on the masters through functional_call
        twin = model if impl == "pallas" else Transformer(
            dataclasses.replace(cfg, attention_impl=impl), device="meta")
        state = accelerator.create_train_state(
            params=model, tx=functools.partial(torch.optim.AdamW, lr=0.0))
        _, m = accelerator.compile_train_step(lm_loss_fn(twin))(state, batch)
        check(not bool(m["applied"]), "the check's micro-step applied an update")
        results[impl] = (m["loss"].item(), torch.cat([p.grad.reshape(-1) for p in params]))
        state.optimizer.zero_grad(set_to_none=True)
    (loss_x, g_x), (loss_p, g_p) = results.pop("xla"), results.pop("pallas")
    twin32 = Transformer(dataclasses.replace(cfg, attention_impl="xla", dtype=torch.float32),
                         device="meta")
    loss32 = lm_loss_fn(twin32)(dict(model.named_parameters()), batch)
    sq_diff = sq_ref = 0.0
    offset = 0
    for g in torch.autograd.grad(loss32, params):
        part = g_x[offset:offset + g.numel()]
        sq_diff += (part - g.reshape(-1)).square().sum().item()
        sq_ref += g.square().sum().item()
        offset += g.numel()
    noise_grad = (sq_diff / sq_ref) ** 0.5
    noise_loss = abs(loss_x - loss32.item())
    rec = {
        "tokens": int(batch["input_ids"].numel()),
        "loss_flash": loss_p, "loss_xla": loss_x, "loss_f32": loss32.item(),
        "loss_err": abs(loss_p - loss_x), "loss_noise_bf16_vs_f32": noise_loss,
        "loss_tolerance": max(TRAIN_TOL_FACTOR * noise_loss, TRAIN_LOSS_TOL_FLOOR),
        "grad_rel_err": ((g_p - g_x).norm() / g_x.norm()).item(),
        "grad_noise_bf16_vs_f32": noise_grad,
        "grad_tolerance": TRAIN_TOL_FACTOR * noise_grad,
        "grad_cosine": torch.nn.functional.cosine_similarity(g_p, g_x, dim=0).item(),
    }
    del g_x, g_p
    torch.cuda.empty_cache()
    return rec


TRAIN_LAYERS, TRAIN_ROWS, TRAIN_SEQ = 8, 2, 2048
# the Llama-2 recipe: AdamW(0.9, 0.95), eps 1e-5, weight decay 0.1 (and clip 1.0)
LLAMA2_ADAMW = functools.partial(torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.95), eps=1e-5,
                                 weight_decay=0.1)


def train_config(layers: int):
    from accelerate_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig.llama2_7b(num_layers=layers, dtype=torch.bfloat16,
                                       param_dtype=torch.float32, attention_impl="pallas")


def train_model(cfg, seed: int):
    """f32 masters on the card from ``init_params(seed)``."""
    from accelerate_tpu_torch.models.transformer import Transformer
    from accelerate_tpu_torch.weights import init_params

    model = Transformer(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(init_params(cfg, seed=seed, device="cuda", dtype=torch.float32),
                          assign=True)
    return model


def train_data(cfg):
    """Two random batches A and B of 2 x 2048 tokens, and the loader's
    dataset A B A B ... (8 batches)."""
    rng = np.random.default_rng(7)
    a, b = (rng.integers(1, cfg.vocab_size, (TRAIN_ROWS, TRAIN_SEQ)).astype(np.int32)
            for _ in range(2))
    return a, [{"input_ids": r} for _ in range(4) for r in (*a, *b)]


def train_phase(gpu):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.models.transformer import lm_loss_fn, state_dict_shapes
    from accelerate_tpu_torch.ops import flash_attention as fa

    layers, rows, seq = TRAIN_LAYERS, TRAIN_ROWS, TRAIN_SEQ
    cfg = train_config(layers)
    model = train_model(cfg, seed=0)
    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    a, dataset = train_data(cfg)
    path_check = attention_path_check(
        accelerator, model, cfg, {"input_ids": torch.from_numpy(a[:1]).cuda()})

    state = accelerator.create_train_state(params=model, tx=LLAMA2_ADAMW)
    step = accelerator.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    loader = accelerator.prepare(SimpleDataLoader(dataset, batch_size=rows))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    metrics, step_s = [], []
    for batch in loader:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = {"flash_fwd": fa.flash_fwd.launches, "flash_dq": fa.flash_dq.launches,
                "flash_dkv": fa.flash_dkv.launches}
    peak = torch.cuda.max_memory_allocated()
    host = [{k: v.item() for k, v in m.items()} for m in metrics]
    micro = len(host)

    # model FLOPs of a micro-step: 6 x matrix parameters x tokens (the
    # embedding is a gather, not a product) plus 3 x the attention forward
    # (4 D flops per visible (query head, key) pair; the backward is twice
    # the forward)
    tokens = rows * seq
    matrix_params = sum(int(np.prod(shape)) for name, shape in state_dict_shapes(cfg).items()
                        if name.endswith("proj.weight") or name == "lm_head.weight")
    attn_fwd = 4 * cfg.resolved_head_dim * cfg.num_heads * layers * rows * seq * (seq + 1) // 2
    flops = 6 * matrix_params * tokens + 3 * attn_fwd
    # a micro-step's share of an optimizer step (accumulate + apply), the
    # median over the optimizer steps after the first (where AdamW allocates
    # its moments), so that one slow step does not set it
    steady = float(np.median([(step_s[i] + step_s[i + 1]) / 2
                              for i in range(2, micro - 1, 2)]))
    applied = [h for h in host if h["applied"]]
    rec = {
        "phase": "train", "config": "llama2_7b", "layers": layers, "of_layers": 32,
        "params": sum(p.numel() for p in model.parameters()), "matrix_params": matrix_params,
        "micro_steps": micro, "optimizer_steps": state.step, "tokens_per_micro_step": tokens,
        "loss": [h["loss"] for h in host], "grad_norm": [h["grad_norm"] for h in host],
        "applied": [bool(h["applied"]) for h in host], "launches": launches,
        "first_step_ms": step_s[0] * 1e3, "step_ms": steady * 1e3,
        "step_ms_mean": float(np.mean(step_s[1:])) * 1e3,
        "step_ms_each": [t * 1e3 for t in step_s], "card_after": card_state(),
        "tokens_per_s": tokens / steady, "model_flops_per_micro_step": flops,
        "mfu_vs_989_tflops": flops / steady / PEAK_FLOPS[torch.bfloat16],
        "max_memory_allocated_gb": peak / 1e9, "path_check": path_check, "gpu": gpu,
    }
    emit(rec)
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in host),
          "a loss or grad norm is not finite")
    check([bool(h["applied"]) for h in host] == [i % 2 == 1 for i in range(micro)],
          "applied is not true on exactly every second call")
    check(state.step == micro // 2, f"{state.step} optimizer steps, want {micro // 2}")
    check(applied[-1]["loss"] < applied[0]["loss"],
          f"the last applied step's loss {applied[-1]['loss']} is not below the first's "
          f"{applied[0]['loss']} on the repeating batch")
    for name, n in launches.items():
        check(n == micro * layers, f"{name} launched {n} times, want {micro} x {layers}")
    check(path_check["loss_err"] <= path_check["loss_tolerance"],
          f"flash vs xla loss differ by {path_check['loss_err']}")
    check(path_check["grad_rel_err"] <= path_check["grad_tolerance"],
          f"flash vs xla gradients differ by {path_check['grad_rel_err']} (relative)")
    return launches, rec


def reference_loop_call(accelerator, state, loss_fn):
    """One call of the reference's loop shape (``compute_gradients`` +
    ``apply_gradients(max_grad_norm=1.0)`` inside ``accumulate()``) as
    ``call(batch) -> (loss, grad_norm, seconds)``: ``grad_norm`` is the
    norm of the window's running average, as ``compile_train_step``
    reports it, read between the two calls (one parameter at a time) and
    left out of ``seconds``."""

    def call(batch):
        with accelerator.accumulate():
            t0 = time.perf_counter()
            grads, m = accelerator.compute_gradients(loss_fn, state, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                sq = sum(torch.linalg.vector_norm(g if p.grad is None else p.grad + g).square()
                         for (_, g), p in zip(grads.items(), state.model.parameters()))
            norm = sq.sqrt().item() / (state.micro_step + 1)
            t2 = time.perf_counter()
            accelerator.apply_gradients(state, grads, max_grad_norm=1.0)
            del grads
            torch.cuda.synchronize()
            seconds = (t1 - t0) + (time.perf_counter() - t2)
        return m["loss"].item(), norm, seconds

    return call


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_api_phase(gpu, train_rec):
    """The reference's loop shape on ``train``'s model, batches and recipe:
    a fresh model from the same seed, 8 micro-steps through
    ``compute_gradients`` + ``apply_gradients``, held call by call against
    ``train``'s losses and grad norms."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.models.transformer import lm_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa

    free_card()
    cfg = train_config(TRAIN_LAYERS)
    model = train_model(cfg, seed=0)
    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    state = accelerator.create_train_state(params=model, tx=LLAMA2_ADAMW)
    loader = accelerator.prepare(SimpleDataLoader(train_data(cfg)[1], batch_size=TRAIN_ROWS))
    call = reference_loop_call(accelerator, state, lm_loss_fn(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    host = [call(batch) for batch in loader]
    launches = {"flash_fwd": fa.flash_fwd.launches, "flash_dq": fa.flash_dq.launches,
                "flash_dkv": fa.flash_dkv.launches}
    peak = torch.cuda.max_memory_allocated()
    micro = len(host)
    losses, norms, step_s = (list(col) for col in zip(*host))
    steady = float(np.median([(step_s[i] + step_s[i + 1]) / 2
                              for i in range(2, micro - 1, 2)]))
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(losses, train_rec["loss"]))
    norm_err = max(abs(x - y) / abs(y) for x, y in zip(norms, train_rec["grad_norm"]))
    rec = {
        "phase": "train_api", "config": "llama2_7b", "layers": TRAIN_LAYERS, "of_layers": 32,
        "micro_steps": micro, "optimizer_steps": state.step, "loss": losses, "grad_norm": norms,
        "loss_train": train_rec["loss"], "grad_norm_train": train_rec["grad_norm"],
        "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
        "tolerance": TRAIN_API_REL_TOL, "launches": launches,
        "step_ms": steady * 1e3, "step_ms_each": [t * 1e3 for t in step_s],
        "step_ms_train": train_rec["step_ms"], "max_memory_allocated_gb": peak / 1e9,
        "max_memory_allocated_gb_train": train_rec["max_memory_allocated_gb"], "gpu": gpu,
    }
    emit(rec)
    check(state.step == micro // 2 and state.micro_step == 0,
          f"{state.step} optimizer steps and micro_step {state.micro_step} after {micro} calls")
    check(loss_err <= TRAIN_API_REL_TOL and norm_err <= TRAIN_API_REL_TOL,
          f"the reference loop's losses / grad norms differ from train's by {loss_err} / "
          f"{norm_err} (relative), over {TRAIN_API_REL_TOL}")
    check(peak < 80e9, f"peak memory {peak / 1e9} GB")
    for name, n in launches.items():
        check(n == micro * TRAIN_LAYERS, f"{name} launched {n} times, want {micro} x "
              f"{TRAIN_LAYERS}")
    del model, state, loader, call, accelerator
    free_card()
    return launches


def checkpoint_phase(gpu):
    """Full width at 2 of 32 layers through the reference loop: 3 calls at
    accumulation 2, ``save_state`` mid-window, ``load_state`` into a fresh
    accelerator and a state made from another seed, 3 more calls, against
    an uninterrupted run of 6 (run twice: the card's own spread); then the
    bf16 safetensors export, read back."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.checkpointing import load_model_params
    from accelerate_tpu_torch.models.transformer import lm_loss_fn
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    layers = 2
    cfg = train_config(layers)
    rng = np.random.default_rng(8)
    batches = [{"input_ids": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (TRAIN_ROWS, TRAIN_SEQ)).astype(np.int32)).cuda()} for _ in range(6)]

    def trainer(seed):
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)
        model = train_model(cfg, seed=seed)
        accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
        state = accelerator.create_train_state(params=model, tx=LLAMA2_ADAMW)
        return accelerator, state, reference_loop_call(accelerator, state, lm_loss_fn(model))

    def finals(state):
        return [p.detach().clone() for p in state.model.parameters()]

    runs = []
    for _ in range(2):
        _, state, call = trainer(0)
        runs.append(([call(b)[:2] for b in batches], finals(state)))
        del state, call
        free_card()
    (whole, want), (again, want_again) = runs
    repeatable = whole == again and all(torch.equal(x, y) for x, y in zip(want, want_again))
    del runs, want_again

    params_bytes = sum(p.numel() * 4 for p in want)
    need = 4 * params_bytes + params_bytes // 2 + 2 * 2**30  # f32 state + bf16 export + margin
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    check(free >= need, f"{tmp} has {free / 1e9:.1f} GB free; the checkpoint phase needs "
          f"{need / 1e9:.1f} GB")
    root = tempfile.mkdtemp(prefix="atpu_checkpoint_", dir=tmp)
    try:
        accelerator, state, call = trainer(0)
        first = [call(b)[:2] for b in batches[:3]]
        check(state.micro_step == 1, f"micro_step {state.micro_step} at the save, want 1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = accelerator.save_state(os.path.join(root, "ckpt"), state=state)
        save_s = time.perf_counter() - t0
        state_bytes = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, files in os.walk(out) for f in files)
        del accelerator, state, call
        free_card()

        accelerator, state, call = trainer(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accelerator.load_state(out, state=state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        moments_on_card = all(s["exp_avg"].is_cuda and s["exp_avg_sq"].is_cuda
                              for s in state.optimizer.state.values())
        rest = [call(b)[:2] for b in batches[3:]]
        resumed_equal = first + rest == whole and all(
            torch.equal(p, w) for p, w in zip(state.model.parameters(), want))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        files = accelerator.save_model(state, os.path.join(root, "export"),
                                       max_shard_size="1GB", save_dtype=torch.bfloat16)
        export_s = time.perf_counter() - t0
        export_bytes = sum(os.path.getsize(f) for f in files)
        t0 = time.perf_counter()
        back = load_model_params(os.path.join(root, "export"), target=state)
        import_s = time.perf_counter() - t0
        export_equal = all(torch.equal(back[name], p.detach().to(torch.bfloat16).cpu())
                           for name, p in state.model.named_parameters())
        del accelerator, state, call, back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_card()
    rec = {
        "phase": "checkpoint", "config": "llama2_7b", "layers": layers, "of_layers": 32,
        "uninterrupted": whole, "resumed": first + rest, "repeatable": repeatable,
        "resumed_bitwise": resumed_equal, "moments_on_card": moments_on_card,
        "train_state_bytes": state_bytes, "save_s": save_s, "load_s": load_s,
        "save_gb_per_s": state_bytes / save_s / 1e9, "load_gb_per_s": state_bytes / load_s / 1e9,
        "export_files": len(files), "export_bytes": export_bytes, "export_s": export_s,
        "import_s": import_s, "export_gb_per_s": export_bytes / export_s / 1e9,
        "import_gb_per_s": export_bytes / import_s / 1e9, "export_bitwise": export_equal,
        "disk_free_gb": free / 1e9, "gpu": gpu,
    }
    emit(rec)
    check(repeatable, "two uninterrupted runs of the checkpoint phase differ")
    check(resumed_equal, "the resumed run differs from the uninterrupted one")
    check(moments_on_card, "AdamW's moments did not load onto the card")
    check(len(files) >= 2, f"the 1GB-shard export wrote {len(files)} file(s)")
    check(export_equal, "the bf16 export read back differs from the masters cast to bf16")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on the card",
              file=sys.stderr)
        return 1
    from accelerate_tpu_torch.models.transformer import TransformerConfig
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving.spec_exec import TreeSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(gpu, flush=True)
    _build.load()
    spills = spilling_kernels(_build.build_logs)
    emit({"phase": "device", "gpu": gpu, "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": _build.build_seconds, "build_s_by_library": _build.build_times,
          "spills": spills})
    check(sorted(_build.build_logs) == sorted(_build.KERNELS),
          f"ptxas reports for {sorted(_build.build_logs)}, want every library")
    tc_entries = set(re.findall(r"Compiling entry function '(\w*wgmma\w*)'",
                                "".join(_build.build_logs.values())))
    check(len(tc_entries) == 12, f"ptxas reports {len(tc_entries)} tensor-core kernels, want "
          "12 (K2 over bf16, int8 and fp8 pages, K3, K4 and K5, each at D 64 and 128)")
    check(not [k for k in spills if "wgmma" in k],
          "a tensor-core kernel spills registers to local memory")

    bf16, f32 = torch.bfloat16, torch.float32
    ragged = [5, 700, 1500, 2040]  # a lane on its first page ... a nearly full lane
    engine_lanes = [57, 384, 700, 1000]  # as the engine's decode steps hold them
    tree_lanes = [5, 700, 1500, 2000]
    tree24 = TreeSpec(2, 4).anc  # the engine_tree phase's tree: 9 nodes
    k1 = kernel_phase("k1", pa.paged_attention, pa.paged_attention_reference, "paged_decode", [
        ("main", 1, ragged, 1, 32, 32, bf16, 128),
        ("main", 2, ragged, 1, 32, 32, f32, 128),
        ("gqa", 3, ragged, 1, 32, 8, bf16, 128),
        ("gqa", 4, ragged, 1, 32, 8, f32, 128),
        # the split walk cut raggedly: an empty lane beside a full one, the
        # page edges, 128 pages of 16 over many splits, a verify span whose
        # early rows see none of a late split's keys (gs 12), D 64
        ("len0_2040", 21, [0, 2040], 1, 32, 32, bf16, 128),
        ("page_edges", 22, [127, 128, 255], 1, 32, 32, bf16, 128),
        ("page16", 23, [5, 2040], 1, 32, 32, bf16, 16),
        ("verify3_gqa", 24, ragged, 3, 32, 8, bf16, 128),
        ("gqa_d64", 25, ragged, 1, 32, 8, bf16, 128, 64),
        ("page16", 26, [5, 2040], 1, 32, 32, f32, 16),
        ("verify3_gqa", 27, ragged, 3, 32, 8, f32, 128),
        ("gqa_d64", 28, ragged, 1, 32, 8, f32, 128, 64),
        # the dequant arm: int8 and fp8-e4m3 pages written by the port's own
        # quantized insert, dead slots poisoned (NaN codes / NaN scales)
        ("main", 31, ragged, 1, 32, 32, bf16, 128, 128, "int8"),
        ("main", 32, ragged, 1, 32, 32, bf16, 128, 128, "fp8"),
        ("engine", 33, engine_lanes, 1, 32, 32, bf16, 128, 128, "int8"),
        ("engine", 34, engine_lanes, 1, 32, 32, bf16, 128, 128, "fp8"),
        ("engine", 35, engine_lanes, 1, 32, 32, bf16, 128),
        ("main", 36, ragged, 1, 32, 32, f32, 128, 128, "int8"),
        ("main", 37, ragged, 1, 32, 32, f32, 128, 128, "fp8"),
        ("gqa", 38, ragged, 1, 32, 8, bf16, 128, 128, "int8"),
        # past 32 folded rows: GQA 8 verifying 5 (40 rows), rep 2 at S 17 (34)
        ("rows40_rep8_s5", 39, ragged, 5, 32, 4, bf16, 128),
        ("rows34_rep2_s17", 40, [5, 700, 1500, 2000], 17, 32, 16, bf16, 128),
        ("rows40_rep8_s5", 41, ragged, 5, 32, 4, f32, 128),
        ("rows34_rep2_s17", 42, [5, 700, 1500, 2000], 17, 32, 16, f32, 128),
        ("rows40_rep8_s5", 43, ragged, 5, 32, 4, bf16, 128, 128, "int8"),
        ("rows34_rep2_s17", 44, [5, 700, 1500, 2000], 17, 32, 16, bf16, 128, 128, "fp8"),
        # head dims 16 and 32, native and quantized
        ("gqa_d16", 45, ragged, 1, 32, 8, bf16, 128, 16),
        ("gqa_d32", 46, ragged, 1, 32, 8, bf16, 128, 32),
        ("gqa_d16", 47, ragged, 1, 32, 8, f32, 128, 16),
        ("gqa_d32", 48, ragged, 1, 32, 8, f32, 128, 32),
        ("gqa_d16", 49, ragged, 1, 32, 8, bf16, 128, 16, "int8"),
        ("gqa_d32", 50, ragged, 1, 32, 8, bf16, 128, 32, "fp8"),
        ("gqa_d16", 51, ragged, 1, 32, 8, f32, 128, 16, "fp8"),
        ("gqa_d32", 52, ragged, 1, 32, 8, f32, 128, 32, "int8"),
        # the tree-mask arm (tree verification), beside the causal arm at the
        # same S; the last lane holds 2000 keys, as 2040 + S would overrun
        # the 2048 keys of its table
        ("tree_main", 70, tree_lanes, 9, 32, 32, bf16, 128, 128, None, tree24),
        ("tree_main", 71, tree_lanes, 9, 32, 32, f32, 128, 128, None, tree24),
        ("verify9_main", 72, tree_lanes, 9, 32, 32, bf16, 128),
        ("verify5_main", 73, tree_lanes, 5, 32, 32, bf16, 128),
        ("tree_engine", 74, engine_lanes, 9, 32, 32, bf16, 128, 128, None, tree24),
        ("tree_gqa_rows40", 75, tree_lanes, 10, 32, 8, bf16, 128, 128, None,
         TreeSpec(3, 3).anc),
        ("tree32", 76, tree_lanes, 32, 32, 32, bf16, 128, 128, None, TreeSpec(31, 1).anc),
        ("tree32", 77, tree_lanes, 32, 32, 8, f32, 128, 128, None, TreeSpec(31, 1).anc),
        ("tree_random20", 78, tree_lanes, 20, 32, 8, bf16, 128, 128, None, random_tree(78, 20)),
        ("tree_page_edge", 79, [127, 128], 9, 32, 32, bf16, 128, 128, None, tree24),
        ("tree_main", 80, tree_lanes, 9, 32, 32, bf16, 128, 128, "int8", tree24),
        ("tree_main", 81, tree_lanes, 9, 32, 32, bf16, 128, 128, "fp8", tree24),
        # the families' shapes: GPT-2 (12 heads of D 64), Falcon-7B's
        # multi-query attention (71 query heads over one kv head, D 64)
        ("gpt2_d64", 82, ragged, 1, 12, 12, bf16, 128, 64),
        ("falcon7b_mq71_d64", 83, ragged, 1, 71, 1, bf16, 128, 64),
        ("falcon7b_mq71_d64", 84, ragged, 1, 71, 1, f32, 128, 64),
    ], k1_describe, k1_checks)
    k2 = kernel_phase("k2", pa.paged_flash_prefill, pa.paged_flash_prefill_reference,
                      "paged_prefill", [
        ("chunk512_base0", 5, [0], 512, 32, 32, bf16, 128),
        ("chunk128_base640", 6, [640], 128, 32, 32, bf16, 128),
        ("chunk512_base0", 7, [0], 512, 32, 32, f32, 128),
        ("chunk128_base640", 8, [640], 128, 32, 32, f32, 128),
        ("gqa_chunk512_base0", 9, [0], 512, 32, 8, bf16, 128),
        ("gqa_chunk128_base640", 10, [640], 128, 32, 8, bf16, 128),
        ("gqa_chunk512_base0", 11, [0], 512, 32, 8, f32, 128),
        ("gqa_chunk128_base640", 12, [640], 128, 32, 8, f32, 128),
        # one box of 64 keys per tile, and four pages of 16 per tile whose
        # last tiles straddle the frontier and the NaN-filled dead pages
        ("chunk512_base0_page64", 19, [0], 512, 32, 32, bf16, 64),
        ("chunk128_base600_page16", 20, [600], 128, 32, 32, bf16, 16),
        # the dequant arm: on the tensor cores for bf16 q (codes converted to
        # bf16 tiles), on the CUDA cores for f32 q
        ("chunk512_base0", 53, [0], 512, 32, 32, bf16, 128, 128, "int8"),
        ("chunk512_base0", 54, [0], 512, 32, 32, bf16, 128, 128, "fp8"),
        ("chunk128_base640", 55, [640], 128, 32, 32, bf16, 128, 128, "int8"),
        ("chunk128_base640", 56, [640], 128, 32, 32, bf16, 128, 128, "fp8"),
        ("chunk512_base0", 57, [0], 512, 32, 32, f32, 128, 128, "int8"),
        ("chunk512_base0", 58, [0], 512, 32, 32, f32, 128, 128, "fp8"),
        ("gqa_chunk512_base0", 59, [0], 512, 32, 8, bf16, 128, 128, "int8"),
        ("chunk128_base600_page16", 60, [600], 128, 32, 32, bf16, 16, 128, "fp8"),
        ("gqa_d64_chunk128_base640", 61, [640], 128, 32, 8, bf16, 128, 64, "int8"),
        # head dims 16 and 32 on the CUDA cores, native and quantized
        ("gqa_d16_chunk128_base640", 62, [640], 128, 32, 8, bf16, 128, 16),
        ("gqa_d32_chunk128_base640", 63, [640], 128, 32, 8, f32, 128, 32),
        ("gqa_d16_chunk128_base640", 64, [640], 128, 32, 8, bf16, 128, 16, "fp8"),
        ("gqa_d32_chunk128_base640", 65, [640], 128, 32, 8, f32, 128, 32, "int8"),
        # a GQA group of 128 query heads per kv head: two q-blocks of 64 heads
        # over the same kv head's pages
        ("gqa128_chunk128_base640", 66, [640], 128, 128, 1, bf16, 128),
        ("gqa128_chunk128_base640", 67, [640], 128, 128, 1, f32, 128),
        # the families' shapes: GPT-2 and Falcon-7B's multi-query group of 71
        ("gpt2_d64_chunk512_base0", 68, [0], 512, 12, 12, bf16, 128, 64),
        ("falcon7b_mq71_d64_chunk128_base640", 69, [640], 128, 71, 1, bf16, 128, 64),
        ("falcon7b_mq71_d64_chunk128_base640", 85, [640], 128, 71, 1, f32, 128, 64),
    ], k2_describe, k2_checks)

    cfg = TransformerConfig.llama2_7b(dtype=bf16)
    model = family_model(cfg, affine_std=0.0)  # the Llama line keeps its earlier weights
    rng = np.random.default_rng(0)
    tol = model_phase(model, cfg, rng)
    for fmt in pa.KV_FORMATS:
        quantized_model_phase(model, cfg, rng, fmt, tol)
    launches, prompts, tokens = engine_phase(model, cfg, rng, gpu, tol)
    # the A/B baseline: eager windows, synchronous loop, the same requests;
    # the same kernels on the same inputs give the same greedy tokens
    _, _, eager_tokens = engine_phase(model, cfg, rng, gpu, tol, prompts=prompts,
                                      name="engine_sync_eager", eager=True)
    check(eager_tokens == tokens, "engine_sync_eager's greedy tokens differ from engine's")
    # the decode-first ordering: the same requests, chunks queued behind
    # the window of their cycle
    _, _, inter_tokens = engine_phase(
        model, cfg, rng, gpu, tol, prompts=prompts, name="engine_interleave",
        knobs=dict(interleave_prefill=True))
    check(inter_tokens == tokens, "engine_interleave's greedy tokens differ from engine's")
    cancel_phase(model, cfg, gpu, prompts, tokens)
    chunk_graph_phase(model, cfg, gpu)
    arm_launches = {fmt: engine_phase(model, cfg, rng, gpu, tol, kv_dtype=fmt)[0]
                    for fmt in pa.KV_FORMATS}
    # speculation: the tree arm on the engine line's prompts; the linear arm
    # on a random 40-token segment tiled to the same lengths, so that the
    # n-gram drafter finds matches
    tree_launches, _, _ = engine_phase(
        model, cfg, rng, gpu, tol, prompts=prompts, name="engine_tree",
        spec=dict(draft_model=8, tree_width=2, tree_depth=4, draft_ctx=64))
    segment = rng.integers(1, cfg.vocab_size, 40).astype(np.int32)
    spec_prompts = [np.resize(segment, n) for n in ENGINE_LENS]
    engine_phase(model, cfg, rng, gpu, tol, prompts=spec_prompts, name="engine_spec",
                 spec=dict(speculate_k=4))
    prefix_launches, shared_prompts = prefix_phases(model, cfg, rng, gpu)
    slab_phases(model, cfg, gpu, tol, prompts, spec_prompts, shared_prompts)
    del model
    free_card()
    # the other families: one 7B model on the card at a time
    family_launches = {"engine_neox": neox_phases(gpu), "engine_gpt2": gpt2_phase(gpu)}
    families_phase(gpu)

    flash = flash_phase([
        ("train", 13, 2, 2048, 32, 32, bf16, True, False),
        ("train", 14, 2, 2048, 32, 32, f32, True, False),
        ("gqa", 15, 2, 2048, 32, 8, bf16, True, False),
        ("segments3", 16, 2, 1024, 32, 32, bf16, True, True),
        ("full512", 17, 2, 512, 32, 32, bf16, False, False),
        ("gqa_d64", 18, 2, 2048, 32, 8, bf16, True, False, 64),
    ])
    train_launches, train_rec = train_phase(gpu)
    launches.update(train_launches)
    api_launches = train_api_phase(gpu, train_rec)
    checkpoint_phase(gpu)

    def first(records, pages, case):
        return next(r for r in records if r["pages"] == pages and r["case"] == case)

    kernels = []
    csrc = "accelerate_tpu_torch/ops/csrc/"
    arms = []
    for fmt in pa.KV_FORMATS:
        # the dequant arms, launched on their own engine run's path
        arms += [
            (first(k1, fmt, "main"), f"paged_attention[{fmt}]", csrc + "paged_attention.cu",
             "accelerate_tpu/ops/paged_attention.py:291",
             arm_launches[fmt]["paged_attention"]),
            (first(k2, fmt, "chunk512_base0"), f"paged_flash_prefill[{fmt}]",
             csrc + "paged_prefill.cu", "accelerate_tpu/ops/paged_attention.py:511",
             arm_launches[fmt]["paged_flash_prefill"]),
        ]
    for rec, name, src, replaces, count in (
        (k1[0], "paged_attention", csrc + "paged_attention.cu",
         "accelerate_tpu/ops/paged_attention.py:252", launches["paged_attention"]),
        # the tree-mask arm, launched on the tree engine's path
        (first(k1, "bfloat16", "tree_main"), "paged_attention[tree]", csrc + "paged_attention.cu",
         "accelerate_tpu/ops/paged_attention.py:300", tree_launches["paged_attention_tree"]),
        (k2[0], "paged_flash_prefill", csrc + "paged_prefill.cu",
         "accelerate_tpu/ops/paged_attention.py:479", launches["paged_flash_prefill"]),
        *arms,
        (flash["k3"], "flash_fwd", csrc + "flash_fwd.cu",
         "accelerate_tpu/ops/flash_attention.py:84", launches["flash_fwd"]),
        (flash["k4"], "flash_dq", csrc + "flash_bwd.cu",
         "accelerate_tpu/ops/flash_attention.py:278", launches["flash_dq"]),
        (flash["k5"], "flash_dkv", csrc + "flash_bwd.cu",
         "accelerate_tpu/ops/flash_attention.py:312", launches["flash_dkv"]),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": count, "max_abs_err": rec["max_abs_err"],
            "tolerance": rec["tolerance"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
        })
        for key in ("design", "pages", "arm"):
            if key in rec:
                kernels[-1][key] = rec[key]
        if name in prefix_launches:
            # the prefix cache's path, its counts zeroed just before its serve
            kernels[-1]["launches_engine_prefix"] = prefix_launches[name]
        for line, counts in family_launches.items():
            # the other families' engines, their counts zeroed just before
            if name in counts:
                kernels[-1]["launches_" + line] = counts[name]
        if name in api_launches:
            # the reference loop's path, its counts zeroed just before its calls
            kernels[-1]["launches_train_api"] = api_launches[name]
    emit({"phase": "run", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   Then the head dims of the wide- and narrow-head families at their
   decode shapes (``WIDE_HEAD_SHAPES``: Gemma-7B's 16 heads of D 256,
   Gemma-2B's 8 over one kv head, Phi-2's 32 of D 80, Phi-3-mini's 32 of D
   96), bf16 and f32 q over native, int8 and fp8 pages, and the tree arm at
   S 9 at each of D 256, 80 and 96.
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
   the same kv head's pages), and the wide-head shapes' 512-token chunk at
   base 0 under both designs over every page format, with 128-token chunks
   at D 256, 80 and 96 (the last over int8 pages of 16).
   Each record names its ``design`` (``wgmma`` for bf16 q over bf16, int8
   or fp8 pages at D 64, 80, 96, 128 and 256, ``cuda-cores`` otherwise);
   every case must
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
   The ``engine`` line's engine records into a private ``MetricsRegistry``
   and serves its debug endpoints on an ephemeral local port
   (``metrics_port=0``): after the serve ``/metrics`` (the Prometheus text
   must parse; 6 requests completed, 6 TTFT observations), ``/healthz``
   (200) and ``/debug/requests`` (six finished waterfalls) are fetched over
   HTTP; it prints ``analyze_costs()``'s decode FLOPs a token and the cost
   table's bytes a decode step beside the weights' bytes, and
   ``compiled_executable_counts()``: each at most 1, and each window's and
   chunk's count the number of its graphs the serve replayed.
   ``engine_telemetry_off``: the same serve with the telemetry switched
   off (``set_enabled(False)``): identical tokens; both lines print serve
   tokens/s (a record, not a gate).
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
   ``gemma_config``, ``model_gemma``, ``engine_gemma`` and
   ``engine_gemma_sync_eager`` the same for Gemma-7B (``hf_compat.GEMMA_7B``:
   28 layers, 16 heads of D 256, hidden 3072, tied 256000-row head; K1 and
   K2 28 launches a step and a chunk), and ``phi2_config``, ``model_phi2``,
   ``engine_phi2`` and ``engine_phi2_sync_eager`` for Phi-2
   (``hf_compat.PHI_2``: 32 layers, 32 heads of D 80; 32 and 32);
   ``model_gpt2`` and ``engine_gpt2``: ``TransformerConfig.gpt2()`` at full
   width and depth (learned positions, tied head, tanh gelu, 12 heads of D 64)
   at ``max_len=1024`` with prompts of ``GPT2_LENS``; ``families``: each
   mapped family's switch set (``FAMILY_SWITCHES``) at hidden 2048 and 2
   layers, a 512-token prefill chunk and 8 decode steps through K2 and K1 held
   against the same forward through their plain versions, and for the
   sliding-window and alibi families (which the kernels refuse, as the
   reference's do) the plain paged forward, launching neither kernel, held
   against the no-cache forward; six more sets at their published head dims
   (Gemma-2B's 8 heads of D 256 over one kv head, GPT-J's D 256, Phi-2's,
   StableLM-3B's and CodeGen-2B's D 80 at hidden 2560, Phi-3-mini's D 96 at
   3072 without its window).  K1 and K2 also take the families' shapes:
   GPT-2's 12 heads of D 64 and Falcon-7B's 71 query heads over one kv head.
   Weight-only quantization and MoE: ``mixtral_config`` (Mistral AI's
   Mixtral-8x7B, ``hf_compat.MIXTRAL_8X7B``: 32 layers, hidden 4096, 32
   query heads over 8 kv heads of D 128, 8 SwiGLU experts of 14336 a layer,
   top 2, the drop-free capacity factor 4) with int8 weights
   (``quantization=8``: 47 GB, where bf16 would need 93), random draws from
   seed 0 quantized per column and per expert as drawn, the router f32; its
   weight bytes by group and the weight bound of a decode step;
   ``model_mixtral`` (the ``model`` line's check at 32 layers: the f32 twin
   shares the int8 codes and dequantizes them layer by layer) and
   ``model_mixtral_plain_paged`` (the kernel path against the plain paged
   path within that tolerance); ``engine_mixtral`` (the ``engine`` line's
   engine and requests, K1 32 launches a step and K2 32 a chunk) and
   ``engine_mixtral_sync_eager`` (identical tokens); ``mixtral_decode_split``
   (a decode step's card time split: one layer's dequantization and its
   experts' products timed alone with CUDA events, times 32, beside the
   step and its bound).  ``int4_config``, ``model_int4_dequantized`` (the
   int4 Llama-2-7B's logits bitwise those of the bf16 model holding its
   dequantized weights), ``model_int4`` and ``engine_int4``: Llama-2-7B with
   int4 weights in blocks of 64.
6. ``k3``, ``k4``, ``k5`` — the flash-attention forward, dQ and dK/dV kernels
   against their plain versions: the training shape (B 2, S 2048, 32 heads,
   D 128, causal) in bf16 and f32, GQA 32/8, three packed segments per row
   at S 1024, non-causal at S 512, GQA 32/8 at D 64, 32 and 16, and the
   wide-head shapes (``WIDE_HEAD_SHAPES``) at B 2, S 2048, causal, bf16 and
   f32; K4 and K5 run twice
   and must give the same bits.  Each line: max abs error beside its
   tolerance, the largest relative error of a tile of 64 positions of one
   head beside its own tolerance, kernel, plain, bound and library
   (``scaled_dot_product_attention``, device time of all its kernels per
   call in a replayed graph) ms, the case's launches, and the kernel's ``design`` (``wgmma`` for
   the bf16 arms, ``cuda-cores`` for the f32 arms); a kernel or library time
   below its bound fails the run.  The device line names
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
   ``train_gemma``: ``train``'s loop and checks at Gemma-7B's widths and 2
   of its 28 layers (``gemma_train_config``: 16 heads of D 256, the tied
   256000-row head), K3-K5 2 launches each a micro-step.
   ``fp8_linear``: ``FP8Linear`` (``torch._scaled_mm``, forward and both
   gradients) at an MLP up-projection's training shape against its plain
   version (``FP8_LINEAR_REL_TOL``), its ms beside a bf16 ``F.linear``'s.
   ``train_fp8``: ``train``'s model, batches and loop under
   ``Accelerator(mixed_precision="fp8")`` (``prepare`` rebuilds the model
   with fp8 projections): ``_scaled_mm`` 3 launches a projection a
   micro-step, K3-K5 8 each a micro-step; ``train_fp8_vs_train``: each
   loss and grad norm against ``train``'s (``FP8_TRAIN_LOSS_REL_TOL``,
   ``FP8_TRAIN_GRAD_NORM_REL_TOL``), ms a micro-step and peak memory beside
   ``train``'s.  ``train_moe``: Mixtral-8x7B's widths at 1 of 32 layers
   (1.71 B parameters), ``train``'s loop and path check, K3-K5 one launch
   each a micro-step; the router's aux loss finite and in the loss (cross
   entropy plus the coefficient times the collected aux).
7b. big-model inference (on the serving model, then models of their own):
   ``generate`` (Llama-2-7B resident: one greedy call of 32 new tokens for
   each of 4 prompts of 64-512 tokens, the decode step replayed as a CUDA
   graph; tokens equal to an eager ``make_prefill_step``/``make_decode_step``
   loop's, every step's logits within the ``model`` line's margin of the
   no-cache forward; s/token and ms a step, graphed and eager, beside the
   weight bound), ``stream_offload`` (the same weights under ``cpu_offload``
   in one pinned host block, 16 tokens through ``StreamingTransformer``:
   prefill logits bitwise the resident model's, tokens equal to
   ``generate``'s; s/token, streamed GB/s, the card memory it adds, and the
   bound from the H2D rate of one pinned 1 GiB copy), ``stream_disk``
   (Llama-2-7B width at 4 layers, 2 of them in ``.dat`` files: tokens equal
   to the resident twin's), ``stream_forward`` (4 layers at
   ``attention_impl="pallas"``, 2 x 2048 tokens: logits bitwise the
   resident forward's, K3 exactly once a layer, K3 held against its plain
   version at that shape) and ``big_mixtral`` (Mixtral-8x7B in bf16, 93.4
   GB, drawn by ``init_params(device_map=...)`` with 20 layers on the card
   and 12 on pinned host under ``max_memory={0: 60e9, ...}``: 8 greedy
   tokens and the last logits identical to a run whose map swaps layers
   0-1 with 20-21; peak card memory under 80 GB, pinned bytes, s/token
   beside the bound).
7c. ``fleet`` (the serving model's weights, A, then B drawn from seed 1;
   the model is not used after this line): an engine X on A serves two
   requests, pauses admission, is drained and takes B by ``swap_params``
   (in place: no graph is captured again), and serves two requests with
   tokens identical to a fresh engine Y on B; an injected
   ``hot_swap_upload`` fault refuses a third set (B with a random final
   norm) and X's next tokens are unchanged; X serves the six ``engine``
   requests and is ``kill``ed once two lanes have tokens and a request
   waits, its ``export_inflight()`` requests are ``adopt``ed by Y and run
   to the end: every request's tokens equal Y's uninterrupted serve of the
   six, no token reaches ``on_token`` twice, ``requests_replayed`` equals
   the export; ``revive()`` and X serves two requests again with Y's
   tokens.  K1/K2 launches over the whole line, the steps' walls and the
   peak memory are printed.
8. the ``run`` line (the run's total seconds, the build included), the
   ``kernels`` line (each kernel, K1's tree-mask arm with the launches
   of ``engine_tree``, and K1's and K2's dequant arms with the launches of
   their engine runs; K1 and K2 also with ``engine_prefix``'s,
   ``engine_neox``'s and ``engine_gpt2``'s launches,
   K3-K5 also with ``train_api``'s, K3 with ``stream_forward``'s; each head
   dim past 64 and 128 its own
   entry: K1 and K2 at D 256 on ``engine_gemma``, D 80 on ``engine_phi2``,
   D 96 on ``families``' ``phi3_d96``; K3-K5 at D 256 on ``train_gemma``,
   at D 80, 96, 32 and 16 on their own kernel cases; ``launches_on`` names
   the path each count comes from; K1 and K2 also with ``engine_mixtral``'s
   and ``engine_int4``'s launches and with ``fleet``'s, K3-K5 with
   ``train_fp8``'s and ``train_moe``'s),
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
from typing import Optional

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


#: ``time.perf_counter()`` at the start of the run: each phase's record gets
#: ``t_s``, the seconds since then, so that the run's time splits by line
_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
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


#: the wide- and narrow-head families' attention shapes: label -> (query
#: heads, kv heads, D) of Gemma-7B, Gemma-2B, Phi-2 and Phi-3-mini
WIDE_HEAD_SHAPES = {"gemma7b_d256": (16, 16, 256), "gemma2b_mq8_d256": (8, 1, 256),
                    "phi2_d80": (32, 32, 80), "phi3_d96": (32, 32, 96)}
#: (q dtype, page format) of each shape's cases: native pages of the q
#: dtype, then int8 and fp8 codes under either q dtype
WIDE_HEAD_ARMS = [(torch.bfloat16, None), (torch.float32, None), (torch.bfloat16, "int8"),
                  (torch.bfloat16, "fp8"), (torch.float32, "int8"), (torch.float32, "fp8")]


def wide_head_cases(lengths, s, seed0, shapes, suffix=""):
    """``kernel_phase`` cases of every shape of ``shapes`` under every arm of
    ``WIDE_HEAD_ARMS``, over pages of 128 keys."""
    cases = []
    for i, (label, (hq, hkv, d)) in enumerate(shapes.items()):
        for j, (dtype, fmt) in enumerate(WIDE_HEAD_ARMS):
            cases.append((f"{label}_{suffix}" if suffix else label, seed0 + 10 * i + j,
                          lengths, s, hq, hkv, dtype, 128, d, fmt))
    return cases


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
    # the same weights in f32 (bf16 values are exact in f32), f32 compute;
    # built on the meta device and assigned, so one f32 copy is resident
    # (Gemma-7B's is 34 GB beside its 17 GB of bf16 weights)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = Transformer(cfg32, device="meta", dtype=torch.float32)
    model32.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in model.state_dict().items()}, assign=True)
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


def engine_phase(model, cfg, rng, gpu, margin: Optional[float], kv_dtype=None, spec=None,
                 prompts=None, name=None, eager=False, knobs=None, telemetry=False):
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
    ``telemetry``: the engine records into a private registry and serves
    its debug endpoints on an ephemeral local port, scraped after the serve
    (:func:`scrape_phase`).
    The graphs captured (one per bucket among them) must not grow during the
    serve.  An fp8 model's ``_scaled_mm`` launches are counted too (one a
    projection a forward).  ``margin=None`` holds no token to the no-cache
    forward (an fp8 model's per-tensor scales differ between the engine's
    batches and that forward's: the deficit is printed).  Returns the
    launches, the prompts and the tokens."""
    from accelerate_tpu_torch.models.generation import GenerationConfig
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving import ServingEngine
    from accelerate_tpu_torch.telemetry import MetricsRegistry, get_reqtrace

    if prompts is None:
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in ENGINE_LENS]
    if telemetry:
        get_reqtrace().reset()
    lens = tuple(len(p) for p in prompts)
    gen = GenerationConfig(max_new_tokens=48)

    def new_engine():
        kw = {**dict(num_slots=4, max_len=2048, prefill_buckets=(128, 512), decode_window=4,
                     kv_dtype=kv_dtype, prefix_cache_mb=0, device="cuda"), **(spec or {}),
              **(knobs or {})}
        if telemetry:
            kw.update(registry=MetricsRegistry(), metrics_port=0)
        if eager:
            return ServingEngine._eager(model, None, **{"async_depth": 0, **kw})
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
    fp8.launches = 0
    t0 = time.perf_counter()
    reqs = engine.serve(prompts, configs=gen)
    wall = time.perf_counter() - t0
    held["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_attention_tree": pa.paged_attention.tree_launches,
                "paged_flash_prefill": pa.paged_flash_prefill.launches}
    if cfg.use_fp8:
        launches["scaled_mm"] = fp8.launches
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
    if cfg.use_fp8:
        # every projection of every forward: the window steps and the chunks
        products = (window_forwards + st["prefill_chunks"]) * cfg.num_layers * (
            7 if cfg.gated_mlp else 6)
        check(spec is None and launches["scaled_mm"] == products,
              f"_scaled_mm launched {launches['scaled_mm']} times, want {products}")
    check(not paged or engine.kv.allocator.free_count == idle_free, "KV pages leaked")
    check(st["graph_captures"] == captures, f"graphs captured during the serve: "
          f"{captures} -> {st['graph_captures']}")
    check(eager or st["graph_replays"] > 0, "no window replayed a graph")
    if (knobs or {}).get("interleave_prefill"):
        check(st["interleaved_chunks"] > 0, "no chunk queued behind a window of its cycle")
    telemetry_rec = scrape_phase(engine, model, len(reqs)) if telemetry else {}
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
        confident += int(((top2[:, 0] - top2[:, 1]) > (margin or 0.0)).sum())
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
          "interleaved_chunks": st["interleaved_chunks"], **telemetry_rec, "gpu": gpu})
    if quantized:
        # quantization moves the logits by design: the tokens are held by
        # the error bound, not by the bf16 noise margin
        check(0.0 < kv_rec["kv_quant_error"] <= kv_rec["kv_quant_error_bound"],
              f"{kv_dtype} kv_quant_error {kv_rec['kv_quant_error']} outside "
              f"(0, {kv_rec['kv_quant_error_bound']}]")
    elif margin is not None:
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


def parse_prometheus(text: str) -> dict:
    """Prometheus text exposition -> ``{sample name with labels: value}``;
    raises on a line that is neither a comment nor ``name value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        check(re.fullmatch(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{le="[^"]+"\})?', name) is not None,
              f"bad Prometheus sample name {name!r}")
        out[name] = float(value)
    return out


def scrape_phase(engine, model, n_requests: int) -> dict:
    """The ``engine`` line's telemetry, read as an operator reads it: its
    ``/metrics``, ``/healthz`` and ``/debug/requests`` fetched over HTTP from
    the engine's debug server on localhost; ``analyze_costs()`` beside the
    weights' bytes; ``compiled_executable_counts()``, each at most 1 and
    each window's and chunk's count the number of its graphs this serve
    replayed.  The debug server stops after (it holds the engine)."""
    import urllib.request

    from accelerate_tpu_torch.telemetry import stop_debug_server

    server = engine.debug_server
    check(server is not None, "metrics_port=0 started no debug server")

    def get(path):
        with urllib.request.urlopen(server.url + path, timeout=60) as resp:
            return resp.status, resp.read().decode()

    try:
        status, text = get("/metrics")
        samples = parse_prometheus(text)
        health, _ = get("/healthz")
        _, body = get("/debug/requests")
        mine = [t for t in json.loads(body)["recent"]
                if t["engine"] == engine.engine_id and t["status"] == "done"]
        waterfall = (json.loads(get(f"/debug/requests/{engine.engine_id}:{mine[0]['rid']}")[1])
                     if mine else {})
    finally:
        stop_debug_server()
    completed = samples.get("atpu_serve_requests_completed_total_total")
    ttft = samples.get("atpu_serve_ttft_s_count")
    check(status == 200 and completed == n_requests and ttft == n_requests,
          f"/metrics: status {status}, {completed} completed, {ttft} TTFT observations, "
          f"want {n_requests}")
    check(health == 200, f"/healthz answered {health}")
    check(len(mine) == n_requests and all(t["phases"] > 0 for t in mine),
          f"/debug/requests holds {len(mine)} finished waterfalls of this engine, "
          f"want {n_requests}")
    costs = engine.analyze_costs()
    counts = engine.compiled_executable_counts()
    programs = {"decode": "decode_window", "verify": "verify_window",
                "tree": "tree_verify_window", "draft": "draft_forward"}
    replayed = {}
    for key in engine.graphs.replayed:
        program = f"prefill_{key[1]}" if key[0] == "prefill" else programs[key[0]]
        replayed[program] = replayed.get(program, 0) + 1
    check(max(counts.values()) <= 1 and all(counts[k] == n for k, n in replayed.items()),
          f"compiled_executable_counts {counts} against the graphs replayed {replayed}")
    weights = model_bytes(model.state_dict())
    return {"telemetry": {
        "metrics_samples": len(samples), "requests_completed": completed,
        "ttft_count": ttft, "healthz": health, "waterfalls": len(mine),
        "waterfall_phases": [p["phase"] for p in waterfall.get("phase_list", [])][:12],
        "decode_flops_per_token": engine.metrics.get("serve/decode_flops_per_token").value,
        "decode_step_bytes": costs["serve/decode_window"]["bytes_accessed"] / engine.window,
        "weights_bytes": weights, "weights_gb": weights / 1e9,
        "hbm_peak_bytes": engine.cost_table.max_hbm_peak_bytes(),
        "hbm_peak_bytes_by_program": {k: v["hbm_peak_bytes"] for k, v in costs.items()},
        "compiled_executable_counts": counts, "graphs_replayed": replayed,
        "device_peaks": dataclasses.asdict(engine.device_peaks)}}


def telemetry_off_phase(model, cfg, rng, gpu, tol, prompts, tokens) -> None:
    """``engine_telemetry_off``: the ``engine`` line's serve with the
    telemetry switched off process-wide; the tokens must be identical (its
    serve tokens/s beside ``engine``'s is a record, not a gate)."""
    from accelerate_tpu_torch.telemetry import set_enabled

    set_enabled(False)
    try:
        _, _, off_tokens = engine_phase(model, cfg, rng, gpu, tol, prompts=prompts,
                                        name="engine_telemetry_off")
    finally:
        set_enabled(True)
    check(off_tokens == tokens, "engine_telemetry_off's tokens differ from engine's")


def fleet_phase(model, cfg, gpu, prompts) -> dict:
    """The ``fleet`` line (the module docstring's 7c): ``swap_params``, the
    upload fault, a failover and ``revive`` on Llama-2-7B at full width and
    depth.  ``model``'s weights are overwritten by the swap.  Returns the
    K1/K2 launches of the whole line."""
    from accelerate_tpu_torch.models.generation import GenerationConfig
    from accelerate_tpu_torch.models.transformer import Transformer
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving import ServingEngine, faults
    from accelerate_tpu_torch.telemetry import MetricsRegistry
    from accelerate_tpu_torch.weights import init_params

    gen = GenerationConfig(max_new_tokens=48)
    kw = dict(num_slots=4, max_len=2048, prefill_buckets=(128, 512), decode_window=4,
              prefix_cache_mb=0, device="cuda")
    walls = {}

    def timed_serve(label, engine, ps):
        t0 = time.perf_counter()
        out = [r.tokens for r in engine.serve([p.copy() for p in ps], configs=gen)]
        walls[label] = time.perf_counter() - t0
        return out

    gc.collect()  # engines of earlier lines serve from these weights: let them go
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    x = ServingEngine(model, None, registry=MetricsRegistry(), **kw)
    walls["engine_x_init"] = time.perf_counter() - t0
    two = prompts[:2]
    on_a = timed_serve("x_on_a", x, two)
    t0 = time.perf_counter()
    sd_b = init_params(cfg, seed=1, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    walls["draw_b"] = time.perf_counter() - t0
    shell = Transformer(cfg, device="meta")
    shell.load_state_dict(sd_b, assign=True)
    t0 = time.perf_counter()
    y = ServingEngine(shell, None, registry=MetricsRegistry(), **kw)
    walls["engine_y_init"] = time.perf_counter() - t0
    # the swap: pause, drain, swap in place, resume
    captures = x.stats["graph_captures"]
    x.pause_admission()
    while not x.drained:
        x.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x.swap_params(sd_b, version="v1")
    torch.cuda.synchronize()
    walls["swap"] = time.perf_counter() - t0
    x.resume_admission()
    check(x.stats["graph_captures"] == captures,
          f"the swap captured graphs: {captures} -> {x.stats['graph_captures']}")
    on_b = timed_serve("x_on_b", x, two)
    fresh_b = timed_serve("y_two", y, two)
    check(on_b == fresh_b, "after swap_params, X's tokens differ from a fresh engine on B")
    check(on_b != on_a, "the swap left X's tokens unchanged")
    # the upload fault: a third set (B with a random final norm) is refused
    third = dict(sd_b)
    third["final_norm.scale"] = torch.randn_like(sd_b["final_norm.scale"])
    faults.install("hot_swap_upload@1")
    refused = False
    try:
        x.swap_params(third, version="v2")
    except faults.FaultInjected:
        refused = True
    finally:
        faults.clear()
    del third
    check(refused and x.weights_version == "v1", "the injected upload fault did not refuse")
    after_fault = timed_serve("x_after_fault", x, two)
    check(after_fault == on_b, "X's tokens changed across the refused swap")
    # failover: Y's uninterrupted serve of the six, then X killed mid-serve
    want = timed_serve("y_six", y, prompts)
    streamed = {}
    reqs = [x.submit(p.copy(), config=gen,
                     on_token=lambda r, t: streamed.setdefault(id(r), []).append(len(r.tokens)))
            for p in prompts]
    steps = 0
    t0 = time.perf_counter()
    while not (sum(1 for r in reqs if r.state.value == "running" and r.tokens) >= 2
               and x.scheduler.queue_depth >= 1):
        check(x.has_work and steps < 10_000, "X drained before the kill point")
        x.step()
        steps += 1
    kill_state = {"step": steps, "queued": x.scheduler.queue_depth,
                  "tokens": [len(r.tokens) for r in reqs],
                  "states": [r.state.value for r in reqs]}
    x.kill("fleet line: simulated loss of the card")
    exported = x.export_inflight()
    for r in exported:
        y.adopt(r)
    y.run()
    walls["failover"] = time.perf_counter() - t0
    got = [r.tokens for r in reqs]
    mismatched = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    repeated = [i for i, r in enumerate(reqs)
                if streamed.get(id(r)) != list(range(1, len(r.tokens) + 1))]
    # the reference's replay, for the record: each request re-prefilled with
    # its first 8 tokens, the continuation held against Y's uninterrupted
    # one (the first index where they part; None: never)
    reprefilled = y.serve([np.concatenate([p, np.asarray(t[:8], np.int32)]) for p, t in
                           zip(prompts, want)], configs=GenerationConfig(max_new_tokens=40))
    prefill_replay_parts = [next((i for i, (a, b) in enumerate(zip(r.tokens, t[8:])) if a != b),
                                 None) for r, t in zip(reprefilled, want)]
    t0 = time.perf_counter()
    x.revive()
    walls["revive"] = time.perf_counter() - t0
    revived = timed_serve("x_revived", x, two)
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_flash_prefill": pa.paged_flash_prefill.launches}
    emit({"phase": "fleet", "config": "llama2_7b", "layers": cfg.num_layers, "dtype": "bfloat16",
          "weights_gb_each": model_bytes(sd_b) / 1e9, "graph_captures_x": captures,
          "kill": kill_state, "exported": len(exported),
          "requests_replayed": y.stats["requests_replayed"],
          "failover_mismatched_requests": mismatched, "repeated_streams": repeated,
          "prefill_replay_first_difference": prefill_replay_parts,
          "hot_swaps": x.stats["hot_swaps"], "walls_s": walls, "launches": launches,
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "tokens_per_s_y_six": sum(len(t) for t in want) / walls["y_six"], "gpu": gpu})
    check(not mismatched, f"failover tokens of requests {mismatched} differ from Y's "
          "uninterrupted serve")
    check(not repeated and all(len(r.tokens) == 48 for r in reqs),
          f"requests {repeated} streamed a token twice, or a request finished short")
    check(y.stats["requests_replayed"] == len(exported),
          f"requests_replayed {y.stats['requests_replayed']} != {len(exported)} exported")
    check(revived == want[:2], "the revived engine's tokens differ from Y's")
    check(launches["paged_attention"] > 0 and launches["paged_flash_prefill"] > 0,
          f"the fleet line launched no kernel: {launches}")
    del x, y, shell, sd_b
    free_card()
    return launches


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


#: the published configs served at full width and depth: line suffix ->
#: (``hf_compat`` literal, its source, the switches and head dim it must map to)
HF_LINES = {
    # GPT-NeoX: LayerNorm with bias, biased projections, rotary over 32 of
    # 128 dims, exact gelu, parallel residual with two norms, untied head
    "neox": ("PYTHIA_6_9B", "EleutherAI/pythia-6.9b config.json",
             dict(norm_type="layernorm", use_bias=True, rope_dim=32, parallel_residual=True,
                  shared_norm=False, mlp_variant="gelu_exact", tie_word_embeddings=False,
                  resolved_head_dim=128)),
    # Gemma: (1 + scale) RMSNorm, sqrt(hidden) embedding scale, tanh-gelu
    # gated MLP, tied head, 16 heads of D 256 over hidden 3072 (K1 and K2's
    # D 256 arms)
    "gemma": ("GEMMA_7B", "google/gemma-7b config.json",
              dict(norm_unit_offset=True, embed_scale=True, mlp_variant="geglu",
                   tie_word_embeddings=True, num_heads=16, num_kv_heads=16,
                   resolved_head_dim=256)),
    # Phi-2: one shared LayerNorm, parallel residual, biases everywhere (the
    # untied head's too), rotary over 32 of 80 dims, tanh gelu (D 80 arms)
    "phi2": ("PHI_2", "microsoft/phi-2 config.json",
             dict(norm_type="layernorm", use_bias=True, lm_head_bias=True, mlp_variant="gelu",
                  parallel_residual=True, shared_norm=True, rope_dim=32,
                  tie_word_embeddings=False, resolved_head_dim=80)),
}


def hf_phases(gpu, line: str) -> dict:
    """One of ``HF_LINES`` at its published widths and full depth, from its
    ``config.json`` values through the port's ``hf_compat`` mapping, bf16,
    random weights from seed 0: ``<line>_config`` (the mapped config, its
    parameters and weight bytes), ``model_<line>`` (the paged forward
    through K2 and K1 against the no-cache forward, the f32 forward of the
    same weights the yardstick of bf16 noise), ``engine_<line>`` (the
    ``engine`` line's engine and requests: K1 one launch a layer each
    decode step, K2 one a layer each chunk, every token within the noise
    margin) and ``engine_<line>_sync_eager``, whose tokens must be
    identical.  Returns ``engine_<line>``'s launches."""
    from accelerate_tpu_torch.models import hf_compat
    from accelerate_tpu_torch.models.transformer import state_dict_shapes

    literal, source, expect = HF_LINES[line]
    cfg = hf_compat.config_from_hf_dict(getattr(hf_compat, literal), dtype=torch.bfloat16)
    params = sum(int(np.prod(shape)) for shape in state_dict_shapes(cfg).values())
    got = {key: getattr(cfg, key) for key in expect}
    check(got == expect, f"{source} mapped to an unexpected config: {got}")
    emit({"phase": f"{line}_config", "source": source,
          "config": {k: str(v) if isinstance(v, torch.dtype) else v
                     for k, v in dataclasses.asdict(cfg).items()},
          "params": params, "weights_gb": 2 * params / 1e9})
    model = family_model(cfg)
    rng = np.random.default_rng(0)
    tol = model_phase(model, cfg, rng, name=f"model_{line}")
    launches, prompts, tokens = engine_phase(model, cfg, rng, gpu, tol, name=f"engine_{line}")
    _, _, eager = engine_phase(model, cfg, rng, gpu, tol, prompts=prompts,
                               name=f"engine_{line}_sync_eager", eager=True)
    check(eager == tokens, f"engine_{line}_sync_eager's greedy tokens differ from engine_{line}'s")
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


def quantized_model(cfg, seed: int = 0):
    """``cfg``'s weight-quantized model on the card: ``init_params``' bf16
    draws from ``seed``, each projection quantized as it is drawn (per
    column, per expert), the router f32, embeddings and head bf16."""
    from accelerate_tpu_torch.models.transformer import Transformer
    from accelerate_tpu_torch.weights import init_params

    sd = init_params(cfg, seed=seed, device="cuda", dtype=torch.bfloat16)
    model = Transformer(cfg, device="meta", dtype=torch.bfloat16)
    model.load_state_dict(sd, assign=True)
    return model


def weight_bytes(model) -> dict:
    """The model's weight bytes by group: the quantized codes, their f32
    scales, the MoE routers, the embeddings and head, and the rest (norms)."""
    groups = {"codes": 0, "scales": 0, "router": 0, "embed_head": 0, "other": 0}
    for name, t in model.state_dict().items():
        key = ("codes" if name.endswith(".qweight") else "scales" if name.endswith(".scales")
               else "router" if ".router." in name
               else "embed_head" if name.split(".")[0] in ("embed_tokens", "lm_head")
               else "other")
        groups[key] += t.numel() * t.element_size()
    return groups


def paged_plain_check(model, cfg, rng, tol: float, name: str) -> dict:
    """The kernel path's logits (a 512-token prefill chunk through K2, 8
    decode steps through K1) against the plain paged path's on the same
    tokens, within the model line's tolerance ``tol``."""
    ids = rng.integers(1, cfg.vocab_size, 520).astype(np.int32)
    got = paged_logits(model, cfg, ids, plain=False)
    want = paged_logits(model, cfg, ids, plain=True)
    err = (got - want).abs().max().item()
    rec = {"kernel_vs_plain_paged_max_abs_logit_err": err, "tolerance": tol}
    check(err <= tol, f"{name}: the kernel path's logits differ from the plain paged path's "
          f"by {err} > {tol}")
    return rec


#: Mixtral-8x7B's routing constants the published config must map to
MIXTRAL_EXPECT = dict(num_layers=32, hidden_size=4096, intermediate_size=14336, num_heads=32,
                      num_kv_heads=8, resolved_head_dim=128, num_experts=8,
                      num_experts_per_tok=2, expert_capacity_factor=4.0, vocab_size=32000,
                      rope_theta=1e6, tie_word_embeddings=False, sliding_window=None)


def moe_decode_split(model, cfg, lanes: int = 4) -> dict:
    """Card time of one decode step split into its parts, each timed alone
    with CUDA events at the engine's decode shape (``lanes`` tokens a
    forward): the dequantization of one layer's weights (the experts' and
    the attention projections', the f32 multiply then the bf16 cast), the
    experts' three batched products at the step's capacity on weights
    dequantized beforehand, each times the layers; beside them one whole
    decode forward (``step_ms``) and what is left of it (``rest``: norms,
    rotary, K1, routing, the attention products, the head)."""
    from accelerate_tpu_torch.ops.quantization import QuantizedLinear, dequantize

    layer = model.layers[0]
    quantized = [m for m in layer.modules() if isinstance(m, QuantizedLinear)]

    def dequant_layer():
        for m in quantized:
            dequantize(m.qtensor(), cfg.dtype, transposed=m.experts is None)

    experts = layer.moe_mlp.experts
    w = {n: dequantize(getattr(experts, n).qtensor(), cfg.dtype)
         for n in ("gate_proj", "up_proj", "down_proj")}
    cap = cfg.resolved_expert_capacity(lanes)
    x = torch.randn(cfg.num_experts, cap, cfg.hidden_size, device="cuda", dtype=cfg.dtype)

    def expert_products():
        g = torch.bmm(x, w["gate_proj"])
        u = torch.bmm(x, w["up_proj"])
        torch.bmm(torch.nn.functional.silu(g) * u, w["down_proj"])

    # one decode forward of ``lanes`` lanes at the engine's lengths, through
    # K1 (eager: at these times the host's launches hide behind the card)
    from accelerate_tpu_torch.models.transformer import PagedKVCache
    from accelerate_tpu_torch.serving import PagedKVPool

    per_lane = 2048 // 128
    pool = PagedKVPool(cfg, lanes, 2048, 128, lanes * per_lane + 1, device="cuda")
    tables = torch.arange(1, lanes * per_lane + 1, dtype=torch.int32,
                          device="cuda").reshape(lanes, per_lane)
    cache = PagedKVCache(pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales,
                         tables=tables, index=torch.tensor([57, 384, 700, 1000][:lanes],
                                                           dtype=torch.int32, device="cuda"),
                         active=torch.ones(lanes, dtype=torch.bool, device="cuda"),
                         kernel="decode")
    ids = torch.ones(lanes, 1, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        dq = time_ms(dequant_layer, iters=5)
        ex = time_ms(expert_products, iters=20)
        del w
        step = time_ms(lambda: model(ids, cache=cache), iters=3, warmup=1)
    del pool, cache
    free_card()
    return {"dequant_ms_per_layer": dq, "expert_products_ms_per_layer": ex,
            "dequant_ms_per_step": dq * cfg.num_layers,
            "expert_products_ms_per_step": ex * cfg.num_layers, "step_ms": step,
            "rest_ms_per_step": step - (dq + ex) * cfg.num_layers,
            "dequant_share": dq * cfg.num_layers / step, "capacity": cap, "lanes": lanes}


def mixtral_phases(gpu) -> dict:
    """Mixtral-8x7B (``hf_compat.MIXTRAL_8X7B``, the published
    ``config.json`` values) at full width and depth with int8 weights
    (``quantization=8``: 47 GB; 93 GB in bf16 would not fit the card):
    ``mixtral_config`` (the mapped config, the weight bytes by group and
    the weight bound of a decode step, every weight read once at the HBM
    rate), ``model_mixtral`` (the ``model`` line's check at 32 layers: the
    f32 twin shares the int8 codes and dequantizes them to f32 layer by
    layer, so it needs no f32 copy of the weights), the kernel path against
    the plain paged path, ``engine_mixtral`` (the ``engine`` line's engine
    and six requests: K1 32 launches a decode step, K2 32 a chunk, every
    token within the noise margin, the peak memory) and
    ``engine_mixtral_sync_eager`` (identical tokens), then the decode step's
    card time split into dequantization, expert products and the rest.
    Returns ``engine_mixtral``'s launches."""
    from accelerate_tpu_torch.models import hf_compat
    from accelerate_tpu_torch.models.transformer import state_dict_shapes

    cfg = hf_compat.config_from_hf_dict(hf_compat.MIXTRAL_8X7B, dtype=torch.bfloat16,
                                        quantization=8)
    got = {key: getattr(cfg, key) for key in MIXTRAL_EXPECT}
    check(got == MIXTRAL_EXPECT, f"mistralai/Mixtral-8x7B-v0.1 mapped to {got}")
    dense = dataclasses.replace(cfg, quantization=None)
    params = sum(int(np.prod(shape)) for shape in state_dict_shapes(dense).values())
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = quantized_model(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    groups = weight_bytes(model)
    total = sum(groups.values())
    bound_ms = 1e3 * total / HBM_BYTES_PER_S
    emit({"phase": "mixtral_config", "source": "mistralai/Mixtral-8x7B-v0.1 config.json",
          "config": {k: str(v) if isinstance(v, torch.dtype) else v
                     for k, v in dataclasses.asdict(cfg).items()},
          "params": params, "bf16_weights_gb": 2 * params / 1e9,
          "weights_gb": total / 1e9, "weights_gb_by_group": {k: v / 1e9 for k, v in
                                                             groups.items()},
          "weight_bound_ms_per_step": bound_ms, "init_s": init_s,
          "init_peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    rng = np.random.default_rng(0)
    tol = model_phase(model, cfg, rng, name="model_mixtral")
    emit({"phase": "model_mixtral_plain_paged", **paged_plain_check(model, cfg, rng, tol,
                                                                    "model_mixtral")})
    launches, prompts, tokens = engine_phase(model, cfg, rng, gpu, tol, name="engine_mixtral")
    _, _, eager = engine_phase(model, cfg, rng, gpu, tol, prompts=prompts,
                               name="engine_mixtral_sync_eager", eager=True)
    check(eager == tokens, "engine_mixtral_sync_eager's greedy tokens differ from "
          "engine_mixtral's")
    emit({"phase": "mixtral_decode_split", **moe_decode_split(model, cfg),
          "weight_bound_ms_per_step": bound_ms, "gpu": gpu})
    del model
    free_card()
    return launches


def int4_phases(gpu) -> dict:
    """Llama-2-7B with int4 weights (``quantization=4``, blocks of 64 along
    K): ``int4_config`` (weight bytes and the weight bound of a decode
    step), ``model_int4`` (the ``model`` line's check) and
    ``model_int4_dequantized`` (the no-cache logits bitwise those of the
    bf16 model holding the dequantized weights: the same products),
    ``engine_int4`` (the ``engine`` line's engine and requests).  Returns
    ``engine_int4``'s launches."""
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.ops.quantization import dequantize

    cfg = TransformerConfig.llama2_7b(dtype=torch.bfloat16, quantization=4,
                                      quantization_block_size=64)
    free_card()
    model = quantized_model(cfg)
    groups = weight_bytes(model)
    bound_ms = 1e3 * sum(groups.values()) / HBM_BYTES_PER_S
    emit({"phase": "int4_config", "config": "llama2_7b", "quantization": 4, "block_size": 64,
          "weights_gb_by_group": {k: v / 1e9 for k, v in groups.items()},
          "weights_gb": sum(groups.values()) / 1e9, "weight_bound_ms_per_step": bound_ms})
    rng = np.random.default_rng(0)
    # the dense twin on the dequantized weights ([out, in], as QuantizedLinear
    # hands them to F.linear)
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith(".qweight"):
            base = name[: -len(".qweight")]
            sd[base + ".weight"] = dequantize(model.get_submodule(base).qtensor(),
                                              torch.bfloat16, transposed=True)
        elif not name.endswith(".scales"):
            sd[name] = t
    twin = Transformer(dataclasses.replace(cfg, quantization=None), device="meta",
                       dtype=torch.bfloat16)
    twin.load_state_dict(sd, assign=True)
    ids = rng.integers(1, cfg.vocab_size, 512).astype(np.int32)
    got, want = no_cache_logits(model, ids), no_cache_logits(twin, ids)
    same = torch.equal(got, want)
    emit({"phase": "model_int4_dequantized", "prompt": 512, "bitwise": same,
          "max_abs_logit_err": (got - want).abs().max().item()})
    check(same, "the int4 model's logits are not bitwise the dequantized bf16 model's")
    del twin, sd, got, want
    free_card()
    tol = model_phase(model, cfg, rng, name="model_int4")
    launches, _, _ = engine_phase(model, cfg, rng, gpu, tol, name="engine_int4")
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
_PHI_SW = dict(norm_type="layernorm", use_bias=True, lm_head_bias=True, mlp_variant="gelu",
               parallel_residual=True, shared_norm=True)
#: the width of the published models with heads of 80 (Phi-2, StableLM-3B,
#: CodeGen-2B: 32 heads over hidden 2560) and 96 (Phi-3-mini: 32 over 3072)
_D80 = dict(hidden_size=2560, intermediate_size=10240, num_heads=32, num_kv_heads=32)
_D96 = dict(hidden_size=3072, intermediate_size=8192, num_heads=32, num_kv_heads=32)
#: each mapped family's switches at hidden 2048 and 2 layers (D 128 over 16
#: heads, D 64 over 32), then the families whose published heads are 256,
#: 80 or 96 wide at those head dims (K1's and K2's D 256, 80 and 96 arms);
#: the three window and alibi sets take the plain paged versions
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
    "phi": dict(_PHI_SW, rope_dim=64),
    "codegen": dict(_GPTJ_SW, rope_dim=32, use_bias=False),
    "mistral_window256": dict(sliding_window=256, num_kv_heads=4),
    "bloom_alibi": dict(norm_type="layernorm", use_bias=True, positional="alibi",
                        embed_norm=True, mlp_variant="gelu", tie_word_embeddings=True),
    "mpt_alibi": dict(norm_type="layernorm", norm_bias=False, positional="alibi",
                      mlp_variant="gelu_exact", tie_word_embeddings=True, num_heads=32,
                      num_kv_heads=32),
    # Gemma-2B: 8 heads of D 256 over one kv head at hidden 2048
    "gemma_d256_mq": dict(norm_unit_offset=True, embed_scale=True, mlp_variant="geglu",
                          tie_word_embeddings=True, num_heads=8, num_kv_heads=1,
                          intermediate_size=16384),
    # GPT-J-6B's heads of 256 (8 of them at hidden 2048)
    "gptj_d256": dict(_GPTJ_SW, num_heads=8, num_kv_heads=8),
    "phi_d80": dict(_PHI_SW, **_D80, rope_dim=32),             # Phi-2: rotary over 0.4
    "stablelm_d80": dict(_D80, norm_type="layernorm", rope_dim=20,  # StableLM-3B: 0.25
                         intermediate_size=6912),
    "codegen_d80": dict(_GPTJ_SW, **_D80, use_bias=False),     # CodeGen-2B: rotary 64
    # Phi-3-mini's switches without its 2047-token window, which would keep
    # it off the kernels (the reference routes window models to XLA)
    "phi3_d96": dict(_D96),
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


def families_phase(gpu) -> dict:
    """Every family of ``FAMILY_SWITCHES`` at its width (hidden 2048 unless
    the set names another) and 2 layers, bf16, random weights: for the
    full-causal ones the paged forward through K2 and K1 (2 and 16
    launches) held against the same forward through their plain versions;
    for the sliding-window and alibi ones (which the kernels refuse, as the
    reference's) the plain paged forward, K1 and K2 launched 0 times, held
    against the no-cache forward.  The tolerance is ``LOGIT_TOL_FACTOR``
    times the bf16 no-cache forward's distance from the f32 one of the same
    weights, as for the model line.  Returns each family's launches."""
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
        rec = {"family": family, "switches": sw, "hidden": cfg.hidden_size,
               "head_dim": cfg.resolved_head_dim, "heads": [cfg.num_heads, cfg.num_kv_heads],
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
    emit({"phase": "families", "layers": 2, "prompt": 512, "decode_steps": 8,
          "records": records, "gpu": gpu})
    return {rec["family"]: rec["launches"] for rec in records}


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


def library_ms(q, k, v, dout, causal, backward) -> float:
    """Device time of ``scaled_dot_product_attention`` on the same values in
    its own contiguous BHSD layout, from :func:`graph_ms` (CUDA events around
    a replayed graph: no host time and no profiler to drop its kernels): its
    forward computes K3's function, its backward K4's and K5's together.  A
    captured backward needs its forward in the same graph, so the backward's
    time is that of forward and backward less the forward's."""
    import torch.nn.functional as F

    gqa = q.shape[2] != k.shape[2]
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(backward)
                  for t in (q, k, v))

    def forward():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=gqa)

    forward_ms = graph_ms(forward, 5)
    if not backward:
        return forward_ms
    grad = dout.transpose(1, 2).contiguous()
    return graph_ms(lambda: torch.autograd.grad(forward(), (qt, kt, vt), grad), 5) - forward_ms


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
        rec["library_ms"] = None if segmented else library_ms(q, k, v, dout, causal, backward)
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
        for key in ("ms", "library_ms"):
            check(rec[key] is None or rec[key] >= bms,
                  f"{name} {label}: {key} {rec[key]} is below the bound {bms}")
        records[name] = rec
    return records


def flash_phase(cases):
    """Every case through :func:`flash_case`; returns each kernel's records,
    the first (training-shape bf16) case's first."""
    records = {}
    for case in cases:
        for name, rec in flash_case(*case).items():
            records.setdefault(name, []).append(rec)
        torch.cuda.empty_cache()
    return records


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


#: Gemma-7B's widths at 2 of its 28 layers for ``train_gemma`` (K3-K5's D 256
#: arms): 1.34 B parameters, 0.79 B of them the tied 256000-row embedding
GEMMA_TRAIN_LAYERS = 2


def gemma_train_config():
    from accelerate_tpu_torch.models.hf_compat import GEMMA_7B, config_from_hf_dict

    return config_from_hf_dict(GEMMA_7B, num_layers=GEMMA_TRAIN_LAYERS, dtype=torch.bfloat16,
                               param_dtype=torch.float32, attention_impl="pallas")


def train_model(cfg, seed: int):
    """f32 masters on the card from ``init_params(seed)``."""
    from accelerate_tpu_torch.models.transformer import Transformer
    from accelerate_tpu_torch.weights import init_params

    model = Transformer(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(init_params(cfg, seed=seed, device="cuda", dtype=torch.float32),
                          assign=True)
    return model


def train_data(cfg, repeats: int = 4):
    """Two random batches A and B of 2 x 2048 tokens, and the loader's
    dataset A B A B ... (``2 * repeats`` batches)."""
    rng = np.random.default_rng(7)
    a, b = (rng.integers(1, cfg.vocab_size, (TRAIN_ROWS, TRAIN_SEQ)).astype(np.int32)
            for _ in range(2))
    return a, [{"input_ids": r} for _ in range(repeats) for r in (*a, *b)]


def host_available_gb() -> float:
    """The host's ``MemAvailable``, GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def offload_plugin(**kw):
    """The FSDP plugin of the offloaded lines: one card, the optimizer state
    in pinned host memory (master weights: auto, on under bf16)."""
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    return FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD", offload_optimizer=True,
                                          **kw)


def train_phase(gpu, cfg=None, name="train", config="llama2_7b", of_layers=32,
                mixed_precision="bf16", with_path_check=True, accelerator_kw=None,
                repeats=4, keep_weights=False):
    """``cfg`` (``train``: Llama-2-7B's widths at ``TRAIN_LAYERS`` layers)
    trained through ``Accelerator.compile_train_step``: ``2 * repeats``
    micro-steps of ``TRAIN_ROWS`` x ``TRAIN_SEQ`` tokens at accumulation 2,
    the flash launch counters zeroed just before and read just after (one
    launch of each of K3-K5 a layer each micro-step; K3 twice under remat,
    whose recompute relaunches it), held to the flash-vs-xla path check
    (``with_path_check``).  Under ``mixed_precision="fp8"`` the model goes
    through ``prepare`` first (its projections become fp8 products) and the
    ``_scaled_mm`` launches are counted too.  ``accelerator_kw`` go to the
    Accelerator (an offloading FSDP plugin: the line then reports the
    chunked update).  Returns the launches and the line's record (with
    ``keep_weights``, the final weights as host copies under ``weights``,
    not printed)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.models.transformer import lm_loss_fn, state_dict_shapes
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.chunked_update import ChunkedOptimizer

    free_card()
    cfg = cfg or train_config(TRAIN_LAYERS)
    layers, rows, seq = cfg.num_layers, TRAIN_ROWS, TRAIN_SEQ
    model = train_model(cfg, seed=0)
    # each line is a run of its own: its precision, its accumulation window
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    accelerator = Accelerator(mixed_precision=mixed_precision, gradient_accumulation_steps=2,
                              **(accelerator_kw or {}))
    model = accelerator.prepare(model)
    cfg = model.config
    a, dataset = train_data(cfg, repeats)
    path_check = attention_path_check(
        accelerator, model, cfg, {"input_ids": torch.from_numpy(a[:1]).cuda()}
    ) if with_path_check else None

    host_before = host_available_gb()
    t0 = time.perf_counter()
    state = accelerator.create_train_state(params=model, tx=LLAMA2_ADAMW)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    offloaded = isinstance(state.optimizer, ChunkedOptimizer)
    step = accelerator.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    loader = accelerator.prepare(SimpleDataLoader(dataset, batch_size=rows))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fp8.launches = 0
    metrics, step_s, update_s = [], [], []
    for batch in loader:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
        if offloaded and accelerator.sync_gradients:
            update_s.append(state.optimizer.last_step_s)
    launches = {"flash_fwd": fa.flash_fwd.launches, "flash_dq": fa.flash_dq.launches,
                "flash_dkv": fa.flash_dkv.launches}
    scaled_mm_launches = fp8.launches
    peak = torch.cuda.max_memory_allocated()
    host = [{k: v.item() for k, v in m.items()} for m in metrics]
    micro = len(host)

    # model FLOPs of a micro-step: 6 x matrix parameters x tokens (the
    # embedding is a gather, not a product) plus 3 x the attention forward
    # (4 D flops per visible (query head, key) pair; the backward is twice
    # the forward)
    tokens = rows * seq
    # (a tied head multiplies by the embedding: Gemma's)
    head = "embed_tokens.weight" if cfg.tie_word_embeddings else "lm_head.weight"
    # an MoE layer's experts count at their active share k / E (the dense
    # formulation computes more: every expert over its whole capacity)
    active = cfg.num_experts_per_tok / cfg.num_experts if cfg.num_experts else 1.0
    matrix_params = sum(int(np.prod(shape)) * (active if ".experts." in name else 1.0)
                        for name, shape in state_dict_shapes(cfg).items()
                        if name.endswith("proj.weight") or name == head)
    attn_fwd = 4 * cfg.resolved_head_dim * cfg.num_heads * layers * rows * seq * (seq + 1) // 2
    flops = 6 * matrix_params * tokens + 3 * attn_fwd
    # a micro-step's share of an optimizer step (accumulate + apply), the
    # median over the optimizer steps after the first (where AdamW allocates
    # its moments), so that one slow step does not set it
    steady = float(np.median([(step_s[i] + step_s[i + 1]) / 2
                              for i in range(2, micro - 1, 2)]))
    applied = [h for h in host if h["applied"]]
    moe_rec = {}
    if cfg.num_experts:
        # the router's aux loss is finite and in the loss: cross entropy plus
        # the coefficient times the layers' collected aux losses
        from accelerate_tpu_torch.models.transformer import cross_entropy_loss, shift_labels
        from accelerate_tpu_torch.parallel.moe import collect_router_aux, router_aux_loss

        ids = {"input_ids": torch.from_numpy(a).cuda()}
        params = accelerator._compute_params(model)
        with torch.no_grad():
            with collect_router_aux() as sown:
                logits = torch.func.functional_call(model, params, (ids["input_ids"],))
            ce = cross_entropy_loss(logits.float(), shift_labels(ids)).item()
            del logits
            total = lm_loss_fn(model)(params, ids).item()
        aux = router_aux_loss(sown, cfg.router_aux_loss_coef).item()
        del params
        moe_rec = {"moe": {"experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
                           "capacity": cfg.resolved_expert_capacity(rows * seq),
                           "aux_coef": cfg.router_aux_loss_coef, "aux_term": aux,
                           "aux_per_layer": [x.item() for x in sown], "cross_entropy": ce,
                           "loss": total}}
        check(np.isfinite(aux) and len(sown) == layers, f"router aux loss {aux} over "
              f"{len(sown)} layers")
        check(abs(total - (ce + aux)) <= 1e-4 * abs(total),
              f"the MoE loss {total} is not cross entropy {ce} + aux {aux}")
    offload_rec = {}
    if offloaded:
        opt = state.optimizer
        update = float(np.median(update_s))
        offload_rec = {"offload": {
            "chunk_mb": accelerator.fsdp_plugin.offload_update_chunk_mb,
            "overlap": opt.overlap, "master_weights": accelerator._offload_master,
            "tier": type(opt.store).__name__, "chunks": len(opt.chunks),
            "host_state_bytes": opt.host_bytes,
            "host_pinned_bytes": opt.store.pinned_bytes(),
            "host_alloc_s": opt.alloc_s,
            "create_train_state_s": create_s,
            "host_available_gb_before": host_before,
            "host_available_gb_after": host_available_gb(),
            "update_s_each": update_s, "update_ms": update * 1e3,
            "chunk_ms": update * 1e3 / len(opt.chunks),
            # each chunk's state crosses PCIe twice a sync step: in and out
            "pcie_gb_per_s": 2 * opt.host_bytes / update / 1e9,
            "working_dtype": str(next(model.parameters()).dtype).replace("torch.", "")}}
        # the host tier streams from page-locked memory, never through
        # pageable bounce copies
        check(offload_rec["offload"]["tier"] != "HostChunkStore"
              or opt.store.pinned_bytes() == opt.host_bytes,
              f"{opt.store.pinned_bytes()} of the host state's {opt.host_bytes} bytes pinned")
    rec = {
        "phase": name, "config": config, "layers": layers, "of_layers": of_layers,
        "head_dim": cfg.resolved_head_dim, "remat": cfg.remat and cfg.remat_policy,
        "compilation_remat": accelerator.compilation_config.remat_policy, **offload_rec,
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
        "mixed_precision": mixed_precision, "scaled_mm_launches": scaled_mm_launches,
        **moe_rec,
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
    # a remat recompute relaunches the flash forward (K3) in the backward
    recompute = cfg.remat or accelerator.compilation_config.remat_policy not in (
        "none", "everything_saveable")
    for name, n in launches.items():
        per = 2 if recompute and name == "flash_fwd" else 1
        check(n == per * micro * layers,
              f"{name} launched {n} times, want {per} x {micro} x {layers}")
    if mixed_precision == "fp8":
        # every attention and MLP projection: its forward and both gradients
        want = micro * layers * 3 * (7 if cfg.gated_mlp else 6)
        check(scaled_mm_launches == want,
              f"_scaled_mm launched {scaled_mm_launches} times, want {want}")
    if path_check is not None:
        check(path_check["loss_err"] <= path_check["loss_tolerance"],
              f"flash vs xla loss differ by {path_check['loss_err']}")
        check(path_check["grad_rel_err"] <= path_check["grad_tolerance"],
              f"flash vs xla gradients differ by {path_check['grad_rel_err']} (relative)")
    if keep_weights:
        rec["weights"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del state, step, loader, model, accelerator
    free_card()
    return launches, rec


#: the card's fp8 linear against its plain version (quantize -> dequantize
#: in bf16, then a bf16 product): ``||got - plain|| / ||plain||`` of the
#: output and both gradients.  The plain version rounds the dequantized
#: operands and the product to bf16 (2^-9 each), the card multiplies the
#: fp8 codes exactly and rounds once
FP8_LINEAR_REL_TOL = 2.0**-7
#: ``train_fp8`` against ``train`` over the first accumulation window, where
#: both hold the same weights and batches (after the first update the two
#: runs follow their own trajectories: fp8 operands carry 3 mantissa bits):
#: each loss within this relative distance, each grad norm within
#: ``FP8_TRAIN_GRAD_NORM_REL_TOL``
FP8_TRAIN_LOSS_REL_TOL = 1e-2
FP8_TRAIN_GRAD_NORM_REL_TOL = 0.1


def fp8_linear_check(gpu, m: int = TRAIN_ROWS * TRAIN_SEQ, k: int = 4096, n: int = 11008) -> dict:
    """``FP8Linear`` on the card (``_scaled_mm``: the forward and both
    gradients) at the training shape of an MLP up-projection against its
    plain version on the same inputs; then ms of its forward and of its
    forward + backward beside a bf16 ``F.linear``'s (the library call) and
    the bound of the fp8 product (operations at the fp8 peak, or the bytes
    of the bf16 operands read once and the output written once)."""
    from accelerate_tpu_torch.ops import fp8

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=gen)
    lin = fp8.FP8Linear(k, n, bias=False, compute_dtype=torch.bfloat16, device="cuda",
                        dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=gen)
    g = torch.randn(m, n, device="cuda", dtype=torch.bfloat16, generator=gen) * 1e-3
    xr = x.clone().requires_grad_()
    out = lin(xr)
    out.backward(g)
    dx, dw = xr.grad, lin.weight.grad
    want = fp8.plain_fp8_linear(x, lin.weight.detach())
    want_dx, want_dw_t = fp8.plain_fp8_grads(x, lin.weight.detach().t(), g)
    rel = {name: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for name, a, b in (("out", out.detach(), want), ("dx", dx, want_dx),
                              ("dw", dw, want_dw_t.t()))}
    lin.weight.grad = None
    w = lin.weight.detach()

    def fwd_bwd(f):
        def run():
            xi = x.detach().requires_grad_()
            f(xi).backward(g)
        return run

    with torch.no_grad():
        ms = time_ms(lambda: lin(x), iters=20)
        bf16_ms = time_ms(lambda: torch.nn.functional.linear(x, w), iters=20)
    train_ms = time_ms(fwd_bwd(lin), iters=10)
    lin.weight.grad = None
    dense = torch.nn.Linear(k, n, bias=False, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        dense.weight.copy_(w)
    bf16_train_ms = time_ms(fwd_bwd(dense), iters=10)
    flops = 2 * m * k * n
    bound = max(flops / 1979e12, 2 * (m * k + k * n + m * n) / HBM_BYTES_PER_S) * 1e3
    rec = {"phase": "fp8_linear", "shape": [m, k, n], "rel_err": rel,
           "tolerance": FP8_LINEAR_REL_TOL, "fwd_ms": ms, "plain_or_library_bf16_fwd_ms": bf16_ms,
           "fwd_bwd_ms": train_ms, "bf16_fwd_bwd_ms": bf16_train_ms,
           "fwd_bound_ms": bound, "fwd_bound_by": "operations" if flops / 1979e12 * 1e3 >= bound
           else "bytes", "gpu": gpu}
    emit(rec)
    for name, err in rel.items():
        check(err <= FP8_LINEAR_REL_TOL, f"the card fp8 linear's {name} differs from its plain "
              f"version by {err} (relative) > {FP8_LINEAR_REL_TOL}")
    del x, g, xr, out, dx, dw, lin, dense
    free_card()
    return rec


def train_fp8_phase(gpu, train_rec) -> dict:
    """``train``'s model, batches and loop under ``Accelerator(
    mixed_precision="fp8")``: every projection through ``_scaled_mm`` (its
    forward and both gradients), attention on K3-K5; the first
    accumulation window's losses and grad norms (the same weights and
    batches as ``train``'s) held against ``train``'s bf16 run, every
    micro-step's distance printed.  Returns the flash launches."""
    fp8_linear_check(gpu)
    launches, rec = train_phase(gpu, name="train_fp8", mixed_precision="fp8",
                                with_path_check=False)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(rec["loss"], train_rec["loss"])]
    norm_rel = [abs(a - b) / abs(b) for a, b in zip(rec["grad_norm"], train_rec["grad_norm"])]
    window = rec["applied"].index(True) + 1
    emit({"phase": "train_fp8_vs_train", "held_micro_steps": window, "loss_rel_diff": loss_rel,
          "grad_norm_rel_diff": norm_rel, "loss_tolerance": FP8_TRAIN_LOSS_REL_TOL,
          "grad_norm_tolerance": FP8_TRAIN_GRAD_NORM_REL_TOL,
          "step_ms": rec["step_ms"], "train_step_ms": train_rec["step_ms"],
          "step_ms_ratio": rec["step_ms"] / train_rec["step_ms"],
          "max_memory_allocated_gb": rec["max_memory_allocated_gb"],
          "train_max_memory_allocated_gb": train_rec["max_memory_allocated_gb"], "gpu": gpu})
    check(max(loss_rel[:window]) <= FP8_TRAIN_LOSS_REL_TOL,
          f"train_fp8's first-window loss strays {max(loss_rel[:window])} (relative) "
          "from train's")
    check(max(norm_rel[:window]) <= FP8_TRAIN_GRAD_NORM_REL_TOL,
          f"train_fp8's first-window grad norm strays {max(norm_rel[:window])} (relative) "
          "from train's")
    return launches


#: Mixtral-8x7B's widths at 1 of its 32 layers for ``train_moe``: 1.71 B
#: parameters, 1.41 B of them the layer's eight experts
MOE_TRAIN_LAYERS = 1


def moe_train_config():
    from accelerate_tpu_torch.models.hf_compat import MIXTRAL_8X7B, config_from_hf_dict

    return config_from_hf_dict(MIXTRAL_8X7B, num_layers=MOE_TRAIN_LAYERS, dtype=torch.bfloat16,
                               param_dtype=torch.float32, attention_impl="pallas")


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


def free_card(host: bool = False) -> None:
    """Collect garbage and return the card's cached blocks; with ``host``,
    also the pinned host blocks torch's caching host allocator keeps (the
    prefix cache's host ring, the nvme tier's bounce buffers), before a line
    that needs the host's memory (``train_full``'s 81 GB)."""
    gc.collect()
    torch.cuda.empty_cache()
    if host:
        torch._C._host_emptyCache()


def train_api_phase(gpu, train_rec):
    """The reference's loop shape on ``train``'s model, batches and recipe:
    a fresh model from the same seed, 8 micro-steps through
    ``compute_gradients`` + ``apply_gradients``, held call by call against
    ``train``'s losses and grad norms."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.models.transformer import lm_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    free_card()
    cfg = train_config(TRAIN_LAYERS)
    model = train_model(cfg, seed=0)
    # a run of its own: no plugin or precision of an earlier line's
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
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


# --------------------------------------------------- single-card training memory
#: ``train_full``'s offload tier, chosen from the card machine's resources
#: (read by a first short call: 96 GiB of host RAM, of which 84 GiB were
#: granted as pinned memory in 29 s; 75 GB of free disk, less than the 81 GB
#: of state): pinned host memory.  Never a fallback at run time.
FULL_OFFLOAD_TIER = "pinned host memory"
REMAT_POLICY_LAYERS = 2
#: ``train_offload`` against ``train`` over the first accumulation window
#: (equal weights): the bf16 gradient buffer against train's f32 one moves
#: the second micro-step's grad norm by the buffer's rounding, 2^-8 relative
#: at most
OFFLOAD_GRAD_NORM_REL_TOL = 2.0**-8


def train_remat_phase(gpu, train_rec) -> dict:
    """``train``'s model, batches and loop with per-layer remat
    (``TransformerConfig(remat=True, remat_policy="full")``): losses and
    grad norms bitwise ``train``'s (the recompute repeats the forward's
    kernels on the same values), K3 launched twice a layer a micro-step,
    the peak below ``train``'s."""
    cfg = dataclasses.replace(train_config(TRAIN_LAYERS), remat=True, remat_policy="full")
    launches, rec = train_phase(gpu, cfg, name="train_remat", with_path_check=False)
    same = rec["loss"] == train_rec["loss"] and rec["grad_norm"] == train_rec["grad_norm"]
    emit({"phase": "train_remat_vs_train", "bitwise": same,
          "max_memory_allocated_gb": rec["max_memory_allocated_gb"],
          "train_max_memory_allocated_gb": train_rec["max_memory_allocated_gb"],
          "step_ms": rec["step_ms"], "train_step_ms": train_rec["step_ms"],
          "step_ms_ratio": rec["step_ms"] / train_rec["step_ms"], "gpu": gpu})
    check(same, "train_remat's losses or grad norms differ from train's")
    check(rec["max_memory_allocated_gb"] < train_rec["max_memory_allocated_gb"],
          f"train_remat's peak {rec['max_memory_allocated_gb']} GB is not below train's "
          f"{train_rec['max_memory_allocated_gb']} GB")
    return launches


def remat_policies_phase(gpu) -> dict:
    """Llama-2-7B's widths at ``REMAT_POLICY_LAYERS`` layers: one micro-step
    (2 x 2048 tokens, bf16 compute from f32 masters, flash path) without
    remat, under each per-layer policy and under ``CompilationConfig``'s
    over-the-loss remat (``Accelerator._maybe_remat``): loss and gradients
    bitwise the plain step's, the activation peak (the peak above what was
    allocated when the step began) and the ms of a micro-step (median of 3
    after a warm-up), K3's launches."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.transformer import Transformer, lm_loss_fn
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import CompilationConfig

    free_card()
    base_cfg = train_config(REMAT_POLICY_LAYERS)
    base = train_model(base_cfg, seed=0)
    masters = list(base.parameters())
    ids = torch.from_numpy(train_data(base_cfg)[0]).cuda()
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)

    def run(model, wrap=None):
        loss_fn = lm_loss_fn(model)
        if wrap is not None:
            loss_fn = wrap(loss_fn)
        times, peak = [], 0
        for i in range(4):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
            loss = loss_fn(params, {"input_ids": ids})
            grads = torch.autograd.grad(loss, masters)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peak = max(peak, torch.cuda.max_memory_allocated() - resident)
            fwd = fa.flash_fwd.launches
            if i < 3:
                del params, grads
        return loss.detach(), grads, float(np.median(times[1:])) * 1e3, peak, fwd

    def variant(cfg):
        model = Transformer(cfg, device="meta")
        model.load_state_dict(base.state_dict(keep_vars=True), assign=True)
        return model

    loss0, grads0, ms0, peak0, fwd0 = run(base)
    rows = [{"policy": "none", "ms": ms0, "activation_peak_gb": peak0 / 1e9, "flash_fwd": fwd0}]
    arms = [(f"layer:{p}", variant(dataclasses.replace(base_cfg, remat=True, remat_policy=p)),
             None) for p in ("full", "nothing_saveable", "dots_saveable",
                             "dots_with_no_batch_dims_saveable", "proj_saveable")]
    acc = Accelerator(compilation_config=CompilationConfig(remat_policy="full"))
    arms.append(("loss:full (CompilationConfig)", base, acc._maybe_remat))
    for label, model, wrap in arms:
        loss, grads, ms, peak, fwd = run(model, wrap)
        same = torch.equal(loss, loss0) and all(torch.equal(a, b) for a, b in zip(grads, grads0))
        rows.append({"policy": label, "bitwise": same, "ms": ms,
                     "activation_peak_gb": peak / 1e9, "flash_fwd": fwd})
        del grads
        check(same, f"remat {label}: loss or gradients differ from the plain step's")
        check(fwd == 2 * REMAT_POLICY_LAYERS,
              f"remat {label}: K3 launched {fwd} times, want 2 x {REMAT_POLICY_LAYERS}")
        # saving nothing inside a layer keeps one input a layer; the
        # over-the-loss arm recomputes the whole forward at once in the
        # backward, so its peak is the plain one's (it is printed)
        if label in ("layer:full", "layer:nothing_saveable"):
            check(peak < peak0, f"remat {label}: peak {peak / 1e9} GB not below the plain "
                  f"step's {peak0 / 1e9} GB")
    emit({"phase": "remat_policies", "config": "llama2_7b", "layers": REMAT_POLICY_LAYERS,
          "of_layers": 32, "tokens": int(ids.numel()), "arms": rows, "gpu": gpu})
    del base, masters, arms, grads0, acc
    free_card()


def train_offload_phase(gpu, train_rec) -> dict:
    """``train``'s model, batches and loop with the optimizer offloaded
    (``FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD",
    offload_optimizer=True)``: f32 masters and AdamW moments in pinned
    host memory, 512 MB chunks, bf16 working weights and gradient buffer
    on the card).  The first accumulation window (equal weights) against
    ``train``: losses bitwise, grad norms within
    ``OFFLOAD_GRAD_NORM_REL_TOL``.  After the 4 updates its weights bitwise
    those of the same run with one chunk (the whole state round-trips) and
    with ``offload_update_overlap=2``; and ``offload_update_chunk_mb=0``
    (the reference's whole-state round trip without master weights: f32
    weights on the card, the moments offloaded) bitwise ``train``'s."""
    launches, rec = train_phase(gpu, name="train_offload", with_path_check=False,
                                accelerator_kw=dict(fsdp_plugin=offload_plugin()),
                                keep_weights=True)
    weights = rec.pop("weights")
    window = rec["applied"].index(True) + 1
    loss_same = rec["loss"][:window] == train_rec["loss"][:window]
    norm_rel = [abs(a - b) / abs(b) for a, b in zip(rec["grad_norm"], train_rec["grad_norm"])]
    twins = {}
    for label, kw in (("one_chunk", dict(offload_update_chunk_mb=1 << 20)),
                      ("overlap_2", dict(offload_update_overlap=2)),
                      ("chunk_mb_0", dict(offload_update_chunk_mb=0))):
        _, twin = train_phase(gpu, name=f"train_offload_{label}", with_path_check=False,
                              accelerator_kw=dict(fsdp_plugin=offload_plugin(**kw)),
                              keep_weights=True)
        want = train_rec["weights"] if label == "chunk_mb_0" else weights
        twins[label] = all(torch.equal(twin["weights"][n], w) for n, w in want.items())
        del twin
    emit({"phase": "train_offload_vs", "first_window_micro_steps": window,
          "losses_bitwise_train": loss_same, "grad_norm_rel_diff_train": norm_rel,
          "grad_norm_tolerance": OFFLOAD_GRAD_NORM_REL_TOL,
          "weights_bitwise": twins, "step_ms": rec["step_ms"],
          "train_step_ms": train_rec["step_ms"],
          "max_memory_allocated_gb": rec["max_memory_allocated_gb"],
          "train_max_memory_allocated_gb": train_rec["max_memory_allocated_gb"], "gpu": gpu})
    check(loss_same, "train_offload's first-window losses differ from train's")
    check(max(norm_rel[:window]) <= OFFLOAD_GRAD_NORM_REL_TOL,
          f"train_offload's first-window grad norm strays {max(norm_rel[:window])} from train's")
    check(twins["one_chunk"], "the 512 MB chunks' weights differ from one chunk's")
    check(twins["overlap_2"], "overlap 2's weights differ from overlap 1's")
    check(twins["chunk_mb_0"], "offload_update_chunk_mb=0's weights differ from train's")
    del weights
    return launches


def train_full_phase(gpu) -> dict:
    """The slice's headline: Llama-2-7B at all 32 layers on one card,
    per-layer remat ("full") and the offloaded optimizer with f32 master
    weights (512 MB chunks, ``FULL_OFFLOAD_TIER``): 4 micro-steps of 2 x
    2048 tokens at accumulation 2 through ``compile_train_step``, K3-K5 on
    every layer (K3 again in the recompute)."""
    cfg = dataclasses.replace(train_config(32), remat=True, remat_policy="full")
    launches, rec = train_phase(gpu, cfg, name="train_full", with_path_check=False,
                                accelerator_kw=dict(fsdp_plugin=offload_plugin()), repeats=2)
    emit({"phase": "train_full_summary", "offload_tier": FULL_OFFLOAD_TIER,
          "layers": 32, "launches": launches,
          "max_memory_allocated_gb": rec["max_memory_allocated_gb"],
          "host_state_gb": rec["offload"]["host_state_bytes"] / 1e9,
          "step_ms_each": rec["step_ms_each"], "update_ms": rec["offload"]["update_ms"],
          "pcie_gb_per_s": rec["offload"]["pcie_gb_per_s"],
          "mfu_vs_989_tflops": rec["mfu_vs_989_tflops"], "loss": rec["loss"], "gpu": gpu})
    check(launches == {"flash_fwd": 256, "flash_dq": 128, "flash_dkv": 128},
          f"train_full's launches {launches}")
    check(rec["max_memory_allocated_gb"] < 80, "train_full's peak is past the card")
    return launches


def checkpoint_offload_phase(gpu) -> dict:
    """The ``checkpoint`` line's mid-window save and resume with the
    optimizer offloaded, once with its state in pinned host memory and once
    in files (the nvme tier): 1 of 32 layers at full width, 512 MB chunks,
    the reference loop, 3 calls (accumulation 2: the save holds one
    micro-step), ``save_state``, ``load_state`` into a fresh accelerator and
    a state from another seed, 1 more call (the update that needs the
    restored buffer, masters and moments); losses, grad norms, the final
    working weights and the masters and second moments bitwise an
    uninterrupted run of 4 with the state in host memory (so the nvme tier
    is held against the host tier too).  Each nvme sync step moves the
    whole state through files twice, so the calls and layers are kept few."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.transformer import lm_loss_fn
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    layers = 1
    cfg = train_config(layers)
    rng = np.random.default_rng(8)
    batches = [{"input_ids": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (TRAIN_ROWS, TRAIN_SEQ)).astype(np.int32)).cuda()} for _ in range(4)]
    tmp = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="atpu_offload_ckpt_", dir=tmp)
    out = {}
    try:
        for tier in ("host", "nvme"):
            def trainer(seed, run):
                GradientState._reset_state()
                AcceleratorState._reset_state(reset_partial_state=True)
                kw = {} if tier == "host" else dict(
                    offload_optimizer_nvme_path=os.path.join(root, f"nvme_{run}"))
                model = train_model(cfg, seed=seed)
                acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2,
                                  fsdp_plugin=offload_plugin(**kw))
                state = acc.create_train_state(params=model, tx=LLAMA2_ADAMW)
                return acc, state, reference_loop_call(acc, state, lm_loss_fn(model))

            def finals(state):
                return ([p.detach().cpu() for p in state.model.parameters()],
                        state.optimizer.host_state("master"),
                        state.optimizer.host_state("exp_avg_sq"))

            if tier == "host":
                _, state, call = trainer(0, "whole")
                whole = [call(b)[:2] for b in batches]
                want = finals(state)
                del state, call
                free_card()
            acc, state, call = trainer(0, "first")
            chunks, host_bytes = len(state.optimizer.chunks), state.optimizer.host_bytes
            first = [call(b)[:2] for b in batches[:3]]
            check(state.micro_step == 1, f"micro_step {state.micro_step} at the save, want 1")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saved = acc.save_state(os.path.join(root, f"ckpt_{tier}"), state=state)
            save_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(saved) for f in files)
            del acc, state, call
            free_card()
            acc, state, call = trainer(1, "resumed")
            t0 = time.perf_counter()
            acc.load_state(saved, state=state)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            rest = [call(b)[:2] for b in batches[3:]]
            got = finals(state)
            bitwise = first + rest == whole and all(
                torch.equal(x, y) for part_g, part_w in zip(got, want)
                for x, y in zip(part_g, part_w))
            del acc, state, call, got
            free_card()
            out[tier] = {"bitwise": bitwise, "chunks": chunks, "state_bytes": host_bytes,
                         "checkpoint_bytes": nbytes, "save_s": save_s, "load_s": load_s,
                         "save_gb_per_s": nbytes / save_s / 1e9,
                         "load_gb_per_s": nbytes / load_s / 1e9, "losses": first + rest}
            check(bitwise, f"the offloaded ({tier}) resume differs from the uninterrupted run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "checkpoint_offload", "config": "llama2_7b", "layers": layers,
          "of_layers": 32, "uninterrupted": whole, "tiers": out, "gpu": gpu})
    return out


ENGINE_FP8_LAYERS = 4


def engine_fp8_model_phase(gpu, rng, prompts) -> dict:
    """A ``use_fp8`` model (Llama-2-7B's widths at ``ENGINE_FP8_LAYERS``
    layers, random bf16 weights) served by ``ServingEngine(paged=True)``:
    every projection an fp8 product through ``_scaled_mm``, whose decode
    windows have M = 4 lanes (zero-padded to 16 inside ``fp8.scaled_mm``).
    The model line first (``model_use_fp8``: the paged forward against the
    no-cache one, and the noise margin), then two of the ``engine`` line's
    requests: K1 and K2 launched once a layer a forward, as in ``engine``;
    the ``_scaled_mm`` launches counted (graph replays credited); every
    token within the noise margin of the no-cache forward's best logit; the
    same for the sync-eager twin, whose tokens must be the graphed engine's.
    An fp8 product scales its input by the amax of the whole ``[lanes, K]``
    activation, inactive lanes' rows included, and those rows read the null
    page back: the twins agree only because every null-page write lands the
    same on every run (``paged_attention._null_last_writer``) and the engine
    restores the null page its graph captures wrote."""
    from accelerate_tpu_torch.models.transformer import TransformerConfig

    free_card()
    cfg = TransformerConfig.llama2_7b(dtype=torch.bfloat16, num_layers=ENGINE_FP8_LAYERS,
                                      use_fp8=True)
    model = family_model(cfg, affine_std=0.0)
    margin = model_phase(model, cfg, rng, name="model_use_fp8")
    two = [prompts[0], prompts[3]]
    launches, _, tokens = engine_phase(model, cfg, rng, gpu, margin, prompts=two,
                                       name="engine_fp8_model")
    _, _, eager_tokens = engine_phase(model, cfg, rng, gpu, margin, prompts=two,
                                      name="engine_fp8_model_sync_eager", eager=True)
    same = sum(a == b for x, y in zip(tokens, eager_tokens) for a, b in zip(x, y))
    emit({"phase": "engine_fp8_model_vs_sync_eager", "tokens_equal": eager_tokens == tokens,
          "same_token_share": same / sum(len(x) for x in tokens),
          "first_difference": [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
                               for x, y in zip(tokens, eager_tokens)], "gpu": gpu})
    check(eager_tokens == tokens, "the fp8 model's graphed engine and its sync-eager twin "
          f"gave different tokens ({same} of {sum(len(x) for x in tokens)} equal)")
    del model
    free_card()
    return launches


# -------------------------------------------------------- big-model inference
GEN_LENS = (64, 192, 320, 512)  # the generate line's prompts, one call each
GEN_NEW = 32
STREAM_NEW = 16
STREAM_LAYERS = 4  # stream_disk's and stream_forward's depth, at Llama-2-7B width
MIXTRAL_CARD_BUDGET = 60e9  # max_memory[0] of big_mixtral: the card's weights
MIXTRAL_PROMPT, MIXTRAL_NEW = 128, 8


def model_bytes(sd) -> int:
    return sum(t.numel() * t.element_size() for t in sd.values())


def h2d_gb_per_s(nbytes: int = 1 << 30, reps: int = 8) -> float:
    """The host-to-card rate of one pinned (``cudaHostRegister``ed) copy of
    ``nbytes``: the fastest of ``reps`` copies, each between CUDA events,
    after a warm-up (the least time the link took, the basis of a bound)."""
    from accelerate_tpu_torch.utils.offload import pinned_host_buffer

    host = pinned_host_buffer(nbytes)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return nbytes / best / 1e9


def timed(fn):
    """``(fn(), seconds)``, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def manual_greedy(prefill, decode, ids, steps):
    """Greedy tokens and each step's last-position logits from a prefill
    callable and a one-token decode callable, ``steps`` tokens."""
    logits = prefill(ids)
    rows, toks = [logits[:, -1]], []
    for _ in range(steps):
        toks.append(rows[-1].argmax(-1).to(torch.int32))
        if len(toks) == steps:
            break
        rows.append(decode(toks[-1])[:, -1])
    return torch.stack(toks, 1), rows, logits


def generate_phase(model, cfg, rng, gpu, tol) -> None:
    """``generate``: Llama-2-7B resident on the card, one greedy call of 32
    new tokens for each of 4 prompts of 64-512 tokens (the static loop
    runs one batch of equal-length prompts; the reference's benchmark
    generates prompt by prompt).  Each call's tokens must equal a manual
    ``make_prefill_step``/``make_decode_step`` loop's (``generate`` replays
    its decode step as a CUDA graph, the loop runs it eagerly), and every
    step's logits (the prompt's, then each decode step's) lie within
    ``tol`` (the ``model`` line's margin) of the no-cache forward of the
    same sequence.  s/token (the call's wall over its new tokens, prefill
    and capture included) and the decode step's ms, graphed and eager
    (CUDA events around 8 steps), beside the bound: every weight read once
    a step at the HBM rate."""
    from accelerate_tpu_torch.models import generation as gen
    from accelerate_tpu_torch.models.transformer import KVCache

    weights = model_bytes(model.state_dict())
    bound_ms = 1e3 * weights / HBM_BYTES_PER_S
    prefill, decode = gen.make_prefill_step(model), gen.make_decode_step(model)
    calls = []
    for n in GEN_LENS:
        ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, n)).astype(np.int64)).cuda()
        gen.generate(model, None, ids[:, :8], max_new_tokens=2)  # warm-up
        (seq, _), wall = timed(lambda: gen.generate(model, None, ids, max_new_tokens=GEN_NEW))
        # room for the loop and the timed steps after it (eager, then graphed)
        cache = KVCache.create(cfg, 1, n + GEN_NEW + 24, device="cuda")
        box = [cache]

        def pre(x):
            logits, box[0] = prefill(None, x, box[0])
            return logits

        def dec(tok):
            logits, box[0] = decode(None, tok, box[0])
            return logits[:, None]

        (toks, rows, prompt_logits), _ = timed(lambda: manual_greedy(pre, dec, ids, GEN_NEW))
        eager_ms = decode_step_ms(dec, toks[:, -1], 8)
        graphed = gen.make_graphed_decode_step(model, None, toks[:, -1], box[0])
        decode_ms = decode_step_ms(graphed, toks[:, -1], 8)
        check(torch.equal(seq[:, n:].to(torch.int32), toks),
              f"generate: prompt {n}: tokens differ from the manual prefill/decode loop")
        ref = no_cache_logits(model, seq[0, :-1].cpu().numpy().astype(np.int32))
        steps = torch.cat([prompt_logits[0], torch.stack([r[0] for r in rows[1:]])])
        err = (steps - ref).abs().max().item()
        calls.append({"prompt": n, "new_tokens": GEN_NEW, "wall_s": wall,
                      "s_per_token": wall / GEN_NEW, "decode_ms_per_step": decode_ms,
                      "eager_decode_ms_per_step": eager_ms, "max_abs_logit_err": err})
        check(err <= tol, f"generate: prompt {n}: logits differ from the no-cache forward by "
              f"{err} > {tol}")
    emit({"phase": "generate", "gpu": gpu, "calls": calls, "tolerance": tol,
          "s_per_token": sum(c["wall_s"] for c in calls) / (GEN_NEW * len(calls)),
          "decode_ms_per_step": float(np.median([c["decode_ms_per_step"] for c in calls])),
          "eager_decode_ms_per_step": float(np.median([c["eager_decode_ms_per_step"]
                                                       for c in calls])),
          "weights_gb": weights / 1e9, "bound_ms_per_step": bound_ms, "bound_by": "bytes"})


def decode_step_ms(dec, tok, reps: int) -> float:
    """ms of one more decode step (CUDA events around ``reps`` of them)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dec(tok)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stream_offload_phase(model, cfg, rng, gpu) -> None:
    """``stream_offload``: the same model under ``cpu_offload`` (all 13.5 GB
    in one pinned host block, the two stream buffers on the card), one
    prompt of 512 tokens, 16 greedy tokens through
    ``StreamingTransformer.generate``.  The prefill logits must be bitwise
    the resident model's on the same cache, and the tokens equal the
    resident ``generate``'s.  s/token, the streamed GB/s (bytes copied over
    the wall), the card memory the streaming adds beyond the model already
    on it (the peak from the streamer's creation through the prefill check
    and the generation, less what was allocated before: the two buffers,
    the cache and the activations), and the bound: the host bytes over the H2D
    rate this run measures on one pinned 1 GiB copy."""
    from accelerate_tpu_torch.big_modeling import StreamingTransformer, cpu_offload
    from accelerate_tpu_torch.models import generation as gen
    from accelerate_tpu_torch.models.transformer import KVCache

    rate = h2d_gb_per_s()
    (placed, loader), place_s = timed(lambda: cpu_offload(model.state_dict()))
    host_bytes = model_bytes(placed)
    check(all(t.is_pinned() for t in placed.values()), "cpu_offload: a weight is not pinned")
    free_card()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = StreamingTransformer(cfg, placed, weights_loader=loader)
    n = GEN_LENS[-1]
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, n)).astype(np.int64)).cuda()
    kinds = [st._resolve(i).kind for i in range(len(st.plan))]
    check(set(kinds) == {"pinned"}, f"stream_offload: stage kinds {set(kinds)}, want pinned")
    cache = st.init_cache(1, n)
    logits, _ = st.forward_with_cache(ids, cache)
    with torch.inference_mode():
        ref, _ = model(ids, cache=KVCache.create(cfg, 1, n, device="cuda"))
    diff = (logits - ref).abs().max().item()
    check(torch.equal(logits, ref), f"stream_offload: prefill logits differ from the resident "
          f"model's by up to {diff}")
    seq, wall = timed(lambda: st.generate(ids, max_new_tokens=STREAM_NEW))
    extra = torch.cuda.max_memory_allocated() - start
    want, _ = gen.generate(model, None, ids, max_new_tokens=STREAM_NEW)
    check(torch.equal(seq, want.cpu()), "stream_offload: tokens differ from generate's")
    emit({"phase": "stream_offload", "gpu": gpu, "prompt": n, "new_tokens": STREAM_NEW,
          "host_gb": host_bytes / 1e9, "place_s": place_s, "wall_s": wall,
          "s_per_token": wall / STREAM_NEW,
          "streamed_gb_per_forward": st.last_bytes_streamed / 1e9,
          "streamed_gb_per_s": st.last_bytes_streamed * STREAM_NEW / wall / 1e9,
          "h2d_gb_per_s_pinned_1gib": rate, "bound_s_per_token": host_bytes / 1e9 / rate,
          "bound_by": "bytes", "peak_card_gb_beyond_start": extra / 1e9,
          "slot_gb": 2 * st._slots[0].numel() / 1e9,
          "prefill_logits_bitwise": True})
    del st, placed, loader
    free_card()


def stream_disk_phase(gpu) -> None:
    """``stream_disk``: Llama-2-7B width at 4 layers (random bf16 weights,
    seed 1), layers 2 and 3 in ``disk_offload``'s ``.dat`` files (written
    just before: the reads hit a warm page cache), the rest on the card;
    a 128-token prompt, 16 greedy tokens, identical to the resident twin's
    ``generate``.  s/token and the GB/s of the mapped stages."""
    from accelerate_tpu_torch.big_modeling import StreamingTransformer, dispatch_params
    from accelerate_tpu_torch.models import generation as gen
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.weights import init_params

    cfg = TransformerConfig.llama2_7b(num_layers=STREAM_LAYERS, dtype=torch.bfloat16)
    sd = init_params(cfg, seed=1, device="cuda", dtype=torch.bfloat16)
    model = Transformer(cfg, device="meta", dtype=torch.bfloat16)
    model.load_state_dict(sd, assign=True)
    dm = {"embed_tokens": 0, "final_norm": 0, "lm_head": 0,
          **{f"layers.{i}": ("disk" if i >= 2 else 0) for i in range(STREAM_LAYERS)}}
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (1, 128)).astype(np.int64)).cuda()
    want, _ = gen.generate(model, None, ids, max_new_tokens=STREAM_NEW)
    folder = tempfile.mkdtemp(prefix="stream_disk_")
    try:
        (placed, loader), write_s = timed(lambda: dispatch_params(sd, dm, offload_folder=folder))
        disk_bytes = sum(loader[k].numel() * loader[k].element_size() for k in loader.index)
        st = StreamingTransformer(cfg, placed, dm, loader)
        kinds = [st._resolve(i).kind for i in range(len(st.plan))]
        check(kinds.count("mapped") == 2, f"stream_disk: stage kinds {kinds}")
        seq, wall = timed(lambda: st.generate(ids, max_new_tokens=STREAM_NEW))
        check(torch.equal(seq, want.cpu()), "stream_disk: tokens differ from the resident "
              "twin's")
        emit({"phase": "stream_disk", "gpu": gpu, "layers": STREAM_LAYERS, "disk_layers": 2,
              "disk_gb": disk_bytes / 1e9, "write_s": write_s, "wall_s": wall,
              "s_per_token": wall / STREAM_NEW,
              "streamed_gb_per_s": st.last_bytes_streamed * STREAM_NEW / wall / 1e9,
              "page_cache": "warm (the files were just written)"})
        del st, placed, loader
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    del model, sd
    free_card()


def stream_forward_phase(gpu) -> dict:
    """``stream_forward``: the streamed no-cache forward at
    ``attention_impl="pallas"`` (Llama-2-7B width, 4 layers, every module on
    pinned host), 2 x 2048 tokens: logits bitwise the resident model's at
    the same setting, K3 launched exactly once a layer, counted over the
    streamed forward alone; K3 held against its plain version at that
    shape (``flash_case``).  Returns K3's launches on the path."""
    from accelerate_tpu_torch.big_modeling import StreamingTransformer, cpu_offload
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.weights import init_params

    cfg = TransformerConfig.llama2_7b(num_layers=STREAM_LAYERS, dtype=torch.bfloat16,
                                      attention_impl="pallas")
    sd = init_params(cfg, seed=2, device="cuda", dtype=torch.bfloat16)
    model = Transformer(cfg, device="meta", dtype=torch.bfloat16)
    model.load_state_dict(sd, assign=True)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 2048)).astype(np.int64)).cuda()
    with torch.inference_mode():
        ref, resident_s = timed(lambda: model(ids))
    placed, loader = cpu_offload(sd)
    st = StreamingTransformer(cfg, placed, weights_loader=loader)
    st(ids[:, :64])  # warm-up
    fa.reset_launch_counts()
    out, wall = timed(lambda: st(ids))
    launches = fa.flash_fwd.launches
    diff = (out - ref).abs().max().item()
    check(torch.equal(out, ref), f"stream_forward: logits differ from the resident forward's "
          f"by up to {diff}")
    check(launches == STREAM_LAYERS, f"stream_forward: K3 launched {launches} times, want "
          f"{STREAM_LAYERS} (one a layer)")
    k3 = flash_case("stream_forward", 430, 2, 2048, 32, 32, torch.bfloat16, True, False)["k3"]
    emit({"phase": "stream_forward", "gpu": gpu, "layers": STREAM_LAYERS, "tokens": 2 * 2048,
          "flash_fwd_launches": launches, "wall_s": wall, "resident_s": resident_s,
          "streamed_gb": st.last_bytes_streamed / 1e9,
          "streamed_gb_per_s": st.last_bytes_streamed / wall / 1e9,
          "logits_bitwise": True, "k3_max_abs_err": k3["max_abs_err"],
          "k3_tolerance": k3["tolerance"]})
    del st, placed, loader, model, sd
    free_card()
    return {"flash_fwd": launches}


def mixtral_run(cfg, device_map, ids):
    """Mixtral drawn by ``init_params(device_map=...)`` and run by
    ``StreamingTransformer``: the greedy tokens, the last step's logits, the
    wall of the prefill and decode loop, the pinned host bytes and the
    peak card memory."""
    from accelerate_tpu_torch.big_modeling import StreamingTransformer
    from accelerate_tpu_torch.weights import init_params

    free_card(host=True)
    torch.cuda.reset_peak_memory_stats()
    sd, init_s = timed(lambda: init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16,
                                           device_map=device_map))
    host = sum(t.numel() * t.element_size() for t in sd.values() if t.device.type == "cpu")
    st = StreamingTransformer(cfg, sd, device_map)
    box = [st.init_cache(1, MIXTRAL_PROMPT + MIXTRAL_NEW)]

    def pre(x):
        logits, box[0] = st.forward_with_cache(x, box[0])
        return logits

    def dec(tok):
        logits, box[0] = st.forward_with_cache(tok[:, None], box[0])
        return logits

    (toks, rows, _), wall = timed(lambda: manual_greedy(pre, dec, ids, MIXTRAL_NEW))
    out = dict(tokens=toks.cpu(), last=rows[-1].float().cpu(), wall_s=wall, init_s=init_s,
               host_bytes=host, card_weight_bytes=model_bytes(sd) - host,
               peak=torch.cuda.max_memory_allocated(), streamed=st.last_bytes_streamed)
    del st, sd, box
    free_card(host=True)
    return out


def big_mixtral_phase(gpu) -> None:
    """``big_mixtral``: Mixtral-8x7B (``hf_compat.MIXTRAL_8X7B``) in bf16, 93.4
    GB, larger than the card: ``infer_auto_device_map`` over
    ``init_empty_weights`` under ``max_memory={0: 60e9, "cpu": ...}`` (the
    default budget's 10 % reserve has no room for the two stream buffers)
    puts the embeddings, the final norm and 20 layers on the card and 12
    layers and the head on pinned host; ``init_params(device_map=...)``
    draws it; one prompt of 128 tokens and 8 greedy tokens streamed.  A
    second run whose map moves layers 0 and 1 to the host and 20 and 21 to
    the card must give the same tokens and last logits.  Peak card memory
    (under 80 GB), pinned host bytes and s/token beside the bound: the
    host bytes over the H2D rate of one pinned 1 GiB copy, measured here,
    plus the card's weights over the HBM rate."""
    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models import hf_compat
    from accelerate_tpu_torch.utils.modeling import compute_module_sizes, infer_auto_device_map

    cfg = hf_compat.config_from_hf_dict(hf_compat.MIXTRAL_8X7B, dtype=torch.bfloat16)
    shapes = init_empty_weights(cfg)
    total = compute_module_sizes(shapes)[""]
    dm = infer_auto_device_map(shapes, {0: MIXTRAL_CARD_BUDGET, "cpu": 10**12}, num_devices=1)
    card_layers = [m for m, d in dm.items() if m.startswith("layers.") and d == 0]
    check(len(card_layers) == 20 and dm["lm_head"] == "cpu",
          f"big_mixtral: {len(card_layers)} layers on the card, want 20")
    moved = {**dm, "layers.0": "cpu", "layers.1": "cpu", "layers.20": 0, "layers.21": 0}
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (1, MIXTRAL_PROMPT)).astype(np.int64)).cuda()
    rate = h2d_gb_per_s()
    first = mixtral_run(cfg, dm, ids)
    second = mixtral_run(cfg, moved, ids)
    check(torch.equal(first["tokens"], second["tokens"]),
          "big_mixtral: tokens depend on the placement")
    diff = (first["last"] - second["last"]).abs().max().item()
    check(diff == 0.0, f"big_mixtral: last logits differ by {diff} between placements")
    bound = first["host_bytes"] / 1e9 / rate + first["card_weight_bytes"] / HBM_BYTES_PER_S
    forwards = MIXTRAL_NEW  # the prefill and 7 decode steps
    emit({"phase": "big_mixtral", "gpu": gpu, "source": "mistralai/Mixtral-8x7B-v0.1 "
          "config.json", "dtype": "bfloat16", "weights_gb": total / 1e9,
          "card_budget_gb": MIXTRAL_CARD_BUDGET / 1e9, "card_layers": len(card_layers),
          "card_weights_gb": first["card_weight_bytes"] / 1e9,
          "pinned_host_gb": first["host_bytes"] / 1e9, "init_s": first["init_s"],
          "prompt": MIXTRAL_PROMPT, "new_tokens": MIXTRAL_NEW, "wall_s": first["wall_s"],
          "s_per_token": first["wall_s"] / forwards,
          "streamed_gb_per_forward": first["streamed"] / 1e9,
          "streamed_gb_per_s": first["streamed"] * forwards / first["wall_s"] / 1e9,
          "h2d_gb_per_s_pinned_1gib": rate, "bound_s_per_token": bound, "bound_by": "bytes",
          "peak_card_gb": first["peak"] / 1e9, "moved_peak_card_gb": second["peak"] / 1e9,
          "moved_s_per_token": second["wall_s"] / forwards,
          "placement_independent": True})
    check(max(first["peak"], second["peak"]) < 80e9, "big_mixtral: peak card memory over 80 GB")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on the card",
              file=sys.stderr)
        return 1
    from accelerate_tpu_torch.models.transformer import TransformerConfig
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving.spec_exec import TreeSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the engine line's debug server listens on localhost only
    os.environ["ATPU_METRICS_HOST"] = "127.0.0.1"
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
    want_tc = 3 * len(pa._WGMMA_HEAD_DIMS) + 3 * len(fa._HEAD_DIMS)
    check(len(tc_entries) == want_tc, f"ptxas reports {len(tc_entries)} tensor-core kernels, "
          f"want {want_tc} (K2 over bf16, int8 and fp8 pages at D {pa._WGMMA_HEAD_DIMS}; K3, "
          f"K4 and K5 at D {fa._HEAD_DIMS})")
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
        # the wide- and narrow-head families at their decode shapes, both q
        # dtypes over every page format: Gemma-7B (16 heads of D 256),
        # Gemma-2B (8 heads of D 256 over one kv head), Phi-2 (32 of D 80),
        # Phi-3-mini (32 of D 96); then each new D's tree arm at S 9
        *wide_head_cases(ragged, 1, 200, WIDE_HEAD_SHAPES),
        ("tree_gemma7b_d256", 230, tree_lanes, 9, 16, 16, bf16, 128, 256, None, tree24),
        ("tree_gemma7b_d256", 231, tree_lanes, 9, 16, 16, f32, 128, 256, None, tree24),
        ("tree_phi2_d80", 232, tree_lanes, 9, 32, 32, bf16, 128, 80, None, tree24),
        ("tree_phi2_d80", 233, tree_lanes, 9, 32, 32, bf16, 128, 80, "int8", tree24),
        ("tree_phi3_d96", 234, tree_lanes, 9, 32, 32, bf16, 128, 96, None, tree24),
        ("tree_phi3_d96", 235, tree_lanes, 9, 32, 32, f32, 128, 96, "fp8", tree24),
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
        # the wide- and narrow-head families' 512-token chunk at base 0, both
        # designs (bf16 q: wgmma; f32 q: the CUDA cores) over every page
        # format, and the engine's 128-token chunk at base 640
        *wide_head_cases([0], 512, 300, WIDE_HEAD_SHAPES, "chunk512_base0"),
        ("gemma7b_d256_chunk128_base640", 330, [640], 128, 16, 16, bf16, 128, 256),
        ("phi2_d80_chunk128_base640", 331, [640], 128, 32, 32, bf16, 128, 80),
        ("phi3_d96_chunk128_base600_page16", 332, [600], 128, 32, 32, bf16, 16, 96, "int8"),
    ], k2_describe, k2_checks)

    cfg = TransformerConfig.llama2_7b(dtype=bf16)
    model = family_model(cfg, affine_std=0.0)  # the Llama line keeps its earlier weights
    rng = np.random.default_rng(0)
    tol = model_phase(model, cfg, rng)
    for fmt in pa.KV_FORMATS:
        quantized_model_phase(model, cfg, rng, fmt, tol)
    launches, prompts, tokens = engine_phase(model, cfg, rng, gpu, tol, telemetry=True)
    telemetry_off_phase(model, cfg, rng, gpu, tol, prompts, tokens)
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
    # big-model inference: the static generate loop on the resident model,
    # then the same weights streamed from pinned host memory
    generate_phase(model, cfg, rng, gpu, tol)
    stream_offload_phase(model, cfg, rng, gpu)
    # the fleet surface (swap_params overwrites the model's weights: last)
    fleet_launches = fleet_phase(model, cfg, gpu, prompts)
    del model
    free_card()
    stream_disk_phase(gpu)
    stream_launches = stream_forward_phase(gpu)
    # the other families: one 7B model on the card at a time; Gemma-7B (16
    # heads of D 256) and Phi-2 (32 of D 80) through K1's and K2's new arms
    family_launches = {"engine_neox": hf_phases(gpu, "neox"), "engine_gpt2": gpt2_phase(gpu)}
    # each new head dim's K1 and K2 launches on the path that runs it
    wide_launches = {256: ("engine_gemma", hf_phases(gpu, "gemma")),
                     80: ("engine_phi2", hf_phases(gpu, "phi2"))}
    wide_launches[96] = ("families:phi3_d96", families_phase(gpu)["phi3_d96"])
    # weight-only quantization: Mixtral-8x7B in int8 (MoE, GQA 32/8), then
    # Llama-2-7B in int4
    family_launches["engine_mixtral"] = mixtral_phases(gpu)
    # Mixtral-8x7B in bf16 (93.4 GB): 20 layers on the card, 12 streamed
    big_mixtral_phase(gpu)
    family_launches["engine_int4"] = int4_phases(gpu)
    # an fp8 model served (its decode windows' M = 4 lanes, padded in the product)
    family_launches["engine_fp8_model"] = engine_fp8_model_phase(gpu, rng, prompts)
    family_launches["fleet"] = fleet_launches

    flash = flash_phase([
        ("train", 13, 2, 2048, 32, 32, bf16, True, False),
        ("train", 14, 2, 2048, 32, 32, f32, True, False),
        ("gqa", 15, 2, 2048, 32, 8, bf16, True, False),
        ("segments3", 16, 2, 1024, 32, 32, bf16, True, True),
        ("full512", 17, 2, 512, 32, 32, bf16, False, False),
        ("gqa_d64", 18, 2, 2048, 32, 8, bf16, True, False, 64),
        # the wide- and narrow-head families at the training shape (B 2, S
        # 2048, causal), bf16 (wgmma) and f32 (CUDA cores); D 32 and 16
        *[(label, 400 + 2 * i + j, 2, 2048, hq, hkv, dtype, True, False, d)
          for i, (label, (hq, hkv, d)) in enumerate(WIDE_HEAD_SHAPES.items())
          for j, dtype in enumerate((bf16, f32))],
        ("gqa_d32", 420, 2, 2048, 32, 8, bf16, True, False, 32),
        ("gqa_d32", 421, 2, 2048, 32, 8, f32, True, False, 32),
        ("gqa_d16", 422, 2, 2048, 32, 8, bf16, True, False, 16),
        ("gqa_d16", 423, 2, 2048, 32, 8, f32, True, False, 16),
    ])
    train_launches, train_rec = train_phase(gpu, keep_weights=True)
    launches.update(train_launches)
    # single-card training memory: remat, the offloaded optimizer, and both
    # at all 32 layers
    train_lines = {"train_remat": train_remat_phase(gpu, train_rec)}
    remat_policies_phase(gpu)
    train_lines["train_offload"] = train_offload_phase(gpu, train_rec)
    del train_rec["weights"]  # 7.5 GB of host memory, before train_full's 81 GB
    free_card(host=True)
    train_lines["train_full"] = train_full_phase(gpu)
    free_card(host=True)
    api_launches = train_api_phase(gpu, train_rec)
    checkpoint_phase(gpu)
    checkpoint_offload_phase(gpu)
    # Gemma-7B's widths (16 heads of D 256, the tied 256000-row head) at 2 of
    # its 28 layers: K3-K5's D 256 arms on the training path
    gemma_train_launches, _ = train_phase(gpu, gemma_train_config(), name="train_gemma",
                                          config="gemma_7b", of_layers=28)
    # fp8 products in training, and a Mixtral layer with its aux loss
    train_lines["train_fp8"] = train_fp8_phase(gpu, train_rec)
    train_lines["train_moe"], _ = train_phase(gpu, moe_train_config(), name="train_moe",
                                              config="mixtral_8x7b", of_layers=32)

    def first(records, pages, case):
        return next(r for r in records if r["pages"] == pages and r["case"] == case)

    kernels = []
    csrc = "accelerate_tpu_torch/ops/csrc/"
    k1_src, k2_src = csrc + "paged_attention.cu", csrc + "paged_prefill.cu"
    flash_src = {"k3": (csrc + "flash_fwd.cu", "accelerate_tpu/ops/flash_attention.py:84"),
                 "k4": (csrc + "flash_bwd.cu", "accelerate_tpu/ops/flash_attention.py:278"),
                 "k5": (csrc + "flash_bwd.cu", "accelerate_tpu/ops/flash_attention.py:312")}
    flash_names = {"k3": "flash_fwd", "k4": "flash_dq", "k5": "flash_dkv"}
    arms = []
    for fmt in pa.KV_FORMATS:
        # the dequant arms, launched on their own engine run's path
        arms += [
            (first(k1, fmt, "main"), f"paged_attention[{fmt}]", k1_src,
             "accelerate_tpu/ops/paged_attention.py:291",
             arm_launches[fmt]["paged_attention"], f"engine_{fmt}"),
            (first(k2, fmt, "chunk512_base0"), f"paged_flash_prefill[{fmt}]",
             k2_src, "accelerate_tpu/ops/paged_attention.py:511",
             arm_launches[fmt]["paged_flash_prefill"], f"engine_{fmt}"),
        ]
    # each new head dim of K1 and K2 (bf16 at its model's shape), launched on
    # its engine's or its family set's path
    for d, label in ((256, "gemma7b_d256"), (80, "phi2_d80"), (96, "phi3_d96")):
        where, counts = wide_launches[d]
        arms += [
            (first(k1, "bfloat16", label), f"paged_attention[d{d}]", k1_src,
             "accelerate_tpu/ops/paged_attention.py:252", counts["paged_attention"], where),
            (first(k2, "bfloat16", f"{label}_chunk512_base0"), f"paged_flash_prefill[d{d}]",
             k2_src, "accelerate_tpu/ops/paged_attention.py:479",
             counts["paged_flash_prefill"], where),
        ]
    # each new head dim of K3-K5 (bf16 at the training shape): D 256 on
    # train_gemma's path, the others on their own kernel cases only
    for name in ("k3", "k4", "k5"):
        for d in (256, 80, 96, 32, 16):
            rec = next(r for r in flash[name] if r["d"] == d and r["dtype"] == "bfloat16")
            count, where = ((gemma_train_launches[flash_names[name]], "train_gemma") if d == 256
                            else (rec["launches"], f"{name} case {rec['case']}"))
            arms.append((rec, f"{flash_names[name]}[d{d}]", *flash_src[name], count, where))
    for rec, name, src, replaces, count, where in (
        (k1[0], "paged_attention", k1_src,
         "accelerate_tpu/ops/paged_attention.py:252", launches["paged_attention"], "engine"),
        # the tree-mask arm, launched on the tree engine's path
        (first(k1, "bfloat16", "tree_main"), "paged_attention[tree]", k1_src,
         "accelerate_tpu/ops/paged_attention.py:300", tree_launches["paged_attention_tree"],
         "engine_tree"),
        (k2[0], "paged_flash_prefill", k2_src,
         "accelerate_tpu/ops/paged_attention.py:479", launches["paged_flash_prefill"], "engine"),
        *[(flash[name][0], flash_names[name], *flash_src[name],
           launches[flash_names[name]], "train") for name in ("k3", "k4", "k5")],
        *arms,
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": count, "launches_on": where, "max_abs_err": rec["max_abs_err"],
            "tolerance": rec["tolerance"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
        })
        for key in ("design", "pages", "arm", "d"):
            if key in rec:
                kernels[-1][key] = rec[key]
        if name in prefix_launches:
            # the prefix cache's path, its counts zeroed just before its serve
            kernels[-1]["launches_engine_prefix"] = prefix_launches[name]
        for line, counts in family_launches.items():
            # the other families' engines, their counts zeroed just before
            if name in counts:
                kernels[-1]["launches_" + line] = counts[name]
        if name in stream_launches:
            # the streamed no-cache forward, its counts zeroed just before
            kernels[-1]["launches_stream_forward"] = stream_launches[name]
        if name in api_launches:
            # the reference loop's path, its counts zeroed just before its calls
            kernels[-1]["launches_train_api"] = api_launches[name]
        for line, counts in train_lines.items():
            # the remat, offload, fp8 and MoE training lines, their counts
            # zeroed just before
            if name in counts:
                kernels[-1]["launches_" + line] = counts[name]
    emit({"phase": "run", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

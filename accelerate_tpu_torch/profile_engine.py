"""Where the serving path's time goes on the card: the engine's loops, A/B.

    python -m accelerate_tpu_torch.profile_engine [--kv-dtype bf16 int8 fp8]
        [--model llama2-7b | pythia-6.9b]

Builds the Llama-2-7B geometry, or with ``--model pythia-6.9b`` GPT-NeoX at
Pythia-6.9B's published widths (its ``config.json`` values through
``hf_compat.config_from_hf_dict``), bf16, random weights from a seed, and, for
each KV storage format (``--kv-dtype``; default the model's bf16), serves
the ``chip_smoke.py`` engine workload in four modes: ``graphs`` — the
engine as a user makes it, every window and every prefill bucket's chunk a
CUDA graph replay, the depth-1 pipelined loop (``async_depth=1``);
``eager_chunks`` — the same with the chunks launch by launch (the loop
before the chunk graphs, through the private hook
``ServingEngine._eager_chunks``); ``interleave`` — ``graphs`` with
``interleave_prefill=True``; ``eager`` — windows and chunks launch by launch
with the synchronous loop (``async_depth=0``, ``ServingEngine._eager``).  A
first eager serve warms up (kernel build, allocator, cuBLAS handles) and
records each paged kernel call's bound at the engine's own shapes (each
call's lengths and widths, through :func:`paged_bound_ms`); then timed
serves run in turns (the modes, then the modes reversed), each engine made
before the clock; then one serve of each mode under ``torch.profiler``
(recording the card only) gives device time by kernel.  Prints one JSON
object per format: for each mode, wall seconds, ``prefill_s``, decode ms
per step (the engine's ``decode_s`` over its decode steps), tokens per
second over the serve's wall, the peak of allocated device memory over
the engine's construction and serve, the device's busy share of the
profiled and of the timed wall, CUDA kernel launches per layer-step, the
top device-time entries, and for the paged kernels (K1 decode, K2 prefill)
their launches, device ms per launch and mean bound per launch; beside
them the decode step's weight-read bound (the weights' bytes over the
card's memory rate) and, per prefill bucket, one chunk's ms replayed from
its graph and run launch by launch beside the chunk's bound
(:func:`chunk_times`).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .models import transformer
from .models.generation import GenerationConfig
from .models.hf_compat import PYTHIA_6_9B, config_from_hf_dict
from .models.transformer import Transformer, TransformerConfig
from .ops.paged_attention import kv_qmax
from .serving import ServingEngine
from .weights import init_params

PROMPT_LENS = (57, 100, 384, 700, 1000, 1500)
TOP = 15  # device-time entries printed
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per dtype
#: the paged kernels' wrappers as the transformer calls them -> a fragment of
#: their device entries' names
PAGED_KERNELS = {"paged_attention": "paged_decode", "paged_flash_prefill": "paged_prefill"}


def paged_bound_ms(lengths, s, hq, hkv, d, dtype, page_dtype=None, page=None) -> tuple:
    """Least time for one paged attention call (K1 or K2): each visible K/V
    byte (in ``page_dtype``, default ``dtype``), q and out (in ``dtype``)
    moved once, and for quantized pages each live (page, kv-head)'s two f32
    scales (``page`` keys a page), against 4 * D flops per visible (query
    head, key) pair at the rate of the products' type (bf16 unless q or the
    pages are f32).  Returns ``(ms, "bytes" or "operations")``."""
    page_dtype = page_dtype or dtype
    q_elem = torch.tensor([], dtype=dtype).element_size()
    kv_elem = torch.tensor([], dtype=page_dtype).element_size()
    keys = sum(length + s for length in lengths)
    pairs = sum(length * s + s * (s + 1) // 2 for length in lengths)
    nbytes = 2 * keys * hkv * d * kv_elem + 2 * len(lengths) * s * hq * d * q_elem
    if kv_qmax(page_dtype) is not None:
        nbytes += 2 * 4 * hkv * sum(-(-(length + s) // page) for length in lengths)
    flops = 4 * d * hq * pairs
    peak = PEAK_FLOPS[torch.float32 if torch.float32 in (dtype, page_dtype) else torch.bfloat16]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def chunk_bound_ms(model, bucket: int, base: int, page_dtype=None, page: int = 128) -> tuple:
    """Least time for one prefill chunk of ``bucket`` tokens at positions
    ``base ..`` through the model's layer stack (the chunk program stops
    before the LM head): the layers' weights, the chunk's embedding rows and
    the ``base`` prior tokens' K/V read once, the chunk's K/V written once
    (in ``page_dtype``, with each live page's two f32 scales for quantized
    pages), against 2 flops per matrix weight per token plus 4 * D flops per
    visible (query head, key) pair a layer, at the model's compute rate.
    Returns ``(ms, "bytes" or "operations")``."""
    cfg = model.config
    act = torch.tensor([], dtype=cfg.dtype).element_size()
    page_dtype = page_dtype or cfg.dtype
    kv = torch.tensor([], dtype=page_dtype).element_size()
    hd = cfg.resolved_head_dim
    matrices = [m.weight for m in model.layers.modules() if isinstance(m, torch.nn.Linear)]
    nbytes = sum(p.numel() * p.element_size() for p in model.layers.parameters())
    nbytes += bucket * cfg.hidden_size * model.embed_tokens.weight.element_size()
    nbytes += 2 * cfg.num_layers * (base + bucket) * cfg.num_kv_heads * hd * kv
    if kv_qmax(page_dtype) is not None:
        nbytes += 2 * 4 * cfg.num_layers * cfg.num_kv_heads * -(-(base + bucket) // page)
    pairs = base * bucket + bucket * (bucket + 1) // 2
    flops = (2 * sum(w.numel() for w in matrices) * bucket
             + 4 * hd * cfg.num_heads * pairs * cfg.num_layers)
    peak = PEAK_FLOPS[torch.float32 if act == 4 else torch.bfloat16]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` calls
    (after ``warmup``), nothing synchronised between them, so a call whose
    host time exceeds its card time is timed by its host."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: (bucket, base) of the chunks :func:`chunk_times` times: the first chunk
#: of a prompt, and a chunk behind 640 tokens of earlier pages
CHUNK_CASES = ((512, 0), (128, 0), (128, 640))


def chunk_times(engine: ServingEngine, iters: int = 10) -> list:
    """One prefill chunk per :data:`CHUNK_CASES` entry on ``engine`` (made
    with its chunk graphs; idle): the bucket's graph replayed and the same
    program launch by launch (as ``_eager`` engines and the parent's loop
    run it), each timed by :func:`time_ms` over ``iters`` back-to-back
    calls, beside :func:`chunk_bound_ms`.  The table maps pages ``1 ..`` of
    the pool, and the tokens are drawn from a seed: the chunk's work is a
    real one, written into pages no request holds."""
    gen = torch.Generator(device=engine.device).manual_seed(0)
    cfg = engine.model.config
    engine._chunk_table.copy_(torch.arange(1, engine.kv.pages_per_lane + 1,
                                           dtype=torch.int32)[None])
    out = []
    for bucket, base in CHUNK_CASES:
        engine._chunk_tokens[bucket].copy_(torch.randint(
            1, cfg.vocab_size, (1, bucket), generator=gen, device=engine.device))
        engine._chunk_base.fill_(base)
        key = engine._chunk_key(bucket)
        bound, by = chunk_bound_ms(engine.model, bucket, base, engine.kv.storage_dtype,
                                   engine.page_size)
        out.append({"bucket": bucket, "base": base,
                    "graph_ms": time_ms(lambda: engine.graphs.replay(key), iters),
                    "eager_ms": time_ms(engine._chunks[bucket], iters),
                    "bound_ms": bound, "bound_by": by})
    return out


#: the engine's loops, for the A/B: the engine as a user makes it (window
#: and chunk graphs, the depth-1 pipeline), the same with eager chunks,
#: the same with interleaved prefill, and eager windows and chunks with
#: the synchronous loop
MODES = ("graphs", "eager_chunks", "interleave", "eager")


def _engine(model, kv_dtype=None, mode="graphs") -> ServingEngine:
    """A new engine for the workload in ``mode`` (:data:`MODES`), without
    the prefix cache (the workload's prompts share nothing)."""
    kw = dict(num_slots=4, max_len=2048, prefill_buckets=(128, 512), decode_window=4,
              kv_dtype=kv_dtype, prefix_cache_mb=0, device="cuda")
    if mode == "graphs":
        return ServingEngine(model, None, **kw)
    if mode == "eager_chunks":
        return ServingEngine._eager_chunks(model, None, **kw)
    if mode == "interleave":
        return ServingEngine(model, None, interleave_prefill=True, **kw)
    return ServingEngine._eager(model, None, async_depth=0, **kw)


def _serve(model, prompts, kv_dtype=None, mode="graphs", engine=None):
    """Serve the workload (on ``engine``, else a new one made before the
    clock starts); returns the engine, the serve's wall seconds and the
    peak of allocated device memory since the engine's construction (bytes;
    over the serve alone when ``engine`` is given)."""
    torch.cuda.reset_peak_memory_stats()
    engine = engine or _engine(model, kv_dtype, mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.serve(prompts, configs=GenerationConfig(max_new_tokens=48))
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _recording_bounds(bounds):
    """Wrap the transformer's two paged kernels so that every call appends
    its :func:`paged_bound_ms` to ``bounds[name]``; returns an undo.  Reading
    each call's lengths syncs the card, so only an untimed serve records."""
    saved = {name: getattr(transformer, name) for name in PAGED_KERNELS}

    def recorder(name, fn):
        def call(q, pages_k, pages_v, tables, lengths, **kw):
            _, s, hq, d = q.shape
            bounds[name].append(paged_bound_ms(lengths.tolist(), s, hq, pages_k.shape[2], d,
                                               q.dtype, pages_k.dtype, pages_k.shape[1]))
            return fn(q, pages_k, pages_v, tables, lengths, **kw)
        return call

    for name, fn in saved.items():
        setattr(transformer, name, recorder(name, fn))
    return lambda: [setattr(transformer, name, fn) for name, fn in saved.items()]


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


#: profiler windows :func:`device_ms` traces before it times a graph instead
PROFILE_WINDOWS = 2


def graph_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``, from CUDA events around replays of a
    CUDA graph of ``iters`` calls: no host time, and no profiler.  It counts
    every kernel of a call and the graph's short gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def device_ms(fn, iters: int, fragment=None, warmup: int = 2) -> float:
    """Device time per call of ``fn`` under ``torch.profiler``: with
    ``fragment``, the mean time of the kernels whose name holds it, per
    launch; else all the kernels of ``iters`` calls, summed, per call.
    Unlike CUDA events around the calls it leaves out the host, whose time
    per call (a wrapper's checks, tensor maps) exceeds a short kernel's own.
    The profiler traces a warm-up cycle of one call before the measured
    one.  The profiler sometimes records no device activity in a window:
    a window that holds no launch of ``fragment`` (of any kernel, without
    one) is traced again, and after ``PROFILE_WINDOWS`` such windows the
    time is :func:`graph_ms`'s, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for window in range(PROFILE_WINDOWS):
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
            for n in (1, iters):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # the schedule's own step annotation also carries the step's device
        # time: leave it out, or a sum over all kernels counts them twice
        evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
                and not e.key.startswith("ProfilerStep")
                and (fragment is None or fragment in e.key)]
        total_ms = sum(device_us(e) for e in evts) / 1e3
        seen = sum(e.count for e in evts)
        if seen:
            return total_ms / (iters if fragment is None else seen)
        print(f"device_ms: profiler window {window + 1} held no launch of "
              f"{fragment or 'any kernel'}", file=sys.stderr, flush=True)
    return graph_ms(fn, iters)


def _profile(model, cfg, prompts, kv_dtype, mode, bounds) -> dict:
    """One serve in ``mode`` under ``torch.profiler``, recording the card
    only (the engine, and its graphs, made before the profiler starts):
    device time by kernel, the busy time, launches per layer-step."""
    engine = _engine(model, kv_dtype, mode)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        p_engine, p_wall, _ = _serve(model, prompts, engine=engine)
    averages = prof.key_averages()
    # device-side entries only (kernels, memcpy/memset)
    evts = [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in evts)
    launches = sum(e.count for e in evts)
    top = sorted(evts, key=device_us, reverse=True)[:TOP]
    paged = {}
    for name, fragment in PAGED_KERNELS.items():
        mine = [e for e in evts if fragment in e.key]
        count = sum(e.count for e in mine)
        paged[name] = {
            "device_entries": sorted({e.key[:80] for e in mine}),
            "launches": count,
            "ms_per_launch": sum(device_us(e) for e in mine) / 1e3 / max(count, 1),
            "recorded_calls": len(bounds[name]),
            "bound_ms_per_launch": float(np.mean([ms for ms, _ in bounds[name]])),
            "bytes_bound_share": float(np.mean([by == "bytes" for _, by in bounds[name]])),
        }
    return {
        "profiled_wall_s": p_wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share_of_profiled_wall": busy_us / 1e6 / p_wall,
        "device_entries_per_engine_run": launches,
        "device_entries_per_layer_step": launches / (
            cfg.num_layers * (p_engine.stats["decode_steps"] + p_engine.stats["prefill_chunks"])),
        "paged_kernels": paged,
        "top_device_time": [
            {"name": e.key[:80], "count": e.count, "device_ms": device_us(e) / 1e3,
             "share": device_us(e) / busy_us}
            for e in top
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kv-dtype", nargs="+", default=[None],
                        choices=["bf16", "int8", "fp8"],
                        help="the KV pool's storage formats, one A/B each (default: the "
                             "model's bf16)")
    parser.add_argument("--model", default="llama2-7b", choices=["llama2-7b", "pythia-6.9b"],
                        help="the served geometry (default Llama-2-7B)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.model == "pythia-6.9b":
        cfg = config_from_hf_dict(PYTHIA_6_9B, dtype=torch.bfloat16)
    else:
        cfg = TransformerConfig.llama2_7b(dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16),
                          assign=True)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for kv_dtype in args.kv_dtype:
        bounds = {name: [] for name in PAGED_KERNELS}
        undo = _recording_bounds(bounds)
        try:
            # warm-up (kernel build, allocator, cuBLAS), recording each call's
            # bound: reading the lengths syncs, so an eager engine records
            _serve(model, prompts, kv_dtype, "eager")
        finally:
            undo()
        # timed serves in turns (A B C D D C B A), each engine made before its
        # clock
        order = MODES + MODES[::-1]
        timed = {mode: [] for mode in MODES}
        for mode in order:
            engine, wall, peak = _serve(model, prompts, kv_dtype, mode)
            timed[mode].append((dict(engine.stats), wall, peak))
            del engine
        engine = _engine(model, kv_dtype, "graphs")
        pool = {"kv_bytes_per_token": engine.stats["kv_bytes_per_token"],
                "kv_pool_gb": engine.kv.kv_bytes() / 1e9}
        chunks = chunk_times(engine)
        del engine
        report = {}
        for mode in MODES:
            walls = [wall for _, wall, _ in timed[mode]]
            stats = [st for st, _, _ in timed[mode]]
            profiled = _profile(model, cfg, prompts, kv_dtype, mode, bounds)
            report[mode] = {
                "async_depth": 0 if mode == "eager" else 1,
                "wall_s": walls,
                "prefill_s": [st["prefill_s"] for st in stats],
                "peak_memory_gb": [peak / 1e9 for _, _, peak in timed[mode]],
                "interleaved_chunks": stats[-1]["interleaved_chunks"],
                "decode_ms_per_step": [1e3 * st["decode_s"] / st["decode_steps"]
                                       for st in stats],
                "serve_tokens_per_s": [st["tokens_generated"] / wall
                                       for st, wall in zip(stats, walls)],
                "decode_tokens_per_s": [st["tokens_generated"] / st["decode_s"]
                                        for st in stats],
                "prefill_ms_per_chunk": [1e3 * st["prefill_s"] / st["prefill_chunks"]
                                         for st in stats],
                "device_busy_share_of_timed_wall": profiled["device_busy_s"] / float(
                    np.mean(walls)),
                "stats": stats[-1],
                **profiled,
            }
        print(json.dumps({
            "gpu": gpu,
            "model": args.model,
            "kv_dtype": kv_dtype,
            **pool,
            "decode_step_weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
            "prefill_chunk_ms": chunks,
            "modes": report,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

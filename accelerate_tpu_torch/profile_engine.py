"""Where the serving path's time goes on the card.

    python -m accelerate_tpu_torch.profile_engine

Builds the Llama-2-7B geometry (bf16, random weights from a seed), serves the
``chip_smoke.py`` engine workload once to warm up (kernel build, allocator,
cuBLAS handles), then serves it again twice: once plain, for the wall times
and engine phase seconds, and once under ``torch.profiler`` for the device
time by kernel.  Prints one JSON object: wall seconds, device busy share,
CUDA kernel launches per decode step and per prefill chunk, and the top
device-time entries.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from .models.generation import GenerationConfig
from .models.transformer import Transformer, TransformerConfig
from .serving import ServingEngine
from .weights import init_params

PROMPT_LENS = (57, 100, 384, 700, 1000, 1500)
TOP = 15  # device-time entries printed


def _serve(model, prompts):
    engine = ServingEngine(model, None, num_slots=4, max_len=2048, prefill_buckets=(128, 512),
                           decode_window=4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.serve(prompts, configs=GenerationConfig(max_new_tokens=48))
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig.llama2_7b(dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16),
                          assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    _serve(model, prompts)                           # warm-up
    engine, wall = _serve(model, prompts)
    stats = dict(engine.stats)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        p_engine, p_wall = _serve(model, prompts)
    # device-side entries only (kernels, memcpy/memset): the host ops that
    # launched them carry the same time as children
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in evts)
    launches = sum(e.count for e in evts)
    top = sorted(evts, key=_device_us, reverse=True)[:TOP]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": gpu,
        "wall_s": wall,
        "stats": stats,
        "decode_ms_per_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
        "prefill_ms_per_chunk": 1e3 * stats["prefill_s"] / stats["prefill_chunks"],
        "profiled_wall_s": p_wall,
        "device_busy_s": device_us / 1e6,
        "device_busy_share_of_profiled_wall": device_us / 1e6 / p_wall,
        "device_entries_per_engine_run": launches,
        "device_entries_per_layer_step": launches / (
            cfg.num_layers * (p_engine.stats["decode_steps"] + p_engine.stats["prefill_chunks"])),
        "top_device_time": [
            {"name": e.key[:80], "count": e.count, "device_ms": _device_us(e) / 1e3,
             "share": _device_us(e) / device_us}
            for e in top
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the training path's time goes on the card.

    python -m accelerate_tpu_torch.profile_train

Builds ``chip_smoke.py``'s train configuration (Llama-2-7B widths at 8 of 32
layers, random f32 masters from a seed, bf16 compute, the flash path K3-K5,
AdamW, gradient accumulation 2, 2 x 2048 tokens per micro-step), runs two
micro-steps to warm up, then four micro-steps (two optimizer steps) twice:
once plain, for the step times, and once under ``torch.profiler`` for the
device time by kernel.  Prints one JSON object: ms per micro-step, device
busy share, device entries per micro-step, the device time by class (flash
kernels, GEMMs, optimizer, the rest) and the top entries.  Needs a CUDA card.
"""

from __future__ import annotations

import functools
import json
import subprocess
import time

import numpy as np
import torch

from .accelerator import Accelerator
from .models.transformer import Transformer, TransformerConfig, lm_loss_fn
from .profile_engine import device_us
from .weights import init_params

LAYERS, ROWS, SEQ = 8, 2, 2048
MICRO_STEPS = 4
TOP = 15  # device-time entries printed
#: device-entry name fragments -> class; the first match wins, else "other"
CLASSES = (
    ("flash", ("flash_fwd", "flash_dq", "flash_dkv")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
    ("optimizer", ("multi_tensor", "foreach")),
)


def _class(name: str) -> str:
    low = name.lower()
    for label, fragments in CLASSES:
        if any(f in low for f in fragments):
            return label
    return "other"


def _steps(step, state, batches):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig.llama2_7b(num_layers=LAYERS, dtype=torch.bfloat16,
                                      param_dtype=torch.float32, attention_impl="pallas")
    model = Transformer(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(init_params(cfg, seed=0, device="cuda", dtype=torch.float32),
                          assign=True)
    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    state = accelerator.create_train_state(params=model, tx=functools.partial(
        torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.95), eps=1e-5, weight_decay=0.1))
    step = accelerator.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    rng = np.random.default_rng(7)
    batches = [{"input_ids": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)).cuda()}
        for _ in range(MICRO_STEPS)]

    _steps(step, state, batches[:2])                                # warm-up
    wall = _steps(step, state, batches)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        p_wall = _steps(step, state, batches)
    # device-side entries only (kernels, memcpy/memset): the host ops that
    # launched them carry the same time as children, and so does the device
    # span of a user annotation (``Optimizer.step#AdamW.step``)
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
            and not e.is_user_annotation]
    busy_us = sum(device_us(e) for e in evts)
    by_class = {}
    for e in evts:
        label = _class(e.key)
        by_class[label] = by_class.get(label, 0.0) + device_us(e)
    top = sorted(evts, key=device_us, reverse=True)[:TOP]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": gpu,
        "layers": LAYERS, "tokens_per_micro_step": ROWS * SEQ, "micro_steps": MICRO_STEPS,
        "ms_per_micro_step": 1e3 * wall / MICRO_STEPS,
        "profiled_ms_per_micro_step": 1e3 * p_wall / MICRO_STEPS,
        "device_ms_per_micro_step": busy_us / 1e3 / MICRO_STEPS,
        "device_busy_share_of_profiled_wall": busy_us / 1e6 / p_wall,
        "device_busy_share_of_plain_wall": busy_us / 1e6 / wall,
        "device_entries_per_micro_step": sum(e.count for e in evts) / MICRO_STEPS,
        "device_ms_per_micro_step_by_class": {k: v / 1e3 / MICRO_STEPS
                                              for k, v in sorted(by_class.items())},
        "device_share_by_class": {k: v / busy_us for k, v in sorted(by_class.items())},
        "top_device_time": [
            {"name": e.key[:80], "count": e.count, "device_ms": device_us(e) / 1e3,
             "share": device_us(e) / busy_us}
            for e in top
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card.

    python3 chip_smoke.py            # every phase, from the root of the repo

Phases, each printing one JSON line:

1. ``device``  — the card, torch/CUDA versions, and the kernels' build.
2. ``k1``      — the paged decode kernel against its plain version at the
   serving path's shapes (Llama-2-7B widths) and at a GQA shape, bf16 and f32
   pages: max abs error against the stated tolerance, kernel/plain/bound ms.
3. ``k2``      — the paged prefill kernel the same, for a 512-token chunk at
   base 0 and a 128-token chunk at base 640.
4. ``model``   — the full-width, full-depth Llama-2-7B geometry (random
   weights from a seed): a 512-token prompt prefilled as one paged chunk,
   then 8 decode steps through ``PagedKVCache``, each step's logits held
   against the no-cache causal forward (plain attention, no kernel).
5. ``engine``  — ``ServingEngine(paged=True)`` serves 6 greedy requests; the
   kernel launch counters are zeroed just before and read just after; every
   output is teacher-forced through the no-cache forward.
6. the ``kernels`` line, the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero before the last
line.  It needs a CUDA card and the repository beside it; there is no CPU
fallback.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per dtype
TOL = {  # kernel vs plain version, per page dtype
    "k1": {torch.float32: 1e-4, torch.bfloat16: 2e-2},
    "k2": {torch.float32: 1e-4, torch.bfloat16: 3e-2},
}
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


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def bound_ms(lengths, s, hq, hkv, d, dtype) -> tuple:
    """Least time for the call: each visible K/V byte, q and out moved once,
    against 4 * D flops per visible (query head, key) pair."""
    elem = torch.tensor([], dtype=dtype).element_size()
    keys = sum(length + s for length in lengths)
    pairs = sum(length * s + s * (s + 1) // 2 for length in lengths)
    nbytes = 2 * keys * hkv * d * elem + 2 * len(lengths) * s * hq * d * elem
    flops = 4 * d * hq * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(name, kernel, plain, cases):
    """Hold ``kernel`` against ``plain`` on every case; returns the first
    (main-path) case's record.  ``launches`` counts the kernel's launches in
    the case (one checked call, then the timing loop)."""
    records = []
    for label, seed, lengths, s, hq, hkv, dtype in cases:
        args = paged_case(seed, lengths, s, hq, hkv, 128, 128, 16, dtype)
        launches0 = kernel.launches
        out = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[name][dtype]
        check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite output "
              "(a dead or stale page was read)")
        bms, by = bound_ms(lengths, s, hq, hkv, 128, dtype)
        rec = dict(
            case=label, dtype=str(dtype).replace("torch.", ""), lengths=lengths, s=s,
            hq=hq, hkv=hkv, max_abs_err=err, tolerance=tol,
            ms=time_ms(lambda: kernel(*args), 20),
            plain_ms=time_ms(lambda: plain(*args), 5),
            bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
        )
        rec["launches"] = kernel.launches - launches0
        emit({"phase": name, **rec})
        check(err <= tol, f"{name} {label}: max abs err {err} > tolerance {tol}")
        records.append(rec)
    return records[0]


# -------------------------------------------------------------------- model
def no_cache_logits(model, ids: np.ndarray) -> torch.Tensor:
    with torch.inference_mode():
        return model(torch.from_numpy(ids[None]).cuda())[0]


def model_phase(model, cfg, rng) -> float:
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
    emit({"phase": "model", "prompt": 512, "decode_steps": 8,
          "max_abs_logit_err": err,
          "decode_max_abs_logit_err": (paged[512:] - ref[512:]).abs().max().item(),
          "tolerance": tol, "plain_bf16_vs_f32": noise,
          "paged_bf16_vs_f32": (paged - ref32).abs().max().item(),
          "logit_std": ref32.std().item()})
    check(err <= tol, f"paged forward logits differ by {err} > {tol}")
    return tol


def engine_phase(model, cfg, rng, gpu, margin: float):
    from accelerate_tpu_torch.models.generation import GenerationConfig
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving import ServingEngine

    lens = (57, 100, 384, 700, 1000, 1500)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lens]
    engine = ServingEngine(model, None, num_slots=4, max_len=2048,
                           prefill_buckets=(128, 512), decode_window=4, device="cuda")
    idle_free = engine.kv.allocator.free_count
    gen = GenerationConfig(max_new_tokens=48)
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = engine.serve(prompts, configs=gen)
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_flash_prefill": pa.paged_flash_prefill.launches}
    st = engine.stats
    check(all(len(r.tokens) == 48 and r.done for r in reqs), "a request did not finish 48 tokens")
    check(launches["paged_attention"] == st["decode_steps"] * cfg.num_layers > 0,
          f"decode kernel launches {launches['paged_attention']} != "
          f"{st['decode_steps']} steps x {cfg.num_layers} layers")
    check(launches["paged_flash_prefill"] == st["prefill_chunks"] * cfg.num_layers > 0,
          f"prefill kernel launches {launches['paged_flash_prefill']} != "
          f"{st['prefill_chunks']} chunks x {cfg.num_layers} layers")
    check(engine.kv.allocator.free_count == idle_free, "KV pages leaked")

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
    emit({"phase": "engine", "requests": len(reqs), "prompt_lens": list(lens),
          "new_tokens": 48, "stats": st, "launches": launches, "wall_s": wall,
          "argmax_agree_share": agree / total,
          "margin_above_noise_share": confident / total, "noise_margin": margin,
          "max_logit_deficit": deficit.max().item(),
          "mean_logit_deficit": deficit.mean().item(),
          "decode_tokens_per_s": st["tokens_generated"] / st["decode_s"],
          "prefill_tokens_per_s": st["prefill_tokens"] / st["prefill_s"],
          "kv_pool_bytes": engine.kv.kv_bytes(), "gpu": gpu})
    check(deficit.max().item() <= margin, "an engine token sits below the no-cache "
          f"forward's best logit by more than the noise margin {margin}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on the card",
              file=sys.stderr)
        return 1
    from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(gpu, flush=True)
    _build.load()
    emit({"phase": "device", "gpu": gpu, "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": _build.build_seconds,
          "spills": sorted({line.strip() for log in _build.build_logs.values()
                            for line in log.splitlines()
                            if "spill" in line and not line.strip().startswith("0 bytes")})})

    bf16, f32 = torch.bfloat16, torch.float32
    ragged = [5, 700, 1500, 2040]  # a lane on its first page ... a nearly full lane
    k1 = kernel_phase("k1", pa.paged_attention, pa.paged_attention_reference, [
        ("main", 1, ragged, 1, 32, 32, bf16),
        ("main", 2, ragged, 1, 32, 32, f32),
        ("gqa", 3, ragged, 1, 32, 8, bf16),
        ("gqa", 4, ragged, 1, 32, 8, f32),
    ])
    k2 = kernel_phase("k2", pa.paged_flash_prefill, pa.paged_flash_prefill_reference, [
        ("chunk512_base0", 5, [0], 512, 32, 32, bf16),
        ("chunk128_base640", 6, [640], 128, 32, 32, bf16),
        ("chunk512_base0", 7, [0], 512, 32, 32, f32),
        ("chunk128_base640", 8, [640], 128, 32, 32, f32),
        ("gqa_chunk512_base0", 9, [0], 512, 32, 8, bf16),
        ("gqa_chunk128_base640", 10, [640], 128, 32, 8, bf16),
        ("gqa_chunk512_base0", 11, [0], 512, 32, 8, f32),
        ("gqa_chunk128_base640", 12, [640], 128, 32, 8, f32),
    ])

    cfg = TransformerConfig.llama2_7b(dtype=bf16)
    model = Transformer(cfg, device="cuda", dtype=bf16)
    model.load_state_dict(init_params(cfg, seed=0, device="cuda", dtype=bf16), assign=True)
    rng = np.random.default_rng(0)
    tol = model_phase(model, cfg, rng)
    launches = engine_phase(model, cfg, rng, gpu, tol)

    kernels = []
    for rec, name, src, replaces, counter in (
        (k1, "paged_attention", "accelerate_tpu_torch/ops/csrc/paged_attention.cu",
         "accelerate_tpu/ops/paged_attention.py:252", "paged_attention"),
        (k2, "paged_flash_prefill", "accelerate_tpu_torch/ops/csrc/paged_prefill.cu",
         "accelerate_tpu/ops/paged_attention.py:479", "paged_flash_prefill"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[counter], "max_abs_err": rec["max_abs_err"],
            "tolerance": rec["tolerance"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        })
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

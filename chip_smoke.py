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
6. ``k3``, ``k4``, ``k5`` — the flash-attention forward, dQ and dK/dV kernels
   against their plain versions: the training shape (B 2, S 2048, 32 heads,
   D 128, causal) in bf16 and f32, GQA 32/8, three packed segments per row
   at S 1024, and non-causal at S 512; K4 and K5 run twice and must give the
   same bits.  Each line: max abs error beside its tolerance, kernel, plain,
   bound and library (``scaled_dot_product_attention``) ms, and the case's
   launches.
7. ``train``   — the serving model freed, ``TransformerConfig.llama2_7b`` at
   full width and 8 of its 32 layers (f32 masters, bf16 compute, the flash
   path) trains through ``Accelerator(mixed_precision="bf16",
   gradient_accumulation_steps=2)``: AdamW with the Llama-2 recipe, 8
   micro-steps of 2 x 2048 tokens = 4 optimizer steps, the flash launch
   counters zeroed just before and read just after.  Before that, one
   micro-step of one sequence is held against the ``attention_impl="xla"``
   path, with an f32 run of the same weights as the yardstick of bf16 noise.
8. the ``kernels`` line, the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero before the last
line.  It needs a CUDA card and the repository beside it; there is no CPU
fallback.
"""

from __future__ import annotations

import dataclasses
import functools
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
# flash kernels vs plain versions, relative to the largest plain value: f32
# sums in another order (measured ~1e-7 relative); in bf16 both versions
# round their output once, after sums in different orders (and p relative to
# another running max in K3), so two bf16 steps at the top of the range
FLASH_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}
# train phase: the flash path's loss and gradient against the xla path's,
# as a multiple of the xla bf16 path's own distance from an f32 run of the
# same weights (two independent bf16 paths sit ~sqrt(2) x that apart); the
# loss tolerance has a floor of 5e-3 (a mean of 2047 cross entropies of
# bf16 logits, whose step is 2**-8 relative), lest a noise reading that
# happens to fall near zero make the check a coin toss
TRAIN_TOL_FACTOR = 2.0
TRAIN_LOSS_TOL_FLOOR = 5e-3
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


# --------------------------------------------------------------- flash attn
def flash_inputs(seed, b, s, hq, hkv, dtype, segmented):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, dout = (torch.randn((b, s, hq, 128), generator=gen, device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn((b, s, hkv, 128), generator=gen, device="cuda").to(dtype)
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


def flash_bound_ms(name, b, s, hq, hkv, dtype, pairs, segmented) -> tuple:
    """Least time: every input read once and every output written once, or
    4 / 6 / 8 x D flops per visible pair (K3 / K4 / K5) at the dtype's peak."""
    elem = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, stat_bytes = b * s * hq * 128 * elem, b * s * hkv * 128 * elem, b * hq * s * 4
    seg_bytes = b * s * 4 if segmented else 0
    nbytes, flops_per_pair = {
        "k3": (q_bytes + 2 * kv_bytes + q_bytes + stat_bytes + seg_bytes, 4),
        "k4": (2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes + q_bytes, 6),
        "k5": (2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes + 2 * kv_bytes, 8),
    }[name]
    flops = flops_per_pair * 128 * hq * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_ms(q, k, v, dout, causal, backward) -> float:
    """``scaled_dot_product_attention`` on the same values in its own
    contiguous BHSD layout: its forward computes K3's function, its backward
    K4's and K5's together."""
    import torch.nn.functional as F

    gqa = q.shape[2] != k.shape[2]
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(backward)
                  for t in (q, k, v))
    if not backward:
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=gqa), 10)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    grad = dout.transpose(1, 2).contiguous()
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), grad, retain_graph=True), 10)


def flash_case(label, seed, b, s, hq, hkv, dtype, causal, segmented) -> dict:
    """K3, K4 and K5 against their plain versions on one case (the same
    inputs to both: the plain forward's lse and delta feed both backward
    versions); one record per kernel."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, seg = flash_inputs(seed, b, s, hq, hkv, dtype, segmented)
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
    ref_dk, ref_dv = fa.flash_dkv_reference(*args, **kw)
    checks = {
        "k3": {"out": held(out, ref_out), "lse": held(lse, ref_lse, FLASH_REL_TOL[torch.float32])},
        "k4": {"dq": held(dq, fa.flash_dq_reference(*args, **kw))},
        "k5": {"dk": held(dk, ref_dk), "dv": held(dv, ref_dv)},
    }
    repeat_dk, repeat_dv = fa.flash_dkv(*args, **kw)
    bitwise = {"k4": torch.equal(dq, fa.flash_dq(*args, **kw)),
               "k5": torch.equal(dk, repeat_dk) and torch.equal(dv, repeat_dv)}
    timings = {
        "k3": (lambda: fa.flash_fwd(q, k, v, **kw),
               lambda: fa.flash_attention_reference(q, k, v, **kw), False),
        "k4": (lambda: fa.flash_dq(*args, **kw),
               lambda: fa.flash_dq_reference(*args, **kw), True),
        "k5": (lambda: fa.flash_dkv(*args, **kw),
               lambda: fa.flash_dkv_reference(*args, **kw), True),
    }
    records = {}
    for name, (kernel, plain, backward) in timings.items():
        errs = checks[name]
        # the kernels line carries the binding check: the largest err / tolerance
        worst = max(errs.values(), key=lambda et: et[0] / et[1])
        bms, by = flash_bound_ms(name, b, s, hq, hkv, dtype, pairs, segmented)
        rec = dict(
            case=label, dtype=str(dtype).replace("torch.", ""), b=b, s=s, hq=hq, hkv=hkv,
            causal=causal, segmented=segmented, visible_pairs=pairs,
            errors={key: e for key, (e, _) in errs.items()},
            tolerances={key: t for key, (_, t) in errs.items()},
            max_abs_err=worst[0], tolerance=worst[1],
            ms=time_ms(kernel, 10), plain_ms=time_ms(plain, 3, warmup=1),
            bound_ms=bms, bound_by=by,
            library_ms=None if segmented else library_ms(q, k, v, dout, causal, backward),
        )
        # the case's own launches: the checked calls, then the timing loop
        rec["launches"] = counters[name].launches - launches0[name]
        if name in bitwise:
            rec["bitwise_repeatable"] = bitwise[name]
        emit({"phase": name, **rec})
        for key, (err, tol) in errs.items():
            check(err <= tol, f"{name} {label}: {key} max abs err {err} > tolerance {tol}")
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


def train_phase(gpu):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import SimpleDataLoader
    from accelerate_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        lm_loss_fn,
        state_dict_shapes,
    )
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.weights import init_params

    layers, rows, seq = 8, 2, 2048
    cfg = TransformerConfig.llama2_7b(num_layers=layers, dtype=torch.bfloat16,
                                      param_dtype=torch.float32, attention_impl="pallas")
    model = Transformer(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(init_params(cfg, seed=0, device="cuda", dtype=torch.float32),
                          assign=True)
    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    rng = np.random.default_rng(7)
    a, b = (rng.integers(1, cfg.vocab_size, (rows, seq)).astype(np.int32) for _ in range(2))
    path_check = attention_path_check(
        accelerator, model, cfg, {"input_ids": torch.from_numpy(a[:1]).cuda()})

    # the Llama-2 recipe: AdamW(0.9, 0.95), eps 1e-5, weight decay 0.1, clip 1.0
    state = accelerator.create_train_state(params=model, tx=functools.partial(
        torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.95), eps=1e-5, weight_decay=0.1))
    step = accelerator.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    dataset = [{"input_ids": r} for _ in range(4) for r in (*a, *b)]  # A B A B ...
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
    steady = float(np.mean(step_s[1:]))
    applied = [h for h in host if h["applied"]]
    rec = {
        "phase": "train", "config": "llama2_7b", "layers": layers, "of_layers": 32,
        "params": sum(p.numel() for p in model.parameters()), "matrix_params": matrix_params,
        "micro_steps": micro, "optimizer_steps": state.step, "tokens_per_micro_step": tokens,
        "loss": [h["loss"] for h in host], "grad_norm": [h["grad_norm"] for h in host],
        "applied": [bool(h["applied"]) for h in host], "launches": launches,
        "first_step_ms": step_s[0] * 1e3, "step_ms": steady * 1e3,
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
    del model
    torch.cuda.empty_cache()

    flash = flash_phase([
        ("train", 13, 2, 2048, 32, 32, bf16, True, False),
        ("train", 14, 2, 2048, 32, 32, f32, True, False),
        ("gqa", 15, 2, 2048, 32, 8, bf16, True, False),
        ("segments3", 16, 2, 1024, 32, 32, bf16, True, True),
        ("full512", 17, 2, 512, 32, 32, bf16, False, False),
    ])
    launches.update(train_phase(gpu))

    kernels = []
    csrc = "accelerate_tpu_torch/ops/csrc/"
    for rec, name, src, replaces in (
        (k1, "paged_attention", csrc + "paged_attention.cu",
         "accelerate_tpu/ops/paged_attention.py:252"),
        (k2, "paged_flash_prefill", csrc + "paged_prefill.cu",
         "accelerate_tpu/ops/paged_attention.py:479"),
        (flash["k3"], "flash_fwd", csrc + "flash_fwd.cu",
         "accelerate_tpu/ops/flash_attention.py:84"),
        (flash["k4"], "flash_dq", csrc + "flash_bwd.cu",
         "accelerate_tpu/ops/flash_attention.py:278"),
        (flash["k5"], "flash_dkv", csrc + "flash_bwd.cu",
         "accelerate_tpu/ops/flash_attention.py:312"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "tolerance": rec["tolerance"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
        })
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1's device time per launch at each split plan, at the serving path's decode shapes.

    python -m accelerate_tpu_torch.profile_decode [--kv-dtype int8|fp8]
    python -m accelerate_tpu_torch.profile_decode --host [--kv-dtype int8|fp8]
    python -m accelerate_tpu_torch.profile_decode --kernels

Three bf16 shapes at Llama-2-7B widths (D 128, page 128, 16 table slots a
lane): ``chip_smoke.py``'s "main" (4 lanes of 5/700/1500/2040 keys, 32
heads) and "gqa" (the same lanes, 32 query over 8 kv heads), and
"engine", lanes of 57/384/700/1000 keys as the engine's decode steps hold
them.  For each, K1 runs at every pages-per-split value that gives a
distinct number of splits; prints one JSON line per (shape, plan): device
ms per launch under ``torch.profiler``, the bound, and whether it is the
plan :func:`~accelerate_tpu_torch.ops.paged_attention.decode_split_plan`
picks.  Last, the yardstick of the card's read rate: one ``torch.sum``
over each of the "main" shape's K and V pools (the whole pool, contiguous),
as device ms and GB/s.  With ``--host`` it prints instead, per shape, the
host ms per call of the wrapper: the host clock over 200 calls with no
synchronisation between them (the launch queue absorbs their kernels), so
the kernel's own time is left out; that mode uses nothing but
``paged_attention``, so it also times an older tree's wrapper.  Needs a
CUDA card.  ``--kv-dtype`` makes the pages int8 or fp8-e4m3 codes of the
same values, written by ``paged_quantized_insert`` with their scales (K1's
dequant arm).  ``--kernels`` prints the device ms per launch of K1 at the
three shapes, of K1's causal arm at the verify spans S 5 and S 9 ("main"'s
heads; S 9 over lanes of 5/700/1500/2000 keys, as 2040 + 9 would overrun
the table) and of K2 at ``chip_smoke.py``'s two bf16 chunks (512 tokens at
base 0, 128 at base 640), native bf16 pages, then, where the tree has it,
K1's tree-mask arm on the S 9 case (the 9-node tree of ``TreeSpec(2, 4)``),
and last the first-use build of the tree's kernels (wall seconds, all and by
library; 0 when they were built before); like ``--host`` it calls nothing
but the two wrappers, ``profile_engine.device_ms`` and ``ops._build``, so a
copy of this file inside an older tree times that tree's kernels and build
(an A/B within one call).
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch

from .ops import paged_attention as pa

SHAPES = {  # lengths, query heads, kv heads
    "main": ([5, 700, 1500, 2040], 32, 32),
    "gqa": ([5, 700, 1500, 2040], 32, 8),
    "engine": ([57, 384, 700, 1000], 32, 32),
}
PAGE, SLOTS, D = 128, 16, 128
CHUNKS = {"chunk512_base0": (0, 512), "chunk128_base640": (640, 128)}  # base, chunk
VERIFY = {"verify5_main": ([5, 700, 1500, 2040], 5), "verify9_main": ([5, 700, 1500, 2000], 9)}

def _case(lengths, hq, hkv, seed=0, kv_dtype=None, s=1):
    """q, pages, tables and lengths (then the scales, for quantized pages)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = len(lengths)
    shape = (n * SLOTS + 1, PAGE, hkv, D)
    pages = [torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(2)]
    tables = torch.arange(1, n * SLOTS + 1, dtype=torch.int32, device="cuda").reshape(n, SLOTS)
    q = torch.randn((n, s, hq, D), generator=gen, device="cuda").bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if kv_dtype is None:
        return q, pages[0], pages[1], tables, lens
    # every lane's whole table written at once: the codes of the same values
    dtype = pa.KV_FORMATS[kv_dtype][0]
    codes, scales = [], []
    every = torch.ones(n, dtype=torch.bool, device="cuda")
    for values in pages:
        c = torch.zeros(shape, dtype=dtype, device="cuda")
        sc = torch.ones(shape[0], hkv, device="cuda")
        new = values[tables.long()].reshape(n, SLOTS * PAGE, hkv, D)
        pa.paged_quantized_insert(c, sc, new, tables, torch.zeros_like(lens), every)
        codes.append(c)
        scales.append(sc)
    return q, codes[0], codes[1], tables, lens, scales[0], scales[1]


def host_ms(fn, iters: int = 200) -> float:
    """Host ms per call of ``fn``: no synchronisation inside the timed loop."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    args_in = sys.argv[1:]
    kv_dtype = args_in[args_in.index("--kv-dtype") + 1] if "--kv-dtype" in args_in else None
    if kv_dtype is not None and kv_dtype not in pa.KV_FORMATS:
        raise SystemExit(f"profile_decode: --kv-dtype {kv_dtype!r}: choose int8 or fp8")
    if "--host" in args_in:
        for name, (lengths, hq, hkv) in SHAPES.items():
            args = _case(lengths, hq, hkv, kv_dtype=kv_dtype)
            print(json.dumps({"shape": name, "kv_dtype": kv_dtype,
                              "host_ms": host_ms(lambda: pa.paged_attention(*args)),
                              "gpu": gpu}), flush=True)
        return 0
    from .profile_engine import device_ms, graph_ms, paged_bound_ms
    if "--kernels" in args_in:
        cases = [(f"k1_{name}", pa.paged_attention, "paged_decode", _case(lengths, hq, hkv))
                 for name, (lengths, hq, hkv) in SHAPES.items()]
        verify = {name: _case(lengths, 32, 32, s=s) for name, (lengths, s) in VERIFY.items()}
        cases += [(f"k1_{name}", pa.paged_attention, "paged_decode", args)
                  for name, args in verify.items()]
        cases += [(f"k2_{name}", pa.paged_flash_prefill, "paged_prefill",
                   _case([base], 32, 32, s=chunk)) for name, (base, chunk) in CHUNKS.items()]
        if hasattr(pa, "TreeMask"):  # the tree-mask arm; an older tree has none
            from .serving.spec_exec import TreeSpec

            mask = pa.TreeMask(TreeSpec(2, 4).anc)
            cases.append(("k1_tree9_main", functools.partial(pa.paged_attention, tree_mask=mask),
                          "paged_decode", verify["verify9_main"]))
        for name, fn, fragment, args in cases:
            fn(*args)
            print(json.dumps({"case": name, "ms": device_ms(lambda: fn(*args), 50, fragment),
                              "gpu": gpu}), flush=True)
        from .ops import _build

        print(json.dumps({"case": "build", "build_s": _build.build_seconds,
                          "by_library": _build.build_times, "gpu": gpu}), flush=True)
        return 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pa.decode_split_plan
    try:
        for name, (lengths, hq, hkv) in SHAPES.items():
            args = _case(lengths, hq, hkv, kv_dtype=kv_dtype)
            picked = plan(SLOTS, len(lengths), hkv, PAGE, sms)
            bound, _ = paged_bound_ms(lengths, 1, hq, hkv, D, torch.bfloat16, args[1].dtype,
                                      PAGE)
            ref = pa.paged_attention(*args)
            seen = set()
            for pps in range(1, SLOTS + 1):
                splits = -(-SLOTS // pps)
                if splits in seen:
                    continue
                seen.add(splits)
                pa.decode_split_plan = lambda *_, p=pps, z=splits: (p, z)
                out = pa.paged_attention(*args)
                ms = device_ms(lambda: pa.paged_attention(*args), 20, "paged_decode")
                g_ms = graph_ms(lambda: pa.paged_attention(*args), 20)
                pa.decode_split_plan = plan
                print(json.dumps({
                    "shape": name, "kv_dtype": kv_dtype, "lengths": lengths, "hq": hq,
                    "hkv": hkv,
                    "pages_per_split": pps, "splits": splits, "picked": (pps, splits) == picked,
                    "ms": ms, "graph_ms": g_ms, "bound_ms": bound, "share_of_bound": bound / ms,
                    "max_abs_diff_vs_picked": (out.float() - ref.float()).abs().max().item(),
                    "gpu": gpu,
                }), flush=True)
    finally:
        pa.decode_split_plan = plan
    _, pages_k, pages_v, _, _ = _case(*SHAPES["main"])
    nbytes = 2 * pages_k.numel() * pages_k.element_size()
    ms = device_ms(lambda: (pages_k.sum(dtype=torch.float32),
                            pages_v.sum(dtype=torch.float32)), 20)
    print(json.dumps({"shape": "stream_read", "bytes": nbytes, "ms": ms,
                      "gb_per_s": nbytes / ms / 1e6, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

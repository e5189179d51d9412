"""Card-only tests of the port: the CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips without a card.  This file
imports torch and the port only (no JAX), so it also runs on a machine that
has no JAX; run it there with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 (the kernels sum in another order than the plain
version, measured errors are ~1e-6); bf16 2e-2 — the plain version rounds
logits and probabilities to bf16 where the kernels keep f32.  The flash
kernels (K3-K5) are held relative to the largest plain value: 1e-5 in f32,
2**-6 (two bf16 steps) in bf16.
"""

import functools

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import SimpleDataLoader
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.weights import init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _case(card, lengths, s, hq, hkv, d, page, ppl, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    n = len(lengths)
    num_pages = n * ppl + 1
    pages = [torch.randn((num_pages, page, hkv, d), generator=gen, device=card).to(dtype)
             for _ in range(2)]
    tables = torch.arange(1, num_pages, dtype=torch.int32, device=card).reshape(n, ppl)
    q = torch.randn((n, s, hq, d), generator=gen, device=card).to(dtype)
    return q, pages[0], pages[1], tables, torch.tensor(lengths, dtype=torch.int32, device=card)


@pytest.mark.parametrize("kernel,plain,s", [
    (pa.paged_attention, pa.paged_attention_reference, 1),
    (pa.paged_attention, pa.paged_attention_reference, 3),
    (pa.paged_flash_prefill, pa.paged_flash_prefill_reference, 40),
])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hkv,d,page", [(4, 128, 16), (2, 64, 32)])
def test_kernel_matches_plain(card, kernel, plain, s, dtype, atol, hkv, d, page):
    args = _case(card, [0, 17, 70], s, 8, hkv, d, page, 8, dtype)
    out = kernel(*args)
    ref = plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def test_launch_counters_count_kernel_launches_only(card):
    pa.reset_launch_counts()
    args = _case(card, [5], 1, 4, 4, 64, 16, 2, torch.float32)
    pa.paged_attention(*args)
    pa.paged_attention_reference(*args)
    pa.paged_flash_prefill(*args)
    assert (pa.paged_attention.launches, pa.paged_flash_prefill.launches) == (1, 1)


def test_unsupported_head_dim_raises(card):
    args = _case(card, [5], 1, 4, 4, 32, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(*args)


def test_engine_on_card_matches_cpu_engine(card):
    """Greedy tokens of the f32 tiny model: kernels on the card == plain
    versions on the CPU."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 head_dim=64, max_seq_len=128)
    sd = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 19, 33, 8)]
    gen = GenerationConfig(max_new_tokens=12)
    out = {}
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               device=dev)
        out[str(dev)] = [r.tokens for r in engine.serve(prompts, configs=gen)]
    assert out["cpu"] == out[str(card)]


def _flash_case(card, b, s, hq, hkv, d, dtype, segmented=False, seed=0, sk=None):
    sk = sk or s
    gen = torch.Generator(device=card).manual_seed(seed)
    q, dout = (torch.randn((b, s, hq, d), generator=gen, device=card).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=card).to(dtype) for _ in range(2))
    seg = None
    if segmented:
        n = max(s, sk)
        pos = torch.arange(n, device=card)
        seg = ((pos >= n // 3).int() + (pos >= (2 * n) // 3).int()).expand(b, n).contiguous()
    return q, k, v, dout, seg


def _close(got, want, dtype):
    rel = 1e-5 if dtype == torch.float32 else 2.0**-6
    tol = rel * max(want.float().abs().max().item(), 1.0)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,segmented", [
    (2, 256, 4, 4, 64, True, False),    # the JAX package's test shapes
    (2, 256, 4, 4, 64, False, False),
    (2, 256, 4, 2, 64, True, False),
    (2, 200, 4, 2, 64, True, False),    # ragged last q-block and k-tile
    (2, 200, 4, 2, 64, False, True),
    (1, 131, 6, 2, 128, True, True),
    (1, 100, 8, 1, 128, True, False),   # MQA: one kv head for eight query heads
])
def test_flash_kernels_match_plain(card, dtype, b, s, hq, hkv, d, causal, segmented):
    _hold_flash_kernels(*_flash_case(card, b, s, hq, hkv, d, dtype, segmented), causal, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,segmented", [
    (1, 96, 160, 4, 2, 64, True, True),     # fewer queries than keys
    (1, 160, 96, 4, 2, 128, False, False),  # more queries than keys
    (1, 80, 80, 72, 1, 64, True, False),    # a group of 72 heads: two parts of 36
    (1, 70, 70, 71, 1, 64, True, True),     # 71 heads over one kv head: parts of one
])
def test_flash_kernels_match_plain_uneven(card, dtype, b, sq, sk, hq, hkv, d, causal, segmented):
    case = _flash_case(card, b, sq, hq, hkv, d, dtype, segmented, seed=1, sk=sk)
    _hold_flash_kernels(*case, causal, dtype)


def _hold_flash_kernels(q, k, v, dout, seg, causal, dtype):
    kw = dict(causal=causal, segment_ids=seg)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)
    delta = fa.flash_delta(ref_out, dout)
    args = (q, k, v, dout, ref_lse, delta)
    dq = fa.flash_dq(*args, **kw)
    dk, dv = fa.flash_dkv(*args, **kw)
    _close(dq, fa.flash_dq_reference(*args, **kw), dtype)
    for got, want in zip((dk, dv), fa.flash_dkv_reference(*args, **kw)):
        _close(got, want, dtype)
    # two passes without atomics: the same bits on every run
    assert torch.equal(dq, fa.flash_dq(*args, **kw))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv), fa.flash_dkv(*args, **kw)))


def test_flash_launch_counters_count_kernel_launches_only(card):
    fa.reset_launch_counts()
    q, k, v, dout, _ = _flash_case(card, 1, 64, 4, 2, 64, torch.float32)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(tq, tk, tv).backward(dout)
    fa.flash_attention_reference(q, k, v)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == (1, 1, 1)


def test_flash_refuses_unsupported_head_dim(card):
    q, k, v, _, _ = _flash_case(card, 1, 64, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, k, v)


@pytest.mark.parametrize("change,match", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), "dtypes"),
    (lambda q, k, v: (q, k.bfloat16(), v), "dtypes"),
    (lambda q, k, v: (q.transpose(1, 2).contiguous().transpose(1, 2), k, v), "contiguous"),
], ids=["fp16", "mixed", "strided"])
def test_flash_refuses_other_dtypes_and_layouts(card, change, match):
    q, k, v, dout, _ = _flash_case(card, 1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd(*change(q, k, v))
    q, k, v = change(q, k, v)
    lse = torch.zeros((1, 4, 64), device=card)
    with pytest.raises(ValueError, match=match):
        fa.flash_dkv(q, k, v, dout.to(q.dtype), lse, lse)


def _train(device, steps=3):
    """Three train calls (accumulation 1) of the f32 tiny model, flash path."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, head_dim=64,
                                 attention_impl="pallas")
    model = Transformer(cfg, device=device)
    # made on the CPU for both runs: the card's generator draws other values
    model.load_state_dict(init_params(cfg, seed=2, device="cpu", dtype=torch.float32))
    acc = Accelerator(cpu=device == "cpu")
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.SGD, lr=0.1))
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    ids = np.random.default_rng(5).integers(1, 256, (steps * 2, 48)).astype(np.int32)
    loader = acc.prepare(SimpleDataLoader([{"input_ids": r} for r in ids], batch_size=2))
    metrics = [{k: float(v) for k, v in step(state, batch)[1].items()} for batch in loader]
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    return metrics, {k: v.detach().cpu() for k, v in model.named_parameters()}


def test_train_steps_on_card_match_cpu(card):
    """The train step with K3-K5 on the card against the same three steps
    with the plain versions on the CPU: f32, SGD, so parameters differ only
    by lr times the kernels' summation-order noise."""
    fa.reset_launch_counts()
    got, got_params = _train(None)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == (6, 6, 6)
    want, want_params = _train("cpu")
    for g, w in zip(got, want):
        assert g["applied"] == w["applied"] == 1.0
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    for name in want_params:
        torch.testing.assert_close(got_params[name], want_params[name], atol=1e-5, rtol=0)

"""Card-only tests of the port: the CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips without a card.  This file
imports torch and the port only (no JAX), so it also runs on a machine that
has no JAX; run it there with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 (the kernels sum in another order than the plain
version, measured errors are ~1e-6); bf16 2e-2 — the plain version rounds
logits and probabilities to bf16 where the kernels keep f32.
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.weights import init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


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

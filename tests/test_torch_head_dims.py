"""Port parity at the head dims of the wide- and narrow-head families: D 80, 96 and 256.

Phi-2, StableLM-3B and CodeGen-2B attend with heads of 80, Phi-3-mini of 96,
Gemma and GPT-J of 256.  The five kernels take these head dims on the card;
here, on the CPU, each wrapper takes its plain PyTorch version, held against
the JAX Pallas kernel run in interpret mode on the same numpy-seeded inputs,
as the JAX package's own tests run it:

* K1 (``paged_attention``): decode and a verify span, the tree-mask arm, and
  int8 and fp8-e4m3 pages with their scales;
* K2 (``paged_flash_prefill``): native pages and int8 / fp8-e4m3 pages;
* K3 (``flash_fwd``): the output and the row logsumexp;
* K4 and K5 (``flash_dq``, ``flash_dkv``): through the gradients of the
  port's ``flash_attention`` against ``jax.grad`` of the JAX one.

And the wrappers' card path still refuses a head dim no kernel takes (72)
with ``ValueError`` before any launch.

Tolerances, as the port's other parity files state them: paged f32 2e-5 (the
JAX kernel's online softmax against the port's full-row softmax); bf16 2e-2
(decode) and 3e-2 (prefill), the plain version rounding logits and
probabilities to bf16 where the kernel keeps f32; quantized pages as the q
dtype's; flash f32 1e-5 (the same f32 products summed in other orders), the
gradients 2e-5 at D 256 (sums of 256-term products, each ~16 x a D 16 term).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu.ops import paged_attention as jpa
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as tpa
from test_torch_paged_attention import (
    _quantized_scenario,
    _run_both,
    _run_quantized,
    _scenario,
    _tree_masks,
)

DIMS = [80, 96, 256]
PAGED_ATOL = {"decode": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
              "prefill": {torch.float32: 2e-5, torch.bfloat16: 3e-2}}
FLASH_ATOL = {80: 1e-5, 96: 1e-5, 256: 2e-5}

DECODE = [
    # n, s, page, pages_per_lane, hkv, rep
    (3, 1, 8, 4, 2, 2),   # decode, GQA rep 2
    (2, 3, 8, 4, 1, 2),   # a verify span crossing a page
]
PREFILL = [
    (2, 16, 8, 6, 2, 2),  # a chunk across pages, GQA rep 2
    (1, 40, 16, 5, 1, 1),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As the family files: the small plain versions gain nothing from
    intra-op threads, which contend for the cores under the tier-1 run's
    six workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", DECODE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_matches_jax_kernel(d, case, dtype):
    arrays = _scenario(_seed("decode", case, d), *case, d)
    out, ref = _run_both(jpa.paged_attention, tpa.paged_attention, arrays, dtype)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=PAGED_ATOL["decode"][dtype])


@pytest.mark.parametrize("d", DIMS)
def test_tree_arm_matches_jax_kernel(d):
    """K1's tree-mask arm: the port's plain version with the mask against the
    JAX kernel in interpret mode and its plain version, f32."""
    anc = _tree_masks()["2x3"]
    q, pk, pv, tables, lengths = _scenario(_seed("tree", d), 3, anc.shape[0], 8, 4, 2, 1, d)
    jargs = tuple(jnp.asarray(a) for a in (q, pk, pv, tables, lengths))
    kernel = np.asarray(jpa.paged_attention(*jargs, tree_mask=anc, interpret=True))
    ref = np.asarray(jpa.paged_attention_reference(*jargs, tree_mask=anc))
    targs = [torch.from_numpy(a) for a in (q, pk, pv, tables, lengths)]
    out = tpa.paged_attention(*targs, tree_mask=anc).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, kernel, atol=2e-5)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert np.abs(tpa.paged_attention(*targs).numpy() - out).max() > 1e-3  # the mask matters


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantized_decode_matches_jax_kernel(d, fmt, dtype):
    case = DECODE[0] + (d,)
    out, ref = _run_quantized(jpa.paged_attention, tpa.paged_attention,
                              _seed("qdecode", d, fmt), fmt, dtype, case)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=PAGED_ATOL["decode"][dtype])


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", PREFILL)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_prefill_matches_jax_kernel(d, case, dtype):
    arrays = _scenario(_seed("prefill", case, d), *case, d)
    out, ref = _run_both(jpa.paged_flash_prefill, tpa.paged_flash_prefill, arrays, dtype)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=PAGED_ATOL["prefill"][dtype])


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantized_prefill_matches_jax_kernel(d, fmt, dtype):
    case = PREFILL[0] + (d,)
    out, ref = _run_quantized(jpa.paged_flash_prefill, tpa.paged_flash_prefill,
                              _seed("qprefill", d, fmt), fmt, dtype, case)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=PAGED_ATOL["prefill"][dtype])


def test_quantized_scenario_holds_codes():
    """The quantized cases above read real codes: the JAX arrays and the
    port's tensors hold the same bits, and most codes are nonzero."""
    (_, jk, _, _, _, _, _), (tk, _) = _quantized_scenario(1, "int8", *PREFILL[0], 80)
    assert np.array_equal(np.asarray(jk).view(np.uint8), tk.view(torch.uint8).numpy())
    assert (tk != 0).float().mean().item() > 0.5


# ----------------------------------------------------------------- K3 - K5
B, S = 2, 64


def _flash_inputs(seed, hq, hkv, d, segmented):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, hkv, d)).astype(np.float32) for _ in range(2))
    seg = None
    if segmented:
        cuts = np.sort(rng.choice(np.arange(1, S), size=(B, 2), replace=False), axis=1)
        seg = (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(np.int32)
    return q, k, v, seg


def _jax_fwd(q, k, v, seg, causal):
    """The JAX forward kernel's ``(out, lse)`` in interpret mode, through its
    wrapper's layout and block choice (``flash_attention.py:524-548``)."""
    hq, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    rep = hq // hkv
    bq = 128 if rep == 1 else max(128 // rep, 32)
    cfg = jfa._Config(bool(causal), d ** -0.5, bq, 1024, bq, 512, True)
    segs = None if seg is None else jfa._broadcast_segments(jnp.asarray(seg), S, S)
    swap = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)  # noqa: E731
    out5, lse5 = jfa._flash_fwd_bhsd(jfa._fold(swap(q), hkv), swap(k), swap(v), segs, cfg)
    return (np.asarray(jnp.swapaxes(jfa._unfold(out5), 1, 2)),
            np.asarray(lse5[..., 0]).reshape(B, hq, S))


FLASH_CASES = [  # hq, hkv, causal, segmented
    (4, 2, True, False),
    (8, 1, True, True),   # Gemma-2B's multi-query group, packed segments
    (4, 4, False, False),
]


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("hq,hkv,causal,segmented", FLASH_CASES)
def test_flash_forward_matches_jax(d, hq, hkv, causal, segmented):
    q, k, v, seg = _flash_inputs(_seed("fwd", d, hq, causal), hq, hkv, d, segmented)
    ref_out, ref_lse = _jax_fwd(q, k, v, seg, causal)
    out, lse = fa.flash_fwd(_t(q), _t(k), _t(v), causal=causal, segment_ids=_t(seg))
    assert out.shape == (B, S, hq, d) and lse.shape == (B, hq, S)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=FLASH_ATOL[d])
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=FLASH_ATOL[d])


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("hq,hkv,causal,segmented", FLASH_CASES)
def test_flash_gradients_match_jax_grad(d, hq, hkv, causal, segmented):
    """dq (K4), dk and dv (K5, unexpanded over the GQA group) through the
    port's autograd Function against ``jax.grad`` of the JAX Pallas
    function, under a random cotangent."""
    q, k, v, seg = _flash_inputs(_seed("bwd", d, hq, causal), hq, hkv, d, segmented)
    w = np.random.default_rng(_seed("w", d)).normal(size=q.shape).astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v, causal=causal, segment_ids=jseg) * w).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, segment_ids=_t(seg))
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLASH_ATOL[d])


# ------------------------------------------------------ the card path's gate
class _CardTensor:
    """Stands in for a CUDA tensor: what the wrappers' checks read before any
    launch (device, shape, dtype), and nothing else."""

    def __init__(self, *shape, dtype=torch.bfloat16):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)


@pytest.fixture
def no_launch(monkeypatch):
    def launch(*args):
        raise AssertionError("a refused head dim reached a launch")

    monkeypatch.setattr(_build, "launch", launch)


@pytest.mark.parametrize("d", [72, 48, 512])
def test_paged_wrappers_refuse_an_unported_head_dim(no_launch, d):
    q = _CardTensor(2, 1, 4, d)
    pages = _CardTensor(9, 16, 2, d)
    tables, lengths = _CardTensor(2, 4, dtype=torch.int32), _CardTensor(2, dtype=torch.int32)
    for fn in (tpa.paged_attention, tpa.paged_flash_prefill):
        with pytest.raises(ValueError, match="head_dim"):
            fn(q, pages, pages, tables, lengths)


@pytest.mark.parametrize("d", [72, 48, 512])
def test_flash_wrappers_refuse_an_unported_head_dim(no_launch, d):
    q, k = _CardTensor(1, 64, 4, d), _CardTensor(1, 64, 2, d)
    stat = _CardTensor(1, 4, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, k, k)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_dq(q, k, k, q, stat, stat)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_dkv(q, k, k, q, stat, stat)


def test_new_head_dims_are_taken():
    for d in DIMS:
        assert d in tpa._HEAD_DIMS and d in tpa._WGMMA_HEAD_DIMS and d in fa._HEAD_DIMS
    for dtype in (torch.bfloat16, torch.int8, torch.float8_e4m3fn):
        assert tpa.prefill_design(torch.bfloat16, dtype, 128, 80) == "wgmma"
    assert tpa.prefill_design(torch.float32, torch.float32, 128, 256) == "cuda-cores"

"""Port parity: flash attention (the plain versions of K3, K4, K5) vs the JAX Pallas kernels.

The same numpy-seeded f32 inputs go through the JAX ``flash_attention``
(Pallas in interpret mode, as the JAX package's own tests run it on the CPU)
and through the port's ``flash_attention``, whose CPU path is the plain
PyTorch version of each kernel.  Shapes stay at S <= 64 and head_dim 32, so
each JAX grid is one program per (batch, kv-head).

Tolerance: f32 atol 1e-5 — both sides sum the same f32 products in
different orders (measured differences are a few 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu.ops.attention import causal_mask as jcausal_mask
from accelerate_tpu.ops.attention import dot_product_attention as jdot_product_attention
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops.attention import causal_mask, dot_product_attention, xla_attention

ATOL = 1e-5
B, S, D = 2, 64, 32
HEADS = [(4, 4), (4, 2), (8, 2)]  # (Hq, Hkv): MHA, GQA 4:2, GQA 8:2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, hq, hkv, s=S, segmented=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, s, hq, D)).astype(np.float32)
    k = rng.normal(size=(B, s, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, s, hkv, D)).astype(np.float32)
    seg = None
    if segmented:
        # three packed sequences per row, boundaries differing between rows
        cuts = np.sort(rng.choice(np.arange(1, s), size=(B, 2), replace=False), axis=1)
        seg = (np.arange(s)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(np.int32)
    return q, k, v, seg


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax_fwd(q, k, v, seg, causal):
    """The JAX forward kernel's (out, lse) through its own wrapper's layout
    and block choice (``flash_attention.py:524-548``)."""
    hq, hkv = q.shape[2], k.shape[2]
    rep = hq // hkv
    bq = 128 if rep == 1 else max(128 // rep, 32)
    cfg = jfa._Config(bool(causal), D ** -0.5, bq, 1024, bq, 512, True)
    segs = None if seg is None else jfa._broadcast_segments(jnp.asarray(seg), S, S)
    swap = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)  # noqa: E731
    out5, lse5 = jfa._flash_fwd_bhsd(jfa._fold(swap(q), hkv), swap(k), swap(v), segs, cfg)
    out = np.asarray(jnp.swapaxes(jfa._unfold(out5), 1, 2))
    lse = np.asarray(lse5[..., 0]).reshape(B, hq, S)
    return out, lse


@pytest.mark.parametrize("segmented", [False, True], ids=["dense", "segments"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv", HEADS, ids=["mha", "gqa4:2", "gqa8:2"])
def test_forward_out_and_lse_match_jax(hq, hkv, causal, segmented):
    q, k, v, seg = _inputs(0, hq, hkv, segmented=segmented)
    ref_out, ref_lse = _jax_fwd(q, k, v, seg, causal)
    out, lse = fa.flash_fwd(*_torch(q, k, v), causal=causal, segment_ids=_torch(seg)[0])
    assert out.dtype == torch.float32 and lse.shape == (B, hq, S)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL)


@pytest.mark.parametrize("segmented", [False, True], ids=["dense", "segments"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv", HEADS, ids=["mha", "gqa4:2", "gqa8:2"])
def test_gradients_match_jax_grad(hq, hkv, causal, segmented):
    """dq, dk, dv through the port's autograd Function (K4 and K5's plain
    versions) against ``jax.grad`` of the JAX Pallas function, under a
    random cotangent."""
    q, k, v, seg = _inputs(1, hq, hkv, segmented=segmented)
    w = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v, causal=causal, segment_ids=jseg) * w).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, segment_ids=_torch(seg)[0])
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal,segmented", [(True, False), (True, True), (False, True)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa8:2"])
def test_plain_backward_matches_autograd_of_dense_attention(hq, hkv, causal, segmented):
    q, k, v, seg = _inputs(3, hq, hkv, segmented=segmented)
    tseg = _torch(seg)[0]
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    dout = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    ref = xla_attention(tq, tk, tv, causal=causal, segment_ids=tseg)
    ref.backward(dout)
    out, lse = fa.flash_attention_reference(tq.detach(), tk.detach(), tv.detach(),
                                            causal=causal, segment_ids=tseg)
    torch.testing.assert_close(out, ref.detach(), atol=ATOL, rtol=0)
    grads = fa.flash_attention_bwd_reference(tq.detach(), tk.detach(), tv.detach(), out, lse,
                                             dout, causal=causal, segment_ids=tseg)
    for got, want in zip(grads, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_bf16_plain_rounds_like_the_kernels():
    """bf16 inputs: the plain forward returns bf16 out and f32 lse, and
    stays within bf16 rounding of the f32 computation on the same values."""
    q, k, v, _ = _inputs(5, 4, 2)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    out, lse = fa.flash_attention_reference(tq, tk, tv)
    out32, lse32 = fa.flash_attention_reference(tq.float(), tk.float(), tv.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse32, atol=ATOL, rtol=0)
    torch.testing.assert_close(out.float(), out32, atol=2e-2, rtol=0)


@pytest.mark.parametrize("causal,segmented", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)], ids=["mha", "gqa4:2"])
def test_xla_dispatch_matches_jax_xla(hq, hkv, causal, segmented):
    q, k, v, seg = _inputs(6, hq, hkv, segmented=segmented)
    ref = jdot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                 implementation="xla",
                                 segment_ids=None if seg is None else jnp.asarray(seg))
    out = dot_product_attention(*_torch(q, k, v), causal=causal, implementation="xla",
                                segment_ids=_torch(seg)[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_pallas_dispatch_is_flash_attention():
    q, k, v, seg = _inputs(7, 4, 2, segmented=True)
    args = _torch(q, k, v)
    got = dot_product_attention(*args, implementation="pallas", segment_ids=_torch(seg)[0])
    want, _ = fa.flash_attention_reference(*args, segment_ids=_torch(seg)[0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("q_len,kv_len", [(5, 5), (3, 7)])
def test_causal_mask_matches_jax(q_len, kv_len):
    np.testing.assert_array_equal(causal_mask(q_len, kv_len).numpy(),
                                  np.asarray(jcausal_mask(q_len, kv_len)))


@pytest.mark.parametrize("kw,item", [
    (dict(implementation="blocked", window=8), "implementation='xla' only"),
    (dict(implementation="ring", window=8), "implementation='xla' only"),
    (dict(implementation="pallas", window=8), "implementation='xla' only"),
    (dict(implementation="pallas", bias=torch.zeros(1)), "implementation='xla' only"),
])
def test_unported_implementations_raise(kw, item):
    q, k, v, _ = _inputs(8, 4, 4)
    with pytest.raises(NotImplementedError, match=item):
        dot_product_attention(*_torch(q, k, v), **kw)


def test_unknown_implementation_is_a_value_error():
    q, k, v, _ = _inputs(8, 4, 4)
    with pytest.raises(ValueError, match="unknown"):
        dot_product_attention(*_torch(q, k, v), implementation="cudnn")


def test_cpu_tensors_take_the_plain_versions_without_counting_launches():
    fa.reset_launch_counts()
    q, k, v, _ = _inputs(9, 4, 2)
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    fa.flash_attention(tq, tk, tv).sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == (0, 0, 0)


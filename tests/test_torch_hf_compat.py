"""Port parity: Hugging Face checkpoint interop (``models/hf_compat.py``).

Tiny random HF models of every mapped model type are built locally with
the installed ``transformers``, their biases and norm parameters drawn
nonzero, and written with ``save_pretrained`` (nothing is downloaded), in
safetensors, torch-bin and sharded form.  For each:

* ``config_from_hf`` gives the JAX package's config, field for field, and
  the same refusals (Qwen2's mixed ``max_window_layers``, Falcon's alibi,
  unmapped activations; ``mixtral`` with the drop-free capacity factor);
* the port's loaded state dict equals, bit for bit, ``params_from_jax`` of
  the JAX ``convert_hf_checkpoint`` output, and so does the port's own
  converted directory read back;
* the port's f32 logits match the HF torch model's within ``HF_ATOL``.

And a checkpoint directory as ``draft_model`` (``"dir#n"``): the tree-verify
engine's greedy tokens equal the JAX engine's on the same checkpoint.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from accelerate_tpu.big_modeling import _checkpoint_files, _read_tensors  # noqa: E402
from accelerate_tpu.models import hf_compat as jhf  # noqa: E402
from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig  # noqa: E402
from accelerate_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from accelerate_tpu.telemetry import MetricsRegistry  # noqa: E402
from accelerate_tpu.utils.modeling import unflatten_tree  # noqa: E402
from accelerate_tpu_torch.checkpointing import load_file  # noqa: E402
from accelerate_tpu_torch.models import hf_compat  # noqa: E402
from accelerate_tpu_torch.models.generation import GenerationConfig  # noqa: E402
from accelerate_tpu_torch.models.transformer import state_dict_shapes  # noqa: E402
from accelerate_tpu_torch.serving import ServingEngine  # noqa: E402
from accelerate_tpu_torch.weights import params_from_jax  # noqa: E402

#: f32 logits of the port against the HF torch model: the same weights,
#: other summation orders and other formulas for the same functions
#: (``baddbmm`` alibi, fused qkv products); the reference's own HF parity
#: tests hold 3e-4
HF_ATOL = 3e-4
DROP = dict(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
#: model type -> (config class, model class, tiny config kwargs); the
#: reference's own HF fixtures (tests/test_hf_compat.py)
HF_MODELS = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel",
             dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4, **DROP)),
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(vocab_size=128, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=128, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64, dropout=0.0,
                 attention_dropout=0.0, word_embed_proj_dim=48)),
    "gptj": ("GPTJConfig", "GPTJForCausalLM",
             dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4, rotary_dim=8,
                  **DROP)),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM",
                 dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, rotary_pct=0.25,
                      max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(vocab_size=128, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                     sliding_window=8, attn_implementation="eager")),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(vocab_size=128, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=1, head_dim=24,
                   max_position_embeddings=64, attn_implementation="eager")),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(vocab_size=128, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                  pad_token_id=0)),
    "falcon": ("FalconConfig", "FalconForCausalLM",
               dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    bias=False, alibi=False, parallel_attn=True, pad_token_id=0,
                    attention_dropout=0.0, hidden_dropout=0.0, new_decoder_architecture=False,
                    multi_query=True)),
    "falcon_40b_style": ("FalconConfig", "FalconForCausalLM",
                         dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                              num_attention_heads=4, bias=False, alibi=False, parallel_attn=True,
                              pad_token_id=0, attention_dropout=0.0, hidden_dropout=0.0,
                              new_decoder_architecture=True, multi_query=False, num_kv_heads=2)),
    "stablelm": ("StableLmConfig", "StableLmForCausalLM",
                 dict(vocab_size=128, hidden_size=64, intermediate_size=160,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=64, use_qkv_bias=True, pad_token_id=0,
                      attention_dropout=0.0, hidden_dropout=0.0)),
    "gpt_bigcode": ("GPTBigCodeConfig", "GPTBigCodeForCausalLM",
                    dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
                         pad_token_id=0, **DROP)),
    "phi": ("PhiConfig", "PhiForCausalLM",
            dict(vocab_size=128, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
                 partial_rotary_factor=0.5, resid_pdrop=0.0, embd_pdrop=0.0,
                 attention_dropout=0.0, pad_token_id=0)),
    "bloom": ("BloomConfig", "BloomForCausalLM",
              dict(vocab_size=128, hidden_size=48, n_layer=2, n_head=6, hidden_dropout=0.0,
                   attention_dropout=0.0, pad_token_id=3)),
    "codegen": ("CodeGenConfig", "CodeGenForCausalLM",
                dict(vocab_size=96, n_embd=64, n_layer=2, n_head=8, rotary_dim=4,
                     n_positions=64, **DROP)),
    "mpt": ("MptConfig", "MptForCausalLM",
            dict(d_model=64, n_heads=8, n_layers=2, vocab_size=96, max_seq_len=64,
                 expansion_ratio=2, resid_pdrop=0.0, emb_pdrop=0.0)),
}
MIXTRAL = ("MixtralConfig", "MixtralForCausalLM",
           dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                num_local_experts=4, num_experts_per_tok=2, sliding_window=None,
                pad_token_id=0, attention_dropout=0.0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under the
    tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_telemetry_off():
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


def _build(spec, seed):
    """A tiny random HF model.  HF draws biases and norm parameters as zeros
    and ones, under which a swapped, dropped or misplaced one maps to the
    same function: each 1-D parameter gets normal(0.1) noise added."""
    config_cls, model_cls, kw = spec
    cfg = getattr(transformers, config_cls)(**kw)
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(torch.randn_like(p) * 0.1)
    return model


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """``saved(name, **save_pretrained kwargs)`` -> (directory, HF model),
    each built and saved once for the module."""
    built = {}

    def get(name, spec=None, **save_kw):
        key = (name, tuple(sorted(save_kw.items())))
        if key not in built:
            path = str(tmp_path_factory.mktemp(name))
            model = _build(spec or HF_MODELS[name], seed=len(name))
            model.save_pretrained(path, **{"safe_serialization": True, **save_kw})
            built[key] = (path, model)
        return built[key]

    return get


def _jax_converted(path) -> dict:
    """``params_from_jax`` of the JAX package's conversion of ``path``."""
    native = jhf.convert_hf_checkpoint(path)
    files = _checkpoint_files(native)
    tree = unflatten_tree(_read_tensors(files, list(files)))
    return params_from_jax(tree, device="cpu")


def _assert_bitwise(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype, name
        assert torch.equal(ours[name], theirs[name]), name


def _config_fields(cfg) -> dict:
    """The config's fields other than the dtypes (torch against jnp), and
    the JAX-only ones (scan, remat, ring layout, paged kernel ...)."""
    from accelerate_tpu_torch.models.transformer import TransformerConfig

    names = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype", "param_dtype"}
    return {n: getattr(cfg, n) for n in names}


@pytest.mark.parametrize("name", list(HF_MODELS))
def test_config_from_hf_matches_jax(saved, name):
    path, _ = saved(name)
    assert hf_compat.is_hf_checkpoint(path) and jhf.is_hf_checkpoint(path)
    assert _config_fields(hf_compat.config_from_hf(path)) == _config_fields(
        jhf.config_from_hf(path))


@pytest.mark.parametrize("name", list(HF_MODELS))
def test_loaded_state_dict_is_the_jax_conversion_bitwise(saved, name):
    path, _ = saved(name)
    model, sd = hf_compat.load_hf_checkpoint(path, device="cpu")
    theirs = _jax_converted(path)
    _assert_bitwise(sd, theirs)
    assert {k: v.data_ptr() for k, v in model.state_dict().items()} == \
        {k: v.data_ptr() for k, v in sd.items()}
    # the port's own converted directory, read back, holds the same bits
    out = hf_compat.convert_hf_checkpoint(path)
    assert hf_compat.convert_hf_checkpoint(path) == out  # the stamp makes it a no-op
    _, from_native = hf_compat.load_hf_checkpoint(out, device="cpu")
    _assert_bitwise(from_native, theirs)


@pytest.mark.parametrize("name", list(HF_MODELS))
def test_logits_match_hf(saved, name):
    path, hf_model = saved(name)
    model, _ = hf_compat.load_hf_checkpoint(
        path, device="cpu", config_overrides=dict(dtype=torch.float32))
    vocab = model.config.vocab_size
    ids = np.random.default_rng(len(name)).integers(1, vocab, (2, 21)).astype(np.int64)
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(ids)).logits.float()
        out = model(torch.from_numpy(ids))
    torch.testing.assert_close(out, ref, atol=HF_ATOL, rtol=HF_ATOL)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_torch_bin_and_sharded_checkpoints_load_the_same(saved, name):
    """``pytorch_model.bin`` (``torch.load(weights_only=True)``) and a
    sharded safetensors checkpoint (``model.safetensors.index.json``) load
    the same bits as the single safetensors file."""
    path, _ = saved(name)
    _, want = hf_compat.load_hf_checkpoint(path, device="cpu")
    bin_path, _ = saved(name, safe_serialization=False)
    assert os.path.isfile(os.path.join(bin_path, "pytorch_model.bin"))
    _, got = hf_compat.load_hf_checkpoint(bin_path, device="cpu")
    _assert_bitwise(got, want)
    sharded, _ = saved(name, max_shard_size="40KB")
    with open(os.path.join(sharded, "model.safetensors.index.json")) as f:
        assert len(set(json.load(f)["weight_map"].values())) > 1
    _, got = hf_compat.load_hf_checkpoint(sharded, device="cpu")
    _assert_bitwise(got, want)
    _assert_bitwise(got, _jax_converted(sharded))


def test_converted_shards_split_at_the_byte_limit(saved, tmp_path):
    path, _ = saved("llama")
    out = hf_compat.convert_hf_checkpoint(path, out_dir=str(tmp_path / "native"),
                                          max_shard_bytes=64 << 10, dtype=torch.bfloat16)
    with open(os.path.join(out, "model.safetensors.index.json")) as f:
        weight_map = json.load(f)["weight_map"]
    shards = sorted(set(weight_map.values()))
    assert len(shards) > 1
    tensors = {}
    for shard in shards:
        tensors.update(load_file(os.path.join(out, shard)))
    assert sorted(tensors) == sorted(weight_map)
    assert all(t.dtype == torch.bfloat16 for t in tensors.values())
    _, sd = hf_compat.load_hf_checkpoint(out, device="cpu")
    assert sd["final_norm.scale"].dtype == torch.float32  # norms back to f32


def test_pythia_6_9b_maps_as_jax():
    """The card's NeoX line: Pythia-6.9B's published ``config.json`` values
    give the JAX package's config, and 6.86 B parameters."""
    cfg = hf_compat.config_from_hf_dict(dict(hf_compat.PYTHIA_6_9B))
    assert _config_fields(cfg) == _config_fields(
        jhf._config_from_hf_dict(dict(hf_compat.PYTHIA_6_9B)))
    n = sum(int(np.prod(s)) for s in state_dict_shapes(cfg).values())
    assert 6.85e9 < n < 6.87e9


def _hf_dict(model_type, **kw):
    base = dict(model_type=model_type, vocab_size=128, hidden_size=64, num_hidden_layers=4,
                num_attention_heads=4, intermediate_size=128)
    return {**base, **kw}


@pytest.mark.parametrize("hf,match", [
    (_hf_dict("qwen2", use_sliding_window=True, max_window_layers=2, sliding_window=8),
     "max_window_layers"),
    (_hf_dict("falcon", alibi=True), "alibi"),
    (dict(model_type="gpt2", vocab_size=128, n_embd=64, n_layer=2, n_head=4,
          activation_function="relu"), "activation"),
    (_hf_dict("gpt_neox", hidden_act="relu"), "hidden_act"),
    (_hf_dict("gemma", hidden_activation="gelu"), "activation"),
    (_hf_dict("mpt", d_model=64, n_heads=6, n_layers=2), "power-of-2"),
    (_hf_dict("t5"), "no key mapping"),
])
def test_config_refusals_match_jax(hf, match):
    with pytest.raises(NotImplementedError, match=match):
        hf_compat.config_from_hf_dict(dict(hf))
    with pytest.raises(NotImplementedError, match=match):
        jhf._config_from_hf_dict(dict(hf))


def test_qwen2_window_layer_semantics_match_jax():
    """All layers full (``max_window_layers >= layers``) or all sliding
    (``max_window_layers <= 0``), as the reference maps them."""
    for mwl, window in ((4, None), (0, 8)):
        hf = _hf_dict("qwen2", use_sliding_window=True, max_window_layers=mwl, sliding_window=8)
        assert hf_compat.config_from_hf_dict(dict(hf)).sliding_window == window
        assert jhf._config_from_hf_dict(dict(hf)).sliding_window == window


def test_mixtral_maps_its_config_and_the_port_refuses_moe(tmp_path):
    """Mixtral (MoE, which the port once refused) maps its config as the
    JAX package does, drop-free capacity factor included, and loads the
    JAX conversion's bits: the router as a ``Linear`` weight, the experts
    stacked ``[E, in, out]`` (``tests/test_torch_moe.py`` holds its logits
    against HF's)."""
    model = _build(MIXTRAL, seed=23)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    assert hf_compat.is_hf_checkpoint(str(tmp_path))
    cfg = hf_compat.config_from_hf(str(tmp_path))
    assert cfg.num_experts == 4 and cfg.expert_capacity_factor == 2.0
    assert _config_fields(cfg) == _config_fields(jhf.config_from_hf(str(tmp_path)))
    _, sd = hf_compat.load_hf_checkpoint(str(tmp_path), device="cpu")
    assert sd["layers.0.moe_mlp.experts.gate_proj.weight"].shape == (4, 64, 96)
    _assert_bitwise(sd, _jax_converted(str(tmp_path)))


def test_placement_refusals(saved, tmp_path):
    """A map spanning the card, ``"cpu"`` and ``"disk"`` is big-model
    dispatch (``big_modeling``, item 10a; ``tests/test_torch_big_modeling.py``
    loads such maps); a second card is item 9e, and a map that leaves a
    module out is refused."""
    path, _ = saved("llama")
    full = {m: "cpu" for m in ("embed_tokens", "layers.0", "layers.1", "final_norm", "lm_head")}
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9e"):
        hf_compat.load_hf_checkpoint(path, device="cpu", device_map={**full, "layers.1": "cuda:1"})
    with pytest.raises(ValueError, match="does not cover"):
        hf_compat.load_hf_checkpoint(path, device="cpu",
                                     device_map={"layers.0": "cpu", "layers.1": 0})
    model, _ = hf_compat.load_hf_checkpoint(path, device_map={"": "cpu"})
    assert model.device == torch.device("cpu")
    assert not hf_compat.is_hf_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        hf_compat.config_from_hf(str(tmp_path))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_checkpoint_draft_tree_tokens_match_jax(saved, paged):
    """``draft_model="<dir>#1"``: a one-layer draft streamed from the HF
    checkpoint drafts a ``TreeSpec(2, 3)`` tree for the served model (the
    same checkpoint, f32); the greedy tokens equal the JAX engine's, which
    streams the same draft through its own ``hf_compat``."""
    path, _ = saved("llama")
    jcfg = jhf.config_from_hf(path, dtype=jnp.float32, param_dtype=jnp.float32)
    native = jhf.convert_hf_checkpoint(path)
    files = _checkpoint_files(native)
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     unflatten_tree(_read_tensors(files, list(files))))
    model, _ = hf_compat.load_hf_checkpoint(path, device="cpu",
                                            config_overrides=dict(dtype=torch.float32))
    knobs = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2, prefix_cache_mb=0, paged=paged, draft_model=path + "#1",
                 tree_width=2, tree_depth=3, draft_ctx=16)
    jeng = JServingEngine(JTransformer(jcfg), jparams, registry=MetricsRegistry(), **knobs)
    eng = ServingEngine(model, None, device="cpu", **knobs)
    assert eng.draft.config.num_layers == 1 and eng.draft.config.dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (3, 14, 5, 9)]
    jreqs = jeng.serve([p.copy() for p in prompts], configs=JGenerationConfig(max_new_tokens=12))
    reqs = eng.serve([p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=12))
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert eng.stats["verify_forwards"] > 0 and eng.stats["spec_drafted"] > 0
    assert jeng.stats["spec_drafted"] > 0
    # the default depth is a quarter of the checkpoint's (at least one layer)
    deflt = ServingEngine(model, None, device="cpu", **dict(knobs, draft_model=path))
    assert deflt.draft.config.num_layers == 1
    with pytest.raises(ValueError, match="out of range"):
        ServingEngine(model, None, device="cpu", **dict(knobs, draft_model=path + "#3"))


def test_port_imports_neither_transformers_nor_safetensors():
    """AST walk: the card's machine has neither package, so no module of the
    port and not ``chip_smoke.py`` imports them (nor JAX: the AST test of
    ``test_torch_engine.py``)."""
    import ast
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sources = sorted((repo / "accelerate_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    offenders = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(repo)}: {n}" for n in names
                          if n.split(".")[0] in ("transformers", "safetensors")]
    assert (repo / "accelerate_tpu_torch/models/hf_compat.py") in sources
    assert offenders == []

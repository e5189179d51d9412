"""Hugging Face checkpoint interop for the port's :class:`Transformer`.

Port of :mod:`accelerate_tpu.models.hf_compat`.  The port keeps its own copy
of everything (it imports nothing of the JAX package, nor ``transformers`` or
``safetensors``):

* :func:`config_from_hf` — ``config.json`` -> :class:`TransformerConfig` for
  the 17 mapped model types, with the reference's refusals (Qwen2's mixed
  ``max_window_layers``, Falcon's alibi, unmapped activations, ...).
  ``mixtral`` loads with the drop-free capacity factor ``E / k``.
* one key map per family: port state-dict name -> ``(hf_key, transform)``.
  HF ``Linear`` weights are already ``[out, in]``, the port's layout, so they
  pass through; GPT-2's ``Conv1D`` weights (``[in, out]``) are transposed;
  the fused-qkv splits of GPT-2, NeoX, BLOOM, Falcon, BigCode, CodeGen, MPT
  and Phi-3 slice the same rows the reference slices.  Mixtral's per-expert
  ``w1``/``w3``/``w2`` gather onto the stacked expert axis: the entry's key
  is then a tuple of HF keys and its transform takes the list of them.
* a ``quantization`` config (``config_overrides={"quantization": 8}``)
  quantizes the mapped weights on the host before they are placed.
* :func:`stream_mapped_tensors` — one shard resident at a time, safetensors
  through :func:`~accelerate_tpu_torch.checkpointing.load_file` and torch-bin
  through ``torch.load(weights_only=True)``, single-file or sharded
  (``*.index.json``).
* :func:`convert_hf_checkpoint` — a sharded safetensors directory in the
  port's naming, written by :func:`~accelerate_tpu_torch.checkpointing.save_file`.
* :func:`load_hf_checkpoint` — the model and its state dict on one device.

The reference's ``to_scan_layout`` has no counterpart: the port has no
scanned layers.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

from .._device import resolve_device
from ..checkpointing import load_file, save_file
from ..ops.quantization import QuantizationConfig, quantize_model_params
from ..weights import is_f32_param
from .transformer import Transformer, TransformerConfig

__all__ = [
    "GEMMA_7B",
    "MIXTRAL_8X7B",
    "PHI_2",
    "PYTHIA_6_9B",
    "SUPPORTED_MODEL_TYPES",
    "config_from_hf",
    "config_from_hf_dict",
    "convert_hf_checkpoint",
    "is_hf_checkpoint",
    "load_hf_checkpoint",
    "native_key_map",
    "stream_mapped_tensors",
]

# architectures with a key mapping; config.json "model_type" values
SUPPORTED_MODEL_TYPES = (
    "gpt2", "llama", "opt", "gptj", "gpt_neox", "mistral", "qwen2", "gemma",
    "phi3", "falcon", "stablelm", "gpt_bigcode", "mixtral", "phi", "bloom",
    "codegen", "mpt",
)

#: EleutherAI ``pythia-6.9b``'s published ``config.json`` (the keys
#: :func:`config_from_hf_dict` reads): GPT-NeoX at 7B width, served without
#: its weights file from random weights
PYTHIA_6_9B = {
    "model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"],
    "hidden_size": 4096, "intermediate_size": 16384, "num_hidden_layers": 32,
    "num_attention_heads": 32, "vocab_size": 50432, "rotary_pct": 0.25,
    "rotary_emb_base": 10000, "max_position_embeddings": 2048, "layer_norm_eps": 1e-5,
    "use_parallel_residual": True, "hidden_act": "gelu", "tie_word_embeddings": False,
}

#: Google ``gemma-7b``'s published ``config.json``: Gemma at 7B width, head
#: dim 256 (16 heads of 256 over hidden 3072), served without its weights
#: file from random weights.  The file names the activation twice: the
#: legacy ``hidden_act`` "gelu" and ``hidden_activation`` "gelu_pytorch_tanh",
#: which the mapping reads first
GEMMA_7B = {
    "model_type": "gemma", "architectures": ["GemmaForCausalLM"],
    "hidden_size": 3072, "intermediate_size": 24576, "num_hidden_layers": 28,
    "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 256,
    "vocab_size": 256000, "max_position_embeddings": 8192, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "attention_bias": False, "hidden_act": "gelu",
    "hidden_activation": "gelu_pytorch_tanh",
}

#: Microsoft ``phi-2``'s published ``config.json``: Phi at 2.7B width, head
#: dim 80 (32 heads over hidden 2560), rotary over 0.4 of each head (32
#: dims), served without its weights file from random weights
PHI_2 = {
    "model_type": "phi", "architectures": ["PhiForCausalLM"],
    "hidden_size": 2560, "intermediate_size": 10240, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32, "vocab_size": 51200,
    "max_position_embeddings": 2048, "layer_norm_eps": 1e-5, "partial_rotary_factor": 0.4,
    "rope_theta": 10000.0, "hidden_act": "gelu_new", "qk_layernorm": False,
    "tie_word_embeddings": False,
}

#: Mistral AI ``Mixtral-8x7B-v0.1``'s published ``config.json``: 32 layers
#: of hidden 4096, 32 query heads over 8 kv heads of D 128, and in each a
#: sparse MoE MLP of 8 SwiGLU experts of 14336, top 2; untied 32000-row
#: head; served without its weights file from random weights
MIXTRAL_8X7B = {
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "vocab_size": 32000, "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "hidden_act": "silu", "tie_word_embeddings": False,
    "num_local_experts": 8, "num_experts_per_tok": 2, "router_aux_loss_coef": 0.02,
    "output_router_logits": False, "sliding_window": None,
}

#: the stamp a converted directory carries
_STAMP = "atpu_conversion.json"


def _read_hf_config(checkpoint: str) -> Dict[str, Any]:
    path = os.path.join(checkpoint, "config.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{checkpoint} has no config.json — not an HF model directory"
        )
    with open(path) as f:
        return json.load(f)


def config_from_hf(checkpoint: str, **overrides) -> TransformerConfig:
    """Build the native :class:`TransformerConfig` a HF ``config.json`` describes.

    ``overrides`` pass through to the dataclass (e.g.
    ``dtype=torch.float32``).  Also accepts a directory written by
    :func:`convert_hf_checkpoint` (its stamp carries the source config).
    """
    stamp_path = os.path.join(checkpoint, "atpu_conversion.json")
    if not os.path.isfile(os.path.join(checkpoint, "config.json")) and os.path.isfile(stamp_path):
        with open(stamp_path) as f:
            return config_from_hf_dict(json.load(f)["source_config"], **overrides)
    return config_from_hf_dict(_read_hf_config(checkpoint), **overrides)


def _llama_base_fields(
    hf: Dict[str, Any], max_seq_default: int = 4096, eps_default: float = 1e-5
) -> Dict[str, Any]:
    """The shared Llama-recipe config core (llama/mistral/qwen2/gemma all
    speak these 11 keys; family deltas layer on top)."""
    return dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        max_seq_len=hf.get("max_position_embeddings", max_seq_default),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", eps_default),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )


def _gpt2_base_fields(hf: Dict[str, Any]) -> Dict[str, Any]:
    """The shared GPT-2-recipe config core (gpt2 and gpt_bigcode speak the
    n_embd/n_layer/n_head spellings; family deltas layer on top)."""
    return dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
        num_layers=hf["n_layer"],
        num_heads=hf["n_head"],
        num_kv_heads=hf["n_head"],
        max_seq_len=hf.get("n_positions", 1024),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        tie_word_embeddings=hf.get("tie_word_embeddings", True),
        norm_type="layernorm",
        use_bias=True,
        positional="learned",
        mlp_variant="gelu",
    )


def config_from_hf_dict(hf: Dict[str, Any], **overrides) -> TransformerConfig:
    """:func:`config_from_hf` of a ``config.json`` already read into ``hf``."""
    model_type = hf.get("model_type")
    if model_type == "gpt2":
        fields = _gpt2_base_fields(hf)
        if hf.get("activation_function", "gelu_new") not in ("gelu_new", "gelu_pytorch_tanh"):
            raise NotImplementedError(
                f"GPT-2 activation {hf['activation_function']!r} is not mapped "
                "(gelu_new is the family standard)"
            )
    elif model_type == "opt":
        # OPT (the BASELINE big-model-inference flagship, OPT-30B): pre-LN
        # decoder, learned positions with the family's +2 row offset, ReLU
        # MLP, biases everywhere, tied embeddings.
        if not hf.get("do_layer_norm_before", True):
            raise NotImplementedError(
                "OPT with do_layer_norm_before=false (the 350m post-LN variant) "
                "is not mapped; every other OPT size is pre-LN and supported."
            )
        if hf.get("word_embed_proj_dim", hf["hidden_size"]) != hf["hidden_size"]:
            raise NotImplementedError(
                "OPT word_embed_proj_dim != hidden_size (the 350m factorized "
                "embedding) is not mapped."
            )
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["ffn_dim"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            norm_type="layernorm",
            use_bias=True,
            positional="learned",
            pos_offset=2,
            mlp_variant="relu",
        )
        if hf.get("activation_function", "relu") != "relu":
            raise NotImplementedError(
                f"OPT activation {hf['activation_function']!r} is not mapped"
            )
    elif model_type == "gptj":
        # GPT-J-6B (the BASELINE lead row): parallel residual with a SHARED
        # pre-norm, interleaved partial rotary, biasless attention but biased
        # MLP, untied lm_head WITH bias.
        n_embd = hf["n_embd"]
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=n_embd,
            intermediate_size=hf.get("n_inner") or 4 * n_embd,
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            num_kv_heads=hf["n_head"],
            max_seq_len=hf.get("n_positions", 2048),
            rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            norm_type="layernorm",
            positional="rope",
            rope_dim=hf.get("rotary_dim") or n_embd // hf["n_head"],
            rope_interleaved=True,
            parallel_residual=True,
            shared_norm=True,
            attn_bias=False,
            mlp_bias=True,
            lm_head_bias=True,
            mlp_variant="gelu",
        )
    elif model_type == "gpt_neox":
        # GPT-NeoX-20B: parallel residual with two norms, rotate-half partial
        # rotary (rotary_pct), biases everywhere, untied biasless embed_out.
        head_dim = hf["hidden_size"] // hf["num_attention_heads"]
        act = hf.get("hidden_act", "gelu")
        if act not in ("gelu", "gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
            raise NotImplementedError(f"gpt_neox hidden_act {act!r} is not mapped")
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            # current transformers writes "rope_theta"; older NeoX configs
            # used the deprecated "rotary_emb_base" spelling
            rope_theta=hf.get("rope_theta", hf.get("rotary_emb_base", 10000.0)),
            rms_norm_eps=hf.get("layer_norm_eps", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            norm_type="layernorm",
            positional="rope",
            rope_dim=int(hf.get("rotary_pct", 0.25) * head_dim),
            parallel_residual=hf.get("use_parallel_residual", True),
            use_bias=True,
            mlp_variant="gelu_exact" if act == "gelu" else "gelu",
        )
    elif model_type == "llama":
        fields = _llama_base_fields(hf)
        # HF keeps these independent (llamafied Qwen exports use attention
        # biases only); the per-site switches keep the key map exact
        if hf.get("attention_bias", False):
            fields["attn_bias"] = True
        if hf.get("mlp_bias", False):
            fields["mlp_bias"] = True
    elif model_type in ("mistral", "qwen2"):
        # Llama recipe with two deltas: sliding-window attention (Mistral
        # always when config.sliding_window is set; Qwen2 behind
        # use_sliding_window), and Qwen2's q/k/v-only projection biases.
        fields = _llama_base_fields(hf)
        if model_type == "qwen2":
            fields["qkv_bias"] = True  # modeling_qwen2: bias on q/k/v, not o/MLP
            if hf.get("use_sliding_window", False):
                # HF semantics: the FIRST max_window_layers layers use full
                # attention; only layers beyond that use the sliding window
                # (Qwen2Config default 28)
                n = hf["num_hidden_layers"]
                mwl = hf.get("max_window_layers", 28)
                if mwl >= n:
                    pass  # every layer is full attention
                elif mwl <= 0:
                    fields["sliding_window"] = hf.get("sliding_window")
                else:
                    raise NotImplementedError(
                        "qwen2 per-layer mixed attention (first "
                        f"max_window_layers={mwl} of {n} layers full, the "
                        "rest sliding) is not mapped; sliding_window here is "
                        "uniform across layers"
                    )
        else:
            # MistralConfig reconstructs an absent key as 4096 — a json that
            # omits it still means the 4096 window, not full attention
            fields["sliding_window"] = hf.get("sliding_window", 4096)
    elif model_type == "gemma":
        act = hf.get("hidden_activation") or hf.get("hidden_act", "gelu_pytorch_tanh")
        if act not in ("gelu_pytorch_tanh", "gelu_new"):
            # plain "gelu" would be the erf form — a different gate function
            raise NotImplementedError(f"gemma hidden activation {act!r} is not mapped")
        fields = dict(
            _llama_base_fields(hf, max_seq_default=8192, eps_default=1e-6),
            # Gemma always ties; the family switches: (1+scale) RMSNorm with
            # zeros-init offset params, sqrt(hidden) embedding scale, tanh-gelu
            # gated MLP
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            norm_unit_offset=True,
            embed_scale=True,
            mlp_variant="geglu",
        )
        if hf.get("attention_bias", False):
            fields["attn_bias"] = True
    elif model_type == "mixtral":
        # Mistral recipe with the dense MLP replaced by top-k MoE: softmax
        # over all experts, top k, the chosen gates renormalised — HF's
        # routing.  HF computes the capacity-less mixture, so the load takes
        # the drop-free factor E / k: a token's k experts are distinct, so an
        # expert's worst load is all N tokens, E / k times the even share
        # N * k / E (accelerate_tpu/models/hf_compat.py:267-283)
        k = hf.get("num_experts_per_tok", 2)
        fields = dict(_llama_base_fields(hf), sliding_window=hf.get("sliding_window"),
                      num_experts=hf["num_local_experts"], num_experts_per_tok=k,
                      router_aux_loss_coef=hf.get("router_aux_loss_coef", 0.001),
                      expert_capacity_factor=hf["num_local_experts"] / k)
    elif model_type == "mpt":
        # MPT (MosaicML): alibi positions, no_bias scale-only LayerNorms,
        # plain-order fused Wqkv, erf-gelu MLP, tied head.  For power-of-2
        # head counts at the default alibi_bias_max=8, MPT's slope sequence
        # equals the Press et al. slopes the alibi path computes; the
        # non-power-of-2 interleave differs, so it is rejected.
        attn = hf.get("attn_config") or {}
        if not attn.get("alibi", True):
            raise NotImplementedError("mpt without alibi is not mapped")
        if attn.get("alibi_bias_max", 8) != 8:
            raise NotImplementedError("mpt alibi_bias_max != 8 is not mapped")
        if attn.get("qk_ln", False):
            raise NotImplementedError("mpt qk_ln=true is not mapped")
        if attn.get("clip_qkv"):
            raise NotImplementedError("mpt clip_qkv is not mapped")
        if attn.get("softmax_scale") is not None:
            raise NotImplementedError("mpt custom softmax_scale is not mapped")
        n_heads = hf["n_heads"]
        if n_heads & (n_heads - 1):
            raise NotImplementedError(
                "mpt non-power-of-2 head counts use a different alibi-slope "
                "interleave and are not mapped"
            )
        if not hf.get("no_bias", True):
            raise NotImplementedError("mpt no_bias=false (biased variant) is not mapped")
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["d_model"],
            # transformers' MptMLP hardcodes 4*d_model and IGNORES the
            # config's expansion_ratio — parity targets the HF port
            intermediate_size=4 * hf["d_model"],
            num_layers=hf["n_layers"],
            num_heads=n_heads,
            num_kv_heads=n_heads,
            max_seq_len=hf.get("max_seq_len", 2048),
            rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=True,  # lm_head is tied to wte
            norm_type="layernorm",
            norm_bias=False,
            use_bias=False,
            positional="alibi",
            mlp_variant="gelu_exact",
        )
    elif model_type == "codegen":
        # CodeGen (Salesforce): the GPT-J recipe — shared-norm parallel
        # residual, interleaved partial rotary, biasless attention, biased
        # MLP and lm_head — with a tensor-parallel-sharded fused qkv
        # (mp_num=4 groups in q|v|k order, split in the key map)
        if hf.get("activation_function", "gelu_new") not in ("gelu_new", "gelu_pytorch_tanh"):
            raise NotImplementedError(
                f"codegen activation {hf['activation_function']!r} is not mapped"
            )
        if hf["n_head"] % 4:
            raise NotImplementedError(
                "codegen n_head must be divisible by the fixed mp_num=4 qkv grouping"
            )
        fields = dict(
            _gpt2_base_fields(hf),
            max_seq_len=hf.get("n_positions", 2048),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            use_bias=False,
            positional="rope",
            rope_interleaved=True,
            rope_dim=hf.get("rotary_dim"),
            parallel_residual=True,
            shared_norm=True,
            attn_bias=False,
            mlp_bias=True,
            lm_head_bias=True,
        )
    elif model_type == "bloom":
        # BLOOM: alibi positions (no positional params), LayerNorm directly
        # after the embedding, head-major fused qkv (NeoX layout), tanh-gelu
        # MLP, biases throughout, tied embeddings
        if hf.get("slow_but_exact", False):
            raise NotImplementedError("bloom slow_but_exact attention is not mapped")
        if hf.get("apply_residual_connection_post_layernorm", False):
            # the bloomz-style post-norm residual is a different block function
            raise NotImplementedError(
                "bloom apply_residual_connection_post_layernorm=true is not mapped"
            )
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=4 * hf["hidden_size"],
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            num_kv_heads=hf["n_head"],
            # alibi has no position table; this only sizes the default KV
            # cache (BloomConfig carries no sequence-length field)
            max_seq_len=2048,
            rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            norm_type="layernorm",
            use_bias=True,
            positional="alibi",
            embed_norm=True,
            mlp_variant="gelu",
        )
    elif model_type == "phi":
        # Phi-1/Phi-2: GPT-J-style block (parallel residual, ONE shared
        # LayerNorm) with llama-style member naming, biases everywhere
        # (incl. the untied lm_head), partial rotate-half rotary, gelu_new
        act = hf.get("hidden_act", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            raise NotImplementedError(f"phi hidden_act {act!r} is not mapped")
        if hf.get("qk_layernorm", False):
            raise NotImplementedError("phi qk_layernorm=true is not mapped")
        if hf.get("rope_scaling"):
            raise NotImplementedError("phi rope_scaling is not mapped")
        fields = _llama_base_fields(hf)
        head_dim = fields["hidden_size"] // fields["num_heads"]
        fields.update(
            norm_type="layernorm",
            rms_norm_eps=hf.get("layer_norm_eps", 1e-5),
            use_bias=True,
            lm_head_bias=True,
            mlp_variant="gelu",
            parallel_residual=True,
            shared_norm=True,
            rope_dim=int(hf.get("partial_rotary_factor", 0.5) * head_dim),
        )
    elif model_type == "phi3":
        # Llama recipe with FUSED projections (qkv_proj / gate_up_proj —
        # split in the key map) and an optional sliding window
        if hf.get("rope_scaling"):
            raise NotImplementedError(
                "phi3 rope_scaling (longrope) is not mapped; only the base "
                "rope models load"
            )
        fields = _llama_base_fields(hf)
        fields["sliding_window"] = hf.get("sliding_window")
    elif model_type == "stablelm":
        # Llama recipe with LayerNorm(+bias) norms, partial rotary, and
        # optional q/k/v biases
        if hf.get("use_parallel_residual", False):
            raise NotImplementedError(
                "stablelm use_parallel_residual=true is not mapped "
                "(sequential-residual checkpoints only)"
            )
        if hf.get("qk_layernorm", False):
            raise NotImplementedError("stablelm qk_layernorm=true is not mapped")
        if hf.get("rope_scaling"):
            raise NotImplementedError("stablelm rope_scaling is not mapped")
        fields = _llama_base_fields(hf)
        head_dim = fields["hidden_size"] // fields["num_heads"]
        fields.update(
            norm_type="layernorm",
            rms_norm_eps=hf.get("layer_norm_eps", 1e-5),
            rope_dim=int(hf.get("partial_rotary_factor", 0.25) * head_dim),
            qkv_bias=bool(hf.get("use_qkv_bias", False)),
        )
    elif model_type == "falcon":
        # Parallel-residual decoder, LayerNorm(+bias), non-gated erf-gelu
        # MLP, fused grouped qkv.  7B style: multi-query + ONE shared norm;
        # 40B/180B style (new_decoder_architecture): GQA + ln_attn/ln_mlp.
        if hf.get("alibi", False):
            raise NotImplementedError(
                "falcon alibi position encoding is not mapped (rope models only)"
            )
        if hf.get("bias", False):
            raise NotImplementedError("falcon bias=true projections are not mapped")
        if not hf.get("parallel_attn", True):
            raise NotImplementedError("falcon parallel_attn=false is not mapped")
        if hf.get("rope_scaling"):
            raise NotImplementedError("falcon rope_scaling is not mapped")
        act = hf.get("activation", "gelu")
        if act != "gelu":  # FalconMLP: ACT2FN[activation], "gelu" = erf form
            raise NotImplementedError(f"falcon activation {act!r} is not mapped")
        new_arch = hf.get("new_decoder_architecture", False)
        heads = hf["num_attention_heads"]
        if new_arch:
            kv = hf.get("num_kv_heads") or heads
        elif hf.get("multi_query", True):
            kv = 1
        else:
            raise NotImplementedError(
                "legacy falcon per-head-interleaved qkv (multi_query=false, "
                "new_decoder_architecture=false) is not mapped"
            )
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf.get("ffn_hidden_size") or 4 * hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=kv,
            max_seq_len=hf.get("max_position_embeddings", 2048),
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            norm_type="layernorm",
            mlp_variant="gelu_exact",
            parallel_residual=True,
            shared_norm=not new_arch,
        )
    elif model_type == "gpt_bigcode":
        # StarCoder family: GPT-2 recipe (learned positions, LayerNorm+bias,
        # tanh-gelu, tied embeddings) but torch Linear layouts and multi-query
        # attention with a fused c_attn
        act = hf.get("activation_function", "gelu_pytorch_tanh")
        if act not in ("gelu_pytorch_tanh", "gelu_new"):
            raise NotImplementedError(f"gpt_bigcode activation {act!r} is not mapped")
        if not hf.get("multi_query", True):
            # the MHA ablations store c_attn head-major interleaved
            # ([q,k,v] per head), a different layout than the MQ [q|k|v]
            # block split bigcode_key_map implements
            raise NotImplementedError(
                "gpt_bigcode multi_query=false (head-interleaved c_attn) is "
                "not mapped"
            )
        fields = dict(
            _gpt2_base_fields(hf),
            num_kv_heads=1,  # multi-query
        )
    else:
        raise NotImplementedError(
            f"model_type {model_type!r} has no key mapping; supported: "
            f"{SUPPORTED_MODEL_TYPES}. The conversion recipe in "
            "models/hf_compat.py is ~30 lines per architecture."
        )
    fields.update(overrides)
    return TransformerConfig(**fields)


def is_hf_checkpoint(checkpoint: str) -> bool:
    """True when ``checkpoint`` is a raw HF model dir of a supported family
    (config.json with a mapped model_type)."""
    path = os.path.join(checkpoint, "config.json")
    if not os.path.isfile(path):
        return False
    try:
        with open(path) as f:
            return json.load(f).get("model_type") in SUPPORTED_MODEL_TYPES
    except (json.JSONDecodeError, OSError):
        return False


# --------------------------------------------------------------- key mapping
# A mapping entry: port state-dict name -> (hf_key, transform).  The port's
# nn.Linear weights are [out, in] like HF's Linear, so those pass through;
# GPT-2's Conv1D stores [in, out] and is transposed.

Transform = Callable[[torch.Tensor], torch.Tensor]


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def _rows(lo: int, hi: int) -> Transform:
    """Rows ``[lo, hi)`` of a fused tensor (a weight's output rows or a
    bias's entries)."""

    def f(x: torch.Tensor) -> torch.Tensor:
        return x[lo:hi].contiguous()

    return f


def _lin(m: Dict[str, Tuple[str, Transform]], ours: str, theirs: str,
         bias: bool = True) -> None:
    """A Linear's weight (and bias) under the same transform-free layout."""
    m[f"{ours}.weight"] = (f"{theirs}.weight", _ident)
    if bias:
        m[f"{ours}.bias"] = (f"{theirs}.bias", _ident)


def _norm(m: Dict[str, Tuple[str, Transform]], ours: str, theirs: str,
          bias: bool = True) -> None:
    m[f"{ours}.scale"] = (f"{theirs}.weight", _ident)
    if bias:
        m[f"{ours}.bias"] = (f"{theirs}.bias", _ident)


def gpt2_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """GPT-2 naming (``transformer.h.{i}...``): ``Conv1D`` ``[in, out]``
    weights transposed, and the fused ``c_attn`` (``[h, 3h]``) split
    column-wise into q/k/v."""
    h = cfg.hidden_size

    def split(which: int, conv: bool) -> Transform:
        def f(x: torch.Tensor) -> torch.Tensor:
            part = x[..., which * h:(which + 1) * h]        # weight [h, h] or bias [h]
            return _t(part) if conv else part.contiguous()
        return f

    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("transformer.wte.weight", _ident),
        "pos_embed.weight": ("transformer.wpe.weight", _ident),
    }
    _norm(m, "final_norm", "transformer.ln_f")
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"transformer.h.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.ln_1")
        _norm(m, f"{n}.post_attn_norm", f"{t}.ln_2")
        for ours, theirs in (("attn.o_proj", "attn.c_proj"), ("mlp.up_proj", "mlp.c_fc"),
                             ("mlp.down_proj", "mlp.c_proj")):
            m[f"{n}.{ours}.weight"] = (f"{t}.{theirs}.weight", _t)
            m[f"{n}.{ours}.bias"] = (f"{t}.{theirs}.bias", _ident)
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            m[f"{n}.attn.{proj}.weight"] = (f"{t}.attn.c_attn.weight", split(j, True))
            m[f"{n}.attn.{proj}.bias"] = (f"{t}.attn.c_attn.bias", split(j, False))
    return m


def opt_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """OPT naming (``model.decoder.layers.{i}...``): separate q/k/v, biases on
    every projection and norm, the tied head skipped."""
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("model.decoder.embed_tokens.weight", _ident),
        "pos_embed.weight": ("model.decoder.embed_positions.weight", _ident),
    }
    _norm(m, "final_norm", "model.decoder.final_layer_norm")
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"model.decoder.layers.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.self_attn_layer_norm")
        _norm(m, f"{n}.post_attn_norm", f"{t}.final_layer_norm")
        for ours, theirs in (("attn.q_proj", "self_attn.q_proj"),
                             ("attn.k_proj", "self_attn.k_proj"),
                             ("attn.v_proj", "self_attn.v_proj"),
                             ("attn.o_proj", "self_attn.out_proj"),
                             ("mlp.up_proj", "fc1"), ("mlp.down_proj", "fc2")):
            _lin(m, f"{n}.{ours}", f"{t}.{theirs}")
    return m


def gptj_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """GPT-J naming (``transformer.h.{i}...``): separate biasless q/k/v,
    biased ``fc_in``/``fc_out``, the shared ``ln_1``, a biased untied head."""
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("transformer.wte.weight", _ident),
    }
    _norm(m, "final_norm", "transformer.ln_f")
    _lin(m, "lm_head", "lm_head")
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"transformer.h.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.ln_1")
        for proj in ("q_proj", "k_proj", "v_proj"):
            _lin(m, f"{n}.attn.{proj}", f"{t}.attn.{proj}", bias=False)
        _lin(m, f"{n}.attn.o_proj", f"{t}.attn.out_proj", bias=False)
        _lin(m, f"{n}.mlp.up_proj", f"{t}.mlp.fc_in")
        _lin(m, f"{n}.mlp.down_proj", f"{t}.mlp.fc_out")
    return m


def _neox_qkv_split(cfg: TransformerConfig, which: int) -> Transform:
    """NeoX (and BLOOM) fuse qkv head-major: row block ``h*3D..(h+1)*3D``
    holds head ``h``'s q, k, v stacked.  Unstack one of the three."""
    heads, d = cfg.num_heads, cfg.resolved_head_dim

    def f(x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:  # weight [3h, h_in]
            return x.reshape(heads, 3, d, x.shape[1])[:, which].reshape(
                heads * d, x.shape[1]).contiguous()
        return x.reshape(heads, 3, d)[:, which].reshape(heads * d).contiguous()

    return f


def gpt_neox_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """GPT-NeoX naming (``gpt_neox.layers.{i}...``): fused head-major qkv,
    biases throughout, two norms a layer, an untied biasless ``embed_out``."""
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("gpt_neox.embed_in.weight", _ident),
        "lm_head.weight": ("embed_out.weight", _ident),
    }
    _norm(m, "final_norm", "gpt_neox.final_layer_norm")
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"gpt_neox.layers.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.input_layernorm")
        _norm(m, f"{n}.post_attn_norm", f"{t}.post_attention_layernorm")
        _lin(m, f"{n}.attn.o_proj", f"{t}.attention.dense")
        _lin(m, f"{n}.mlp.up_proj", f"{t}.mlp.dense_h_to_4h")
        _lin(m, f"{n}.mlp.down_proj", f"{t}.mlp.dense_4h_to_h")
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            qkv = f"{t}.attention.query_key_value"
            m[f"{n}.attn.{proj}.weight"] = (f"{qkv}.weight", _neox_qkv_split(cfg, j))
            m[f"{n}.attn.{proj}.bias"] = (f"{qkv}.bias", _neox_qkv_split(cfg, j))
    return m


def llama_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """HF Llama naming (``model.layers.{i}.self_attn...``); also Mistral,
    Qwen2, Gemma and StableLM, whose deltas are config switches (LayerNorm
    biases for StableLM, the per-site projection biases)."""
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("model.embed_tokens.weight", _ident),
    }
    norm_bias = cfg.norm_type == "layernorm"  # StableLM: LayerNorm with bias
    _norm(m, "final_norm", "model.norm", norm_bias)
    if not cfg.tie_word_embeddings:
        _lin(m, "lm_head", "lm_head", bias=False)
    qkv, o, mlp = cfg.site_bias("qkv"), cfg.site_bias("o"), cfg.site_bias("mlp")
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"model.layers.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.input_layernorm", norm_bias)
        _norm(m, f"{n}.post_attn_norm", f"{t}.post_attention_layernorm", norm_bias)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _lin(m, f"{n}.attn.{proj}", f"{t}.self_attn.{proj}",
                 qkv if proj != "o_proj" else o)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            _lin(m, f"{n}.mlp.{proj}", f"{t}.mlp.{proj}", mlp)
    return m


def _stack_t(parts: List[torch.Tensor]) -> torch.Tensor:
    """Gather transform: per-expert ``Linear`` weights ``[out, in]`` -> the
    stacked experts' ``[E, in, out]``."""
    return torch.stack([p.t() for p in parts]).contiguous()


def mixtral_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[Any, Callable]]:
    """Mixtral naming: the Llama attention and norms, and each layer's
    ``block_sparse_moe``: the router ``gate`` (a ``Linear``, as the port's)
    and the experts' ``w1``/``w3``/``w2`` (gate/up/down) stacked onto the
    expert axis (``accelerate_tpu/models/hf_compat.py:997-1016``)."""
    m: Dict[str, Tuple[Any, Callable]] = {
        k: v for k, v in llama_key_map(cfg).items() if ".mlp." not in k}
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}.moe_mlp", f"model.layers.{i}.block_sparse_moe"
        m[f"{n}.router.weight"] = (f"{t}.gate.weight", _ident)
        for ours, theirs in (("gate_proj", "w1"), ("up_proj", "w3"), ("down_proj", "w2")):
            m[f"{n}.experts.{ours}.weight"] = (
                tuple(f"{t}.experts.{e}.{theirs}.weight" for e in range(cfg.num_experts)),
                _stack_t)
    return m


def phi3_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """Phi-3 naming: the Llama tree with fused ``qkv_proj`` (q|k|v rows) and
    ``gate_up_proj`` (gate|up rows)."""
    hd = cfg.resolved_head_dim
    q_rows, kv_rows = cfg.num_heads * hd, cfg.num_kv_heads * hd
    inter = cfg.intermediate_size
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("model.embed_tokens.weight", _ident),
    }
    _norm(m, "final_norm", "model.norm", bias=False)
    if not cfg.tie_word_embeddings:
        _lin(m, "lm_head", "lm_head", bias=False)
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"model.layers.{i}"
        qkv = f"{t}.self_attn.qkv_proj.weight"
        gu = f"{t}.mlp.gate_up_proj.weight"
        _norm(m, f"{n}.input_norm", f"{t}.input_layernorm", bias=False)
        _norm(m, f"{n}.post_attn_norm", f"{t}.post_attention_layernorm", bias=False)
        m.update({
            f"{n}.attn.q_proj.weight": (qkv, _rows(0, q_rows)),
            f"{n}.attn.k_proj.weight": (qkv, _rows(q_rows, q_rows + kv_rows)),
            f"{n}.attn.v_proj.weight": (qkv, _rows(q_rows + kv_rows, q_rows + 2 * kv_rows)),
            f"{n}.attn.o_proj.weight": (f"{t}.self_attn.o_proj.weight", _ident),
            f"{n}.mlp.gate_proj.weight": (gu, _rows(0, inter)),
            f"{n}.mlp.up_proj.weight": (gu, _rows(inter, 2 * inter)),
            f"{n}.mlp.down_proj.weight": (f"{t}.mlp.down_proj.weight", _ident),
        })
    return m


def _falcon_grouped_split(cfg: TransformerConfig, which: str) -> Transform:
    """``new_decoder_architecture`` fused qkv: rows grouped per KV head as
    ``[q_0..q_{g-1}, k, v] x num_kv_heads``."""
    hd = cfg.resolved_head_dim
    groups = cfg.num_kv_heads
    per_group = cfg.num_heads // groups

    def f(x: torch.Tensor) -> torch.Tensor:
        hidden = x.shape[-1]
        g = x.reshape(groups, per_group + 2, hd, hidden)
        if which == "q":
            part = g[:, :per_group].reshape(groups * per_group * hd, hidden)
        else:
            part = g[:, -2 if which == "k" else -1].reshape(groups * hd, hidden)
        return part.contiguous()

    return f


def falcon_key_map(cfg: TransformerConfig, new_arch: bool) -> Dict[str, Tuple[str, Transform]]:
    """Falcon naming (``transformer.h.{i}.self_attention...``).  7B style:
    multi-query rows ``[q|k|v]``, one shared norm.  40B style: grouped qkv,
    ``ln_attn`` + ``ln_mlp``."""
    hd = cfg.resolved_head_dim
    q_rows = cfg.num_heads * hd
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("transformer.word_embeddings.weight", _ident),
    }
    _norm(m, "final_norm", "transformer.ln_f")
    if not cfg.tie_word_embeddings:
        _lin(m, "lm_head", "lm_head", bias=False)
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"transformer.h.{i}"
        qkv = f"{t}.self_attention.query_key_value.weight"
        if new_arch:
            _norm(m, f"{n}.input_norm", f"{t}.ln_attn")
            _norm(m, f"{n}.post_attn_norm", f"{t}.ln_mlp")
            for proj in ("q", "k", "v"):
                m[f"{n}.attn.{proj}_proj.weight"] = (qkv, _falcon_grouped_split(cfg, proj))
        else:
            kv_rows = cfg.num_kv_heads * hd  # multi-query: one kv head
            _norm(m, f"{n}.input_norm", f"{t}.input_layernorm")
            m.update({
                f"{n}.attn.q_proj.weight": (qkv, _rows(0, q_rows)),
                f"{n}.attn.k_proj.weight": (qkv, _rows(q_rows, q_rows + kv_rows)),
                f"{n}.attn.v_proj.weight": (qkv, _rows(q_rows + kv_rows, q_rows + 2 * kv_rows)),
            })
        _lin(m, f"{n}.attn.o_proj", f"{t}.self_attention.dense", bias=False)
        _lin(m, f"{n}.mlp.up_proj", f"{t}.mlp.dense_h_to_4h", bias=False)
        _lin(m, f"{n}.mlp.down_proj", f"{t}.mlp.dense_4h_to_h", bias=False)
    return m


def bigcode_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """GPT-BigCode / StarCoder naming: GPT-2's tree with Linear layouts and a
    multi-query fused ``c_attn`` ``[q | k | v]``, biases throughout."""
    hd = cfg.resolved_head_dim
    q_rows, kv_rows = cfg.num_heads * hd, cfg.num_kv_heads * hd
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("transformer.wte.weight", _ident),
        "pos_embed.weight": ("transformer.wpe.weight", _ident),
    }
    _norm(m, "final_norm", "transformer.ln_f")
    if not cfg.tie_word_embeddings:
        _lin(m, "lm_head", "lm_head", bias=False)
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"transformer.h.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.ln_1")
        _norm(m, f"{n}.post_attn_norm", f"{t}.ln_2")
        for proj, lo, hi in (("q_proj", 0, q_rows),
                             ("k_proj", q_rows, q_rows + kv_rows),
                             ("v_proj", q_rows + kv_rows, q_rows + 2 * kv_rows)):
            m[f"{n}.attn.{proj}.weight"] = (f"{t}.attn.c_attn.weight", _rows(lo, hi))
            m[f"{n}.attn.{proj}.bias"] = (f"{t}.attn.c_attn.bias", _rows(lo, hi))
        _lin(m, f"{n}.attn.o_proj", f"{t}.attn.c_proj")
        _lin(m, f"{n}.mlp.up_proj", f"{t}.mlp.c_fc")
        _lin(m, f"{n}.mlp.down_proj", f"{t}.mlp.c_proj")
    return m


def _codegen_qkv_split(cfg: TransformerConfig, which: int) -> Transform:
    """CodeGen's fused qkv: ``mp_num=4`` row groups, each stacking its share
    of q, then V, then K.  ``which``: 0 = q, 1 = v, 2 = k."""
    hidden = cfg.hidden_size
    local = hidden // 4

    def f(x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(4, 3, local, x.shape[-1])  # [mp, (q, v, k), local, in]
        return g[:, which].reshape(hidden, x.shape[-1]).contiguous()

    return f


def codegen_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """CodeGen naming: GPT-J's tree except the fused ``qkv_proj``."""
    m = gptj_key_map(cfg)
    for i in range(cfg.num_layers):
        n, qkv = f"layers.{i}", f"transformer.h.{i}.attn.qkv_proj.weight"
        m[f"{n}.attn.q_proj.weight"] = (qkv, _codegen_qkv_split(cfg, 0))
        m[f"{n}.attn.v_proj.weight"] = (qkv, _codegen_qkv_split(cfg, 1))
        m[f"{n}.attn.k_proj.weight"] = (qkv, _codegen_qkv_split(cfg, 2))
    return m


def mpt_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """MPT naming (``transformer.blocks.{i}...``): scale-only norms, fused
    plain-order ``Wqkv`` (q|k|v rows), biasless projections, tied head."""
    e = cfg.num_heads * cfg.resolved_head_dim
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("transformer.wte.weight", _ident),
    }
    _norm(m, "final_norm", "transformer.norm_f", bias=False)
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"transformer.blocks.{i}"
        qkv = f"{t}.attn.Wqkv.weight"
        _norm(m, f"{n}.input_norm", f"{t}.norm_1", bias=False)
        _norm(m, f"{n}.post_attn_norm", f"{t}.norm_2", bias=False)
        m.update({
            f"{n}.attn.q_proj.weight": (qkv, _rows(0, e)),
            f"{n}.attn.k_proj.weight": (qkv, _rows(e, 2 * e)),
            f"{n}.attn.v_proj.weight": (qkv, _rows(2 * e, 3 * e)),
        })
        _lin(m, f"{n}.attn.o_proj", f"{t}.attn.out_proj", bias=False)
        _lin(m, f"{n}.mlp.up_proj", f"{t}.ffn.up_proj", bias=False)
        _lin(m, f"{n}.mlp.down_proj", f"{t}.ffn.down_proj", bias=False)
    return m


def bloom_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """BLOOM naming (``transformer.h.{i}.self_attention...``): head-major
    fused qkv (NeoX's layout), the embedding LayerNorm, biases throughout,
    tied head."""
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("transformer.word_embeddings.weight", _ident),
    }
    _norm(m, "embed_norm", "transformer.word_embeddings_layernorm")
    _norm(m, "final_norm", "transformer.ln_f")
    if not cfg.tie_word_embeddings:
        _lin(m, "lm_head", "lm_head", bias=False)
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"transformer.h.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.input_layernorm")
        _norm(m, f"{n}.post_attn_norm", f"{t}.post_attention_layernorm")
        qkv = f"{t}.self_attention.query_key_value"
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            m[f"{n}.attn.{proj}.weight"] = (f"{qkv}.weight", _neox_qkv_split(cfg, j))
            m[f"{n}.attn.{proj}.bias"] = (f"{qkv}.bias", _neox_qkv_split(cfg, j))
        _lin(m, f"{n}.attn.o_proj", f"{t}.self_attention.dense")
        _lin(m, f"{n}.mlp.up_proj", f"{t}.mlp.dense_h_to_4h")
        _lin(m, f"{n}.mlp.down_proj", f"{t}.mlp.dense_4h_to_h")
    return m


def phi_key_map(cfg: TransformerConfig) -> Dict[str, Tuple[str, Transform]]:
    """Phi-1/Phi-2 naming: llama-style ``model.layers.{i}.self_attn`` with
    ``dense``/``fc1``/``fc2`` members, one shared ``input_layernorm`` a
    block, biases throughout (the untied head included)."""
    m: Dict[str, Tuple[str, Transform]] = {
        "embed_tokens.weight": ("model.embed_tokens.weight", _ident),
    }
    _norm(m, "final_norm", "model.final_layernorm")
    _lin(m, "lm_head", "lm_head")
    for i in range(cfg.num_layers):
        n, t = f"layers.{i}", f"model.layers.{i}"
        _norm(m, f"{n}.input_norm", f"{t}.input_layernorm")
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                             ("v_proj", "v_proj"), ("o_proj", "dense")):
            _lin(m, f"{n}.attn.{ours}", f"{t}.self_attn.{theirs}")
        _lin(m, f"{n}.mlp.up_proj", f"{t}.mlp.fc1")
        _lin(m, f"{n}.mlp.down_proj", f"{t}.mlp.fc2")
    return m


def native_key_map(checkpoint: str, cfg: Optional[TransformerConfig] = None
                   ) -> Tuple[TransformerConfig, Dict[str, Tuple[str, Transform]]]:
    """``(config, {port name: (hf_key, transform)})`` for a HF model dir.
    ``cfg`` overrides the config read from ``config.json`` (a truncated
    depth maps only the first layers)."""
    hf = _read_hf_config(checkpoint)
    cfg = cfg if cfg is not None else config_from_hf(checkpoint)
    model_type = hf["model_type"]
    maps = {"gpt2": gpt2_key_map, "opt": opt_key_map, "gptj": gptj_key_map,
            "gpt_neox": gpt_neox_key_map, "phi3": phi3_key_map,
            "gpt_bigcode": bigcode_key_map, "phi": phi_key_map, "bloom": bloom_key_map,
            "codegen": codegen_key_map, "mpt": mpt_key_map, "mixtral": mixtral_key_map}
    if model_type == "falcon":
        mapping = falcon_key_map(cfg, hf.get("new_decoder_architecture", False))
    else:  # llama recipe: llama / mistral / qwen2 / gemma / stablelm
        mapping = maps.get(model_type, llama_key_map)(cfg)
    return cfg, mapping


# ------------------------------------------------------------------ reading
def _checkpoint_files(checkpoint: str) -> List[str]:
    """The weight files of a single-file or sharded (``*.index.json``)
    checkpoint, safetensors first, then torch-bin."""
    for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        index_path = os.path.join(checkpoint, index_name)
        if os.path.isfile(index_path):
            with open(index_path) as f:
                weight_map = json.load(f)["weight_map"]
            return [os.path.join(checkpoint, name) for name in dict.fromkeys(weight_map.values())]
    for single_name in ("model.safetensors", "pytorch_model.bin"):
        single = os.path.join(checkpoint, single_name)
        if os.path.isfile(single):
            return [single]
    raise FileNotFoundError(f"No checkpoint found at {checkpoint} (looked for "
                            "model.safetensors[.index.json] and pytorch_model.bin[.index.json])")


def _iter_hf_tensors(checkpoint: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(hf_key, host tensor)`` over every shard, one shard resident at a
    time: safetensors through the port's reader, torch-bin through
    ``torch.load(weights_only=True)`` (memory-mapped)."""
    for fname in _checkpoint_files(checkpoint):
        if fname.endswith(".bin"):
            tensors = torch.load(fname, map_location="cpu", mmap=True, weights_only=True)
        else:
            tensors = load_file(fname)
        yield from tensors.items()
        del tensors


def _mapped(checkpoint: str, mapping: Dict[str, Tuple[Any, Callable]]
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(port name, host tensor)`` as the checkpoint streams: an entry of
    one HF key as soon as that tensor is read, an entry of a tuple of keys
    (a gather) once all of them are, its parts held until then."""
    by_hf: Dict[str, list] = {}
    for native, (hf_key, transform) in mapping.items():
        for part in (hf_key if isinstance(hf_key, tuple) else (hf_key,)):
            by_hf.setdefault(part, []).append(native)
    pending: Dict[str, Dict[str, torch.Tensor]] = {}
    for hf_key, tensor in _iter_hf_tensors(checkpoint):
        for native in by_hf.get(hf_key, ()):
            keys, transform = mapping[native]
            if not isinstance(keys, tuple):
                yield native, transform(tensor)
                continue
            parts = pending.setdefault(native, {})
            parts[hf_key] = tensor
            if len(parts) == len(keys):
                yield native, transform([parts[k] for k in keys])
                del pending[native]


def stream_mapped_tensors(checkpoint: str, mapping: Dict[str, Tuple[Any, Callable]],
                          dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Stream a checkpoint through a ``{port name: (hf_key, transform)}`` map
    -> ``{port name: host tensor}`` (cast to ``dtype`` when given).  Several
    port names may cite the same HF tensor (fused-qkv splits), each through
    its own transform; a tuple of HF keys gathers them (Mixtral's experts);
    unmapped HF keys (tied duplicates, buffers) are skipped; a mapped tensor
    the checkpoint lacks raises ``ValueError``."""
    flat: Dict[str, torch.Tensor] = {}
    for native, t in _mapped(checkpoint, mapping):
        flat[native] = t.to(dtype) if dtype is not None else t
    missing = set(mapping) - set(flat)
    if missing:
        raise ValueError(f"{checkpoint} is missing tensors for {sorted(missing)[:5]}")
    return flat


# ---------------------------------------------------------------- converter
def convert_hf_checkpoint(checkpoint: str, out_dir: Optional[str] = None,
                          dtype: Optional[torch.dtype] = None,
                          max_shard_bytes: int = 4 << 30, force: bool = False) -> str:
    """Convert a HF model dir into a sharded safetensors checkpoint in the
    port's naming (``<dir>/_atpu_torch_native`` by default); returns the
    output dir.  A second call is a no-op unless ``force`` or the source
    config or ``dtype`` changed (the stamp records both).  One pass, each
    output shard written when it fills; ``dtype`` casts en route."""
    out_dir = out_dir or os.path.join(checkpoint, "_atpu_torch_native")
    stamp_path = os.path.join(out_dir, _STAMP)
    stamp = {"source_config": _read_hf_config(checkpoint),
             "dtype": str(dtype) if dtype is not None else None, "format_version": 1}
    if not force and os.path.isfile(stamp_path):
        with open(stamp_path) as f:
            if json.load(f) == stamp:
                return out_dir
    _, mapping = native_key_map(checkpoint)
    os.makedirs(out_dir, exist_ok=True)
    # a fresh conversion leaves no stale shard or index behind
    for old in glob.glob(os.path.join(out_dir, "model*.safetensors*")):
        os.remove(old)
    shard_keys: List[List[str]] = []
    current: Dict[str, torch.Tensor] = {}
    current_bytes = 0

    def flush():
        nonlocal current, current_bytes
        if current:
            save_file(current, os.path.join(out_dir, f"shard-{len(shard_keys):05d}.part"))
            shard_keys.append(list(current))
            current, current_bytes = {}, 0

    for native, t in _mapped(checkpoint, mapping):
        t = t.to(dtype) if dtype is not None else t
        nbytes = t.numel() * t.element_size()
        if current_bytes + nbytes > max_shard_bytes:
            flush()
        current[native] = t
        current_bytes += nbytes
    flush()
    written = {k for keys in shard_keys for k in keys}
    missing = sorted(set(mapping) - written)
    if missing:
        for i in range(len(shard_keys)):
            os.remove(os.path.join(out_dir, f"shard-{i:05d}.part"))
        raise ValueError(f"HF checkpoint at {checkpoint} is missing tensors for "
                         f"{len(missing)} mapped keys (first few: {missing[:5]})")
    if len(shard_keys) == 1:
        os.replace(os.path.join(out_dir, "shard-00000.part"),
                   os.path.join(out_dir, "model.safetensors"))
    else:
        index = {"metadata": {}, "weight_map": {}}
        for i, keys in enumerate(shard_keys):
            fname = f"model-{i + 1:05d}-of-{len(shard_keys):05d}.safetensors"
            os.replace(os.path.join(out_dir, f"shard-{i:05d}.part"),
                       os.path.join(out_dir, fname))
            index["weight_map"].update({k: fname for k in keys})
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f)
    with open(stamp_path, "w") as f:
        json.dump(stamp, f)
    return out_dir


def _placement(device, device_map) -> Optional[torch.device]:
    """The one device a load places on: ``device``, or the single device a
    ``device_map`` names.  ``None`` for a placement policy (``"auto"``,
    ``"balanced"``, ...) or a map spanning the card, ``"cpu"`` and
    ``"disk"``: that load is big-model dispatch,
    :func:`~accelerate_tpu_torch.big_modeling.load_checkpoint_and_dispatch`
    (ROADMAP item 10a)."""
    if device_map is None:
        return resolve_device(device)
    if isinstance(device_map, dict):
        targets = {str(v) for v in device_map.values()}
        if len(targets) == 1 and targets != {"disk"}:
            return resolve_device(targets.pop())
    return None


def place(host: Dict[str, torch.Tensor], device, dtype: Optional[torch.dtype] = None
          ) -> Dict[str, torch.Tensor]:
    """Host tensors -> the model's placement on ``device``: norm parameters
    and routers f32 (the model keeps them so), quantized codes and scales
    as they are, the rest in ``dtype`` (default: as stored)."""
    sd = {}
    for name, t in host.items():
        if is_f32_param(name):
            t = t.to(torch.float32)
        elif dtype is not None and not name.endswith((".qweight", ".scales")):
            t = t.to(dtype)
        sd[name] = t.to(device)
    return sd


def load_hf_checkpoint(checkpoint: str, device: Optional[Union[str, torch.device]] = None,
                       dtype: Optional[torch.dtype] = None,
                       config_overrides: Optional[Dict[str, Any]] = None,
                       device_map=None, **dispatch_kwargs):
    """HF model dir (or a directory :func:`convert_hf_checkpoint` wrote) ->
    ``(model, state_dict)`` on one device (the card unless ``device="cpu"``;
    a ``device_map`` naming one device is accepted).  ``dtype`` casts the
    matrices, embeddings and projection biases (default: as stored); norm
    parameters and routers are f32 whatever the checkpoint holds, as the
    model keeps them.  With ``config_overrides={"quantization": 8}`` (or 4)
    the mapped weights are quantized on the host
    (:func:`~accelerate_tpu_torch.ops.quantization.quantize_model_params`).

    A ``device_map`` over the card, ``"cpu"`` and ``"disk"`` (or
    ``"auto"``, ``"balanced"``, ``"balanced_low_0"``, ``"sharded"``) goes
    through :func:`~accelerate_tpu_torch.big_modeling.
    load_checkpoint_and_dispatch` (``dispatch_kwargs``: ``max_memory``,
    ``offload_folder``) and returns the reference's ``(model, state dict,
    device_map, loader)``, ``model`` a weightless shell on ``meta``: pass
    the rest to :class:`~accelerate_tpu_torch.big_modeling.
    StreamingTransformer` (``accelerate_tpu/models/hf_compat.py:1266``)."""
    placement = _placement(device, device_map)
    if placement is None:
        return _dispatch_hf_checkpoint(checkpoint, device, dtype, config_overrides, device_map,
                                       **dispatch_kwargs)
    device = placement
    cfg = config_from_hf(checkpoint, **(config_overrides or {}))
    if os.path.isfile(os.path.join(checkpoint, "config.json")):
        _, mapping = native_key_map(checkpoint, cfg)
        host = stream_mapped_tensors(checkpoint, mapping)
    else:
        host = {}
        for fname in _checkpoint_files(checkpoint):
            host.update(load_file(fname))
    if cfg.quantization is not None and not any(k.endswith(".qweight") for k in host):
        host = quantize_model_params(host, QuantizationConfig(
            bits=cfg.quantization, block_size=cfg.quantization_block_size))
    sd = place(host, device, dtype)
    model = Transformer(cfg, device="meta")
    model.load_state_dict(sd, assign=True)
    return model, sd


def _dispatch_hf_checkpoint(checkpoint, device, dtype, config_overrides, device_map,
                            **dispatch_kwargs):
    from ..big_modeling import load_checkpoint_and_dispatch

    cfg = config_from_hf(checkpoint, **(config_overrides or {}))
    native = (convert_hf_checkpoint(checkpoint, dtype=dtype) if is_hf_checkpoint(checkpoint)
              else checkpoint)
    quantization = None if cfg.quantization is None else QuantizationConfig(
        bits=cfg.quantization, block_size=cfg.quantization_block_size)
    model = Transformer(cfg, device="meta")
    params, device_map, loader = load_checkpoint_and_dispatch(
        model, native, device_map=device_map, dtype=dtype, quantization=quantization,
        device=device, **dispatch_kwargs)
    return model, params, device_map, loader

"""Port parity: big-model inference (``big_modeling.py``, ``utils/modeling.py``,
``utils/offload.py``, ``utils/memory.py``).

The JAX package's functions and the port's get the same inputs, made from
numpy seeds at ``TransformerConfig.tiny`` widths in f32:

* device maps and budgets equal the JAX package's once its ``layers_{i}``
  modules are named ``layers.{i}``;
* ``.dat`` folders written by either package are read back bit for bit by
  the other (bf16 included), and the loader serves in-memory tensors,
  ``.dat`` files and tensors still inside safetensors files;
* the streaming executor runs a non-transformer stack, its hooks, its packed
  snapshots (``invalidate_cache``, rebinds, a tied module packed once) and
  its cached decode path as the reference's do;
* the port's streamed forward is bitwise its resident forward on the CPU,
  from pinned-host (here: host) weights, ``.dat`` files, a checkpoint's
  memory maps and a quantized tree, and within ``ATOL`` of the JAX
  package's ``StreamingTransformer``;
* a ``scan_layers=True`` JAX tree carries across ``params_from_jax``.

On the CPU the streaming executor takes its transfer path for every stage
(the host is the device), so these tests run the buffer layout and views
that the card runs; the card's copy stream and events are held by
``tests/test_torch_cuda.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.ops.quantization import Int8Config as JInt8Config
from accelerate_tpu.ops.quantization import quantize_model_params as jquantize
from accelerate_tpu.utils import modeling as jmodeling
from accelerate_tpu.utils import offload as joffload
from accelerate_tpu_torch import big_modeling as bm
from accelerate_tpu_torch.checkpointing import save_file
from accelerate_tpu_torch.models import hf_compat
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.ops.quantization import Int8Config
from accelerate_tpu_torch.utils import memory, modeling, offload
from accelerate_tpu_torch.weights import init_params, params_from_jax

#: f32 logits of the port against the JAX package: two frameworks summing
#: the same f32 products in other orders (measured: a few 1e-7)
ATOL = 1e-5

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    return TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **kw)


def _jcfg(**kw):
    return JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **kw)


def _placed(placed_and_loader):
    """``dispatch_params``' two results as ``StreamingTransformer`` keywords."""
    placed, loader = placed_and_loader
    return dict(params=placed, weights_loader=loader)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape).astype(np.int32)


def _jparams(jcfg, seed=0):
    jmodel = JTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


def _resident(cfg, sd):
    model = Transformer(cfg, device=CPU, dtype=torch.float32)
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def pair():
    """The JAX model and its params, the port's state dict of the same
    weights and the resident port model."""
    jmodel, jparams = _jparams(_jcfg())
    sd = params_from_jax(jparams, device=CPU)
    return jmodel, jparams, sd, _resident(_cfg(), sd)


def _renamed(device_map):
    return {k.replace("layers_", "layers."): v for k, v in device_map.items()}


# ------------------------------------------------------------ size math
def test_tree_utils_and_natural_order():
    tree = {"a": {"b": np.zeros(3), "c": {"d": np.ones(2)}}, "e": np.zeros(1)}
    flat = modeling.flatten_tree(tree)
    assert flat.keys() == jmodeling.flatten_tree(tree).keys() == {"a.b", "a.c.d", "e"}
    np.testing.assert_array_equal(modeling.unflatten_tree(flat)["a"]["c"]["d"], np.ones(2))
    sd = {f"layers.{i}.w": torch.zeros(1) for i in (0, 1, 2, 10, 11)}
    sd["embed_tokens.weight"] = torch.zeros(1)
    mods = modeling.top_level_modules(sd)
    assert mods.index("layers.2") < mods.index("layers.10")
    assert set(mods) == {"embed_tokens", "layers.0", "layers.1", "layers.2", "layers.10",
                         "layers.11"}


def test_module_sizes_match_jax(pair):
    _, jparams, sd, _ = pair
    jsizes = jmodeling.compute_module_sizes(jparams)
    sizes = modeling.compute_module_sizes(sd)
    assert sizes[""] == jsizes[""]
    for mod in modeling.top_level_modules(sd):
        assert sizes[mod] == jsizes[mod.replace("layers.", "layers_")], mod
    assert modeling.compute_module_sizes(sd, dtype=torch.bfloat16)[""] == \
        jmodeling.compute_module_sizes(jparams, dtype=jnp.bfloat16)[""]
    size, names = modeling.get_max_layer_size(sd)
    jsize, jnames = jmodeling.get_max_layer_size(jparams)
    assert size == jsize and names == [n.replace("layers_", "layers.") for n in jnames]
    # shapes alone (meta tensors, shape tuples) size the same
    meta = bm.init_empty_weights(_cfg(), dtype=torch.float32)
    assert all(t.device.type == "meta" for t in meta.values())
    assert modeling.compute_module_sizes(meta)[""] == sizes[""]
    assert modeling.compute_module_sizes({"m": {"w": (8, 8)}})[""] == 256


@pytest.mark.parametrize("budget", [
    {0: 10**9},
    {0: 40_000, "cpu": 10**9},
    {0: 40_000, 1: 60_000, "cpu": 80_000, "disk": 10**9},
    {0: 0, "cpu": 50_000, "disk": 10**9},
], ids=["one_card", "cpu_spill", "two_cards_disk", "no_card"])
def test_infer_auto_device_map_matches_jax(pair, budget):
    _, jparams, sd, _ = pair
    want = _renamed(jmodeling.infer_auto_device_map(jparams, max_memory=budget, num_devices=2))
    got = modeling.infer_auto_device_map(sd, max_memory=budget, num_devices=2)
    assert got == want and list(got) == modeling.top_level_modules(sd)


@pytest.mark.parametrize("n,low_zero", [(1, False), (3, False), (3, True)])
def test_balanced_memory_matches_jax(pair, n, low_zero):
    _, jparams, sd, _ = pair
    want = jmodeling.get_balanced_memory(jparams, num_devices=n, low_zero=low_zero)
    got = modeling.get_balanced_memory(sd, num_devices=n, low_zero=low_zero)
    assert got == want
    assert _renamed(jmodeling.infer_auto_device_map(jparams, want, num_devices=n)) == \
        modeling.infer_auto_device_map(sd, got, num_devices=n)


def test_no_room_raises(pair):
    _, _, sd, _ = pair
    with pytest.raises(ValueError, match="does not fit"):
        modeling.infer_auto_device_map(sd, max_memory={0: 100})
    assert modeling.get_max_memory() is None  # no card here


# ------------------------------------------------------------ offload
def _dtypes_dict(seed):
    rng = np.random.default_rng(seed)
    return {"a.w": rng.standard_normal((3, 5)).astype(np.float32),
            "a.i": rng.integers(-9, 9, (4,)).astype(np.int32),
            "b.q": rng.integers(-127, 127, (2, 3)).astype(np.int8),
            "b.h": rng.standard_normal((6,)).astype(np.float16),
            "c.bf": np.asarray(jnp.asarray(rng.standard_normal((2, 4)), jnp.bfloat16)),
            "c.scalar": np.float32(2.5)}


def _raw(x):
    """The bytes of a torch tensor or numpy (ml_dtypes) array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy().tobytes() if x.dim() else \
            x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def test_dat_folders_interchange_bitwise(tmp_path):
    arrays = _dtypes_dict(0)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    joffload.offload_state_dict(str(jdir), arrays)
    offload.offload_state_dict(str(pdir), {k: torch.from_numpy(np.array(v).view(np.int16))
                                           .view(torch.bfloat16) if k == "c.bf" else
                                           torch.from_numpy(np.array(v))
                                           for k, v in arrays.items()})
    # the same files, byte for byte, and the same index
    for name in arrays:
        assert (jdir / f"{name}.dat").read_bytes() == (pdir / f"{name}.dat").read_bytes(), name
    assert json.loads((jdir / "index.json").read_text()) == \
        json.loads((pdir / "index.json").read_text())
    # each package reads the other's folder back bit for bit
    for folder in (jdir, pdir):
        ploader = offload.OffloadedWeightsLoader(save_folder=str(folder))
        jloader = joffload.OffloadedWeightsLoader(save_folder=str(folder))
        for name, want in arrays.items():
            got = ploader[name]
            assert tuple(got.shape) == np.shape(want)
            assert _raw(got) == _raw(jloader[name]) == np.asarray(want).tobytes(), name
            assert ploader.is_mapped(name)
    assert ploader["c.bf"].dtype == torch.bfloat16


def test_loader_over_dict_dat_and_safetensors(tmp_path):
    rng = np.random.default_rng(1)
    mem = {"m.a": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))}
    disk = {"m.b": torch.from_numpy(rng.standard_normal((3,)).astype(np.float32))}
    st = {"n.c": torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).bfloat16(),
          "n.d": torch.arange(6, dtype=torch.int64)}
    offload.offload_state_dict(str(tmp_path / "dat"), disk)
    save_file(st, str(tmp_path / "w.safetensors"))
    loader = offload.OffloadedWeightsLoader(
        state_dict=mem, save_folder=str(tmp_path / "dat"),
        safetensors_files={k: str(tmp_path / "w.safetensors") for k in st})
    assert list(loader) == ["m.a", "m.b", "n.c", "n.d"] and len(loader) == 4
    for k, want in {**mem, **disk, **st}.items():
        assert torch.equal(loader[k], want), k
    assert [loader.is_mapped(k) for k in loader] == [False, True, True, True]
    assert loader["m.a"] is mem["m.a"]
    view = offload.PrefixedDataset(loader, "n.")
    assert set(view) == {"c", "d"} and torch.equal(view["d"], st["n.d"])
    with pytest.raises(ValueError, match="at least one"):
        offload.OffloadedWeightsLoader()


# ------------------------------------------------------------ memory
@pytest.mark.parametrize("exc,oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"), True),
    (MemoryError(), True),
    (ValueError("bad shape"), False),
    (FileNotFoundError("BLOOM-560m checkpoint not found: out of memory?"), False),
])
def test_should_reduce_batch_size(exc, oom):
    assert memory.should_reduce_batch_size(exc) is oom


def test_find_executable_batch_size():
    tried = []

    @memory.find_executable_batch_size(starting_batch_size=128)
    def run(batch_size, extra=0):
        tried.append(batch_size)
        if batch_size > 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return batch_size + extra

    assert run(extra=1) == 17 and tried == [128, 64, 32, 16]
    assert run() == 16  # starts again from 128

    @memory.find_executable_batch_size(starting_batch_size=4)
    def never(batch_size):
        raise MemoryError()

    with pytest.raises(RuntimeError, match="reached zero"):
        never()

    @memory.find_executable_batch_size(starting_batch_size=8)
    def other(batch_size):
        raise FileNotFoundError("BLOOM-560m")

    with pytest.raises(FileNotFoundError):
        other()
    with pytest.raises(TypeError):
        memory.find_executable_batch_size(lambda: None)
    a, b = memory.release_memory(torch.zeros(3), torch.ones(2))
    assert a is None and b is None


# ------------------------------------------------------------ init
def test_init_params_device_map_is_the_plain_draw():
    cfg = _cfg(num_layers=3)
    want = init_params(cfg, seed=3, device=CPU, dtype=torch.float32)
    mods = modeling.top_level_modules(want)
    device_map = {m: ("cpu" if i % 2 else 0) for i, m in enumerate(mods)}
    got = init_params(cfg, seed=3, device=CPU, dtype=torch.float32, device_map=device_map)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    host = [k for k in got if device_map[modeling.module_of(k)] == "cpu"]
    # the cpu modules are views of one host block, each at a 256-byte offset
    assert len({got[k].untyped_storage().data_ptr() for k in host}) == 1
    ptr0 = got[host[0]].untyped_storage().data_ptr()
    assert all((got[k].data_ptr() - ptr0) % 256 == 0 for k in host)
    on_host = bm.init_params_on_host(cfg, seed=3, dtype=torch.float32, device=CPU)
    assert all(torch.equal(on_host[k], want[k]) for k in want)
    meta = bm.init_empty_weights(cfg, dtype=torch.float32)
    assert {k: (tuple(t.shape), t.dtype) for k, t in meta.items()} == \
        {k: (tuple(t.shape), t.dtype) for k, t in want.items()}
    with pytest.raises(ValueError, match="does not cover"):
        init_params(cfg, device=CPU, device_map={"embed_tokens": 0})
    with pytest.raises(ValueError, match="disk_offload"):
        init_params(cfg, device=CPU, device_map={m: "disk" for m in mods})


# ------------------------------------------------------------ dispatch
def test_dispatch_and_offload(pair, tmp_path):
    _, _, sd, _ = pair
    dm = {m: ("cpu" if m.startswith("layers") else 0) for m in modeling.top_level_modules(sd)}
    placed, loader = bm.dispatch_params(sd, dm, device=CPU)
    assert list(placed) == list(sd) and all(torch.equal(placed[k], sd[k]) for k in sd)
    assert set(loader) == {k for k in sd if k.startswith("layers.")}
    assert placed["layers.0.attn.q_proj.weight"] is not sd["layers.0.attn.q_proj.weight"]
    placed, loader = bm.disk_offload(sd, str(tmp_path), device=CPU)
    assert placed == {} and set(loader) == set(sd)
    assert all(loader.is_mapped(k) and torch.equal(loader[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="does not cover"):
        bm.dispatch_params(sd, {"embed_tokens": 0}, device=CPU)
    with pytest.raises(ValueError, match="offload_folder"):
        bm.dispatch_params(sd, {m: "disk" for m in dm}, device=CPU)
    with pytest.raises(NotImplementedError, match="9e"):
        bm.dispatch_params(sd, {**dm, "embed_tokens": 1}, device=CPU)
    assert all(torch.equal(v, sd[k])
               for k, v in bm.shard_params_for_inference(sd, device=CPU).items())
    with pytest.raises(NotImplementedError, match="9e"):
        bm.shard_params_for_inference(sd, mesh=np.zeros((2, 2)), device=CPU)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, pair):
    """The pair's weights saved as a two-shard safetensors checkpoint."""
    _, _, sd, _ = pair
    path = str(tmp_path_factory.mktemp("ckpt"))
    names = list(sd)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    for fname, keys in shards.items():
        save_file({k: sd[k] for k in keys}, os.path.join(path, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: fname for fname, keys in shards.items()
                                                  for k in keys}}, f)
    return path


def test_checkpoint_shapes_and_dispatch(pair, ckpt):
    _, _, sd, model = pair
    assert os.path.isfile(os.path.join(ckpt, "model.safetensors.index.json"))
    shapes = bm.checkpoint_shapes(ckpt)
    assert {k: tuple(t.shape) for k, t in shapes.items()} == \
        {k: tuple(t.shape) for k, t in sd.items()}
    assert all(t.device.type == "meta" for t in shapes.values())
    placed, dm, loader = bm.load_checkpoint_and_dispatch(None, ckpt, device=CPU)
    assert set(dm.values()) == {0} and loader is None
    assert all(torch.equal(placed[k], sd[k]) for k in sd)
    placed, dm, loader = bm.load_checkpoint_and_dispatch(None, ckpt, device_map="sharded",
                                                         device=CPU)
    assert dm == "sharded" and loader is None and all(torch.equal(placed[k], sd[k]) for k in sd)
    with pytest.raises(NotImplementedError, match="9e"):
        bm.load_checkpoint_and_dispatch(None, ckpt, device_map="sharded", mesh=np.zeros(4),
                                        device=CPU)
    with pytest.raises(ValueError, match="not modules"):
        bm.load_checkpoint_and_dispatch(None, ckpt, device_map={"bogus": 0}, device=CPU)
    with pytest.raises(ValueError, match="does not cover"):
        bm.load_checkpoint_and_dispatch(None, ckpt, device_map={"embed_tokens": "cpu"},
                                        device=CPU)
    with pytest.raises(ValueError, match="Unknown device_map"):
        bm.load_checkpoint_and_dispatch(None, ckpt, device_map="everywhere", device=CPU)


def test_checkpoint_spills_to_cpu_and_disk(pair, ckpt):
    """An ``"auto"`` map under tight budgets spills layers to the host and the
    disk in order; disk modules stay in the checkpoint (memory maps), and
    the streamed forward is bitwise the resident one."""
    _, _, sd, model = pair
    sizes = modeling.compute_module_sizes(sd)
    # natural order, as the reference's: final_norm sorts before the layers
    budget = {0: sizes["embed_tokens"], "cpu": sizes["final_norm"] + sizes["layers.0"],
              "disk": 10**9}
    placed, dm, loader = bm.load_checkpoint_and_dispatch(None, ckpt, max_memory=budget,
                                                         device=CPU)
    assert dm == {"embed_tokens": 0, "final_norm": "cpu", "layers.0": "cpu",
                  "layers.1": "disk", "lm_head": "disk"}
    assert not any(k.startswith("layers.1") for k in placed)
    assert loader.is_mapped("layers.1.mlp.up_proj.weight")
    assert torch.equal(loader["layers.1.mlp.up_proj.weight"], sd["layers.1.mlp.up_proj.weight"])
    ids = torch.from_numpy(_ids(3, (2, 9)))
    st = bm.StreamingTransformer(model.config, placed, dm, loader, exec_device=CPU)
    with torch.no_grad():
        assert torch.equal(st(ids), model(ids))


def test_quantized_dispatch(pair, ckpt):
    """``quantization=`` quantizes as it reads (cpu modules on the host);
    the budgets see the quantized sizes; disk modules refuse it."""
    from accelerate_tpu_torch.ops.quantization import quantize_model_params

    _, _, sd, _ = pair
    q = Int8Config(min_size=0)
    placed, dm, loader = bm.load_checkpoint_and_dispatch(
        None, ckpt, device_map={m: "cpu" if m.startswith("layers") else 0
                                for m in modeling.top_level_modules(sd)},
        quantization=q, device=CPU)
    want = quantize_model_params(sd, q)
    assert set(placed) == set(want)
    assert all(torch.equal(placed[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="disk-mapped"):
        bm.load_checkpoint_and_dispatch(
            None, ckpt, device_map={m: "disk" for m in modeling.top_level_modules(sd)},
            quantization=q, device=CPU)


def _hf_llama_dir(path, sd, cfg):
    """A HF Llama directory of ``sd``: ``config.json`` and
    ``model.safetensors`` under the HF key names (the port's llama map,
    whose transforms are identities, read backwards)."""
    mapping = hf_compat.llama_key_map(cfg)
    save_file({hf: sd[name] for name, (hf, _) in mapping.items()},
              os.path.join(path, "model.safetensors"))
    hf_cfg = dict(model_type="llama", architectures=["LlamaForCausalLM"],
                  vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  intermediate_size=cfg.intermediate_size,
                  num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
                  num_key_value_heads=cfg.num_kv_heads,
                  max_position_embeddings=cfg.max_seq_len, rms_norm_eps=cfg.rms_norm_eps,
                  rope_theta=cfg.rope_theta, tie_word_embeddings=False,
                  hidden_act="silu", torch_dtype="float32")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)


def test_load_hf_checkpoint_with_device_map(pair, tmp_path):
    """``load_hf_checkpoint(device_map=...)`` over the card (the CPU here),
    ``"cpu"`` and ``"disk"``: the HF directory is converted, the reference's
    four results come back, and the streamed model equals the one-device
    load's bit for bit."""
    _, _, sd, _ = pair
    hf_dir = str(tmp_path / "hf")
    os.makedirs(hf_dir)
    _hf_llama_dir(hf_dir, sd, _cfg())
    dm = {"embed_tokens": 0, "layers.0": "cpu", "layers.1": "disk", "final_norm": 0,
          "lm_head": "cpu"}
    over = {"dtype": torch.float32}
    model, params, got_dm, loader = hf_compat.load_hf_checkpoint(
        hf_dir, device=CPU, device_map=dm, config_overrides=over)
    assert got_dm == dm and model.embed_tokens.weight.device.type == "meta"
    assert loader.is_mapped("layers.1.attn.q_proj.weight")
    resident, one = hf_compat.load_hf_checkpoint(hf_dir, device=CPU, config_overrides=over)
    assert set(params) | set(loader) == set(one)
    st = bm.StreamingTransformer(model.config, params, got_dm, loader, exec_device=CPU)
    ids = torch.from_numpy(_ids(4, (2, 7)))
    with torch.no_grad():
        assert torch.equal(st(ids), resident(ids))
    _, _, auto_dm, _ = hf_compat.load_hf_checkpoint(hf_dir, device=CPU, device_map="auto",
                                                    config_overrides=over)
    assert set(auto_dm.values()) == {0}


# ------------------------------------------------------------ executor
def _mlp_stack(seed=0, depth=3, width=32):
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.standard_normal((i, o)).astype(np.float32) * 0.2,
                "bias": rng.standard_normal((o,)).astype(np.float32) * 0.1}

    params = {"stem": dense(16, width), "out": dense(width, 4)}
    params.update({f"block_{i}": {"lin": dense(width, width)} for i in range(depth)})
    x = rng.standard_normal((2, 16)).astype(np.float32)
    return params, x


def _stem(p, x):
    return x @ p["kernel"] + p["bias"]


def _block(p, x):
    return x + torch.nn.functional.gelu(x) @ p["lin"]["kernel"] + p["lin"]["bias"]


def _jax_mlp(params, x):
    h = x @ params["stem"]["kernel"] + params["stem"]["bias"]
    for i in range(3):
        lin = params[f"block_{i}"]["lin"]
        h = h + jax.nn.gelu(h, approximate=False) @ lin["kernel"] + lin["bias"]
    return np.asarray(h @ params["out"]["kernel"] + params["out"]["bias"])


def test_streams_a_non_transformer_stack():
    params, x = _mlp_stack()
    plan = bm.make_layer_plan(embed=("stem", _stem),
                              layers=[(f"block_{i}", _block) for i in range(3)],
                              head=("out", _stem))
    ref = _jax_mlp(params, x)
    out = bm.StreamingExecutor(plan, params=params, exec_device=CPU)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # from a loader of memory maps, every block through the staging buffer
    flat = {k: torch.from_numpy(v) for k, v in modeling.flatten_tree(params).items()}
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        offload.offload_state_dict(d, flat)
        ex = bm.StreamingExecutor(plan, weights_loader=offload.OffloadedWeightsLoader(
            save_folder=d), exec_device=CPU)
        np.testing.assert_allclose(ex(torch.from_numpy(x)).numpy(), ref, atol=ATOL)
        assert ex._packed_cache == {} and ex.last_bytes_streamed == sum(
            t.numel() * 4 for t in flat.values())
    with pytest.raises(ValueError, match="non-empty plan"):
        bm.StreamingExecutor([], exec_device=CPU)
    with pytest.raises(KeyError, match="No weights"):
        bm.StreamingExecutor([("nowhere", _stem)], exec_device=CPU)(torch.from_numpy(x))


def test_multi_carry_stage():
    plan = [(lambda: {"s": torch.tensor(2.0)}, lambda p, a, b: (a * p["s"], b + 1)),
            (lambda: {"s": torch.tensor(3.0)}, lambda p, a, b: a * p["s"] + b)]
    out = bm.StreamingExecutor(plan, exec_device=CPU)(torch.tensor(1.0), torch.tensor(0.0))
    assert float(out) == 7.0


def test_packed_snapshot_invalidate_and_rebind():
    w = np.full((64, 64), 2.0, np.float32)
    b = np.zeros((64,), np.float32)
    plan = [("mod", lambda p, x: x @ p["w"] + p["b"])]
    ex = bm.StreamingExecutor(plan, params={"mod": {"w": w, "b": b}}, exec_device=CPU)
    x = torch.ones(2, 64)
    first = ex(x)
    w[:] = 0.0  # a snapshot: an edit in place is not seen ...
    assert torch.equal(ex(x), first)
    ex.invalidate_cache()  # ... until the cache is dropped
    assert torch.equal(ex(x), torch.zeros(2, 64))
    # a rebind to new arrays is seen, and superseded snapshots are dropped
    for scale in (2.0, 3.0, 5.0):
        ex.params = {"mod": {"w": np.full((64, 64), scale, np.float32), "b": b}}
        assert torch.equal(ex(x), torch.full((2, 64), 64.0 * scale))
        assert len(ex._buffer_registry) == 1


def test_tied_module_packs_once():
    shared = {"w": torch.ones(32, 32)}
    plan = [("a", lambda p, x: x @ p["w"]), (lambda: shared, lambda p, x: x @ p["w"])]
    ex = bm.StreamingExecutor(plan, params={"a": shared}, exec_device=CPU)
    assert torch.equal(ex(torch.ones(2, 32)), torch.full((2, 32), 32.0 * 32.0))
    assert len(ex._buffer_registry) == 1


def _hook_plan():
    def fn(p, x):
        return x @ p["w"]

    params = {"stem": {"w": torch.eye(4)}, "mid": {"w": 2.0 * torch.eye(4)},
              "out": {"w": torch.eye(4)}}
    return bm.make_layer_plan(embed=("stem", fn), layers=[("mid", fn)], head=("out", fn)), params


def test_hooks_order_carry_fetch_and_removal():
    calls = []

    class Recorder(bm.StageHook):
        def __init__(self, tag):
            self.tag = tag

        def pre_stage(self, ex, i, carry):
            calls.append((self.tag, "pre", i))

        def post_stage(self, ex, i, carry):
            calls.append((self.tag, "post", i))

    plan, params = _hook_plan()
    ex = bm.StreamingExecutor(plan, params=params, hooks=[Recorder("a")], exec_device=CPU)
    ex.add_hook(Recorder("b"))
    assert torch.equal(ex(torch.ones(1, 4)), 2.0 * torch.ones(1, 4))
    assert calls == [(t, w, i) for i in range(3) for w in ("pre", "post") for t in "ab"]

    class Doubler(bm.StageHook):
        def post_stage(self, ex, i, carry):
            if i == 0:
                return tuple(2.0 * c for c in carry)

    out = bm.StreamingExecutor(plan, params=params, hooks=[Doubler()], exec_device=CPU)(
        torch.ones(1, 4))
    assert torch.equal(out, 4.0 * torch.ones(1, 4))

    class Store(bm.StageHook):
        fetched = []

        def fetch_weights(self, ex, i, source):
            self.fetched.append(i)
            if source == "mid":
                return {"w": 5.0 * torch.eye(4)}

    store = Store()
    out = bm.StreamingExecutor(plan, params=params, hooks=[store], exec_device=CPU)(
        torch.ones(1, 4))
    assert torch.equal(out, 5.0 * torch.ones(1, 4)) and store.fetched == [0, 1, 2]

    class Boom(bm.StageHook):
        def pre_stage(self, ex, i, carry):
            raise AssertionError("removed")

    ex = bm.StreamingExecutor(plan, params=params, exec_device=CPU)
    h = Boom()
    ex.add_hook(h)
    ex.remove_hook(h)
    assert torch.equal(ex(torch.ones(1, 4)), 2.0 * torch.ones(1, 4))


def test_hooks_on_the_cached_decode_path(pair):
    _, _, sd, model = pair
    seen = []

    class Span(bm.StageHook):
        def pre_stage(self, ex, i, carry):
            seen.append((i, len(carry)))

    st = bm.StreamingTransformer(model.config, sd, hooks=[Span()], exec_device=CPU)
    cache = st.init_cache(1, 8)
    st.forward_with_cache(torch.arange(4)[None, :], cache)
    # embed and head see (ids | x, positions); each layer stage its chunk cache too
    assert seen == [(0, 2), (1, 3), (2, 3), (3, 2)]


# ------------------------------------------------------------ streaming
@pytest.fixture(scope="module")
def jax_streamers(pair):
    jmodel, jparams, _, _ = pair
    cfg = jmodel.config
    return {"resident": jbm.StreamingTransformer(cfg, jparams),
            "cpu": jbm.StreamingTransformer(cfg, **_placed(jbm.cpu_offload(jparams)))}


@pytest.mark.parametrize("source", ["resident", "cpu", "disk", "mapped_checkpoint"])
def test_streamed_forward_bitwise_resident_and_near_jax(pair, jax_streamers, source,
                                                         tmp_path, ckpt):
    jmodel, jparams, sd, model = pair
    cfg = model.config
    if source == "resident":
        st = bm.StreamingTransformer(cfg, sd, exec_device=CPU)
    elif source == "cpu":
        st = bm.StreamingTransformer(cfg, **_placed(bm.cpu_offload(sd, device=CPU)), exec_device=CPU)
    elif source == "disk":
        placed, loader = bm.disk_offload(sd, str(tmp_path), device=CPU)
        st = bm.StreamingTransformer(cfg, placed, weights_loader=loader, exec_device=CPU,
                                     layers_per_stage=2)
    else:
        dm = {m: "disk" for m in modeling.top_level_modules(sd)}
        placed, dm, loader = bm.load_checkpoint_and_dispatch(None, ckpt, dm, device=CPU)
        st = bm.StreamingTransformer(cfg, placed, dm, loader, exec_device=CPU)
    ids = _ids(5, (2, 11))
    with torch.no_grad():
        ref = model(torch.from_numpy(ids))
    out = st(torch.from_numpy(ids))
    assert torch.equal(out, ref)
    jout = np.asarray(jax_streamers["cpu"](jnp.asarray(ids)))
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(tie_word_embeddings=True),
                                dict(positional="learned", norm_type="layernorm",
                                     use_bias=True, embed_norm=True),
                                dict(num_experts=4)],
                         ids=["tied", "learned_embed_norm", "moe"])
def test_streamed_families_bitwise_resident(kw):
    cfg = _cfg(**kw)
    sd = init_params(cfg, seed=1, device=CPU, dtype=torch.float32)
    sd = {k: v + 0.1 * torch.randn_like(v) if v.dim() == 1 else v for k, v in sd.items()}
    model = _resident(cfg, sd)
    ids = torch.from_numpy(_ids(6, (2, 10)))
    st = bm.StreamingTransformer(cfg, **_placed(bm.cpu_offload(sd, device=CPU)), exec_device=CPU)
    with torch.no_grad():
        assert torch.equal(st(ids), model(ids))
    if cfg.tie_word_embeddings:
        # the embedding stage and the head stage share its snapshot (f32: the
        # head's group also holds the final norm, so only with dtypes apart)
        assert len(st._buffer_registry) == cfg.num_layers + 2


def test_quantized_tree_streams(pair):
    """A JAX int8 tree through ``params_from_jax``: the streamed port model is
    bitwise the resident quantized one and within ``ATOL`` of the JAX
    package's ``StreamingTransformer`` on the same tree."""
    jmodel, jparams, _, _ = pair
    jq = jax.tree_util.tree_map(np.asarray, jquantize(jparams, JInt8Config()))
    qcfg = _cfg(quantization=8)
    sd = params_from_jax(jq, device=CPU)
    model = _resident(qcfg, sd)
    ids = _ids(7, (2, 9))
    st = bm.StreamingTransformer(qcfg, **_placed(bm.cpu_offload(sd, device=CPU)), exec_device=CPU)
    out = st(torch.from_numpy(ids))
    with torch.no_grad():
        assert torch.equal(out, model(torch.from_numpy(ids)))
    jst = jbm.StreamingTransformer(dataclasses.replace(jmodel.config, quantization=8), jq)
    np.testing.assert_allclose(out.numpy(), np.asarray(jst(jnp.asarray(ids))), atol=ATOL)


def test_scanned_jax_tree_carries_across():
    """``params_from_jax`` unstacks a ``scan_layers=True`` tree into
    ``layers.{i}``, each layer's kernels transposed: the port's logits match
    the scanned JAX model's, and its streamed forward the JAX streamer's."""
    jcfg = _jcfg(scan_layers=True)
    jmodel, jparams = _jparams(jcfg, seed=2)
    assert "layers" in jparams and "layers_0" not in jparams
    sd = params_from_jax(jparams, device=CPU)
    assert set(sd) == set(init_params(_cfg(), device=CPU))
    model = _resident(_cfg(), sd)
    ids = _ids(8, (2, 12))
    ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(ids)).numpy(), ref, atol=ATOL)
    out = bm.StreamingTransformer(_cfg(), sd, exec_device=CPU)(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jbm.StreamingTransformer(
        jcfg, jparams)(jnp.asarray(ids))), atol=ATOL)


def test_streams_across_inference_mode(pair):
    """The transfer buffers a first call allocates inside
    ``torch.inference_mode`` are written again by a later call outside it."""
    from accelerate_tpu_torch.models.transformer import KVCache

    _, _, sd, model = pair
    st = bm.StreamingTransformer(model.config, **_placed(bm.cpu_offload(sd, device=CPU)),
                                 exec_device=CPU)
    ids = torch.from_numpy(_ids(9, (1, 6)))
    with torch.inference_mode():
        assert torch.equal(st(ids), model(ids))
    logits, _ = st.forward_with_cache(ids, st.init_cache(1, 6))
    with torch.no_grad():
        want, _ = model(ids, cache=KVCache.create(model.config, 1, 6, device=CPU))
    assert torch.equal(logits, want)

"""Configuration dataclasses of the training path.

Port of the :mod:`accelerate_tpu.utils.dataclasses` classes the train
step and its checkpoints need: :class:`PrecisionPolicy`,
:class:`GradScalerKwargs`, :class:`FP8RecipeKwargs`,
:class:`GradientAccumulationPlugin`, :class:`DataLoaderConfiguration`,
:class:`ProjectConfiguration`, :class:`CompilationConfig` (remat),
:class:`FullyShardedDataParallelPlugin` with its enums, and the
multi-process ones: :class:`DistributedType`, :class:`MeshConfig` and
:func:`parse_mesh_spec`, :class:`InitProcessGroupKwargs`,
:class:`CollectiveKwargs`, :class:`ZeroPlugin` (the DeepSpeed plugin's
counterpart) and :class:`ModelParallelPlugin` (the Megatron plugin's: the
``tp``, ``pp``, ``sp`` and ``ep`` degrees).  Dtypes are ``torch`` dtypes.
"""

from __future__ import annotations

import copy
import enum
import os
import warnings
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, Mapping, Optional

import torch


def str_to_bool(value: str) -> int:
    """An environment string as 1 or 0 (``y``/``yes``/``t``/``true``/``on``/``1``
    and their negations)."""
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if value in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    try:
        return bool(str_to_bool(os.environ.get(key, str(default))))
    except ValueError:
        return default


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"dp=2,fsdp=4,tp=-1"`` -> an axes dict (the ``ACCELERATE_MESH``
    environment's format)."""
    axes = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"Bad mesh spec segment {part!r}; expected name=size")
        name, size = part.split("=", 1)
        axes[name.strip()] = int(size)
    return axes


class EnumWithContains(enum.EnumMeta):
    def __contains__(cls, item):
        try:
            cls(item)
        except ValueError:
            return False
        return True


class BaseEnum(str, enum.Enum, metaclass=EnumWithContains):
    def __str__(self):
        return self.value


class DistributedType(BaseEnum):
    """Topology and promoted strategy, with the JAX package's values:
    ``NO`` (one process, one device), ``MULTI_CPU`` (several processes on
    the host), ``FSDP``, ``ZERO`` and ``MODEL_PARALLEL`` (a plugin was
    given).  The JAX package's ``TPU``/``MULTI_TPU`` name its several chips
    under one or several hosts; the port's counterpart, several processes
    each on one card, is ``MULTI_GPU``."""

    NO = "NO"
    MULTI_CPU = "MULTI_CPU"
    MULTI_GPU = "MULTI_GPU"
    FSDP = "FSDP"
    ZERO = "ZERO"
    MODEL_PARALLEL = "MODEL_PARALLEL"


class ShardingStrategy(BaseEnum):
    """FSDP sharding strategies, as the JAX package's act over the ``fsdp``
    axis: ``FULL_SHARD``/``HYBRID_SHARD`` shard parameters, gradients and
    optimizer state; ``SHARD_GRAD_OP``/``HYBRID_SHARD_ZERO2`` gradients and
    optimizer state; ``NO_SHARD`` nothing.  Over an ``fsdp`` axis of size 1
    every strategy holds the whole state."""

    FULL_SHARD = "FULL_SHARD"
    SHARD_GRAD_OP = "SHARD_GRAD_OP"
    NO_SHARD = "NO_SHARD"
    HYBRID_SHARD = "HYBRID_SHARD"
    HYBRID_SHARD_ZERO2 = "HYBRID_SHARD_ZERO2"


class StateDictType(BaseEnum):
    """Checkpoint layouts.  The JAX package writes one orbax tree either
    way; the port writes one ``torch.save`` file for one process and one a
    rank across processes, either way (``checkpointing.py``)."""

    FULL_STATE_DICT = "FULL_STATE_DICT"
    SHARDED_STATE_DICT = "SHARDED_STATE_DICT"


class KwargsHandler:
    def to_dict(self):
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self):
        """The fields that differ from their defaults."""
        default_dict = self.__class__().to_dict()
        this_dict = self.to_dict()
        return {k: v for k, v in this_dict.items() if default_dict[k] != v}


@dataclass
class CollectiveKwargs(KwargsHandler):
    """Gradient-reduction options (``accelerate_tpu/utils/dataclasses.py:174-229``).

    - ``grad_reduce_dtype``: the gradient carry dtype (``"bf16"``,
      ``"fp16"``, ``"fp32"`` or ``None`` for f32): the accumulation buffer
      and the gradients between the backward and the update take it; norm
      and clip math stay f32.
    - ``comm_hook="powersgd"``: rank-``powersgd_rank`` PowerSGD over the
      ``dp`` axis (:mod:`~accelerate_tpu_torch.parallel.compression`),
      leaves below ``comm_hook_min_size`` elements reduced uncompressed.
    - ``bucket_cap_mb``: accepted for the reference's signature.
    """

    grad_reduce_dtype: Optional[str] = None
    bucket_cap_mb: int = 25
    comm_hook: str = "none"
    powersgd_rank: int = 4
    comm_hook_min_size: int = 4096

    @classmethod
    def from_env(cls) -> "CollectiveKwargs":
        """The launcher's environment (``ACCELERATE_GRAD_REDUCE_DTYPE``,
        ``ACCELERATE_COMM_HOOK``, ``ACCELERATE_POWERSGD_RANK``); a factory,
        so that a handler passed to the Accelerator wins."""
        kw: Dict[str, Any] = {}
        if os.environ.get("ACCELERATE_GRAD_REDUCE_DTYPE"):
            kw["grad_reduce_dtype"] = os.environ["ACCELERATE_GRAD_REDUCE_DTYPE"]
        if os.environ.get("ACCELERATE_COMM_HOOK"):
            kw["comm_hook"] = os.environ["ACCELERATE_COMM_HOOK"]
        if os.environ.get("ACCELERATE_POWERSGD_RANK"):
            kw["powersgd_rank"] = int(os.environ["ACCELERATE_POWERSGD_RANK"])
        return cls(**kw)


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """Rendezvous options (``accelerate_tpu/utils/dataclasses.py:232-238``).
    ``backend`` ``"jax"`` (the reference's default) or ``None`` means the
    default, ``nccl`` on the card and ``gloo`` under ``cpu=True``;
    ``"gloo"`` and ``"nccl"`` are taken as given.  ``init_method``
    defaults to ``tcp://`` + ``ACCELERATE_COORDINATOR_ADDRESS``."""

    backend: Optional[str] = "jax"
    init_method: Optional[str] = None
    timeout: timedelta = timedelta(seconds=1800)


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss-scaling knobs for fp16."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class FP8RecipeKwargs(KwargsHandler):
    """fp8 training knobs (``accelerate_tpu/utils/dataclasses.py:241-256``).

    ``margin`` and ``fp8_format`` drive the just-in-time-scaling linear the
    model uses under ``Accelerator(mixed_precision="fp8")``
    (:mod:`~accelerate_tpu_torch.ops.fp8`); ``interval``,
    ``amax_history_len`` and ``amax_compute_algo`` drive the explicit-state
    delayed-scaling API (``DelayedScalingState``)."""

    margin: int = 0
    interval: int = 1
    fp8_format: str = "HYBRID"  # e4m3 forward / e5m2 backward; "E4M3" both
    amax_history_len: int = 1024
    amax_compute_algo: str = "max"


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    num_steps: Optional[int] = None
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class DataLoaderConfiguration:
    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = False
    non_blocking: bool = False
    prefetch_size: int = 2


@dataclass
class ProjectConfiguration:
    """Where a run keeps its checkpoints and logs: ``save_state`` names
    ``<project_dir>/checkpoints/checkpoint_{iteration}`` under
    ``automatic_checkpoint_naming`` and keeps the newest ``total_limit``."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        self.set_directories(self.project_dir)


@dataclass(frozen=True)
class PrecisionPolicy:
    """Three-dtype mixed-precision policy: masters in ``param_dtype``, cast to
    ``compute_dtype`` at step entry, step outputs cast to ``output_dtype``."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    use_loss_scaling: bool = False

    @classmethod
    def from_mixed_precision(cls, mixed_precision: Optional[str]) -> "PrecisionPolicy":
        mp = str(mixed_precision or "no")
        if mp in ("no", "fp32"):
            return cls()
        if mp == "bf16":
            return cls(compute_dtype=torch.bfloat16)
        if mp == "fp16":
            return cls(compute_dtype=torch.float16, use_loss_scaling=True)
        if mp == "fp8":
            # fp8 product operands (the model's linears); the rest in bf16
            return cls(compute_dtype=torch.bfloat16)
        raise ValueError(f"Unknown mixed precision: {mixed_precision!r}")

    @staticmethod
    def _cast(tree, dtype):
        if isinstance(tree, torch.Tensor):
            return tree.to(dtype) if tree.is_floating_point() else tree
        if isinstance(tree, Mapping):
            return type(tree)((k, PrecisionPolicy._cast(v, dtype)) for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return type(tree)(PrecisionPolicy._cast(v, dtype) for v in tree)
        return tree

    def cast_to_compute(self, tree):
        """Every floating tensor of ``tree`` in ``compute_dtype`` — a
        differentiable ``.to``, so gradients reach the masters in their own
        dtype."""
        return self._cast(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return self._cast(tree, self.output_dtype)


@dataclass
class MeshConfig:
    """An explicit mesh request: axis sizes (-1 fills with the remaining
    processes) and ``dcn_axes``, the axes whose outer part spans nodes."""

    axes: Dict[str, int] = field(default_factory=dict)
    dcn_axes: Dict[str, int] = field(default_factory=dict)
    allow_split_physical_axes: bool = False


#: ``CollectiveKwargs.grad_reduce_dtype`` names -> torch dtypes
TENSOR_DTYPES = {
    "no": torch.float32,
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "fp8": torch.float8_e4m3fn,
}


@dataclass
class CompilationConfig(KwargsHandler):
    """Compile options of the train step (``accelerate_tpu/utils/
    dataclasses.py:303-333``).

    - ``remat_policy``: activation checkpointing over the whole loss in
      ``Accelerator.compile_train_step`` (``torch.utils.checkpoint`` with the
      policy's selective-checkpoint context; ``Accelerator._maybe_remat``):
      ``"none"`` or one of ``utils.remat.POLICIES`` (an unknown name
      raises there, as in the JAX package).
    - ``donate_state``: the JAX package donates the state's buffers to its
      jitted step; here the step updates the state in place already, so
      there is nothing to donate.
    - ``scan_layers``: the JAX package's Accelerator never reads it (a
      model's own ``scan_layers`` rolls its layers); the port's layers are a
      Python loop either way.
    - ``fullgraph``, ``dynamic``: parity no-ops in the JAX package too (XLA
      always traces a whole, static graph); the port's step is eager.
    """

    remat_policy: str = "none"
    donate_state: bool = True
    scan_layers: bool = False
    fullgraph: bool = True
    dynamic: bool = False

    @classmethod
    def from_env(cls) -> "CompilationConfig":
        """The launcher's environment (``ACCELERATE_REMAT_POLICY``,
        ``ACCELERATE_SCAN_LAYERS``).  A factory, so that a config passed to
        the Accelerator wins over the environment."""
        kw = {}
        if os.environ.get("ACCELERATE_REMAT_POLICY"):
            kw["remat_policy"] = os.environ["ACCELERATE_REMAT_POLICY"]
        if os.environ.get("ACCELERATE_SCAN_LAYERS"):
            kw["scan_layers"] = parse_flag_from_env("ACCELERATE_SCAN_LAYERS")
        return cls(**kw)


@dataclass
class FullyShardedDataParallelPlugin:
    """FSDP options (``accelerate_tpu/utils/dataclasses.py:350-460``).

    ``sharding_strategy`` (:attr:`shards_params`, :attr:`shards_opt_state`,
    :attr:`shards_grads`, :attr:`hybrid`), ``min_weight_size`` and
    ``shard_gradients`` place the train state over the mesh's ``fsdp``
    axis (``parallel/sharding.py``); ``fsdp_axis_size`` sizes that axis
    (-1: every process the model-parallel axes leave).
    ``backward_prefetch``, ``use_orig_params`` and ``sync_module_states``
    are parity no-ops, as in the JAX package.  The rest:

    - ``offload_optimizer``: the optimizer state lives in pinned host
      memory and streams through the card in chunks of
      ``offload_update_chunk_mb`` on sync steps (``utils/chunked_update.py``;
      0: the whole state round-trips at once; -1: the size from the card's
      free memory), ``offload_update_overlap`` chunks in flight;
    - ``offload_optimizer_nvme_path``: the state lives in files there
      instead (the nvme tier);
    - ``offload_master_weights``: f32 masters inside the offloaded state,
      working weights in the compute dtype on the card (``None``: on when
      the optimizer is offloaded and the compute dtype is narrower);
    - ``cpu_offload``: the working weights wait in host memory between
      steps;
    - ``activation_checkpointing``: remat over the loss
      (``CompilationConfig(remat_policy="full")``).
    """

    sharding_strategy: ShardingStrategy = ShardingStrategy.FULL_SHARD
    min_weight_size: int = 2**12
    state_dict_type: StateDictType = StateDictType.SHARDED_STATE_DICT
    cpu_offload: bool = False
    offload_optimizer: bool = False
    offload_update_chunk_mb: int = 512
    offload_update_overlap: int = 1
    offload_optimizer_nvme_path: Optional[str] = None
    offload_master_weights: Optional[bool] = None
    fsdp_axis_size: int = -1
    backward_prefetch: str = "BACKWARD_PRE"
    use_orig_params: bool = True
    sync_module_states: bool = True
    activation_checkpointing: bool = False
    shard_gradients: Optional[bool] = None

    def __post_init__(self):
        if isinstance(self.sharding_strategy, str):
            self.sharding_strategy = ShardingStrategy(self.sharding_strategy)
        if isinstance(self.state_dict_type, str):
            self.state_dict_type = StateDictType(self.state_dict_type)
        env_strategy = os.environ.get("FSDP_SHARDING_STRATEGY")
        if env_strategy and "FSDP_SHARDING_STRATEGY" not in os.environ.get("_ACCELERATE_IGNORED", ""):
            if env_strategy in ShardingStrategy:
                self.sharding_strategy = ShardingStrategy(env_strategy)
        if os.environ.get("FSDP_OFFLOAD_PARAMS"):
            self.cpu_offload = parse_flag_from_env("FSDP_OFFLOAD_PARAMS")
        if os.environ.get("FSDP_MIN_NUM_PARAMS"):
            self.min_weight_size = int(os.environ["FSDP_MIN_NUM_PARAMS"])
        if os.environ.get("FSDP_STATE_DICT_TYPE"):
            self.state_dict_type = StateDictType(os.environ["FSDP_STATE_DICT_TYPE"])
        if os.environ.get("FSDP_ACTIVATION_CHECKPOINTING"):
            self.activation_checkpointing = parse_flag_from_env("FSDP_ACTIVATION_CHECKPOINTING")
        if os.environ.get("FSDP_OFFLOAD_OPTIMIZER"):
            self.offload_optimizer = parse_flag_from_env("FSDP_OFFLOAD_OPTIMIZER")
        if os.environ.get("FSDP_OFFLOAD_UPDATE_CHUNK_MB"):
            self.offload_update_chunk_mb = int(os.environ["FSDP_OFFLOAD_UPDATE_CHUNK_MB"])
        if os.environ.get("FSDP_OFFLOAD_UPDATE_OVERLAP"):
            self.offload_update_overlap = int(os.environ["FSDP_OFFLOAD_UPDATE_OVERLAP"])
        if os.environ.get("FSDP_NVME_PATH"):
            self.offload_optimizer_nvme_path = os.environ["FSDP_NVME_PATH"]
        if os.environ.get("FSDP_OFFLOAD_MASTER_WEIGHTS"):
            self.offload_master_weights = parse_flag_from_env("FSDP_OFFLOAD_MASTER_WEIGHTS")

    @property
    def shards_params(self) -> bool:
        return self.sharding_strategy in (ShardingStrategy.FULL_SHARD,
                                          ShardingStrategy.HYBRID_SHARD)

    @property
    def shards_opt_state(self) -> bool:
        return self.sharding_strategy != ShardingStrategy.NO_SHARD

    @property
    def shards_grads(self) -> bool:
        if self.shard_gradients is not None:
            return self.shard_gradients
        return self.shards_opt_state

    @property
    def hybrid(self) -> bool:
        return self.sharding_strategy in (ShardingStrategy.HYBRID_SHARD,
                                          ShardingStrategy.HYBRID_SHARD_ZERO2)


@dataclass
class ZeroPlugin:
    """The DeepSpeed plugin's counterpart (``accelerate_tpu/utils/
    dataclasses.py:463-711``): ZeRO stages lower onto the FSDP plugin
    (:meth:`to_fsdp_plugin`): stage 0 NO_SHARD, 1 optimizer state sharded,
    2 gradients too, 3 parameters too.  Offload maps onto the FSDP
    plugin's host (``"cpu"``) and disk (``"nvme"``) tiers."""

    zero_stage: int = 2
    gradient_accumulation_steps: Optional[int] = None
    gradient_clipping: Optional[float] = None
    offload_optimizer_device: str = "none"
    offload_param_device: str = "none"
    nvme_path: Optional[str] = None
    zero3_save_16bit_model: bool = False
    train_micro_batch_size_per_gpu: Optional[int] = None
    offload_update_chunk_mb: Optional[int] = None
    offload_update_overlap: Optional[int] = None

    def __post_init__(self):
        # set by from_deepspeed_config from the JSON's fp16/bf16 sections
        self.inferred_mixed_precision: Optional[str] = None
        env = os.environ
        if env.get("ACCELERATE_DEEPSPEED_ZERO_STAGE"):
            self.zero_stage = int(env["ACCELERATE_DEEPSPEED_ZERO_STAGE"])
        if env.get("ACCELERATE_DEEPSPEED_OFFLOAD_OPTIMIZER_DEVICE"):
            self.offload_optimizer_device = env["ACCELERATE_DEEPSPEED_OFFLOAD_OPTIMIZER_DEVICE"]
        if env.get("ACCELERATE_DEEPSPEED_OFFLOAD_PARAM_DEVICE"):
            self.offload_param_device = env["ACCELERATE_DEEPSPEED_OFFLOAD_PARAM_DEVICE"]
        if env.get("ACCELERATE_DEEPSPEED_NVME_PATH"):
            self.nvme_path = env["ACCELERATE_DEEPSPEED_NVME_PATH"]
        if env.get("ACCELERATE_DEEPSPEED_GRADIENT_CLIPPING"):
            self.gradient_clipping = float(env["ACCELERATE_DEEPSPEED_GRADIENT_CLIPPING"])
        if env.get("ACCELERATE_DEEPSPEED_ZERO3_SAVE_16BIT_MODEL"):
            self.zero3_save_16bit_model = parse_flag_from_env(
                "ACCELERATE_DEEPSPEED_ZERO3_SAVE_16BIT_MODEL")
        if env.get("ACCELERATE_DEEPSPEED_OFFLOAD_UPDATE_CHUNK_MB"):
            self.offload_update_chunk_mb = int(env["ACCELERATE_DEEPSPEED_OFFLOAD_UPDATE_CHUNK_MB"])
        if env.get("ACCELERATE_DEEPSPEED_OFFLOAD_UPDATE_OVERLAP"):
            self.offload_update_overlap = int(env["ACCELERATE_DEEPSPEED_OFFLOAD_UPDATE_OVERLAP"])
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"ZeRO stage must be 0-3, got {self.zero_stage}")
        if self.offload_optimizer_device not in ("none", "cpu", "nvme"):
            raise ValueError(
                f"offload_optimizer_device={self.offload_optimizer_device!r} is not "
                "supported; use 'cpu' (pinned-host offload), 'nvme' (disk tier, "
                "requires nvme_path), or 'none'.")
        if self.offload_optimizer_device == "nvme" and not self.nvme_path:
            raise ValueError(
                "offload_optimizer_device='nvme' requires nvme_path (the directory "
                "the chunked update streams optimizer state from).")
        if self.offload_param_device not in ("none", "cpu"):
            raise ValueError(
                f"offload_param_device={self.offload_param_device!r} is not supported; "
                "use 'cpu' (pinned-host offload) or 'none'. Disk-backed weight "
                "streaming is available via big_modeling.load_checkpoint_and_dispatch.")

    @classmethod
    def from_deepspeed_config(cls, path: str, **overrides) -> "ZeroPlugin":
        """A :class:`ZeroPlugin` from a DeepSpeed JSON file, with the
        reference's mapping (``accelerate_tpu/utils/dataclasses.py:549-680``):
        ``zero_optimization.stage``, ``offload_optimizer.device``/
        ``nvme_path``, ``offload_param.device`` (``nvme`` falls back to
        ``cpu`` with a warning), ``sub_group_size`` (elements at 12 B each,
        clamped to 2048 MB with a warning), ``stage3_gather_16bit_weights_
        on_model_save``, ``gradient_accumulation_steps``,
        ``gradient_clipping``, ``train_micro_batch_size_per_gpu`` and the
        fp16/bf16 sections (:attr:`inferred_mixed_precision`).  ``"auto"``
        resolves to the field default; every other key is named in one
        warning (build the optimizer from the same file with
        :func:`~accelerate_tpu_torch.utils.ds_compat.torch_tx_from_ds_config`)."""
        import json as _json

        with open(path) as f:
            ds = _json.load(f)

        def resolved(value, default=None):
            return default if value in ("auto", None) else value

        kwargs: Dict[str, Any] = {}
        zero = ds.get("zero_optimization", {})
        if resolved(zero.get("stage")) is not None:
            kwargs["zero_stage"] = int(zero["stage"])
        off_opt = zero.get("offload_optimizer", {}) or {}
        device = resolved(off_opt.get("device"), "none") or "none"
        if device != "none":
            kwargs["offload_optimizer_device"] = device
            if device == "nvme":
                kwargs["nvme_path"] = resolved(off_opt.get("nvme_path"))
        off_param = zero.get("offload_param", {}) or {}
        p_device = resolved(off_param.get("device"), "none") or "none"
        if p_device == "nvme":
            warnings.warn(
                "offload_param.device='nvme' has no training-state tier here; "
                "using 'cpu' (pinned host). Disk-streamed weights are served by "
                "big_modeling.load_checkpoint_and_dispatch.", stacklevel=2)
            p_device = "cpu"
        if p_device != "none":
            kwargs["offload_param_device"] = p_device
        sub_group = resolved(zero.get("sub_group_size"))
        if (sub_group is not None and device in ("cpu", "nvme")
                and "offload_update_chunk_mb" not in overrides):
            chunk_mb = max(1, int(float(sub_group)) * 12 >> 20)
            if chunk_mb > 2048:
                warnings.warn(
                    f"sub_group_size={sub_group!r} maps to ~{chunk_mb} MB streamed "
                    "chunks; clamping to 2048 MB to stay inside HBM transient "
                    "headroom (set offload_update_chunk_mb explicitly, or -1 for "
                    "adaptive sizing, to override).", stacklevel=2)
                chunk_mb = 2048
            kwargs["offload_update_chunk_mb"] = chunk_mb
        save16 = resolved(zero.get("stage3_gather_16bit_weights_on_model_save"))
        if save16 is not None:
            kwargs["zero3_save_16bit_model"] = bool(save16)
        for key, conv in (("gradient_accumulation_steps", int), ("gradient_clipping", float),
                          ("train_micro_batch_size_per_gpu", int)):
            if resolved(ds.get(key)) is not None:
                kwargs[key] = conv(ds[key])
        mixed = None
        if resolved(ds.get("bf16", {}).get("enabled"), False):
            mixed = "bf16"
        elif resolved(ds.get("fp16", {}).get("enabled"), False):
            mixed = "fp16"
        known = {"zero_optimization", "gradient_accumulation_steps", "gradient_clipping",
                 "train_micro_batch_size_per_gpu", "fp16", "bf16"}
        known_zero = {"stage", "offload_optimizer", "offload_param", "sub_group_size",
                      "stage3_gather_16bit_weights_on_model_save"}
        unmapped = sorted(set(ds) - known)
        unmapped += [f"zero_optimization.{k}" for k in sorted(set(zero) - known_zero)]
        unmapped += [f"zero_optimization.offload_optimizer.{k}"
                     for k in sorted(set(off_opt) - {"device", "nvme_path"})]
        unmapped += [f"zero_optimization.offload_param.{k}"
                     for k in sorted(set(off_param) - {"device", "nvme_path"})]
        if unmapped:
            warnings.warn(
                f"DeepSpeed config keys without a mapping here (ignored): {unmapped}. "
                "Optimizer/scheduler sections: build the optimizer from the SAME file "
                "with accelerate_tpu_torch.utils.ds_compat.torch_tx_from_ds_config(path, "
                "lr=..., total_num_steps=...) and pass it to create_train_state; "
                "comm/bucket tuning has no counterpart.", stacklevel=2)
        kwargs.update(overrides)
        plugin = cls(**kwargs)
        plugin.inferred_mixed_precision = mixed
        return plugin

    def to_fsdp_plugin(self) -> "FullyShardedDataParallelPlugin":
        """The FSDP plugin this stage lowers onto: stage 1 shards only the
        optimizer state (gradients all-reduced), stage 2 the gradients too
        (reduce-scattered), stage 3 the parameters too."""
        strategy = {0: ShardingStrategy.NO_SHARD, 1: ShardingStrategy.SHARD_GRAD_OP,
                    2: ShardingStrategy.SHARD_GRAD_OP,
                    3: ShardingStrategy.FULL_SHARD}[self.zero_stage]
        kwargs = {}
        if self.offload_update_chunk_mb is not None:
            kwargs["offload_update_chunk_mb"] = self.offload_update_chunk_mb
        if self.offload_update_overlap is not None:
            kwargs["offload_update_overlap"] = self.offload_update_overlap
        return FullyShardedDataParallelPlugin(
            sharding_strategy=strategy,
            min_weight_size=0 if self.zero_stage == 3 else 2**12,
            cpu_offload=self.offload_param_device == "cpu",
            offload_optimizer=self.offload_optimizer_device in ("cpu", "nvme"),
            offload_optimizer_nvme_path=(self.nvme_path
                                         if self.offload_optimizer_device == "nvme" else None),
            shard_gradients=self.zero_stage >= 2,
            **kwargs)


@dataclass
class ModelParallelPlugin:
    """The Megatron plugin's counterpart (``accelerate_tpu/utils/
    dataclasses.py:714-760``): the degrees become the mesh's ``tp``, ``pp``,
    ``sp`` and ``ep`` axes (``parallel/tensor_parallel.py``'s rules,
    ``parallel/pipeline.py``, ``parallel/ring_attention.py``,
    ``parallel/moe.py``); ``num_micro_batches`` is the pipeline's default
    micro-batch count.  ``recompute_activations`` lowers to
    ``remat_policy="full"``."""

    tp_degree: int = 1
    pp_degree: int = 1
    sp_degree: int = 1
    expert_parallel_degree: int = 1
    num_micro_batches: int = 8
    recompute_activations: bool = False

    def __post_init__(self):
        env = os.environ
        for key, name in (("MEGATRON_LM_TP_DEGREE", "tp_degree"),
                          ("MEGATRON_LM_PP_DEGREE", "pp_degree"),
                          ("MEGATRON_LM_SP_DEGREE", "sp_degree"),
                          ("MEGATRON_LM_EP_DEGREE", "expert_parallel_degree"),
                          ("MEGATRON_LM_NUM_MICRO_BATCHES", "num_micro_batches")):
            if env.get(key):
                setattr(self, name, int(env[key]))
        if env.get("MEGATRON_LM_RECOMPUTE_ACTIVATIONS"):
            self.recompute_activations = parse_flag_from_env("MEGATRON_LM_RECOMPUTE_ACTIVATIONS")

    @property
    def model_parallel_size(self) -> int:
        return self.tp_degree * self.pp_degree * self.sp_degree * self.expert_parallel_degree

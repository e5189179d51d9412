"""Configuration dataclasses of the training path.

Port of the :mod:`accelerate_tpu.utils.dataclasses` classes the
single-device train step and its checkpoints need: :class:`PrecisionPolicy`,
:class:`GradScalerKwargs`, :class:`FP8RecipeKwargs`,
:class:`GradientAccumulationPlugin`, :class:`DataLoaderConfiguration`,
:class:`ProjectConfiguration`, :class:`CompilationConfig` (remat) and
:class:`FullyShardedDataParallelPlugin` (the host-offloaded optimizer) with
its enums.  Dtypes are ``torch`` dtypes.
"""

from __future__ import annotations

import copy
import enum
import os
from dataclasses import dataclass
from typing import Mapping, Optional

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


class ShardingStrategy(BaseEnum):
    """FSDP sharding strategies.  Over the one card of this package every
    strategy holds the whole state on it, as the JAX package's do on a
    one-device mesh (an ``fsdp`` axis of size 1)."""

    FULL_SHARD = "FULL_SHARD"
    SHARD_GRAD_OP = "SHARD_GRAD_OP"
    NO_SHARD = "NO_SHARD"
    HYBRID_SHARD = "HYBRID_SHARD"
    HYBRID_SHARD_ZERO2 = "HYBRID_SHARD_ZERO2"


class StateDictType(BaseEnum):
    """Checkpoint layouts.  The JAX package writes one orbax tree either
    way; the port writes one ``torch.save`` file either way."""

    FULL_STATE_DICT = "FULL_STATE_DICT"
    SHARDED_STATE_DICT = "SHARDED_STATE_DICT"


class KwargsHandler:
    def to_dict(self):
        return copy.deepcopy(self.__dict__)


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
    """FSDP options on one card (``accelerate_tpu/utils/dataclasses.py:350-440``).

    Over one device the sharding fields change nothing the JAX package
    computes or writes on a one-device mesh: ``sharding_strategy``,
    ``min_weight_size``, ``state_dict_type`` and ``shard_gradients`` are
    accepted and act over that one device; ``backward_prefetch``,
    ``use_orig_params`` and ``sync_module_states`` are parity no-ops there
    too.  ``fsdp_axis_size`` above 1 needs that many devices and raises in
    the Accelerator (ROADMAP Queue 1 item 9e).  What does change the step
    is ported:

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

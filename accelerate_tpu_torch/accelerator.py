"""The ``Accelerator`` of the training path: one device a process, one or many processes.

Port of :mod:`accelerate_tpu.accelerator`.  The JAX package compiles the
whole training step into one jitted program; here the same step runs
eagerly, with the same semantics and the same metrics::

    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    loader = accelerator.prepare(SimpleDataLoader(dataset, batch_size=2))
    state = accelerator.create_train_state(
        params=model, tx=functools.partial(torch.optim.AdamW, lr=3e-4))
    step = accelerator.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    for batch in loader:
        state, metrics = step(state, batch)

Every call of ``step`` casts the f32 masters to the policy's compute dtype
(a differentiable ``.to`` inside the loss, so gradients land in f32 on the
masters), runs the loss forward and backward — adding into the parameters'
``.grad``, the accumulation buffer — and on a sync call (every
``gradient_accumulation_steps``-th, the dataloader's last batch, or every
call under ``sync_each_batch``) averages, clips by global norm and value,
checks finiteness under fp16, applies the optimizer and clears the buffer.
The state is updated in place.  ``metrics`` holds device tensors (``loss``,
``grad_norm``, ``applied``, ``overflow`` and ``aux``): the step reads nothing
back from the device, except one finiteness flag per sync step under fp16.

The reference's unfused loop shape is here too, with the JAX package's
semantics::

    for batch in loader:
        with accelerator.accumulate():
            grads, m = accelerator.compute_gradients(loss_fn, state, batch)
            state = accelerator.apply_gradients(state, grads, max_grad_norm=1.0)

``compute_gradients`` returns fresh f32 gradients (unscaled under fp16)
and leaves the state alone; ``apply_gradients`` adds them into the
accumulation buffer, or on a sync call averages, clips, applies and clears
it.  ``save_state``/``load_state`` (``checkpointing.py``) resume a run,
mid-window too; ``save_model`` exports safetensors.

Under ``mixed_precision="fp8"`` (compute in bf16), ``prepare(model)`` rebuilds
a :class:`~accelerate_tpu_torch.models.transformer.Transformer` with
``use_fp8`` and the recipe's margin and format (an ``FP8RecipeKwargs``
handler, else the default recipe), on the same tensors: its projections
then run fp8 products (``ops/fp8.py``).

Single-card training memory (the reference's remat and ZeRO-Offload)::

    accelerator = Accelerator(
        mixed_precision="bf16", gradient_accumulation_steps=2,
        fsdp_plugin=FullyShardedDataParallelPlugin(offload_optimizer=True),
        compilation_config=CompilationConfig(remat_policy="full"))

``compilation_config.remat_policy`` checkpoints the whole loss in
``compile_train_step`` (``_maybe_remat``; ``fsdp_plugin.
activation_checkpointing`` lowers to ``"full"``); a model's own
``TransformerConfig(remat=True)`` checkpoints each layer instead.  With
``offload_optimizer`` the optimizer is a :class:`~accelerate_tpu_torch.
utils.chunked_update.ChunkedOptimizer`: its state in pinned host memory
(or files under ``offload_optimizer_nvme_path``), streamed through the card
in chunks on sync steps; under a compute dtype narrower than f32 the f32
masters live there too and the card holds the working weights and the
gradient buffer in the compute dtype.  ``rng_types`` is stored (it matters
only with several processes) and ``dynamo_backend`` accepted and ignored
(the step is not compiled by dynamo), as in the reference.

Telemetry, as in the reference: the step records into the process
registry (:mod:`~accelerate_tpu_torch.telemetry`) the ``train/step_time_s``
histogram (the step's time on the card's stream, between CUDA events
recorded around it and read once the step has finished, never waited for
in the loop; host wall on the CPU), ``train/steps_total``,
``train/tokens_total``, ``train/tokens_per_s``, the deferred 0-d tensor
gauges ``train/loss`` and ``train/grad_norm`` (read at a scrape, never in
the loop), ``train/model_flops`` and ``train/step_mfu`` (the FLOPs of
:func:`~accelerate_tpu_torch.telemetry.cost.train_step_cost` over the
step's time and the card's peak) and ``train/hbm_peak_bytes`` (the
allocator's peak after the step); a ``train/step`` span and heartbeat; and a
:class:`~accelerate_tpu_torch.telemetry.RecompileWatchdog` over the step,
where a "compile" is a new ``(shape, dtype, device)`` signature of the
batch.  Eval steps record ``eval/step_time_s``; ``save_state``,
``load_state`` and ``save_model`` their ``checkpoint/*`` spans, histograms
and byte counters.  ``metrics_port`` starts the debug server.

Across processes (each one device; ``launchers.py`` or any launcher that
sets the reference's ``ACCELERATE_*`` rendezvous environment) the same
script runs unchanged::

    accelerator = Accelerator(
        mesh={"dp": 2, "fsdp": 2},                       # or derived from the plugins
        fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD"),
        deepspeed_plugin=ZeroPlugin(zero_stage=2),       # lowers onto the FSDP plugin
        megatron_lm_plugin=ModelParallelPlugin(tp_degree=2),
        kwargs_handlers=[CollectiveKwargs(comm_hook="powersgd"),
                         InitProcessGroupKwargs(backend="gloo")])

The mesh is the reference's (``_default_mesh``: the plugins' axes, the
rest ``dp``; ``ACCELERATE_MESH``/``ACCELERATE_DCN_MESH``), and so are the
train state's placements (``_train_state_shardings``: the FSDP/ZeRO shape
rule, the tensor-parallel rules under ``tp``).  A prepared loader gives
each rank the rows of its data shard; the step gathers each parameter
block for the forward, reduces every micro-step's gradient over the data
axes (PowerSGD over ``dp`` with the hook), clips by the global norm over
every shard, and updates each rank's block of the optimizer state
(``parallel/sharding.py``'s ``ShardedLayout``, built whenever a process
group is up, a world of one too); without a process group the step is
the single-card one.  ``save_state`` writes each
rank's blocks and ``load_state`` re-shards them onto the live mesh, also
from another world size (``checkpointing.py``).

Pipeline, sequence and expert parallelism (``ModelParallelPlugin(
pp_degree=, sp_degree=, expert_parallel_degree=)``, the mesh's ``pp``,
``sp`` and ``ep`` axes): each ``pp`` rank keeps its stage's layers and the
loss must schedule the pipeline (``parallel/pipeline.py``'s
``pipeline_lm_loss_fn``, marked ``_pp_aware``); an ``sp`` mesh needs a loss
that cuts the sequence (a ring model's ``lm_loss_fn``, marked
``_sp_aware``); the experts' leading dim is cut over ``ep`` and each rank
computes its own (``parallel/moe.py``).  ``compile_train_step`` refuses a
loss without the mark, as the reference does.

``log_with`` (trackers) raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.utils.data
from torch import nn

from . import checkpointing
from .data_loader import DataLoaderShard, SimpleDataLoader, prepare_data_loader
from .data_loader import skip_first_batches as _skip_first_batches
from .optimizer import AcceleratedOptimizer
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .telemetry import (
    CostTable,
    RecompileWatchdog,
    detect_device_peaks,
    get_flight_recorder,
    get_registry,
    get_tracer,
    start_debug_server,
)
from .telemetry import metrics as _telemetry_metrics
from .telemetry.cost import batch_token_shape, train_step_cost
from .telemetry.watchdog import tensor_signature
from .train_state import TrainState, global_norm, tree_finite
from .utils import operations as ops
from .utils import remat as _remat
from .parallel import mesh as mesh_lib
from .utils.dataclasses import (
    TENSOR_DTYPES,
    CollectiveKwargs,
    CompilationConfig,
    DataLoaderConfiguration,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    MeshConfig,
    ModelParallelPlugin,
    PrecisionPolicy,
    ProjectConfiguration,
    ZeroPlugin,
    parse_flag_from_env,
    parse_mesh_spec,
)

#: constructor argument -> where its port stands in the ROADMAP
_UNPORTED_ARGS = {
    "log_with": "trackers: ROADMAP Queue 1 item 10 (tracking.py)",
}


def _process_group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _is_tensor(t) -> bool:
    return isinstance(t, torch.Tensor)


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor leaf of a tree, in order."""
    leaves: List[torch.Tensor] = []
    ops.recursively_apply(leaves.append, tree, test_type=_is_tensor)
    return leaves


def _batch_signature(args, kwargs):
    """A step's signature: its batch's tensors (the state is the same
    object on every call)."""
    return tensor_signature(args[1:], kwargs)


def _is_dataloader_like(obj) -> bool:
    if isinstance(obj, (DataLoaderShard, SimpleDataLoader)):
        return True
    return isinstance(obj, torch.utils.data.DataLoader)


class Accelerator:
    def __init__(
        self,
        device_placement: bool = True,
        split_batches: bool = False,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        deepspeed_plugin=None,
        fsdp_plugin=None,
        megatron_lm_plugin=None,
        mesh=None,
        rng_types=None,
        log_with=None,
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        step_scheduler_with_optimizer: bool = True,
        kwargs_handlers: Optional[List[Any]] = None,
        compilation_config=None,
        dynamo_backend: Optional[str] = None,
        metrics_port: Optional[int] = None,
    ):
        if log_with is not None:
            raise NotImplementedError(
                f"Accelerator(log_with=...) is not ported: {_UNPORTED_ARGS['log_with']}")
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        # kwargs handlers (accelerate_tpu/accelerator.py:169-190)
        self.scaler_handler: Optional[GradScalerKwargs] = None
        self.collective_handler: Optional[CollectiveKwargs] = None
        self.init_handler: Optional[InitProcessGroupKwargs] = None
        self.fp8_recipe_handler: Optional[FP8RecipeKwargs] = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, GradScalerKwargs):
                self.scaler_handler = handler
            elif isinstance(handler, CollectiveKwargs):
                self.collective_handler = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                self.init_handler = handler
            elif isinstance(handler, FP8RecipeKwargs):
                self.fp8_recipe_handler = handler
            else:
                raise TypeError(
                    f"kwargs handler {type(handler).__name__} is not one of GradScalerKwargs, "
                    "CollectiveKwargs, InitProcessGroupKwargs, FP8RecipeKwargs")
        if self.fp8_recipe_handler is None and mixed_precision == "fp8":
            self.fp8_recipe_handler = FP8RecipeKwargs()
        if self.collective_handler is None and any(
                os.environ.get(k) for k in ("ACCELERATE_GRAD_REDUCE_DTYPE",
                                            "ACCELERATE_COMM_HOOK", "ACCELERATE_POWERSGD_RANK")):
            self.collective_handler = CollectiveKwargs.from_env()

        if deepspeed_plugin is None and os.environ.get("ACCELERATE_DEEPSPEED_CONFIG_FILE"):
            deepspeed_plugin = ZeroPlugin.from_deepspeed_config(
                os.environ["ACCELERATE_DEEPSPEED_CONFIG_FILE"])
        if deepspeed_plugin is None and parse_flag_from_env("ACCELERATE_USE_DEEPSPEED"):
            deepspeed_plugin = ZeroPlugin()
        if (mixed_precision is None and not os.environ.get("ACCELERATE_MIXED_PRECISION")
                and deepspeed_plugin is not None
                and getattr(deepspeed_plugin, "inferred_mixed_precision", None)):
            mixed_precision = deepspeed_plugin.inferred_mixed_precision
        if fsdp_plugin is None and parse_flag_from_env("ACCELERATE_USE_FSDP"):
            fsdp_plugin = FullyShardedDataParallelPlugin()
        if megatron_lm_plugin is None and parse_flag_from_env("ACCELERATE_USE_MEGATRON_LM"):
            megatron_lm_plugin = ModelParallelPlugin()

        if gradient_accumulation_plugin is None:
            if (gradient_accumulation_steps == 1 and deepspeed_plugin is not None
                    and deepspeed_plugin.gradient_accumulation_steps):
                gradient_accumulation_steps = deepspeed_plugin.gradient_accumulation_steps
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=int(
                os.environ.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS",
                               gradient_accumulation_steps)))
        elif gradient_accumulation_steps != 1:
            raise ValueError("Pass either gradient_accumulation_steps or "
                             "gradient_accumulation_plugin, not both")

        # the rendezvous takes every InitProcessGroupKwargs field here
        # (the JAX package drops backend and init_method: jax.distributed
        # has neither)
        init_kwargs = self.init_handler.to_kwargs() if self.init_handler else {}
        self.state = AcceleratorState(
            mixed_precision=mixed_precision, cpu=cpu, fsdp_plugin=fsdp_plugin,
            zero_plugin=deepspeed_plugin, model_parallel_plugin=megatron_lm_plugin,
            mesh_config=mesh if isinstance(mesh, MeshConfig) else None,
            _from_accelerator=True, **init_kwargs)
        if mesh is not None and not isinstance(mesh, MeshConfig):
            self.state.partial_state.set_mesh(mesh)
        elif mesh is None:
            self._default_mesh()
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        if split_batches:
            self.dataloader_config.split_batches = True
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.compilation_config = compilation_config or CompilationConfig.from_env()
        # FSDP's activation_checkpointing and the model-parallel plugin's
        # recompute_activations lower onto the one remat mechanism
        # (accelerate_tpu/accelerator.py:254-262)
        wants_remat = ((fsdp_plugin is not None and fsdp_plugin.activation_checkpointing)
                       or (megatron_lm_plugin is not None
                           and megatron_lm_plugin.recompute_activations))
        if wants_remat and self.compilation_config.remat_policy == "none":
            self.compilation_config.remat_policy = "full"
        # the RNGs a prepared loader synchronizes across processes at each
        # epoch's start ("generator": the seedable sampler's)
        self.rng_types = rng_types or ["generator"]
        # accepted for API parity: the step is not compiled by dynamo
        self.dynamo_backend = dynamo_backend

        self.trackers: List[Any] = []  # stays empty: log_with is not ported

        self.step = 0  # host micro-step counter (the GradientState mirror)
        self.flag_tensor: Optional[int] = None
        self._models: List[nn.Module] = []
        self._optimizers: List[AcceleratedOptimizer] = []
        self._schedulers: List[AcceleratedScheduler] = []
        self._dataloaders: List[DataLoaderShard] = []
        #: id(torch optimizer) -> the TrainState it is bound to
        self._states: Dict[int, TrainState] = {}
        self._custom_objects: List[Any] = []
        self._save_model_state_pre_hooks: Dict[Any, Callable] = {}
        self._load_model_state_pre_hooks: Dict[Any, Callable] = {}
        self._chunk_info: Optional[Dict[str, Any]] = None  # set under offload_optimizer
        self._offload_master = False

        # telemetry: the process registry and span tracer every built-in
        # surface records into, the flight recorder (the step's heartbeat),
        # the cost table (each step's FLOP formula over its batch shapes)
        # and the opt-in debug server
        self.telemetry = get_registry()
        self.tracer = get_tracer()
        self.flight_recorder = get_flight_recorder()
        self.cost_table = CostTable(self.telemetry)
        self.device_peaks = detect_device_peaks(self.device)
        #: each instrumented step's settle: lands the card timings of its
        #: finished steps (analyze_costs waits for them all)
        self._step_settles: List[Callable[[bool], None]] = []
        self.debug_server = start_debug_server(metrics_port, registry=self.telemetry,
                                               recorder=self.flight_recorder)
        if self.debug_server is not None:
            self.debug_server.add_collector(self.analyze_costs)

    # --------------------------------------------------------------- topology
    def _default_mesh(self):
        """The mesh from the launcher's environment or the plugins
        (``accelerate_tpu/accelerator.py:337-407``): the model-parallel
        axes, then ``fsdp`` (``fsdp_axis_size``, -1 for every process left)
        when the strategy shards, the rest ``dp``; under a hybrid strategy
        over several nodes, ``dp`` spans the nodes and ``fsdp`` the
        processes of one.  ``ACCELERATE_MESH`` (``"dp=2,fsdp=-1"``) must
        carry the axes the plugins shard over."""
        ps = self.state.partial_state
        n = ps.num_processes
        env_mesh = os.environ.get("ACCELERATE_MESH")
        mp = self.state.model_parallel_plugin
        fsdp_plugin = self.effective_fsdp_plugin
        if env_mesh:
            axes = parse_mesh_spec(env_mesh)
            required = []
            if fsdp_plugin is not None and fsdp_plugin.shards_opt_state:
                required.append("fsdp")
            if mp is not None:
                for axis, degree in (("tp", mp.tp_degree), ("pp", mp.pp_degree),
                                     ("sp", mp.sp_degree), ("ep", mp.expert_parallel_degree)):
                    if degree > 1:
                        required.append(axis)
            missing = [a for a in required if a not in axes]
            if missing:
                raise ValueError(
                    f"ACCELERATE_MESH={env_mesh!r} lacks axes {missing} required by the "
                    "active FSDP/ZeRO/model-parallel plugins. Add them to --mesh "
                    f"(e.g. --mesh {','.join(f'{a}=...' for a in missing)},{env_mesh}) "
                    "or drop the plugin flags.")
            dcn_spec = os.environ.get("ACCELERATE_DCN_MESH")
            ps.set_mesh(MeshConfig(axes=axes,
                                   dcn_axes=parse_mesh_spec(dcn_spec) if dcn_spec else {}))
            return
        axes: Dict[str, int] = {}
        if mp is not None:
            for axis, degree in (("pp", mp.pp_degree), ("sp", mp.sp_degree),
                                 ("tp", mp.tp_degree), ("ep", mp.expert_parallel_degree)):
                if degree > 1:
                    axes[axis] = degree
        model_par = math.prod(axes.values()) if axes else 1
        if n % model_par != 0:
            raise ValueError(f"Model-parallel degrees {axes} do not divide {n} devices")
        rest = n // model_par
        if fsdp_plugin is not None and fsdp_plugin.shards_opt_state:
            nodes = self._num_nodes()
            if fsdp_plugin.hybrid and nodes > 1:
                ps.set_mesh(MeshConfig(axes={"dp": nodes, "fsdp": rest // nodes, **axes},
                                       dcn_axes={"dp": nodes}))
                return
            fsdp_size = fsdp_plugin.fsdp_axis_size if fsdp_plugin.fsdp_axis_size > 0 else rest
            if rest % fsdp_size:
                raise ValueError(
                    f"fsdp_axis_size={fsdp_size} does not divide the {rest} processes the "
                    "model-parallel axes leave (one device a process)")
            axes = {"dp": rest // fsdp_size, "fsdp": fsdp_size, **axes}
        else:
            axes = {"dp": rest, **axes}
        ps.set_mesh(axes)

    def _num_nodes(self) -> int:
        """Nodes of the run: the processes whose local index is 0 (the
        reference's processes are its hosts)."""
        if self.num_processes == 1:
            return 1
        return sum(ops.gather_object([int(self.local_process_index == 0)]))

    @property
    def effective_fsdp_plugin(self) -> Optional[FullyShardedDataParallelPlugin]:
        """The FSDP plugin, or the one a ZeRO plugin lowers onto."""
        if self.state.fsdp_plugin is not None:
            return self.state.fsdp_plugin
        if self.state.zero_plugin is not None:
            return self.state.zero_plugin.to_fsdp_plugin()
        return None

    @property
    def mesh(self):
        return self.state.partial_state.mesh

    # ------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def distributed_type(self) -> str:
        return self.state.distributed_type

    @property
    def fsdp_plugin(self) -> Optional[FullyShardedDataParallelPlugin]:
        return self.state.fsdp_plugin

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def policy(self) -> PrecisionPolicy:
        return self.state.policy

    @property
    def _use_loss_scaling(self) -> bool:
        """fp16 dynamic loss scaling, honouring ``GradScalerKwargs(enabled=False)``."""
        return self.policy.use_loss_scaling and (
            self.scaler_handler.enabled if self.scaler_handler else True)

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int):
        self.gradient_state.plugin_kwargs.update({"num_steps": value})

    @property
    def split_batches(self) -> bool:
        return self.dataloader_config.split_batches

    @property
    def dispatch_batches(self):
        return self.dataloader_config.dispatch_batches

    @property
    def even_batches(self) -> bool:
        return self.dataloader_config.even_batches

    @property
    def use_seedable_sampler(self) -> bool:
        return self.dataloader_config.use_seedable_sampler

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> Optional[str]:
        return self.project_configuration.logging_dir

    # ------------------------------------------------------------ process ctl
    def wait_for_everyone(self):
        self.state.partial_state.wait_for_everyone()

    def print(self, *args, **kwargs):
        self.state.partial_state.print(*args, **kwargs)

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.partial_state.split_between_processes(inputs,
                                                                apply_padding=apply_padding)

    def on_main_process(self, function):
        return self.state.partial_state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state.partial_state.on_local_main_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state.partial_state.on_process(function, process_index=process_index)

    def on_last_process(self, function):
        return self.state.partial_state.on_last_process(function)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.partial_state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.partial_state.local_main_process_first():
            yield

    # ----------------------------------------------------------------- prepare
    def prepare(self, *args):
        """Wrap dataloaders, optimizers and schedules for this accelerator;
        return them in the same order (one object alone, else a tuple)."""
        result = [self._prepare_one(obj) for obj in args]
        return result[0] if len(result) == 1 else tuple(result)

    def _prepare_one(self, obj):
        if _is_dataloader_like(obj):
            prepared = self.prepare_data_loader(obj)
            self._dataloaders.append(prepared)
            return prepared
        if isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
            prepared = AcceleratedOptimizer(obj, _accelerator=self)
            self._optimizers.append(prepared)
            return prepared
        if isinstance(obj, TrainState):
            return obj
        if isinstance(obj, AcceleratedScheduler):
            self._schedulers.append(obj)
            return obj
        if isinstance(obj, nn.Module):
            obj = self._maybe_apply_fp8(obj)
            self._models.append(obj)
            return obj
        if callable(obj):
            # a bare schedule: step -> learning rate
            sched = AcceleratedScheduler(
                obj, step_multiplier=self.num_processes if self.step_scheduler_with_optimizer else 1,
                split_batches=self.split_batches)
            self._schedulers.append(sched)
            return sched
        return obj

    def _maybe_apply_fp8(self, model: nn.Module) -> nn.Module:
        """Under ``mixed_precision="fp8"``, a model whose ``config`` is a
        dataclass with ``use_fp8`` comes back rebuilt with it set and the
        recipe's ``margin``/``fp8_format`` (``accelerate_tpu/accelerator.py:
        579-615``), on the same tensors (built on the meta device, the state
        dict assigned).  An int-quantized model is left as it is, and a
        model without such a config too, each with a warning."""
        if self.mixed_precision != "fp8":
            return model
        cfg = getattr(model, "config", None)
        if cfg is None or not dataclasses.is_dataclass(cfg) or not hasattr(cfg, "use_fp8"):
            warnings.warn(
                f"mixed_precision='fp8': {type(model).__name__} has no fp8-capable config "
                "(a dataclass with a use_fp8 field); its matmuls stay in bf16. Use "
                "accelerate_tpu_torch.ops.fp8.FP8Linear in the model to opt in.", stacklevel=3)
            return model
        if getattr(cfg, "quantization", None) is not None:
            warnings.warn(
                "mixed_precision='fp8': model is int-quantized (weights already dequantize "
                "into the matmul); leaving it unchanged.", stacklevel=3)
            return model
        recipe = self.fp8_recipe_handler
        new_cfg = dataclasses.replace(cfg, use_fp8=True, fp8_margin=int(recipe.margin or 0),
                                      fp8_format=str(recipe.fp8_format))
        rebuilt = type(model)(new_cfg, device="meta")
        rebuilt.load_state_dict(model.state_dict(keep_vars=True), assign=True)
        return rebuilt

    def prepare_data_loader(self, data_loader, device_placement: Optional[bool] = None):
        """The loader for this process: the rows of its data shard on the
        mesh (``data_partition_spec``: every data axis splits the batch;
        ranks that differ on ``tp`` only get the same rows)."""
        cfg = self.dataloader_config
        return prepare_data_loader(
            data_loader, device=self.device, split_batches=cfg.split_batches,
            put_on_device=self.device_placement if device_placement is None else device_placement,
            dispatch_batches=cfg.dispatch_batches, even_batches=cfg.even_batches,
            use_seedable_sampler=cfg.use_seedable_sampler, non_blocking=cfg.non_blocking,
            prefetch_size=cfg.prefetch_size, mesh=self.mesh,
            rng_types=self.rng_types if cfg.use_seedable_sampler else None)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return _skip_first_batches(dataloader, num_batches=num_batches)

    # ------------------------------------------------------------ train state
    def create_train_state(self, *, params: nn.Module, tx: Callable) -> TrainState:
        """Cast the module's masters to the policy's ``param_dtype`` (in
        place), then bind ``tx(parameters) -> torch.optim.Optimizer`` to them.
        The optimizer is registered, wrapped, with this accelerator.

        With ``fsdp_plugin.offload_optimizer`` (the reference's offload
        branch, ``accelerate_tpu/accelerator.py:659-764``) the optimizer is
        a :class:`~accelerate_tpu_torch.utils.chunked_update.ChunkedOptimizer`
        over chunks of ``offload_update_chunk_mb`` (-1: sized from the
        card's memory, ``auto_chunk_bytes``; 0: the whole state at once,
        without master weights), its state pinned on the host or in files
        under ``offload_optimizer_nvme_path``.  Master weights (by default
        on under a compute dtype narrower than f32) put the f32 masters
        there too and cast the module to the compute dtype.  Everything the
        state needs on the host is allocated here, once."""
        if not isinstance(params, nn.Module):
            raise TypeError(f"params must be the nn.Module holding the masters, got "
                            f"{type(params)}")
        params.to(dtype=self.policy.param_dtype)
        self._chunk_info = None
        self._offload_master = False
        plugin = self.effective_fsdp_plugin
        # the sharded step whenever a process group is up, a world of one too
        layout = self._make_layout(params) if _process_group_up() else None
        opt_params = None if layout is None else layout.optimizer_params(params)
        if layout is not None and plugin is not None and plugin.offload_optimizer and any(
                e["master"] is not None for e in layout.entries.values()):
            raise NotImplementedError(
                "offload_optimizer with optimizer state sharded finer than the parameters "
                "(ZeRO-1/2, SHARD_GRAD_OP over an fsdp axis) is not ported; FULL_SHARD "
                "(ZeRO-3) streams each rank's shard: ROADMAP Queue 1 item 9e-ii")
        if plugin is not None and plugin.offload_optimizer_nvme_path and (
                not plugin.offload_optimizer or plugin.offload_update_chunk_mb == 0):
            raise ValueError(
                "offload_optimizer_nvme_path requires offload_optimizer=True and "
                "a non-zero offload_update_chunk_mb: the nvme tier streams the "
                "optimizer state through the chunked update "
                "(utils/chunked_update.py).")
        if plugin is not None and plugin.offload_optimizer:
            tx = self._offloaded_tx(params, tx, plugin)
        scaler = self.scaler_handler
        state = TrainState.create(
            model=params, tx=tx, use_loss_scaling=self._use_loss_scaling,
            init_loss_scale=scaler.init_scale if scaler else 2.0**16,
            loss_scale_kwargs=(dict(growth_factor=scaler.growth_factor,
                                    backoff_factor=scaler.backoff_factor,
                                    growth_interval=scaler.growth_interval)
                               if scaler else None),
            opt_params=opt_params,
        )
        state.layout = layout
        powersgd = self._powersgd_config()
        if powersgd is not None:
            from .parallel.compression import powersgd_init
            from .parallel.sharding import logical_shape

            self._check_powersgd_layout(layout)
            state.comm_state = powersgd_init(
                {name: torch.empty(logical_shape(name, p.shape), device=p.device)
                 for name, p in params.named_parameters()},
                rank=powersgd["rank"], min_compression_size=powersgd["min_size"])
        if self._offload_master:
            # the working copy in the compute dtype, after the masters were
            # seeded from the full-precision values
            params.to(dtype=self.policy.compute_dtype)
        state.device = self.device
        state.offload_params, _ = self._offload_flags()
        state.params_to_host()
        self._states[id(state.optimizer)] = state
        self._optimizers.append(AcceleratedOptimizer(state.optimizer, _accelerator=self))
        if params not in self._models:
            self._models.append(params)
        return state

    def _train_state_shardings(self):
        """``(param_rule, opt_rule, shards_grads)`` over the mesh
        (``accelerate_tpu/accelerator.py:898-985``): the tensor-parallel rules
        when the mesh has ``tp``, else the FSDP/ZeRO shape rules; under
        ``ep`` the stacked experts' leading dim over ``ep``, composed with
        ``fsdp`` as the strategy shards (the ``pp`` branch is the layout's
        stage ownership, :meth:`_make_layout`); ``shards_grads``: ZeRO-2 and
        up reduce-scatter gradients into the optimizer's blocks, ZeRO-1
        all-reduces."""
        from .parallel.sharding import (
            expert_partition_spec,
            logical_shape,
            make_opt_sharding_fn,
            make_param_sharding_fn,
            to_torch_spec,
        )
        from .parallel.tensor_parallel import make_tp_sharding_fn

        mesh = self.mesh
        plugin = self.effective_fsdp_plugin
        if mesh_lib.mesh_axis_size(mesh, "tp") > 1:
            param_rule = make_tp_sharding_fn(mesh, plugin)
            opt_rule = make_tp_sharding_fn(mesh, plugin, for_opt_state=True)
        else:
            shape_param, shape_opt = (make_param_sharding_fn(mesh, plugin),
                                      make_opt_sharding_fn(mesh, plugin))
            param_rule = lambda name, x: shape_param(x, name)  # noqa: E731
            opt_rule = lambda name, x: shape_opt(x, name)  # noqa: E731
        ep = mesh_lib.mesh_axis_size(mesh, "ep")
        if ep > 1:
            fsdp = mesh_lib.mesh_axis_size(mesh, "fsdp")
            min_size = plugin.min_weight_size if plugin is not None else 2**12

            def expert_wrap(base, shards_fsdp: bool):
                def rule(name, x):
                    placed = base(name, x)
                    if "experts" not in name.split("."):
                        return placed
                    shape = tuple(x.shape)
                    spec = expert_partition_spec(logical_shape(name, shape), ep,
                                                 fsdp if shards_fsdp else 1, min_size)
                    return mesh_lib.NamedSharding(mesh, to_torch_spec(name, spec, len(shape)),
                                                  placed.memory_kind)
                return rule

            param_rule = expert_wrap(param_rule, plugin is not None and plugin.shards_params)
            opt_rule = expert_wrap(opt_rule, plugin is not None and plugin.shards_opt_state)
        return param_rule, opt_rule, plugin is None or plugin.shards_grads

    def _make_layout(self, model: nn.Module):
        """The model's :class:`~accelerate_tpu_torch.parallel.sharding.
        ShardedLayout` (its blocks cut in place).  Under ``tp`` the port's
        :class:`~accelerate_tpu_torch.models.transformer.Transformer`
        computes tensor-parallel (its attention on the rank's heads); any
        other module gathers the ``tp`` blocks and computes whole, which
        gives the same values."""
        from .models.transformer import Transformer
        from .parallel.sharding import ShardedLayout

        from .parallel.pipeline import layer_stage

        param_rule, opt_rule, shards_grads = self._train_state_shardings()
        pp = mesh_lib.mesh_axis_size(self.mesh, "pp")
        stage_of = None
        if pp > 1:
            depth = len({n.split(".")[1] for n, _ in model.named_parameters()
                         if n.startswith("layers.") and n.split(".")[1].isdigit()})
            stage_of = lambda name: layer_stage(name, depth, pp)  # noqa: E731
        tp = mesh_lib.mesh_axis_size(self.mesh, "tp")
        tp_compute = isinstance(model, Transformer) and tp > 1
        if tp_compute:
            cfg = model.config
            if cfg.num_kv_heads % tp or cfg.num_heads % tp:
                raise ValueError(
                    f"tp={tp} must divide num_heads ({cfg.num_heads}) and num_kv_heads "
                    f"({cfg.num_kv_heads}): each rank attends over its own heads")
            if (cfg.positional == "alibi" or cfg.num_experts > 0
                    or cfg.quantization is not None or cfg.use_fp8):
                raise NotImplementedError(
                    "tensor-parallel training of alibi, MoE, quantized or fp8 models is not "
                    "ported: ROADMAP Queue 1 item 9e-ii")
        # the reductions ride in the compute dtype, as the reference's do
        # (XLA reduces the bf16 partials), or the explicit grad_reduce_dtype
        handler = self.collective_handler
        reduce_dtype = (TENSOR_DTYPES[handler.grad_reduce_dtype]
                        if handler is not None and handler.grad_reduce_dtype
                        else self.policy.compute_dtype)
        layout = ShardedLayout(self.mesh, model, param_rule, opt_rule, shards_grads=shards_grads,
                               tp_compute=tp_compute, reduce_dtype=reduce_dtype,
                               stage_of=stage_of, ep_compute=isinstance(model, Transformer))
        layout.install_tp(model)
        layout.install_moe(model)
        return layout

    def _powersgd_config(self) -> Optional[Dict[str, int]]:
        """PowerSGD's validated settings, or ``None`` when the hook is off
        (``accelerate_tpu/accelerator.py:1043-1085``): dp/fsdp meshes only,
        a ``dp`` axis, no fp16 loss scaling."""
        handler = self.collective_handler
        if handler is None or handler.comm_hook in (None, "none"):
            return None
        if handler.comm_hook != "powersgd":
            raise ValueError(f"Unknown CollectiveKwargs.comm_hook {handler.comm_hook!r}; "
                             "supported: 'none', 'powersgd'.")
        mesh = self.mesh
        offending = [a for a in mesh.axis_names
                     if a not in ("dp", "fsdp") and mesh_lib.mesh_axis_size(mesh, a) > 1]
        if offending:
            raise ValueError(
                "comm_hook='powersgd' compresses the dp gradient reduction and "
                f"composes with dp/fsdp meshes only; this mesh also shards over "
                f"{offending}. Drop the hook or the model-parallel axes "
                "(PowerSGD targets replicated-DP over slow networks).")
        if "dp" not in mesh.axis_names:
            raise ValueError(
                "comm_hook='powersgd' compresses the dp gradient reduction but "
                "this mesh has no dp axis; add one (e.g. mesh={'dp': n_slices, "
                "'fsdp': -1}) or drop the hook.")
        if self._use_loss_scaling:
            raise ValueError(
                "comm_hook='powersgd' is bf16/fp32-only: dynamic loss scaling "
                "re-scales gradients across steps, which breaks the error-feedback "
                "carry (stale-scale residuals).")
        return {"rank": int(handler.powersgd_rank), "min_size": int(handler.comm_hook_min_size)}

    @staticmethod
    def _check_powersgd_layout(layout) -> None:
        """PowerSGD compresses whole matrices, as the reference's does; a
        parameter the step holds in ``fsdp`` blocks (FULL_SHARD) would be
        compressed block by block, which is another algorithm."""
        if layout is None:
            return
        sharded = [n for n, e in layout.entries.items() if "fsdp" in str(e["pspec"])]
        if sharded:
            raise NotImplementedError(
                f"comm_hook='powersgd' over parameters sharded on fsdp ({sharded[:3]}...): "
                "the port compresses whole matrices only; use SHARD_GRAD_OP or NO_SHARD "
                "with the hook (ROADMAP Queue 1 item 9e-ii)")

    def _offloaded_tx(self, model: nn.Module, tx: Callable,
                      plugin: FullyShardedDataParallelPlugin) -> Callable:
        """``tx`` made into a :class:`ChunkedOptimizer` factory per the
        plugin's offload fields; sets ``_chunk_info`` (``None`` when one
        chunk holds the whole state) and ``_offload_master``."""
        from .utils.chunked_update import (
            _BYTES_PER_ELEMENT,
            ChunkedOptimizer,
            DiskChunkStore,
            HostChunkStore,
            auto_chunk_bytes,
            build_chunked_tx,
            detect_hbm_bytes,
        )

        chunk_mb = plugin.offload_update_chunk_mb
        if chunk_mb < -1:
            raise ValueError(
                f"offload_update_chunk_mb={chunk_mb}: "
                "use a positive size in MB, 0 to disable chunking, or -1 for "
                "adaptive sizing from free HBM.")
        overlap = max(int(plugin.offload_update_overlap), 1)
        use_master = False
        chunk_bytes = None  # 0: the whole state round-trips, no masters
        if chunk_mb != 0:
            use_master = plugin.offload_master_weights
            if use_master is None:
                use_master = self.policy.compute_dtype != torch.float32
            if chunk_mb == -1:
                # the working weights and their .grad (the accumulation
                # buffer: the port has no separate one) in one dtype
                working_b = (self.policy.compute_dtype if use_master
                             else self.policy.param_dtype).itemsize
                chunk_bytes = auto_chunk_bytes(
                    model, working_bytes_per_element=working_b,
                    grad_bytes_per_element=working_b, overlap=overlap,
                    hbm_bytes=detect_hbm_bytes(self.device))
            else:
                chunk_bytes = chunk_mb * 2**20
            _, info = build_chunked_tx(tx, model, chunk_bytes)
            nvme_path = plugin.offload_optimizer_nvme_path
            if info is None and nvme_path:
                state_mb = sum(p.numel() for p in model.parameters()) * _BYTES_PER_ELEMENT >> 20
                raise ValueError(
                    "offload_optimizer_device='nvme' streams the optimizer state "
                    "through bounded chunks, but offload_update_chunk_mb resolves "
                    f"to a single chunk for this model (~{state_mb} MB of state). "
                    f"Set offload_update_chunk_mb below {max(state_mb // 2, 1)} to "
                    "engage the disk tier.")
            if info is not None:
                info.update(master=bool(use_master), overlap=overlap, chunk_bytes=chunk_bytes)
                if nvme_path:
                    info["disk_store"] = DiskChunkStore(nvme_path)
                self._chunk_info = info
        self._offload_master = bool(use_master)
        info = self._chunk_info
        store = (info or {}).get("disk_store") or HostChunkStore(pin=self.device.type == "cuda")
        master_dtype = self.policy.param_dtype if use_master else None

        def make(parameters):
            return ChunkedOptimizer(parameters, tx, None if info is None else chunk_bytes,
                                    master_dtype=master_dtype, store=store, overlap=overlap)

        return make

    def _offload_flags(self):
        """``(offload_params, offload_opt)`` per the FSDP plugin
        (``accelerate_tpu/accelerator.py:1088-1117``): ``offload_opt`` means
        pinned-host residency of the optimizer state, so the nvme tier
        reports False.  Both work on any device here (on the CPU the host
        is the device)."""
        plugin = self.effective_fsdp_plugin
        on_disk = plugin is not None and bool(plugin.offload_optimizer_nvme_path)
        offload_opt = plugin is not None and plugin.offload_optimizer and not on_disk
        offload_params = plugin is not None and plugin.cpu_offload
        return offload_params, offload_opt

    def _compute_params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """Name -> master cast to the compute dtype (differentiable)."""
        return self.policy.cast_to_compute(dict(model.named_parameters()))

    def analyze_costs(self) -> Dict[str, Any]:
        """Land the card timings of every finished step (waiting for the
        steps still on the card), evaluate the cost table over every step
        program this accelerator ran, and publish ``train/model_flops`` and
        ``train/hbm_peak_bytes``.  Off the step loop: benches call it, and
        the debug server runs it before each ``/metrics`` scrape.  Returns
        the table's snapshot."""
        for settle in list(self._step_settles):
            settle(True)
        snap = self.cost_table.analyze_all()
        for name, entry in snap.items():
            if name.startswith("train_step/"):
                if entry.get("flops"):
                    self.telemetry.gauge(
                        "train/model_flops", help="XLA-estimated FLOPs per train step",
                    ).set(entry["flops"])
                if entry.get("hbm_peak_bytes"):
                    self.telemetry.gauge(
                        "train/hbm_peak_bytes",
                        help="train step executable HBM peak (arg+out+temp-alias)",
                    ).set(entry["hbm_peak_bytes"])
        return snap

    # ------------------------------------------------------------- train step
    def compile_train_step(self, loss_fn: Callable, *, has_aux: bool = False,
                           max_grad_norm: Optional[float] = None,
                           max_grad_value: Optional[float] = None,
                           compile_budget: Optional[int] = 4) -> Callable:
        """Build ``step(state, batch) -> (state, metrics)`` for
        ``loss_fn(params, batch) -> loss`` (``(loss, aux)`` with ``has_aux``),
        where ``params`` maps parameter names to the compute-dtype weights.

        Gradient accumulation is built in: the optimizer applies on every
        ``gradient_accumulation_steps``-th call and on the dataloader's last
        batch (``GradientState.sync_with_dataloader``); other calls only add
        to the buffer.  ``grad_norm`` is the norm of the running average on
        every call; the clip factor is ``min(1, max_grad_norm / (norm + 1e-6))``.

        ``compilation_config.remat_policy`` checkpoints the whole loss
        (:meth:`_maybe_remat`).  Under an offloaded optimizer the update is
        the chunked one (the state's :class:`~accelerate_tpu_torch.utils.
        chunked_update.ChunkedOptimizer`), after the clip over the whole
        buffer; under ``cpu_offload`` the working weights come to the card
        for the call and go back after it.

        The step is instrumented (the module docstring's telemetry); more
        than ``compile_budget`` distinct batch signatures log a warning
        (``None``: count without warning)."""
        if max_grad_norm is None and self.state.zero_plugin is not None:
            # a DeepSpeed config's gradient_clipping stands in when none is given
            max_grad_norm = self.state.zero_plugin.gradient_clipping
        self._check_parallel_loss(loss_fn)
        accum = self.gradient_accumulation_steps
        fp16 = self._use_loss_scaling
        chunked = self._chunk_info is not None
        loss_call = self._maybe_remat(loss_fn)

        def step(state: TrainState, batch):
            if not chunked and self._chunk_info is not None:
                raise ValueError(
                    "An offload-chunked train state exists but this step was "
                    "compiled before create_train_state: the in-graph apply "
                    "would round-trip the whole host-resident optimizer state "
                    "through HBM. Call create_train_state first, then "
                    "compile_train_step.")
            gs = self.gradient_state
            force = bool((gs.sync_with_dataloader and gs.end_of_dataloader)
                         or gs.sync_each_batch)
            scale = state.loss_scale.scale if fp16 else 1.0
            state.params_to_device()
            layout = state.layout
            if layout is None:
                out = loss_call(self._compute_params(state.model), batch)
                loss, aux = out if has_aux else (out, None)
                loss = loss.float()
                (loss * scale if fp16 else loss).backward()
            else:
                loss, aux = self._sharded_backward(state, loss_call, batch, has_aux,
                                                   scale if fp16 else None)

            count = state.micro_step + 1
            do_sync = force or count >= accum
            if layout is None:
                grads = [p.grad for p in state.model.parameters() if p.grad is not None]
                # the buffer holds scale * (sum of the micro-steps' gradients)
                inv = 1.0 / (count * scale)
                gnorm = global_norm(grads) * inv
            else:
                # ... summed over the data shards too
                grads = list(layout.buffers(state.model).values())
                inv = 1.0 / (count * scale * layout.n_data)
                gnorm = layout.global_norm(state.model) * inv
            applied = overflow = False
            if do_sync:
                factor = torch.full((), inv, dtype=torch.float32, device=gnorm.device)
                if max_grad_norm is not None:
                    factor = factor * torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, factor)
                if max_grad_value is not None:
                    for g in grads:
                        g.clamp_(-max_grad_value, max_grad_value)
                finite = self._all_finite(state, grads) if fp16 else True
                applied, overflow = finite, not finite
                if applied:
                    for sched in self._schedulers:
                        sched.apply(state.optimizer, state.step)
                    self._apply(state)
                state.optimizer.zero_grad(set_to_none=True)
                if layout is not None:
                    layout.zero_grad(state.model)
                state.micro_step = 0
                if fp16:
                    state.loss_scale = state.loss_scale.update(finite)
                for wrapper in self._optimizers:
                    if wrapper.optimizer is state.optimizer:
                        wrapper._step_was_skipped = overflow
            else:
                state.micro_step = count
            state.params_to_host()
            self.step = 0 if do_sync else self.step + 1
            gs._set_sync_gradients(do_sync)

            # flags as device fills: a host-to-device copy would wait for the stream
            flag = lambda value: torch.full((), value, dtype=torch.bool,  # noqa: E731
                                            device=loss.device)
            metrics = {
                "loss": loss.detach(),
                "grad_norm": gnorm.detach(),
                "applied": flag(applied),
                "overflow": flag(overflow),
            }
            if has_aux:
                metrics["aux"] = ops.recursively_apply(torch.Tensor.detach, aux,
                                                       test_type=_is_tensor)
            return state, metrics

        name = getattr(loss_fn, "__name__", "loss")
        # a "compile" of the eager step: a new (shape, dtype, device)
        # signature of the batch
        watched = RecompileWatchdog(step, name=f"train_step/{name}", budget=compile_budget,
                                    registry=self.telemetry, signature=_batch_signature)
        return self._instrument_train(watched, f"train_step/{name}")

    # ------------------------------------------------- across processes
    def _sharded_backward(self, state: TrainState, loss_call: Callable, batch, has_aux: bool,
                          scale: Optional[float]):
        """One micro-step of a sharded state: the blocks gathered for the
        forward, the backward, this micro-step's gradient summed over the
        data ranks (PowerSGD's mean over ``dp`` with the hook) and added to
        the buffers.  Returns the loss and aux averaged over the data ranks,
        as the reference's are over the global batch."""
        layout, model = state.layout, state.model
        named = list(model.named_parameters())
        stash = {n: p.grad for n, p in named}
        for _, p in named:
            p.grad = None
        out = loss_call(layout.compute_params(self._compute_params(model)), batch)
        loss, aux = out if has_aux else (out, None)
        loss = loss.float()
        (loss * scale if scale is not None else loss).backward()
        fresh = {n: p.grad for n, p in named if p.grad is not None}
        reduced = layout.reduce_fresh(model, fresh, compress=self._compressor(state))
        layout.accumulate(model, reduced, stash)
        if has_aux:
            aux = ops.recursively_apply(
                lambda t: layout.data_mean(t) if t.is_floating_point() else t.detach(), aux,
                test_type=_is_tensor)
        return layout.data_mean(loss), aux

    def _compressor(self, state: TrainState) -> Optional[Callable]:
        """PowerSGD's ``dp`` reduction of one parameter's gradient, on the
        JAX package's logical matrix (a linear weight transposed), carrying
        ``state.comm_state``; ``None`` without the hook.  The gradient is
        summed over this replica's ``fsdp`` ranks: it is scaled to the
        replica's mean in, and back to the sum over every data rank out."""
        if state.comm_state is None:
            return None
        from .parallel.compression import compressed_pmean
        from .parallel.sharding import logical_permutation

        layout = state.layout
        group = layout.mesh.group("dp")
        fsdp = mesh_lib.mesh_axis_size(layout.mesh, "fsdp")

        def compress(name: str, g: torch.Tensor) -> torch.Tensor:
            transposed = logical_permutation(name, g.ndim) != tuple(range(g.ndim))
            lg = (g.t() if transposed else g) / fsdp
            ghat, new = compressed_pmean({name: lg}, {name: state.comm_state.get(name)}, group)
            state.comm_state[name] = new[name]
            out = ghat[name] * layout.n_data
            return (out.t() if transposed else out).contiguous()

        return compress

    def _all_finite(self, state: TrainState, grads) -> bool:
        """fp16's test over every shard of every process's buffers."""
        if state.layout is None:
            return bool(tree_finite(grads))
        return state.layout.all_finite(state.model)

    def _apply(self, state: TrainState) -> None:
        """The optimizer update; a sharded state's masters take their
        gradient blocks first and give the updated blocks back after."""
        if state.layout is not None:
            state.layout.to_masters(state.model)
        state.apply_gradients()
        if state.layout is not None:
            state.layout.from_masters(state.model)

    def _instrument_train(self, watched: Callable, cost_key: str) -> Callable:
        """The reference's telemetry wrapper around a train step (its
        ``train/*`` instruments, names and help strings).  With telemetry
        off it is one boolean check."""
        registry, tracer, recorder = self.telemetry, self.tracer, self.flight_recorder
        cost_table, peak_flops = self.cost_table, self.device_peaks.flops_per_s
        step_hist = registry.histogram("train/step_time_s", help="train step wall time (s)")
        steps_total = registry.counter("train/steps_total", help="train step calls")
        tokens_total = registry.counter("train/tokens_total", help="tokens (or samples) stepped")
        tps_gauge = registry.gauge("train/tokens_per_s", help="last-step token throughput")
        gnorm_gauge = registry.gauge("train/grad_norm", help="last-step gradient norm (deferred)")
        loss_gauge = registry.gauge("train/loss", help="last-step loss (deferred)")
        mfu_gauge = registry.gauge(
            "train/step_mfu", help="measured FLOPs/s over chip peak, clamped to (0, 1]")
        flops_gauge = registry.gauge(
            "train/model_flops", help="XLA-estimated FLOPs per train step")
        hbm_gauge = registry.gauge(
            "train/hbm_peak_bytes", help="train step executable HBM peak (arg+out+temp-alias)")
        #: steps on the card whose end event has not been read:
        #: (start, end, tokens, FLOPs)
        on_card: List[tuple] = []
        #: the batch shapes the cost table's entry was captured with
        captured: Dict[str, Any] = {"shapes": None, "formula": None}

        def record(dt: float, ntok: int, flops: Optional[float]) -> None:
            step_hist.observe(dt)
            if ntok:
                tps_gauge.set(ntok / dt if dt > 0 else 0.0)
            if flops:
                flops_gauge.set(flops)
                if dt > 0:
                    mfu_gauge.set(min(1.0, flops / dt / peak_flops))

        def settle(wait: bool) -> None:
            """Record the card steps whose end event has completed (with
            ``wait``, all of them, waiting for each)."""
            while on_card and (wait or on_card[0][1].query()):
                start, end, ntok, flops = on_card.pop(0)
                end.synchronize()
                record(start.elapsed_time(end) / 1e3, ntok, flops)

        self._step_settles.append(settle)

        def instrumented(state: TrainState, batch):
            if not _telemetry_metrics.enabled():
                return watched(state, batch)
            device = self.device
            shapes = [(tuple(t.shape), str(t.dtype)) for t in _tensors(batch)]
            if shapes != captured["shapes"]:
                # the formula is host arithmetic over the batch's shapes: it
                # is evaluated at once, not deferred to a scrape, and again
                # for each new batch signature (the step's FLOPs follow it)
                if captured["formula"] is None:
                    captured["formula"] = train_step_cost(state.model)
                cost_table.capture(cost_key, watched, (batch,), cost=captured["formula"],
                                   replace=True)
                cost_table.analyze(cost_key)
                captured["shapes"] = shapes
                recorder.record("train/capture", name=cost_key,
                                batch_shapes=sorted({str(s) for s, _ in shapes}))
            cuda = device.type == "cuda"
            if cuda:
                settle(False)
                marks = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                marks[0].record()
            t0 = time.perf_counter()
            with tracer.span("train/step"):
                new_state, metrics = watched(state, batch)
            dt = time.perf_counter() - t0
            steps_total.inc()
            rows, seq = batch_token_shape(shapes)
            ntok = rows * seq
            if ntok:
                tokens_total.inc(ntok)
            flops = cost_table.flops(cost_key)
            if cuda:
                marks[1].record()
                on_card.append((marks[0], marks[1], ntok, flops))
                hbm = torch.cuda.max_memory_allocated(device)
                cost_table.set_hbm_peak_bytes(cost_key, hbm)
                hbm_gauge.set(hbm)
            else:
                record(dt, ntok, flops)
            loss = None
            if isinstance(metrics, dict):
                if metrics.get("grad_norm") is not None:
                    gnorm_gauge.set(metrics["grad_norm"])
                if metrics.get("loss") is not None:
                    loss = metrics["loss"]
                    loss_gauge.set(loss)
            # progress heartbeat: the stall detector and /healthz; the loss
            # stays a device tensor until a dump reads it
            recorder.heartbeat("train/step", step=steps_total.value, dt_s=dt, tokens=ntok,
                               loss=loss)
            return new_state, metrics

        instrumented._watchdog = watched
        return instrumented

    def _check_parallel_loss(self, loss_fn: Callable) -> None:
        """The reference's guards (``accelerate_tpu/accelerator.py:1213-1234``):
        on a ``pp`` (``sp``) mesh the loss must schedule the pipeline (cut
        the sequence), or those ranks would repeat each other's work."""
        pp_size = mesh_lib.mesh_axis_size(self.mesh, "pp")
        if pp_size > 1 and not getattr(loss_fn, "_pp_aware", False):
            raise ValueError(
                f"The mesh has a pp axis of size {pp_size} but this loss_fn has no "
                "pipeline schedule: the pp devices would silently replicate compute. "
                "Build the loss with accelerate_tpu_torch.parallel.pipeline_lm_loss_fn(model) "
                "(or mark a custom loss that microbatch-schedules over the pp axis "
                "with `loss_fn._pp_aware = True`), or drop pp_degree from "
                "ModelParallelPlugin.")
        sp_size = mesh_lib.mesh_axis_size(self.mesh, "sp")
        if sp_size > 1 and not getattr(loss_fn, "_sp_aware", False):
            raise ValueError(
                f"The mesh has an sp axis of size {sp_size} but this loss_fn does not "
                "shard the sequence: those devices would silently replicate compute. "
                "Use a ring-attention model (TransformerConfig(attention_impl='ring') "
                "with lm_loss_fn — parallel/ring_attention.py), mark a custom "
                "sequence-sharded loss with `loss_fn._sp_aware = True`, or drop "
                "sp_degree from ModelParallelPlugin.")

    def _maybe_remat(self, loss_fn: Callable) -> Callable:
        """``CompilationConfig.remat_policy`` over the whole loss
        (``accelerate_tpu/accelerator.py:1119-1150``): ``loss_fn`` under
        ``torch.utils.checkpoint`` with the policy
        (:mod:`~accelerate_tpu_torch.utils.remat`), so that the backward
        recomputes what it does not save.  FSDP's
        ``activation_checkpointing`` lowers to ``"full"``.  Values and
        gradients are the loss's own."""
        name = self.compilation_config.remat_policy
        if name in (None, "none"):
            return loss_fn
        if getattr(loss_fn, "_pipeline_schedule", None) == "1f1b":
            # the 1f1b loss computes its gradients in its own forward, and
            # recomputes each stage already (accelerate_tpu/accelerator.py:1236)
            from .logging import get_logger

            get_logger(__name__).warning_once(
                "remat_policy is ignored for schedule='1f1b' pipeline losses: "
                "the interleaved schedule bounds activation memory itself, and "
                "checkpointing a custom_vjp would re-run it.")
            return loss_fn
        _remat.check_policy(name)

        def remat_loss(params, batch):
            return _remat.remat(loss_fn, params, batch, policy=name)

        return remat_loss

    def compile_eval_step(self, eval_fn: Callable, *,
                          compile_budget: Optional[int] = 4) -> Callable:
        """Build ``eval_step(state_or_params, batch)``: ``eval_fn(params,
        batch)`` under ``torch.no_grad`` with the compute-dtype weights (a
        sharded state's gathered as its train step gathers them), its
        floating outputs cast to the policy's output dtype.  Takes a
        :class:`TrainState`, the model, or a name -> tensor dict.
        Instrumented like the train step: the ``eval/step_time_s``
        histogram (host wall) and a recompile watchdog."""

        def eval_step(state_or_params, batch):
            with torch.no_grad():
                if isinstance(state_or_params, TrainState):
                    state_or_params.params_to_device()
                    try:
                        params = self._compute_params(state_or_params.model)
                        if state_or_params.layout is not None:
                            params = state_or_params.layout.compute_params(params)
                        return self.policy.cast_to_output(eval_fn(params, batch))
                    finally:
                        state_or_params.params_to_host()
                elif isinstance(state_or_params, nn.Module):
                    params = self._compute_params(state_or_params)
                    layout = next((st.layout for st in self._states.values()
                                   if st.model is state_or_params and st.layout is not None),
                                  None)
                    if layout is not None:
                        params = layout.compute_params(params)
                else:
                    params = self.policy.cast_to_compute(state_or_params)
                return self.policy.cast_to_output(eval_fn(params, batch))

        name = getattr(eval_fn, "__name__", "eval")
        watched = RecompileWatchdog(eval_step, name=f"eval_step/{name}", budget=compile_budget,
                                    registry=self.telemetry, signature=_batch_signature)
        cost_key = f"eval_step/{name}"
        eval_hist = self.telemetry.histogram("eval/step_time_s", help="eval step wall time (s)")

        def instrumented(state_or_params, batch):
            if not _telemetry_metrics.enabled():
                return watched(state_or_params, batch)
            model = (state_or_params.model if isinstance(state_or_params, TrainState)
                     else state_or_params)
            if not self.cost_table.captured(cost_key) and isinstance(model, nn.Module):
                self.cost_table.capture(cost_key, watched, (batch,),
                                        cost=train_step_cost(model, backward=False))
            t0 = time.perf_counter()
            with self.tracer.span("eval/step"):
                out = watched(state_or_params, batch)
            eval_hist.observe(time.perf_counter() - t0)
            return out

        instrumented._watchdog = watched
        return instrumented

    # ----------------------------------------------------- accumulation flags
    @contextlib.contextmanager
    def accumulate(self, *models):
        """Set ``sync_gradients`` for the next micro-step, as the JAX
        package's imperative mirror does."""
        self._do_sync()
        yield

    def _do_sync(self):
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs._set_sync_gradients(True)
        else:
            self.step += 1
            gs._set_sync_gradients((self.step % self.gradient_accumulation_steps) == 0)
        if gs.sync_each_batch:
            gs._set_sync_gradients(True)

    @contextlib.contextmanager
    def no_sync(self, model=None):
        old = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(old)

    # ------------------------------------------------- the reference's loop
    def compute_gradients(self, loss_fn: Callable, state: TrainState, batch,
                          has_aux: bool = False):
        """Gradients of ``loss_fn(params, batch)`` (the loss
        ``compile_train_step`` takes, run under the same policy cast) with
        respect to the state's masters: ``(grads, {"loss", "aux"})``, where
        ``grads`` maps each parameter name to a fresh f32 tensor, divided
        by the fp16 loss scale.  The state, and its accumulation buffer,
        are left as they are.  As in the reference, no remat policy applies
        here (only ``compile_train_step`` checkpoints the loss)."""
        scale = state.loss_scale.scale if state.loss_scale is not None else 1.0
        state.params_to_device()
        layout = state.layout
        named = list(state.model.named_parameters())
        params = self._compute_params(state.model)
        if layout is not None:
            # each rank's block of the global mean gradient
            params = layout.compute_params(params)
        out = loss_fn(params, batch)
        loss, aux = out if has_aux else (out, ())
        loss = loss.float()
        grads = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                    [p for _, p in named], allow_unused=True)
        result = {}
        for (name, p), g in zip(named, grads):
            g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
            result[name] = g.div_(scale) if scale != 1.0 else g
        if layout is not None:
            result = {name: g.div_(layout.n_data) for name, g in
                      layout.reduce_fresh(state.model, result, into_masters=False).items()}
            loss = layout.data_mean(loss)
            aux = ops.recursively_apply(
                lambda t: layout.data_mean(t) if t.is_floating_point() else t, aux,
                test_type=_is_tensor)
        state.params_to_host()
        aux = ops.recursively_apply(torch.Tensor.detach, aux, test_type=_is_tensor)
        return result, {"loss": loss.detach(), "aux": aux}

    def backward(self, *args, **kwargs):
        """Not supported, as in the JAX package: gradients are computed
        functionally (:meth:`compute_gradients`)."""
        raise RuntimeError(
            "accelerator.backward(loss) is not supported: gradients are computed "
            "functionally. Use `grads, m = accelerator.compute_gradients(loss_fn, state, batch)` "
            "then `state = accelerator.apply_gradients(state, grads)`, or the fused "
            "`accelerator.compile_train_step(loss_fn)`.")

    def apply_gradients(self, state: TrainState, grads: Dict[str, torch.Tensor],
                        max_grad_norm: Optional[float] = None) -> TrainState:
        """Add ``grads`` (name -> tensor, as :meth:`compute_gradients`
        returns them) into the accumulation buffer — the parameters'
        ``.grad`` — and, when ``sync_gradients`` is set (by
        :meth:`accumulate`), average the buffer over the window's
        ``micro_step + 1`` calls, clip it by global norm to
        ``max_grad_norm`` (factor ``min(1, max / (norm + 1e-6))``), apply
        the optimizer unless fp16 finds it non-finite, update the loss
        scale, clear the buffer and restart the window.  ``grads`` is not
        modified.  In place; returns ``state``.

        Under an offloaded optimizer the update streams the state through
        the card in chunks, where the reference round-trips the whole state
        (``accelerate_tpu/accelerator.py:1969-2003``): the values are the
        same."""
        state.params_to_device()
        params = dict(state.model.named_parameters())
        if grads.keys() != params.keys():
            raise ValueError(f"grads hold {sorted(set(grads) ^ set(params))[:5]} that the "
                             "state's parameters do not (or the other way round)")
        layout = state.layout
        with torch.no_grad():
            if layout is not None:
                layout.add_to_buffers(state.model, grads)
            else:
                for name, p in params.items():
                    if p.grad is None:
                        p.grad = grads[name].to(p.dtype, copy=True)
                    else:
                        p.grad.add_(grads[name])
        if not self.sync_gradients:
            state.micro_step += 1
            state.params_to_host()
            return state
        bufs = ([p.grad for p in params.values()] if layout is None
                else list(layout.buffers(state.model).values()))
        torch._foreach_div_(bufs, float(state.micro_step + 1))
        if max_grad_norm is not None:
            norm = global_norm(bufs) if layout is None else layout.global_norm(state.model)
            clip = torch.clamp(max_grad_norm / (norm + 1e-6), max=1.0)
            torch._foreach_mul_(bufs, clip)
        finite = self._all_finite(state, bufs) if state.loss_scale is not None else True
        if finite:
            for sched in self._schedulers:
                sched.apply(state.optimizer, state.step)
            self._apply(state)
        state.optimizer.zero_grad(set_to_none=True)
        if layout is not None:
            layout.zero_grad(state.model)
        state.micro_step = 0
        if state.loss_scale is not None:
            state.loss_scale = state.loss_scale.update(finite)
        for wrapper in self._optimizers:
            if wrapper.optimizer is state.optimizer:
                wrapper._step_was_skipped = not finite
        state.params_to_host()
        return state

    def clip_grad_norm_(self, grads, max_norm: float, norm_type: float = 2.0):
        """``(grads scaled by min(1, max_norm / (norm + 1e-6)), norm)`` for
        the global L2 norm of a tree of gradients; ``grads`` is not
        modified."""
        if norm_type != 2.0:
            raise NotImplementedError("Only L2 global-norm clipping is supported")
        layout = next((st.layout for st in self._states.values()
                       if st.layout is not None and isinstance(grads, dict)
                       and grads.keys() == st.layout.entries.keys()), None)
        if layout is None:
            norm = global_norm(_tensors(grads))
        else:
            # a sharded state's gradient blocks: the norm of the whole
            norm = torch.zeros((), dtype=torch.float32, device=self.device)
            for name, g in grads.items():
                norm = norm + torch.linalg.vector_norm(g, dtype=torch.float32).square() / \
                    layout._replicas(name, layout.entries[name]["pspec"])
            norm = ops.reduce(norm, reduction="sum").sqrt()
        factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return ops.recursively_apply(lambda g: g * factor, grads, test_type=_is_tensor), norm

    def clip_grad_value_(self, grads, clip_value: float):
        """Every gradient clamped to ``[-clip_value, clip_value]`` (new tensors)."""
        return ops.recursively_apply(lambda g: g.clamp(-clip_value, clip_value), grads,
                                     test_type=_is_tensor)

    # ------------------------------------------------------------ collectives
    def gather(self, tensor):
        return ops.gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """Gather over processes and drop the end-of-epoch remainder padding
        (``accelerate_tpu/accelerator.py:2036-2061``): tensors concatenate
        on dim 0, anything else gathers as objects."""
        all_tensors = all(ops.is_tensor(leaf) for leaf in ops._leaves(input_data)) and \
            bool(ops._leaves(input_data))
        if not all_tensors or use_gather_object:
            data = ops.gather_object(input_data)
        else:
            data = ops.gather(input_data)
        gs = self.gradient_state
        if gs.end_of_dataloader and gs.remainder > 0:
            if all_tensors and not use_gather_object:
                data = ops.recursively_apply(lambda t: t[: gs.remainder], data)
            else:
                try:
                    data = data[: gs.remainder]
                except TypeError:
                    warnings.warn("gather_for_metrics could not truncate duplicate end-of-epoch "
                                  "samples on a non-sliceable object; returning data "
                                  "unmodified.")
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return ops.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                        pad_first=pad_first)

    # ------------------------------------------------------------- utilities
    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A no-op scope: the precision policy is applied inside the step."""
        yield

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):
        """A no-op scope, as in the reference: the prepared loaders even
        out the ranks' batches (``even_batches``) instead."""
        yield

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """The module itself: the port wraps nothing."""
        return model

    def free_memory(self, *objects):
        """Drop every registered model, optimizer, schedule, dataloader and
        train state, collect garbage and return the card's cached blocks."""
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self._states.clear()
        self._chunk_info = None  # an nvme tier's store
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    def clear(self, *objects):
        return self.free_memory(*objects)

    def set_trigger(self):
        """Flag this process for :meth:`check_trigger`."""
        self.flag_tensor = 1

    def check_trigger(self) -> bool:
        """True (once) if any process called :meth:`set_trigger`."""
        triggered = any(bool(f) for f in ops.gather_object([self.flag_tensor or 0]))
        if triggered:
            self.flag_tensor = 0
        return triggered

    def get_state_dict(self, state_or_params, unwrap: bool = True) -> Dict[str, torch.Tensor]:
        """A host copy of the weights of a :class:`TrainState`, a module or a
        name -> tensor dict, by the port's state-dict names (a sharded
        state's gathered whole: every process must call this)."""
        return checkpointing.host_state_dict(state_or_params)

    def register_for_checkpointing(self, *objects):
        """Objects with ``state_dict``/``load_state_dict`` that
        :meth:`save_state`/:meth:`load_state` carry along."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(
                f"All objects must have state_dict/load_state_dict methods; got {invalid}")
        self._custom_objects.extend(objects)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return _skip_first_batches(dataloader, num_batches=num_batches)

    # ------------------------------------------------------------ checkpoints
    def save_state(self, output_dir: Optional[str] = None, state: Optional[TrainState] = None,
                   **save_kwargs) -> str:
        return checkpointing.save_accelerator_state(self, output_dir, state, **save_kwargs)

    def load_state(self, input_dir: Optional[str] = None, state: Optional[TrainState] = None,
                   **load_kwargs) -> Optional[TrainState]:
        return checkpointing.load_accelerator_state(self, input_dir, state, **load_kwargs)

    def save_model(self, state_or_params, save_directory: str,
                   max_shard_size: Union[int, str] = "10GB", safe_serialization: bool = True,
                   save_dtype: Optional[torch.dtype] = None) -> List[str]:
        return checkpointing.save_model(
            self, state_or_params, save_directory, max_shard_size=max_shard_size,
            safe_serialization=safe_serialization, save_dtype=save_dtype)

    def register_save_state_pre_hook(self, hook: Callable):
        """``hook(models, weights, output_dir)`` runs before each save."""
        handle = object()
        self._save_model_state_pre_hooks[handle] = hook
        return handle

    def register_load_state_pre_hook(self, hook: Callable):
        """``hook(models, input_dir)`` runs before each load."""
        handle = object()
        self._load_model_state_pre_hooks[handle] = hook
        return handle

    def end_training(self):
        for tracker in self.trackers:
            tracker.finish()

    # ---------------------------------------------------------------- profile
    @contextlib.contextmanager
    def profile(self, log_dir: Optional[str] = None):
        """Capture a ``torch.profiler`` trace of the block (host activity,
        and the card's on ``cuda``) and write it as a Chrome trace under
        ``log_dir`` (default ``<project_dir or .>/profile``); yields the
        profiler."""
        log_dir = log_dir or os.path.join(self.project_dir or ".", "profile")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"worker{self.process_index}.{time.time_ns()}.pt.trace.json"))

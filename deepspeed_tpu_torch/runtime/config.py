"""The ds_config subset the training path reads.

Counterpart of ``deepspeed_tpu/runtime/config.py`` for the keys
``deepspeed_tpu_torch.initialize`` honours:

* ``train_batch_size``, ``train_micro_batch_size_per_gpu``,
  ``gradient_accumulation_steps`` (resolved as ``resolve_batch_sizes``
  does, over the data-parallel world), ``steps_per_print``,
  ``gradient_clipping``, ``seed``;
* ``optimizer.{type, params}``, ``scheduler.{type, params}``;
* ``bf16.enabled``, ``fp16.{enabled, loss_scale, initial_scale_power,
  loss_scale_window, hysteresis, min_loss_scale, consecutive_hysteresis}``;
* ``zero_optimization`` (:class:`ZeroConfig`: stages 0-3 over the
  data-parallel ranks), ``kernels.{flash_attention, flash_block_q,
  flash_block_k, fused_adam}`` (``fused_adam``: the engine's two-kernel
  Adam step, for the Adam family);
* ``checkpoint.checkpoint_engine.type`` (:class:`CheckpointConfig`:
  ``sync``, ``async`` or ``decoupled``);
* ``moe`` (:class:`MoEConfig`: ``expert_parallel_size``, the size of the
  mesh's ``expert`` axis; ``dispatch_impl``, ``capacity_factor``,
  ``pad_capacity_to_ep`` and ``use_rts``, which ``initialize`` applies to
  the model's gate and MoE layer);
* ``curriculum_learning`` and ``data_efficiency.data_sampling.
  curriculum_learning`` (the seqlen curriculum of the dataloader
  ``initialize`` builds; :meth:`DeepSpeedConfig.curriculum`);
* ``sequence_parallel`` (:class:`SequenceParallelConfig`: ``sp_size``,
  the size of the mesh's ``seq`` axis ``initialize`` builds);
* ``tensor_parallel`` (:class:`TensorParallelConfig`: ``autotp_size``,
  the size of the mesh's ``tensor`` axis ``initialize`` builds, beside
  ``seq`` and the data axes; a model without a split of its own goes
  through AutoTP's name policy);
* ``hybrid_engine`` (:class:`HybridEngineConfig`: ``enabled`` makes
  ``initialize`` return the ``DeepSpeedHybridEngine``, ``max_out_tokens``
  its default generation length; the other keys are recorded for config
  parity, as in the JAX package).

* ``zero_optimization.offload_optimizer`` (ZeRO-Offload: masters and
  moments in host memory, the C++ optimizer) and ``offload_param``
  (ZeRO-Infinity: the trunk's layers streamed from the ``cpu`` or ``nvme``
  tier), typed as :class:`OffloadOptimizerConfig` and
  :class:`OffloadParamConfig`, and ``aio`` (:class:`AioConfig`: the NVMe
  tier's file I/O engine).
* ZeRO++: ``zero_quantized_weights`` (qwZ), ``zero_quantized_gradients``
  (qgZ) and ``zero_hpz_partition_size`` (hpZ) run in
  ``runtime/engine.py``; ``zero_quantized_nontrainable_weights`` is
  parsed and read nowhere, as in the JAX package.

What the port cannot do yet raises ``NotImplementedError`` ("not ported
yet", naming its ``ROADMAP.md`` Queue 1 item): the compositions with
``seq`` that ``initialize`` checks (items 7c, 7d, 9c), ZeRO++ under a
tensor or ``seq`` axis or on a model other than the Llama family (4c,
also checked by ``initialize``), MiCS (10),
``kernels.overlap_collectives`` (4b), a pipeline
dimension above 1, random-LTD (``data_efficiency.data_routing.
random_ltd``).  The groups of :data:`ACCEPTED_WITHOUT_EFFECT`
(telemetry, tuning, comms_logger, ...) are accepted and have no effect;
``ROADMAP.md`` lists them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from .config_utils import group_from_dict, is_auto

#: top-level groups of the JAX config whose planes are not ported: accepted,
#: no effect
ACCEPTED_WITHOUT_EFFECT = (
    "activation_checkpointing", "amp", "autotuning",
    "comms_logger", "compile", "compression_training", "csv_monitor",
    "disable_allgather", "dump_state", "elasticity", "flops_profiler",
    "gradient_predivide_factor", "memory_breakdown", "monitor_config",
    "prescale_gradients", "resilience", "serving", "sparse_gradients",
    "telemetry", "tensorboard", "tuning", "wall_clock_breakdown", "wandb",
    "zero_allow_untested_optimizer")

#: (group, key, ROADMAP Queue 1 item) of the parallel dimensions other than
#: data, expert, sequence and tensor whose training is not ported: a value
#: above 1 raises
_PARALLEL_DIMS = (("pipeline", "stages", 8),)

#: the token dispatch rungs of the MoE layer
DISPATCH_IMPLS = ("auto", "dense", "sparse", "pallas")


@dataclasses.dataclass
class FP16Config:
    enabled: Union[bool, str] = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0: dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BF16Config:
    enabled: Union[bool, str] = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "AdamW"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: str = "WarmupLR"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


#: where an offload puts its state (JAX ``OffloadDeviceEnum``)
OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _offload_device(device: Any, where: str) -> str:
    d = str(getattr(device, "value", device)).lower()
    if d not in OFFLOAD_DEVICES:
        raise ValueError(f"{where}.device={device!r}: use none, cpu or nvme")
    return d


@dataclasses.dataclass
class OffloadParamConfig:
    """``zero_optimization.offload_param`` (JAX
    ``DeepSpeedZeroOffloadParamConfig``): ZeRO-Infinity.  ``device`` cpu
    keeps every layer's planes in host memory, nvme in files under
    ``nvme_path`` behind a ring of ``buffer_count`` host slots."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.device = _offload_device(self.device,
                                      "zero_optimization.offload_param")


@dataclasses.dataclass
class OffloadOptimizerConfig:
    """``zero_optimization.offload_optimizer`` (JAX
    ``DeepSpeedZeroOffloadOptimizerConfig``): ZeRO-Offload.
    ``pipeline_read`` / ``pipeline_write`` left unset (None) keep the
    streaming engine's pipelined host optimizer; both set false run it
    serially.  ``nvme`` keeps the state in host memory, as the JAX
    engine does (only the streamed layers go to files)."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: Optional[bool] = None
    pipeline_write: Optional[bool] = None
    fast_init: bool = False
    ratio: float = 1.0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.device = _offload_device(self.device,
                                      "zero_optimization.offload_optimizer")

    @property
    def pipelined(self) -> bool:
        """JAX ``LayerStreamingEngine``: pipelined unless the pair is set
        and both are false."""
        if self.pipeline_read is None and self.pipeline_write is None:
            return True
        return bool(self.pipeline_read or self.pipeline_write)


@dataclasses.dataclass
class AioConfig:
    """``aio`` (JAX ``AioConfig``): the NVMe tier's file I/O engine."""

    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True
    use_gds: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


#: the persistence threshold an unresolved ``"auto"`` counts as (JAX
#: ``ZeroShardingPolicy.from_config``)
AUTO_PERSISTENCE_THRESHOLD = 100_000


@dataclasses.dataclass
class ZeroConfig:
    """``zero_optimization`` (JAX ``DeepSpeedZeroConfig``).

    ``stage`` (0-3) and ``stage3_param_persistence_threshold`` (a leaf of
    at most this many elements stays replicated) decide the placement of
    every leaf (``runtime/zero/sharder.py``); ``reduce_bucket_size`` is the
    elements of one flat collective (the gradients' all-reduce, the
    masters' all-gather).  The other scheduling knobs
    (``allgather_bucket_size``, ``overlap_comm``, ``contiguous_gradients``,
    ``stage3_prefetch_bucket_size``, ``stage3_max_live_parameters``,
    ``stage3_gather_16bit_weights_on_model_save``) are recorded and
    advisory, as in the JAX package: the engine gathers one weight at a
    time where it is read and reduce-scatters it where its gradient
    forms.  ZeRO++'s ``zero_quantized_weights``,
    ``zero_quantized_gradients`` and ``zero_hpz_partition_size`` (stage 3,
    equal to the mesh's ``data`` axis) run in the engine;
    ``zero_quantized_nontrainable_weights`` is read nowhere, as in the JAX
    package."""

    stage: int = 0
    reduce_bucket_size: Union[int, str] = 500_000_000
    allgather_bucket_size: Union[int, str] = 500_000_000
    overlap_comm: Optional[bool] = None
    contiguous_gradients: bool = True
    stage3_param_persistence_threshold: Union[int, str] = 100_000
    stage3_prefetch_bucket_size: Union[int, str] = 50_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    offload_param: Optional[OffloadParamConfig] = None
    cpu_offload: Optional[bool] = None
    mics_shard_size: int = -1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for name, group in (("offload_optimizer", OffloadOptimizerConfig),
                            ("offload_param", OffloadParamConfig)):
            value = getattr(self, name)
            if value is not None and not isinstance(value, group):
                setattr(self, name, group_from_dict(
                    group, value, f"zero_optimization.{name}"))

    def offload_optimizer_device(self) -> str:
        """none | cpu | nvme (the deprecated ``cpu_offload: true`` is
        cpu)."""
        if self.cpu_offload:
            return "cpu"
        o = self.offload_optimizer
        return "none" if o is None else o.device

    def offload_param_device(self) -> str:
        o = self.offload_param
        return "none" if o is None else o.device

    def resolve_auto_from_hidden_size(self, hidden_size: int) -> None:
        """The reference's ``"auto"`` heuristics: reduce bucket hidden²,
        prefetch 0.9 hidden², persistence threshold 10 hidden."""
        if is_auto(self.reduce_bucket_size):
            self.reduce_bucket_size = hidden_size * hidden_size
        if is_auto(self.stage3_prefetch_bucket_size):
            self.stage3_prefetch_bucket_size = int(0.9 * hidden_size
                                                   * hidden_size)
        if is_auto(self.stage3_param_persistence_threshold):
            self.stage3_param_persistence_threshold = 10 * hidden_size

    @property
    def persistence_threshold(self) -> int:
        t = self.stage3_param_persistence_threshold
        return AUTO_PERSISTENCE_THRESHOLD if is_auto(t) else int(t)

    @property
    def reduce_bucket_elements(self) -> int:
        b = self.reduce_bucket_size
        return 500_000_000 if is_auto(b) else max(int(b), 1)


@dataclasses.dataclass
class CheckpointConfig:
    """``checkpoint`` (JAX ``CheckpointConfig``): ``checkpoint_engine.type``
    picks the save backend (``runtime/checkpoint_engine.py``); the other
    keys are recorded and advisory, as in the JAX package."""

    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = dataclasses.field(default_factory=dict)
    writer: Optional[Dict[str, Any]] = None
    checkpoint_engine: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MoEConfig:
    """``moe`` (JAX ``MoEConfig``): the expert-parallel plane.
    ``initialize`` builds the mesh with ``expert_parallel_size`` as its
    ``expert`` axis (it must divide the data-parallel world) and pushes the
    other keys onto the model's gate and MoE layer (``_apply_moe_config``):
    the dispatch rung (``auto`` keeps the model's), the train and eval
    capacity factor (0 keeps the model's), the capacity padded up to a
    multiple of the expert axis, and random token selection."""

    expert_parallel_size: int = 1
    dispatch_impl: str = "auto"
    capacity_factor: float = 0.0
    pad_capacity_to_ep: bool = True
    use_rts: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if int(self.expert_parallel_size) < 1:
            raise ValueError("moe.expert_parallel_size must be >= 1")
        if self.dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(f"moe.dispatch_impl {self.dispatch_impl!r} not "
                             "in auto|dense|sparse|pallas")


@dataclasses.dataclass
class SequenceParallelConfig:
    """``sequence_parallel`` (JAX ``SequenceParallelConfig``): ``sp_size``
    is the mesh's ``seq`` axis (an mpu's ``get_sequence_parallel_world_size``
    wins); ``seq_length_is_variable`` and ``attention_backend`` are
    recorded and have no effect, as in the JAX package."""

    sp_size: int = 1
    seq_length_is_variable: bool = True
    attention_backend: str = "auto"
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TensorParallelConfig:
    """``tensor_parallel`` (JAX ``TensorParallelConfig``): ``autotp_size``
    is the mesh's ``tensor`` axis (a ``mesh=`` whose tensor axis differs
    raises); ``tp_overlap_comm`` is recorded and has no effect, as in the
    JAX package."""

    autotp_size: int = 1
    tp_overlap_comm: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not is_auto(self.autotp_size) and int(self.autotp_size) < 1:
            raise ValueError("tensor_parallel.autotp_size must be >= 1")


@dataclasses.dataclass
class HybridEngineConfig:
    """``hybrid_engine`` (JAX ``HybridEngineConfig``): ``enabled`` wraps
    the training engine in ``runtime/hybrid_engine.DeepSpeedHybridEngine``
    (generation on the live weights), ``max_out_tokens`` is its default
    number of new tokens; ``inference_tp_size``,
    ``release_inference_cache``, ``pin_parameters`` and
    ``tp_gather_partition_size`` are kept for config parity and have no
    effect, as in the JAX package."""

    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DataEfficiencyConfig:
    """``data_efficiency`` (JAX ``DataEfficiencyConfig``): its
    ``data_sampling.curriculum_learning`` is the nested form of the
    curriculum; ``data_routing.random_ltd`` is not ported."""

    enabled: bool = False
    seed: int = 1234
    data_sampling: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data_routing: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class KernelsConfig:
    #: route the model's attention through the flash kernels
    flash_attention: bool = False
    flash_block_q: int = 0
    flash_block_k: int = 0
    #: the fused step: one gradient-norm kernel and one Adam kernel
    fused_adam: bool = False
    #: the JAX engine's chunked ring collectives under ZeRO-3 (refused)
    overlap_collectives: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeepSpeedConfig:
    train_batch_size: Union[int, str, None] = None
    train_micro_batch_size_per_gpu: Union[int, str, None] = None
    gradient_accumulation_steps: Union[int, str, None] = None
    steps_per_print: Union[int, float] = 10
    gradient_clipping: Union[float, str] = 0.0
    seed: int = 1234
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = dataclasses.field(
        default_factory=ZeroConfig)
    kernels: KernelsConfig = dataclasses.field(default_factory=KernelsConfig)
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    data_efficiency: DataEfficiencyConfig = dataclasses.field(
        default_factory=DataEfficiencyConfig)
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    sequence_parallel: SequenceParallelConfig = dataclasses.field(
        default_factory=SequenceParallelConfig)
    tensor_parallel: TensorParallelConfig = dataclasses.field(
        default_factory=TensorParallelConfig)
    hybrid_engine: HybridEngineConfig = dataclasses.field(
        default_factory=HybridEngineConfig)
    aio: AioConfig = dataclasses.field(default_factory=AioConfig)
    zero_force_ds_cpu_optimizer: bool = True
    curriculum_learning: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    #: groups of :data:`ACCEPTED_WITHOUT_EFFECT` present in the input
    accepted_without_effect: Tuple[str, ...] = ()
    #: top-level keys neither ported nor known to the JAX config
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _GROUPS = {"optimizer": OptimizerConfig, "scheduler": SchedulerConfig,
               "fp16": FP16Config, "bf16": BF16Config,
               "zero_optimization": ZeroConfig, "kernels": KernelsConfig,
               "checkpoint": CheckpointConfig,
               "data_efficiency": DataEfficiencyConfig, "moe": MoEConfig,
               "sequence_parallel": SequenceParallelConfig,
               "tensor_parallel": TensorParallelConfig,
               "hybrid_engine": HybridEngineConfig, "aio": AioConfig}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DeepSpeedConfig":
        """Parse a ds_config dict; raises "not ported yet" for what the port
        cannot do."""
        data = dict(data)
        for group, key, item in _PARALLEL_DIMS:
            size = (data.get(group) or {}).get(key) or 1
            if not is_auto(size) and int(size) > 1:
                raise NotImplementedError(
                    f"{group}.{key}={size}: training over a {group} "
                    f"dimension is not ported yet (ROADMAP Queue 1 item "
                    f"{item})")
        accepted = tuple(k for k in ACCEPTED_WITHOUT_EFFECT if k in data)
        groups = {name: (group_from_dict(g, data.pop(name), name)
                         if data.get(name) is not None else data.pop(name))
                  for name, g in cls._GROUPS.items() if name in data}
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in data.items() if k in names}
        rest = {k: v for k, v in data.items()
                if k not in names and k not in ACCEPTED_WITHOUT_EFFECT
                and k not in {g for g, _, _ in _PARALLEL_DIMS}}
        cfg = cls(**known, **groups, accepted_without_effect=accepted,
                  extra=rest)
        cfg._refuse_unported()
        return cfg

    @classmethod
    def load(cls, config: Union[str, os.PathLike, Dict[str, Any],
                                "DeepSpeedConfig"]) -> "DeepSpeedConfig":
        """A config object, a dict, or the path of a JSON file."""
        if isinstance(config, DeepSpeedConfig):
            return config
        if isinstance(config, dict):
            return cls.from_dict(config)
        with open(config) as f:
            return cls.from_dict(json.load(f))

    def _refuse_unported(self) -> None:
        z = self.zero_optimization
        if int(z.stage) not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage={z.stage}: use 0-3")
        if z.offload_param_device() == "nvme" and not z.offload_param.nvme_path:
            raise ValueError("offload_param.device=nvme requires nvme_path")
        if int(z.mics_shard_size or -1) > 0:
            raise NotImplementedError("MiCS sharding (mics_shard_size) is "
                                      "not ported yet (ROADMAP Queue 1 item "
                                      "10)")
        if self.kernels.overlap_collectives:
            raise NotImplementedError(
                "kernels.overlap_collectives: the chunked ring overlap of "
                "the ZeRO-3 collectives is not ported yet (ROADMAP Queue 1 "
                "item 4b)")
        kind = str((self.checkpoint.checkpoint_engine or {}).get(
            "type", "sync")).lower()
        if kind not in ("sync", "async", "decoupled"):
            raise ValueError(f"checkpoint.checkpoint_engine.type={kind!r}: "
                             "use sync, async or decoupled")
        ltd = (self.data_efficiency.data_routing or {}).get("random_ltd") \
            or {}
        if self.data_efficiency.enabled and ltd.get("enabled"):
            raise NotImplementedError(
                "data_efficiency.data_routing.random_ltd is not ported yet "
                "(ROADMAP Queue 1 item 10)")

    def curriculum(self) -> Dict[str, Any]:
        """The enabled seqlen curriculum: the top-level
        ``curriculum_learning`` group, else ``data_efficiency.data_sampling.
        curriculum_learning`` when ``data_efficiency`` is enabled; ``{}``
        when neither is (JAX ``initialize``)."""
        cl = dict(self.curriculum_learning or {})
        if not cl.get("enabled"):
            de = self.data_efficiency
            cl = dict((de.data_sampling or {}).get("curriculum_learning")
                      or {}) if de.enabled else {}
        return cl if cl.get("enabled") else {}

    def resolve_batch_sizes(self, world_size: int = 1, tp: int = 1,
                            pp: int = 1, sp: int = 1) -> None:
        """Infer the missing members of (train batch, micro batch, grad
        accumulation) and check ``train = micro x gas x dp`` with ``dp =
        world_size / (tp x pp x sp)`` (``resolve_batch_sizes`` of the JAX
        config)."""
        denom = tp * pp * sp
        if world_size % denom:
            raise ValueError(f"world_size={world_size} not divisible by "
                             f"tp*pp*sp={denom}")
        dp = world_size // denom
        tb = None if is_auto(self.train_batch_size) else self.train_batch_size
        mb = (None if is_auto(self.train_micro_batch_size_per_gpu)
              else self.train_micro_batch_size_per_gpu)
        gas = (None if is_auto(self.gradient_accumulation_steps)
               else self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is None:
            if tb % (mb * dp):
                raise ValueError(f"train_batch_size={tb} not divisible by "
                                 f"micro_batch x dp ({mb} x {dp})")
            gas = tb // (mb * dp)
        elif tb is not None and gas is not None and mb is None:
            if tb % (gas * dp):
                raise ValueError(f"train_batch_size={tb} not divisible by "
                                 f"grad_accum x dp ({gas} x {dp})")
            mb = tb // (gas * dp)
        elif mb is not None:
            gas = gas or 1
            tb = tb or mb * gas * dp
        elif tb is not None:
            gas = 1
            if tb % dp:
                raise ValueError(f"train_batch_size={tb} not divisible by "
                                 f"dp_world={dp}")
            mb = tb // dp
        else:
            tb, mb, gas = dp, 1, 1
        if tb != mb * gas * dp:
            raise ValueError(
                f"Batch invariant violated: train_batch_size={tb} != "
                f"micro={mb} x grad_accum={gas} x dp_world={dp}")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    def resolve_auto_precision(self, default: str = "bf16") -> None:
        if is_auto(self.bf16.enabled):
            self.bf16.enabled = default == "bf16"
        if is_auto(self.fp16.enabled):
            self.fp16.enabled = default == "fp16"

    def dtype(self) -> torch.dtype:
        """Compute dtype; precedence bf16 > fp16 > fp32."""
        if self.bf16.enabled is True:
            return torch.bfloat16
        if self.fp16.enabled is True:
            return torch.float16
        return torch.float32

"""The ds_config subset the training path reads.

Counterpart of ``deepspeed_tpu/runtime/config.py`` for the keys
``deepspeed_tpu_torch.initialize`` honours on one device:

* ``train_batch_size``, ``train_micro_batch_size_per_gpu``,
  ``gradient_accumulation_steps`` (resolved as ``resolve_batch_sizes``
  does), ``steps_per_print``, ``gradient_clipping``, ``seed``;
* ``optimizer.{type, params}``, ``scheduler.{type, params}``;
* ``bf16.enabled``, ``fp16.{enabled, loss_scale, initial_scale_power,
  loss_scale_window, hysteresis, min_loss_scale, consecutive_hysteresis}``;
* ``zero_optimization.stage`` (0 only), ``kernels.{flash_attention,
  flash_block_q, flash_block_k, fused_adam}`` (``fused_adam``: the engine's
  two-kernel Adam step, for the Adam family).

What the port cannot do yet raises ``NotImplementedError`` ("not ported
yet"): ZeRO stage above 0, optimizer or parameter offload, a parallel
dimension above 1.  The groups of
:data:`ACCEPTED_WITHOUT_EFFECT` (telemetry, tuning, comms_logger, ...) are
accepted and have no effect; ``ROADMAP.md`` lists them.
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
    "activation_checkpointing", "aio", "amp", "autotuning", "checkpoint",
    "comms_logger", "compile", "compression_training", "csv_monitor",
    "curriculum_learning", "data_efficiency", "disable_allgather",
    "dump_state", "elasticity", "flops_profiler", "gradient_predivide_factor",
    "hybrid_engine", "memory_breakdown", "monitor_config",
    "prescale_gradients", "resilience", "serving", "sparse_gradients",
    "telemetry", "tensorboard", "tuning", "wall_clock_breakdown", "wandb",
    "zero_allow_untested_optimizer", "zero_force_ds_cpu_optimizer")

#: (group, key) whose value above 1 asks for a mesh of more than one device
_PARALLEL_DIMS = (("tensor_parallel", "autotp_size"),
                  ("sequence_parallel", "sp_size"), ("pipeline", "stages"),
                  ("moe", "expert_parallel_size"))


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


@dataclasses.dataclass
class ZeroConfig:
    stage: int = 0
    offload_optimizer: Optional[Dict[str, Any]] = None
    offload_param: Optional[Dict[str, Any]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class KernelsConfig:
    #: route the model's attention through the flash kernels
    flash_attention: bool = False
    flash_block_q: int = 0
    flash_block_k: int = 0
    #: the fused step: one gradient-norm kernel and one Adam kernel
    fused_adam: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _offloads(spec: Optional[Dict[str, Any]]) -> bool:
    return bool(spec) and str(spec.get("device", "none")).lower() != "none"


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
    #: groups of :data:`ACCEPTED_WITHOUT_EFFECT` present in the input
    accepted_without_effect: Tuple[str, ...] = ()
    #: top-level keys neither ported nor known to the JAX config
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _GROUPS = {"optimizer": OptimizerConfig, "scheduler": SchedulerConfig,
               "fp16": FP16Config, "bf16": BF16Config,
               "zero_optimization": ZeroConfig, "kernels": KernelsConfig}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DeepSpeedConfig":
        """Parse a ds_config dict; raises "not ported yet" for what the port
        cannot do."""
        data = dict(data)
        for group, key in _PARALLEL_DIMS:
            size = (data.get(group) or {}).get(key) or 1
            if not is_auto(size) and int(size) > 1:
                raise NotImplementedError(
                    f"{group}.{key}={size}: a mesh of more than one device is "
                    "not ported yet")
        accepted = tuple(k for k in ACCEPTED_WITHOUT_EFFECT if k in data)
        groups = {name: (group_from_dict(g, data.pop(name), name)
                         if data.get(name) is not None else data.pop(name))
                  for name, g in cls._GROUPS.items() if name in data}
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in data.items() if k in names}
        rest = {k: v for k, v in data.items()
                if k not in names and k not in ACCEPTED_WITHOUT_EFFECT
                and k not in {g for g, _ in _PARALLEL_DIMS}}
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
        if int(z.stage) > 0:
            raise NotImplementedError(f"zero_optimization.stage={z.stage}: "
                                      "ZeRO above stage 0 is not ported yet")
        if _offloads(z.offload_optimizer) or _offloads(z.offload_param):
            raise NotImplementedError("optimizer/parameter offload is not "
                                      "ported yet")
        if int(z.extra.get("mics_shard_size", -1) or -1) > 0:
            raise NotImplementedError("MiCS sharding is not ported yet")

    def resolve_batch_sizes(self, world_size: int = 1) -> None:
        """Infer the missing members of (train batch, micro batch, grad
        accumulation) and check ``train = micro x gas x world``
        (``resolve_batch_sizes`` of the JAX config, one data-parallel
        rank per device)."""
        dp = world_size
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

"""Inference engine v1: ``init_inference`` + KV-cache generation.

Counterpart of ``deepspeed_tpu/inference/engine.py`` (the reference's
``deepspeed.init_inference(model, ...) -> InferenceEngine`` with
``.generate``).  "Kernel injection" is the CUDA decode-attention kernel that
the model's ``decode_step`` calls.  Tensor-parallel inference
(``tensor_parallel={"tp_size": N}``) runs one process per rank: the engine
takes the model's mesh, or builds one over the joined process group
(joining it from the launcher's environment first) and splits a whole
model's weights in place (``LlamaModel.shard_``, the reference's AutoTP;
a Mixtral's expert stacks keep their ``I/tp`` FFN columns).  Each rank's
decode kernel then runs on its own heads, and every rank returns the same
tokens.  A model without ``shard_`` (OPT) is served whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..parallel.mesh import AXIS_TENSOR, MeshLayout
from ..utils import groups
from ..runtime.zero.sharder import refuse_cut
from ..utils.device import DeviceLike, check_module_device, resolve_device
from ..utils.logging import log_dist


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    tensor_parallel: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"tp_size": 1})
    #: the model's own ``config.dtype`` rules; kept for the reference's
    #: call shape and logged
    dtype: torch.dtype = torch.bfloat16
    replace_with_kernel_inject: bool = True  # the CUDA decode kernel
    max_out_tokens: int = 1024
    min_out_tokens: int = 1


class InferenceEngine:
    def __init__(self, model: torch.nn.Module,
                 config: DeepSpeedInferenceConfig,
                 device: DeviceLike = "cuda", mesh: Any = None):
        self.device = resolve_device(device)
        check_module_device(model, self.device)
        refuse_cut(model, "init_inference")
        tp = int(config.tensor_parallel.get("tp_size", 1))
        if tp > 1 and not hasattr(model, "shard_"):
            raise NotImplementedError(
                f"{type(model).__name__} under tensor parallelism is not "
                "ported yet (ROADMAP Queue 1 item 6b)")
        if tp > 1 and model.tp == 1:
            if mesh is None:
                from ..comm import comm
                comm.init_distributed(device=self.device)
                mesh = groups.initialize_mesh(MeshLayout.infer(tp=tp))
            model.shard_(mesh)
        if model.tp != tp or (mesh is not None
                              and mesh.shape[AXIS_TENSOR] != tp):
            raise ValueError(f"tp_size={tp}, but the model is split over "
                             f"{model.tp} ranks")
        self.module = model
        self.config = config
        self.mesh = model.mesh
        log_dist(f"init_inference: tp={tp} device={self.device} "
                 f"dtype={config.dtype} "
                 f"kernel_inject={config.replace_with_kernel_inject}")

    def __call__(self, input_ids: torch.Tensor, **kwargs) -> torch.Tensor:
        """Module passthrough: ``[B, S, V]`` logits."""
        return self.module(input_ids.to(self.device))

    def forward(self, input_ids: torch.Tensor, **kwargs) -> torch.Tensor:
        return self(input_ids, **kwargs)

    @torch.no_grad()
    def generate(self, input_ids: Any, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, eos_token_id: Optional[int] = None
                 ) -> torch.Tensor:
        """Greedy (``temperature=0``) or sampled generation with a KV cache.
        ``input_ids [B, S]`` → ``[B, S + max_new_tokens]`` int64 on the
        engine's device (after EOS a row repeats its last token).  Sampling
        draws from a ``torch.Generator`` seeded with ``seed``."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        B, S = ids.shape
        cache = self.module.init_cache(B, S + max_new_tokens)
        logits, cache = self.module.prefill(ids, cache)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = [ids]
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        last = None
        for i in range(max_new_tokens):
            if temperature > 0:
                scaled = logits / temperature
                if top_k > 0:
                    kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
                    scaled = scaled.masked_fill(scaled < kth, float("-inf"))
                tok = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                        generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            if eos_token_id is not None:
                if last is not None:
                    tok = torch.where(done, last, tok)
                done = done | (tok == eos_token_id)
            out.append(tok[:, None])
            last = tok
            if eos_token_id is not None and bool(done.all()):
                out.append(tok[:, None].expand(B, max_new_tokens - i - 1))
                break
            if i < max_new_tokens - 1:
                logits, cache = self.module.decode_step(cache, tok)
        return torch.cat(out, dim=1)


def init_inference(model: torch.nn.Module, config: Any = None,
                   tensor_parallel: Optional[Dict[str, Any]] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   replace_with_kernel_inject: bool = True,
                   max_out_tokens: int = 1024,
                   device: DeviceLike = "cuda",
                   mesh: Any = None) -> InferenceEngine:
    """The reference's call shape; ``model`` is one of the port's models,
    already holding its weights on ``device`` (whole, or split over
    ``mesh``'s tensor axis)."""
    if config is None:
        config = DeepSpeedInferenceConfig(
            tensor_parallel=tensor_parallel or {"tp_size": 1},
            dtype=dtype, replace_with_kernel_inject=replace_with_kernel_inject,
            max_out_tokens=max_out_tokens)
    elif isinstance(config, dict):
        config = DeepSpeedInferenceConfig(**config)
    return InferenceEngine(model, config, device=device, mesh=mesh)

"""Per-architecture model adapters for the v2 ragged serving engine.

Counterpart of ``deepspeed_tpu/inference/v2/adapters.py``: the engine owns
paging, scheduling and the two programs (chunked prefill, decode burst);
an adapter owns the architecture deltas.  Every hook works on flat token
batches ``[N, ...]`` with positions ``[N]``.  The Llama family (Llama and
Mixtral, whose routed FFN runs inside ``post_attn``) and OPT (learned
positions added at ``embed``, multi-head attention) are ported.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch


def make_adapter(model: Any) -> "ModelAdapterV2":
    """Pick the adapter for a model instance."""
    for cls in type(model).__mro__:
        if cls.__name__ in _REGISTRY:
            return _REGISTRY[cls.__name__](model)
    raise NotImplementedError(
        f"no v2 adapter for model class {type(model).__name__}; register "
        f"one in deepspeed_tpu_torch.inference.v2.adapters._REGISTRY")


class ModelAdapterV2:
    """Architecture hooks the engine calls inside its programs."""

    def __init__(self, model: Any):
        self.model = model
        self.config = model.config

    # -- static shape facts -------------------------------------------------

    @property
    def num_layers(self) -> int:
        return self.config.num_layers

    @property
    def num_heads(self) -> int:
        return self.config.num_heads

    @property
    def kv_heads(self) -> int:
        return getattr(self.config, "num_kv_heads", self.config.num_heads)

    @property
    def head_dim(self) -> int:
        return self.config.hd

    @property
    def dtype(self) -> torch.dtype:
        return self.config.dtype

    @property
    def window(self) -> Optional[int]:
        return getattr(self.config, "sliding_window", None)

    # -- hooks ----------------------------------------------------------------

    def layers(self) -> Sequence[Any]:
        """The per-layer modules, in order."""
        raise NotImplementedError

    def embed(self, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def qkv(self, layer: Any, x: torch.Tensor, positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x [N, H]`` → (q ``[N, h, d]``, k, v ``[N, kv_h, d]``) with any
        rotary encoding applied."""
        raise NotImplementedError

    def post_attn(self, layer: Any, x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
        """Output projection + residual + FFN block: ``[N, H]``."""
        raise NotImplementedError

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm over ``[N, H]``."""
        raise NotImplementedError

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """LM head: ``[N, H]`` → fp32 ``[N, V]``."""
        raise NotImplementedError


class LlamaV2Adapter(ModelAdapterV2):
    """Llama/Mistral family: RoPE, RMSNorm, biasless projections.  The head
    counts are this rank's under tensor parallelism."""

    @property
    def num_heads(self) -> int:
        return self.model.num_local_heads

    @property
    def kv_heads(self) -> int:
        return self.model.num_local_kv_heads

    def layers(self):
        return self.model.layers

    def embed(self, tokens, positions):
        del positions  # rotary: positions enter at qkv time
        return self.model.embed_tokens(tokens)

    def qkv(self, layer, x, positions):
        return self.model.qkv(layer, x, positions)

    def post_attn(self, layer, x, attn):
        return self.model.post_attn(layer, x, attn)

    def finalize(self, x):
        return self.model.finalize(x)

    def logits(self, x):
        return self.model.logits(x)


class OPTV2Adapter(ModelAdapterV2):
    """OPT family: learned absolute positions (+2 offset, clamped at the
    table's end), LayerNorm with bias, biased projections, ReLU MLP, tied
    head (``models/opt.py``)."""

    def layers(self):
        return self.model.layers

    def embed(self, tokens, positions):
        return self.model.embed_tokens(tokens, positions)

    def qkv(self, layer, x, positions):
        del positions  # learned positions were added at embed time
        return self.model.qkv(layer, x)

    def post_attn(self, layer, x, attn):
        return self.model.post_attn(layer, x, attn)

    def finalize(self, x):
        return self.model.finalize(x)

    def logits(self, x):
        return self.model.logits(x)


_REGISTRY = {"LlamaModel": LlamaV2Adapter,
             "MixtralModel": LlamaV2Adapter,
             "OPTModel": OPTV2Adapter}

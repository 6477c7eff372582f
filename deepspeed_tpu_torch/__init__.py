"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``deepspeed_tpu`` stays the reference; this package imports
``torch`` and numpy, never JAX or the JAX package.  Ported so far: the
serving path, from :func:`init_inference` and :func:`build_serving_frontend`
down to two hand-written CUDA kernels (padded-cache and paged decode
attention); the training path, from :func:`initialize` through
``engine.train_step`` down to three hand-written CUDA flash-attention
kernels (forward, dq pass, dk/dv pass) and, under ``kernels.fused_adam``,
a multi-tensor gradient norm and a fused Adam step; and Mixtral on both
paths, with hand-written CUDA MoE dispatch and combine kernels; and
block-sparse attention with its gradient (:mod:`.ops.sparse_attention`),
down to three hand-written CUDA kernels over the live tiles; and
tensor-parallel serving of the Llama family over ``torch.distributed``,
one process per rank (:func:`init_distributed`, :mod:`.comm`,
``utils.groups``, ``launcher.local``), with the paged kernel on each
rank's heads; and the int8 quantizer kernel; and data parallelism with
ZeRO stages 0-3 over ``torch.distributed`` (:mod:`.zero`: ``Init``,
``GatheredParameters``), one process per rank; and expert parallelism:
Mixtral trained on ``expert`` x ``data`` axes with the gate routing the
global micro-batch, served under tensor parallelism, and Residual-MoE
(:class:`MoE`); and the other ladder models: BERT (masked-LM training on
the flash kernels, non-causal with padding as segment ids), the CIFAR
ResNet, OPT (served on the decode and paged kernels), and the Hugging Face
checkpoint importers (``models.load_hf_*``).  Every
entry point runs on ``device="cuda"`` unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""

from . import comm
from .runtime import zero
from .comm import init_distributed
from .inference import init_inference
from .inference.v2 import KVCacheConfig, build_engine_v2
from .models import (BertConfig, BertModel, LlamaConfig, LlamaModel,
                     MixtralConfig, MixtralModel, OPTConfig, OPTModel,
                     ResNetConfig, ResNetModel, load_hf_bert, load_hf_llama,
                     load_hf_mistral, load_hf_mixtral, load_hf_opt)
from .moe import MoE
from .runtime import DeepSpeedConfig, DeepSpeedEngine, initialize
from .serving import ServingParams, build_serving_frontend

__all__ = ["BertConfig", "BertModel", "DeepSpeedConfig", "DeepSpeedEngine",
           "KVCacheConfig", "LlamaConfig", "LlamaModel", "MixtralConfig",
           "MixtralModel", "MoE", "OPTConfig", "OPTModel", "ResNetConfig",
           "ResNetModel", "ServingParams", "build_engine_v2",
           "build_serving_frontend", "comm", "init_distributed",
           "init_inference", "initialize", "load_hf_bert", "load_hf_llama",
           "load_hf_mistral", "load_hf_mixtral", "load_hf_opt", "zero"]

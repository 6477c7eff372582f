"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``deepspeed_tpu`` stays the reference; this package imports
``torch`` and numpy, never JAX or the JAX package.  Ported so far: the
serving path, from :func:`init_inference` and :func:`build_serving_frontend`
down to two hand-written CUDA kernels (padded-cache and paged decode
attention), and the training path, from :func:`initialize` through
``engine.train_step`` down to three hand-written CUDA flash-attention
kernels (forward, dq pass, dk/dv pass).  Every entry point runs on
``device="cuda"`` unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run.
"""

from .inference import init_inference
from .inference.v2 import KVCacheConfig, build_engine_v2
from .models import LlamaConfig, LlamaModel
from .runtime import DeepSpeedConfig, DeepSpeedEngine, initialize
from .serving import ServingParams, build_serving_frontend

__all__ = ["DeepSpeedConfig", "DeepSpeedEngine", "KVCacheConfig",
           "LlamaConfig", "LlamaModel", "ServingParams", "build_engine_v2",
           "build_serving_frontend", "init_inference", "initialize"]

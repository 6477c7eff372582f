"""Sequence parallelism (Ulysses and ring) and ALST's tiled compute.

Counterpart of ``deepspeed_tpu/runtime/sequence_parallel`` (the
reference's ``deepspeed/runtime/sequence_parallel/ulysses_sp.py`` and the
legacy ``deepspeed/sequence/layer.py``).  Each rank of the ``seq`` axis
holds one contiguous chunk of every row's sequence; the functions here take
and return that chunk.
"""

from .ring import ring_attention
from .ulysses_sp import (SequenceTiledCompute, TiledMLP, UlyssesSPAttentionHF,
                         UlyssesSPDataLoaderAdapter, sequence_tiled_loss,
                         ulysses_attention)

__all__ = [
    "ulysses_attention", "ring_attention", "UlyssesSPAttentionHF",
    "UlyssesSPDataLoaderAdapter", "SequenceTiledCompute", "TiledMLP",
    "sequence_tiled_loss",
]

"""The hybrid engine: one engine for RLHF's train and generate phases.

Counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py``
(``DeepSpeedHybridEngine``, the reference's ``deepspeed/runtime/
hybrid_engine.py``).  ``initialize`` returns it when the config's
``hybrid_engine.enabled`` is true.  The training API passes through to the
wrapped ``DeepSpeedEngine``; :meth:`DeepSpeedHybridEngine.generate` runs
the module's own KV-cache path (``init_cache``, ``prefill``,
``decode_step``: decode kernel #1 on the card) on the parameters the
engine updates in place, so a generation after a ``train_step`` sees the
new weights with no copy.  Under ZeRO-3 the module reads its cut weights
through ``runtime/zero/sharder.compute_weight``, which gathers them (every
rank of the data-parallel group calls ``generate`` alike); under tensor
parallelism each rank decodes its own heads, as ``init_inference`` does
(every tensor rank calls it with the same inputs).  The JAX engine's jit
caches have no counterpart: the programs run eagerly.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from ..utils.logging import log_dist

#: how often (in generated tokens) the all-done check reads the device
EOS_CHECK_EVERY = 8


class DeepSpeedHybridEngine:
    """A training engine with a weight-sharing generate path."""

    def __init__(self, engine: Any, max_out_tokens: int = 512):
        if not callable(getattr(engine.module, "prefill", None)):
            raise TypeError("hybrid engine needs a model with prefill/"
                            f"decode_step (got {type(engine.module)})")
        if engine.infinity is not None:
            raise NotImplementedError(
                "hybrid_engine with zero_optimization.offload_param is not "
                "ported: the streamed trunk never holds its weights on the "
                "card")
        self.engine = engine
        self.module = engine.module
        self.max_out_tokens = int(max_out_tokens)
        self._gen_tokens = 0
        self._gen_time = 0.0
        self._train_time = 0.0

    # -- train passthrough ---------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        # anything not defined here is the training engine's surface
        return getattr(self.__dict__["engine"], name)

    def train_step(self, batch: Any) -> Dict[str, Any]:
        t0 = time.perf_counter()
        out = self.engine.train_step(batch)
        self._train_time += time.perf_counter() - t0
        return out

    # -- generate phase --------------------------------------------------------

    @torch.no_grad()
    def generate(self, input_ids: Any, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
        """Greedy (``temperature == 0``) or sampled generation on the
        engine's current weights: ``input_ids [B, S]`` → ``[B, S +
        max_new]`` int64 on the engine's device.  Sampling draws from a
        ``torch.Generator`` seeded with ``seed`` (``top_k`` above 0 keeps
        the k largest logits).  With ``eos_token_id`` a finished row
        repeats its last token, and every ``EOS_CHECK_EVERY`` tokens one
        read of the device ends the loop when every row is done (the rest
        padded with the last tokens), as the JAX engine does."""
        max_new = int(max_new_tokens or self.max_out_tokens)
        dev = self.engine.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        B, S = ids.shape
        t0 = time.perf_counter()
        cache = self.module.init_cache(B, S + max_new)
        logits, cache = self.module.prefill(ids, cache)
        gen = torch.Generator(device=dev).manual_seed(seed)
        out: List[torch.Tensor] = [ids]
        last = None
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        # counted on the device: no host read inside the loop
        produced = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(max_new):
            if temperature > 0:
                scaled = logits / temperature
                if top_k > 0:
                    kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
                    scaled = scaled.masked_fill(scaled < kth, float("-inf"))
                tok = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                        generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            if eos_token_id is not None and last is not None:
                tok = torch.where(done, last, tok)
            produced += B - done.sum()
            out.append(tok[:, None])
            last = tok
            if eos_token_id is not None:
                done = done | (tok == eos_token_id)
                if (i + 1) % EOS_CHECK_EVERY == 0 and bool(done.all()):
                    out.append(tok[:, None].expand(B, max_new - i - 1))
                    break
            if i < max_new - 1:
                logits, cache = self.module.decode_step(cache, tok)
        result = torch.cat(out, dim=1)
        self._gen_tokens += int(produced)  # one read, after the loop
        self._gen_time += time.perf_counter() - t0
        return result

    # -- the reference's other surface -----------------------------------------

    def eval(self) -> "DeepSpeedHybridEngine":
        self.engine.eval()
        return self

    def train(self, mode: bool = True) -> "DeepSpeedHybridEngine":
        self.engine.train(mode)
        return self

    def release_inference_cache(self) -> None:
        """The reference drops its inference buffers between phases; here
        the caches are locals of each ``generate``, so nothing is held."""

    def print_latency_log(self) -> None:
        tps = self._gen_tokens / self._gen_time if self._gen_time else 0.0
        log_dist(f"hybrid engine: generated {self._gen_tokens} tokens "
                 f"({tps:.1f} tok/s), train time {self._train_time:.2f}s, "
                 f"generate time {self._gen_time:.2f}s")

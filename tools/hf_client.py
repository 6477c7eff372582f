"""A Hugging-Face-shaped causal LM of plain ``nn.Module`` s with no split of
its own: the client that AutoTP's name policy (``deepspeed_tpu_torch.
runtime.tensor_parallel.auto_tp``) splits in the CPU tests
(``tests/torch_tp_ranks.py``) and in ``chip_smoke.py``'s train_tp agreement.

``embed_tokens``, ``layers.{i}.self_attn.{q,k,v,o}_proj`` (with biases and
the head counts the attention reshapes by), ``layers.{i}.mlp.{gate,up,
down}_proj``, ``norm`` and ``lm_head``; ``loss`` is the next-token cross
entropy over the whole logits.  fp32, drawn on the host from
``torch.manual_seed(seed)`` (move it with ``.to(device)``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

#: the CPU tests' widths
CLIENT = dict(vocab=512, H=64, heads=4, kv_heads=2, inter=128, layers=2)


class ClientAttention(nn.Module):
    """Causal GQA attention in Hugging Face's layout and names; reshapes
    by its own head counts."""

    def __init__(self, H: int, heads: int, kv_heads: int):
        super().__init__()
        self.num_heads, self.num_key_value_heads = heads, kv_heads
        self.head_dim = H // heads
        self.q_proj = nn.Linear(H, heads * self.head_dim)
        self.k_proj = nn.Linear(H, kv_heads * self.head_dim)
        self.v_proj = nn.Linear(H, kv_heads * self.head_dim)
        self.o_proj = nn.Linear(heads * self.head_dim, H)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(B, S, self.num_key_value_heads,
                                self.head_dim)
        v = self.v_proj(x).view(B, S, self.num_key_value_heads,
                                self.head_dim)
        rep = self.num_heads // self.num_key_value_heads
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / self.head_dim ** 0.5
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.o_proj(out.reshape(B, S, self.num_heads
                                       * self.head_dim))


class ClientMLP(nn.Module):
    def __init__(self, H: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(H, inter, bias=False)
        self.up_proj = nn.Linear(H, inter, bias=False)
        self.down_proj = nn.Linear(inter, H)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x))
                              * self.up_proj(x))


class ClientBlock(nn.Module):
    def __init__(self, H: int, heads: int, kv_heads: int, inter: int):
        super().__init__()
        self.input_layernorm = nn.LayerNorm(H)
        self.self_attn = ClientAttention(H, heads, kv_heads)
        self.post_attention_layernorm = nn.LayerNorm(H)
        self.mlp = ClientMLP(H, inter)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class ClientLM(nn.Module):
    """The client at ``widths`` (the keys of :data:`CLIENT`)."""

    def __init__(self, seed: int = 0, widths: Dict[str, int] = CLIENT):
        super().__init__()
        c = widths
        torch.manual_seed(seed)
        self.embed_tokens = nn.Embedding(c["vocab"], c["H"])
        self.layers = nn.ModuleList(
            ClientBlock(c["H"], c["heads"], c["kv_heads"], c["inter"])
            for _ in range(c["layers"]))
        self.norm = nn.LayerNorm(c["H"])
        self.lm_head = nn.Linear(c["H"], c["vocab"], bias=False)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.lm_head(self.norm(x))

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ids = batch["input_ids"]
        logits = self(ids)[:, :-1]
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))

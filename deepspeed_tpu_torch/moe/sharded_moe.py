"""Top-k gating and the MoE layer in PyTorch, on one device.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py``: the GShard/Switch
top-1/top-2 gate with capacity, token dropping and the load-balancing aux
loss, one routing core (:func:`_gating_core`) read out in two forms:

* dense (:func:`top_k_gating`): one-hot ``[T, E, C]`` combine weights and
  dispatch mask, contracted with einsums;
* index (:func:`top_k_gating_indices`): per choice, the expert, the slot,
  whether the assignment survived capacity, and its renormalised gate,
  which ``ops/kernels/moe_dispatch.py`` turns into row gathers.

:class:`MOELayer` runs one of three rungs (``choose_dispatch_impl``):
``dense``, ``sparse`` (the gathers' plain versions) or ``pallas`` (the
hand-written CUDA dispatch and combine kernels; the name is kept so that
configs carry over).  Router logits are fp32; ``argmax`` takes the first
maximum; second choices queue behind every first choice; gates are
renormalised after the capacity filter.  ``noisy_gate_policy="RSample"``
and random token selection draw from a ``torch.Generator`` passed as
``noise_rng`` (the same generator: the noise first, then the priority
permutation), so their bits differ from ``jax.random``'s.  The expert mesh
(``_constrain``, ``pad_to_ep``) and the memory-ledger registration are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels.moe_dispatch import (choose_dispatch_impl,
                                        combine_reference,
                                        dispatch_reference, moe_combine,
                                        moe_dispatch, routing_to_indices)

Tensor = torch.Tensor


class GateMeta(dict):
    """Gate metadata; ``np.asarray(meta)`` gives the per-expert assignment
    counts (the bare ``exp_counts`` older callers received)."""

    def __array__(self, dtype=None, copy=None):
        a = self["exp_counts"].detach().cpu().numpy()
        return a.astype(dtype) if dtype is not None else a


@dataclasses.dataclass
class GateIndices:
    """The routing decision in index form: per choice k and token t, the
    expert, the slot within it, whether the assignment survived capacity,
    and the renormalised combine weight (zero when dropped)."""

    expert_idx: Tensor  # [K, T] int32
    slot: Tensor        # [K, T] int32
    keep: Tensor        # [K, T] bool
    gate: Tensor        # [K, T] fp32
    capacity: int
    num_experts: int


def _one_hot(idx: Tensor, num: int) -> Tensor:
    return F.one_hot(idx.long(), num).float()


def _gating_core(logits: Tensor, k: int, capacity: int,
                 noise_rng: Optional[torch.Generator],
                 noisy_gate_policy: Optional[str], drop_tokens: bool,
                 rts_rng: Optional[torch.Generator]) -> Dict[str, Any]:
    """The one top-k routing computation both output forms are built from:
    softmax ``gates``, per-choice one-hot ``masks`` (capacity-filtered when
    ``drop_tokens``), ``positions`` (slot within the chosen expert),
    ``within`` (slot < capacity), expert ``idxs``, renormalised ``gate_k``,
    ``l_aux`` and the metadata."""
    if k not in (1, 2):
        raise ValueError(f"k must be 1 or 2, got {k}")
    T, E = logits.shape
    C = capacity

    route_logits = logits
    if noisy_gate_policy == "RSample" and noise_rng is not None:
        route_logits = logits + torch.randn(
            logits.shape, generator=noise_rng, device=logits.device,
            dtype=logits.dtype)
    gates = torch.softmax(logits.float(), dim=-1)  # [T, E]

    idx1 = torch.argmax(route_logits, dim=-1)  # the first maximum
    mask1 = _one_hot(idx1, E)

    # load-balancing aux loss (Switch eq. 4): E · Σ_e mean gate · share
    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).sum() * E

    masks, idxs = [mask1], [idx1]
    if k == 2:
        logits2 = torch.where(mask1.bool(), float("-inf"), route_logits)
        idx2 = torch.argmax(logits2, dim=-1)
        masks.append(_one_hot(idx2, E))
        idxs.append(idx2)

    # capacity priority: arrival order, or a random permutation (RTS)
    perm = inv = None
    if rts_rng is not None:
        perm = torch.randperm(T, generator=rts_rng, device=logits.device)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(T, device=logits.device)

    # slot within each expert: a running count over tokens in priority
    # order; second choices queue behind all first choices
    positions: List[Tensor] = []
    offset = torch.zeros(E, dtype=torch.float32, device=logits.device)
    for m in masks:
        mp = m[perm] if perm is not None else m
        loc = torch.cumsum(mp, dim=0) - mp + offset[None, :]
        offset = offset + mp.sum(dim=0)
        pos = (loc * mp).sum(dim=-1)
        positions.append(pos[inv] if inv is not None else pos)

    exp_counts = masks[0].sum(dim=0)  # pre-drop assignment counts

    # routing telemetry from the pre-capacity state
    load = exp_counts / max(float(T), 1.0)
    entropy = -(me * torch.log(me.clamp(min=1e-9))).sum()
    assigned = sum(m.sum() for m in masks)
    overflowed = sum((m * (pos >= C).to(m.dtype)[:, None]).sum()
                     for m, pos in zip(masks, positions))
    overflow_frac = overflowed / assigned.clamp(min=1.0)

    within = [pos < C for pos in positions]

    # filter by capacity BEFORE renormalising: a token whose second choice
    # is dropped keeps its full weight on the first
    if drop_tokens:
        masks = [m * w.to(m.dtype)[:, None] for m, w in zip(masks, within)]

    denom = sum((gates * m).sum(dim=-1) for m in masks).clamp(min=1e-9)
    gate_k = [(gates * m).sum(dim=-1) / denom for m in masks]

    meta = GateMeta({"l_aux": l_aux, "exp_counts": exp_counts, "load": load,
                     "entropy": entropy, "overflow_frac": overflow_frac})
    return dict(gates=gates, masks=masks, positions=positions, within=within,
                idxs=idxs, gate_k=gate_k, l_aux=l_aux, meta=meta, T=T, E=E,
                C=C, k=k)


def top_k_gating(logits: Tensor, k: int, capacity: int,
                 noise_rng: Optional[torch.Generator] = None,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True,
                 rts_rng: Optional[torch.Generator] = None
                 ) -> Tuple[Tensor, Tensor, Tensor, GateMeta]:
    """GShard top-k gating over ``[T, E]`` router logits → ``(combine
    weights [T, E, C] fp32, dispatch mask [T, E, C] bool, l_aux, meta)``."""
    core = _gating_core(logits, k, capacity, noise_rng, noisy_gate_policy,
                        drop_tokens, rts_rng)
    T, E, C = core["T"], core["E"], core["C"]
    dev = logits.device
    combine = torch.zeros(T, E, C, dtype=torch.float32, device=dev)
    dispatch = torch.zeros(T, E, C, dtype=torch.bool, device=dev)
    slots = torch.arange(C, device=dev)
    for m, pos, g in zip(core["masks"], core["positions"], core["gate_k"]):
        # a position past capacity matches no slot (m is zero there too)
        pos_oh = (pos.long()[:, None] == slots[None, :]).float()
        contrib = m[:, :, None] * pos_oh[:, None, :]
        combine = combine + g[:, None, None] * contrib
        dispatch = dispatch | (contrib > 0)
    meta = core["meta"]
    meta["drop_rate"] = 1.0 - (combine > 0).sum() / max(k * T, 1)
    return combine, dispatch, core["l_aux"], meta


def top_k_gating_indices(logits: Tensor, k: int, capacity: int,
                         noise_rng: Optional[torch.Generator] = None,
                         noisy_gate_policy: Optional[str] = None,
                         drop_tokens: bool = True,
                         rts_rng: Optional[torch.Generator] = None
                         ) -> Tuple[GateIndices, Tensor, GateMeta]:
    """:func:`top_k_gating` in index form: the same routing decision,
    returned as ``(GateIndices, l_aux, meta)``."""
    core = _gating_core(logits, k, capacity, noise_rng, noisy_gate_policy,
                        drop_tokens, rts_rng)
    T, E, C, kk = core["T"], core["E"], core["C"], core["k"]
    expert_idx = torch.stack([i.to(torch.int32) for i in core["idxs"]])
    slot = torch.stack([p.to(torch.int32) for p in core["positions"]])
    # an assignment lands iff its (filtered) mask row is live and its slot
    # is within capacity: the dense contribution's support
    keep = torch.stack([(m.sum(dim=-1) > 0) & w
                        for m, w in zip(core["masks"], core["within"])])
    gate = torch.stack(core["gate_k"])
    meta = core["meta"]
    kept = sum(((g > 0) & kp).sum() for g, kp in zip(core["gate_k"], keep))
    meta["drop_rate"] = 1.0 - kept / max(kk * T, 1)
    gi = GateIndices(expert_idx=expert_idx, slot=slot, keep=keep, gate=gate,
                     capacity=C, num_experts=E)
    return gi, core["l_aux"], meta


@dataclasses.dataclass
class TopKGate:
    """Router configuration (the reference ``TopKGate`` constructor keys);
    the router weight ``wg [H, E]`` lives with the caller."""

    num_experts: int
    k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_rts: bool = False

    def capacity(self, num_tokens: int, train: bool = True) -> int:
        """``max(ceil(k · T · factor / E), min_capacity)``."""
        f = self.capacity_factor if train else self.eval_capacity_factor
        cap = int(math.ceil(self.k * num_tokens * f / self.num_experts))
        return max(cap, self.min_capacity)

    def _rts_rng(self, noise_rng: Optional[torch.Generator],
                 train: bool) -> Optional[torch.Generator]:
        return noise_rng if self.use_rts and train else None

    def _logits(self, wg: Tensor, x: Tensor) -> Tensor:
        return x.float() @ wg.float()

    def __call__(self, wg: Tensor, x: Tensor, train: bool = True,
                 noise_rng: Optional[torch.Generator] = None):
        """``x [T, H]`` → the dense gating tensors (:func:`top_k_gating`)."""
        return top_k_gating(self._logits(wg, x), self.k,
                            self.capacity(x.shape[0], train),
                            noise_rng=noise_rng,
                            noisy_gate_policy=(self.noisy_gate_policy
                                               if train else None),
                            drop_tokens=self.drop_tokens,
                            rts_rng=self._rts_rng(noise_rng, train))

    def route(self, wg: Tensor, x: Tensor, train: bool = True,
              noise_rng: Optional[torch.Generator] = None
              ) -> Tuple[GateIndices, Tensor, GateMeta]:
        """The index form of :meth:`__call__`."""
        return top_k_gating_indices(
            self._logits(wg, x), self.k, self.capacity(x.shape[0], train),
            noise_rng=noise_rng,
            noisy_gate_policy=self.noisy_gate_policy if train else None,
            drop_tokens=self.drop_tokens,
            rts_rng=self._rts_rng(noise_rng, train))


class MOELayer:
    """The MoE layer (reference ``MOELayer``) on one device.

    ``expert_fn(expert_params, x)`` maps ``[E, C, H] → [E, C, H]`` with
    expert-stacked params (leading dim E).  ``dispatch_impl``: ``auto`` |
    ``dense`` | ``sparse`` | ``pallas`` (see ``choose_dispatch_impl``).
    """

    def __init__(self, gate: TopKGate,
                 expert_fn: Callable[[Any, Tensor], Tensor],
                 dispatch_impl: str = "auto"):
        self.gate = gate
        self.expert_fn = expert_fn
        self.dispatch_impl = dispatch_impl
        #: the rung the last call resolved to
        self.last_impl: Optional[str] = None

    def __call__(self, wg: Tensor, expert_params: Any, x: Tensor,
                 train: bool = True,
                 noise_rng: Optional[torch.Generator] = None
                 ) -> Tuple[Tensor, Tensor, GateMeta]:
        """``x [..., H]`` (every leading position a token) → ``(y [..., H],
        l_aux, meta)``."""
        H = x.shape[-1]
        tokens = x.reshape(-1, H)
        T, E = tokens.shape[0], self.gate.num_experts
        C = self.gate.capacity(T, train)
        impl = choose_dispatch_impl(self.dispatch_impl, T, E, C,
                                    device=x.device)
        dtype = x.dtype
        if impl == "dense":
            combine, dispatch, l_aux, meta = self.gate(wg, tokens, train,
                                                       noise_rng)
            expert_in = torch.einsum("tec,th->ech", dispatch.to(dtype),
                                     tokens)
            expert_out = self.expert_fn(expert_params, expert_in)
            y = torch.einsum("tec,ech->th", combine.to(dtype), expert_out)
        else:
            gi, l_aux, meta = self.gate.route(wg, tokens, train, noise_rng)
            src_idx, flat_idx = routing_to_indices(
                gi.expert_idx, gi.slot, gi.keep, E, C)
            gates_tk = gi.gate.t()  # [T, K]
            if impl == "pallas":
                expert_in = moe_dispatch(tokens.contiguous(), src_idx)
                expert_out = self.expert_fn(expert_params, expert_in)
                y = moe_combine(expert_out.contiguous(), flat_idx,
                                   gates_tk)
            else:
                expert_in = dispatch_reference(tokens, src_idx)
                expert_out = self.expert_fn(expert_params, expert_in)
                y = combine_reference(expert_out, flat_idx, gates_tk)
            y = y.to(dtype)
        self.last_impl = impl
        return y.reshape(x.shape), l_aux, GateMeta(meta)

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
permutation), so their bits differ from ``jax.random``'s.

Expert, data and sequence parallelism (``MOELayer(mesh=...)`` on a
process mesh whose data-parallel axes ``(expert, data)`` or ``seq`` exceed
1): JAX routes the global micro-batch under GSPMD, so capacity, slots,
drops and ``l_aux`` are functions of every rank's tokens, in the global
``(b, s)`` order.  The port runs one process a rank and makes that
decision explicit:

1. this rank's fp32 router logits ``[T_loc, E]`` are all-gathered over the
   data-parallel axes and ``seq`` (:func:`routing_group`) and put in the
   global order by :func:`global_token_ids`: a rank holds its data
   coordinate's rows (expert-major: the order in which JAX shards the
   batch over ``("expert", "data")``), and under ``seq`` only its
   ``S/sp`` chunk of each, so its tokens are not contiguous in that
   order.  The one routing core runs on ``[T_glob, E]``: every rank holds
   the same capacity (padded to a multiple of the expert axis), slots,
   drops and ``l_aux``;
2. the global indices become this rank's view (:func:`local_routing`,
   through the rank's global token ids): a slot filled by another rank's
   token is ``EMPTY_SLOT``, a local token's id is its row on this rank,
   and the combine reads this rank's rows of ``flat_idx``;
3. the dispatch fills a local ``[E, C, H]``, which is reduce-scattered over
   the ``expert`` group along E (each slot has one writer, so the sum is
   exact): ``[E/ep, C, H]``, this coordinate's experts over the tokens of
   its expert group (the ranks that share its data, ``seq`` and
   ``tensor`` coordinates); the experts run on it and their output is
   all-gathered back over the ``expert`` group before the combine.

The collectives are autograd Functions, each the other's backward; the
logits' all-gather sums its cotangents back (the permutation into the
global order is an index, whose backward autograd undoes), so every
rank's copy of ``l_aux`` contributes: the engine's division by ``gas x
dp`` leaves the global gradient, and a model under ``seq`` counts its
``l_aux`` ``1/sp`` a rank (``LlamaModel.loss``).  The rows of other
groups' slots are zeros that the experts still compute, as JAX's GSPMD
plan does on its data replicas.  The memory-ledger registration
(telemetry) is not ported; where JAX's ``_constrain`` would drop a
constraint and warn, an E that does not divide over the expert axis
raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..comm import comm
from ..ops.kernels.moe_dispatch import (EMPTY_SLOT, choose_dispatch_impl,
                                        combine_reference,
                                        dispatch_reference, moe_combine,
                                        moe_dispatch, routing_to_indices)
from ..parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR,
                             DP_AXES)
from ..utils import groups

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
    the router weight ``wg [H, E]`` lives with the caller.  With a ``mesh``
    whose ``expert`` axis exceeds 1, :meth:`capacity` rounds up to a
    multiple of it (``pad_to_ep``; False keeps the reference formula)."""

    num_experts: int
    k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_rts: bool = False
    pad_to_ep: bool = True
    mesh: Optional[Any] = None

    def _ep_size(self) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get(AXIS_EXPERT, 1))

    def capacity(self, num_tokens: int, train: bool = True) -> int:
        """``max(ceil(k · T · factor / E), min_capacity)``, padded up to a
        multiple of the expert axis."""
        f = self.capacity_factor if train else self.eval_capacity_factor
        cap = int(math.ceil(self.k * num_tokens * f / self.num_experts))
        cap = max(cap, self.min_capacity)
        ep = self._ep_size()
        if self.pad_to_ep and ep > 1:
            cap = -(-cap // ep) * ep
        return cap

    def _rts_rng(self, noise_rng: Optional[torch.Generator],
                 train: bool) -> Optional[torch.Generator]:
        return noise_rng if self.use_rts and train else None

    def _logits(self, wg: Tensor, x: Tensor) -> Tensor:
        return x.float() @ wg.float()

    def _kw(self, logits: Tensor, train: bool,
            noise_rng: Optional[torch.Generator]) -> Dict[str, Any]:
        return dict(k=self.k, capacity=self.capacity(logits.shape[0], train),
                    noise_rng=noise_rng,
                    noisy_gate_policy=(self.noisy_gate_policy if train
                                       else None),
                    drop_tokens=self.drop_tokens,
                    rts_rng=self._rts_rng(noise_rng, train))

    def gating(self, logits: Tensor, train: bool = True,
               noise_rng: Optional[torch.Generator] = None):
        """Router logits ``[T, E]`` → the dense gating tensors."""
        return top_k_gating(logits, **self._kw(logits, train, noise_rng))

    def route_logits(self, logits: Tensor, train: bool = True,
                     noise_rng: Optional[torch.Generator] = None
                     ) -> Tuple[GateIndices, Tensor, GateMeta]:
        """Router logits ``[T, E]`` → the routing in index form."""
        return top_k_gating_indices(logits,
                                    **self._kw(logits, train, noise_rng))

    def __call__(self, wg: Tensor, x: Tensor, train: bool = True,
                 noise_rng: Optional[torch.Generator] = None):
        """``x [T, H]`` → the dense gating tensors (:func:`top_k_gating`)."""
        return self.gating(self._logits(wg, x), train, noise_rng)

    def route(self, wg: Tensor, x: Tensor, train: bool = True,
              noise_rng: Optional[torch.Generator] = None
              ) -> Tuple[GateIndices, Tensor, GateMeta]:
        """The index form of :meth:`__call__`."""
        return self.route_logits(self._logits(wg, x), train, noise_rng)


class _AllGather(torch.autograd.Function):
    """Forward: every rank's block concatenated along dim 0 over
    ``group``; backward: the cotangent summed over the group, this rank's
    block of it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: Tensor, group: Any) -> Tensor:
        ctx.group = group
        return comm.all_gather(x, group=group, dim=0)

    @staticmethod
    def backward(ctx, g: Tensor):
        return comm.reduce_scatter(g, group=ctx.group, dim=0), None


class _ReduceScatter(torch.autograd.Function):
    """Forward: the sum over ``group``, this rank's block along dim 0;
    backward: the blocks' cotangents all-gathered."""

    @staticmethod
    def forward(ctx, x: Tensor, group: Any) -> Tensor:
        ctx.group = group
        return comm.reduce_scatter(x, group=group, dim=0)

    @staticmethod
    def backward(ctx, g: Tensor):
        return comm.all_gather(g, group=ctx.group, dim=0), None


class MOELayer:
    """The MoE layer (reference ``MOELayer``).

    ``expert_fn(expert_params, x)`` maps ``[E', C, H] → [E', C, H]`` with
    expert-stacked params (leading dim E', this rank's experts: E / ep).
    ``dispatch_impl``: ``auto`` | ``dense`` | ``sparse`` | ``pallas`` (see
    ``choose_dispatch_impl``; chosen from the global token count, so every
    rank takes the same rung).  ``mesh``: a process mesh; when its
    data-parallel axes or ``seq`` exceed 1 the gate routes the global
    micro-batch and the experts are exchanged over the ``expert`` axis
    (module docstring).
    ``expert_tensor_parallel``: the owner splits the experts' FFN dim over
    the mesh's ``tensor`` axis and sums their outputs over it (Megatron's
    *g*); the tokens into the dispatch and the gates into the combine then
    pass *f*.
    """

    def __init__(self, gate: TopKGate,
                 expert_fn: Callable[[Any, Tensor], Tensor],
                 mesh: Optional[Any] = None, dispatch_impl: str = "auto",
                 expert_tensor_parallel: bool = False):
        self.gate = gate
        self.expert_fn = expert_fn
        self.mesh = mesh
        if gate.mesh is None:
            gate.mesh = mesh  # the capacity's pad sees the expert axis
        self.dispatch_impl = dispatch_impl
        self.expert_tensor_parallel = expert_tensor_parallel
        #: the rung and the capacity of the last call, and its routing
        #: over the global tokens (the index rungs; None after a dense one)
        self.last_impl: Optional[str] = None
        self.last_capacity: Optional[int] = None
        self.last_routing: Optional[GateIndices] = None

    def _dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(int(self.mesh.shape.get(a, 1)) for a in DP_AXES)

    def _sp_size(self) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get(AXIS_SEQ, 1))

    def _experts(self, expert_params: Any, expert_in: Tensor) -> Tensor:
        """The experts over ``[E, C, H]``: with an ``expert`` axis above 1,
        this coordinate's ``E/ep`` experts over the sum of its group's
        buffers, the outputs gathered back to ``[E, C, H]``."""
        ep = self.gate._ep_size()
        if ep == 1:
            return self.expert_fn(expert_params, expert_in)
        group = self.mesh.group(AXIS_EXPERT)
        mine = _ReduceScatter.apply(expert_in, group)
        return _AllGather.apply(self.expert_fn(expert_params, mine), group)

    def _tensor_copy(self) -> Callable[[Tensor], Tensor]:
        """Megatron's *f* over the ``tensor`` group when the experts are
        split over it (else the identity).  The replicated router's
        gradient then sums every rank's partial expert outputs' share
        once, and the aux loss's is added once: both are whole and equal
        on every tensor rank."""
        if not self.expert_tensor_parallel or self.mesh is None or \
                int(self.mesh.shape.get(AXIS_TENSOR, 1)) == 1:
            return lambda t: t
        group = self.mesh.group(AXIS_TENSOR)
        return lambda t: comm.tp_copy(t, group)

    def __call__(self, wg: Tensor, expert_params: Any, x: Tensor,
                 train: bool = True,
                 noise_rng: Optional[torch.Generator] = None
                 ) -> Tuple[Tensor, Tensor, GateMeta]:
        """``x [..., H]`` (every leading position a token; this rank's rows
        on a mesh, under ``seq`` ``[..., S/sp, H]``: its chunk of them) →
        ``(y [..., H], l_aux, meta)``; on a mesh ``l_aux`` and ``meta`` are
        the global micro-batch's, equal on every rank."""
        H = x.shape[-1]
        tokens = x.reshape(-1, H)
        E = self.gate.num_experts
        ep = self.gate._ep_size()
        if E % ep:
            raise ValueError(f"num_experts ({E}) does not split over the "
                             f"expert axis ({ep})")
        logits = self.gate._logits(wg, tokens)
        ids = None  # this rank's tokens' places in the global order
        if self._dp_size() * self._sp_size() > 1:
            ids, order = global_token_ids(self.mesh, x.shape)
            logits = _AllGather.apply(logits, routing_group(self.mesh))
            logits = logits.index_select(0, order.to(logits.device))
            ids = ids.to(x.device)
        T = logits.shape[0]
        C = self.gate.capacity(T, train)
        f = self._tensor_copy()
        impl = choose_dispatch_impl(self.dispatch_impl, T, E, C,
                                    device=x.device)
        dtype = x.dtype
        if impl == "dense":
            combine, dispatch, l_aux, meta = self.gate.gating(
                logits, train, noise_rng)
            self.last_routing = None
            rows = ids if ids is not None else slice(None)
            expert_in = torch.einsum("tec,th->ech",
                                     dispatch[rows].to(dtype), f(tokens))
            expert_out = self._experts(expert_params, expert_in)
            y = torch.einsum("tec,ech->th", f(combine[rows].to(dtype)),
                             expert_out)
        else:
            gi, l_aux, meta = self.gate.route_logits(logits, train,
                                                     noise_rng)
            self.last_routing = gi
            src_idx, flat_idx = routing_to_indices(
                gi.expert_idx, gi.slot, gi.keep, E, C)
            gates_tk = gi.gate.t()  # [T, K]
            if ids is not None:  # this rank's view of the global routing
                src_idx, flat_idx, gates_tk = local_routing(
                    src_idx, flat_idx, gates_tk, ids)
            gates_tk, disp = f(gates_tk), f(tokens)
            if impl == "pallas":
                expert_in = moe_dispatch(disp.contiguous(), src_idx)
                expert_out = self._experts(expert_params, expert_in)
                y = moe_combine(expert_out.contiguous(), flat_idx, gates_tk)
            else:
                expert_in = dispatch_reference(disp, src_idx)
                expert_out = self._experts(expert_params, expert_in)
                y = combine_reference(expert_out, flat_idx, gates_tk)
            y = y.to(dtype)
        self.last_impl, self.last_capacity = impl, C
        return y.reshape(x.shape), l_aux, GateMeta(meta)


def routing_group(mesh: Any) -> Any:
    """The group a MoE layer routes over: the data-parallel axes and, on
    a mesh whose ``seq`` axis exceeds 1, ``seq`` (the ranks that share
    this rank's ``tensor`` and ``pipe`` coordinates)."""
    if int(mesh.shape.get(AXIS_SEQ, 1)) > 1:
        return groups.axes_group(DP_AXES + (AXIS_SEQ,), mesh)
    return mesh.group(*DP_AXES)


def global_token_ids(mesh: Any, shape: Tuple[int, ...]
                     ) -> Tuple[Tensor, Tensor]:
    """``(ids, order)`` for activations of ``shape [..., H]`` on ``mesh``:
    ``ids`` the places of this rank's tokens in the global ``(b, s)``
    order, ``order`` the rows of the :func:`routing_group` all-gather (its
    ranks' blocks in rank order: expert, data, then ``seq``) that put it in
    that order.  A rank's data-parallel index ``q = expert·dp + data``
    holds global rows ``[q·B, (q+1)·B)``; under ``seq`` (``shape [..., n,
    H]``, ``n = S/sp``) its ``seq`` index ``s`` holds their positions
    ``[s·n, (s+1)·n)``."""
    sp = int(mesh.shape.get(AXIS_SEQ, 1))
    dp = math.prod(int(mesh.shape.get(a, 1)) for a in DP_AXES)
    n = shape[-2] if sp > 1 else 1
    if sp > 1 and len(shape) < 3:
        raise ValueError("under a seq axis the MoE layer takes [..., S/sp, "
                         f"H] activations, got {tuple(shape)}")
    rows = math.prod(shape[:-1]) // n

    def ids_of(q: int, s: int) -> Tensor:
        b = torch.arange(rows) + q * rows
        j = torch.arange(n) + s * n
        return (b[:, None] * (n * sp) + j[None, :]).reshape(-1)

    coords = mesh.coords
    q = coords[AXIS_EXPERT] * int(mesh.shape[AXIS_DATA]) + coords[AXIS_DATA]
    mine = ids_of(q, coords[AXIS_SEQ] if sp > 1 else 0)
    gathered = torch.cat([ids_of(qq, ss) for qq in range(dp)
                          for ss in range(sp)])
    order = torch.empty_like(gathered)
    order[gathered] = torch.arange(gathered.numel())
    return mine, order


def local_routing(src_idx: Tensor, flat_idx: Tensor, gates: Tensor,
                  ids: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One rank's view of a routing over the global tokens, whose own
    are at ``ids`` (its local token ``i`` is global token ``ids[i]``):
    ``src_idx [E, C]`` with every other rank's slot ``EMPTY_SLOT`` and
    local token ids, and this rank's rows of ``flat_idx`` and ``gates [T,
    K]``."""
    T = flat_idx.shape[0]
    ids = ids.to(device=src_idx.device, dtype=torch.long)
    # one spare entry past the end: EMPTY_SLOT (-1) indexes it
    local = torch.full((T + 1,), EMPTY_SLOT, dtype=src_idx.dtype,
                       device=src_idx.device)
    local[ids] = torch.arange(ids.numel(), dtype=src_idx.dtype,
                              device=src_idx.device)
    return (local[src_idx.long()], flat_idx[ids].contiguous(),
            gates[ids])

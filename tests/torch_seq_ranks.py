"""Rank bodies of the parity tests of Mixtral, BERT and OPT under a ``seq``
axis and of Mixtral at expert x tensor parallelism
(``test_torch_seq_models``, ``test_torch_expert_mesh``).

``launcher.local.launch`` runs :func:`seq_rank` in fresh processes that
import this module by name; it imports no JAX.  Each rank joins a gloo
group on the CPU (one thread a rank) and returns plain values: the MoE
layer's global routing over the data axes x ``seq`` (its output chunk,
the routing, ``l_aux`` and the gradients), per training case the metrics
of every step and this rank's parameters before and after them, a
checkpoint's resume, and the refusals.
"""

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import (BertConfig, BertModel, MixtralConfig,
                                 MixtralModel, OPTConfig, OPTModel,
                                 ResNetConfig, ResNetModel, comm,
                                 init_distributed, initialize)
from deepspeed_tpu_torch.moe import MOELayer, TopKGate, swiglu_expert_fn
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups

SEQ, STEPS = 16, 3
OPTIMIZER = {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}}
#: capacity 12 of 64 top-2 assignments over 4 experts (2 rows of SEQ):
#: tokens drop in every step
CAPACITY_FACTOR = 0.75
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")

#: the routing cases of the MoE layer: name -> (ep, sp, impl); the global
#: input is ``[2, SEQ, ROUTE_H]``, each data coordinate's rows cut over
#: ``seq``
ROUTE_CASES = {"sp2_sparse": (1, 2, "sparse"), "sp2_dense": (1, 2, "dense"),
               "ep2sp2_sparse": (2, 2, "sparse"),
               "ep2sp2_dense": (2, 2, "dense")}
ROUTE_H, ROUTE_I, ROUTE_E, ROUTE_K = 16, 24, 4, 2
#: the routing loss: Σ y·cot plus this times l_aux (shared out over the
#: ep x sp ranks that route together)
ROUTE_AUX = 0.5

#: training cases: name -> (kind, layout (ep, sp, tp), model overrides)
TRAIN_CASES = {
    # aux_loss_coef 1 (not 0.02): an aux loss counted once a seq rank
    # would add ~2 (about 1 a layer) to every loss
    "mixtral_sp2": ("mixtral", (1, 2, 1), {"aux_loss_coef": 1.0}),
    "bert_sp2": ("bert", (1, 2, 1), {}),
    "opt_sp2": ("opt", (1, 2, 1), {}),
    "mixtral_ep2sp2": ("mixtral", (2, 2, 1), {}),
    "mixtral_ep2tp2": ("mixtral", (2, 1, 2), {}),
}
#: the rows of a step: both on one data coordinate, or one on each of the
#: expert axis's two (no case has a ``data`` axis above 1)
ROWS = 2


def world_of(layout: Tuple[int, int, int]) -> int:
    ep, sp, tp = layout
    return ep * sp * tp


def mixtral_config(**kw) -> MixtralConfig:
    return MixtralConfig.tiny(num_layers=2, dtype=torch.float32,
                              param_dtype=torch.float32,
                              capacity_factor=CAPACITY_FACTOR, **kw)


def model_config(name: str):
    kind, _, over = TRAIN_CASES[name]
    fp32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    if kind == "mixtral":
        return mixtral_config(**over)
    if kind == "bert":
        return BertConfig.tiny(num_layers=2, attn_impl="flash", **fp32)
    return OPTConfig.tiny(num_layers=2, attn_impl="flash", **fp32)


def build(name: str):
    cls = {"mixtral": MixtralModel, "bert": BertModel,
           "opt": OPTModel}[TRAIN_CASES[name][0]]
    return cls(model_config(name), device="cpu")


def case_config(name: str) -> Dict[str, Any]:
    kind, (ep, sp, tp), _ = TRAIN_CASES[name]
    cfg = {"train_micro_batch_size_per_gpu": ROWS // ep,
           "steps_per_print": 0, "optimizer": OPTIMIZER,
           "sequence_parallel": {"sp_size": sp},
           "tensor_parallel": {"autotp_size": tp}}
    if kind == "mixtral":
        cfg["moe"] = {"expert_parallel_size": ep, "dispatch_impl": "sparse"}
    return cfg


def batches(name: str) -> List[Dict[str, np.ndarray]]:
    """Each step's global batch (``ROWS`` rows of ``SEQ``): Mixtral and
    OPT ids; BERT ids with pad tails of 5 and 11 (one inside the second
    chunk, one across the chunk boundary), token types and ~30 % MLM
    labels on real tokens."""
    kind = TRAIN_CASES[name][0]
    out = []
    for i in range(STEPS):
        r = np.random.RandomState(40 + i)
        ids = r.randint(0, 512, (ROWS, SEQ)).astype(np.int64)
        if kind != "bert":
            out.append({"input_ids": ids})
            continue
        mask = np.ones_like(ids)
        mask[0, SEQ - 5:] = 0
        mask[1, SEQ - 11:] = 0
        labels = np.where((r.rand(*ids.shape) < 0.3) & (mask == 1), ids,
                          -100)
        labels[:, 0] = ids[:, 0]
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": (np.arange(SEQ)[None] >= 3).astype(
                        np.int64).repeat(ROWS, 0), "labels": labels})
    return out


def data_rows(batch: Dict[str, np.ndarray], q: int, dp: int
              ) -> Dict[str, torch.Tensor]:
    """The whole rows JAX's batch sharding gives data-parallel index
    ``q`` of ``dp``: every ``seq`` and tensor rank of it feeds them."""
    n = ROWS // dp
    return {k: torch.from_numpy(v[q * n:(q + 1) * n])
            for k, v in batch.items()}


def route_inputs(name: str) -> Dict[str, np.ndarray]:
    """The global input ``[2, SEQ, H]``, its cotangent, the router and the
    expert stacks of a routing case."""
    rng = np.random.RandomState(sorted(ROUTE_CASES).index(name))
    H, I, E = ROUTE_H, ROUTE_I, ROUTE_E

    def normal(*shape):
        return rng.randn(*shape).astype(np.float32)

    return {"x": normal(2, SEQ, H), "cot": normal(2, SEQ, H),
            "wg": normal(H, E), "w_gate": normal(E, H, I) / np.sqrt(H),
            "w_up": normal(E, H, I) / np.sqrt(H),
            "w_down": normal(E, I, H) / np.sqrt(I)}


def _route(name: str) -> Dict[str, Any]:
    """This rank's chunk of its data coordinate's rows through
    ``MOELayer(mesh=...)``: its output, the global routing, ``l_aux`` and
    the gradients of its share of ``Σ y·cot + ROUTE_AUX·l_aux``."""
    ep, sp, impl = ROUTE_CASES[name]
    mesh = groups.initialize_mesh(MeshLayout.infer(ep * sp, ep=ep, sp=sp))
    inp = {k: torch.from_numpy(v) for k, v in route_inputs(name).items()}
    e, s = mesh.axis_rank("expert"), mesh.axis_rank("seq")
    n, m = ROUTE_E // ep, SEQ // sp
    rows = slice(e * 2 // ep, (e + 1) * 2 // ep)
    x = inp["x"][rows, s * m:(s + 1) * m].clone().requires_grad_()
    wg = inp["wg"].clone().requires_grad_()
    experts = {k: inp[k][e * n:(e + 1) * n].clone().requires_grad_()
               for k in EXPERT_LEAVES}
    gate = TopKGate(num_experts=ROUTE_E, k=ROUTE_K,
                    capacity_factor=CAPACITY_FACTOR)
    layer = MOELayer(gate, swiglu_expert_fn, mesh=mesh, dispatch_impl=impl)
    y, l_aux, meta = layer(wg, experts, x)
    cot = inp["cot"][rows, s * m:(s + 1) * m]
    # every rank of the routing group holds the one l_aux: a share each
    ((y * cot).sum() + ROUTE_AUX * l_aux / (ep * sp)).backward()
    out = {"y": y.detach().numpy(), "capacity": layer.last_capacity,
           "impl": layer.last_impl, "l_aux": float(l_aux.detach()),
           "drop_rate": float(meta["drop_rate"]), "dx": x.grad.numpy(),
           "dwg": wg.grad.numpy(), "expert": e, "seq": s,
           "dexperts": {k: v.grad.numpy() for k, v in experts.items()}}
    gi = layer.last_routing
    if gi is not None:
        out["routing"] = {k: getattr(gi, k).numpy()
                          for k in ("expert_idx", "slot", "keep")}
    groups.reset_mesh()
    return out


def _state(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy()
            for k, v in model.named_parameters()}


def _steps(engine, name: str, todo) -> Dict[str, Any]:
    dp = engine.dp_world_size
    q = comm.get_rank(engine.dp_group) if dp > 1 else 0
    out = {k: [] for k in ("loss", "grad_norm", "lr")}
    out["kept"] = []
    layer = getattr(engine.module, "_moe_layer", None)
    for b in todo:
        m = engine.train_step(data_rows(b, q, dp))
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
        if layer is not None:  # the share kept by the step's last routing
            out["kept"].append(float(layer.last_routing.keep.float()
                                     .mean()))
    return out


def _train(name: str, weights: Dict[str, np.ndarray], ckpt: str
           ) -> Dict[str, Any]:
    """Every step of a case on this rank (each rank loads the whole
    reference weights; ``initialize`` cuts them over the mesh)."""
    model = build(name)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    engine, *_ = initialize(model=model, config=case_config(name),
                            device="cpu")
    mesh = model.mesh
    out = {"before": _state(model)}
    out.update(_steps(engine, name, batches(name)))
    out["after"] = _state(model)
    out["coords"] = {a: mesh.axis_rank(a) for a in ("expert", "seq",
                                                    "tensor")}
    out["sp"] = engine.sp_world_size
    if name == "mixtral_ep2tp2":
        out["checkpoint"] = _resume(name, weights, ckpt)
    return out


def _resume(name: str, weights, ckpt: str) -> Dict[str, Any]:
    """Two steps, a save, the third step; a fresh engine (other weights)
    loads the save and takes the third step again: bit for bit."""
    todo = batches(name)
    model = build(name)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    engine, *_ = initialize(model=model, config=case_config(name),
                            device="cpu")
    _steps(engine, name, todo[:2])
    engine.save_checkpoint(ckpt, tag="ep2tp2")
    at_save = _state(model)
    first = _steps(engine, name, todo[2:])
    other = MixtralModel(model_config(name), device="cpu", seed=5)
    engine2, *_ = initialize(model=other, config=case_config(name),
                             device="cpu")
    engine2.load_checkpoint(ckpt, tag="ep2tp2")
    again = _steps(engine2, name, todo[2:])
    a, b = _state(model), _state(other)
    return {"at_save": at_save, "first": first["loss"] + first["grad_norm"],
            "again": again["loss"] + again["grad_norm"],
            "equal": all(np.array_equal(a[k], b[k]) for k in a),
            "files": sorted(f for f in os.listdir(os.path.join(
                ckpt, "ep2tp2")) if f.endswith(".pt"))}


def _refusals() -> Dict[str, str]:
    """The compositions with ``seq`` left unported, each refused by
    ``initialize`` before any mesh is built."""
    fp32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    base = {"train_micro_batch_size_per_gpu": 1, "optimizer": OPTIMIZER}
    seq2 = dict(base, sequence_parallel={"sp_size": 2})
    tpsp = dict(seq2, tensor_parallel={"autotp_size": 2})
    tries = {
        "bert_tp_sp": (lambda: BertModel(BertConfig.tiny(
            num_layers=1, **fp32), device="cpu"), tpsp),
        "opt_tp_sp": (lambda: OPTModel(OPTConfig.tiny(
            num_layers=1, **fp32), device="cpu"), tpsp),
        "mixtral_tp_sp": (lambda: MixtralModel(mixtral_config(),
                                               device="cpu"), tpsp),
        "mixtral_ep_tp_sp": (lambda: MixtralModel(mixtral_config(),
                                                  device="cpu"),
                             dict(tpsp, moe={"expert_parallel_size": 2})),
        "mixtral_infinity_sp": (lambda: MixtralModel(mixtral_config(),
                                                     device="cpu"),
                                dict(seq2, zero_optimization={
                                    "stage": 3, "offload_param": {
                                        "device": "cpu"}})),
        "resnet_sp": (lambda: ResNetModel(ResNetConfig.tiny(
            dtype=torch.float32), device="cpu"), seq2),
    }
    out = {}
    for what, (make, cfg) in tries.items():
        try:
            initialize(model=make(), config=cfg, device="cpu")
            out[what] = "accepted"
        except NotImplementedError as e:
            out[what] = str(e)
    return out


def seq_rank(rank: int, weights: Dict[str, Dict[str, np.ndarray]],
             ckpt: str) -> Dict[str, Any]:
    """Every case of this world size on this rank."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    out: Dict[str, Any] = {"route": {}}
    for name, (ep, sp, _) in ROUTE_CASES.items():
        if ep * sp == world:
            out["route"][name] = _route(name)
    for name, (kind, layout, _) in TRAIN_CASES.items():
        if world_of(layout) == world:
            out[name] = _train(name, weights[name], ckpt)
            groups.reset_mesh()
    if world == 2:
        out["refusals"] = _refusals()
    return out

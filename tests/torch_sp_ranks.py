"""Rank bodies of the sequence-parallel parity tests
(``test_torch_sequence_parallel``).

``launcher.local.launch`` runs :func:`sp_rank` in fresh processes that
import this module by name; it imports no JAX.  Each rank joins a gloo
group on the CPU (one thread a rank) and returns plain values: per
training case the metrics of every step and the parameters gathered after
them, and the results of the unit checks (Ulysses and ring attention with
their gradients, the mpu, checkpoints, the dataloader, the refusals).
"""

import os
from typing import Any, Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch import (BertConfig, BertModel, DistributedAttention,
                                 LlamaConfig, LlamaModel, MixtralConfig,
                                 MixtralModel, ResNetConfig, ResNetModel,
                                 comm, init_distributed, initialize, zero)
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.runtime.sequence_parallel import (
    UlyssesSPAttentionHF, ring_attention, ulysses_attention)
from deepspeed_tpu_torch.utils import groups

#: ``LlamaConfig.tiny(num_layers=2)``: GQA 8/4, head dim 16
MODEL = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
             num_layers=2, num_heads=8, num_kv_heads=4, max_seq_len=256)
#: two heads: Ulysses stops at sp 2, the ring runs at sp 4
RING_MODEL = dict(MODEL, num_heads=2, num_kv_heads=2)
SEQ, STEPS = 32, 3
#: leaves of at most this many elements stay whole under ZeRO-3
THRESHOLD = 1000
OPTIMIZER = {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}}

#: name -> (world, sp, model, attn_impl, loss_tiles, ZeRO stage, labels)
CASES = {
    "sp2": (2, 2, MODEL, "flash", 1, 0, None),
    "sp2_tiles4": (2, 2, MODEL, "xla", 4, 0, None),
    # -100 on most of the first half: rank 0's chunk holds 4 valid labels,
    # rank 1's 31 a row
    "sp2_uneven_mask": (2, 2, MODEL, "xla", 1, 0, "uneven"),
    "sp2_dp2_zero3": (4, 2, MODEL, "xla", 1, 3, None),
    "ring_sp4": (4, 4, RING_MODEL, "ring", 1, 0, None),
}
#: the first half's positions that keep their labels in the uneven mask
KEPT = (3, 9)


def case_config(name: str) -> Dict[str, Any]:
    world, sp, _, _, _, stage, _ = CASES[name]
    return {"train_micro_batch_size_per_gpu": 2 * sp // world,
            "steps_per_print": 0, "optimizer": OPTIMIZER,
            "sequence_parallel": {"sp_size": sp},
            "zero_optimization": {
                "stage": stage,
                "stage3_param_persistence_threshold": THRESHOLD}}


def model_config(name: str) -> LlamaConfig:
    _, _, model, attn, tiles, _, _ = CASES[name]
    return LlamaConfig(**model, dtype=torch.float32,
                       param_dtype=torch.float32, attn_impl=attn,
                       loss_tiles=tiles)


def global_batches(name: str) -> List[Dict[str, np.ndarray]]:
    """Each step's global batch (two rows of ``SEQ`` tokens)."""
    out = []
    for i in range(STEPS):
        ids = np.random.RandomState(10 + i).randint(0, 512, (2, SEQ))
        batch = {"input_ids": ids.astype(np.int64)}
        if CASES[name][6] == "uneven":
            labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], 1)
            drop = np.ones(SEQ, bool)
            drop[SEQ // 2:] = False
            drop[list(KEPT)] = False
            labels[:, drop] = -100
            batch["labels"] = labels.astype(np.int64)
        out.append(batch)
    return out


def local_rows(batch: Dict[str, np.ndarray], dp_rank: int, dp: int
               ) -> Dict[str, torch.Tensor]:
    """The whole rows JAX's batch sharding gives data coordinate
    ``dp_rank``: every ``seq`` rank of it feeds them."""
    n = next(iter(batch.values())).shape[0] // dp
    return {k: torch.from_numpy(v[dp_rank * n:(dp_rank + 1) * n])
            for k, v in batch.items()}


def _gathered(model) -> Dict[str, np.ndarray]:
    with zero.GatheredParameters(list(model.parameters())):
        return {k: v.detach().numpy().copy()
                for k, v in model.named_parameters()}


def _model(cfg: LlamaConfig, rank: int, weights, seed: int) -> LlamaModel:
    """Rank 0 holds ``weights``; the others draw their own, which
    ``initialize`` replaces with rank 0's."""
    model = LlamaModel(cfg, device="cpu", seed=seed + rank)
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    return model


def _steps(engine, name: str, batches) -> Dict[str, Any]:
    dp = engine.dp_world_size
    dp_rank = comm.get_rank(engine.dp_group) if dp > 1 else 0
    out = {k: [] for k in ("loss", "grad_norm", "lr")}
    comm.all_to_all_in_graph.calls = 0
    for b in batches:
        m = engine.train_step(local_rows(b, dp_rank, dp))
        for k in out:
            out[k].append(float(m[k]))
    out["all_to_all"] = comm.all_to_all_in_graph.calls
    out["dp_rank"], out["sp_rank"] = dp_rank, engine.sp_rank
    return out


def _train_case(rank: int, name: str, weights, ckpt: str) -> Dict[str, Any]:
    config = case_config(name)
    if name == "sp2_dp2_zero3":  # its save runs through the async engine
        config["checkpoint"] = {"checkpoint_engine": {"type": "async"}}
    model = _model(model_config(name), rank, weights, 100)
    engine, *_ = initialize(model=model, config=config, device="cpu")
    batches = global_batches(name)
    out = _steps(engine, name, batches)
    out["eval"] = float(engine.eval_loss(local_rows(
        batches[0], out["dp_rank"], engine.dp_world_size)))
    out["params"] = _gathered(model)
    out["cut"] = sum(p is not None for p in engine.placements)
    if name == "sp2_dp2_zero3":
        engine.save_checkpoint(ckpt, tag="zero3")
        engine.checkpoint_engine.wait()
        out["files"] = sorted(os.listdir(os.path.join(ckpt, "zero3")))
    return out


def _checkpoint(rank: int, weights, ckpt: str) -> Dict[str, Any]:
    """sp 2: two steps, a save, a third step; a fresh engine (other
    weights) loads the save and takes the third step again."""
    batches = global_batches("sp2")
    model = _model(model_config("sp2"), rank, weights, 100)
    engine, *_ = initialize(model=model, config=case_config("sp2"),
                            device="cpu")
    _steps(engine, "sp2", batches[:2])
    engine.save_checkpoint(ckpt, tag="sp2")
    at_save = _gathered(model)
    first = _steps(engine, "sp2", batches[2:])
    model2 = LlamaModel(model_config("sp2"), device="cpu", seed=300 + rank)
    engine2, *_ = initialize(model=model2, config=case_config("sp2"),
                             device="cpu")
    engine2.load_checkpoint(ckpt, tag="sp2")
    again = _steps(engine2, "sp2", batches[2:])
    after, after2 = _gathered(model), _gathered(model2)
    return {"at_save": at_save, "first": first, "again": again,
            "params_equal": all(np.array_equal(after[k], after2[k])
                                for k in after),
            "files": sorted(os.listdir(os.path.join(ckpt, "sp2")))}


def _attn(q, k, v):
    """Causal softmax attention over a whole sequence ``[B, S, h, d]``."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def attention_inputs(h: int, kv_h: int, seed: int) -> List[np.ndarray]:
    """q ``[2, SEQ, h, 16]``, k and v ``[2, SEQ, kv_h, 16]`` and a
    cotangent of q's shape."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(2, SEQ, n, 16) * 0.3).astype(np.float32)
            for n in (h, kv_h, kv_h, h)]


def _with_grads(fn, inputs, sp: int, r: int) -> Dict[str, np.ndarray]:
    """This rank's chunk of ``fn``'s output and of the gradients of
    Σ out·cot with respect to q, k and v."""
    n = SEQ // sp
    q, k, v, cot = (torch.from_numpy(x[:, r * n:(r + 1) * n]).clone()
                    .requires_grad_() for x in inputs)
    out = fn(q, k, v)
    (out * cot).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _refusals() -> Dict[str, Any]:
    """What sp 2 refuses, each by its message (and the losses of
    ZeRO-Infinity at sp 2, and Mixtral and BERT, which ``initialize``
    accepts now: ``test_torch_seq_models`` trains them)."""
    out = {}
    tiny = dict(dtype=torch.float32, param_dtype=torch.float32)

    def attempt(what, fn):
        try:
            fn()
            out[what] = "accepted"
        except (ValueError, NotImplementedError) as e:
            out[what] = f"{type(e).__name__}: {e}"

    def uneven_seq():
        engine, *_ = initialize(model=LlamaModel(
            LlamaConfig(**MODEL, **tiny), device="cpu"),
            config=case_config("sp2"), device="cpu")
        engine.train_step({"input_ids": torch.zeros(2, SEQ + 1,
                                                    dtype=torch.long)})

    attempt("seq_not_divisible", uneven_seq)

    def infinity():  # ZeRO-Infinity at sp 2 trains (two steps, one batch)
        engine, *_ = initialize(
            model=LlamaModel(LlamaConfig(**MODEL, **tiny), device="cpu"),
            config=dict(case_config("sp2"), zero_optimization={
                "stage": 3, "offload_param": {"device": "cpu"}}),
            device="cpu")
        batch = local_rows(global_batches("sp2")[0], 0, 1)
        return [float(engine.train_step(batch)["loss"]) for _ in range(2)]

    out["infinity"] = infinity()
    attempt("mixtral", lambda: initialize(
        model=MixtralModel(MixtralConfig.tiny(num_layers=1, **tiny),
                           device="cpu"),
        config=case_config("sp2"), device="cpu"))
    attempt("bert", lambda: initialize(
        model=BertModel(BertConfig.tiny(dtype=torch.float32),
                        device="cpu"),
        config=case_config("sp2"), device="cpu"))
    attempt("resnet", lambda: initialize(
        model=ResNetModel(ResNetConfig.tiny(dtype=torch.float32),
                          device="cpu"),
        config=case_config("sp2"), device="cpu"))
    return out


def _two_rank_units(rank: int) -> Dict[str, Any]:
    """Ulysses and ``DistributedAttention`` with their gradients, and the
    mpu of ``register_with_transformers``."""
    groups.initialize_mesh(MeshLayout.infer(2, sp=2))
    inputs = attention_inputs(8, 8, 0)
    out = {"ulysses": _with_grads(
        lambda q, k, v: ulysses_attention(_attn, q, k, v), inputs, 2, rank),
        "distributed_attention": _with_grads(
            DistributedAttention(_attn), inputs, 2, rank)}
    mpu = UlyssesSPAttentionHF.register_with_transformers(
        model_name_or_path="x", sequence_parallel_size=2, max_length=256)
    # the mpu's sequence-parallel size wins over the config's
    engine, *_ = initialize(model=LlamaModel(LlamaConfig(
        **MODEL, dtype=torch.float32, param_dtype=torch.float32),
        device="cpu"), config=dict(case_config("sp2"),
                                   sequence_parallel={"sp_size": 1}),
        mpu=mpu, device="cpu")
    out["mpu"] = [mpu.get_sequence_parallel_world_size(),
                  mpu.get_sequence_parallel_rank(),
                  comm.get_world_size(mpu.get_sequence_parallel_group()),
                  UlyssesSPAttentionHF.register_with_transformers(
                      sequence_parallel_size=1) is None,
                  engine.sp_world_size]
    for what, kw in (("mpu_sp4", dict(sequence_parallel_size=4)),
                     ("mpu_max_length", dict(sequence_parallel_size=2,
                                             max_length=33))):
        try:
            UlyssesSPAttentionHF.register_with_transformers(**kw)
            out[what] = "accepted"
        except ValueError as e:
            out[what] = str(e)
    return out


def _four_rank_units(rank: int) -> Dict[str, Any]:
    """The ring at sp 4 with GQA (kv width 2 under 8 heads), causal with
    and without a window, with its gradients; the loader's rows at sp 2 x
    dp 2; Ulysses refusing 2 heads at sp 4."""
    groups.initialize_mesh(MeshLayout.infer(4, sp=4))
    inputs = attention_inputs(8, 2, 1)
    out = {f"ring_w{w}": _with_grads(
        lambda q, k, v, w=w: ring_attention(q, k, v, True, window=w),
        inputs, 4, rank) for w in (None, 12)}
    data = [{"input_ids": np.arange(i * SEQ, (i + 1) * SEQ)}
            for i in range(16)]
    _, _, loader, _ = initialize(
        model=LlamaModel(LlamaConfig(**MODEL, dtype=torch.float32,
                                     param_dtype=torch.float32),
                         device="cpu"),
        config=case_config("sp2_dp2_zero3"), training_data=data,
        device="cpu")
    out["loader_rows"] = [b["input_ids"].numpy() for b, _ in
                          zip(loader, range(2))]
    try:
        engine, *_ = initialize(model=LlamaModel(LlamaConfig(
            **RING_MODEL, dtype=torch.float32, param_dtype=torch.float32),
            device="cpu"), config=case_config("ring_sp4"), device="cpu")
        engine.train_step(local_rows(global_batches("ring_sp4")[0], 0, 1))
        out["heads_not_divisible"] = "accepted"
    except ValueError as e:
        out["heads_not_divisible"] = str(e)
    return out


def sp_rank(rank: int, weights: Dict[str, np.ndarray],
            ring_weights: Dict[str, np.ndarray], ckpt: str
            ) -> Dict[str, Any]:
    """Every case of this world size on this rank."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    out: Dict[str, Any] = {}
    for name, case in CASES.items():
        if case[0] == world:
            out[name] = _train_case(
                rank, name, ring_weights if case[2] is RING_MODEL
                else weights, ckpt)
    if world == 2:
        out["checkpoint"] = _checkpoint(rank, weights, ckpt)
        out["refusals"] = _refusals()
        out.update(_two_rank_units(rank))
    else:
        out.update(_four_rank_units(rank))
    return out

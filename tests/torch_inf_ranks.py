"""Rank bodies of the multi-rank ZeRO-Infinity parity tests
(``test_torch_infinity_ranks``).

``launcher.local.launch`` runs :func:`inf_rank` in fresh processes that
import this module by name; it imports no JAX.  Each rank joins a gloo
group on the CPU (one thread a rank), builds the case's model (rank 0
holds the weights it is handed, the others draw their own, which
``initialize`` replaces), trains it through ``initialize`` with
``offload_param`` and returns plain values: each step's metrics, the eval
loss, the whole masters gathered from the ranks' planes after the steps,
the swapper's segment sizes and byte counts, and the results of the
checks that need ranks (tiers and pipelines bit for bit, an fp16 overflow
on one rank, a save and its resume, a world-1 save loaded at world 2, the
streamed sp-2 run beside the on-device one, the refusal under a tensor
axis).
"""

import os
from typing import Any, Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                 MixtralModel, comm, init_distributed,
                                 initialize)
from deepspeed_tpu_torch.models import shard_llama_params
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups

#: ``LlamaConfig.tiny(num_layers=4)``: GQA 8/4, head dim 16
MODEL = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
             num_layers=4, num_heads=8, num_kv_heads=4, max_seq_len=256)
SEQ, STEPS, ROWS = 32, 3, 4
OPTIMIZER = {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.0}}

#: name -> (world, sp, attn_impl, loss_tiles, config overrides, Mixtral)
CASES = {
    "dp2_fused": (2, 1, "flash", 1, {}, False),
    "dp2_stash_gas2_clip": (2, 1, "flash", 1, {
        "gradient_accumulation_steps": 2, "gradient_clipping": 0.5}, False),
    "sp2": (2, 2, "flash", 1, {}, False),
    "sp2_tiles4": (2, 2, "flash", 4, {}, False),
    "mixtral_dp2": (2, 1, "xla", 1, {}, True),
    "dp2_sp2": (4, 2, "flash", 1, {}, False),
}
FP16 = {"fp16": {"enabled": True, "initial_scale_power": 8,
                 "hysteresis": 1, "loss_scale_window": 2}}


def gas(name: str) -> int:
    return CASES[name][4].get("gradient_accumulation_steps", 1)


def case_config(name: str, param: Any = None, **zero) -> Dict[str, Any]:
    """The ds_config of a case (``param``: the ``offload_param`` group,
    default the cpu tier; ``zero`` more ``zero_optimization`` keys)."""
    world, sp, _, _, overrides, _ = CASES[name]
    return {"train_micro_batch_size_per_gpu": ROWS * sp // world,
            "steps_per_print": 0, "optimizer": OPTIMIZER,
            "sequence_parallel": {"sp_size": sp},
            "zero_optimization": {
                "stage": 3, "offload_param": param or {"device": "cpu"},
                **zero}, **overrides}


def global_batches(name: str) -> List[np.ndarray]:
    """Each step's global batch: ``ROWS x gas`` rows of ``SEQ`` tokens."""
    return [np.random.RandomState(20 + i).randint(0, 512, (ROWS * gas(name),
                                                          SEQ))
            for i in range(STEPS)]


def local_rows(ids: np.ndarray, dp_rank: int, dp: int, gas_: int
               ) -> torch.Tensor:
    """Data coordinate ``dp_rank``'s rows of a global batch: its share of
    each of the ``gas`` micro-batches, as JAX's batch sharding gives it
    (every ``seq`` rank of the coordinate feeds the same rows)."""
    micro = ids.shape[0] // gas_
    n = micro // dp
    rows = [ids[k * micro + dp_rank * n:k * micro + (dp_rank + 1) * n]
            for k in range(gas_)]
    return torch.from_numpy(np.concatenate(rows).astype(np.int64))


def model_config(name: str, mixtral_fields: Dict[str, Any],
                 dtype=torch.float32) -> LlamaConfig:
    _, _, attn, tiles, _, moe = CASES[name]
    if moe:  # the JAX tiny Mixtral's fields over the port's tiny
        return MixtralConfig.tiny(**dict(mixtral_fields, dtype=dtype,
                                         param_dtype=torch.float32))
    return LlamaConfig(**MODEL, dtype=dtype, param_dtype=torch.float32,
                       attn_impl=attn, loss_tiles=tiles)


def _model(cfg: LlamaConfig, rank: int, weights, seed: int):
    cls = MixtralModel if isinstance(cfg, MixtralConfig) else LlamaModel
    model = cls(cfg, device="cpu", seed=seed + rank)
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    return model


def streamed_state(engine) -> Dict[str, np.ndarray]:
    """Every master, whole: the resident leaves and each layer's gathered
    from the ranks' planes (every rank calls it)."""
    inf = engine.infinity
    out = {k: v.detach().numpy().copy() for k, v in inf.resident.items()}
    for i in range(inf.L):
        for k, v in inf.swapper.layer_master_tree(i).items():
            out[f"layers.{i}.{k}"] = v.numpy().copy()
    return out


def streamed_moments(engine) -> List[Dict[str, np.ndarray]]:
    sw = engine.infinity.swapper
    return [{k: v.numpy().copy() for k, v in sw.layer_moments(i).items()}
            for i in range(sw.L)]


def _coords(engine):
    dp = engine.dp_world_size
    return (comm.get_rank(engine.dp_group) if dp > 1 else 0), dp


def steps(engine, name: str, batches) -> Dict[str, Any]:
    d, dp = _coords(engine)
    out = {k: [] for k in ("loss", "grad_norm", "lr", "loss_scale",
                           "overflow")}
    comm.all_to_all_in_graph.calls = 0
    for b in batches:
        m = engine.train_step({"input_ids": local_rows(b, d, dp, gas(name))})
        for k in out:
            out[k].append(float(m[k]))
    out["all_to_all"] = comm.all_to_all_in_graph.calls
    return out


def _engine(name: str, rank: int, weights, seed: int, mixtral_fields,
            config=None, dtype=torch.float32):
    model = _model(model_config(name, mixtral_fields, dtype), rank, weights,
                   seed)
    engine, *_ = initialize(model=model, config=config or case_config(name),
                            device="cpu")
    return engine


def _train_case(rank: int, name: str, weights, mixtral_fields
                ) -> Dict[str, Any]:
    engine = _engine(name, rank, weights, 100, mixtral_fields)
    batches = global_batches(name)
    d, dp = _coords(engine)
    ev = float(engine.eval_loss({"input_ids": local_rows(
        batches[0][:ROWS], d, dp, 1)}))
    out = steps(engine, name, batches)
    sw = engine.infinity.swapper
    out.update(eval=ev, state=streamed_state(engine), dp_rank=d,
               sp_rank=engine.sp_rank, n_elems=sw.n_elems, n_pad=sw.n_pad,
               n_plane=sw.n_plane, world=sw.shard_world,
               segments=sw.segments, host_plane_bytes=sw.host_plane_bytes(),
               plane_numel=[p.numel() for p in (sw._resident[0].wire,
                                                sw._resident[0].master)],
               device_param_bytes=engine.infinity.peak_device_param_bytes(),
               io_bytes=dict(sw.io_bytes),
               trunk_on_module=float(sum(
                   p.abs().sum() for p in engine.module.layers.parameters())))
    return out


def _tiers(rank: int, weights, root: str) -> Dict[str, Any]:
    """dp 2 on both paths: the cpu tier pipelined and serial, the nvme tier
    (a ring of 2 slots for 4 layers, so it evicts) pipelined: losses, grad
    norms and every master."""
    out: Dict[str, Any] = {}
    for name in ("dp2_fused", "dp2_stash_gas2_clip"):
        for tier, pipelined in (("cpu", True), ("cpu", False),
                                ("nvme", True)):
            path = os.path.join(root, f"nv_{name}")
            param = ({"device": "cpu"} if tier == "cpu" else
                     {"device": "nvme", "buffer_count": 2, "nvme_path": path})
            opt = {} if pipelined else {"offload_optimizer": {
                "device": "cpu", "pipeline_read": False,
                "pipeline_write": False}}
            engine = _engine(name, rank, weights, 200, None,
                             case_config(name, param, **opt))
            got = steps(engine, name, global_batches(name)[:2])
            sw = engine.infinity.swapper
            row = {"loss": got["loss"], "grad_norm": got["grad_norm"],
                   "state": streamed_state(engine),
                   "pipelined": sw._pipe is not None}
            if tier == "nvme":
                row["files"] = sorted(os.listdir(path))
                row["evicts"] = sw.buffer_count < sw.L
            out[f"{name}/{tier}/{'pipelined' if pipelined else 'serial'}"] \
                = row
            del engine, sw
    return out


def _fp16_overflow(rank: int, weights) -> Dict[str, Any]:
    """fp16 at dp 2 (the stash path): two clean steps, then a resident
    master at 1e38 on rank 0 alone (inf in fp16): every rank skips."""
    name = "dp2_fused"
    config = dict(case_config(name), **FP16)
    engine = _engine(name, rank, weights, 300, None, config,
                     dtype=torch.float16)
    batches = global_batches(name)
    clean = steps(engine, name, batches[:2])
    inf = engine.infinity
    before = {"steps": inf.global_steps, "adam": inf.swapper.state_step,
              "count": engine.optimizer.count,
              "scale": engine.loss_scaler.scale}
    if rank == 0:
        with torch.no_grad():
            inf.resident["embed.weight"].mul_(1e38)
    m = steps(engine, name, batches[2:])
    return {"clean": clean, "before": before, "overflow": m["overflow"],
            "after": {"steps": inf.global_steps,
                      "adam": inf.swapper.state_step,
                      "count": engine.optimizer.count,
                      "scale": engine.loss_scaler.scale,
                      "skipped": engine.skipped_steps}}


def _checkpoint(rank: int, weights, root: str, world1_dir: str
                ) -> Dict[str, Any]:
    """dp 2: two steps, a save, a third step; a fresh engine (other
    weights) loads the save and takes the third step again.  Then a
    world-1 save (``world1_dir``) loaded at dp 2."""
    name = "dp2_fused"
    batches = global_batches(name)
    engine = _engine(name, rank, weights, 400, None)
    steps(engine, name, batches[:2])
    tag_dir = engine.save_checkpoint(os.path.join(root, "ckpt"), tag="dp2")
    at_save = streamed_state(engine)
    moments = streamed_moments(engine)
    first = steps(engine, name, batches[2:])
    engine2 = _engine(name, rank, weights, 500, None)
    engine2.load_checkpoint(os.path.join(root, "ckpt"), tag="dp2")
    loaded = {"adam": engine2.infinity.swapper.state_step,
              "steps": engine2.global_steps}
    again = steps(engine2, name, batches[2:])
    a, b = streamed_state(engine), streamed_state(engine2)
    engine3 = _engine(name, rank, weights, 600, None)
    engine3.load_checkpoint(world1_dir, tag="w1")
    return {"at_save": at_save, "moments": moments, "first": first,
            "again": again, "loaded": loaded,
            "params_equal": all(np.array_equal(a[k], b[k]) for k in a),
            "files": sorted(os.listdir(tag_dir)),
            "from_world1": {"state": streamed_state(engine3),
                            "moments": streamed_moments(engine3),
                            "adam": engine3.infinity.swapper.state_step}}


def _on_device_sp2(rank: int, weights) -> Dict[str, Any]:
    """The sp-2 case on the on-device engine (ZeRO 0, the remat path)."""
    name = "sp2"
    config = dict(case_config(name), zero_optimization={"stage": 0})
    engine = _engine(name, rank, weights, 700, None, config)
    return steps(engine, name, global_batches(name))


def _tp_refusal(weights) -> Dict[str, Any]:
    """``offload_param`` on a tensor axis of 2 (no longer refused): the
    dp2_fused case's config at tp 2, streamed and on the device, two steps
    of the same four rows on both ranks each."""
    out = {}
    for where, zero in (("streamed", None), ("on_device", {"stage": 0})):
        mesh = groups.initialize_mesh(MeshLayout.infer(2, tp=2))
        model = LlamaModel(LlamaConfig(**MODEL, dtype=torch.float32,
                                       param_dtype=torch.float32),
                           device="cpu", mesh=mesh)
        model.load_state_dict(shard_llama_params(
            {k: torch.from_numpy(v) for k, v in weights.items()}, 2,
            model.tp_rank))
        config = dict(case_config("dp2_fused"),
                      train_micro_batch_size_per_gpu=ROWS)
        if zero is not None:
            config["zero_optimization"] = zero
        try:
            engine, *_ = initialize(model=model, config=config, mesh=mesh,
                                    device="cpu")
            out[where] = steps(engine, "dp2_fused",
                               global_batches("dp2_fused")[:2])
        finally:
            groups.reset_mesh()
    return out


def inf_rank(rank: int, weights: Dict[str, np.ndarray],
             moe_weights: Dict[str, np.ndarray],
             mixtral_fields: Dict[str, Any], root: str) -> Dict[str, Any]:
    """Every case of this world size on this rank."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    out: Dict[str, Any] = {}
    for name, case in CASES.items():
        if case[0] == world:
            out[name] = _train_case(rank, name, moe_weights if case[5]
                                    else weights, mixtral_fields)
    if world == 2:
        out["tiers"] = _tiers(rank, weights, os.path.join(root, "tiers"))
        out["fp16"] = _fp16_overflow(rank, weights)
        out["checkpoint"] = _checkpoint(rank, weights, root,
                                        os.path.join(root, "world1"))
        out["on_device_sp2"] = _on_device_sp2(rank, weights)
        out["tp_refusal"] = _tp_refusal(weights)
    return out

"""Rank bodies of the tensor-parallel tests (``test_torch_tensor_parallel``
for serving, ``test_torch_tp_train`` for training).

``launcher.local.launch`` runs each in fresh processes, which import this
module by name; it imports no JAX, so a rank starts with PyTorch alone.
Every body joins a gloo process group on the CPU, builds its mesh, and
returns plain values (lists and numpy arrays) to the test.
"""

import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._python_dispatch

from torch import nn

from deepspeed_tpu_torch import (BertConfig, BertModel, KVCacheConfig,
                                 LlamaConfig, LlamaModel, MixtralConfig,
                                 MixtralModel, OPTConfig, OPTModel,
                                 ResNetConfig, ResNetModel, build_engine_v2,
                                 build_serving_frontend, comm,
                                 init_distributed, init_inference,
                                 initialize, tp_model_init)
from deepspeed_tpu_torch.models import shard_llama_params
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups
from torch_inf_ranks import streamed_state

# the HF-shaped AutoTP client, shared with chip_smoke.py
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from hf_client import CLIENT, ClientLM  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _join(tp: int = 0):
    """Join the gloo group (one thread a rank: the ranks share the CPU) and,
    with ``tp``, build the mesh."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    return groups.initialize_mesh(MeshLayout.infer(tp=tp)) if tp else None


def _state_dict(weights):
    return {k: torch.from_numpy(v) for k, v in weights.items()}


def _tp_model(cfg_kw, weights, mesh):
    model = LlamaModel(LlamaConfig(**cfg_kw), device="cpu", mesh=mesh)
    model.load_state_dict(shard_llama_params(
        _state_dict(weights), model.tp, model.tp_rank))
    return model


def comm_rank(rank: int, inputs):
    """The verbs over the world on per-rank numpy ``inputs[rank]``:
    all_reduce (sum and max), all_gather along dims 0 and 1, and broadcast
    from rank 1, in fp32 and bf16 (returned as fp32)."""
    _join()
    out = {}
    for name, dtype in DTYPES.items():
        x = torch.from_numpy(inputs[rank]).to(dtype)
        res = {"sum": comm.all_reduce(x.clone()),
               "max": comm.all_reduce(x.clone(), comm.ReduceOp.MAX),
               "gather0": comm.all_gather(x),
               "gather1": comm.all_gather(x, dim=1),
               "bcast": comm.broadcast(x.clone(), src=1)}
        out[name] = {k: v.float().numpy() for k, v in res.items()}
    return out


def _opt_serve(mesh, opt_kw, opt_weights, prompts, n_new, cache_kw,
               engine_kw, ids, v1_new) -> Dict[str, Any]:
    """OPT at ``tp=2``: v2 on a model built on the mesh holding its shard
    (paged #2b on each rank's heads), the first prompt's prefill logits,
    then v1 ``init_inference(tensor_parallel=...)`` on a whole model."""
    from deepspeed_tpu_torch.models import shard_opt_params
    cfg = OPTConfig(**opt_kw)
    sd = _state_dict(opt_weights)
    model = OPTModel(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(shard_opt_params(sd, 2, model.tp_rank))
    eng = build_engine_v2(model, cache_config=KVCacheConfig(**cache_kw),
                          device="cpu", mesh=mesh, **engine_kw)
    tokens = eng.generate(prompts, max_new_tokens=n_new)
    first = torch.tensor([prompts[0]])
    logits, _ = model.prefill(first, model.init_cache(1, first.shape[1]))
    whole = OPTModel(cfg, device="cpu")
    whole.load_state_dict(sd)
    v1 = init_inference(whole, tensor_parallel={"tp_size": 2}, device="cpu",
                        mesh=mesh)
    out = v1.generate(torch.from_numpy(ids), max_new_tokens=v1_new)
    return {"tokens": tokens, "logits": logits.numpy(),
            "attn_path": eng.last_attn_path,
            "pool_heads": eng.pool["k"].shape[3],
            "v1_tokens": out.numpy(), "v1_tp": whole.tp,
            "v1_fc_in_rows": whole.layers[0].fc_in.weight.shape[0]}


def engines_rank(rank: int, cfg_kw, weights, prompts, n_new, cache_kw,
                 engine_kw, ids, v1_new, opt=None):
    """The v2 engine on this rank's shard (greedy tokens, the first
    prompt's last-token logits from ``prefill``, the decode path, the
    pool's heads); then v1 ``init_inference(tensor_parallel={"tp_size":
    2})`` on a whole model, which builds its own mesh and splits the
    weights; with ``opt`` (the OPT model's kwargs and weights) the same
    for OPT."""
    mesh = _join(2)
    model = _tp_model(cfg_kw, weights, mesh)
    eng = build_engine_v2(model, cache_config=KVCacheConfig(**cache_kw),
                          device="cpu", mesh=mesh, **engine_kw)
    tokens = eng.generate(prompts, max_new_tokens=n_new)
    first = torch.tensor([prompts[0]])
    logits, _ = model.prefill(first, model.init_cache(1, first.shape[1]))
    whole = LlamaModel(LlamaConfig(**cfg_kw), device="cpu")
    whole.load_state_dict(_state_dict(weights))
    v1 = init_inference(whole, tensor_parallel={"tp_size": 2}, device="cpu")
    v1_out = v1.generate(torch.from_numpy(ids), max_new_tokens=v1_new)
    out = {"tokens": tokens, "logits": logits.numpy(),
           "attn_path": eng.last_attn_path,
           "pool_heads": eng.pool["k"].shape[3], "v1_tokens": v1_out.numpy(),
           "v1_tp": whole.tp,
           "v1_q_rows": whole.layers[0].q_proj.weight.shape[0]}
    if opt is not None:
        out["opt"] = _opt_serve(groups.get_mesh(), opt["kw"],
                                opt["weights"], prompts, n_new, cache_kw,
                                engine_kw, ids, v1_new)
    return out


def frontend_rank(rank: int, cfg_kw, weights, prompts, n_new, cache_kw,
                  engine_kw):
    """``build_serving_frontend(mesh=...)`` with ``pump()`` driven on this
    rank: every request's tokens, and what ``start()`` says."""
    mesh = _join(2)
    model = _tp_model(cfg_kw, weights, mesh)
    fe = build_serving_frontend(model, cache_config=KVCacheConfig(**cache_kw),
                                device="cpu", mesh=mesh, **engine_kw)
    tokens = serve_script(fe, prompts, n_new)
    try:
        fe.start()
        refused = None
    except RuntimeError as e:
        refused = str(e)
    return {"tokens": tokens, "start_refused": refused}


def serve_script(fe, prompts, n_new):
    """Submit ``prompts`` in classes that rotate, then pump to idle; the
    tokens in submission order (shared by the ``tp=1`` reference)."""
    classes = ("interactive", "batch", "background")
    handles = [fe.submit(p, n_new, classes[i % 3])
               for i, p in enumerate(prompts)]
    fe.run_until_idle()
    return [h.result() for h in handles]


def stray_rank(rank: int):
    """Rank 0 enters an all-reduce that rank 1, alive, never joins."""
    _join()
    if rank == 0:
        comm.all_reduce(torch.ones(4))
    else:
        time.sleep(600)
    return rank


# -- tensor-parallel training (test_torch_tp_train) ---------------------------

#: the tiny Llama of the training tests: 2 layers, GQA 8/4 (4/2 a rank at
#: tp 2), fp32 masters (the ZeRO tests' model)
TRAIN_MODEL = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
                   num_layers=2, num_heads=8, num_kv_heads=4,
                   max_seq_len=256)
#: one row a data rank (the ZeRO tests' reason: at more rows one embedding
#: entry's gradient cancels to a few ulps); the clip reads the global norm
TRAIN_BASE = {"train_micro_batch_size_per_gpu": 1, "steps_per_print": 0,
              "gradient_clipping": 0.5,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 3e-3, "weight_decay": 0.01}}}
TRAIN_STEPS, TRAIN_SEQ, TRAIN_THRESHOLD = 3, 16, 1000
#: name -> (world, ZeRO stage, loss tiles, model); every case at tp 2
TRAIN_CASES = {
    "tp2_tiles1": (2, 0, 1, "llama"), "tp2_tiles2": (2, 0, 2, "llama"),
    "tp2_split_first": (2, 0, 1, "llama"),
    "tp2_mixtral": (2, 0, 1, "mixtral"),
    "dp2tp2_z1": (4, 1, 1, "llama"), "dp2tp2_z3": (4, 3, 1, "llama"),
}
#: split by ``tp_model_init`` before ``initialize``: ``tp2_tiles2`` with
#: ``tensor_parallel.autotp_size`` in the config, ``tp2_split_first``
#: without it (the model's own mesh gives the tensor axis)
SPLIT_FIRST = ("tp2_tiles2", "tp2_split_first")
#: the hybrid engine's prompt and greedy length at tp 2
HYBRID_PROMPT, HYBRID_NEW = [[3, 17, 99, 250, 7]], 6


def train_config(name: str, **extra) -> Dict[str, Any]:
    _, stage, _, kind = TRAIN_CASES[name]
    cfg = dict(TRAIN_BASE, zero_optimization={
        "stage": stage, "stage3_param_persistence_threshold":
        TRAIN_THRESHOLD})
    if name != "tp2_split_first":
        cfg["tensor_parallel"] = {"autotp_size": 2}
    if kind == "mixtral":
        cfg["moe"] = {"dispatch_impl": "sparse"}
    cfg.update(extra)
    return cfg


def train_model_config(name: str, dtype=torch.float32):
    _, _, tiles, kind = TRAIN_CASES[name]
    if kind == "mixtral":
        return MixtralConfig.tiny(num_layers=2, dtype=dtype,
                                  param_dtype=torch.float32)
    return LlamaConfig(dtype=dtype, param_dtype=torch.float32,
                       loss_tiles=tiles, **TRAIN_MODEL)


def train_batches(name: str) -> List[np.ndarray]:
    """Each step's global batch: one row a data rank."""
    dp = TRAIN_CASES[name][0] // 2
    return [np.random.RandomState(20 + i).randint(0, 512, (dp, TRAIN_SEQ))
            .astype(np.int64) for i in range(TRAIN_STEPS)]


def _whole_model(name: str, weights, dtype=torch.float32):
    kind = TRAIN_CASES[name][3]
    model = (MixtralModel if kind == "mixtral" else LlamaModel)(
        train_model_config(name, dtype), device="cpu")
    model.load_state_dict(_state_dict(weights))
    return model


class _VocabWidths(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the floating-point results of every op whose last dim is the
    whole vocabulary (the full logits, had a rank formed them)."""

    def __init__(self, vocab: int):
        super().__init__()
        self.vocab, self.hits = vocab, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                    t.dim() >= 2 and t.shape[-1] == self.vocab:
                self.hits += 1
        return out


def _local_whole(engine) -> Dict[str, np.ndarray]:
    """This rank's masters by name, a ZeRO-3 chunk gathered to the rank's
    tensor block."""
    out = {}
    for name, p, pl in zip(engine.param_names, engine.params,
                           engine.placements):
        t = pl.gather(p.data) if pl is not None and engine.zero_stage == 3 \
            else p.data
        out[name] = t.detach().numpy().copy()
    return out


def _moments(engine) -> Dict[str, np.ndarray]:
    st = engine.optimizer.state_dict()
    return {f"{k}:{n}": st[k][i].detach().numpy().copy()
            for i, n in enumerate(engine.param_names) for k in ("m", "v")}


def _steps(engine, name: str, rows: int) -> Dict[str, list]:
    out = {"loss": [], "grad_norm": [], "lr": [], "skipped": []}
    for b in train_batches(name):
        m = engine.train_step({"input_ids": torch.from_numpy(
            b[rows:rows + 1])})
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
        out["skipped"].append(int(engine.skipped_steps))
    return out


def _train_case(name: str, weights) -> Dict[str, Any]:
    """The case on this rank: the whole model split by ``initialize``
    (``SPLIT_FIRST``: by ``tp_model_init`` before it), its steps, its
    masters after them; Mixtral also the router's gradient of step 1."""
    groups.reset_mesh()
    model = _whole_model(name, weights)
    if name in SPLIT_FIRST:
        tp_model_init(model, tp_size=2)
    engine, *_ = initialize(model=model, config=train_config(name),
                            device="cpu")
    mesh = groups.get_mesh()
    data = mesh.axis_rank("data")
    out: Dict[str, Any] = {"tp_rank": model.tp_rank, "data_rank": data,
                           "cut": len(engine._cut)}
    if TRAIN_CASES[name][3] == "mixtral":  # the first step's gradient
        model.loss({"input_ids": torch.from_numpy(
            train_batches(name)[0][data:data + 1])}).backward()
        out["wg_grad"] = {n: p.grad.numpy().copy() for n, p in
                          model.named_parameters() if n.endswith(".wg")}
        engine.zero_grad()
    with _VocabWidths(model.config.vocab_size) as widths:
        out.update(_steps(engine, name, data))
    out["full_vocab_outputs"] = widths.hits
    out["params"] = _local_whole(engine)
    out["logits_shape"] = list(model.lm_head.weight.shape)
    return out, engine


def _fp16_skip(weights) -> Dict[str, Any]:
    """fp16 at tp 2: an Inf placed in rank 1's block of a split leaf's
    gradient makes both ranks skip the step (the flag OR-ed over
    ``tensor``), leaving every parameter as it was."""
    groups.reset_mesh()
    model = _whole_model("tp2_tiles1", weights, torch.float16)
    engine, *_ = initialize(model=model, config=train_config(
        "tp2_tiles1", fp16={"enabled": True, "initial_scale_power": 8,
                             "hysteresis": 1}),
        device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {"input_ids": torch.from_numpy(train_batches("tp2_tiles1")[0])}
    engine.backward(engine.forward(batch))
    if model.tp_rank == 1:
        model.layers[1].q_proj.weight.grad[0, 0] = float("inf")
    m = engine.step()
    same = all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    m2 = engine.train_step(batch)
    return {"overflow": [bool(m["overflow"]), bool(m2["overflow"])],
            "loss_scale": [m["loss_scale"], m2["loss_scale"]],
            "skipped": engine.skipped_steps, "unchanged": same}


def _checkpoints(engine, name: str, weights, root: Dict[str, str]
                 ) -> Dict[str, Any]:
    """Save the tp-2 engine, load it into a fresh tp-2 engine (bit for
    bit, and one more step of each equal), then load the one-process
    checkpoint ``root["tp1"]`` at tp 2."""
    engine.save_checkpoint(root["tp2"])
    groups.reset_mesh()
    fresh = _whole_model(name, weights)
    again, *_ = initialize(model=fresh, config=train_config(name),
                           device="cpu")
    again.load_checkpoint(root["tp2"])
    a, b = _local_whole(engine), _local_whole(again)
    ma, mb = _moments(engine), _moments(again)
    equal = all(np.array_equal(a[k], b[k]) for k in a) and all(
        np.array_equal(ma[k], mb[k]) for k in ma) and \
        again.optimizer.count == engine.optimizer.count
    nxt = {"input_ids": torch.from_numpy(train_batches(name)[0])}
    resumed = float(again.train_step(nxt)["loss"])
    original = float(engine.train_step(nxt)["loss"])
    groups.reset_mesh()
    third = _whole_model(name, weights)
    from_tp1, *_ = initialize(model=third, config=train_config(name),
                              device="cpu")
    from_tp1.load_checkpoint(root["tp1"])
    return {"tp2_equal": equal, "resumed_loss": resumed,
            "original_loss": original, "from_tp1": _local_whole(from_tp1),
            "from_tp1_moments": _moments(from_tp1),
            "from_tp1_count": from_tp1.optimizer.count}


def _hybrid(weights) -> List[List[int]]:
    """The hybrid engine at tp 2: one step, then greedy tokens (each rank
    decodes its heads)."""
    groups.reset_mesh()
    model = _whole_model("tp2_tiles1", weights)
    engine, *_ = initialize(model=model, config=train_config(
        "tp2_tiles1", hybrid_engine={"enabled": True, "max_out_tokens": 4}),
        device="cpu")
    engine.train_step({"input_ids": torch.from_numpy(
        train_batches("tp2_tiles1")[0])})
    return engine.generate(torch.tensor(HYBRID_PROMPT),
                           max_new_tokens=HYBRID_NEW).tolist()


def _refusals_4(mixtral_w) -> Dict[str, str]:
    """On four ranks: a tensor axis with an expert axis trains
    (``test_torch_expert_mesh``); with a ``seq`` axis too it is refused
    (item 7c), before any mesh is built."""
    groups.reset_mesh()
    try:
        initialize(model=_whole_model("tp2_mixtral", mixtral_w),
                   config=train_config("tp2_mixtral", moe={
                       "dispatch_impl": "sparse",
                       "expert_parallel_size": 2},
                       sequence_parallel={"sp_size": 2}), device="cpu")
        return {"expert": "accepted"}
    except NotImplementedError as e:
        return {"expert": str(e)}


# -- tensor x sequence parallelism (the 4-rank launch) -----------------------

#: name -> (attention, loss tiles): Llama at tp 2 x sp 2 (dp 1), Ulysses
#: on the flash route (the kernels' plain versions here) or the ring
TPSP_CASES = {"tp2sp2_ulysses_t1": ("flash", 1),
              "tp2sp2_ulysses_t2": ("flash", 2),
              "tp2sp2_ring_t1": ("ring", 1), "tp2sp2_ring_t2": ("ring", 2)}


def tpsp_model_config(name: str) -> LlamaConfig:
    attn, tiles = TPSP_CASES[name]
    return LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                       attn_impl=attn, loss_tiles=tiles, **TRAIN_MODEL)


def tpsp_config() -> Dict[str, Any]:
    return dict(TRAIN_BASE, zero_optimization={"stage": 0},
                tensor_parallel={"autotp_size": 2},
                sequence_parallel={"sp_size": 2})


def _tpsp_engine(name: str, weights):
    groups.reset_mesh()
    model = LlamaModel(tpsp_model_config(name), device="cpu")
    model.load_state_dict(_state_dict(weights))
    engine, *_ = initialize(model=model, config=tpsp_config(),
                            device="cpu")
    return model, engine


def _tpsp_case(name: str, weights) -> Tuple[Dict[str, Any], Any]:
    """The case on this rank: the whole model split by ``initialize`` over
    tensor and its row cut over seq, three AdamW steps with clipping on
    the tp-2 cases' batches (one row, the same on every rank), the
    all-to-alls they ran, the rank's masters."""
    model, engine = _tpsp_engine(name, weights)
    mesh = groups.get_mesh()
    out: Dict[str, Any] = {"tp_rank": model.tp_rank,
                           "seq_rank": mesh.axis_rank("seq"),
                           "data_rank": mesh.axis_rank("data"),
                           "local_heads": model.num_local_heads}
    comm.all_to_all_in_graph.calls = 0
    with _VocabWidths(model.config.vocab_size) as widths:
        out.update(_steps(engine, "tp2_tiles1", 0))
    out["all_to_all"] = comm.all_to_all_in_graph.calls
    out["full_vocab_outputs"] = widths.hits
    out["params"] = _local_whole(engine)
    return out, engine


def _tpsp_checkpoint(engine, weights, root: str) -> Dict[str, Any]:
    """A tp-2 x sp-2 save loaded by a fresh tp-2 x sp-2 engine: the
    rank's masters and moments bit for bit, one more step of each
    equal."""
    name = "tp2sp2_ulysses_t1"
    engine.save_checkpoint(root)
    _, again = _tpsp_engine(name, weights)
    again.load_checkpoint(root)
    a, b = _local_whole(engine), _local_whole(again)
    ma, mb = _moments(engine), _moments(again)
    nxt = {"input_ids": torch.from_numpy(train_batches("tp2_tiles1")[0])}
    return {"equal": all(np.array_equal(a[k], b[k]) for k in a) and all(
                np.array_equal(ma[k], mb[k]) for k in ma)
            and again.optimizer.count == engine.optimizer.count,
            "resumed_loss": float(again.train_step(nxt)["loss"]),
            "original_loss": float(engine.train_step(nxt)["loss"])}


# -- ZeRO-Infinity, the ladder models and AutoTP at tp 2 (the 2-rank launch) --

def _split_dims(model) -> Dict[str, Optional[int]]:
    """Each parameter's split dim (``ds_tensor``), None for a whole
    leaf."""
    return {n: (p.ds_tensor.dim if hasattr(p, "ds_tensor") else None)
            for n, p in model.named_parameters()}


#: ZeRO-Infinity at tp 2: the stash path (``tp2_tiles1``'s config: AdamW
#: with clipping, the on-device run it is held to) and the fused path
#: (no clipping, against an on-device run without it)
INF_ZERO = {"stage": 3, "offload_param": {"device": "cpu"}}
INF_FUSED_STEPS = 2


def _infinity_tp(weights, root: str) -> Dict[str, Any]:
    """Llama streamed from the cpu tier at tp 2, from the whole model
    ``initialize`` splits: its steps, masters, trunk bytes and the module's
    trunk; a save of it loaded by an on-device tp-2 engine (the rank's
    blocks, bit for bit); the fused path beside an on-device run."""
    groups.reset_mesh()
    model = _whole_model("tp2_tiles1", weights)
    engine, *_ = initialize(model=model, config=train_config(
        "tp2_tiles1", zero_optimization=INF_ZERO), device="cpu")
    sw = engine.infinity.swapper
    out: Dict[str, Any] = {"tp_rank": model.tp_rank,
                           "split": sorted(engine.infinity.layer_tensor),
                           "n_elems": sw.n_elems,
                           "layer_numel": sum(
                               p.numel() for p in model.layers[0].parameters()),
                           "device_param_bytes":
                               engine.infinity.peak_device_param_bytes()}
    out["stash"] = _steps(engine, "tp2_tiles1", 0)
    out["stash"]["state"] = streamed_state(engine)
    engine.save_checkpoint(root)
    groups.reset_mesh()
    dev_engine, *_ = initialize(model=_whole_model("tp2_tiles1", weights),
                                config=train_config("tp2_tiles1"),
                                device="cpu")
    dev_engine.load_checkpoint(root)
    got = _local_whole(dev_engine)
    out["loaded_equal"] = set(got) == set(out["stash"]["state"]) and all(
        np.array_equal(got[k], out["stash"]["state"][k]) for k in got)
    out["loaded_count"] = dev_engine.optimizer.count
    del dev_engine
    fused = {}
    for where, zero in (("streamed", INF_ZERO), ("on_device",
                                                 {"stage": 0})):
        groups.reset_mesh()
        eng, *_ = initialize(model=_whole_model("tp2_tiles1", weights),
                             config=train_config("tp2_tiles1",
                                                 gradient_clipping=0.0,
                                                 zero_optimization=zero),
                             device="cpu")
        run = {"loss": [], "grad_norm": []}
        for b in train_batches("tp2_tiles1")[:INF_FUSED_STEPS]:
            m = eng.train_step({"input_ids": torch.from_numpy(b)})
            run["loss"].append(float(m["loss"]))
            run["grad_norm"].append(float(m["grad_norm"]))
        fused[where] = run
        del eng
    out["fused"] = fused
    return out


#: the ladder models at tp 2: tiny widths, 2 layers (ResNet ``tiny``),
#: ``LADDER_ROWS`` rows a step, three steps
LADDER_KINDS = ("opt", "bert", "resnet")
LADDER_ROWS, LADDER_SEQ = 2, 16


def ladder_config(tp: int = 2) -> Dict[str, Any]:
    """The ladder models' and the client's config at ``tp``."""
    cfg = dict(TRAIN_BASE, train_micro_batch_size_per_gpu=LADDER_ROWS,
               zero_optimization={"stage": 0})
    if tp > 1:
        cfg["tensor_parallel"] = {"autotp_size": tp}
    return cfg


def ladder_model(kind: str):
    if kind == "opt":
        return OPTModel(OPTConfig.tiny(num_layers=2, dtype=torch.float32,
                                       param_dtype=torch.float32),
                        device="cpu")
    if kind == "bert":
        return BertModel(BertConfig.tiny(num_layers=2, dtype=torch.float32,
                                         param_dtype=torch.float32,
                                         attn_impl="flash"), device="cpu")
    return ResNetModel(ResNetConfig.tiny(dtype=torch.float32,
                                         param_dtype=torch.float32),
                       device="cpu")


def ladder_batches(kind: str) -> List[Dict[str, np.ndarray]]:
    """Each step's batch (``LADDER_ROWS`` rows, every tensor rank the
    same): OPT ids; BERT ids with a pad tail on row 1, token types and
    ~30 % MLM labels; ResNet 8 x 8 images and labels."""
    out = []
    for i in range(TRAIN_STEPS):
        r = np.random.RandomState(30 + i)
        if kind == "resnet":
            out.append({"images": r.randn(LADDER_ROWS, 8, 8, 3).astype(
                np.float32), "labels": r.randint(0, 10, (LADDER_ROWS,))})
            continue
        ids = r.randint(0, 512, (LADDER_ROWS, LADDER_SEQ))
        if kind == "opt":
            out.append({"input_ids": ids})
            continue
        mask = np.ones_like(ids)
        mask[1, LADDER_SEQ - 4:] = 0
        labels = np.where((r.rand(*ids.shape) < 0.3) & (mask == 1), ids,
                          -100)
        labels[:, 0] = ids[:, 0]
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": (np.arange(LADDER_SEQ)[None] >=
                                       LADDER_SEQ // 2).astype(np.int64)
                    .repeat(LADDER_ROWS, 0), "labels": labels})
    return out


def train_steps(engine, batches) -> Dict[str, list]:
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        m = engine.train_step({k: torch.from_numpy(v) for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


def _ladder_tp(kind: str, weights) -> Dict[str, Any]:
    """A whole ladder model split by ``initialize`` at tp 2: its steps,
    the rank's masters and split dims."""
    groups.reset_mesh()
    model = ladder_model(kind)
    model.load_state_dict(_state_dict(weights))
    engine, *_ = initialize(model=model, config=ladder_config(),
                            device="cpu")
    out = train_steps(engine, ladder_batches(kind))
    out.update(tp_rank=model.tp_rank, dims=_split_dims(model),
               params=_local_whole(engine))
    return out


def _autotp_client(weights, ids: np.ndarray) -> Dict[str, Any]:
    """The client split by ``tp_model_init`` (AutoTP's name policy) and
    trained through ``initialize`` at tp 2 on the OPT batches; then
    ``init_inference(tensor_parallel=...)`` on a whole client: its
    logits."""
    groups.reset_mesh()
    model = ClientLM()
    model.load_state_dict(_state_dict(weights))
    tp_model_init(model, tp_size=2)
    attn = model.layers[0].self_attn
    engine, *_ = initialize(model=model, config=ladder_config(),
                            device="cpu")
    out = train_steps(engine, ladder_batches("opt"))
    out.update(tp_rank=model.tp_rank, dims=_split_dims(model),
               params=_local_whole(engine),
               heads=[attn.num_heads, attn.num_key_value_heads],
               lm_head_gathers=model.lm_head.gather_output)
    whole = ClientLM()
    whole.load_state_dict(_state_dict(weights))
    v1 = init_inference(whole, tensor_parallel={"tp_size": 2},
                        device="cpu")
    with torch.no_grad():
        out["v1_logits"] = v1(torch.from_numpy(ids)).numpy()
    return out


def tp_train_rank(rank: int, llama_w, mixtral_w, root: Dict[str, str],
                  more: Dict[str, Any]) -> Dict[str, Any]:
    """Every training case of this world size on this rank (two ranks:
    also fp16, the checkpoints, the hybrid engine, ZeRO-Infinity, the
    ladder models and the AutoTP client at tp 2; four: tp 2 x sp 2 and its
    checkpoint, and the expert-axis refusal)."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    out: Dict[str, Any] = {}
    for name, (w, *_rest) in TRAIN_CASES.items():
        if w != world:
            continue
        kind = TRAIN_CASES[name][3]
        out[name], engine = _train_case(
            name, mixtral_w if kind == "mixtral" else llama_w)
        if name == "tp2_tiles1":
            out["ckpt"] = _checkpoints(engine, name, llama_w, root)
        del engine
    if world == 2:
        out["fp16"] = _fp16_skip(llama_w)
        out["hybrid"] = _hybrid(llama_w)
        out["infinity"] = _infinity_tp(llama_w, root["inf_tp2"])
        for kind in LADDER_KINDS:
            out[kind] = _ladder_tp(kind, more[kind])
        out["client"] = _autotp_client(more["client"], more["client_ids"])
    else:
        for name in TPSP_CASES:
            out[name], engine = _tpsp_case(name, llama_w)
            if name == "tp2sp2_ulysses_t1":
                out["tpsp_ckpt"] = _tpsp_checkpoint(engine, llama_w,
                                                    root["tp2sp2"])
            del engine
        out["refusals"] = _refusals_4(mixtral_w)
    return out


def np_weights(model) -> dict:
    """A model's state dict as fp32 numpy arrays (sent to the ranks by
    value)."""
    return {k: v.float().numpy() for k, v in model.state_dict().items()}


__all__ = ["CLIENT", "ClientLM", "HYBRID_NEW", "HYBRID_PROMPT",
           "LADDER_KINDS", "TPSP_CASES", "TRAIN_CASES", "TRAIN_MODEL",
           "comm_rank", "engines_rank", "frontend_rank", "ladder_batches",
           "ladder_config", "ladder_model", "np_weights", "serve_script",
           "stray_rank", "tp_train_rank", "tpsp_model_config",
           "train_batches", "train_config", "train_model_config",
           "train_steps"]

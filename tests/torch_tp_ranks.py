"""Rank bodies of the tensor-parallel tests (``test_torch_tensor_parallel``).

``launcher.local.launch`` runs each in fresh processes, which import this
module by name; it imports no JAX, so a rank starts with PyTorch alone.
Every body joins a gloo process group on the CPU, builds its mesh, and
returns plain values (lists and numpy arrays) to the test.
"""

import time

import torch

from deepspeed_tpu_torch import (KVCacheConfig, LlamaConfig, LlamaModel,
                                 build_engine_v2, build_serving_frontend,
                                 comm, init_distributed, init_inference)
from deepspeed_tpu_torch.models import shard_llama_params
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups

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


def engines_rank(rank: int, cfg_kw, weights, prompts, n_new, cache_kw,
                 engine_kw, ids, v1_new):
    """The v2 engine on this rank's shard (greedy tokens, the first
    prompt's last-token logits from ``prefill``, the decode path, the
    pool's heads); then v1 ``init_inference(tensor_parallel={"tp_size":
    2})`` on a whole model, which builds its own mesh and splits the
    weights."""
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
    return {"tokens": tokens, "logits": logits.numpy(),
            "attn_path": eng.last_attn_path,
            "pool_heads": eng.pool["k"].shape[3], "v1_tokens": v1_out.numpy(),
            "v1_tp": whole.tp,
            "v1_q_rows": whole.layers[0].q_proj.weight.shape[0]}


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


def np_weights(model) -> dict:
    """A model's state dict as fp32 numpy arrays (sent to the ranks by
    value)."""
    return {k: v.float().numpy() for k, v in model.state_dict().items()}


__all__ = ["comm_rank", "engines_rank", "frontend_rank", "np_weights",
           "serve_script", "stray_rank"]

"""Mixtral on meshes that cross the expert axis with a second one: expert x
``seq`` and expert x tensor, against the JAX package.

One gloo launch on 4 ranks (rank bodies in ``torch_seq_ranks``, no JAX
there) in a thread while this process runs the JAX side on 4 of the 8
virtual CPU devices.  fp32 throughout; the JAX helpers are
``test_torch_seq_models``'.

* the MoE layer at ep 2 x sp 2 (sparse and dense rungs): the logits
  gathered over the expert axis and ``seq`` and put in JAX's global
  ``(b, s)`` order, the buffers exchanged over the ``expert`` group of
  each ``seq`` coordinate; the routing equals JAX's exactly with tokens
  dropped, the output chunks, ``l_aux`` and the gradients within 1e-5;
* Mixtral trained 3 steps through ``initialize`` at ep 2 x sp 2 (one row
  a data coordinate, its chunks over ``seq``) and at ep 2 x tp 2 (each
  rank's ``E/ep`` experts by their ``I/tp`` columns, JAX's ``P(pipe,
  expert, None, tensor)``) against JAX's engine on the same mesh: losses
  and grad norms within 2e-4 relative, the final masters within 2e-4
  (``test_torch_seq_models.assert_masters_close``);
  each rank's expert shards are the slice of the reference leaves, and
  every rank of one model reports the same;
* at ep 2 x tp 2 a checkpoint writes one file a (data-parallel, tensor)
  coordinate, resumes bit for bit, and loads in one process (ep 1, tp 1)
  to the same leaves.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
import torch_seq_ranks as ranks
from test_torch_seq_models import (check_route, check_training, joined,
                                   start)
from torch_parity import free_jax_cycles  # noqa: F401

MESH_CASES = ["mixtral_ep2sp2", "mixtral_ep2tp2"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ep_tp_ckpt"))
    get, thread, weights = start(4, MESH_CASES, ckpt)
    yield {"get": get, "weights": weights, "ckpt": ckpt}
    thread.join()


@pytest.mark.parametrize("name", [n for n, c in ranks.ROUTE_CASES.items()
                                  if c[0] == 2])
def test_routing_over_expert_and_seq_matches_jax(launched, name):
    check_route(launched["get"](), name)


@pytest.mark.parametrize("name", MESH_CASES)
def test_mixtral_on_expert_mesh_matches_jax(launched, name):
    got = [r[name] for r in launched["get"]()]
    ep, sp, tp = ranks.TRAIN_CASES[name][1]
    assert sorted((g["coords"]["expert"], g["coords"]["seq"],
                   g["coords"]["tensor"]) for g in got) == [
        (e, s, t) for e in range(ep) for s in range(sp) for t in range(tp)]
    E, I = 4, 176  # MixtralConfig.tiny's experts and FFN dim
    for g in got:  # this rank's experts by its columns
        w = g["before"]["layers.0.w_gate"]
        assert w.shape == (E // ep, 128, I // tp)
        e, t = g["coords"]["expert"], g["coords"]["tensor"]
        whole = launched["weights"][name]["layers.0.w_gate"]
        assert np.array_equal(w, whole[e * E // ep:(e + 1) * E // ep, :,
                                       t * I // tp:(t + 1) * I // tp])
    check_training(got, name, launched["weights"][name])


def test_ep2tp2_checkpoint_resumes_and_loads_in_one_process(launched):
    got = launched["get"]()
    for r in got:
        c = r["mixtral_ep2tp2"]["checkpoint"]
        assert c["equal"] and c["again"] == c["first"]
        assert c["files"] == [f"dp_rank_{d:05d}_tp_rank_{t:02d}.pt"
                              for d in range(2) for t in range(2)]
    want = joined([dict(r["mixtral_ep2tp2"],
                        at_save=r["mixtral_ep2tp2"]["checkpoint"]["at_save"])
                   for r in got], "at_save")
    model = dst.MixtralModel(ranks.mixtral_config(), device="cpu", seed=3)
    cfg = ranks.case_config("mixtral_ep2tp2")
    cfg.update(train_micro_batch_size_per_gpu=ranks.ROWS,
               moe=dict(cfg["moe"], expert_parallel_size=1),
               tensor_parallel={"autotp_size": 1})
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    engine.load_checkpoint(launched["ckpt"], tag="ep2tp2")
    for k, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[k]), k
    assert engine.optimizer.count == 2
    # the third step from there is the ranks' third step
    m = engine.train_step({k: torch.from_numpy(v) for k, v in
                           ranks.batches("mixtral_ep2tp2")[2].items()})
    first = got[0]["mixtral_ep2tp2"]["checkpoint"]["first"]
    np.testing.assert_allclose(float(m["loss"]), first[0], rtol=1e-5)

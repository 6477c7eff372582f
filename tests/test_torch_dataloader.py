"""The port's dataloader and seqlen curriculum against the JAX package's.

* each data-parallel rank's rows of every batch (dp 1, 2 and 4, two
  epochs, shuffled, with and without ``drop_last``) equal that rank's
  contiguous block of the global batch JAX's ``DeepSpeedDataLoader``
  yields for the same dataset and seed; a final batch that does not split
  over the ranks goes whole to each, as JAX replicates it;
* ``resume_from_samples`` lands where JAX's does, in the cases of
  ``tests/unit/elasticity/test_reshard_restore.py``;
* every curriculum schedule gives JAX's ``get_difficulty`` over steps
  0-50, ``truncate_batch`` JAX's batch, and ``DeepSpeedDataSampler`` JAX's
  draws;
* the curriculum reaches the loader through ``initialize``, in both config
  forms (``tests/unit/runtime/test_data_pipeline.py``);
* three steps through ``initialize(training_data=...)`` give the JAX
  engine's losses, its own loader fed the same data (fp32: 1e-5, the
  engine tolerance of ``test_torch_train``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime import dataloader as jax_dataloader
from deepspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jcs
from deepspeed_tpu.runtime.data_pipeline import data_sampler as jds
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.runtime.data_pipeline import (CurriculumDataLoader,
                                                       CurriculumScheduler,
                                                       DeepSpeedDataSampler,
                                                       truncate_batch)
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from test_torch_train import BASE, training_pair
from torch_parity import free_jax_cycles  # noqa: F401


def _mesh():
    return build_mesh(MeshLayout.infer(1, dp=1), devices=jax.devices()[:1])


def _dataset(n=22, seq=12):
    rng = np.random.RandomState(3)
    return [{"input_ids": rng.randint(0, 512, seq).astype(np.int32),
             "labels": rng.randint(0, 512, seq).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("drop_last", [True, False],
                         ids=["drop_last", "keep_last"])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_rank_rows_match_jax_batches(dp, drop_last):
    data = _dataset()
    jl = jax_dataloader.DeepSpeedDataLoader(
        data, batch_size=8, mesh=_mesh(), shuffle=True, seed=1234,
        drop_last=drop_last)
    want = [[jax.tree.map(np.asarray, b) for b in jl] for _ in range(2)]
    loaders = [DeepSpeedDataLoader(data, batch_size=8, dp_rank=r,
                                   dp_world_size=dp, shuffle=True, seed=1234,
                                   drop_last=drop_last) for r in range(dp)]
    assert all(len(dl) == len(jl) for dl in loaders)
    for epoch in range(2):
        got = [list(dl) for dl in loaders]
        assert all(len(g) == len(want[epoch]) for g in got)
        for i, wb in enumerate(want[epoch]):
            rows = wb["input_ids"].shape[0]
            n = rows // dp if rows % dp == 0 else rows
            for r in range(dp):
                lo = r * n if rows % dp == 0 else 0
                for k in ("input_ids", "labels"):
                    t = got[r][i][k]
                    assert isinstance(t, torch.Tensor)
                    np.testing.assert_array_equal(t.numpy(),
                                                  wb[k][lo:lo + n])
    if not drop_last:  # 22 = 2 x 8 + 6: the last batch's six rows
        assert want[0][-1]["input_ids"].shape[0] == 6


@pytest.mark.parametrize("n,bs,consumed", [(32, 8, 20), (32, 8, 40),
                                           (32, 8, 32), (100, 25, 180)])
def test_resume_from_samples_matches_jax(n, bs, consumed):
    data = [{"x": np.full((4,), i, np.float32)} for i in range(n)]
    jl = jax_dataloader.DeepSpeedDataLoader(data, batch_size=bs,
                                            mesh=_mesh(), shuffle=False)
    pl = DeepSpeedDataLoader(data, batch_size=bs, shuffle=False)
    jl.resume_from_samples(consumed)
    pl.resume_from_samples(consumed)
    assert (pl._epoch, pl._resume_skip_batches) == \
        (jl._epoch, jl._resume_skip_batches)
    got, want = list(pl), [np.asarray(b["x"]) for b in jl]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"].numpy(), w)


SCHEDULES = {
    "fixed_linear": {"min_difficulty": 8, "max_difficulty": 64,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 37,
                                         "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 16, "max_difficulty": 256,
                   "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 45,
                                       "difficulty_step": 16,
                                       "root_degree": 3}},
    "fixed_discrete": {"min_difficulty": 1, "max_difficulty": 5,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 3, 7],
                                           "max_step": [5, 20]}},
    "custom": {"min_difficulty": 1, "max_difficulty": 9,
               "schedule_type": "custom"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_curriculum_schedules_match_jax(name):
    fn = (lambda s: 1 + (s * 7) % 9) if name == "custom" else None
    want = jcs.CurriculumScheduler(SCHEDULES[name], custom_fn=fn)
    got = CurriculumScheduler(SCHEDULES[name], custom_fn=fn)
    assert [got.get_difficulty(s) for s in range(51)] == \
        [want.get_difficulty(s) for s in range(51)]
    assert got.update_difficulty(17) == want.update_difficulty(17)


def test_truncate_batch_and_data_sampler_match_jax():
    batch = _dataset(4, 24)
    stacked = {k: np.stack([b[k] for b in batch]) for k in batch[0]}
    stacked["mask_1d"] = np.ones(4)
    want = jds.truncate_batch(stacked, 10)
    got = truncate_batch({k: torch.from_numpy(v) for k, v in
                          stacked.items()}, 10)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    difficulties = np.random.RandomState(1).randint(1, 20, 40)
    cfg = SCHEDULES["fixed_linear"] | {"min_difficulty": 4,
                                       "max_difficulty": 20}
    data = _dataset(40)
    js = jds.DeepSpeedDataSampler(data, difficulties, 6, cfg, seed=5)
    ps = DeepSpeedDataSampler(data, difficulties, 6, cfg, seed=5)
    js.set_step(3)
    ps.set_step(3)
    for _ in range(4):
        w, g = next(js), next(ps)
        np.testing.assert_array_equal(g["input_ids"].numpy(),
                                      w["input_ids"])


def test_repeating_loader_and_collate_fn():
    data = _dataset(8)
    seen = []

    def collate(items):
        seen.append(len(items))
        return {"input_ids": np.stack([it["input_ids"] for it in items]),
                "n": len(items)}
    dl = DeepSpeedDataLoader(data, batch_size=4, dp_rank=1, dp_world_size=2,
                             collate_fn=collate)
    rep = RepeatingLoader(dl)
    batches = [next(rep) for _ in range(5)]  # 2 batches an epoch
    assert seen == [2] * 5
    assert all(isinstance(b["input_ids"], torch.Tensor) and b["n"] == 2
               for b in batches)
    np.testing.assert_array_equal(batches[0]["input_ids"].numpy(),
                                  batches[2]["input_ids"].numpy())
    with pytest.raises(ValueError, match="does not split"):
        DeepSpeedDataLoader(data, batch_size=5, dp_world_size=2)


CURRICULUM = {"enabled": True, "min_difficulty": 8, "max_difficulty": 32,
              "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 4,
                                  "difficulty_step": 8}}


@pytest.mark.parametrize("form", ["curriculum_learning", "data_efficiency"])
def test_curriculum_wired_through_initialize(form):
    _, _, tm = training_pair(num_layers=1)
    group = ({"curriculum_learning": CURRICULUM} if form ==
             "curriculum_learning" else {"data_efficiency": {
                 "enabled": True, "data_sampling": {
                     "curriculum_learning": CURRICULUM}}})
    engine, _, dl, _ = dst.initialize(
        model=tm, config=dict(BASE, **group), device="cpu",
        training_data=_dataset(16, 32))
    assert isinstance(dl, CurriculumDataLoader)
    assert engine.curriculum_scheduler is dl.scheduler
    assert engine.config.accepted_without_effect == ()
    it = iter(dl)
    first = next(it)
    assert first["input_ids"].shape == (2, 8)  # truncated at step 0
    assert np.isfinite(float(engine.train_step(first)["loss"]))
    engine.global_steps = 10  # past the schedule
    late = next(it)
    assert late["input_ids"].shape == (2, 32)  # the full length


def test_random_ltd_is_not_ported():
    _, _, tm = training_pair(num_layers=1)
    with pytest.raises(NotImplementedError, match="random_ltd.*item 10"):
        dst.initialize(model=tm, device="cpu", config=dict(
            BASE, data_efficiency={"enabled": True, "data_routing": {
                "random_ltd": {"enabled": True}}}))


def test_initialize_training_data_matches_jax_engine():
    jm, params, tm = training_pair(num_layers=2)
    data = [{"input_ids": d["input_ids"]} for d in _dataset(16, 16)]
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    je, _, jdl, _ = jdst.initialize(model=jm, model_parameters=params,
                                    config=dict(BASE), mesh=mesh,
                                    training_data=data)
    engine, _, dl, _ = dst.initialize(model=tm, config=dict(BASE),
                                      device="cpu", training_data=data)
    want = [float(je.train_step(b)["loss"]) for b, _ in zip(jdl, range(3))]
    got = [float(engine.train_step(b)["loss"]) for b, _ in zip(dl, range(3))]
    np.testing.assert_allclose(got, want, rtol=1e-5)

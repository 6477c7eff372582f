"""``initialize`` on several ranks trains one model.

Two gloo ranks (``launcher.local.launch``, rank bodies in
``torch_dp_ranks``) that built the model from different seeds, each
feeding its half of the global batch, give the losses of one process
running the global batch (two accumulation steps of the same rows), with
the world alone, a data-parallel mesh or an mpu naming the world.  A
world of one, with a one-rank gloo group or none, trains exactly as
before: the same losses.  A mesh or mpu of two data-parallel ranks
without a process group of two is refused.
"""

import types

import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.launcher import launch

#: every launch's limit: a rank that hangs fails the test, not the suite
TIMEOUT = 120


@pytest.mark.parametrize("how", ["world", "world_and_mesh", "world_and_mpu"])
def test_two_ranks_train_one_model(how):
    want = ranks.train_steps(initialize(model=ranks.tiny_model(),
                                        config=ranks.CONFIG,
                                        device="cpu")[0])
    got = launch(ranks.initialize_rank, 2, (how,), timeout=TIMEOUT)
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=1e-6)


def test_one_rank_world_trains_as_without_a_group():
    want = ranks.train_steps(initialize(model=ranks.tiny_model(),
                                        config=ranks.CONFIG,
                                        device="cpu")[0])
    assert np.all(np.isfinite(want))
    (got,) = launch(ranks.initialize_rank, 1, ("world_and_mesh",),
                    timeout=TIMEOUT)
    assert got == want


@pytest.mark.parametrize("what", ["mesh", "mpu"])
def test_a_data_axis_of_two_is_refused_without_a_group(what):
    kw = ({"mesh": types.SimpleNamespace(shape={"data": 2, "tensor": 1})}
          if what == "mesh" else
          {"mpu": types.SimpleNamespace(
              get_data_parallel_world_size=lambda: 2,
              get_data_parallel_group=lambda: None)})
    with pytest.raises(ValueError, match="more ranks than the process "
                                         "group holds"):
        initialize(model=ranks.tiny_model(), config=ranks.CONFIG,
                   device="cpu", **kw)
    # a data axis of one is accepted
    one = ({"mesh": types.SimpleNamespace(shape={"data": 1, "tensor": 1})}
           if what == "mesh" else
           {"mpu": types.SimpleNamespace(
               get_data_parallel_world_size=lambda: 1)})
    engine, *_ = initialize(model=ranks.tiny_model(), config=ranks.CONFIG,
                            device="cpu", **one)
    assert torch.isfinite(torch.tensor(ranks.train_steps(engine, 1))).all()

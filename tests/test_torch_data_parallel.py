"""``initialize`` refuses to train data-parallel replicas it cannot average.

Data parallelism is not ported: on more than one rank each engine would
step on its own batch and never average its gradients.  Two gloo ranks
(``launcher.local.launch``, rank bodies in ``torch_dp_ranks``) must get
"not ported yet" from ``initialize``, with and without a data-parallel
mesh, and a mesh or mpu of two data-parallel ranks must be refused even
without a process group.  A world of one, with a one-rank gloo group or
none, trains exactly as before: the same losses.
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


@pytest.mark.parametrize("with_mesh", [False, True],
                         ids=["world", "world_and_mesh"])
def test_two_ranks_are_refused(with_mesh):
    got = launch(ranks.initialize_rank, 2, (with_mesh,), timeout=TIMEOUT)
    for msg in got:
        assert isinstance(msg, str), msg
        assert "data parallelism over 2 ranks is not ported yet" in msg


def test_one_rank_world_trains_as_without_a_group():
    want = ranks.train_steps(initialize(model=ranks.tiny_model(),
                                        config=ranks.CONFIG,
                                        device="cpu")[0])
    assert np.all(np.isfinite(want))
    (got,) = launch(ranks.initialize_rank, 1, (True,), timeout=TIMEOUT)
    assert got == want


@pytest.mark.parametrize("what", ["mesh", "mpu"])
def test_a_data_axis_of_two_is_refused_without_a_group(what):
    kw = ({"mesh": types.SimpleNamespace(shape={"data": 2, "tensor": 1})}
          if what == "mesh" else
          {"mpu": types.SimpleNamespace(
              get_data_parallel_world_size=lambda: 2)})
    with pytest.raises(NotImplementedError, match="not ported yet"):
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

"""Where the fp32 masters of the port and of the JAX engine part after a
few Adam steps, and why.

The Infinity tests on ranks (``test_torch_infinity_ranks``) hold the
masters against JAX per leaf in relative norm: a few elements differ by
up to ~4e-4 after three steps (lr 1e-3), on the streamed engines and the
on-device ones alike.  This test runs that configuration (the 4-layer tiny
Llama, fp32, flash route, 4 rows of 32 tokens, AdamW lr 1e-3, three steps)
on the port's on-device engine and the JAX engine on one device, and
names the elements: every master element more than 1e-5 from JAX's has a
first-step gradient below 1e-5 of its leaf's largest in both packages,
where fp32 summation order decides the value (the two gradients agree to
that level everywhere, and often differ in sign there).  Adam's ``m /
sqrt(v)`` turns such a gradient into a step of about ``lr`` whatever its
size, so its sign, not its size, sets the update.  A handful of elements
a leaf is affected.  The gap is the reference's arithmetic meeting the
port's, not a fault of either (ROADMAP Queue 3, reference-side notes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
import torch_inf_ranks as ranks
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import llama_params_from_jax
from torch_parity import free_jax_cycles  # noqa: F401

CASE = "dp2_fused"  # its model, rows and optimizer, in one process
GAP = 1e-5           # a master element this far from JAX's is named
LAST_BIT = 1e-5      # of the leaf's largest |gradient|


def _port(tree) -> dict:
    host = jax.tree.map(np.asarray, jax.device_get(tree))
    return {k: v.numpy() for k, v in llama_params_from_jax(host).items()}


def test_master_gap_lies_on_last_bit_gradients():
    jm = JaxLlamaModel(JaxLlamaConfig.tiny(dtype=jnp.float32, num_layers=4,
                                           attn_impl="flash"))
    params = jm.init_params(jax.random.PRNGKey(0))
    weights = _port(params)
    cfg = {"train_micro_batch_size_per_gpu": ranks.ROWS,
           "steps_per_print": 0, "optimizer": ranks.OPTIMIZER}
    batches = ranks.global_batches(CASE)
    want_grad = _port(jax.grad(jm.loss)(params, {
        "input_ids": jnp.asarray(batches[0])}))
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    try:
        engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                     config=cfg, mesh=mesh)
        for b in batches:
            engine.train_step({"input_ids": jnp.asarray(b)})
        want = _port(engine.state.params)
    finally:
        groups.reset_mesh()

    model = dst.LlamaModel(ranks.model_config(CASE, {}), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    model.loss({"input_ids": torch.from_numpy(batches[0])}).backward()
    got_grad = {k: p.grad.numpy().copy() for k, p in
                model.named_parameters()}
    model.zero_grad()
    port, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    for b in batches:
        port.train_step({"input_ids": torch.from_numpy(b)})
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}

    named, largest = 0, (0.0, "")
    for k, w in want.items():
        scale = np.abs(want_grad[k]).max()
        # one gradient, up to fp32 summation order
        assert np.abs(got_grad[k] - want_grad[k]).max() <= LAST_BIT * scale, k
        gap = np.abs(got[k] - w)
        far = np.argwhere(gap > GAP)
        named += len(far)
        assert len(far) <= max(8, gap.size // 1000), (k, len(far))
        for i in map(tuple, far):
            for g in (got_grad[k][i], want_grad[k][i]):
                assert abs(g) <= LAST_BIT * scale, (k, i, g, scale)
        if gap.max() > largest[0]:
            largest = (float(gap.max()), k)
    print(f"{named} master elements more than {GAP} from JAX's; the "
          f"largest {largest[0]:.3e} in {largest[1]}")
    assert named > 0  # the gap the Infinity tests bound is here

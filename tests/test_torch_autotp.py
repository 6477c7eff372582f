"""AutoTP's name policy for client modules, without a process group.

* the port's ``infer_tp_specs`` against JAX's on the name sets of
  ``tests/unit/test_feature_round2.py`` (the zoo's stacked leaves with
  their head dims, the Hugging Face spellings, Flax nesting and dotted
  keys), each leaf given to the port in torch's layout (JAX's ``[..., in,
  out]`` transposed to ``[..., out, in]``; the head-dim leaves ``wq``
  ``[..., H, heads, hd]`` → ``[..., heads, hd, H]`` and ``wo`` ``[...,
  heads, hd, H]`` → ``[..., H, heads, hd]``): the port splits the dim
  JAX's spec shards, moved by the same transposition;
* ``auto_tp`` on an HF-shaped client (``torch_tp_ranks.ClientLM``) at
  each rank of a tensor axis of 2: the column layers keep their block of
  rows (and of their biases), the row layers their block of columns (their
  biases whole), every split leaf marked ``ds_tensor``, the parameter
  objects kept, the attention's head counts halved, ``lm_head`` (no row
  partner) all-gathering, a row layer without a column partner splitting
  its input, a tied head left whole; a head count or a weight that does
  not divide raises, naming it, before anything is split.

The training parity of the split client (tp 2 against tp 1 and JAX's
engine) runs in ``test_torch_tp_train``'s 2-rank launch.
"""

import jax.numpy as jnp
import pytest
import torch
from torch import nn

import torch_tp_ranks as ranks
from deepspeed_tpu.runtime.tensor_parallel import \
    infer_tp_specs as jax_infer_tp_specs
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.parallel.mesh import ProcessMesh
from deepspeed_tpu_torch.runtime.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, auto_tp, infer_tp_specs,
    split_model_)

#: test_feature_round2.py:306's tree and :402's
JAX_TREES = [
    {"embed": (512, 64),
     "layers": {"attn": {"wq": (2, 64, 8, 8), "wo": (2, 8, 8, 64)},
                "mlp": {"w_up": (2, 64, 256), "w_down": (2, 256, 64),
                        "norm": (2, 64)}},
     "q_proj": (64, 64), "down_proj": (256, 64), "bias": (64,)},
    {"q_proj": {"kernel": (64, 64), "bias": (64,)},
     "self_attn.o_proj.weight": (64, 64)},
]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _to_torch(name: str, ndim: int):
    """The permutation from a JAX leaf's dims to torch's layout: torch
    dim ``i`` is JAX dim ``perm[i]``."""
    last = name.rsplit(".", 1)[-1]
    lead = list(range(ndim - 3)) if ndim >= 3 else []
    if ndim < 2:
        return list(range(ndim))
    if last in ("wq", "wk", "wv") and ndim >= 3:
        return lead + [ndim - 2, ndim - 1, ndim - 3]
    if last == "wo" and ndim >= 3:
        return lead + [ndim - 1, ndim - 3, ndim - 2]
    return list(range(ndim - 2)) + [ndim - 1, ndim - 2]


def _jax_specs(tree):
    leaves = {}

    def build(t):
        return {k: build(v) if isinstance(v, dict) else jnp.zeros(v)
                for k, v in t.items()}
    specs = jax_infer_tp_specs(build(tree))
    for name, _ in _flat(tree):
        node = specs
        for part in _split_path(tree, name):
            node = node[part]
        leaves[name] = next((i for i, a in enumerate(tuple(node))
                             if a == "tensor"), None)
    return leaves


def _split_path(tree, name):
    """The dict keys of ``name`` in ``tree`` (a key may hold dots)."""
    for k, v in tree.items():
        if name == k:
            return [k]
        if isinstance(v, dict) and name.startswith(k + "."):
            return [k] + _split_path(v, name[len(k) + 1:])
    raise KeyError(name)


@pytest.mark.parametrize("tree", range(len(JAX_TREES)))
def test_infer_tp_specs_matches_jax_transposed(tree):
    shapes = dict(_flat(JAX_TREES[tree]))
    want = _jax_specs(JAX_TREES[tree])
    named = []
    perms = {}
    for name, shape in shapes.items():
        perm = _to_torch(name, len(shape))
        perms[name] = perm
        named.append((name, torch.zeros([shape[p] for p in perm])))
    got = infer_tp_specs(named)
    assert set(got) == set(want)
    split = 0
    for name, jdim in want.items():
        port = None if jdim is None else perms[name].index(jdim)
        assert got[name] == port, (name, got[name], jdim)
        split += port is not None
    assert split == (6 if tree == 0 else 2)


def _mesh(rank: int) -> ProcessMesh:
    # no process group: auto_tp only records it; nothing here runs forward
    return ProcessMesh(MeshLayout(tp=2), rank=rank,
                       groups={("tensor",): None})


@pytest.mark.parametrize("rank", [0, 1])
def test_auto_tp_splits_an_hf_client(rank):
    whole = ranks.ClientLM(seed=0)
    model = ranks.ClientLM(seed=0)
    before = {n: id(p) for n, p in model.named_parameters()}
    auto_tp(model, _mesh(rank))
    assert (model.tp, model.tp_rank) == (2, rank)
    assert {n: id(p) for n, p in model.named_parameters()} == before
    ref = dict(whole.named_parameters())
    c = ranks.CLIENT
    for i in range(c["layers"]):
        attn = model.layers[i].self_attn
        assert (attn.num_heads, attn.num_key_value_heads) == (
            c["heads"] // 2, c["kv_heads"] // 2)
        for name, kind in (("self_attn.q_proj", "column"),
                           ("self_attn.k_proj", "column"),
                           ("self_attn.v_proj", "column"),
                           ("self_attn.o_proj", "row"),
                           ("mlp.gate_proj", "column"),
                           ("mlp.up_proj", "column"),
                           ("mlp.down_proj", "row")):
            lin = model.get_submodule(f"layers.{i}.{name}")
            w, full = lin.weight, ref[f"layers.{i}.{name}.weight"]
            dim = 0 if kind == "column" else 1
            n = full.shape[dim] // 2
            assert isinstance(lin, ColumnParallelLinear if kind == "column"
                              else RowParallelLinear)
            assert torch.equal(w, full.narrow(dim, rank * n, n)), name
            assert (w.ds_tensor.dim, w.ds_tensor.tp, w.ds_tensor.rank) == \
                (dim, 2, rank)
            if lin.bias is not None:
                b = ref[f"layers.{i}.{name}.bias"]
                if kind == "column":
                    assert torch.equal(lin.bias, b.narrow(0, rank * n, n))
                    assert lin.bias.ds_tensor.dim == 0
                else:  # added once after g
                    assert torch.equal(lin.bias, b)
                    assert not hasattr(lin.bias, "ds_tensor")
            if kind == "column":
                assert not lin.gather_output
            else:
                assert not lin.split_input
    # lm_head has no row partner in its parent: its output is gathered
    assert isinstance(model.lm_head, ColumnParallelLinear)
    assert model.lm_head.gather_output
    assert model.lm_head.weight.shape == (c["vocab"] // 2, c["H"])
    for name in ("embed_tokens.weight", "norm.weight",
                 "layers.0.input_layernorm.weight"):
        p = model.get_parameter(name)
        assert torch.equal(p, ref[name]) and not hasattr(p, "ds_tensor")


class _RowAlone(nn.Module):
    """A row-named layer whose parent holds no column layer, and a head
    tied to the embedding."""

    def __init__(self):
        super().__init__()
        self.embed = nn.Embedding(16, 8)
        self.fc2 = nn.Linear(8, 8)
        self.lm_head = nn.Linear(8, 16, bias=False)
        self.lm_head.weight = self.embed.weight


def test_auto_tp_row_alone_splits_its_input_and_tied_head_stays_whole():
    model = _RowAlone()
    auto_tp(model, _mesh(1))
    assert isinstance(model.fc2, RowParallelLinear)
    assert model.fc2.split_input and model.fc2.weight.shape == (8, 4)
    assert type(model.lm_head) is nn.Linear
    assert model.lm_head.weight is model.embed.weight
    assert model.embed.weight.shape == (16, 8)


def test_auto_tp_refuses_what_does_not_divide():
    model = ranks.ClientLM(seed=0)
    model.layers[1].self_attn.num_key_value_heads = 3
    with pytest.raises(ValueError, match=r"layers\.1\.self_attn\."
                       r"num_key_value_heads = 3 does not split over tp=2"):
        auto_tp(model, _mesh(0))
    # nothing was split
    assert type(model.layers[0].self_attn.q_proj) is nn.Linear
    assert model.layers[0].self_attn.q_proj.weight.shape[0] == \
        ranks.CLIENT["H"]
    odd = nn.Module()
    odd.up_proj = nn.Linear(4, 5)
    with pytest.raises(ValueError, match=r"up_proj\.weight \(5, 4\) does "
                       "not split over tp=2"):
        auto_tp(odd, _mesh(0))
    with pytest.raises(ValueError, match="a bare loss function"):
        split_model_(lambda batch: batch, _mesh(0))

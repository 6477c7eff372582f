"""Communication of the PyTorch port over ``torch.distributed``
(counterpart of ``deepspeed_tpu/comm``)."""

from .comm import (ReduceOp, all_gather, all_gather_into, all_reduce,
                   all_to_all_in_graph, all_to_all_single, barrier,
                   broadcast, get_local_rank, get_rank, get_world_size,
                   init_distributed, is_initialized, new_group, ppermute,
                   reduce_scatter, reset_wire, tp_copy, tp_gather, tp_max,
                   tp_reduce, tp_split, wire_counts)

__all__ = ["ReduceOp", "all_gather", "all_gather_into", "all_reduce",
           "all_to_all_in_graph", "all_to_all_single", "barrier",
           "broadcast", "get_local_rank", "get_rank", "get_world_size",
           "init_distributed", "is_initialized", "new_group", "ppermute",
           "reduce_scatter", "reset_wire", "tp_copy", "tp_gather", "tp_max",
           "tp_reduce", "tp_split", "wire_counts"]

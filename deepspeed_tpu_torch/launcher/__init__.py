"""Launchers of the PyTorch port (counterpart of
``deepspeed_tpu/launcher``): local multi-process runs."""

from .local import free_port, launch, rank_env

__all__ = ["free_port", "launch", "rank_env"]

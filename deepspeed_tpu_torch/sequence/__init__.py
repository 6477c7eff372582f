"""Legacy Ulysses module (the reference's ``deepspeed/sequence/``)."""

from .layer import DistributedAttention

__all__ = ["DistributedAttention"]

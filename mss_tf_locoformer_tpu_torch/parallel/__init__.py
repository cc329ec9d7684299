"""Data- and tensor-parallel runs on ``torch.distributed`` (the JAX
package's ``parallel/``): ``multihost`` (process group, rank helpers),
``mesh`` (the ``dp x mp`` grid and its groups), ``sharding`` (the TP split
of the parameters) and ``tp_fused`` (the fused steps under TP)."""

from . import multihost
from .mesh import activate_mesh, local_mesh, make_mesh, shard_batch
from .sharding import (gather_state_dict, shard_module, shard_state_dict,
                       validate_tp)
from .tp_fused import tp_attention_step, tp_ffn_step

__all__ = ["make_mesh", "shard_batch", "local_mesh", "activate_mesh",
           "shard_state_dict", "gather_state_dict", "shard_module", "validate_tp",
           "tp_attention_step", "tp_ffn_step", "multihost"]

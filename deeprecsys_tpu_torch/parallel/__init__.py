"""Counterpart of ``deeprecsys_tpu/parallel/``: the device mesh
(``mesh.py``), table placement (``placement.py``), the sharded serving
lookups and ``sharded_apply`` (``sharding.py``, with the training losses),
and the table-wise model (``api.py``).

Not ported yet (ROADMAP.md Queue 1 item 12b): the sharded trainers
(``make_train_step``, ``make_sharded_sparse_table_step``) and multi-process
meshes (``distributed_init`` with more than one process raises).
"""

from deeprecsys_tpu_torch.parallel.mesh import Mesh, distributed_init, make_mesh
from deeprecsys_tpu_torch.parallel.sharding import (
    shard_params,
    sharded_apply,
    sharded_embedding_bag,
)

__all__ = [
    "make_mesh",
    "distributed_init",
    "shard_params",
    "sharded_apply",
    "sharded_embedding_bag",
    "Mesh",
]

"""Counterpart of ``deeprecsys_tpu/parallel/``: the device mesh
(``mesh.py``), table placement (``placement.py``), the sharded serving
lookups and ``sharded_apply`` (``sharding.py``, with the training losses,
``make_train_step`` and ``unshard_params``), and the table-wise model
(``api.py``). The mesh trainers are ``train.py``'s ``Trainer(mesh=)`` and
``make_sharded_sparse_table_step``. ``distributed_init`` starts a
``torch.distributed`` process group, over which ``make_mesh`` builds a mesh
of several processes' devices (the serving forward, the hot/cold and
table-wise lookups and models, and the mesh trainers run there). The mesh
engines serve from one process, as the JAX package's do: there they raise.
"""

from deeprecsys_tpu_torch.parallel.mesh import Mesh, distributed_init, make_mesh
from deeprecsys_tpu_torch.parallel.sharding import (
    make_train_step,
    shard_params,
    sharded_apply,
    sharded_embedding_bag,
    unshard_params,
)

__all__ = [
    "make_mesh",
    "distributed_init",
    "make_train_step",
    "shard_params",
    "sharded_apply",
    "sharded_embedding_bag",
    "unshard_params",
    "Mesh",
]

from deeprecsys_tpu_torch.ops.embedding import (
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_reference,
    embedding_bag_reference,
    init_fused_tables,
    unpack_table,
)
from deeprecsys_tpu_torch.ops.mlp import mlp_init, mlp_apply
from deeprecsys_tpu_torch.ops.interactions import cat_interaction, dot_interaction
from deeprecsys_tpu_torch.ops.rnn import (
    basic_rnn_init,
    basic_rnn_scan,
    rnn_scan,
    rnn_scan_backward,
    rnn_scan_backward_reference,
    rnn_scan_reference,
)
from deeprecsys_tpu_torch.ops.sparse_adagrad import (
    sparse_adagrad_step,
    sparse_adagrad_step_reference,
)

__all__ = [
    "embedding_bag",
    "embedding_bag_backward",
    "embedding_bag_backward_reference",
    "embedding_bag_reference",
    "init_fused_tables",
    "unpack_table",
    "mlp_init",
    "mlp_apply",
    "cat_interaction",
    "dot_interaction",
    "basic_rnn_init",
    "basic_rnn_scan",
    "rnn_scan",
    "rnn_scan_backward",
    "rnn_scan_backward_reference",
    "rnn_scan_reference",
    "sparse_adagrad_step",
    "sparse_adagrad_step_reference",
]

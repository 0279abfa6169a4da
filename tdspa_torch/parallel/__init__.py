"""Multi-GPU over ``torch.distributed`` (port of ``tdspa/parallel``)."""

from tdspa_torch.parallel.mesh import default_mesh, make_mesh, maybe_initialize_distributed
from tdspa_torch.parallel.shardings import (
    batch_sharding,
    query_sharded_batch_spec,
    replicated,
    shard_batch,
    train_batch_spec,
)

from duet_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_to_multiple,
    phase_and_tag_sharded,
)
from duet_tpu_torch.parallel.distributed import init_distributed, global_mesh, host_read_batches, gather_rows
from duet_tpu_torch.parallel.shard_cluster import cluster_sharded

from multiposenet_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicated,
    shard_batch,
)
from multiposenet_tpu_torch.parallel import distributed

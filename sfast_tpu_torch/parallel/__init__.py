"""Multi-device inference and training on ``torch.distributed``: the mesh
(``mesh.py``), the sharding rules (``sharding.py``), tensor-parallel
modules with explicit collectives (``tensor_parallel.py``) and ring
attention over ``sp`` (``ring_attention.py``).  Counterpart of
``sfast_tpu/parallel``, whose names it exports."""

from sfast_tpu_torch.parallel.mesh import make_mesh
from sfast_tpu_torch.parallel.sharding import (
    batch_spec,
    replicated,
    shard_params,
    unet_param_spec,
)

__all__ = ["make_mesh", "unet_param_spec", "shard_params", "batch_spec", "replicated"]

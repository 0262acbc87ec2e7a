"""Parallelism of the port: tensor parallelism of the U-Net
(`partition.py`) and the multi-process dryrun (`dryrun.py`); data
parallelism and FSDP live in `aqualora_torch/core/sharding.py`."""

from aqualora_torch.core.sharding import (DATA_AXIS, MODEL_AXIS,  # noqa: F401
                                          is_main_process, local_batch_size,
                                          make_mesh, shard_batch)
from aqualora_torch.parallel.partition import (  # noqa: F401
    shard_params, unet_partition_specs)

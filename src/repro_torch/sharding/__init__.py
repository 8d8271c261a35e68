from .rules import (  # noqa: F401
    batch_partition_specs,
    cache_partition_specs,
    dp_axes,
    opt_partition_specs,
    param_partition_specs,
    to_placements,
)

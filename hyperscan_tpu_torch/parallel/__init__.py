from .sharded import (  # noqa: F401
    SHARD_AXIS,
    Mesh,
    close_multihost_mesh,
    make_mesh,
    make_multihost_mesh,
    pad_batch_for_mesh,
    sharded_scan_counts,
    sharded_scan_matches,
    sharded_teddy_count,
)

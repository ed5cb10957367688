"""Several devices in one process (--devices N): parallel/tile_sharded."""

from . import tile_sharded  # noqa: F401

from .mesh import (
    gather_rays,
    init_distributed,
    make_hierarchical_mesh,
    make_mesh,
    replicate,
    shard_rays,
)

__all__ = [
    "gather_rays",
    "init_distributed",
    "make_hierarchical_mesh",
    "make_mesh",
    "replicate",
    "shard_rays",
]

"""Several devices behind one agent process: the sharded parse plane."""

from .mesh import (DeviceMesh, ShardedKernel, ShardedParsePlane, make_mesh,
                   mesh_status)

__all__ = ["DeviceMesh", "ShardedKernel", "ShardedParsePlane", "make_mesh",
           "mesh_status"]

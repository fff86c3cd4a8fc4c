"""The port's distributed pieces: ``sharding`` (meshes over local devices
or over ranks, ``MeshAxes``, placements, collectives, the parameter
rules), ``compress`` (int8 error-feedback reduction and the manual
data-parallel step), ``pipeline_parallel`` (the GPipe ring) and
``fault_tolerance`` (heartbeats and the elastic restart plan)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    Mesh, MeshAxes, from_mesh, local_mesh, param_sharding_rules, rank_mesh)

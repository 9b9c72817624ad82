"""Multi-process execution: the process setup of a device mesh
(``distributed``) and a rank's view of the mesh with its gather
(``mesh``)."""
from . import distributed, mesh

__all__ = ["distributed", "mesh"]

"""Device placement for pipeline-parallel serving."""
from .mesh import stage_devices

__all__ = ["stage_devices"]

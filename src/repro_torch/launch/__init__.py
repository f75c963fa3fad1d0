"""Entry points (``python -m repro_torch.launch.train``), meshes and the
step builders.  The reference's v5e roofline constants (peak FLOP/s, HBM
and ICI rates) are a TPU's numbers and have no counterpart here."""
from repro_torch.launch.mesh import (make_production_mesh, make_serving_mesh,
                                     make_test_mesh, mesh_dims)

__all__ = ["make_production_mesh", "make_serving_mesh", "make_test_mesh", "mesh_dims"]

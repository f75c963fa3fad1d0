"""Entry points (``python -m repro_torch.launch.train``), meshes and the
step builders, the collective accounting of a built step
(``hlo_analysis``) and the production dry run (``dryrun``).  The
roofline constants in ``launch.mesh`` are an H100's, in place of the
reference's v5e ones."""
from repro_torch.launch.mesh import (make_production_mesh, make_serving_mesh,
                                     make_test_mesh, mesh_dims)

__all__ = ["make_production_mesh", "make_serving_mesh", "make_test_mesh", "mesh_dims"]

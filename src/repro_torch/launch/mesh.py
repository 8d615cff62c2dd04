"""Production mesh entry point.  Functions, not constants: importing
touches no process group."""
from repro_torch.parallel.mesh import make_mesh, make_production_mesh  # noqa: F401

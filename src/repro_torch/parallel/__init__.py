"""Multi-rank pieces of the port (counterpart of the JAX
``repro.parallel``), over ``torch.distributed``: named meshes of rank
processes, logical-axis sharding rules and the sharded forward, the
tensor-parallel contractions, sequence-sharded attention, expert-parallel
MoE, the GPipe pipeline, int8 gradient compression, and sharded paged KV
pools."""
from repro_torch.parallel.mesh import make_mesh, make_production_mesh
from repro_torch.parallel.pagedkv import (PoolGroup, chip_of_page,
                                          chip_page_range)
from repro_torch.parallel.sharding import (Rules, constrain, default_rules,
                                           logical_to_sharding,
                                           sharding_context, spec_for)

__all__ = ["make_production_mesh", "make_mesh", "Rules", "constrain",
           "default_rules", "logical_to_sharding", "sharding_context",
           "spec_for", "PoolGroup", "chip_of_page", "chip_page_range"]

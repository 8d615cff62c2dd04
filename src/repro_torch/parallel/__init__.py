"""Multi-rank pieces of the port (counterpart of the JAX
``repro.parallel``): sharded paged KV pools over ``torch.distributed``."""
from repro_torch.parallel.pagedkv import (PoolGroup, chip_of_page,
                                          chip_page_range)

__all__ = ["PoolGroup", "chip_of_page", "chip_page_range"]

from repro_torch.serve.engine import (EngineStuckError, RankDivergenceError,
                                     Request, SamplingParams, ServeEngine)
from repro_torch.serve.faults import (FaultEvent, FaultPlan,
                                     TransientDispatchError)
from repro_torch.serve.kvcache import (CacheInvariantError, ContiguousCache,
                                      MemoryStats, PagedCache)
from repro_torch.serve.offload import HostTierError, PrefixStore
from repro_torch.serve.sampling import filtered_probs, sample_batch
from repro_torch.serve.tenancy import (BATCH, INTERACTIVE, PriorityClass,
                                      TenancyConfig, TenantSpec, Victim,
                                      next_victim)

__all__ = ["BATCH", "CacheInvariantError", "ContiguousCache",
           "EngineStuckError", "FaultEvent", "FaultPlan", "HostTierError",
           "INTERACTIVE",
           "MemoryStats", "PagedCache", "PrefixStore", "PriorityClass",
           "RankDivergenceError", "Request", "SamplingParams", "ServeEngine",
           "TenancyConfig", "TenantSpec", "TransientDispatchError", "Victim",
           "filtered_probs", "next_victim", "sample_batch"]

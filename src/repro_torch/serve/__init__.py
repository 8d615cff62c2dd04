from repro_torch.serve.engine import (NonFiniteLogitsError,
                                     RankDivergenceError, Request,
                                     SamplingParams, ServeEngine)
from repro_torch.serve.kvcache import ContiguousCache, PagedCache
from repro_torch.serve.sampling import filtered_probs, sample_batch

__all__ = ["ContiguousCache", "NonFiniteLogitsError", "PagedCache", "RankDivergenceError",
           "Request", "SamplingParams", "ServeEngine", "filtered_probs",
           "sample_batch"]

from repro_torch.serve.engine import (NonFiniteLogitsError, Request,
                                     SamplingParams, ServeEngine)
from repro_torch.serve.kvcache import PagedCache
from repro_torch.serve.sampling import filtered_probs, sample_batch

__all__ = ["NonFiniteLogitsError", "PagedCache", "Request", "SamplingParams",
           "ServeEngine", "filtered_probs", "sample_batch"]

from repro_torch.models.lm import LM, make_batch
from repro_torch.models.transformer import ForwardOpts

__all__ = ["LM", "ForwardOpts", "make_batch"]

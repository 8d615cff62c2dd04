from repro_torch.models.lm import LM
from repro_torch.models.transformer import ForwardOpts

__all__ = ["LM", "ForwardOpts"]

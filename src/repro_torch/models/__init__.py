from repro_torch.models.lm import (LM, input_logical_axes, input_specs,
                                   make_batch)
from repro_torch.models.transformer import ForwardOpts

__all__ = ["LM", "ForwardOpts", "input_logical_axes", "input_specs",
           "make_batch"]

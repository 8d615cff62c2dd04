"""The training infrastructure the port needs from the JAX ``repro.core``:
checkpoints in the same on-disk format, Young's checkpoint interval and the
fault-tolerant train loop."""
from repro_torch.core.checkpoint import (CheckpointManager, latest_step,
                                         load_checkpoint, save_checkpoint)
from repro_torch.core.runtime import FTTrainLoop, job_mtbf_seconds
from repro_torch.core.youngs import checkpoint_every_n_steps, young_interval

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint", "FTTrainLoop", "job_mtbf_seconds",
           "checkpoint_every_n_steps", "young_interval"]

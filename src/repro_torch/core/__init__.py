"""The paper's primary contribution, ported: the fault-tolerant training
infrastructure (cluster failure model, health checks, alerting, gang
scheduling with buffer pool, two-tier storage, Young-interval checkpointing,
and the FT runtime composing them).  The counterpart of the JAX
``repro.core``, with the same names; all of it is host Python except the
two Autopilot probes (``health.py``), which run on a torch device."""
from repro_torch.core.aiops import Anomaly, AnomalyDetector, render_dashboard
from repro_torch.core.alerts import Alert, AlertManager, SlackSink
from repro_torch.core.checkpoint import (CheckpointManager, latest_step,
                                         load_checkpoint, save_checkpoint)
from repro_torch.core.clock import VirtualClock, WallClock
from repro_torch.core.cluster import FailureKind, Node, NodeState, SimCluster
from repro_torch.core.health import Autopilot
from repro_torch.core.runtime import (FTTrainLoop, GoodputReport,
                                      job_mtbf_seconds, simulate_job)
from repro_torch.core.scheduler import GangScheduler, Job, JobState
from repro_torch.core.storage import (COS, NFS, SCALE, BlobStore, ScaleCache,
                                      StorageStack)
from repro_torch.core.straggler import StragglerDetector
from repro_torch.core.telemetry import GLOBAL_REGISTRY, MetricsRegistry
from repro_torch.core.tenancy import Namespace, TenantScheduler
from repro_torch.core.youngs import (checkpoint_every_n_steps, lost_fraction,
                                     optimal_lost_fraction, young_interval)

__all__ = [
    "Anomaly", "AnomalyDetector", "render_dashboard", "Namespace",
    "TenantScheduler",
    "Alert", "AlertManager", "SlackSink", "CheckpointManager", "latest_step",
    "load_checkpoint", "save_checkpoint", "VirtualClock", "WallClock",
    "FailureKind", "Node", "NodeState", "SimCluster", "Autopilot",
    "FTTrainLoop", "GoodputReport", "job_mtbf_seconds", "simulate_job",
    "GangScheduler", "Job", "JobState", "COS", "NFS", "SCALE", "BlobStore",
    "ScaleCache", "StorageStack", "StragglerDetector", "GLOBAL_REGISTRY",
    "MetricsRegistry", "checkpoint_every_n_steps", "lost_fraction",
    "optimal_lost_fraction", "young_interval",
]

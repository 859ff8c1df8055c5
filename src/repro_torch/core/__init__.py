"""The port's framework core: tasks, boxes, platforms, the registry, the
result cache, sharding, the scheduler, the sweep executor and the runner
(the counterpart of ``repro.core``; ``remote_platform`` waits for the
fleet slice)."""
from repro_torch.core.box import Box, TaskSpec
from repro_torch.core.cache import EwmaCostStore, ResultCache, cache_key
from repro_torch.core.cost import CostModel
from repro_torch.core.executor import SweepExecutor, SweepResult, SweepStats
from repro_torch.core.metrics import Samples, compute_metrics, known_metrics
from repro_torch.core.platform import (
    Platform,
    get_platform,
    known_platforms,
    register_platform,
)
from repro_torch.core.report import merge_shard_reports
from repro_torch.core.runner import Runner, RunnerResult
from repro_torch.core.scheduler import FleetScheduler, Outcome, Sink, WorkItem
from repro_torch.core.shard import (
    ShardSpec,
    cost_partition,
    cost_shard_map,
    partition,
    resolve_auto_weights,
    shard_of,
)
from repro_torch.core.task import Task, TaskContext, TestResult

__all__ = [
    "Box", "TaskSpec", "Samples", "compute_metrics", "known_metrics",
    "Runner", "RunnerResult", "Task", "TaskContext", "TestResult",
    "SweepExecutor", "SweepResult", "SweepStats",
    "ResultCache", "cache_key", "CostModel", "EwmaCostStore",
    "FleetScheduler", "Sink", "WorkItem", "Outcome",
    "Platform", "get_platform", "known_platforms", "register_platform",
    "ShardSpec", "shard_of", "partition", "cost_shard_map", "cost_partition",
    "resolve_auto_weights",
    "merge_shard_reports",
]

"""The port's tasks, by name."""
from __future__ import annotations

from repro_torch.core.task import Task
from repro_torch.tasks.compute import ComputeTask, StringTask
from repro_torch.tasks.dbms import AppStepTask, DBMSTask
from repro_torch.tasks.index_offload import IndexOffloadTask
from repro_torch.tasks.memory import MemoryTask
from repro_torch.tasks.network import NetworkTask
from repro_torch.tasks.plugins.accel import AccelTask
from repro_torch.tasks.plugins.quantize import QuantizeTask
from repro_torch.tasks.pushdown import PushdownTask
from repro_torch.tasks.serving import ServingTask
from repro_torch.tasks.storage import StorageTask

TASKS: dict[str, type[Task]] = {
    DBMSTask.name: DBMSTask,
    ServingTask.name: ServingTask,
    PushdownTask.name: PushdownTask,
    AccelTask.name: AccelTask,
    ComputeTask.name: ComputeTask,
    StringTask.name: StringTask,
    MemoryTask.name: MemoryTask,
    StorageTask.name: StorageTask,
    IndexOffloadTask.name: IndexOffloadTask,
    NetworkTask.name: NetworkTask,
    QuantizeTask.name: QuantizeTask,
    AppStepTask.name: AppStepTask,
}

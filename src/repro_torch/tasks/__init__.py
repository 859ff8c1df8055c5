"""The port's tasks, by name."""
from __future__ import annotations

from repro_torch.core.task import Task
from repro_torch.tasks.dbms import DBMSTask
from repro_torch.tasks.plugins.accel import AccelTask
from repro_torch.tasks.pushdown import PushdownTask
from repro_torch.tasks.serving import ServingTask

TASKS: dict[str, type[Task]] = {
    DBMSTask.name: DBMSTask,
    ServingTask.name: ServingTask,
    PushdownTask.name: PushdownTask,
    AccelTask.name: AccelTask,
}

"""Simulated Slurm resource manager.

Faithful to the semantics the paper relies on: sbatch (batch submission with
#SBATCH-style resource requirements), FIFO scheduling onto partition nodes,
squeue/scancel, configurable scheduler cycle, and fault injection (node
failure -> NODE_FAIL for resident jobs), which is what the Endpoint Worker's
cleanup loop and the Job Worker's reconvergence are tested against.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.simclock import EventLoop


class JobState(enum.Enum):
    PENDING = "PD"
    RUNNING = "R"
    COMPLETED = "CD"
    CANCELLED = "CA"
    NODE_FAIL = "NF"
    FAILED = "F"


@dataclass
class SimNode:
    node_id: str
    gpus: int = 4
    partition: str = "gpu"
    up: bool = True
    gpus_used: int = 0

    @property
    def gpus_free(self) -> int:
        return self.gpus - self.gpus_used if self.up else 0


@dataclass(eq=False)
class SlurmJob:
    job_id: int
    params: dict                      # parsed #SBATCH directives
    on_start: Callable                # fn(job, node) -> on_kill callable
    state: JobState = JobState.PENDING
    node: Optional[SimNode] = None
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    _on_kill: Optional[Callable] = None

    @property
    def gpus(self) -> int:
        return int(self.params.get("gpus", 1))

    @property
    def priority(self) -> int:
        return int(self.params.get("priority", 0))


class SimSlurm:
    def __init__(self, loop: EventLoop, nodes: list[SimNode],
                 sched_interval: float = 2.0, start_latency: float = 1.0):
        self.loop = loop
        self.nodes = {n.node_id: n for n in nodes}
        self.jobs: dict[int, SlurmJob] = {}
        self._ids = itertools.count(1000)
        self.start_latency = start_latency
        self._sched_task = loop.every(sched_interval, self._schedule_cycle)

    def stop(self):
        """Tear down the periodic scheduling cycle."""
        self._sched_task.stop()

    # ------------------------------------------------------------------
    def sbatch(self, params: dict, on_start: Callable) -> int:
        job = SlurmJob(next(self._ids), params, on_start,
                       submitted_at=self.loop.now)
        self.jobs[job.job_id] = job
        return job.job_id

    def scancel(self, job_id: int):
        job = self.jobs.get(job_id)
        if job is None or job.state not in (JobState.PENDING,
                                            JobState.RUNNING):
            return
        self._teardown(job, JobState.CANCELLED)

    def squeue(self) -> list[dict]:
        return [{"job_id": j.job_id, "state": j.state.value,
                 "node": j.node.node_id if j.node else None,
                 "params": dict(j.params)}
                for j in self.jobs.values()
                if j.state in (JobState.PENDING, JobState.RUNNING)]

    def job_state(self, job_id: int) -> Optional[JobState]:
        j = self.jobs.get(job_id)
        return j.state if j else None

    # ------------------------------------------------------------------
    def _schedule_cycle(self, now: float = 0.0):
        # higher sbatch --priority first, then FIFO (all-equal priorities
        # reduce to the paper's plain FIFO order)
        pending = sorted((j for j in self.jobs.values()
                          if j.state == JobState.PENDING),
                         key=lambda j: (-j.priority, j.submitted_at,
                                        j.job_id))
        for job in pending:
            part = job.params.get("partition", "gpu")
            node = next((n for n in self.nodes.values()
                         if n.up and n.partition == part
                         and n.gpus_free >= job.gpus), None)
            if node is None:
                continue  # stays pending (FIFO, no backfill)
            node.gpus_used += job.gpus
            job.node = node
            job.state = JobState.RUNNING
            job.started_at = self.loop.now

            def start(j=job, n=node):
                if j.state == JobState.RUNNING:
                    j._on_kill = j.on_start(j, n)

            self.loop.call_after(self.start_latency, start)

    def _teardown(self, job: SlurmJob, state: JobState):
        if job.node is not None and job.state == JobState.RUNNING:
            job.node.gpus_used -= job.gpus
        job.state = state
        if job._on_kill is not None:
            job._on_kill()
            job._on_kill = None

    # -- fault injection ---------------------------------------------------
    def fail_node(self, node_id: str):
        node = self.nodes[node_id]
        node.up = False
        for job in list(self.jobs.values()):
            if job.node is node and job.state == JobState.RUNNING:
                self._teardown(job, JobState.NODE_FAIL)
        node.gpus_used = 0

    def restore_node(self, node_id: str):
        self.nodes[node_id].up = True

    # -- metrics -------------------------------------------------------------
    def utilization(self) -> float:
        total = sum(n.gpus for n in self.nodes.values() if n.up)
        used = sum(n.gpus_used for n in self.nodes.values() if n.up)
        return used / max(total, 1)

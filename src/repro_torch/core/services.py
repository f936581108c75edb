"""Management-component microservices (paper §3.2): Job Worker, Slurm
Submit, Endpoint Gateway, Endpoint Worker.

Each is a long-running background process on the event loop with the cycle
times and semantics described in the paper (Job Worker every 15 s with
synchronous per-configuration iteration; Endpoint Worker with health polls
and a configurable 30-minute startup timeout; Endpoint Gateway's
p = argmax(port)+1 assignment; Slurm Submit's comma-delimited parameter
string -> sbatch bridge).
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

from repro_torch.core.db import Database
from repro_torch.core.simclock import EventLoop
from repro_torch.core.slurm import JobState, SimSlurm

BASE_PORT = 8000


class SlurmSubmit:
    """SSH->bash->sbatch bridge. Accepts the comma-delimited parameter
    string (as the paper's service does), selects the model-specific
    .slurm template and submits; the job payload performs the Endpoint
    Gateway registration curl and starts the vLLM server."""

    def __init__(self, slurm: SimSlurm, job_payload: Callable):
        self.slurm = slurm
        self.job_payload = job_payload  # fn(job, node, params) -> kill fn

    def submit(self, param_string: str) -> int:
        params = dict(kv.split("=", 1) for kv in param_string.split(","))
        # "#SBATCH" directives derived from the model's .slurm template.
        # Coerce AFTER the spread: every value in the comma-delimited
        # parameter string is a raw string, and spreading it last used to
        # overwrite the int-coerced keys with those strings.
        sbatch_params = {
            **params,
            "gpus": int(params.get("gpus", 1)),
            "nodes": int(params.get("nodes", 1)),
            "partition": params.get("partition", "gpu"),
            "priority": int(params.get("priority", 0)),
        }

        def on_start(job, node):
            return self.job_payload(job, node, params)

        return self.slurm.sbatch(sbatch_params, on_start)


class EndpointGateway:
    """Registration callback target for the in-job curl POST."""

    def __init__(self, db: Database, loop: EventLoop, auth_token: str = "eg"):
        self.db = db
        self.loop = loop
        self.auth_token = auth_token

    def register(self, *, endpoint_job_id: int, slurm_job_id: int, node: str,
                 model_name: str, model_version: str, bearer_token: str,
                 auth: str, phase: Optional[str] = None) -> Optional[int]:
        """Returns the assigned port (the curl response) or None."""
        if auth != self.auth_token:
            return None
        job = self.db["ai_model_endpoint_jobs"].get(endpoint_job_id)
        if job is None or job["slurm_job_id"] != slurm_job_id:
            return None
        if self.db["ai_model_endpoints"].select(endpoint_job_id=endpoint_job_id):
            return None  # already has an endpoint attached
        ports = [ep["port"] for ep in
                 self.db["ai_model_endpoints"].select(node=node)]
        port = (max(ports) + 1) if ports else BASE_PORT
        self.db["ai_model_endpoints"].insert(
            self.db, endpoint_job_id=endpoint_job_id, node=node, port=port,
            model_name=model_name, model_version=model_version,
            bearer_token=bearer_token, ready_at=None, phase=phase)
        self.db["ai_model_endpoint_jobs"].update(
            endpoint_job_id, registered_at=self.loop.now)
        return port


class JobWorker:
    """Reconciliation loop: ai_model_configurations (desired) vs
    ai_model_endpoint_jobs (actual). Configurations are iterated
    synchronously; at most one submission per configuration per cycle (the
    paper waits a timespan after each submit to avoid port races).

    Configurations owned by the declarative `Reconciler`
    (repro_torch.core.deployments) are listed in `managed`: for those this
    class is only the reconcile *executor* — the Reconciler drives `submit_one`
    itself with drain-aware scale-down and rolling updates — and the legacy
    count-diffing loop below skips them."""

    def __init__(self, db: Database, loop: EventLoop, slurm: SimSlurm,
                 submit: SlurmSubmit, interval: float = 15.0):
        self.db = db
        self.slurm = slurm
        self.submit = submit
        self.managed: set[int] = set()   # config ids owned by the Reconciler
        self._tok = itertools.count(1)
        self._tick = loop.every(interval, self.run)
        self.loop = loop

    def stop(self):
        """Tear down the periodic count-diffing loop."""
        self._tick.stop()

    def run(self, now: float):
        for cfg in list(self.db["ai_model_configurations"].rows.values()):
            if cfg["id"] in self.managed:
                continue
            jobs = self.db["ai_model_endpoint_jobs"].select(
                configuration_id=cfg["id"])
            live = [j for j in jobs if self.slurm.job_state(j["slurm_job_id"])
                    in (JobState.PENDING, JobState.RUNNING)]
            desired = int(cfg["instances"])
            if len(live) < desired:
                self.submit_one(cfg, now)       # one per cycle (sync iter)
            elif len(live) > desired:
                self._scale_down(cfg, live, len(live) - desired)

    def submit_one(self, cfg: dict, now: float, priority: int = 0,
                   phase: Optional[str] = None) -> dict:
        """Submit one endpoint job for `cfg`; returns the job row (the
        Reconciler records the template generation against its id).
        ``phase`` tags the job as a prefill/decode pool member
        (disaggregated deployments); None = unified."""
        bearer = f"tok-{next(self._tok):08x}"
        # row is created first so the job script can reference its id
        row = self.db["ai_model_endpoint_jobs"].insert(
            self.db, configuration_id=cfg["id"], slurm_job_id=None,
            submitted_at=now, registered_at=None, ready_at=None, phase=phase)
        param_string = ",".join([
            f"config_id={cfg['id']}",
            f"endpoint_job_id={row['id']}",
            f"model={cfg['model_name']}",
            f"version={cfg['model_version']}",
            f"gpus={cfg['gpus_per_node']}",
            f"nodes={cfg['nodes']}",
            f"partition={cfg['slurm_partition']}",
            f"load={cfg['est_load_time']}",
            f"priority={priority}",
            f"phase={phase or ''}",
            f"bearer={bearer}",
        ])
        slurm_job_id = self.submit.submit(param_string)
        return self.db["ai_model_endpoint_jobs"].update(
            row["id"], slurm_job_id=slurm_job_id)

    def _scale_down(self, cfg: dict, live: list, excess: int):
        # prefer not-yet-ready jobs, then newest first
        victims = sorted(live, key=lambda j: (j["ready_at"] is not None,
                                              -(j["submitted_at"] or 0)))
        for j in victims[:excess]:
            if j["slurm_job_id"] is not None:
                self.slurm.scancel(j["slurm_job_id"])
            # rows are reaped by the Endpoint Worker's dead-job pass


class EndpointWorker:
    """Health-status manager: polls /health of every endpoint job, marks
    readiness, reaps cancelled/expired jobs (paper's two no-response cases,
    with the configurable 30-minute startup timeout)."""

    def __init__(self, db: Database, loop: EventLoop, slurm: SimSlurm,
                 registry: dict, interval: float = 5.0,
                 startup_timeout: float = 1800.0,
                 on_ready: Optional[Callable[[str], None]] = None):
        self.db = db
        self.loop = loop
        self.slurm = slurm
        self.registry = registry       # (node, port) -> VLLMInstance
        self.startup_timeout = startup_timeout
        # fn(model_name), fired on the not-ready -> ready transition; the
        # Web Gateway uses this to drain its router-side queue immediately
        # instead of waiting for the next drain tick
        self.on_ready = on_ready
        self._tick = loop.every(interval, self.run)

    def stop(self):
        """Tear down the periodic health-poll loop."""
        self._tick.stop()

    def _health(self, job: dict) -> Optional[int]:
        eps = self.db["ai_model_endpoints"].select(endpoint_job_id=job["id"])
        if not eps:
            return None
        inst = self.registry.get((eps[0]["node"], eps[0]["port"]))
        if inst is None:
            return None
        return inst.health()

    def run(self, now: float):
        for job in list(self.db["ai_model_endpoint_jobs"].rows.values()):
            state = self.slurm.job_state(job["slurm_job_id"]) \
                if job["slurm_job_id"] is not None else None
            status = self._health(job)
            if status == 200:
                if job["ready_at"] is None:
                    self.db["ai_model_endpoint_jobs"].update(
                        job["id"], ready_at=now)
                became_ready = None
                for ep in self.db["ai_model_endpoints"].select(
                        endpoint_job_id=job["id"]):
                    if ep["ready_at"] is None:
                        self.db["ai_model_endpoints"].update(
                            ep["id"], ready_at=now)
                        became_ready = ep["model_name"]
                if became_ready is not None and self.on_ready is not None:
                    self.on_ready(became_ready)
                continue
            # no response: (1) cancelled/expired/failed, (2) still starting
            dead = state not in (JobState.PENDING, JobState.RUNNING)
            expired = (now - (job["submitted_at"] or now)
                       > self.startup_timeout)
            if dead or expired:
                if not dead and job["slurm_job_id"] is not None:
                    self.slurm.scancel(job["slurm_job_id"])
                # remove endpoint + job rows; Job Worker will reconverge
                self.db["ai_model_endpoint_jobs"].delete(self.db, job["id"])

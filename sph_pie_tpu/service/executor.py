"""Run executor: the bridge from run records to actual simulations.

The reference's runs (shows) are logged by human operators; this framework
executes them: submitting a run drives the SPH engine for the requested
steps, records step metrics into the run record at a fixed cadence (the
entries analogue), optionally checkpoints, and fires lifecycle webhooks.
A single worker thread serialises execution (one accelerator).
"""

from __future__ import annotations

import queue
import threading
import traceback

from sph_pie_tpu.service import metrics as metrics_lib
from sph_pie_tpu.service.storage.base import now_ms


class RunExecutor:
    def __init__(self, registry, webhook=None, broadcast=None, checkpoint_dir=None):
        self.registry = registry
        self.webhook = webhook
        self.broadcast = broadcast or (lambda msg: None)
        self.checkpoint_dir = checkpoint_dir
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._lock = threading.Lock()

    def _ensure_worker(self):
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._loop, daemon=True)
                self._worker.start()

    def submit(
        self, run_id: str, scene_id: str, n_steps: int, record_every: int = 50
    ):
        provider = self.registry.get_provider()
        run = provider.get_run(run_id)
        if run is None:
            raise KeyError(run_id)
        run["status"] = "queued"
        run["execution"] = {
            "scene": scene_id,
            "steps": int(n_steps),
            "recordEvery": int(record_every),
            "queuedAt": now_ms(),
        }
        provider.replace_run(run)
        self._q.put((run_id, scene_id, int(n_steps), int(record_every)))
        self._ensure_worker()
        return run

    def pending(self) -> int:
        return self._q.qsize()

    def _loop(self):
        while True:
            try:
                job = self._q.get(timeout=5)
            except queue.Empty:
                # Retire atomically w.r.t. submit(): if a job slipped in
                # between the timeout and here, keep draining; otherwise
                # clear the worker slot under the lock so the next
                # submit() is guaranteed to start a fresh worker.
                with self._lock:
                    if self._q.empty():
                        self._worker = None
                        return
                continue
            self._execute(*job)

    def _execute(self, run_id, scene_id, n_steps, record_every):
        provider = self.registry.get_provider()

        def update(**kw):
            run = provider.get_run(run_id)
            if run is None:
                return None
            run.update(kw)
            provider.replace_run(run)
            self.broadcast({"type": "runs:changed", "event": "run.updated", "runId": run_id})
            return run

        try:
            from sph_pie_tpu.scenes import builders
            from sph_pie_tpu.solvers import run as run_lib

            run0 = provider.get_run(run_id) or {}
            builder = getattr(builders, scene_id)
            params0 = dict(run0.get("params") or {})
            # solver selection rides the run params: {"solver": "pbf",
            # "pbf": {...make_pbf_params kwargs...}} runs the constraint
            # solver through the same epoch loop (BASELINE config #4).
            solver = str(params0.pop("solver", "wcsph"))
            pbf_kwargs = params0.pop("pbf", None) or {}
            pbf_params = None
            if solver == "pbf":
                from sph_pie_tpu.solvers import pbf as pbf_lib

                pbf_params = pbf_lib.make_pbf_params(**pbf_kwargs)
            elif solver != "wcsph":
                raise ValueError(f"unknown solver {solver!r}")
            try:
                # the run's params dict parameterises the scene builder
                scene = builder(**params0)
            except TypeError as e:
                raise ValueError(f"bad scene params: {e}") from e
            update(status="running", startedAt=now_ms())
            state = scene.state
            step = 0
            while step < n_steps:
                chunk = min(record_every, n_steps - step)
                state, overflow = run_lib.run_epochs(
                    scene.params,
                    scene.bgrid,
                    state,
                    scene.emitter,
                    scene.obstacles,
                    chunk,
                    1,
                    start_step=step,
                    boundary=getattr(scene, "boundary", None),
                    pbf_params=pbf_params,
                )
                step += chunk
                m = metrics_lib.state_metrics(state, scene.params, step=step)
                m["overflow"] = int(overflow)
                try:
                    provider.add_step(run_id, {"step": step, **m})
                except Exception:
                    pass  # run may have been archived/deleted mid-flight
                self.broadcast(
                    {"type": "runs:changed", "event": "step.added", "runId": run_id}
                )
            if self.checkpoint_dir:
                from sph_pie_tpu.utils.checkpoint import CheckpointManager

                CheckpointManager(f"{self.checkpoint_dir}/{run_id}").save(
                    state, scene.params, step=step
                )
            run = update(status="completed", completedAt=now_ms())
            if self.webhook is not None and run is not None:
                self.webhook.dispatch_run_event("run.completed", run)
        except Exception as e:
            update(
                status="failed",
                error=f"{type(e).__name__}: {e}"[:500],
                failedAt=now_ms(),
            )
            traceback.print_exc()

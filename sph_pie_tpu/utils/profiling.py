"""Tracing / profiling.

The reference's observability is request logs + self-timed webhook sends
(SURVEY.md §5). An accelerator framework needs real tracing from the start: this
wraps ``jax.profiler`` for device traces, summarises a trace per device
stream (kernels per step, busy time, idle share, the costliest kernels),
and provides a lightweight step-timing registry the service layer exposes
in /api/health-adjacent surfaces.

Trace the flagship step on the card and print the summary:

    python -m sph_pie_tpu.utils.profiling [--n 1000000] [--steps 3]
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import statistics
import time


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def busy_ns(intervals) -> int:
    """Length of the union of ``(start_ns, end_ns)`` intervals."""
    total, cur_start, cur_end = 0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def summarize_trace(log_dir: str, n_steps: int, plane_prefix: str = "/device:",
                    top: int = 15) -> list[dict]:
    """Per-line summary of the newest ``jax.profiler`` trace under
    ``log_dir``, for every plane whose name starts with ``plane_prefix``
    (on a GPU, one line per CUDA stream).

    For each line with events: the event count and count per step; the
    window from the first event's start to the last one's end; busy time
    (the union of event intervals); ``idle_share`` = 1 - busy / window;
    and the ``top`` event names by time per step, each with its launches
    per step. Steps are the ``n_steps`` the traced region ran."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {log_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            spans = [(e.start_ns, e.end_ns, e.name) for e in line.events]
            if not spans:
                continue
            per_name = collections.defaultdict(lambda: [0, 0.0])
            for start, end, name in spans:
                per_name[name][0] += 1
                per_name[name][1] += end - start
            window = max(s[1] for s in spans) - min(s[0] for s in spans)
            busy = busy_ns((s[0], s[1]) for s in spans)
            ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top]
            out.append({
                "plane": plane.name,
                "line": line.name,
                "events": len(spans),
                "events_per_step": len(spans) / n_steps,
                "window_ms": window / 1e6,
                "busy_ms": busy / 1e6,
                "idle_share": 1.0 - busy / window if window else 0.0,
                "top": [
                    {"name": name, "ms_per_step": dur / 1e6 / n_steps,
                     "launches_per_step": count / n_steps}
                    for name, (count, dur) in ranked
                ],
            })
    return out


def trace_steps(run, n_steps: int, log_dir: str, **summary_kw) -> dict:
    """Time ``run()`` (which runs ``n_steps`` steps and returns device
    arrays) once untraced, then once under the profiler, and summarise
    the trace. ``run`` must be compiled already: the first call here is a
    timed one."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(run())
    untraced_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with device_trace(log_dir):
        jax.block_until_ready(run())
    traced_s = time.perf_counter() - t0
    return {
        "steps": n_steps,
        "untraced_ms_per_step": untraced_s / n_steps * 1e3,
        "traced_wall_s": traced_s,
        "lines": summarize_trace(log_dir, n_steps, **summary_kw),
    }


def annotate(name: str):
    """Named trace span for host-side phases (shows up in the profile)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Rolling wall-clock stats for repeated phases (blocks until the
    device result is ready, so timings are real device time)."""

    def __init__(self, window: int = 200):
        self.window = window
        self._samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, result=None):
        import jax

        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            if "result" in out:
                jax.block_until_ready(out["result"])
            dt = time.perf_counter() - t0
            buf = self._samples.setdefault(name, [])
            buf.append(dt)
            del buf[: -self.window]

    def stats(self) -> dict:
        out = {}
        for name, xs in self._samples.items():
            out[name] = {
                "count": len(xs),
                "mean_ms": statistics.fmean(xs) * 1e3,
                "p50_ms": statistics.median(xs) * 1e3,
                "max_ms": max(xs) * 1e3,
            }
        return out


def main(argv=None) -> int:
    """Trace ``--steps`` steps of the WCSPH 3D dam break at ``--n``
    particles (builder defaults) and print one JSON line per device
    stream."""
    import argparse
    import json
    import tempfile

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--log-dir", default=None,
                    help="trace directory (default: a fresh temporary one)")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from sph_pie_tpu.scenes import dam_break_3d
    from sph_pie_tpu.solvers import wcsph_binned
    from sph_pie_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    scene = dam_break_3d(args.n)
    b = scene.binned_state()
    k = jnp.asarray(args.steps, jnp.int32)
    sim = wcsph_binned.simulate.lower(scene.params, scene.bgrid, b, k).compile()

    def run():
        return sim(scene.params, b, k)

    log_dir = args.log_dir or tempfile.mkdtemp(prefix="sph_pie_trace_")
    res = trace_steps(run, args.steps, log_dir)
    lines = res.pop("lines")
    print(json.dumps(dict(res, n_particles=int(b.valid.sum()), log_dir=log_dir)))
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Smoke test of the SPH engine's main path on an NVIDIA GPU.

    python chip_smoke.py             # one card: every default phase
    python chip_smoke.py --cards 4   # four cards: the multi-device phase only

Default phases, all in this one process (a JAX process reserves most of
the card's memory, so no second one is started):

  1. flagship WCSPH: 3D dam break at 1M, 5 warm + 50 timed steps, then on
     past the first rebin; state checks;
  2. PBF at 1M with the in-loop splat render (BASELINE config #4);
  3. the epoch loop behind ``python -m sph_pie_tpu simulate``: emitter +
     obstacle scene (BASELINE config #2);
  4. agreement with the plain reference on the card: (a) the BASELINE
     2D 4k f64 trajectory contract, (b) a 3D f64 run at the flagship's
     layout, (c) one f32 density + force evaluation at 100k against the
     same jitted functions on the host CPU;
  5. the HTTP service: a run executed through the API.

Every line but the last is a progress or result line. The last stdout
line is one JSON object, ``{"ok": true, "device": {...}}``, printed only
when every phase passed. The script exits non-zero, and prints no result
line, when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np


class SmokeFailure(Exception):
    """A check on the engine's output failed."""


def _require(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def _log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def initial_inventory(scene) -> tuple[int, float]:
    """(active particle count, total fluid mass in f64) of a fresh scene."""
    act = np.asarray(scene.state.active)
    mass = np.asarray(scene.state.mass, np.float64)[act]
    return int(act.sum()), float(mass.sum())


def check_state(scene, b, n0: int, mass0: float, require_rebin=True) -> dict:
    """The state checks every stepping phase applies to its final state:
    no cell overflow; every particle still present (count and total mass
    unchanged); all positions finite and inside the domain plus a 5h
    margin (the bound the repo's rollout tests use); and, unless waived, at
    least one rebin over the run. Raises SmokeFailure; returns the
    measured values."""
    from sph_pie_tpu.neighbors import binned as nb

    overflow = int(b.overflow)
    _require(overflow == 0, f"cell overflow: {overflow} particles dropped")
    st = nb.unbin(scene.bgrid, b, scene.state.capacity)
    alive = np.asarray(st.active)
    n = int(alive.sum())
    _require(n == n0, f"particle count changed: {n0} -> {n}")
    mass = float(np.asarray(st.mass, np.float64)[alive].sum())
    _require(
        abs(mass - mass0) <= 1e-9 * abs(mass0),
        f"total mass changed: {mass0} -> {mass}",
    )
    pos = np.asarray(st.pos)[alive]
    _require(np.isfinite(pos).all(), "non-finite positions")
    pad = 5.0 * float(scene.params.h)
    lo = np.asarray(scene.params.bound_min) - pad
    hi = np.asarray(scene.params.bound_max) + pad
    outside = int(((pos < lo) | (pos > hi)).any(axis=1).sum())
    _require(outside == 0, f"{outside} particles outside the domain + 5h")
    rebins = int(b.n_rebins)
    _require(not require_rebin or rebins >= 1, "no rebin over the run")
    return {"overflow": overflow, "n_active": n, "rebins": rebins}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _aot(fn, *args, **kwargs):
    """Lower + compile a jitted function; returns (compiled, seconds). The
    compiled function is called with the same arguments minus the static
    ones."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **kwargs).compile()
    return compiled, time.perf_counter() - t0


def _timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _peak_bytes(device) -> int:
    return int(device.memory_stats()["peak_bytes_in_use"])


def _report(name: str, info: dict, device):
    info = dict(info, peak_bytes_in_use=_peak_bytes(device))
    _log(f"[phase] {name}: " + json.dumps(info))


def _max_dpos(grid, b, b_ref, capacity) -> float:
    """Max |dx| between two runs of one scene, in owner order (a rebin
    that fires in one run but not the other permutes slots)."""
    from sph_pie_tpu.neighbors import binned as nb

    s = nb.unbin(grid, b, capacity)
    s_ref = nb.unbin(grid, b_ref, capacity)
    act = np.asarray(s_ref.active)
    _require(
        (np.asarray(s.active) == act).all(), "active sets differ between runs"
    )
    return float(np.abs(np.asarray(s.pos)[act] - np.asarray(s_ref.pos)[act]).max())


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------


def phase_wcsph_flagship(n=1_000_000, warm=5, timed=50, past=400) -> dict:
    """1M WCSPH at the builder defaults (cap 40, skin 0.40, home_tier)."""
    import jax.numpy as jnp

    from sph_pie_tpu.scenes import dam_break_3d
    from sph_pie_tpu.solvers import wcsph_binned

    scene = dam_break_3d(n)
    g, params = scene.bgrid, scene.params
    _require(g.cap == 40, f"cap {g.cap} != 40")
    _require(abs(g.skin - 0.40 * float(params.h)) < 1e-9, "skin != 0.40 h")
    _require(0 < g.home_tier < g.cap, "home_tier is off")
    n0, mass0 = initial_inventory(scene)
    b = scene.binned_state()
    _require(int(b.overflow) == 0, "overflow at bin time")

    def steps(k):
        return jnp.asarray(k, jnp.int32)

    sim, compile_s = _aot(
        wcsph_binned.simulate, params, grid=g, b=b, n_steps=steps(warm)
    )
    b, warm_s = _timed(sim, params, b=b, n_steps=steps(warm))
    b, run_s = _timed(sim, params, b=b, n_steps=steps(timed))
    rebins_timed = int(b.n_rebins)
    # on past the first rebin (from rest, the first fires after ~350
    # steps at 1M), so the rebin path runs and is checked too
    b, past_s = _timed(sim, params, b=b, n_steps=steps(past))
    checks = check_state(scene, b, n0, mass0)
    ms = run_s / timed * 1e3
    return {
        "n_particles": n0,
        "cells": g.num_cells,
        "compile_s": round(compile_s, 3),
        "warm_s": round(warm_s, 3),
        "run_s": round(run_s, 4),
        "timed_steps": timed,
        "ms_per_step": round(ms, 3),
        "particle_steps_per_sec": round(n0 / (ms / 1e3), 1),
        "rebins_before_further_steps": rebins_timed,
        "further_steps": past,
        "further_ms_per_step": round(past_s / past * 1e3, 3),
        **checks,
    }


def phase_pbf_render(n=1_000_000, steps=10) -> dict:
    """PBF flagship params with the splat render inside the loop."""
    import jax.numpy as jnp

    from sph_pie_tpu.scenes import dam_break_3d
    from sph_pie_tpu.solvers import pbf

    scene = dam_break_3d(n)
    g, params, pp = scene.bgrid, scene.params, pbf.flagship_params()
    n0, mass0 = initial_inventory(scene)
    b = scene.binned_state()
    k = jnp.asarray(steps, jnp.int32)
    sim, compile_s = _aot(pbf.simulate_rendered, params, grid=g, pbf=pp, b=b, n_steps=k)
    (b, frame, checksum), run_s = _timed(sim, params, pbf=pp, b=b, n_steps=k)
    checks = check_state(scene, b, n0, mass0)
    lit = int((np.asarray(frame) > 0).sum())
    _require(lit > 0, "rendered frame is all zero")
    ms = run_s / steps * 1e3
    return {
        "n_particles": n0,
        "compile_s": round(compile_s, 3),
        "run_s": round(run_s, 4),
        "steps": steps,
        "ms_per_step": round(ms, 3),
        "particle_steps_per_sec": round(n0 / (ms / 1e3), 1),
        "frame_shape": list(np.asarray(frame).shape),
        "lit_pixels": lit,
        "checksum": int(checksum),
        **checks,
    }


def phase_epoch_loop(n=4096, steps=500) -> dict:
    """``run_lib.run_scene`` on the emitter + obstacle scene, the loop
    behind ``python -m sph_pie_tpu simulate``."""
    from sph_pie_tpu.scenes import emitter_2d
    from sph_pie_tpu.solvers import run as run_lib

    scene = emitter_2d(n)
    (st, overflow), first_s = _timed(run_lib.run_scene, scene, steps)
    (st, overflow), run_s = _timed(run_lib.run_scene, scene, steps)
    emitted = int(np.asarray(st.active).sum())
    _require(emitted > 0, "no particle was emitted")
    _require(int(overflow) == 0, f"overflow {int(overflow)}")
    pos = np.asarray(st.pos)[np.asarray(st.active)]
    _require(np.isfinite(pos).all(), "non-finite positions")
    return {
        "first_call_s": round(first_s, 3),
        "run_s": round(run_s, 4),
        "steps": steps,
        "steps_per_sec": round(steps / run_s, 1),
        "emitted": emitted,
        "overflow": int(overflow),
    }


def _oracle_run(scene, steps: int):
    """Positions after ``steps`` of the plain CPU reference (the native
    C++ oracle when it builds, else the NumPy one it mirrors)."""
    from sph_pie_tpu import native
    from sph_pie_tpu.oracle import oracle_from_scene

    oracle = oracle_from_scene(scene, dtype=np.float64)
    if native.available():
        want, _ = native.oracle_run(
            scene.params, oracle.pos, oracle.vel, oracle.mass, steps
        )
        return want, "native"
    return oracle.run(steps), "numpy"


def phase_reference_f64(n2d=4096, steps2d=1000, n3d=2000, steps3d=20) -> dict:
    """(a) the BASELINE trajectory contract (tests/test_wcsph.py
    ``test_full_contract_4k_1000_steps``): 2D dam break, f64, max |dx| <
    1e-3; (b) a 3D dam break at the flagship layout, f64, < 1e-6 (the
    bound of the repo's f64 parity tests)."""
    import jax
    import jax.numpy as jnp

    from sph_pie_tpu.neighbors import binned as nb
    from sph_pie_tpu.scenes import builders
    from sph_pie_tpu.solvers import wcsph_binned

    out = {}
    with jax.enable_x64():
        for label, scene, steps, tol in (
            ("2d", builders.dam_break_2d(n_target=n2d, dtype=jnp.float64), steps2d, 1e-3),
            ("3d", builders.dam_break_3d(n_target=n3d, dtype=jnp.float64), steps3d, 1e-6),
        ):
            b, run_s = _timed(
                wcsph_binned.simulate,
                scene.params, scene.bgrid, scene.binned_state(), steps,
            )
            _require(int(b.overflow) == 0, f"{label}: overflow")
            st = nb.unbin(scene.bgrid, b, scene.state.capacity)
            got = np.asarray(st.pos)[np.asarray(st.active)]
            t0 = time.perf_counter()
            want, which = _oracle_run(scene, steps)
            oracle_s = time.perf_counter() - t0
            err = float(np.abs(got - want).max())
            _require(err < tol, f"{label} f64: max |dx| {err:.3e} >= {tol}")
            out[label] = {
                "n_particles": int(got.shape[0]),
                "cap": scene.bgrid.cap,
                "steps": steps,
                "card_s": round(run_s, 3),
                "oracle": which,
                "oracle_s": round(oracle_s, 3),
                "max_abs_dx": err,
                "bound": tol,
            }
    return out


# f32 card-vs-host tolerances for phase 4c. Same program, same inputs:
# only the order of f32 sums differs (GPU tree reductions, FMA
# contraction). Density is a sum of positive terms, so the two agree to
# within 1e-5 relative (f32 alone is ~3e-7 off the f64 value).
# Acceleration sums pressure terms that cancel near-exactly: f32 itself
# is ~1e-3 of the largest |acc| off the f64 value on any device, so two
# f32 devices can differ by twice that. The card is therefore held to
# the host's own accuracy: its error against an f64 evaluation (on the
# host) may be at most twice the host f32 error against the same.
F32_RHO_RTOL = 1e-5
F32_ACC_VS_HOST = 2.0


def phase_card_vs_cpu(n=100_000, settle=20) -> dict:
    """One f32 density + force evaluation at 100k on the card and on the
    host CPU, same jitted functions, same input state; an f64 evaluation
    on the host is the arbiter for acceleration."""
    import jax
    import jax.numpy as jnp

    from sph_pie_tpu.kernels import eos
    from sph_pie_tpu.scenes import dam_break_3d
    from sph_pie_tpu.solvers import wcsph_binned
    from sph_pie_tpu.utils.struct import replace

    scene = dam_break_3d(n)
    params, g = scene.params, scene.bgrid
    # a few steps first, so velocities and pressures are not the lattice's
    b = wcsph_binned.simulate(params, g, scene.binned_state(), settle)

    @jax.jit
    def rho_acc(params, b):
        rho = wcsph_binned._density(params, g, b)
        b = replace(b, density=rho, pressure=eos.tait_pressure(params, rho))
        acc, _ = wcsph_binned._forces(params, g, b)
        return rho, acc

    (rho_d, acc_d), card_s = _timed(rho_acc, params, b)
    cpu = jax.devices("cpu")[0]
    params_h, b_h = jax.device_put(params, cpu), jax.device_put(b, cpu)
    (rho_h, acc_h), cpu_s = _timed(rho_acc, params_h, b_h)
    _require(
        next(iter(rho_h.devices())).platform == "cpu", "host run not on the CPU"
    )
    with jax.enable_x64():
        def f64(t):
            return jax.tree.map(
                lambda x: x.astype(jnp.float64)
                if jnp.issubdtype(x.dtype, jnp.floating) else x,
                t,
            )

        (_, acc_64), f64_s = _timed(rho_acc, f64(params_h), f64(b_h))
    valid = np.asarray(b.valid)
    rd, rh = np.asarray(rho_d)[valid], np.asarray(rho_h)[valid]
    rho_rel = float(np.abs(rd - rh).max() / np.abs(rh).max())
    ad, ah = np.asarray(acc_d)[valid], np.asarray(acc_h)[valid]
    a64 = np.asarray(acc_64)[valid]
    scale = float(np.abs(a64).max())
    card_err = float(np.abs(ad - a64).max() / scale)
    host_err = float(np.abs(ah - a64).max() / scale)
    out = {
        "n_particles": int(valid.sum()),
        "card_s": round(card_s, 3),
        "cpu_s": round(cpu_s, 3),
        "cpu_f64_s": round(f64_s, 3),
        "rho_card_vs_cpu_max_rel": rho_rel,
        "rho_bound": F32_RHO_RTOL,
        "acc_card_vs_cpu_over_max_acc": float(np.abs(ad - ah).max() / scale),
        "acc_card_vs_f64_over_max_acc": card_err,
        "acc_cpu_f32_vs_f64_over_max_acc": host_err,
        "acc_bound": f"card <= {F32_ACC_VS_HOST} x cpu",
    }
    _log(f"[check] card_vs_cpu: {json.dumps(out)}")
    _require(rho_rel < F32_RHO_RTOL, f"density card vs CPU {rho_rel:.3e}")
    _require(
        card_err <= F32_ACC_VS_HOST * host_err,
        f"acceleration: card {card_err:.3e} vs host {host_err:.3e} (f64 ref)",
    )
    return out


class _Client:
    """Minimal JSON client with a session cookie."""

    def __init__(self, base: str):
        self.base, self.cookie = base, None

    def req(self, method, path, body=None, expect=200):
        req = urllib.request.Request(
            self.base + path,
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"},
        )
        if self.cookie:
            req.add_header("Cookie", self.cookie)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status, raw = resp.status, resp.read()
                cookie = resp.headers.get("Set-Cookie")
        except urllib.error.HTTPError as e:
            status, raw, cookie = e.code, e.read(), e.headers.get("Set-Cookie")
        if cookie:
            self.cookie = cookie.split(";")[0]
        _require(status == expect, f"{method} {path}: {status}: {raw[:200]!r}")
        return json.loads(raw)


def phase_service(n=100_000, steps=200, record_every=100, timeout_s=600) -> dict:
    """The service path: in-process server on an ephemeral port, admin
    login with the forced password change, a dam_break_3d run executed
    through the API and polled until completed."""
    from sph_pie_tpu.service.api import App, make_server
    from sph_pie_tpu.service.users import DEFAULT_TEMP_PASSWORD

    with tempfile.TemporaryDirectory() as tmp:
        app = App(config_path=os.path.join(tmp, "cfg.json"), data_dir=tmp, env={})
        srv = make_server(app, "127.0.0.1", 0)
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        try:
            c = _Client(f"http://127.0.0.1:{srv.server_port}")
            c.req("POST", "/api/auth/login",
                  {"email": "admin@local", "password": DEFAULT_TEMP_PASSWORD})
            c.req("POST", "/api/auth/password",
                  {"currentPassword": DEFAULT_TEMP_PASSWORD,
                   "password": "Sm0ke-Test-Passw0rd!"})
            run = c.req("POST", "/api/runs", {
                "name": "chip-smoke",
                "scene": "dam_break_3d",
                "runDate": time.strftime("%Y-%m-%d"),
                "params": {"n_target": n},
            }, expect=201)["run"]
            t0 = time.perf_counter()
            c.req("POST", f"/api/runs/{run['id']}/execute",
                  {"steps": steps, "recordEvery": record_every}, expect=202)
            while True:
                run = c.req("GET", f"/api/runs/{run['id']}")["run"]
                if run.get("status") in ("completed", "failed"):
                    break
                _require(time.perf_counter() - t0 < timeout_s, "run timed out")
                time.sleep(0.5)
            wall_s = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
            server.join(timeout=10)
    _require(run["status"] == "completed", f"run {run['status']}: {run.get('error')}")
    recs = run["steps"]
    _require(
        [s["step"] for s in recs] == list(range(record_every, steps + 1, record_every)),
        f"recorded steps {[s['step'] for s in recs]}",
    )
    for s in recs:
        nums = [v for v in s.values() if isinstance(v, (int, float))]
        _require(all(np.isfinite(nums)), f"non-finite metric at step {s['step']}")
        _require(s["overflow"] == 0, f"overflow at step {s['step']}")
    return {
        "status": run["status"],
        "wall_s": round(wall_s, 3),
        "n_active": recs[-1]["n_active"],
        "recorded_steps": [s["step"] for s in recs],
        "kinetic_energy": recs[-1]["kinetic_energy"],
    }


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------

# Bounds of the CPU dry run (__graft_entry__.py) for sharded vs
# single-device positions after a few steps.
WCSPH_SHARDED_TOL = 5e-6
PBF_SHARDED_TOL = 1e-6


def _check_sharded(x, n: int) -> int:
    """Each shard of ``x`` on its own card; returns the shard count."""
    devs = [s.device for s in x.addressable_shards]
    _require(len(devs) == n and len(set(devs)) == n, f"shards on {devs}")
    return len(devs)


def phase_multi_card(n_cards=4, n=1_000_000, steps=3) -> dict:
    """The three sharded paths of ``parallel/`` on a 1M 3D dam break, each
    compared in owner order with the single-card run on card 0."""
    import dataclasses

    import jax

    from sph_pie_tpu.neighbors import binned as nb
    from sph_pie_tpu.parallel import balance, halo, sharding
    from sph_pie_tpu.scenes import dam_break_3d, dam_break_3d_periodic
    from sph_pie_tpu.solvers import pbf as pbf_lib
    from sph_pie_tpu.solvers import wcsph_binned

    mesh = sharding.make_mesh(n_cards)
    out = {}

    def single(params, grid, b):
        for _ in range(steps):
            b = wcsph_binned.step(params, grid, b)
        return jax.block_until_ready(b)

    def record(name, err, tol, t_s, shards):
        _require(err < tol, f"{name}: max |dx| {err:.3e} >= {tol}")
        out[name] = {"max_abs_dx": err, "bound": tol, "run_s": round(t_s, 3),
                     "shards": shards}
        _log(f"[multi] {name}: " + json.dumps(out[name]))

    scene = dam_break_3d(n)
    params, g, cap = scene.params, scene.bgrid, scene.state.capacity
    b0 = scene.binned_state()
    ref = single(params, g, b0)

    # GSPMD: shardings pinned on a jitted step, XLA inserts collectives
    t0 = time.perf_counter()
    step = sharding.sharded_step(mesh, params, g)
    b = sharding.shard_binned(mesh, g, b0)
    for _ in range(steps):
        b = step(b)
    b = jax.block_until_ready(b)
    record("gspmd", _max_dpos(g, b, ref, cap), WCSPH_SHARDED_TOL,
           time.perf_counter() - t0, _check_sharded(b.pos, n_cards))

    # explicit ppermute halos: grid padded so the cells divide evenly
    d0 = g.dims[0]
    while (d0 + 2) * math.prod(d + 2 for d in g.dims[1:]) % n_cards:
        d0 += 1
    gh = dataclasses.replace(g, dims=(d0,) + g.dims[1:])
    bh0 = nb.bin_state(gh, scene.state, scene.boundary)
    ref_h = single(params, gh, bh0)
    t0 = time.perf_counter()
    halo_step, _ = halo.make_halo_step(mesh, params, gh)
    halo_step = jax.jit(halo_step)
    b = sharding.shard_binned(mesh, gh, bh0)
    for _ in range(steps):
        b = halo_step(b)
    b = jax.block_until_ready(b)
    record("halo", _max_dpos(gh, b, ref_h, cap), WCSPH_SHARDED_TOL,
           time.perf_counter() - t0, _check_sharded(b.pos, n_cards))

    # particle-balanced splits, on the walled tank and the periodic channel
    for name, sc in (("balanced", scene),
                     ("balanced_periodic", dam_break_3d_periodic(n))):
        gb = sc.bgrid
        bb0 = sc.binned_state()
        ref_b = ref if sc is scene else single(sc.params, gb, bb0)
        counts = np.asarray(jax.device_get(balance.cell_counts(gb, bb0)))
        c_cap = max(3 * gb.num_cells // n_cards, nb.halo_cells(gb) + 1)
        starts = balance.balanced_splits(counts, n_cards, c_cap)
        t0 = time.perf_counter()
        init_fn, step_fn, finish_fn = balance.make_balanced_step(
            mesh, sc.params, gb, c_cap
        )
        bs = init_fn(bb0, starts)
        for _ in range(steps):
            bs = step_fn(bs)
        shards = _check_sharded(bs.fields["pos"], n_cards)
        b = jax.block_until_ready(finish_fn(bs, bb0))
        record(name, _max_dpos(gb, b, ref_b, sc.state.capacity),
               WCSPH_SHARDED_TOL, time.perf_counter() - t0, shards)
        out[name]["balance_factor"] = balance.balance_factor(counts, starts)

    # PBF under the GSPMD decomposition
    pp = pbf_lib.flagship_params()
    ref_p = jax.block_until_ready(pbf_lib.simulate(params, g, pp, b0, steps))
    t0 = time.perf_counter()
    sim = sharding.sharded_pbf_simulate(mesh, params, g, pp)
    b = jax.block_until_ready(sim(sharding.shard_binned(mesh, g, b0), steps))
    record("pbf_gspmd", _max_dpos(g, b, ref_p, cap), PBF_SHARDED_TOL,
           time.perf_counter() - t0, _check_sharded(b.pos, n_cards))

    out["peak_bytes_in_use_per_card"] = [
        _peak_bytes(d) for d in jax.devices()[:n_cards]
    ]
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--cards", type=int, default=1, choices=(1, 4),
        help="4 runs only the multi-device phase, on four cards",
    )
    args = ap.parse_args(argv)

    # The run uses exactly ``--cards`` cards: on a host with more, show JAX
    # only the first ones (unless the caller already chose them).
    os.environ.setdefault(
        "CUDA_VISIBLE_DEVICES", ",".join(str(i) for i in range(args.cards))
    )
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: JAX found platform {platform!r}, not a GPU", file=sys.stderr)
        return 1
    if len(devices) != args.cards:
        print(f"chip_smoke: JAX sees {len(devices)} cards, the run uses "
              f"{args.cards}; set CUDA_VISIBLE_DEVICES to {args.cards} cards",
              file=sys.stderr)
        return 1

    from sph_pie_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    _log(f"card: {_card_line()}")
    _log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
         f"compile cache {cache}")
    _log(f"devices: {[d.device_kind for d in devices]}")

    if args.cards == 4:
        phases = [("multi_card", lambda: phase_multi_card(4))]
    else:
        phases = [
            ("wcsph_1m", phase_wcsph_flagship),
            ("pbf_1m_render", phase_pbf_render),
            ("epoch_loop_emitter_2d", phase_epoch_loop),
            ("reference_f64", phase_reference_f64),
            ("card_vs_cpu_f32_100k", phase_card_vs_cpu),
            ("service_dam_break_3d_100k", phase_service),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        info = fn()
        info["phase_wall_s"] = round(time.perf_counter() - t0, 3)
        _report(name, info, devices[0])

    print(json.dumps({
        "ok": True,
        "device": {"platform": platform, "kind": devices[0].device_kind,
                   "count": args.cards},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

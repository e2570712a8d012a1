"""Entry-point contract: dryrun_multichip must succeed in hostile envs.

Failure mode it guards: a caller process that already initialized a
single-device backend before the CPU/8-device override could take effect,
so make_mesh(8) raised. The entry detects an initialized backend and
re-execs in a clean CPU-only subprocess.
"""

import pytest
import subprocess
import sys

import jax

from __graft_entry__ import _jax_backend_initialized, dryrun_multichip, entry


def test_entry_compiles_single_device():
    fn, args = entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out.pos)


@pytest.mark.heavy
def test_dryrun_multichip_with_initialized_backend():
    # Force-initialize the 8-device CPU backend (order-independent: when
    # this file runs alone, no earlier test has touched a device yet) so
    # this exercises the detection logic; with >= n devices available it
    # may run in-process or via subprocess — either way it must succeed.
    jax.devices()
    assert _jax_backend_initialized()
    dryrun_multichip(4)


@pytest.mark.heavy
def test_dryrun_multichip_poisoned_one_device_process():
    # Simulate the exact round-1 driver environment: a process whose JAX
    # backend is already initialized with a single device. dryrun must
    # detect this and recover via a clean subprocess.
    code = (
        "import jax\n"
        "assert len(jax.devices()) >= 1\n"
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(8)\n"
    )
    import os

    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr
    assert "ppermute halo" in res.stdout

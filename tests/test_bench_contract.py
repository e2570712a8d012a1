"""Contract tests for bench.py's output and failure behaviour.

1. Happy path: the LAST stdout line is one short JSON headline with
   metric/value/unit and the device it ran on, and the full detail lands
   in the detail file — even when the wall-clock budget skips every
   optional row.
2. A platform other than the GPU is refused unless it was asked for by
   name.
3. A row that raises is recorded and fails the run.

The happy path runs bench.py as a real subprocess on the CPU backend
(asked for by name through ``JAX_PLATFORMS``) with a tiny flagship
(``BENCH_FLAGSHIP_N``).
"""

import json
import os
import subprocess
import sys

import pytest

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parse_headline(line):
    head = json.loads(line)
    assert head["metric"] == "particle_steps_per_sec_3d_dam_break_1m"
    assert head["unit"] == "particle-steps/s"
    assert head["value"] > 0
    assert head["device"]["platform"] == "cpu"
    assert head["device"]["count"] >= 1 and head["device"]["kind"]
    assert len(line) < 1800
    return head


@pytest.mark.heavy
def test_headline_prints_even_when_budget_skips_all_optional_rows(tmp_path):
    # budget 10s: already spent by the time the flagship (which is never
    # budget-gated) finishes compiling, so every optional row skips
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "BENCH_DETAIL_PATH": str(tmp_path / "detail.json"),
        "BENCH_FLAGSHIP_N": "2048",
        "BENCH_BUDGET_S": "10",
    }
    proc = subprocess.run(
        [sys.executable, "bench.py"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=350,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert proc.returncode == 0, proc.stderr[-2000:]
    # headline prints twice: right after the flagship AND at the end
    assert len(lines) >= 2
    first, last = _parse_headline(lines[0]), _parse_headline(lines[-1])
    assert first["value"] == last["value"]
    # optional rows were skipped with explicit markers, not silently
    detail = json.loads((tmp_path / "detail.json").read_text())
    skips = [v for v in detail["extra"].values()
             if isinstance(v, str) and v.startswith("skipped(budget")]
    assert skips, detail["extra"]
    # progress lines went to stderr
    assert "[bench]" in proc.stderr


@pytest.mark.parametrize(
    "platform, requested, ok",
    [
        ("gpu", "", True),
        ("cpu", "cpu", True),
        ("cpu", "", False),  # JAX fell back to the CPU on its own
        ("cpu", "cuda", False),
    ],
)
def test_platform_not_asked_for_is_refused(platform, requested, ok):
    if ok:
        bench.check_platform(platform, requested)
    else:
        with pytest.raises(RuntimeError, match="not a GPU"):
            bench.check_platform(platform, requested)


def test_failing_row_is_recorded_and_fails_the_run(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "_DETAIL_PATH", str(tmp_path / "detail.json"))
    b = bench.Bench({"platform": "cpu", "kind": "cpu", "count": 1})
    assert b.run_row("broken", lambda: 1 / 0) is None
    b.run_row("fine", lambda: {"ms_per_step": 1.0})
    assert b.failed == ["broken"]
    assert b.rows["broken"].startswith("ZeroDivisionError")
    detail = json.loads((tmp_path / "detail.json").read_text())
    assert detail["ms_per_step"]["fine"] == 1.0

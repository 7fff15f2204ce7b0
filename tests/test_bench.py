"""bench.py's harness contract: children refuse to measure without a GPU,
a failed item makes the run exit non-zero, and the JSON line names the
device and the card's power limit."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _bench(env_extra, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_ENABLE_X64")}
    env.update({"JAX_PLATFORMS": "cpu", **env_extra})
    return subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_child_refuses_cpu():
    r = _bench({"BENCH_CHILD": "fcc_lossy"})
    assert r.returncode != 0
    assert "BENCH_RESULT" not in r.stdout
    assert "no GPU" in r.stderr


def test_failed_item_exits_nonzero_and_json_names_device():
    r = _bench({"BENCH_ONLY": "none", "BENCH_BUDGET_S": "300"})
    assert r.returncode != 0
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["failed"] == ["fcc_lossy"] and out["value"] is None
    assert "device" in out and "power_limit" in out

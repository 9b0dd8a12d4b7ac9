"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the CPU
(``--device cpu``), each run in a subprocess with an explicit environment
and a time limit."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--docs", "250", "--vocab", "3000",
         "--requests", "100", "--max-batch", "8"]


def _serve(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module")
def snapshot_boots(tmp_path_factory):
    """Two boots: a build saved as a snapshot, then a boot from it."""
    snap = tmp_path_factory.mktemp("snap")
    first = _serve(*SMALL, "--smoke", "--snapshot-dir", str(snap),
                   "--save-snapshot")
    second = _serve(*SMALL, "--smoke", "--snapshot-dir", str(snap),
                    "--metrics")
    return first, second


def test_cli_smoke_passes_on_the_cpu(snapshot_boots):
    first, _ = snapshot_boots
    assert first.returncode == 0, first.stdout + first.stderr[-3000:]
    assert "smoke: PASS" in first.stdout
    assert "building corpus: 250 docs" in first.stdout
    assert "snapshot committed" in first.stdout
    assert "executors built after warmup: 0" in first.stdout


def test_cli_second_boot_loads_the_snapshot_without_building(snapshot_boots):
    _, second = snapshot_boots
    assert second.returncode == 0, second.stdout + second.stderr[-3000:]
    assert "smoke: PASS" in second.stdout
    assert "loading snapshot v1" in second.stdout
    assert "building corpus" not in second.stdout
    # --metrics: the registry's stage breakdown and roofline gauge print
    assert "stage latency attribution" in second.stdout
    assert "roofline[cpu]" in second.stdout


def test_cli_rejects_bm25_on_dr_cleanly():
    r = _serve(*SMALL, "--strategy", "dr", "--measure", "bm25", "--smoke")
    assert r.returncode != 0
    assert "error:" in r.stderr and "bm25" in r.stderr.lower()
    assert "Traceback" not in r.stderr


def test_cli_rejects_shards_cleanly():
    # --shards N > 0 serves a sharded engine now; a negative count, and more
    # shards than documents, still exit with a one-line error
    r = _serve(*SMALL, "--shards", "-1")
    assert r.returncode != 0
    assert "error: --shards" in r.stderr
    assert "Traceback" not in r.stderr
    assert "building corpus" not in r.stdout
    r = _serve(*SMALL, "--docs", "3", "--shards", "4")
    assert r.returncode != 0
    assert "error:" in r.stderr and "zero documents" in r.stderr
    assert "Traceback" not in r.stderr


def test_cli_sharded_smoke_on_the_cpu(tmp_path):
    """``--shards 4`` builds a document-sharded engine, snapshots it, serves
    a smoke load, and boots again from the snapshot."""
    snap = str(tmp_path / "snap")
    first = _serve(*SMALL, "--shards", "4", "--smoke", "--snapshot-dir",
                   snap, "--save-snapshot")
    assert first.returncode == 0, first.stdout + first.stderr[-3000:]
    assert "smoke: PASS" in first.stdout
    assert "snapshot committed" in first.stdout
    assert "executors built after warmup: 0" in first.stdout
    second = _serve(*SMALL, "--smoke", "--snapshot-dir", snap,
                    "--mode", "and", "--measure", "bm25")
    assert second.returncode == 0, second.stdout + second.stderr[-3000:]
    assert "loading snapshot v1" in second.stdout
    assert "building corpus" not in second.stdout
    assert "smoke: PASS" in second.stdout

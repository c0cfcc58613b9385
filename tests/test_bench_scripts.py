"""Smoke tests for the benchmark drivers: each refuses to time a CPU, and
its timed functions run at tiny sizes here — keeps the measurement
harness from rotting."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def _run(args, timeout=240):
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env=ENV, timeout=timeout,
        capture_output=True, text=True,
    )


def _load(relpath):
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_py_smoke():
    r = _run(["bench.py"])
    assert r.returncode != 0 and "no GPU" in r.stderr, r.stderr[-2000:]
    assert "maxwell_spmm_nnz_per_s" not in r.stdout
    d = _load("bench.py").measure(n_grid=6, p=2)
    json.dumps(d)
    assert d["metric"] == "maxwell_spmm_nnz_per_s"
    assert d["value"] > 0 and d["vs_baseline"] > 0
    assert d["device"]["platform"] == "cpu"


@pytest.mark.slow
def test_sweep_driver_smoke(tmp_path):
    sw = _load("benchmarks/sweep_lanczos.py")
    csv = str(tmp_path / "bl.csv")
    args = sw.parser().parse_args(
        ["--block", "--n-col", "2", "--n-min", "4", "--n-max", "5",
         "--m1", "2", "--m2", "4", "--csv", csv])
    rows = sw.sweep(args)
    assert rows and os.path.exists(csv)
    assert len(open(csv).read().splitlines()) >= 2


def test_weak_scaling_smoke():
    ws = _load("benchmarks/weak_scaling.py")
    rows = ws.weak_scaling([1, 2], n_xy=4, z_per_device=8, p=2)
    assert len(rows) == 2 and rows[0]["efficiency"] == 1.0
    assert rows[1]["nz"] == 16


@pytest.mark.slow
def test_kernel_bench_smoke():
    kb = _load("benchmarks/kernel_bench.py")
    assert len(kb.bench_sqrtm()) == 9

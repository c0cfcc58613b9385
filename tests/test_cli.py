"""CLI driver: both paths reproduce the reference's validation behavior
(rel. error vs FDTD, `test_lanczos.cu:118-123` / `:294-301`)."""

import pytest

from lanczos_tpu.cli import build_parser, config_from_args, run


def _run(argv):
    cfg = config_from_args(build_parser().parse_args(argv))
    return run(cfg)


def test_block_driver_converges():
    out = _run([
        "-N", "3", "-m", "6", "--block", "--n-col", "4",
        "--fdtd-steps", "100000", "--dtype", "float64", "--lc", "20",
        "--eig-backend", "lax",
    ])
    assert out["relative_error"] < 1e-4


def test_vector_driver_converges():
    out = _run([
        "-N", "3", "-m", "8", "--vector", "--fdtd-steps", "100000",
        "--dtype", "float64", "--lc", "20", "--reorth", "full",
    ])
    assert out["relative_error"] < 1e-4


@pytest.mark.slow
def test_stacked_operator_driver():
    out = _run([
        "-N", "3", "-m", "6", "--block", "--operator", "stacked",
        "--fdtd-steps", "50000", "--lc", "20", "--eig-backend", "lax",
    ])
    assert out["relative_error"] < 1e-3


@pytest.mark.slow
def test_distributed_stacked_driver():
    out = _run([
        "-N", "3", "-m", "5", "--vector", "--operator", "stacked",
        "--devices", "8", "--fdtd-steps", "50000", "--lc", "20",
    ])
    assert out["relative_error"] < 1e-3


def test_ell_operator_driver():
    out = _run([
        "-N", "3", "-m", "6", "--block", "--operator", "ell",
        "--fdtd-steps", "50000", "--lc", "20", "--eig-backend", "lax",
    ])
    assert out["relative_error"] < 1e-3

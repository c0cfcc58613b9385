"""`chip_smoke.py` at tiny sizes on the CPU: each phase function end to end
(the Triton-route Gram kernel in interpret mode, phase D on four virtual
devices), the refusal without a GPU, and the compile-cache rule of the
entry points."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, cwd, env_extra=None, drop=(), timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          timeout=timeout, capture_output=True, text=True)


def test_phase_a_tiny(capsys):
    cs.phase_a(n_grid=6, m=5, fdtd_steps=40, timing_grids=(6,))
    out = capsys.readouterr().out
    assert '"expm_block"' in out and '"expm_vector"' in out
    assert '"stencil_mm"' in out


def test_phase_b_tiny(capsys):
    cs.phase_b(n_rows=20_000)
    assert '"ell_vs_dia"' in capsys.readouterr().out


def test_phase_c_tiny(capsys):
    cs.phase_c(n_grid=6, ps=(1, 4), interpret=True)
    out = capsys.readouterr().out
    assert '"fused_iteration"' in out and '"block_mix"' in out


def test_phase_d_tiny(capsys):
    cs.phase_d(n_devices=4, n_rows=40_000, n_grid=8)
    out = capsys.readouterr().out
    assert '"eigsh_halo_ell"' in out and '"expm_stacked"' in out


def test_refuses_without_gpu():
    r = _python(["chip_smoke.py"], cwd=REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _python(["chip_smoke.py"], cwd=str(tmp_path), drop=("PYTHONPATH",))
    assert r.returncode != 0 and '"ok"' not in r.stdout


_CACHE_PROBE = (
    "import jax, lanczos_tpu.utils.compile_cache as c; "
    "print(c.use_checkout_cache()); "
    "print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_rule(tmp_path, env_set):
    """Unset: the cache lands in <checkout>/.jax_cache.  Set: JAX keeps the
    variable's directory and the program sets no other."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    r = _python(["-c", _CACHE_PROBE], cwd=str(tmp_path), env_extra=extra,
                drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-2000:]
    used, configured = r.stdout.split()
    want = str(tmp_path) if env_set else os.path.join(REPO, ".jax_cache")
    assert used == configured == want

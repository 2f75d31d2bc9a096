"""Entry points tell the truth about the device: no fallback to another
backend, no host-CPU detour, a compile cache at a stable place."""
import dataclasses
import os

import jax
import numpy as np
import pytest

from eigensolver_tpu import cases
from eigensolver_tpu.search import SearchConfig
from eigensolver_tpu.sweep import run_case
from eigensolver_tpu.utils import enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = enable_compile_cache()
    assert first == enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first


def test_dryrun_multichip_refuses_missing_devices():
    import __graft_entry__ as g
    with pytest.raises(RuntimeError, match="needs"):
        g.dryrun_multichip(len(jax.devices()) + 1)


def test_bench_refuses_cpu():
    import bench
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None)


def test_refine_f64_runs_on_default_device(monkeypatch):
    """The f64 refine asks for no CPU device: it runs wherever
    jax.default_device points, and tightens the f32 roots to the f64 ones."""
    real_devices = jax.devices

    def no_cpu_lookup(backend=None):
        assert backend is None, f"refine looked up backend {backend!r}"
        return real_devices()

    case = cases.slab_density_photospheric(width=1e5)
    case = dataclasses.replace(
        case, n_k=2, k_min=1.0, k_max=2.0, speeds=(1.05, 1.17, 1.29),
        grid=dataclasses.replace(case.grid, n_interior=256))
    rs64, _ = run_case(case, SearchConfig(n_omega=64, n_bisect=60))
    monkeypatch.setattr(jax, "devices", no_cpu_lookup)
    with jax.default_device(real_devices()[-1]):
        rs32, _ = run_case(case, SearchConfig(n_omega=64, n_bisect=30,
                                              scan_dtype="float32",
                                              polish_dtype="float32"),
                           refine_f64=True)
    for name in rs64.branches:
        a = np.sort(rs32[name].omegas)
        b = np.sort(rs64[name].omegas)
        assert len(a) == len(b) > 0, (name, a, b)
        assert np.max(np.abs(a - b) / b) < 2e-7

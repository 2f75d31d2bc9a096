"""Tests that need the card. Run them on a machine with a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -q

Each decides inside the `gpu` fixture whether JAX's default device is a GPU
and skips with a reason otherwise (so they skip under the CPU tier)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import kv, kvp

from eigensolver_tpu import cases, special
from eigensolver_tpu.search import SearchConfig
from eigensolver_tpu.sweep import run_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-12),
                                        (jnp.float32, 1e-5)])
def test_kve_ratio_on_gpu_matches_scipy(gpu, dtype, rtol):
    zs = np.geomspace(0.05, 30.0, 513)
    r0, r1 = jax.jit(jax.vmap(special.kve_ratio_both))(jnp.asarray(zs, dtype))
    assert r0.devices() == {gpu}
    for m, got in ((0, r0), (1, r1)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   kvp(m, zs) / kv(m, zs), rtol=rtol)


def test_cpu_gpu_f64_roots_agree(gpu):
    """Phase 3(b) of chip_smoke.py (which runs the cylinder) at a small
    size, on the slab engine: the same f64 sweep on the GPU and on the CPU
    backend gives the same roots to 1e-9."""
    case = cases.slab_density_photospheric(width=0.9)
    case = dataclasses.replace(
        case, k_values=(0.5, 2.0),
        grid=dataclasses.replace(case.grid, n_interior=512))
    cfg = SearchConfig(n_omega=128, n_bisect=60)
    rs_gpu, _ = run_case(case, cfg)
    with jax.default_device(jax.devices("cpu")[0]):
        rs_cpu, _ = run_case(case, cfg)
    for name in rs_gpu.branches:
        a, b = rs_gpu[name], rs_cpu[name]
        assert len(a) == len(b) > 0, (name, len(a), len(b))
        ia, ib = np.lexsort((a.omegas, a.ks)), np.lexsort((b.omegas, b.ks))
        rel = np.abs(a.omegas[ia] - b.omegas[ib]) / np.abs(b.omegas[ib])
        assert rel.max() <= 1e-9, (name, rel.max())


def test_refine_f64_on_gpu(gpu):
    """f32 sweep + f64 refine on the card reaches the f64 sweep's roots
    (tests/test_refine.py's case)."""
    case = cases.slab_density_photospheric(width=1e5)
    case = dataclasses.replace(
        case, n_k=3, k_min=1.0, k_max=2.0, speeds=(1.05, 1.17, 1.29),
        grid=dataclasses.replace(case.grid, n_interior=1024))
    rs32, _ = run_case(case, SearchConfig(n_omega=128, n_bisect=40,
                                          scan_dtype="float32",
                                          polish_dtype="float32"),
                       refine_f64=True)
    rs64, _ = run_case(case, SearchConfig(n_omega=128, n_bisect=60))
    for name in rs64.branches:
        a = np.sort(rs32[name].omegas)
        b = np.sort(rs64[name].omegas)
        assert len(a) == len(b) > 0, (name, len(a), len(b))
        assert np.max(np.abs(a - b) / b) < 2e-7

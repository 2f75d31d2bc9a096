"""Modified-Bessel module vs scipy (real + complex)."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy.special import iv, ivp, kv, kvp

from eigensolver_tpu import special


@pytest.mark.parametrize("m", [0, 1])
def test_kve_ratio_real(m):
    zs = np.array([0.05, 0.5, 1.5, 1.99, 2.01, 3.0, 5.0, 8.9, 15.0, 50.0, 200.0])
    got = np.asarray(special.kve_ratio(m, jnp.asarray(zs)))
    want = kvp(m, zs) / kv(m, zs)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("m", [0, 1])
def test_kve_ratio_complex(m):
    rng = np.random.default_rng(0)
    zs = rng.uniform(0.05, 20, 25) + 1j * rng.uniform(-10, 10, 25)
    got = np.asarray(special.kve_ratio(m, jnp.asarray(zs)))
    want = np.array([kvp(m, z) / kv(m, z) for z in zs])
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("m", [0, 1])
def test_ive_ratio_real(m):
    zs = np.array([0.1, 1.0, 4.0, 8.0])
    got = np.asarray(special.ive_ratio(m, jnp.asarray(zs)))
    want = ivp(m, zs) / iv(m, zs)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_k_values_small():
    zs = np.array([0.1, 0.7, 1.9])
    np.testing.assert_allclose(np.asarray(special.k0(jnp.asarray(zs))),
                               kv(0, zs), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(special.k1(jnp.asarray(zs))),
                               kv(1, zs), rtol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-12),
                                        (jnp.float32, 1e-5)])
@pytest.mark.parametrize("m", [0, 1])
def test_kve_ratio_both_vmapped(m, dtype, rtol):
    """The exterior ratio as the cylinder dispersion evaluates it: vmapped
    over a batch of real arguments, at the sweep's f32 and the refine's f64."""
    import jax
    zs = np.geomspace(0.05, 30.0, 257)
    got = jax.vmap(special.kve_ratio_both)(jnp.asarray(zs, dtype))[m]
    assert got.dtype == dtype
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               kvp(m, zs) / kv(m, zs), rtol=rtol)


@pytest.mark.slow
def test_bessel_exterior_equals_numeric_exterior():
    """Cylinder dispersion roots identical under 'bessel' vs 'numeric'
    exterior treatment (machine precision)."""
    import dataclasses
    import jax
    from eigensolver_tpu import cases
    from eigensolver_tpu.search import bisect, find_brackets, ladder_scan
    from eigensolver_tpu.sweep import make_dispersion

    case_b = cases.cylinder_density_coronal(width=1e5)
    case_b = dataclasses.replace(
        case_b, grid=dataclasses.replace(case_b.grid, n_interior=256))
    case_n = dataclasses.replace(
        case_b, grid=dataclasses.replace(case_b.grid, exterior_method="numeric"))
    k = 1.0
    W = np.linspace(2.0, 4.0, 801)
    out = {}
    for nm, c in [("bessel", case_b), ("numeric", case_n)]:
        disp = jax.jit(jax.vmap(make_dispersion(c, 1)))
        om = jnp.asarray(W * k)[None, :]
        ks = jnp.asarray([k])
        det, valid, _ = ladder_scan(disp, om, ks)
        d = np.asarray(det[0])
        v = np.asarray(valid[0])
        s = np.sign(d)
        roots = []
        for i in np.nonzero((s[:-1] * s[1:] < 0) & v[:-1] & v[1:])[0]:
            roots.append(W[i] - d[i] * (W[i + 1] - W[i]) / (d[i + 1] - d[i]))
        out[nm] = np.asarray(roots)
    assert len(out["bessel"]) == len(out["numeric"]) > 0
    # numeric exterior carries its own RK discretisation error (~1e-8)
    np.testing.assert_allclose(out["bessel"], out["numeric"], rtol=1e-6)

"""Candidate-grid sharding: sharded sweep == single-device sweep, exactly.

Runs on the 8-virtual-device CPU mesh from conftest (the stand-in for a
multi-card mesh, SURVEY.md section 4/5 testing plan).
"""
import dataclasses

import jax
import numpy as np
import pytest

from eigensolver_tpu import cases
from eigensolver_tpu.parallel import make_mesh, run_case_sharded
from eigensolver_tpu.search import SearchConfig
from eigensolver_tpu.sweep import run_case


@pytest.fixture(scope="module")
def small_case():
    case = cases.slab_density_photospheric(width=1e5)
    return dataclasses.replace(
        case, n_k=5, k_min=1.0, k_max=3.0,
        speeds=(0.95, 1.05, 1.15, 1.29),
        grid=dataclasses.replace(case.grid, n_interior=512))


def test_sharded_equals_single(small_case):
    assert len(jax.devices()) == 8, "conftest should fake 8 devices"
    cfg = SearchConfig(n_omega=96, n_bisect=45)
    rs1, _ = run_case(small_case, cfg)
    rs8, _ = run_case_sharded(small_case, make_mesh(8), cfg)
    for name in rs1.branches:
        a = np.sort(rs1[name].omegas)
        b = np.sort(rs8[name].omegas)
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(a, b)


@pytest.mark.slow  # fast-tier budget: the Pallas kernel is opt-in and the padding variant duplicates the sharding gate (re-tiered r05; <50 s bar)
def test_sharded_odd_row_count_padding(small_case):
    """Row counts not divisible by the mesh exercise the padding path."""
    case = dataclasses.replace(small_case, n_k=3)  # 3*3=9 rows over 8 devices
    cfg = SearchConfig(n_omega=96, n_bisect=45)
    rs1, _ = run_case(case, cfg)
    rs8, _ = run_case_sharded(case, make_mesh(8), cfg)
    for name in rs1.branches:
        np.testing.assert_array_equal(np.sort(rs1[name].omegas),
                                      np.sort(rs8[name].omegas))


def test_graft_dryrun():
    import __graft_entry__ as g
    g.dryrun_multichip(8)
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == (1024,)


@pytest.mark.slow
def test_sharded_refine_f64_matches_single(small_case):
    """f64 refinement now runs under a mesh too (shared finalize_branches
    tail, VERDICT r02 weak #6): sharded+refined == single+refined exactly.
    Slow tier; gates the BASELINE accuracy x scaling joint claim."""
    cfg = SearchConfig(n_omega=96, n_bisect=20, scan_dtype="float32",
                       polish_dtype="float32")
    rs1, _ = run_case(small_case, cfg, refine_f64=True)
    rs8, _ = run_case_sharded(small_case, make_mesh(8), cfg, refine_f64=True)
    total = 0
    for name in rs1.branches:
        a = np.sort(rs1[name].omegas)
        b = np.sort(rs8[name].omegas)
        np.testing.assert_array_equal(a, b)
        total += len(a)
    assert total > 0
    # refinement really ran: refined roots are f64-converged (the raw f32
    # polish leaves ~1e-6 relative residual vs the f64 zero)
    from eigensolver_tpu.sweep import make_dispersion
    import jax.numpy as jnp
    disp = jax.jit(jax.vmap(make_dispersion(small_case, 1, dtype=jnp.float64)))
    br = rs1["kink"]
    res = disp(jnp.asarray(br.omegas), jnp.asarray(br.ks))
    assert float(np.max(np.asarray(res.mismatch_pct))) < 0.5

"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of its
phases rehearses its control flow at a tiny grid (n_k 3, n_interior 64)."""
import dataclasses

import pytest

import chip_smoke
from eigensolver_tpu import cases


def tiny(case, **kw):
    return dataclasses.replace(
        case, n_k=3, grid=dataclasses.replace(case.grid, n_interior=64), **kw)


def test_main_refuses_cpu(capfd):
    rc = chip_smoke.main([])
    out = capfd.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out
    assert "phase 2" not in out          # failed before any sweep


def test_main_rejects_unknown_option():
    assert chip_smoke.main(["--bogus"]) == 2


def test_phase_device_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="not a GPU"):
        chip_smoke.phase_device()


def test_phase_main_path():
    out = chip_smoke.phase_main_path(
        [tiny(cases.slab_density_photospheric(width=0.9))],
        tiny(cases.slab_flow_complex_coronal()))
    assert len(out) == 2
    assert all(r["wall_s"] > 0 for r in out.values())


def test_phase_oracles():
    case = tiny(cases.slab_density_photospheric(width=1e5),
                speeds=(0.905, 0.93, 0.955, 0.98, 0.9995))
    out = chip_smoke.phase_oracles([(case, "slab")])
    assert out and all(r["n"] > 0 for r in out.values())


def test_phase_cpu_vs_default_device():
    out = chip_smoke.phase_cpu_vs_gpu(
        tiny(cases.slab_density_photospheric(width=0.9)))
    assert set(out) == {"sausage", "kink"}


def test_phase_memory():
    case = tiny(cases.slab_density_photospheric(width=0.9))
    out = chip_smoke.dispatch_memory(case, chip_smoke.f32_search(case), "tiny")
    assert out["shape"] == [128, case.grid.n_omega_ladder]
    assert out["temp_size_in_bytes"] > 0


def test_phase_four_cards_on_virtual_devices():
    out = chip_smoke.phase_four_cards(
        tiny(cases.slab_density_photospheric(width=0.9)), n_cards=4)
    assert out["sausage"]["n"] > 0 and out["kink"]["n"] > 0

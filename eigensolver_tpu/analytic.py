"""Closed-form uniform-limit dispersion relations ("known dispersion" curves).

The reference validates its shooting engine against brute-force scans of the
analytic uniform-slab-with-flow relations and overlays them on the dispersion
diagram as the "known" curves (`Slab/Non uniform flow/Solver/
flow_multiprocessor.py:117-127` definitions, `:146-276` the 1e-3-step scan,
`:356` the overlay). Here the same capability is one public module:

- `slab_relation`   - uniform slab (+ uniform internal/external flow):
  sausage/kink tanh relation; body modes come out of the same expression via
  the complex square root (Re of the relation has the tan-form zeros).
- `cylinder_relation` - uniform magnetic cylinder (Edwin & Roberts 1983 form):
  rho_e (Om_e^2 - k^2 vA_e^2) m_i I_m'(m_i)/I_m(m_i)
    - rho_i (Om_i^2 - k^2 vA_i^2) m_e K_m'(m_e)/K_m(m_e),
  body modes via complex m_i (I_m(ix) = i^m J_m(x), so the expression is real
  on the body branch too).
- `scan_relation`   - vectorised dense-scan + bisection root finder over a
  phase-speed window (replaces the reference's per-point Python loop).
- `analytic_curves` - roots on a k grid packaged as a RootBranch for direct
  overlay with `viz.dispersion_diagram(..., analytic=...)`.
- `analytic_deviation` - per-root relative distance of solver roots to the
  nearest zero of the relation (the uniform-limit accuracy oracle).

Host-side utility (numpy/scipy): this is the L4 validation layer, not the
device compute path - the solver-side oracle tests in `tests/test_slab_analytic.py`
and `tests/test_cylinder_analytic.py` use the same relations.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from .config import Regime
from .roots import RootBranch


def _msq(c2, a2, Om):
    """Evanescence coefficient m^2(Omega) = (c^2-Om^2)(a^2-Om^2) /
    ((c^2+a^2)(cT^2-Om^2)) in phase-speed units (Om = omega/k - U)."""
    cT2 = c2 * a2 / (c2 + a2) if (c2 + a2) else 0.0
    return (c2 - Om**2) * (a2 - Om**2) / ((c2 + a2) * (cT2 - Om**2))


def slab_relation(rg: Regime, v, k, parity: int):
    """Uniform-slab dispersion relation value at phase speed(s) v = omega/k.

    parity 0 = sausage (tanh form), 1 = kink (coth form); zeros of the
    returned (real) value are the eigenvalues. Doppler shifts U_i0/U_e are
    honoured (`flow_multiprocessor.py:117-127`). Vectorised over `v`.
    """
    vc = np.asarray(v, complex)
    Om_i = vc - rg.U_i0
    Om_e = vc - rg.U_e
    m0 = np.sqrt(_msq(rg.c_i0**2, rg.vA_i0**2, Om_i))
    me = np.sqrt(_msq(rg.c_e**2, rg.vA_e**2, Om_e))
    R1 = rg.rho_e / rg.rho_i0
    base = R1 * (rg.vA_e**2 - Om_e**2) * m0 / (me * (rg.vA_i0**2 - Om_i**2))
    th = np.tanh(np.asarray(k) * m0)
    val = base * th + 1 if parity == 0 else base / th + 1
    return val.real


def cylinder_relation(rg: Regime, v, k, m: int):
    """Uniform-cylinder dispersion relation value at phase speed(s) v.

    Interface matching of P_T and xi_r with interior I_m(m_i r) and exterior
    K_m(m_e r); the complex sqrt routes body modes through J_m automatically.
    (The reference never evaluates this analytically - it integrates the same
    exterior equation numerically, `Density_cylinder.py:628-631` - but its
    uniform-limit `width=1e5` runs are regression points for exactly this
    relation.) Vectorised over `v`.
    """
    from scipy.special import ivp, iv, kvp, kv

    vc = np.asarray(v, complex)
    kk = np.asarray(k, float)
    Om_i = vc - rg.U_i0
    Om_e = vc - rg.U_e
    m_i = np.sqrt(_msq(rg.c_i0**2, rg.vA_i0**2, Om_i)) * kk
    m_e = np.sqrt(_msq(rg.c_e**2, rg.vA_e**2, Om_e)) * kk
    # xi_r ~ P' / (rho (Om^2 - vA^2)); continuity of xi_r/P_T across r=1
    i_ratio = m_i * ivp(m, m_i) / iv(m, m_i)
    k_ratio = m_e * kvp(m, m_e) / kv(m, m_e)
    val = (rg.rho_e * ((kk * Om_e)**2 - kk**2 * rg.vA_e**2) * i_ratio
           - rg.rho_i0 * ((kk * Om_i)**2 - kk**2 * rg.vA_i0**2) * k_ratio)
    # scale-invariant normalisation keeps the scan well-conditioned
    scale = np.abs(rg.rho_e * ((kk * Om_e)**2 - kk**2 * rg.vA_e**2) * i_ratio) \
        + np.abs(rg.rho_i0 * ((kk * Om_i)**2 - kk**2 * rg.vA_i0**2) * k_ratio)
    return (val / np.where(scale == 0.0, 1.0, scale)).real


def scan_relation(fn: Callable[[np.ndarray], np.ndarray], v_lo: float,
                  v_hi: float, n_scan: int = 4001, n_bisect: int = 50,
                  max_jump: float = 10.0) -> np.ndarray:
    """All zeros of a scalar relation over [v_lo, v_hi]: dense scan for sign
    changes, vectorised bisection to convergence. Pole crossings (sign changes
    where |f| stays large on both sides) are rejected by the `max_jump` bound
    relative to the scan's median |f| - the reference's brute-force scan keeps
    them and filters by residual later (`flow_multiprocessor.py:146-290`)."""
    v = np.linspace(v_lo, v_hi, n_scan)
    f = np.asarray(fn(v))
    finite = np.isfinite(f)
    s = np.signbit(f)
    idx = np.nonzero((s[:-1] != s[1:]) & finite[:-1] & finite[1:])[0]
    if len(idx) == 0:
        return np.empty(0)
    med = np.median(np.abs(f[finite])) or 1.0
    ok = np.minimum(np.abs(f[idx]), np.abs(f[idx + 1])) < max_jump * med
    lo, hi = v[idx[ok]], v[idx[ok] + 1]
    f_lo = np.asarray(fn(lo))
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        f_mid = np.asarray(fn(mid))
        right = np.signbit(f_mid) == np.signbit(f_lo)
        lo = np.where(right, mid, lo)
        hi = np.where(right, hi, mid)
        f_lo = np.where(right, f_mid, f_lo)
    root = 0.5 * (lo + hi)
    # reject residual poles: |f| must actually be small at the "root"
    res = np.abs(np.asarray(fn(root)))
    return root[res < 1e-4 * max(1.0, med)]


def analytic_curves(rg: Regime, ks: Sequence[float], v_lo: float, v_hi: float,
                    geometry: str = "slab", modes: Sequence[int] = (0, 1),
                    n_scan: int = 4001) -> Dict[str, RootBranch]:
    """Analytic dispersion roots on a k grid, as {branch: RootBranch} - the
    "known dispersion" overlay data of the reference's validation figures
    (`flow_multiprocessor.py:356,904,937`)."""
    from .sweep import MODE_NAMES

    rel = slab_relation if geometry == "slab" else cylinder_relation
    out: Dict[str, RootBranch] = {}
    for mode in modes:
        oms, kks = [], []
        for k in ks:
            roots = scan_relation(lambda v: rel(rg, v, k, mode),
                                  v_lo, v_hi, n_scan=n_scan)
            oms.extend(np.asarray(roots) * k)
            kks.extend([k] * len(roots))
        out[MODE_NAMES.get(mode, f"m{mode}")] = RootBranch(
            omegas=np.asarray(oms), ks=np.asarray(kks)).sorted_by_k()
    return out


def nearest_zero(f_batch, v0, w_start=4e-6, w_max=5e-3, n_scan=257):
    """The analytic-relation zero NEAREST v0, by expanding-window scan.

    A single wide bracket fails near mode-accumulation points: with several
    adjacent analytic zeros (and tan-type poles) inside it, plain bisection
    lands on an arbitrary sign change and reports a ~1e-3 'deviation' that
    is matcher error, not solver error. Here the window starts at +-4e-6
    relative and grows 8x until it contains at least one sign-change
    bracket; ALL brackets in the window are bisected,
    pole crossings are rejected (|f| at the converged point exceeding the
    bracket-endpoint values identifies a tan/K_m pole), and the zero
    closest to v0 wins - so a root is never matched across a nearer zero.
    """
    w = w_start
    while w <= w_max:
        lo, hi = v0 * (1 - w), v0 * (1 + w)
        vs = np.linspace(lo, hi, n_scan)
        fs = f_batch(vs)
        ok = np.isfinite(fs)
        sgn = np.sign(fs)
        br = (sgn[:-1] * sgn[1:] < 0) & ok[:-1] & ok[1:]
        zeros = []
        for i in np.where(br)[0]:
            a, b = vs[i], vs[i + 1]
            fa, fb = fs[i], fs[i + 1]
            for _ in range(80):
                m = 0.5 * (a + b)
                fm = f_batch(np.asarray([m]))[0]
                if not np.isfinite(fm):
                    break
                if np.sign(fm) == np.sign(fa):
                    a, fa = m, fm
                else:
                    b, fb = m, fm
            v_star = 0.5 * (a + b)
            # pole rejection: at a genuine zero |f| shrinks toward the
            # bisection limit; at a tan/K_m pole it blows up past the
            # original bracket endpoints
            probe = f_batch(v_star * np.asarray([1 - 1e-12, 1 + 1e-12]))
            probe = probe[np.isfinite(probe)]
            if len(probe) and np.min(np.abs(probe)) > 10.0 * max(
                    abs(fs[i]), abs(fs[i + 1])):
                continue
            zeros.append(v_star)
        if zeros:
            return min(zeros, key=lambda z: abs(z - v0))
        if w == w_max:
            break
        # clamp the final iteration TO w_max: the bare x8 ladder ends at
        # 2.048e-3 and would never scan the documented +-0.5%
        w = min(w * 8.0, w_max)
    return np.nan


def analytic_deviation(rg, omegas, ks, branch_parity, geometry):
    """Per-root relative deviation |om - om_analytic| / om_analytic, where
    om_analytic is the analytic-relation zero NEAREST each refined root
    (see nearest_zero; NaN where no zero exists within +-0.5%)."""
    rel = slab_relation if geometry == "slab" else cylinder_relation
    devs = []
    for om, k in zip(omegas, ks):
        f_batch = lambda v: np.asarray(rel(rg, np.asarray(v), k,
                                           branch_parity))
        v0 = om / k
        v_star = nearest_zero(f_batch, v0)
        devs.append(abs(v0 - v_star) / abs(v_star)
                    if np.isfinite(v_star) else np.nan)
    return np.asarray(devs)

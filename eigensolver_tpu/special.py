"""Modified Bessel functions I_m, K_m (m = 0, 1) for real AND complex
arguments, pure JAX.

Why: the cylinder exterior solution is exactly K_m(sqrt(m_e) r) - the
reference integrates it numerically with LSODA over a 3-wavelength domain
(`Density_cylinder.py:628-634`; there are NO scipy.special Bessel calls
anywhere in the reference tree, SURVEY.md S7). Evaluating K_m analytically at
the interface replaces the 512-step exterior integration per candidate with a
few dozen flops, and handles complex m_e (Kelvin-Helmholtz path) natively.

Method: ascending series for |z| <= 9 (A&S 9.6.10-9.6.13 forms with the log
term for K), asymptotic expansion for |z| > 9 (A&S 9.7.1-9.7.2), blended with
`jnp.where`. The dispersion determinant only needs the scale-invariant
logarithmic derivative K_m'(z)/K_m(z), so overflow/underflow of e^{+-z} is
avoided entirely by using the SCALED functions (I_m e^{-|Re z|}, K_m e^{+z}).
"""
from __future__ import annotations

import jax.numpy as jnp

_EULER_GAMMA = 0.5772156649015328606
_N_SERIES = 24          # (z^2/4)^k / (k!)^2 converges ~1e-16 by k=24 at |z|=9
_N_ASYMP = 10


def _series_ik(z, m: int):
    """Ascending-series I_m(z) (unscaled) and K_m(z) e^{+z} is NOT formed here;
    returns (I_m, K_m) by their convergent series - valid |z| <= ~9."""
    z2 = 0.25 * z * z
    half_log = jnp.log(0.5 * z)

    # I_0 / I_1 series and the K log-series accumulated together
    # K_0 = -(log(z/2)+gamma) I_0 + sum_{k>=1} (z^2/4)^k/(k!)^2 * H_k
    # K_1 = (1/z) + (log(z/2)+gamma) I_1 - ... (A&S 9.6.11/9.6.53 form)
    one = jnp.ones_like(z)
    if m == 0:
        term = one
        I = one
        Ksum = jnp.zeros_like(z)
        Hk = 0.0
        for k in range(1, _N_SERIES + 1):
            term = term * z2 / (k * k)
            Hk = Hk + 1.0 / k
            I = I + term
            Ksum = Ksum + term * Hk
        K = -(half_log + _EULER_GAMMA) * I + Ksum
        return I, K
    # m == 1
    term = one                 # (z/2)^{2k}/ (k! (k+1)!) accumulated with z/2 factor
    I = one * 0.5              # leading (z/2)/1 -> I1 = (z/2) sum ...
    # build I1 = (z/2) * sum_k (z^2/4)^k / (k!(k+1)!)
    s = one
    term = one
    for k in range(1, _N_SERIES + 1):
        term = term * z2 / (k * (k + 1))
        s = s + term
    I1 = 0.5 * z * s
    # K1 = 1/z + (log(z/2)+gamma) I1 - (z/4) sum_k (z^2/4)^k (H_k + H_{k+1}) / (k!(k+1)!)
    ssum = jnp.zeros_like(z)
    term = one
    Hk = 0.0
    Hk1 = 1.0
    ssum = ssum + term * (Hk + Hk1)
    for k in range(1, _N_SERIES + 1):
        term = term * z2 / (k * (k + 1))
        Hk = Hk + 1.0 / k
        Hk1 = Hk1 + 1.0 / (k + 1)
        ssum = ssum + term * (Hk + Hk1)
    K1 = 1.0 / z + (half_log + _EULER_GAMMA) * I1 - 0.25 * z * ssum
    return I1, K1


def _asymp_k_scaled(z, m: int):
    """K_m(z) e^{z} sqrt(2 z / pi) (i.e. the bracket of A&S 9.7.2) - |z| > ~9."""
    mu = 4.0 * m * m
    term = jnp.ones_like(z)
    s = jnp.ones_like(z)
    for k in range(1, _N_ASYMP + 1):
        term = term * (mu - (2 * k - 1) ** 2) / (8.0 * k * z)
        s = s + term
    return s


_N_CF2 = 60


def _cf2_h(z):
    """Steed/Temme continued fraction CF2 for modified Bessel K at order
    nu = 0: returns h with K_1/K_0 = (z + 0.5 - h)/z. Converges for
    Re z > 0, |z| >~ 1; fixed iteration count for jit."""
    a1 = 0.25
    b = 2.0 * (1.0 + z)
    d = 1.0 / b
    delh = d
    h = d
    a = -a1
    for i in range(2, _N_CF2 + 2):
        a = a - 2.0 * (i - 1)
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
    return a1 * h


def kve_ratio_both(z):
    """(K_0'/K_0, K_1'/K_1) for real z > 0 or complex z with Re z > 0.

    Uses K_0' = -K_1 and K_1' = -K_0 - K_1/z. The K_1/K_0 ratio comes from
    the ascending series for |z| < 2 (cancellation bounded to ~2 digits) and
    from the CF2 continued fraction at order 0 for |z| >= 2 (full precision
    for real and complex arguments). Both orders share the one r10 evaluation.
    """
    z = jnp.asarray(z)
    az = jnp.abs(z)
    small = az < 2.0
    zs = jnp.where(small, z, 1.0)          # keep series args in range
    zl = jnp.where(small, 4.0, z)

    _, K0s = _series_ik(zs, 0)
    _, K1s = _series_ik(zs, 1)
    h = _cf2_h(zl)
    r10 = jnp.where(small, K1s / K0s, (zl + 0.5 - h) / zl)
    return -r10, -1.0 / r10 - 1.0 / z


def kve_ratio(m: int, z):
    """K_m'(z) / K_m(z) for m in {0, 1} (see kve_ratio_both)."""
    r0, r1 = kve_ratio_both(z)
    return r0 if m == 0 else r1


def k0(z):
    """K_0(z) (unscaled; overflows/underflows outside ~|z|<700)."""
    z = jnp.asarray(z)
    az = jnp.abs(z)
    small = az <= 9.0
    zs = jnp.where(small, z, 1.0)
    zl = jnp.where(small, 10.0, z)
    _, K0s = _series_ik(zs, 0)
    large = jnp.sqrt(jnp.pi / (2.0 * zl)) * jnp.exp(-zl) * _asymp_k_scaled(zl, 0)
    return jnp.where(small, K0s, large)


def k1(z):
    z = jnp.asarray(z)
    az = jnp.abs(z)
    small = az <= 9.0
    zs = jnp.where(small, z, 1.0)
    zl = jnp.where(small, 10.0, z)
    _, K1s = _series_ik(zs, 1)
    large = jnp.sqrt(jnp.pi / (2.0 * zl)) * jnp.exp(-zl) * _asymp_k_scaled(zl, 1)
    return jnp.where(small, K1s, large)


def i0(z):
    """I_0(z) by series (|z| <= ~9 accurate; larger args overflow the series
    slowly - the dispersion path never needs unscaled I beyond that)."""
    I, _ = _series_ik(jnp.asarray(z), 0)
    return I


def i1(z):
    I, _ = _series_ik(jnp.asarray(z), 1)
    return I


def ive_ratio(m: int, z):
    """I_m'(z)/I_m(z) via series (interior analytic check in uniform limit)."""
    z = jnp.asarray(z)
    I0v, _ = _series_ik(z, 0)
    I1v, _ = _series_ik(z, 1)
    if m == 0:
        return I1v / I0v
    # I_1' = I_0 - I_1/z
    return I0v / I1v - 1.0 / z

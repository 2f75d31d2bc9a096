"""Cylinder geometry dispersion function (Hain-Lust P_T formulation).

Physics replicated from the reference solvers:
- non-uniform density:    `Cylinder/Non-uniform density/Coronal/solvers/
  Density_cylinder.py:546-825` (coefficient chain shift_freq, alfven_freq,
  cusp_freq, D, Q, T, C1, C2, C3, F = rD/C3, g; interior ODE
  P'' = -(F'/F)P' + (g/F)P; xi_r = (C1 P + D P')/C3; exterior modified-Bessel
  ODE; xi_r continuity matching)
- axial flow:             `Cylinder/Non-uniform flow/Coronal/solvers/
  Cylinder_method_flow_testing.py:575-626` (Doppler shift_freq)
- rotational flow:        `Cylinder/Rotational flow/Photospheric/Solvers/
  Twisted_photospheric_flow_sausage.py:482-577` (v_phi = v_twist r^power,
  force-balanced P_i(r), C1 with shift_freq^2, odeintz -> native complex)

Design deltas vs the reference (SURVEY.md section 7):
- The interior is integrated in the self-adjoint flux form (F P')' = g P with
  state (P, w = F P'), so dF/F is never formed; xi_r = C1 P / C3 + w / r.
  The reference re-derives F' and g *symbolically per (omega, k)*
  (`Density_cylinder.py:601-619`) - here g's derivative terms come from
  `jax.grad` of closed-form coefficient functions, traced once.
- Instead of fsolve-shooting on the unknown boundary derivative
  (`Density_cylinder.py:647-656`), we integrate TWO basis solutions inward
  from r = 1 and form the 2x2 determinant
      D(omega,k) = axis(u1) * match(u2) - axis(u2) * match(u1)
  where axis(u) is the reference's axis condition (kink: P(eps) = 0,
  `Density_cylinder.py:652-657`; sausage: P'(eps) = 0, `:1083-1085`) and
  match(u) = xi_u(1) * P_e(1) - xi_e(1) * P_u(1) is interface continuity.
  The same zeros, no nested root-find, fully vmappable.
- The exterior (P'' = -P'/r + (m_e + m^2/r^2) P, `Density_cylinder.py:630-631`)
  is integrated inward from r_far = W * 2pi/k with renormalised fixed-step RK4,
  selecting the decaying K_m-direction solution exactly as the reference's
  tiny-IC LSODA integration does. (The default exterior is the analytic
  Bessel-K logarithmic derivative of `eigensolver_tpu.special`.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from jax import lax

from .. import special
from ..config import CaseConfig
from ..equilibrium import Equilibrium, make_equilibrium
from ..ode import rk4_final


def _rk4_linear2(coef, y0, x0, x1, n_steps: int, unroll: int = 1):
    """Classical RK4 specialised to the two-basis LINEAR system
    d(P, w)/dx = (w * iF, g * P): the coefficient chain `coef(x) -> (iF, g)`
    - the expensive part, carrying the whole Hain-Lust chain - is evaluated
    at the 3 distinct RK4 abscissae (x, x + h/2, x + h) instead of once per
    stage (k2 and k3 share the midpoint chain, which XLA's CSE does not
    reliably merge across stage boundaries). The y-update arithmetic is identical to `ode.rk4_final` over
    `rhs_int2`, so integrated states are bit-identical where CSE did merge
    and mathematically identical everywhere."""
    h = (x1 - x0) / n_steps

    def apply(c, y):
        iF, g = c
        P1, w1, P2, w2 = y
        return (w1 * iF, g * P1, w2 * iF, g * P2)

    def axpy(a, y, k):
        return tuple(yi + a * ki for yi, ki in zip(y, k))

    def step(y, i):
        x = x0 + i * h
        cA = coef(x)
        cM = coef(x + 0.5 * h)
        cB = coef(x + h)
        k1 = apply(cA, y)
        k2 = apply(cM, axpy(0.5 * h, y, k1))
        k3 = apply(cM, axpy(0.5 * h, y, k2))
        k4 = apply(cB, axpy(h, y, k3))
        y_next = tuple(
            yi + (h / 6.0) * (a + 2 * b + 2 * c_ + d)
            for yi, a, b, c_, d in zip(y, k1, k2, k3, k4))
        return y_next, None

    yf, _ = lax.scan(step, y0, jnp.arange(n_steps), unroll=unroll)
    return yf


class CylinderInterface(NamedTuple):
    det: jnp.ndarray
    mismatch_pct: jnp.ndarray
    valid: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CylinderPhysics:
    case: CaseConfig
    eq: Equilibrium

    @classmethod
    def from_case(cls, case: CaseConfig) -> "CylinderPhysics":
        return cls(case=case, eq=make_equilibrium(case))

    # -- Hain-Lust coefficient chain (closed-form; `Density_cylinder.py:569-619`,
    #    twisted variant `Twisted_photospheric_flow_sausage.py:482-530`) --------

    def coefficients(self, omega, k, m: int, twisted_c1: bool):
        """Return closed-form scalar functions of r: D, C1, C2, C3, F, g."""
        eq = self.eq

        def shift_freq(r):
            # `Twisted_photospheric_flow_sausage.py:482` (with v_phi(r));
            # density case reduces to omega - k v_z.
            return omega - m * eq.v_phi(r) / r - k * eq.U_i(r)

        def alfven_freq(r):
            return m * eq.B_phi(r) / r + k * eq.B_i(r) / jnp.sqrt(eq.rho_i(r))

        def cusp_freq(r):
            ci = eq.c_i(r)
            return alfven_freq(r) * ci / jnp.sqrt(ci ** 2 + eq.vA_i(r) ** 2)

        def Dfun(r):
            s2 = shift_freq(r) ** 2
            return (eq.rho_i(r) * (eq.c_i(r) ** 2 + eq.vA_i(r) ** 2)
                    * (s2 - alfven_freq(r) ** 2) * (s2 - cusp_freq(r) ** 2))

        def Qfun(r):
            s = shift_freq(r)
            fb = m * eq.B_phi(r) / r + k * eq.B_i(r)
            return (-(s ** 2 - alfven_freq(r) ** 2) * eq.rho_i(r) * eq.v_phi(r) ** 2 / r
                    + 2.0 * s ** 2 * eq.B_phi(r) ** 2 / r
                    + 2.0 * s * eq.B_phi(r) * eq.v_phi(r) * fb / r)

        def Tfun(r):
            fb = m * eq.B_phi(r) / r + k * eq.B_i(r)
            return fb * eq.B_phi(r) + eq.rho_i(r) * eq.v_phi(r) * shift_freq(r)

        def C1fun(r):
            s = shift_freq(r)
            csum = eq.c_i(r) ** 2 + eq.vA_i(r) ** 2
            sf = s ** 2 if twisted_c1 else s
            # twisted solvers use Q * shift^2 (`Twisted_photospheric_flow_sausage.py:502`),
            # the density/flow solvers Q * shift (`Density_cylinder.py:589-590`).
            return (Qfun(r) * sf
                    - 2.0 * m * csum * (s ** 2 - cusp_freq(r) ** 2) * Tfun(r) / r ** 2)

        def C2fun(r):
            s2 = shift_freq(r) ** 2
            csum = eq.c_i(r) ** 2 + eq.vA_i(r) ** 2
            return s2 ** 2 - csum * (m ** 2 / r ** 2 + k ** 2) * (s2 - cusp_freq(r) ** 2)

        def C3diff(r):
            return (eq.B_phi(r) / r) ** 2 - eq.rho_i(r) * (eq.v_phi(r) / r) ** 2

        dC3diff = jax.grad(lambda r: jnp.reshape(C3diff(r), ()))

        def Afun(r):
            s2 = shift_freq(r) ** 2
            return eq.rho_i(r) * (s2 - alfven_freq(r) ** 2) + r * dC3diff(r)

        def Bfun(r):
            s2 = shift_freq(r) ** 2
            csum = eq.c_i(r) ** 2 + eq.vA_i(r) ** 2
            return (Qfun(r) ** 2
                    - 4.0 * csum * (s2 - cusp_freq(r) ** 2) * Tfun(r) ** 2 / r ** 2)

        def C3fun(r):
            return Dfun(r) * Afun(r) + Bfun(r)

        def Ffun(r):
            return r * Dfun(r) / C3fun(r)

        def invFfun(r):
            # 1/F = C3/(rD) = A/r + B/(rD): the A/r part is REGULAR through
            # the D-zeros (and B == 0 identically for the density/axial-flow
            # cases), so forming it this way keeps the flux-form rhs finite
            # everywhere except the genuine Alfven/cusp continua of the
            # twisted case (same regularisation as the slab rhs).
            return Afun(r) / r + Bfun(r) / (r * Dfun(r))

        rc1c3 = lambda r: r * C1fun(r) / C3fun(r)
        drc1c3 = jax.grad(lambda r: jnp.reshape(rc1c3(r), ()))

        def gfun(r):
            # `Density_cylinder.py:617-619`
            return (-drc1c3(r)
                    - r * (C2fun(r) - C1fun(r) ** 2 / C3fun(r)) / Dfun(r))

        def invF_g(r):
            # Fused hot-path form of (invFfun, gfun) for the interior RK4
            # stages: ONE evaluation of the coefficient chain feeds both
            # outputs, and the d(r C1/C3)/dr term rides a single forward-mode
            # jvp whose primal IS that shared evaluation (the unfused pair
            # costs two reverse-mode sweeps plus re-derived chains; XLA CSE
            # merges some but not the backward passes - measured on the
            # twisted engine, the dominant per-stage cost). Tangents of the
            # aux outputs are dead and DCE'd by XLA. Expressions are
            # identical to invFfun/gfun, so density/axial-flow results are
            # bit-identical (their C1/C3diff fold to zero either way).
            def full(rr):
                return rc1c3(rr), (Dfun(rr), C1fun(rr), C3fun(rr),
                                   Afun(rr), Bfun(rr), C2fun(rr))

            (rc, aux), (drc, _) = jax.jvp(full, (r,), (jnp.ones_like(r),))
            D, C1, C3, A, B, C2 = aux
            invF = A / r + B / (r * D)
            g = -drc - r * (C2 - C1 ** 2 / C3) / D
            return invF, g

        return Dfun, C1fun, C3fun, Ffun, gfun, invFfun, invF_g

    def exterior_m(self, omega, k):
        rg = self.eq.regime
        num = (k**2 * rg.vA_e**2 - omega**2) * (k**2 * rg.c_e**2 - omega**2)
        den = (rg.vA_e**2 + rg.c_e**2) * (k**2 * rg.cT_e**2 - omega**2)
        return num / den

    # -- dispersion function ---------------------------------------------------

    def make_dispersion(self, m: int | None = None, dtype=jnp.float64) -> Callable:
        """disp(omega, k[, m]) -> CylinderInterface for azimuthal order m
        (0 = sausage, 1 = kink). With m=None the azimuthal order is a TRACED
        third argument - one compiled program serves both mode families."""
        case, eq = self.case, self.eq
        gr = case.grid
        n_int = gr.n_interior
        n_ext = gr.n_exterior
        eps = gr.axis_epsilon
        twisted = case.twist_profile is not None
        complex_mode = case.complex_omega or twisted
        # twisted runs use complex odeintz in the reference even for real omega
        # (`Twisted_photospheric_flow_sausage.py:555-577`); real omega keeps the
        # result real in exact arithmetic, so we stay real unless omega is complex.
        cdtype = jnp.result_type(dtype, jnp.complex64) if case.complex_omega else dtype

        def disp(omega, k, m_arg):
            omega = jnp.asarray(omega, cdtype)
            k = jnp.asarray(k, dtype)
            mm = jnp.asarray(m_arg, dtype)   # azimuthal order, traced
            rg = eq.regime

            (Dfun, C1fun, C3fun, Ffun, gfun, invFfun,
             invF_g) = self.coefficients(omega, k, mm, twisted_c1=twisted)

            # ---- interior: two basis solutions, inward r: 1 -> eps ----------
            # Both bases ride ONE scan with a TUPLE state (P1, w1, P2, w2):
            # the coefficient chain invF/g (the expensive part - g carries
            # jax.grad-derived terms) is evaluated once per RK4 stage instead
            # of once per basis, halving the interior coefficient work
            # (VERDICT r02 weak #1). A tuple, not a stacked vector: under
            # vmap a stacked (batch, 4) carry turns every stage into strided
            # column slices + re-stacks (measured 4.7x SLOWER than two
            # scans on CPU); four separate (batch,) arrays keep each stage
            # purely elementwise.
            one = jnp.ones((), cdtype)
            zero = jnp.zeros((), cdtype)
            F1 = Ffun(jnp.asarray(1.0, dtype))
            #       u1: P(1)=1, P'(1)=0   |   u2: P(1)=0, P'(1)=1  (w = F P')
            u0 = (one, zero, zero, F1 * one)

            r1 = jnp.asarray(1.0, dtype)
            re_ = jnp.asarray(eps, dtype)
            state = _rk4_linear2(invF_g, u0, r1, re_, n_int,
                                 unroll=gr.scan_unroll)
            if not twisted and gr.axis_epsilon_final < eps:
                # log-spaced tail eps -> eps_final in t = ln r: the 1/r
                # coefficient terms are O(1) in t, so fixed steps stay
                # accurate arbitrarily close to the axis. Imposing the BC at
                # eps=1e-3 costs an O(eps^2) ~ 5e-6 eigenvalue bias (config
                # .GridConfig.axis_epsilon_final); at 1e-5 it is ~1e-10.
                # Twisted cases keep the reference's eps (axis cutoff is
                # physics there: v_phi ~ r^(p-1)).
                def coef_log(t):
                    # in t = ln r the linear system's coefficients are
                    # (r iF, r g) - same chain, same arithmetic as the
                    # previous rhs_log wrapper
                    r = jnp.exp(t)
                    iF, g = invF_g(r)
                    return (r * iF, r * g)

                state = _rk4_linear2(coef_log, state, jnp.log(re_),
                                     jnp.log(jnp.asarray(
                                         gr.axis_epsilon_final, dtype)),
                                     gr.n_axis_log, unroll=gr.scan_unroll)
            P1e, w1e, P2e, w2e = state
            u1 = (P1e, w1e)
            u2 = (P2e, w2e)

            # axis condition (reference BCs at r = 0.001):
            # m=0: P'(eps)=0 -> w(eps)=0 ; m>=1: P(eps)=0
            is_sausage = mm < 0.5
            a1 = jnp.where(is_sausage, u1[1], u1[0])
            a2 = jnp.where(is_sausage, u2[1], u2[0])

            # interface values at r=1 of each basis solution
            C1_1 = C1fun(r1)
            C3_1 = C3fun(r1)
            # xi_r = C1 P / C3 + w / r   (from xi_r = (C1 P + D P')/C3, w = F P',
            #  D/(F C3) = 1/r; reference `Density_cylinder.py:664`)
            xi1 = C1_1 * 1.0 / C3_1 + zero          # u1: P=1, w=0
            xi2 = F1 / 1.0                           # u2: P=0, w=F(1)

            # ---- exterior: decaying K_m solution ----------------------------
            m_e = self.exterior_m(omega, k)
            if gr.exterior_method == "bessel":
                # exact: P_e(r) = K_m(sqrt(m_e) r); logarithmic derivative at
                # r=1 (complex-capable, Re sqrt >= 0), replacing the
                # reference's numeric exterior integration
                # (`Density_cylinder.py:628-634`). Elementwise series + CF2
                # that XLA fuses into the surrounding dispersion program.
                sq = jnp.sqrt(m_e.astype(cdtype)) if case.complex_omega \
                    else jnp.sqrt(jnp.maximum(m_e, 1e-300))
                r0, r1_ = special.kve_ratio_both(sq)
                dP_e = sq * jnp.where(is_sausage, r0, r1_)
                P_e = jnp.ones_like(dP_e)
            else:
                # reference-parity: integrate inward from r_far with tiny ICs
                # (selects the K_m-growing-inward direction). Integration
                # runs in t = ln r, where the modified-Bessel operator loses
                # its first-derivative term:  d2P/dt2 = (m^2 + m_e e^{2t}) P.
                # A uniform grid in r CANNOT cover this domain at small k:
                # r_far = 3*2pi/k is ~1900 at k = 0.01, so h ~ 3.7 while
                # K_m(kappa r) varies on scale r ~ 1 near the interface -
                # the fixed-step integration was unresolved there and the
                # band-top kink zeros vanished from the determinant (the
                # PARITY r04/r05 k=0.01 miss cluster; the reference's
                # adaptive LSODA resolved it, `Density_cylinder.py:628-634`).
                # In t both regimes are resolved: near-interface variation
                # has scale dt ~ 1, the outer exponential scale
                # dt ~ 1/(kappa r_far) >> the step ln(r_far)/n_ext.
                r_far = gr.exterior_wavelengths * 2.0 * jnp.pi / k

                def rhs_ext_log(t, y):
                    P, Pdot = y[0], y[1]
                    r2 = jnp.exp(2.0 * t).astype(cdtype)
                    return jnp.stack([Pdot, (mm * mm + m_e * r2) * P])

                t_far = jnp.log(r_far).astype(dtype)
                # reference ICs [P, dP/dr] = [1e-8, -1e-8] at r_far;
                # dP/dt = r dP/dr
                y0 = jnp.stack([jnp.full((), 1e-8, cdtype),
                                (-1e-8 * r_far).astype(cdtype)])
                ye = rk4_final(rhs_ext_log, y0, t_far,
                               jnp.zeros((), dtype), n_ext,
                               unroll=gr.scan_unroll)
                P_e, dP_e = ye[0], ye[1]     # dP/dt(0) = dP/dr(1)
                dP_e = dP_e / P_e
                P_e = jnp.ones_like(P_e)
            xi_e = dP_e / (rg.rho_e * (omega ** 2 - k ** 2 * rg.vA_e ** 2))

            # ---- determinant -------------------------------------------------
            # Twisted-equilibrium jump term: the reference's kink shooting
            # objective is P_i(eps) + J xi_e(1) = 0 with J = B_phi(1)^2 -
            # rho_i(1) v_phi(1)^2 (`Twisted_photospheric_nonlinear_flow_kink_
            # fast.py:561,697`); the sausage objective omits it (`Twisted_
            # photospheric_flow_sausage.py:570`). J = 0 identically for the
            # density/axial-flow cases, so this is exact for all families.
            r1f = jnp.asarray(1.0, dtype)
            J = eq.B_phi(r1f) ** 2 - eq.rho_i(r1f) * eq.v_phi(r1f) ** 2
            J = jnp.where(is_sausage, jnp.zeros_like(J), J)

            m1 = xi1 * P_e - xi_e * 1.0    # u1: P_u(1)=1
            m2 = xi2 * P_e - xi_e * 0.0    # u2: P_u(1)=0
            det = a1 * m2 - a2 * m1 + J * xi_e * xi2

            # reference-style % mismatch of xi_r after pressure matching:
            # combination u = A u1 + B u2 with the (jump-corrected) axis
            # condition satisfied, scaled so P(1) = P_e(1) = 1
            # =>  A=1, B=-(a1 + J xi_e)/a2.
            B = -(a1 + J * xi_e) / a2
            xi_i = xi1 + B * xi2
            num = jnp.abs(xi_e - xi_i)
            den = jnp.maximum(jnp.abs(xi_e), jnp.abs(xi_i))
            mismatch = 100.0 * num / den

            if case.complex_omega:
                valid = m_e.real > 0
            else:
                valid = m_e > 0
            if not complex_mode:
                det = jnp.real(det)
            return CylinderInterface(det=det, mismatch_pct=mismatch, valid=valid)

        if m is None:
            return disp
        m_const = float(m)
        return lambda omega, k: disp(omega, k, m_const)

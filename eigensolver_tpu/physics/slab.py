"""Slab geometry dispersion function (vx formulation).

Physics replicated from the reference solvers (capability parity, new design):
- non-uniform density:   `Slab/Non uniform density/Photospheric/Solvers/
  multiprocessor_Inhomogeneous_method.py:307-525` (interior ODE
  vx'' = -(F'/F) vx' + m0 vx, parity BCs, total-pressure matching)
- uniform flow:          `Slab/Non uniform flow/Solver/flow_multiprocessor.py:465-483`
  (Doppler shift, xi = vx/Omega continuity across the flow jump)
- non-uniform flow:      `flow_multiprocessor_coronal.py:317-356`
  (shear terms D(x), coeff(x))
- complex KH:            `COMPLEX ANALYSIS/flow_multiprocessor_complex_coronal.py:
  368-403` (complex omega, extra pressure term add_P_Ti = -k U'/Omega)

Design deltas vs the reference (SURVEY.md section 7):
- The density-case interior is integrated in the self-adjoint "flux" form
  (F vx')' = F m0 vx with state (vx, w = F vx'), so no dF/F is ever formed -
  and total pressure is simply PT = w / Omega. This removes the per-(omega,k)
  sympy diff/lambdify of the reference entirely.
- Parity is imposed exactly at the centre (vx odd for sausage, even for kink)
  instead of the reference's fsolve shooting on the unknown boundary derivative;
  the zeros of the resulting 2x2 interface determinant coincide.
- The exterior solution is analytic (constant coefficients): vx_e ~
  exp(-sqrt(m_e)(x-1)), replacing the reference's 500-point LSODA integration
  from tiny initial conditions.
- Everything is closed-form JAX, jit once, vmap over the (omega, k) candidate
  batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax.numpy as jnp

from ..config import CaseConfig
from ..equilibrium import Equilibrium, make_equilibrium
from ..ode import rk4_final
from ..profiles import elementwise_grad


def _rk4_linear_flux(coef, y0, x0, x1, n_steps: int, unroll: int = 1):
    """Classical RK4 specialised to the LINEAR flux-form system
    d(vx, w)/dx = (w * invF, w_rate * vx) with a TUPLE state: the
    coefficient chain `coef(x) -> (invF, w_rate)` is evaluated at the 3
    distinct RK4 abscissae per step (k2/k3 share the midpoint chain) and
    the per-stage arithmetic is purely elementwise under vmap (a stacked
    (batch, 2) carry costs strided column slices per stage). Update
    arithmetic matches `ode.rk4_final` over `make_flux_rhs` exactly; the
    cylinder twin is `physics/cylinder._rk4_linear2`."""
    from jax import lax

    h = (x1 - x0) / n_steps

    def apply(c, y):
        invF, w_rate = c
        vx, w = y
        return (w * invF, w_rate * vx)

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


def _rk4_linear_shear(coef, y0, x0, x1, n_steps: int, unroll: int = 1):
    """`_rk4_linear_flux` twin for the shear form: state (vx, dvx) with
    d(vx, dvx)/dx = (dvx, -D dvx - coeff vx), chain `coef(x) -> (D, coeff)`
    at the 3 distinct RK4 abscissae per step. Arithmetic matches
    `ode.rk4_final` over `make_shear_rhs` exactly (complex state included -
    the KH path integrates the same form in complex omega)."""
    from jax import lax

    h = (x1 - x0) / n_steps

    def apply(c, y):
        Dx, coeff = c
        vx, dvx = y
        return (dvx, -Dx * dvx - coeff * vx)

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


class SlabInterface(NamedTuple):
    """Quantities at the matching boundary x = +1 for one (omega, k)."""

    det: jnp.ndarray          # dispersion determinant D(omega, k); roots = eigenvalues
    mismatch_pct: jnp.ndarray  # reference-style % total-pressure mismatch after
    #                            amplitude matching (acceptance metric, p_tol)
    valid: jnp.ndarray        # evanescent exterior etc. (m_e > 0)


def _sqrt_decay(m_e):
    """Branch of sqrt with Re >= 0, so exp(-sqrt(m_e) x) decays as x -> +inf.
    Matches the solution LSODA selects in the reference by integrating the
    growing direction from tiny ICs."""
    s = jnp.sqrt(m_e.astype(jnp.result_type(m_e, 1j)) if jnp.iscomplexobj(m_e) else m_e)
    return s


@dataclasses.dataclass(frozen=True)
class SlabPhysics:
    """Dispersion-function factory for all slab cases."""

    case: CaseConfig
    eq: Equilibrium

    @classmethod
    def from_case(cls, case: CaseConfig) -> "SlabPhysics":
        return cls(case=case, eq=make_equilibrium(case))

    # -- coefficient functions (closed-form, traced under jit) ---------------

    def exterior_m(self, omega, k):
        """m_e^2 coefficient of the exterior equation vx'' = m_e vx
        (`multiprocessor_Inhomogeneous_method.py:320`), Doppler-shifted when the
        exterior flows (`flow_multiprocessor.py:465`)."""
        rg = self.eq.regime
        Om = omega - k * rg.U_e
        num = (k**2 * rg.vA_e**2 - Om**2) * (k**2 * rg.c_e**2 - Om**2)
        den = (rg.vA_e**2 + rg.c_e**2) * (k**2 * rg.cT_e**2 - Om**2)
        return num / den

    def exterior_PT_coeff(self, omega, k):
        """p_e_const (`multiprocessor_Inhomogeneous_method.py:324`): PT_e =
        p_e_const * vx_e'."""
        rg = self.eq.regime
        Om = omega - k * rg.U_e
        return (
            rg.rho_e * (rg.vA_e**2 + rg.c_e**2)
            * (k**2 * rg.cT_e**2 - Om**2)
            / (Om * (k**2 * rg.c_e**2 - Om**2))
        )

    def interior_F(self, x, omega, k):
        """F(x) (`multiprocessor_Inhomogeneous_method.py:330-331`), with local
        Doppler shift for flow cases."""
        eq = self.eq
        Om = omega - k * eq.U_i(x)
        c2 = eq.c_i(x) ** 2
        a2 = eq.vA_i(x) ** 2
        cT2 = c2 * a2 / (c2 + a2)
        return eq.rho_i(x) * (c2 + a2) * (k**2 * cT2 - Om**2) / (k**2 * c2 - Om**2)

    def interior_m0(self, x, omega, k):
        """m0(x) (`multiprocessor_Inhomogeneous_method.py:336`)."""
        eq = self.eq
        Om = omega - k * eq.U_i(x)
        c2 = eq.c_i(x) ** 2
        a2 = eq.vA_i(x) ** 2
        cT2 = c2 * a2 / (c2 + a2)
        return (k**2 * c2 - Om**2) * (k**2 * a2 - Om**2) / ((c2 + a2) * (k**2 * cT2 - Om**2))

    # -- interior ODE right-hand sides (shared by the dispersion function and
    #    eigenfunction reconstruction - same forms, one definition) -----------

    @property
    def has_flow(self) -> bool:
        case = self.case
        return (case.regime.U_i0 != 0.0 or case.regime.U_e != 0.0
                or case.flow_profile.kind.value != "uniform")

    def make_flux_rhs(self, omega, k):
        """Self-adjoint flux form, state (vx, w = F vx') - density cases.

        The products are formed ANALYTICALLY, not as F and m0 separately:
        1/F and F*m0 = rho (k^2 vA^2 - Om^2) are regular at the sound point
        omega = k c_i(x*) where F and m0 individually blow up - evaluating
        them separately poisons RK4 stages near the resonance and loses the
        slow-body modes the reference finds there (its LSODA steps over the
        pole). Only the cusp continuum omega = k cT_i(x) stays genuinely
        singular, exactly as in the physics.
        """
        coef = self.make_flux_coef(omega, k)

        def rhs(x, y):
            vx, w = y[0], y[1]
            inv_F, w_rate = coef(x)
            return jnp.stack([w * inv_F, w_rate * vx])

        return rhs

    def make_flux_coef(self, omega, k):
        """Coefficient chain of the flux form: coef(x) -> (1/F, F m0)."""
        eq = self.eq

        def coef(x):
            Om = omega - k * eq.U_i(x)
            rho = eq.rho_i(x)
            c2 = eq.c_i(x) ** 2
            a2 = eq.vA_i(x) ** 2
            cT2 = c2 * a2 / (c2 + a2)
            inv_F = (k**2 * c2 - Om**2) / (
                rho * (c2 + a2) * (k**2 * cT2 - Om**2))
            w_rate = rho * (k**2 * a2 - Om**2)
            return inv_F, w_rate

        return coef

    def make_shear_rhs(self, omega, k):
        """Direct (vx, vx') form with the shear terms D(x), coeff(x) - the
        non-uniform-flow interior equation vx'' = -D vx' - coeff vx
        (`flow_multiprocessor_coronal.py:317-356`; corrected-D variant
        `flow_multiprocessor_complex_coronal.py:381-385`, selected by
        case.shear_D_legacy)."""
        coef = self.make_shear_coef(omega, k)

        def rhs(x, y):
            vx, dvx = y[0], y[1]
            Dx, coeff = coef(x)
            return jnp.stack([dvx, -Dx * dvx - coeff * vx])

        return rhs

    def make_shear_coef(self, omega, k):
        """Coefficient chain of the shear form: coef(x) -> (D(x), coeff(x))."""
        case, eq = self.case, self.eq
        dU = elementwise_grad(eq.U_i)
        ddU = elementwise_grad(dU)

        def coef(x):
            Om = omega - k * eq.U_i(x)
            rgl = eq.regime
            c2 = rgl.c_i0 ** 2
            a2 = rgl.vA_i0 ** 2
            cT2 = c2 * a2 / (c2 + a2)
            dUx = dU(x)
            ddUx = ddU(x)
            m0 = ((k**2 * c2 - Om**2) * (k**2 * a2 - Om**2)
                  / ((c2 + a2) * (k**2 * cT2 - Om**2)))
            if case.shear_D_legacy:
                # legacy shear coefficient, as shipped in the real
                # Gaussian-flow solver (`flow_multiprocessor_coronal.py:
                # 317-318`) - the form that generated the flow pickles
                Dx = (2.0 * k * dUx
                      * ((Om**2 - k**2 * cT2)
                         + (k**4 * cT2 * c2)
                         / ((c2 + a2) * (Om**2 - k**2 * cT2)))
                      / (Om * (Om**2 - k**2 * c2)))
            else:
                # corrected D(x) (`flow_multiprocessor_complex_coronal.py:
                # 381-385`, which supersedes the legacy form there)
                Dx = (2.0 * k * dUx
                      * (Om**2 / (Om**2 - k**2 * c2)
                         - (k**2 * cT2) / (Om**2 - k**2 * cT2)) / Om)
            coeff = (k * ddUx / Om) + (k * dUx * Dx / Om) - m0
            return Dx, coeff

        return coef

    # -- dispersion function -------------------------------------------------

    def make_dispersion(self, parity: int | None = None, dtype=jnp.float64,
                        include_shear_pressure: bool | None = None) -> Callable:
        """Return disp(omega, k[, parity]) -> SlabInterface.

        parity: 0 = sausage (vx odd), 1 = kink (vx even) - reference BCs at
        `multiprocessor_Inhomogeneous_method.py:380-385` (sausage) / `:618-623`
        (kink), re-expressed as exact centre conditions. When parity is None
        the returned function takes it as a TRACED third argument, so one
        compiled program serves both mode families (halves compile count and
        lets a sweep fuse sausage+kink into a single device batch).

        include_shear_pressure: add the -k U'/Omega correction to interior PT
        (`flow_multiprocessor_complex_coronal.py:401-403`). Defaults to True
        only for complex-omega cases, mirroring the reference's per-file choice
        (the real Gaussian-flow solver omits it, `flow_multiprocessor_coronal.py:356`).
        """
        case, eq = self.case, self.eq
        n_steps = case.grid.n_interior
        has_flow = self.has_flow
        if include_shear_pressure is None:
            include_shear_pressure = case.complex_omega

        dU = elementwise_grad(eq.U_i)

        cdtype = jnp.result_type(dtype, jnp.complex64) if case.complex_omega else dtype

        def disp(omega, k, parity_arg):
            omega = jnp.asarray(omega, cdtype)
            k = jnp.asarray(k, dtype)
            par = jnp.asarray(parity_arg, dtype)   # 0 = sausage, 1 = kink

            m_e = self.exterior_m(omega, k)
            p_e = self.exterior_PT_coeff(omega, k)
            sqm = jnp.sqrt(m_e.astype(cdtype)) if case.complex_omega else jnp.sqrt(
                jnp.maximum(m_e, 0.0))

            if not has_flow:
                # --- self-adjoint flux form: state (vx, w = F vx') ----------
                # TUPLE state + 3-abscissa linear stepper (same rewrite as
                # the cylinder interior, `physics/cylinder._rk4_linear2`):
                # under vmap a stacked (batch, 2) carry turns every RK4
                # stage into strided column slices, and the coefficient
                # chain ran once per stage instead of once per abscissa
                # (k2/k3 share the midpoint). Arithmetic is unchanged.
                coef = self.make_flux_coef(omega, k)
                F0 = self.interior_F(jnp.asarray(0.0, dtype), omega, k)
                # sausage (par=0): vx odd => y0 = (0, F0); kink: (1, 0)
                y0 = (par * jnp.ones_like(F0), (1.0 - par) * F0)

                yb = _rk4_linear_flux(coef, y0, jnp.asarray(0.0, dtype),
                                      jnp.asarray(1.0, dtype), n_steps,
                                      unroll=case.grid.scan_unroll)
                vx_b, w_b = yb[0], yb[1]
                Om_i = omega - k * eq.U_i(jnp.asarray(1.0, dtype))
                PT_i = w_b / Om_i          # PT = F vx' / Omega = w / Omega
            else:
                # --- direct (vx, vx') form with shear terms -----------------
                # tuple carry + 3-abscissa stepper, as in the flux branch
                # (the shear chain carries dU/ddU jax.grad terms per eval -
                # the k2/k3 midpoint share cuts it from 4 to 3 per step)
                coef = self.make_shear_coef(omega, k)
                parc = par.astype(cdtype)
                y0 = (parc, 1.0 - parc)
                yb = _rk4_linear_shear(coef, y0, jnp.asarray(0.0, dtype),
                                       jnp.asarray(1.0, dtype), n_steps,
                                       unroll=case.grid.scan_unroll)
                vx_b, dvx_b = yb[0], yb[1]
                x1 = jnp.asarray(1.0, dtype)
                Om_i = omega - k * eq.U_i(x1)
                F1 = self.interior_F(x1, omega, k)
                PT_i = (F1 / Om_i) * dvx_b
                if include_shear_pressure:
                    add = -(k * dU(x1)) / Om_i
                    PT_i = (F1 / Om_i) * (dvx_b - add * vx_b)

            # Exterior (x > 1)
            Om_e = omega - k * eq.regime.U_e
            if case.grid.exterior_method == "numeric":
                # reference-parity: integrate from x = 1 + W*2pi/k toward the
                # boundary with tiny ICs (`multiprocessor_Inhomogeneous_method
                # .py:364-371`, mirrored to our x > 1 side). Near the external
                # cutoffs (m_e -> 0) this carries an O(e^{-2 sqrt(m_e) L})
                # admixture of the non-decaying solution - the reference's
                # finite-domain physics, reproduced for pickle parity.
                from ..ode import rk4_final_renorm
                L = case.grid.exterior_wavelengths * 2.0 * jnp.pi / k

                def rhs_e(x, y):
                    return jnp.stack([y[1], m_e * y[0]])

                y0e = jnp.stack([jnp.asarray(1e-8, cdtype),
                                 jnp.asarray(-1e-15, cdtype)])
                ye, _ = rk4_final_renorm(rhs_e, y0e, (1.0 + L).astype(dtype),
                                         jnp.asarray(1.0, dtype),
                                         case.grid.n_exterior)
                dvx_over_vx = ye[1] / ye[0]
                PT_e = p_e * dvx_over_vx
            else:
                # exact decaying solution: vx_e = exp(-sqm (x-1))
                PT_e = p_e * (-sqm)
            xi_e = 1.0 / Om_e
            xi_i = vx_b / Om_i

            det = xi_i * PT_e - xi_e * PT_i

            # Reference-style acceptance metric: scale interior so xi matches,
            # then % mismatch of PT (`multiprocessor_Inhomogeneous_method.py:503`).
            s = xi_e / xi_i
            num = jnp.abs(PT_e - s * PT_i)
            den = jnp.maximum(jnp.abs(PT_e), jnp.abs(s * PT_i))
            mismatch = 100.0 * num / den

            if case.complex_omega:
                valid = m_e.real > 0
            else:
                valid = m_e > 0
            return SlabInterface(det=det, mismatch_pct=mismatch, valid=valid)

        if parity is None:
            return disp
        p_const = float(parity)
        return lambda omega, k: disp(omega, k, p_const)

"""Fixed-step ODE integration under `lax.scan`.

Replaces the reference's adaptive `scipy.integrate.odeint` (LSODA) and its
complex-view wrapper `odeintz` (`Twisted_photospheric_flow_sausage.py:67-96`).
Fixed step count => static shapes => `vmap`-able over 10^4..10^6 simultaneous
(omega, k) candidates, which is where all the device throughput comes from
(SURVEY.md section 7, design delta 2). Complex state is supported natively by
XLA (complex64/128) - no float-view trick needed.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

# rhs(x, y) -> dy/dx, with y any pytree (typically a length-2 state vector).
RHS = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def rk4_final(rhs: RHS, y0, x0, x1, n_steps: int, unroll: int = 1):
    """Integrate dy/dx = rhs(x, y) from x0 to x1 with `n_steps` classical RK4
    steps; return y(x1). x0/x1 may be traced scalars (per-candidate domains,
    e.g. the exterior extent 3*2*pi/k of `Density_cylinder.py:552`).

    unroll: forwarded to `lax.scan` - unrolling several RK4 steps per loop
    iteration lets XLA fuse across step boundaries and amortise the fixed
    cost each loop iteration pays on the device."""
    h = (x1 - x0) / n_steps

    def step(carry, i):
        y = carry
        x = x0 + i * h
        k1 = rhs(x, y)
        k2 = rhs(x + 0.5 * h, jax.tree.map(lambda a, b: a + 0.5 * h * b, y, k1))
        k3 = rhs(x + 0.5 * h, jax.tree.map(lambda a, b: a + 0.5 * h * b, y, k2))
        k4 = rhs(x + h, jax.tree.map(lambda a, b: a + h * b, y, k3))
        y_next = jax.tree.map(
            lambda a, b1, b2, b3, b4: a + (h / 6.0) * (b1 + 2 * b2 + 2 * b3 + b4),
            y, k1, k2, k3, k4,
        )
        return y_next, None

    yf, _ = lax.scan(step, y0, jnp.arange(n_steps), unroll=unroll)
    return yf


def rk4_trajectory(rhs: RHS, y0, x0, x1, n_steps: int):
    """Like `rk4_final` but also return the full trajectory (n_steps+1 states),
    used for eigenfunction reconstruction (analysis layer)."""
    h = (x1 - x0) / n_steps

    def step(carry, i):
        y = carry
        x = x0 + i * h
        k1 = rhs(x, y)
        k2 = rhs(x + 0.5 * h, jax.tree.map(lambda a, b: a + 0.5 * h * b, y, k1))
        k3 = rhs(x + 0.5 * h, jax.tree.map(lambda a, b: a + 0.5 * h * b, y, k2))
        k4 = rhs(x + h, jax.tree.map(lambda a, b: a + h * b, y, k3))
        y_next = jax.tree.map(
            lambda a, b1, b2, b3, b4: a + (h / 6.0) * (b1 + 2 * b2 + 2 * b3 + b4),
            y, k1, k2, k3, k4,
        )
        return y_next, y_next

    yf, ys = lax.scan(step, y0, jnp.arange(n_steps))
    full = jax.tree.map(
        lambda first, rest: jnp.concatenate([first[None], rest], axis=0), y0, ys
    )
    return yf, full


def rk4_final_renorm(rhs: RHS, y0, x0, x1, n_steps: int, every: int = 64):
    """RK4 with periodic renormalisation of the (linear, homogeneous) state to
    unit max-norm, accumulating log-scale. Prevents overflow when integrating
    growing exponentials over long exterior domains (the reference relies on
    float64 headroom + tiny 1e-8 ICs instead, `multiprocessor_Inhomogeneous_method.py:364-371`).

    Returns (y_final, log_scale) with the true solution y * exp(log_scale).
    Only valid for linear homogeneous systems where overall scale is irrelevant
    to root positions (all our dispersion determinants are scale-invariant).
    """
    h = (x1 - x0) / n_steps

    def step(carry, i):
        y, logs = carry
        x = x0 + i * h
        k1 = rhs(x, y)
        k2 = rhs(x + 0.5 * h, y + 0.5 * h * k1)
        k3 = rhs(x + 0.5 * h, y + 0.5 * h * k2)
        k4 = rhs(x + h, y + h * k3)
        y_next = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

        def renorm(args):
            yv, lg = args
            scale = jnp.max(jnp.abs(yv))
            scale = jnp.where(scale > 0, scale, 1.0)
            return yv / scale, lg + jnp.log(scale)

        y_next, logs = lax.cond(
            (i + 1) % every == 0, renorm, lambda a: a, (y_next, logs)
        )
        return (y_next, logs), None

    real_dtype = jnp.zeros((), dtype=jnp.asarray(y0).dtype).real.dtype
    logs0 = jnp.zeros((), dtype=real_dtype)
    (yf, logs), _ = lax.scan(step, (y0, logs0), jnp.arange(n_steps))
    return yf, logs

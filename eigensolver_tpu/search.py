"""Massively batched root search over the (omega, k) plane.

Replaces the reference's L2 layer - one OS process per (k, speed-band) cell with
recursive omega-bisection inside (`multiprocessor_Inhomogeneous_method.py:
307-414,777-835`; 1800 concurrent processes for the cylinder sweep,
`Density_cylinder.py:1126-1153`) - with three shape-static, vmapped stages:

1. ladder scan:   evaluate D(omega, k) on dense omega ladders for every
                  (k, band) cell at once (one big batch, scan dtype);
2. bracketing:    detect sign changes in-array, keep a fixed budget of
                  brackets per cell (top-K selection, no dynamic shapes);
3. polish:        vectorised bisection (fixed iteration count, polish dtype)
                  on all brackets simultaneously, then acceptance filtering by
                  the reference-style residual tolerance.

dtype split: the broad scan runs in `scan_dtype` (float32 for speed), the
polish in `polish_dtype` (float64, on a ~100x smaller batch), delivering
1e-6-relative eigenvalues at float32 scan cost.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class BracketBatch(NamedTuple):
    lo: jnp.ndarray        # (B,) lower omega of bracket
    hi: jnp.ndarray        # (B,) upper omega
    k: jnp.ndarray         # (B,) wavenumber of the cell
    mask: jnp.ndarray      # (B,) bool - real bracket vs padding
    mode: Optional[jnp.ndarray] = None  # (B,) mode id when fused sweeps
    n_in_row: Optional[jnp.ndarray] = None  # (rows,) sign changes found per row
    #   (before the top-K budget cut - saturation diagnostic)


class PolishResult(NamedTuple):
    omega: jnp.ndarray     # (B,) converged root candidates
    k: jnp.ndarray
    mismatch: jnp.ndarray  # (B,) reference-style % residual at the root
    mask: jnp.ndarray      # (B,) bracket validity (pre-acceptance)
    mode: Optional[jnp.ndarray] = None
    # (B,) bool: entry is a reference-parity FUZZ (acceptance-swath) record,
    # not a polished root - it must stay AT the reference's scan seed, so
    # f64 refinement skips it (a swath point bisected to the nearest f64
    # zero would drift off the seed the reference recorded). None = all
    # polished.
    fuzz: Optional[jnp.ndarray] = None


def _call_disp(disp_batch, omega, k, mode):
    return disp_batch(omega, k) if mode is None else disp_batch(omega, k, mode)


def ladder_scan(disp_batch: Callable, omegas: jnp.ndarray, ks: jnp.ndarray,
                modes: Optional[jnp.ndarray] = None):
    """Evaluate the dispersion function on a (rows, n_omega) ladder grid.

    disp_batch: vmapped disp over flat (omega, k[, mode]) -> .det/.valid/...
    omegas: (rows, n_omega); ks: (rows,); modes: optional (rows,) traced mode
    column (sausage/kink fused into one batch - one compile, one dispatch).
    Returns (det, valid, mismatch) as (rows, n_omega) arrays.
    """
    rows, n_omega = omegas.shape
    flat_om = omegas.reshape(-1)
    flat_k = jnp.repeat(ks, n_omega)
    flat_m = None if modes is None else jnp.repeat(modes, n_omega)
    res = _call_disp(disp_batch, flat_om, flat_k, flat_m)
    det = res.det.reshape(rows, n_omega)
    valid = res.valid.reshape(rows, n_omega)
    mism = res.mismatch_pct.reshape(rows, n_omega)
    return det, valid, mism


def find_brackets(omegas: jnp.ndarray, ks: jnp.ndarray, det: jnp.ndarray,
                  valid: jnp.ndarray, max_per_row: int,
                  modes: Optional[jnp.ndarray] = None,
                  pole_det_factor: Optional[float] = None,
                  mism: Optional[jnp.ndarray] = None) -> BracketBatch:
    """Select up to `max_per_row` sign-change brackets per ladder row.

    pole_det_factor: when set, drop sign changes whose SMALLER endpoint |det|
    exceeds `pole_det_factor` x the row's median finite |det| - at a pole
    crossing both endpoints are huge relative to the row, while at a root at
    least one endpoint is small. This spends no polish budget on obvious pole
    crossings; final arbitration remains the residual-acceptance filter in
    `polish`. None disables the bound (every sign change is a candidate).

    mism: optional (rows, n_omega) reference-style residual %. When given,
    a saturated row keeps the `max_per_row` brackets with the SMALLEST
    endpoint residual instead of the lowest-omega ones - continuum/pole
    crossings carry large residuals while genuine roots sit at dips, so
    the budget goes to likely eigenvalues rather than to whichever sign
    changes happen to come first in the ladder (the failure mode behind
    the r02 cyl_flow_1 band-top misses; see PARITY_r02).
    """
    finite = jnp.isfinite(det)
    ok = valid & finite
    neg = jnp.signbit(det)
    is_br = (neg[:, :-1] != neg[:, 1:]) & ok[:, :-1] & ok[:, 1:]
    if pole_det_factor is not None:
        absd = jnp.abs(det)
        med = jnp.nanmedian(jnp.where(ok, absd, jnp.nan), axis=1,
                            keepdims=True)
        lo_mag = jnp.minimum(absd[:, :-1], absd[:, 1:])
        is_br = is_br & (lo_mag <= pole_det_factor * med)
    n_in_row = jnp.sum(is_br, axis=1)
    # Top-K selection instead of a full-row argsort: TopK with
    # k = max_per_row is a partial reduction, where a variadic sort of the
    # (rows, n_omega) float key orders every column. XLA TopK breaks ties
    # toward lower indices, matching a stable argsort order.
    # lax.top_k requires k <= the last-axis size (n_omega - 1 candidate
    # brackets per row): clamp rather than fail at trace time when a caller
    # pairs a short ladder with a large bracket budget (ADVICE r04 #3).
    max_per_row = min(max_per_row, is_br.shape[1])
    if mism is not None:
        big = jnp.where(jnp.isfinite(mism), mism, jnp.inf)
        score = jnp.minimum(big[:, :-1], big[:, 1:])
        # clamp genuine brackets to a large FINITE score so a bracket whose
        # both endpoint residuals are non-finite still outranks every
        # non-bracket column (which carry inf), instead of tying with them
        score = jnp.where(is_br, jnp.minimum(score, 1e30), jnp.inf)
        _, order = jax.lax.top_k(-score, max_per_row)
    else:
        _, order = jax.lax.top_k(is_br.astype(jnp.int32), max_per_row)
    rows = jnp.arange(omegas.shape[0])[:, None]
    lo = omegas[rows, order]
    hi = omegas[rows, order + 1]
    mask = is_br[rows, order]
    kcol = jnp.broadcast_to(ks[:, None], lo.shape)
    mcol = (None if modes is None
            else jnp.broadcast_to(modes[:, None], lo.shape).reshape(-1))
    return BracketBatch(lo=lo.reshape(-1), hi=hi.reshape(-1),
                        k=kcol.reshape(-1), mask=mask.reshape(-1), mode=mcol,
                        n_in_row=n_in_row)


def bisect(disp_batch: Callable, br: BracketBatch, n_iter: int,
           dtype=jnp.float64) -> PolishResult:
    """Vectorised bisection on all brackets at once (fixed iteration count,
    replaces the reference's depth<=100 recursive `locate_*`,
    `multiprocessor_Inhomogeneous_method.py:312-414`).

    The dispersion is traced at ONE site, inside the loop: step 0
    evaluates the bracket's lower end, steps 1..n_iter the midpoints, and
    step n_iter+1 the converged root (its residual). Each traced copy of the
    dispersion is a whole RK4 scan, and the program's compile time grows
    with the number of copies."""
    lo = br.lo.astype(dtype)
    hi = br.hi.astype(dtype)
    k = br.k.astype(dtype)
    md = br.mode
    mism = jax.eval_shape(lambda: _call_disp(disp_batch, lo, k, md).mismatch_pct)

    def body(i, carry):
        lo, hi, lo_neg, _ = carry
        mid = 0.5 * (lo + hi)
        res = _call_disp(disp_batch, jnp.where(i == 0, lo, mid), k, md)
        neg = jnp.signbit(res.det)
        lo_neg = jnp.where(i == 0, neg, lo_neg)
        step = (i > 0) & (i <= n_iter)
        go_right = neg == lo_neg            # root in [mid, hi]
        lo = jnp.where(step & go_right, mid, lo)
        hi = jnp.where(step & ~go_right, mid, hi)
        return lo, hi, lo_neg, res.mismatch_pct

    lo, hi, _, mismatch = jax.lax.fori_loop(
        0, n_iter + 2, body,
        (lo, hi, jnp.zeros(lo.shape, bool), jnp.zeros(mism.shape, mism.dtype)))
    return PolishResult(omega=0.5 * (lo + hi), k=k, mismatch=mismatch,
                        mask=br.mask, mode=md)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    n_omega: int = 256
    max_brackets_per_row: int = 8
    n_bisect: int = 60
    # residual % at the converged root (pole filter). f32 bracket-noise
    # budget (ADVICE r04 #4): for m >= 1 the inward cylinder integration is
    # dominated by the irregular ~r^-m component (~100x amplification over
    # the eps=1e-3..1e-5 axis tail), costing ~2 of the 7 f32 digits; near
    # continuum bands the f32 determinant can therefore carry spurious
    # sign changes whose bisected "roots" pass percent-level acceptance.
    # Production flows neutralise this downstream: refine_roots_f64's
    # bracketed mask drops candidates the f64 dispersion never brackets,
    # and acceptance can be re-judged at the f64 zero (accept_pct_refined).
    # Un-refined f32 sweeps should treat accepted roots within continuum
    # bands as provisional.
    accept_pct: float = 1.0
    # When f64 refinement runs (run_case refine_f64), acceptance can be
    # re-judged at the refined root in f64 with this threshold; the scan-stage
    # accept_pct is then typically loosened. Needle-sharp quasi-resonances
    # (e.g. slab-flow backward slow modes near the Doppler cusp edge, whose
    # residual climbs to ~100% within 1e-4 relative of the zero) are
    # unreachable by an f32 polish filter but trivially accepted at their f64
    # zero. None = keep the scan-stage decision.
    accept_pct_refined: Optional[float] = None
    scan_dtype: str = "float64"
    polish_dtype: str = "float64"
    # Reference-parity acceptance: additionally record scan points whose
    # residual is below this percentage, as the reference does
    # (`multiprocessor_Inhomogeneous_method.py:503-508` accepts any scanned
    # omega with <p_tol% pressure mismatch - in continuum bands this yields
    # acceptance swaths rather than discrete roots). None disables.
    fuzz_accept_pct: Optional[float] = None
    # Evaluate fuzz acceptance only on every `fuzz_stride`-th ladder point.
    # The reference records swath entries AT its own scan seeds, so parity
    # needs the fuzz grid to be the reference's seed grid while the bracket
    # search keeps the full-resolution ladder: with uniform ladders and
    # n_omega = stride*(N_ref - 1) + 1, the strided subsample falls on the
    # reference's N_ref-point linspace over the band UP TO the ladder's
    # edge_shrink offset (build_ladders shrinks each band edge by 1e-3 of the
    # band width to dodge characteristic-speed singularities, so strided
    # points sit within ~1e-3 of band width from the exact reference seeds -
    # inside the percent-level acceptance tolerances this mode emulates).
    fuzz_stride: int = 1
    # Restrict fuzz acceptance to |phase speed| ranges the reference actually
    # scanned: tuple of (lo, hi) bounds on |omega/k|. Guard band edges our
    # ladder needs (e.g. around v = 0) can otherwise record swath entries in
    # bands the reference never seeded. None = fuzz everywhere.
    fuzz_v_ranges: Optional[tuple] = None
    # Pole pre-filter for the bracket stage (see find_brackets); None = off.
    pole_det_factor: Optional[float] = None
    # SIGNED phase-speed ranges (lo, hi) where bracket formation is masked:
    # inside genuine continua (Doppler Alfven/cusp, shear critical layer) the
    # discretized operator has a dense resolution-dependent point spectrum -
    # its sign changes are not converged eigenvalues but they exhaust the
    # per-row bracket budget and crowd out real modes above the band edge
    # (measured on cyl_flow_1: ~115 in-band crossings per row vs the budget
    # of 24, hiding the confirmed discrete mode at v = 0.9505). Fuzz (swath
    # parity) acceptance is NOT masked. Typically filled from
    # `equilibrium.genuine_continua(case)`. None = no masking.
    exclude_v_ranges: Optional[tuple] = None
    # Row-local OMEGA-range masking for (k, m)-dependent continua (the
    # rotational-flow family, whose Doppler Alfven/cusp ranges involve
    # m v_phi(r)/r): a jit-traceable fn(k, m) -> (lo, hi) arrays of shape
    # (n_bands,); bracket formation is masked for omega in any [lo_j, hi_j].
    # Typically `equilibrium.genuine_continua_rowfn(case)`. None = off.
    exclude_omega_rowfn: Optional[Callable] = None


_PIPELINE_CACHE: dict = {}


def _search_pipeline(disp_batch_scan: Callable, disp_batch_polish: Callable,
                     cfg: SearchConfig) -> Callable:
    """One fused jit for scan -> bracket -> bisect -> accept. Compiling the
    whole pipeline as a unit (instead of eager fori_loops re-tracing per call)
    cuts per-sweep compile count to one per (mode, shape bucket)."""
    key = (id(disp_batch_scan), id(disp_batch_polish), cfg)
    fn = _PIPELINE_CACHE.get(key)
    if fn is not None:
        return fn

    polish_dt = jnp.dtype(cfg.polish_dtype)

    @jax.jit
    def pipeline(omegas, ks, modes):
        det, valid, mism = ladder_scan(disp_batch_scan, omegas, ks, modes)
        det_br = det
        if cfg.exclude_v_ranges:
            v = omegas / ks[:, None]
            excl = jnp.zeros(det.shape, bool)
            for lo_v, hi_v, *_ in cfg.exclude_v_ranges:
                excl = excl | ((v > lo_v) & (v < hi_v))
            det_br = jnp.where(excl, jnp.nan, det_br)
        if cfg.exclude_omega_rowfn is not None:
            md = (jnp.ones_like(ks) if modes is None else modes)
            lo_b, hi_b = jax.vmap(cfg.exclude_omega_rowfn)(ks, md)
            in_band = ((omegas[:, :, None] > lo_b[:, None, :])
                       & (omegas[:, :, None] < hi_b[:, None, :])).any(-1)
            det_br = jnp.where(in_band, jnp.nan, det_br)
        br = find_brackets(omegas, ks, det_br, valid,
                           cfg.max_brackets_per_row,
                           modes, pole_det_factor=cfg.pole_det_factor,
                           mism=mism)
        n_saturated = jnp.sum(br.n_in_row > cfg.max_brackets_per_row)
        pr = bisect(disp_batch_polish, br, cfg.n_bisect, dtype=polish_dt)
        accepted = (pr.mask & jnp.isfinite(pr.mismatch)
                    & (pr.mismatch < cfg.accept_pct))
        pr = pr._replace(mask=accepted,
                         fuzz=jnp.zeros_like(accepted))
        if cfg.fuzz_accept_pct is None:
            return pr, None, n_saturated
        # reference-parity swath acceptance: keep local minima of the
        # residual among scan points passing the tolerance, PLUS the first
        # point of each under-tolerance run - the reference breaks out of the
        # band on its first acceptance (`multiprocessor_Inhomogeneous_method
        # .py:503-508` break; `Cylinder_method_flow_testing.py` kink loop), so
        # band-edge seeds at characteristic speeds (e.g. v = c_kink) become
        # recorded roots even though the residual still decreases beyond them.
        sub = slice(None, None, cfg.fuzz_stride)
        om_f, mism_f, valid_f = omegas[:, sub], mism[:, sub], valid[:, sub]
        acc = valid_f & jnp.isfinite(mism_f) & (mism_f < cfg.fuzz_accept_pct)
        big = jnp.where(jnp.isfinite(mism_f), mism_f, jnp.inf)
        left = jnp.concatenate([jnp.full_like(big[:, :1], jnp.inf),
                                big[:, :-1]], axis=1)
        right = jnp.concatenate([big[:, 1:],
                                 jnp.full_like(big[:, :1], jnp.inf)], axis=1)
        acc_left = jnp.concatenate(
            [jnp.zeros_like(acc[:, :1]), acc[:, :-1]], axis=1)
        keep = acc & ((big <= left) & (big <= right) | ~acc_left)
        if cfg.fuzz_v_ranges is not None:
            v = jnp.abs(om_f) / jnp.abs(ks)[:, None]
            in_rng = jnp.zeros_like(keep)
            for lo_v, hi_v in cfg.fuzz_v_ranges:
                in_rng = in_rng | ((v >= lo_v) & (v <= hi_v))
            keep = keep & in_rng
        n_fuzz = om_f.shape[1]
        fuzz = PolishResult(
            omega=om_f.reshape(-1),
            k=jnp.repeat(ks, n_fuzz),
            mismatch=mism_f.reshape(-1),
            mask=keep.reshape(-1),
            mode=None if modes is None else jnp.repeat(modes, n_fuzz),
            fuzz=jnp.ones(om_f.size, bool))
        return pr, fuzz, n_saturated

    _PIPELINE_CACHE[key] = pipeline
    return pipeline


def pad_rows(omegas, ks, modes, row_bucket: int):
    """Pad the row axis to a multiple of `row_bucket` with NaN ladders, which
    produce no brackets, so the fused pipeline compiles once per bucket."""
    pad = (-omegas.shape[0]) % row_bucket
    if pad:
        omegas = jnp.concatenate(
            [omegas, jnp.full((pad, omegas.shape[1]), jnp.nan, omegas.dtype)])
        ks = jnp.concatenate([ks, jnp.ones((pad,), ks.dtype)])
        if modes is not None:
            modes = jnp.concatenate([modes, jnp.zeros((pad,), modes.dtype)])
    return omegas, ks, modes


def search_rows(disp_batch_scan: Callable, disp_batch_polish: Callable,
                omegas: jnp.ndarray, ks: jnp.ndarray,
                cfg: SearchConfig, row_bucket: int = 128,
                modes: Optional[jnp.ndarray] = None) -> PolishResult:
    """Full scan->bracket->polish pipeline for one ladder batch, in one
    device dispatch.

    omegas: (rows, n_omega) ladders; ks: (rows,); modes: optional (rows,)
    traced mode column (fused sausage+kink sweep).
    Rows are padded to a multiple of `row_bucket` (invalid NaN ladders) so the
    fused pipeline compiles once per bucket size rather than per exact row
    count. Returns a PolishResult whose mask already includes acceptance
    filtering (padding rows produce no brackets - their dets are NaN).

    The dispatch's scratch is proportional to the batch area: 156 MiB of
    device memory for the largest recorded sweep (1792 rows x 1519 omega,
    cylinder flow; compiled.memory_analysis() on an H100), so a whole sweep
    goes to the device at once.
    """
    rows = omegas.shape[0]
    n_omega = omegas.shape[1]
    omegas, ks, modes = pad_rows(omegas, ks, modes, row_bucket)
    pipeline = _search_pipeline(disp_batch_scan, disp_batch_polish, cfg)
    pr, fuzz, n_saturated = pipeline(omegas, ks, modes)
    n_sat = int(n_saturated)
    if n_sat:
        import warnings
        warnings.warn(
            f"{n_sat} ladder rows found more sign changes than "
            f"max_brackets_per_row={cfg.max_brackets_per_row}; only the "
            f"{cfg.max_brackets_per_row} smallest-residual brackets per row "
            f"were polished - raise max_brackets_per_row (or mask continua "
            f"via exclude_v_ranges/exclude_omega_rowfn) if dense bands "
            f"matter", stacklevel=2)
    keep = rows * cfg.max_brackets_per_row

    def cut(x, n):
        return None if x is None else x[:n]

    pr = PolishResult(omega=pr.omega[:keep], k=pr.k[:keep],
                      mismatch=pr.mismatch[:keep], mask=pr.mask[:keep],
                      mode=cut(pr.mode, keep), fuzz=cut(pr.fuzz, keep))
    if fuzz is None:
        return pr
    n_fuzz = -(-n_omega // cfg.fuzz_stride)   # ceil: strided subsample width
    kf = rows * n_fuzz

    def cat(a, b, n):
        if a is None or b is None:
            return None
        return jnp.concatenate([a, b[:n]])

    return PolishResult(
        omega=jnp.concatenate([pr.omega, fuzz.omega[:kf]]),
        k=jnp.concatenate([pr.k, fuzz.k[:kf]]),
        mismatch=jnp.concatenate([pr.mismatch, fuzz.mismatch[:kf]]),
        mask=jnp.concatenate([pr.mask, fuzz.mask[:kf]]),
        mode=cat(pr.mode, fuzz.mode, kf),
        fuzz=cat(pr.fuzz, fuzz.fuzz, kf))


def collect(pr: PolishResult, with_fuzz: bool = False):
    """Device->host gather of accepted roots: (omega, k, mismatch[, mode]
    [, fuzz_flag]).

    All result leaves are packed into ONE device array and fetched with a
    single transfer: each separate `np.asarray(device_array)` is its own
    host<->device round-trip, so six per-leaf fetches would pay six.
    """
    leaves = [pr.omega, pr.k, pr.mismatch, pr.mask]
    if pr.mode is not None:
        leaves.append(pr.mode)
    if pr.fuzz is not None:
        leaves.append(pr.fuzz)
    if all(isinstance(x, jax.Array) for x in leaves):
        dt = jnp.result_type(pr.omega.dtype, pr.k.dtype, pr.mismatch.dtype)
        packed = np.asarray(jnp.stack([x.astype(dt) for x in leaves]))
        host = list(packed)
    else:
        host = [np.asarray(x) for x in leaves]
    om, kk, mm = host[0], host[1], host[2]
    mask = host[3].astype(bool)
    i = 4
    md = None
    if pr.mode is not None:
        md = host[i]
        i += 1
    fz = host[i].astype(bool) if pr.fuzz is not None else None
    out = (om[mask], kk[mask], mm[mask])
    if md is not None:
        out = out + (md[mask],)
    if with_fuzz:
        out = out + ((np.zeros(int(mask.sum()), bool) if fz is None
                      else fz[mask]),)
    return out


def refine_roots_f64(disp64: Callable, omegas: np.ndarray, ks: np.ndarray,
                     modes: np.ndarray, n_iter: int = 30,
                     rel_halfwidth: float = 4e-7):
    """Float64 re-bisection of f32-converged roots on the default device.

    The broad scan+polish run in f32; the accepted roots (a ~1000x smaller
    set) are then re-bracketed within +-rel_halfwidth and bisected in f64 to
    reach the 1e-7-relative target (BASELINE.md accuracy row). Needs
    jax_enable_x64 (without it the f64 buffers are silently f32).

    disp64: the f64 dispersion vmapped over flat (omega, k, mode), as
    `sweep.make_dispersion_moded` caches it per case - every mode family
    refines in one program, compiled once per root-count bucket.

    Returns (refined omegas, bracketed). `bracketed` marks the entries whose
    f64 signs bracketed within the (geometrically widened, up to ~2e-3
    relative) window. An entry that NEVER brackets is not a zero of the f64
    dispersion at all - it is f32 scan noise (measured on cyl_flow_1e5: a
    spurious kink 'root' 0.57% from the true eigenvalue survived refine
    untouched and then poisoned the recheck's nearest-ours comparison);
    callers should drop such entries rather than ship the f32 value.
    """
    n = len(omegas)
    if n == 0:
        return omegas, np.zeros(0, bool)
    # pad to a power-of-two bucket (>= 128) with copies of the first root:
    # one compiled program serves every root count in the bucket
    size = max(128, 1 << (n - 1).bit_length())

    def pad(x):
        return jnp.asarray(np.concatenate([x, np.full(size - n, x[0])]),
                           jnp.float64)

    out, bracketed = _refine_f64(disp64, pad(omegas), pad(ks), pad(modes),
                                 n_iter, rel_halfwidth)
    return np.asarray(out)[:n], np.asarray(bracketed)[:n]


@partial(jax.jit, static_argnums=(0, 4, 5))
def _refine_f64(disp64, om, kk, md, n_iter, rel_halfwidth):
    # ONE traced copy of the dispersion (each copy is a whole RK4 scan, and
    # the compile time grows with the copies): every iteration takes the
    # signs at 2n points - both bracket ends in the 5 widening rounds, the
    # midpoint (twice; the lanes are free) in the n_iter bisection steps.
    n = om.shape[0]
    kk2 = jnp.concatenate([kk, kk])
    md2 = jnp.concatenate([md, md])

    def body(i, carry):
        lo, hi, w, lo_neg, bad = carry
        widening = i < 5
        mid = 0.5 * (lo + hi)
        a = jnp.where(widening, lo, mid)
        b = jnp.where(widening, hi, mid)
        neg = jnp.signbit(disp64(jnp.concatenate([a, b]), kk2, md2).det)
        # rounds 0-3 widen geometrically (x8 per round, up to ~2e-3
        # relative) where the f64 signs do not yet bracket: an f32-polished
        # root can sit ~1e-3 relative off the f64 zero when the determinant
        # is cancellation-heavy. Round 4 only checks; entries that never
        # bracketed keep their f32 value untouched (lo = hi = om).
        now_bad = neg[:n] == neg[n:]
        w = jnp.where(i < 4, 8.0 * w, w)
        grow = now_bad & (i < 4)
        collapse = now_bad & (i == 4)
        lo_w = jnp.where(grow, om * (1.0 - w), jnp.where(collapse, om, lo))
        hi_w = jnp.where(grow, om * (1.0 + w), jnp.where(collapse, om, hi))
        go_right = neg[:n] == lo_neg
        return (jnp.where(widening, lo_w, jnp.where(go_right, mid, lo)),
                jnp.where(widening, hi_w, jnp.where(go_right, hi, mid)),
                w, jnp.where(widening, neg[:n], lo_neg),
                jnp.where(widening, now_bad, bad))

    lo, hi, _, _, bad = jax.lax.fori_loop(
        0, 5 + n_iter, body,
        (om * (1.0 - rel_halfwidth), om * (1.0 + rel_halfwidth),
         jnp.asarray(rel_halfwidth, om.dtype), jnp.zeros(n, bool),
         jnp.zeros(n, bool)))
    return 0.5 * (lo + hi), ~bad


# ---------------------------------------------------------------------------
# Complex-omega search (Kelvin-Helmholtz growth rates)
# ---------------------------------------------------------------------------

class ComplexSearchResult(NamedTuple):
    omega: jnp.ndarray     # complex roots
    k: jnp.ndarray
    resid: jnp.ndarray     # |D| at the root (normalised)
    mask: jnp.ndarray


def winding_number(disp_batch: Callable, k, path: jnp.ndarray, mode=None):
    """Winding number of the dispersion determinant along a closed polyline
    `path` in the complex omega plane: (zeros - poles) enclosed, by the
    argument principle (phase-increment quadrature)."""
    z = jnp.asarray(path)
    n = z.shape[0]
    kk = jnp.full(z.shape, k, jnp.asarray(z).real.dtype)
    md = None if mode is None else jnp.full(z.shape, float(mode))
    det = _call_disp(disp_batch, z, kk, md).det
    dphase = jnp.angle(det[jnp.arange(1, n + 1) % n] / det)
    return jnp.sum(dphase) / (2.0 * jnp.pi)


def count_roots_argument_principle(disp_batch: Callable, k, center, radius,
                                   n_points: int = 512, mode=None):
    """Number of zeros (minus poles) of the holomorphic dispersion determinant
    inside a circle in the complex omega plane, by winding-number quadrature
    (the argument-principle completeness check recommended by the retrieved
    root-search literature - PAPERS.md; used to verify that a band's Newton
    sweep missed no KH roots)."""
    th = jnp.linspace(0.0, 2.0 * jnp.pi, n_points, endpoint=False)
    z = center + radius * jnp.exp(1j * th)
    return winding_number(disp_batch, k, z, mode=mode)


def count_roots_rectangle(disp_batch: Callable, k, re_lo, re_hi, im_lo, im_hi,
                          n_per_side: int = 128, mode=None):
    """Zeros (minus poles) inside a rectangle of the complex omega plane.

    The completeness audit uses UPPER-half-plane rectangles (im_lo > 0):
    the determinant's singularities - Alfven/cusp/flow-continuum poles,
    omega = k (U(x) +- c_T(x)) etc. - all sit on the REAL axis for real
    equilibria, so a rectangle lifted off the axis is pole-free and its
    winding number counts genuinely growing modes exactly.
    """
    def seg(a, b):
        t = jnp.linspace(0.0, 1.0, n_per_side, endpoint=False)
        return a + (b - a) * t

    c = [complex(re_lo, im_lo), complex(re_hi, im_lo),
         complex(re_hi, im_hi), complex(re_lo, im_hi)]
    path = jnp.concatenate([seg(c[i], c[(i + 1) % 4]) for i in range(4)])
    return winding_number(disp_batch, k, path, mode=mode)


@partial(jax.jit, static_argnums=(0,), static_argnames=("n_iter", "damping"))
def newton_complex(disp_batch: Callable, omega0: jnp.ndarray, k: jnp.ndarray,
                   n_iter: int = 20, damping: float = 1.0):
    """Batched Newton iteration in complex omega on the holomorphic dispersion
    determinant. Replaces the reference's 2-D `fsolve` on [Re, Im] residuals
    (`flow_multiprocessor_complex_coronal.py:438-450`). dD/domega comes from a
    single `jax.jvp` (holomorphic forward-mode), so each iteration costs two
    determinant evaluations."""

    def det_fn(om, kk):
        return disp_batch(om, kk).det

    def body(_, om):
        d, dd = jax.jvp(lambda o: det_fn(o, k), (om,),
                        (jnp.ones_like(om),))
        step = jnp.where(dd == 0, 0.0 + 0.0j, d / dd)
        # clamp steps to avoid shooting across the plane from near-poles
        max_step = 0.2 * (1.0 + jnp.abs(om))
        mag = jnp.abs(step)
        step = jnp.where(mag > max_step, step * (max_step / mag), step)
        return om - damping * step

    om = jax.lax.fori_loop(0, n_iter, body, omega0)
    return om

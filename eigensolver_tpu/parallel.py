"""Multi-device / multi-host sharding of the candidate grid.

The reference's only parallelism is one OS process per (k, speed-band) cell
with `multiprocessing.Queue` collection (SURVEY.md P1/P2; 1800 concurrent
processes for the cylinder sweep, `Density_cylinder.py:1126-1153`). Here
the flattened (k, band) ladder-row axis is sharded over a 1-D
`jax.sharding.Mesh`; the ladder scan, bracketing and vectorised bisection are
all row-local, so XLA SPMD runs them with zero communication; candidate roots
are gathered to the host once at the end (replacing Queue+chain-flatten) and
deduplicated there.

Multi-host: `jax.distributed.initialize()` + the same mesh over all processes;
the gather rides the interconnect within a host and the network across
hosts. The cards of one host are joined all to all, so the mesh stays 1-D.
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .config import CaseConfig
from .roots import RootSet
from .search import SearchConfig, search_rows
from .sweep import SweepStats, build_ladders, make_dispersion_moded


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Multi-controller (multi-host) initialisation.

    Call once per process before any other JAX API. Arguments default to the
    `EIGENSOLVER_COORDINATOR` / `EIGENSOLVER_NUM_PROCESSES` /
    `EIGENSOLVER_PROCESS_ID` environment variables (so launchers can export
    them without touching user code). Returns True when a multi-process
    runtime was initialised, False when the env requests none (single-host
    run).

    This is the capability replacing the reference's single-node 1800-process
    fan-out (`Density_cylinder.py:1126-1153`): after initialisation,
    `jax.devices()` spans all hosts, `make_mesh()` builds a global mesh, and
    `run_case_sharded` runs one SPMD program over it.
    """
    import os
    coordinator = coordinator or os.environ.get("EIGENSOLVER_COORDINATOR")
    num_processes = num_processes if num_processes is not None else \
        _env_int("EIGENSOLVER_NUM_PROCESSES")
    process_id = process_id if process_id is not None else \
        _env_int("EIGENSOLVER_PROCESS_ID")
    if coordinator is None and num_processes is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def _env_int(name: str) -> Optional[int]:
    import os
    v = os.environ.get(name)
    return None if v is None else int(v)


def make_mesh(n_devices: Optional[int] = None, axis: str = "cand") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]).reshape(n), axis_names=(axis,))


def run_case_sharded(case: CaseConfig, mesh: Optional[Mesh] = None,
                     search: Optional[SearchConfig] = None,
                     modes=None, refine_f64: bool = False
                     ) -> tuple[RootSet, SweepStats]:
    """Sharded sweep: identical results to `sweep.run_case`, candidate rows
    distributed over the mesh. Padding rows duplicate the last row; their
    roots are dropped by slicing before dedup. refine_f64 re-bisects the
    (host-gathered) accepted roots in float64 exactly as run_case does -
    the shared `sweep.finalize_branches` tail."""
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    search = search or SearchConfig(
        n_omega=case.grid.n_omega_ladder, n_bisect=case.grid.n_bisect)
    modes = tuple(modes) if modes is not None else case.modes
    scan_dt = jnp.dtype(search.scan_dtype)
    polish_dt = jnp.dtype(search.polish_dtype)

    omegas, ks = build_ladders(case, search.n_omega)
    omegas = np.asarray(omegas)
    ks = np.asarray(ks)
    rows = omegas.shape[0]

    # fuse mode families into one batch (traced mode column, as in run_case)
    omegas_f = np.concatenate([omegas] * len(modes))
    ks_f = np.concatenate([ks] * len(modes))
    modes_f = np.concatenate(
        [np.full((rows,), float(mode)) for mode in modes])

    # pad the fused rows so they split evenly over the mesh; padding ladders
    # are NaN (produce no brackets)
    true_rows = omegas_f.shape[0]
    pad = (-true_rows) % n_dev
    if pad:
        omegas_f = np.concatenate(
            [omegas_f, np.full((pad, omegas_f.shape[1]), np.nan)])
        ks_f = np.concatenate([ks_f, np.ones(pad)])
        modes_f = np.concatenate([modes_f, np.zeros(pad)])

    row_sharding = NamedSharding(mesh, P(axis, None))
    k_sharding = NamedSharding(mesh, P(axis))

    def put(arr, sharding):
        arr = np.asarray(arr, jnp.dtype(scan_dt))
        if jax.process_count() > 1:
            # multi-controller: every process holds the same full host array;
            # each contributes only its addressable shards
            return jax.make_array_from_callback(
                arr.shape, sharding, lambda idx: arr[idx])
        return jax.device_put(jnp.asarray(arr), sharding)

    om_dev = put(omegas_f, row_sharding)
    ks_dev = put(ks_f, k_sharding)
    md_dev = put(modes_f, k_sharding)

    disp_scan = make_dispersion_moded(case, scan_dt)
    disp_polish = (disp_scan if polish_dt == scan_dt
                   else make_dispersion_moded(case, polish_dt))

    stats = SweepStats()
    t0 = time.time()
    pr = search_rows(disp_scan, disp_polish, om_dev, ks_dev, search,
                     row_bucket=n_dev, modes=md_dev)
    if jax.process_count() > 1:
        # multi-controller: the result shards live on different hosts; one
        # cross-host all-gather replicates them so every process holds the full root
        # set (replaces the reference's Queue drain, SURVEY.md P2)
        from jax.experimental import multihost_utils
        pr = type(pr)(*[None if x is None
                        else multihost_utils.process_allgather(x, tiled=True)
                        for x in pr])
    from .sweep import finalize_branches
    branches = finalize_branches(pr, modes, case, search,
                                 refine_f64=refine_f64)
    stats.n_roots = sum(len(b) for b in branches.values())
    stats.n_candidates = true_rows * omegas.shape[1]
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats

"""Two-process CPU multi-controller sweep (jax.distributed) vs the
single-process sharded sweep.

This exercises the REAL multi-host code path - `parallel.init_distributed`
(env-gated `jax.distributed.initialize`), a global mesh spanning both
processes, `make_array_from_callback` placement, and the cross-host
`process_allgather` result collection - on two local CPU processes with 2
virtual devices each (4 global). Across real hosts the identical program
runs over the network instead of grpc-over-localhost; the work partition
and collectives are the same (SURVEY.md P3, replacing the reference's
single-node 1800-process fan-out, `Density_cylinder.py:1126-1153`).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r'''
import json
import jax
jax.config.update("jax_platforms", "cpu")
from eigensolver_tpu.parallel import init_distributed, make_mesh, run_case_sharded
assert init_distributed(), "env not set"
assert jax.process_count() == 2, jax.process_count()
import dataclasses
from eigensolver_tpu import cases
from eigensolver_tpu.search import SearchConfig

case = cases.slab_density_photospheric(width=0.9)
case = dataclasses.replace(
    case, n_k=4, grid=dataclasses.replace(case.grid, n_interior=64))
cfg = SearchConfig(n_omega=32, n_bisect=12, max_brackets_per_row=4,
                   scan_dtype="float32", polish_dtype="float32")
rs, st = run_case_sharded(case, make_mesh(), cfg)
out = {b: [[float(x) for x in br.omegas], [float(x) for x in br.ks]]
       for b, br in rs.branches.items()}
print("RESULT " + json.dumps(out), flush=True)
'''


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_multicontroller_matches_single():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "EIGENSOLVER_COORDINATOR": f"127.0.0.1:{port}",
            "EIGENSOLVER_NUM_PROCESSES": "2",
            "EIGENSOLVER_PROCESS_ID": str(pid),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "JAX_PLATFORMS": "cpu",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out + err[-2000:]
        outs.append(json.loads(line[-1][len("RESULT "):]))

    # both controllers hold the identical full root set
    assert outs[0] == outs[1]
    assert sum(len(v[0]) for v in outs[0].values()) > 0

    # and it matches the single-process sharded sweep on the same 4-device
    # global mesh (same SPMD program, grpc collectives swapped for local)
    import dataclasses
    import jax
    from eigensolver_tpu import cases
    from eigensolver_tpu.parallel import make_mesh, run_case_sharded
    from eigensolver_tpu.search import SearchConfig

    case = cases.slab_density_photospheric(width=0.9)
    case = dataclasses.replace(
        case, n_k=4, grid=dataclasses.replace(case.grid, n_interior=64))
    cfg = SearchConfig(n_omega=32, n_bisect=12, max_brackets_per_row=4,
                       scan_dtype="float32", polish_dtype="float32")
    rs, _ = run_case_sharded(case, make_mesh(4), cfg)
    for b, (oms, ks) in outs[0].items():
        np.testing.assert_allclose(np.asarray(oms), rs[b].omegas, rtol=2e-6)
        np.testing.assert_allclose(np.asarray(ks), rs[b].ks, rtol=0)

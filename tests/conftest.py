"""Test harness: the CPU with 8 virtual devices (multi-device sharding tests
run on a virtual mesh, per SURVEY.md section 4's testing plan) and float64.

`JAX_PLATFORMS` is only defaulted, so `JAX_PLATFORMS=cuda,cpu pytest -m gpu`
reaches the card for the tests marked `gpu`."""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

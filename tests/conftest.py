"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Parity tests require float64 (the reference is REAL(C_DOUBLE) end to end);
sharding tests need a multi-device mesh.  The CPU backend is forced only
when JAX_PLATFORMS is unset, so ``JAX_PLATFORMS=cuda pytest -m gpu`` (run by
chip_smoke.py) reaches the card.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

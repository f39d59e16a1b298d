# -*- coding: utf-8 -*-
"""
Test configuration. By default the tests run on a virtual 8-device CPU
mesh (sharding tests need no accelerator) with float64 enabled, so kernel
parity tests can compare against the float64 reference.

``JAX_PLATFORMS=cuda python -m pytest tests -m gpu`` runs the tests that
need a GPU on the card instead; elsewhere those tests skip (a fixture
decides, at run time).

"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    assert jax.devices()[0].platform == "cpu", "tests must run on CPU devices"

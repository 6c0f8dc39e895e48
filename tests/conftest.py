"""Force a virtual 8-device CPU mesh for all tests (SURVEY.md §4).

The platform is pinned through jax.config before first backend use, so
the tests run on the CPU even where JAX could reach a GPU. Tests that
need a card carry the ``gpu`` marker and decide inside the test body
whether one is present.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

"""Test configuration.

The suite runs on the CPU: Pallas kernels go through the Pallas
interpreter (``interpret=True``, chosen by ``ops._utils.use_interpret_mode``)
and an 8-device virtual CPU mesh exercises the multi-device sharding logic.
The reference gates its GPU tests on ``numba.cuda.is_available()``
(tests/test_flash_attention.py:16-21); here the tests that need the card
carry the ``gpu`` marker and skip inside their ``gpu`` fixture when JAX
finds no GPU.  ``chip_smoke.py`` runs them on the card by setting
``FLASHATTN_TEST_GPU=1``, which leaves JAX on its default backend:

    FLASHATTN_TEST_GPU=1 python -m pytest -m gpu tests/

``jax.config.update`` (not the environment) selects the CPU, because it
works even when JAX was imported before this file ran.
"""

import os

if not os.environ.get("FLASHATTN_TEST_GPU"):
    # XLA parses XLA_FLAGS at first backend initialisation, which has not
    # happened yet even if jax is already imported.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"
    assert jax.device_count() == 8, "expected 8 virtual CPU devices"

"""Test configuration: force JAX onto a virtual 8-device CPU mesh so
multi-device sharding tests run anywhere (the analog of the reference's
ability to run with any backend disabled, main.cpp:289-302)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if jax.config.jax_num_cpu_devices < 8:
    jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: the suite is compile-bound (each renderer
# variant compiles its frame fns); repeat runs hit the cache.
from rayaccel_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import pytest

from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.scene.compile import compile_scene


@pytest.fixture(scope="session")
def test_scene_data():
    return make_test_scene()


@pytest.fixture(scope="session")
def test_scene(test_scene_data):
    return compile_scene(test_scene_data)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)

"""Context lifecycle: analog of racc::init / createContext / info / destroy
(reference RayAccelerator.h:95-105, RayAccelerator.cpp:417-427, 448-727).

The reference context owns worker threads, a ray-stream pool and OpenCL
state; under XLA all of that collapses into compiled programs, so the
context holds only the configuration, the device set and the optional
multi-chip mesh. It stays a first-class object because scene compilation
and renderers are parameterized by it, mirroring the reference API shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

from rayaccel_tpu.config import Configuration, ContextInfo, default_configuration


def init() -> None:
    """Analog of racc::init (RayAccelerator.cpp:417-423). The reference
    disables denormals (FTZ/DAZ) and boots Embree; XLA sets its own
    floating-point modes and there is no library to boot, so this only
    asserts the float32 default (x64 mode would silently double every buffer)."""
    if jax.config.read("jax_enable_x64"):
        raise RuntimeError("rayaccel_tpu requires float32 mode (jax_enable_x64=False)")


def deinit() -> None:
    """Analog of racc::deinit (RayAccelerator.cpp:425-427)."""


@dataclasses.dataclass
class Context:
    configuration: Configuration
    devices: list
    mesh: Optional[jax.sharding.Mesh] = None

    @property
    def device_count(self) -> int:
        return len(self.devices)


def create_context(configuration: Optional[Configuration] = None,
                   devices=None) -> Context:
    """Analog of racc::createContext (RayAccelerator.cpp:448-727). Stream
    pool sizing, page-aligned allocation and worker startup have no XLA
    equivalent; what remains is device selection and (optionally) building
    the tile-parallel mesh."""
    cfg = configuration or default_configuration()
    devices = list(devices) if devices is not None else list(jax.devices())
    mesh = None
    if cfg.mesh_shape is not None:
        import numpy as np
        n = int(np.prod(cfg.mesh_shape))
        if n > len(devices):
            raise ValueError(f"mesh_shape {cfg.mesh_shape} needs {n} devices, "
                             f"have {len(devices)}")
        mesh = jax.sharding.Mesh(
            np.asarray(devices[:n]).reshape(cfg.mesh_shape), ("tiles",))
    return Context(configuration=cfg, devices=devices, mesh=mesh)


def destroy(context: Context) -> None:
    """Analog of racc::destroy(Context*) (RayAccelerator.cpp:761-788);
    device buffers are garbage-collected, nothing to join."""


def info(context: Context) -> ContextInfo:
    """Analog of racc::info (RayAccelerator.cpp:729-736)."""
    cfg = context.configuration
    return ContextInfo(
        device_count=context.device_count,
        wave_size=cfg.wave_size,
        max_rays_in_flight=cfg.max_rays_in_flight,
        backend=cfg.backend,
    )

"""Configuration for the wavefront runtime.

Reinterprets every knob of the reference ``racc::Configuration``
(reference RayAccelerator.h:32-42) for a compiled wavefront loop, where
the CPU-thread/GPU-queue scheduler is replaced by XLA programs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Closest-hit engines a Configuration may name: the cluster engine
# (ops/trace_mxu.py, the production path) and its two references.
BACKENDS = ("mxu", "xla", "bruteforce")


@dataclasses.dataclass(frozen=True)
class Configuration:
    """Runtime configuration.

    Mapping from the reference configuration (RayAccelerator.h:32-42,
    defaults at RayAccelerator.cpp:429-446):

    - ``gpuContext``            -> ``backend``: which traversal engine runs the
      ray/scene intersection stage. ``"mxu"`` is the cluster-dense tracer
      (ops/trace_mxu.py) — the throughput engine, playing the role of the
      OpenCL kernel (Kernels.h:141-242); ``"xla"`` is the lockstep
      BVH2/TrianglePair traversal (ops/trace.py), the general-purpose
      reference in the role of the Embree CPU path (Scene.cpp:374-484).
      Both produce the same hits and serve as each other's oracle, like
      the reference's ``--no-gpu`` / ``--no-cpu-tracing`` flag pair
      (main.cpp:289-302).
    - ``allowCpuTracing``       -> gone: one engine traces every ray class.
    - ``cpuThreads``/``gpuSubmissionThreads`` -> gone: XLA owns scheduling;
      the mesh axis in :mod:`rayaccel_tpu.parallel` is the concurrency knob.
    - ``maxRaysInFlight`` (128*128*16)        -> ``max_rays_in_flight``: the
      per-device ray-pool cap; a wave is clamped to at most this many lanes.
    - ``maxRaysPerSpawn``/``cpuShadeBatch``   -> gone: spawn and shade fuse
      into the compiled wave loop, so there is no separate granularity.
    - ``cpuTestBatch``                        -> ``trace_block``: ray-tile
      size of the cluster engine (rays that share one cluster queue).
    - ``rayStreamBatchSize`` (11264, sized so the iGPU stays occupied,
      RayAccelerator.cpp:440) -> ``wave_size``: rays per traced primary
      wave.
    """

    backend: str = "mxu"
    max_rays_in_flight: int = 128 * 128 * 16
    trace_block: int = 1024
    wave_size: int = 128 * 128 * 4
    # BVH traversal stack depth per ray (reference GPU kernel uses 64,
    # Kernels.h:166). Kept configurable because it scales wavefront state.
    traversal_stack_depth: int = 48
    # Pixel sampler: "uniform" matches the reference's per-call rand()
    # jitter (Camera.cpp:58); "stratified" is progressive R2
    # low-discrepancy sampling (bench config 4).
    sampler: str = "uniform"
    # Re-sort lane state between bounces by spatial coherence (the
    # wavefront form of the reference's ray-stream regrouping, SURVEY.md
    # §7); on, the renderers run the frame-pooled bounce loop.
    regroup: bool = True
    # Maximum path depth for the Whitted ray-tree spill stack, analog of
    # maxShadingDepth=8 pre-sizing loopData 8*maxRaysInFlight
    # (WhittedRenderer.cpp:47-50).
    max_shading_depth: int = 8
    # Optional (devices, ) mesh shape for multi-chip tile parallelism.
    mesh_shape: Optional[Tuple[int, ...]] = None
    # Cross-chip bounce load balancing: re-shard pooled bounce rays over
    # the mesh when per-shard live counts diverge (SURVEY §2d work
    # stealing analog; reference RayAccelerator.cpp:215-244, 360-363).
    reshard_bounces: bool = True
    # --- frame-pool shape knobs (every constant that affects a benched
    # number lives here and is echoed in the bench knobs line). ---
    # Width-shrink ladder floor for both frame pools: the pool never
    # shrinks below this many lanes.
    min_stage_width: int = 8192
    # Whitted pooled tree loop: width-ladder ratio (tree live sets decay
    # slowly; PT uses a fixed ratio 4 for its geometric live collapse).
    whitted_stage_ratio: int = 2
    # Whitted pooled tree loop: parked-stack levels hauled through every
    # width shrink; deeper levels ride a cond on the actual max sp.
    whitted_hot_levels: int = 3

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; the "
                             f"engines are {', '.join(BACKENDS)}")
        if self.sampler not in ("uniform", "stratified"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.max_rays_in_flight <= 0 or self.wave_size <= 0:
            raise ValueError("ray counts must be positive")
        if self.wave_size % 8 != 0:
            raise ValueError("wave_size must be a multiple of 8")
        if self.min_stage_width < 1024:
            raise ValueError("min_stage_width must be >= 1024")
        if self.whitted_stage_ratio < 2:
            raise ValueError("whitted_stage_ratio must be >= 2")
        if self.whitted_hot_levels < 1:
            raise ValueError("whitted_hot_levels must be >= 1")

    def pool_knobs(self) -> dict:
        """Frame-pool shape knobs for bench-line echoes."""
        return dict(min_stage_width=self.min_stage_width,
                    whitted_stage_ratio=self.whitted_stage_ratio,
                    whitted_hot_levels=self.whitted_hot_levels,
                    max_shading_depth=self.max_shading_depth)


@dataclasses.dataclass(frozen=True)
class ContextInfo:
    """Introspection data, analog of racc::ContextInfo (RayAccelerator.h:44-49)."""

    device_count: int
    wave_size: int
    max_rays_in_flight: int
    backend: str


def default_configuration(backend: str = "mxu") -> Configuration:
    """Tuned defaults, analog of racc::defaultConfiguration (reference
    RayAccelerator.cpp:429-446): the cluster engine for every ray class,
    65k-lane primary waves and 1024-ray trace tiles. The CLI and
    ``Configuration()`` use the same default."""
    return Configuration(backend=backend)

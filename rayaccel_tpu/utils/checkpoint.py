"""Progressive-render checkpoint/resume.

The reference has no checkpointing (SURVEY.md §5); its closest state is
the progressive accumulation pair (frameBuffer, spp) reset on camera moves
(reference main.cpp:204-205, 248-251). Long progressive renders on a
shared accelerator can be preempted, so we serialize exactly that state — the swizzled
accumulation buffer, spp, and the base RNG key — so a render resumes
mid-accumulation bit-exactly.
"""

from __future__ import annotations

import json
import os  # noqa: F401  (kept for callers)

import jax.numpy as jnp
import numpy as np

_MAGIC = "rayaccel_tpu-checkpoint-v1"


def scene_fingerprint(renderer) -> str:
    """Hash of the scene geometry + camera pose, so a checkpoint refuses
    to blend accumulation from a different scene or viewpoint (the
    reference resets accumulation on any camera move, main.cpp:248-251)."""
    import hashlib

    h = hashlib.sha1()
    sd = getattr(renderer, "scene_data", None)
    if sd is not None:
        h.update(np.asarray(sd.vertices, np.float32).tobytes())
        h.update(np.asarray(sd.indices, np.uint32).tobytes())
        h.update(np.asarray(sd.materials, np.float32).tobytes())
    cam = getattr(renderer, "camera", None)
    if cam is not None:
        for a in cam.as_arrays():
            h.update(np.asarray(a, np.float32).tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, renderer, base_key=None) -> None:
    meta = {
        "magic": _MAGIC,
        "spp": renderer.spp,
        "width": renderer.width,
        "height": renderer.height,
        "n_lanes": renderer.n_lanes,
        "fingerprint": scene_fingerprint(renderer),
    }
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json", "w") as f:
        json.dump(meta, f)
    arrays = {"fb": np.asarray(renderer.frame_buffer)}
    if base_key is not None:
        arrays["key"] = np.asarray(base_key)
    np.savez(base + ".npz", **arrays)


def load_checkpoint(path: str, renderer):
    """Restore accumulation state into ``renderer``. Returns the stored
    base RNG key (or None). ``path`` may be the base prefix or the .npz."""
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        meta = json.load(f)
    if meta.get("magic") != _MAGIC:
        raise ValueError(f"{path}: not a rayaccel_tpu checkpoint")
    if (meta["width"], meta["height"]) != (renderer.width, renderer.height):
        raise ValueError(
            f"checkpoint viewport {meta['width']}x{meta['height']} != "
            f"renderer {renderer.width}x{renderer.height}")
    if meta["n_lanes"] != renderer.n_lanes:
        raise ValueError("wave layout mismatch (different wave_size?)")
    fp = meta.get("fingerprint")
    if fp is not None and fp != scene_fingerprint(renderer):
        raise ValueError(
            "checkpoint scene/camera fingerprint mismatch: refusing to "
            "blend accumulation across different scenes or viewpoints")
    data = np.load(base + ".npz")
    renderer.set_frame_buffer(jnp.asarray(data["fb"]))
    renderer.spp = int(meta["spp"])
    return jnp.asarray(data["key"]) if "key" in data else None

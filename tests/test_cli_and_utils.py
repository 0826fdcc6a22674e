"""CLI, stats, checkpoint and image-IO tests (reference app-shell parity:
flags main.cpp:289-307, Mrays/s reporting main.cpp:208-231)."""

import os

import numpy as np
import jax
import pytest

import rayaccel_tpu as racc
from rayaccel_tpu.cli import main as cli_main
from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from rayaccel_tpu.utils.image import rmse, tonemap, write_pfm, write_png
from rayaccel_tpu.utils.stats import RenderStats


def test_cli_conflicting_flags(capsys):
    assert cli_main(["--no-gpu", "--no-cpu-tracing"]) == 1


def test_cli_renders_png(tmp_path):
    out = str(tmp_path / "t.png")
    rc = cli_main(["--synthetic", "test", "--spp", "1", "--quiet",
                   "--width", "64", "--height", "64", "--max-depth", "1",
                   "--wave-size", "4096", "--out", out])
    assert rc == 0
    data = open(out, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) > 500


def test_cli_whitted_xla_backend(tmp_path):
    out = str(tmp_path / "w.pfm")
    rc = cli_main(["--synthetic", "test", "--whitted", "--no-gpu",
                   "--spp", "1", "--quiet", "--width", "64", "--height", "64",
                   "--wave-size", "4096", "--out", out])
    assert rc == 0
    with open(out, "rb") as f:
        assert f.readline().strip() == b"PF"


def test_scene_file_roundtrip_via_cli(tmp_path):
    from rayaccel_tpu.scene.loader import save_scene
    s = make_test_scene(viewport=(64, 64))
    path = str(tmp_path / "scene.bin")
    save_scene(path, s)
    out = str(tmp_path / "s.png")
    rc = cli_main(["--scene", path, "--spp", "1", "--quiet",
                   "--wave-size", "4096", "--max-depth", "1", "--out", out])
    assert rc == 0 and os.path.exists(out)


def test_checkpoint_roundtrip(tmp_path):
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ctx = racc.create_context(racc.Configuration(wave_size=4096))
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov, 64, 64)
    r = racc.PathTracingRenderer(ctx, cam, s)
    r.render_frame(jax.random.PRNGKey(0))
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, r, jax.random.PRNGKey(0))

    r2 = racc.PathTracingRenderer(ctx, cam, s)
    key = load_checkpoint(ckpt + ".npz", r2)
    assert r2.spp == 1
    assert key is not None
    np.testing.assert_array_equal(np.asarray(r2.frame_buffer),
                                  np.asarray(r.frame_buffer))
    # Continuing from the checkpoint == continuing the original.
    r.render_frame(jax.random.PRNGKey(1))
    r2.render_frame(jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(r2.frame_buffer),
                                  np.asarray(r.frame_buffer))


def test_checkpoint_rejects_mismatch(tmp_path):
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ctx = racc.create_context(racc.Configuration(wave_size=4096))
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov, 64, 64)
    r = racc.PathTracingRenderer(ctx, cam, s)
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, r)
    s2 = make_test_scene(viewport=(128, 128), max_depth=1)
    cam2 = racc.Camera.look_at(s2.cam_origin, s2.cam_dir, s2.cam_up,
                               s2.cam_fov, 128, 128)
    r2 = racc.PathTracingRenderer(ctx, cam2, s2)
    with pytest.raises(ValueError):
        load_checkpoint(ckpt + ".npz", r2)


def test_stats_sliding_window():
    st = RenderStats()
    for i in range(40):
        st.record(1_000_000, 0.01, i + 1)
    assert st.frames == 40
    assert abs(st.sliding_mrays_per_s - 100.0) < 1e-6
    assert abs(st.last.mrays_per_s - 100.0) < 1e-6
    line = st.format_line()
    assert "instant" in line and "sliding" in line
    s = st.summary()
    assert s["rays_traced_total"] == 40_000_000


def test_tonemap_divides_by_spp():
    hdr = np.full((2, 2, 3), 2.0, np.float32)
    out = tonemap(hdr, spp=4)
    assert out.dtype == np.uint8
    assert np.all(out == int(2.0 * 255 / 4))


def test_rmse_helper():
    a = np.zeros((4, 4, 3))
    b = np.ones((4, 4, 3)) * 2
    assert abs(rmse(a, b) - 2.0) < 1e-9


def test_cli_backend_flag_mapping():
    from rayaccel_tpu.cli import build_parser, select_backend
    p = build_parser()
    assert select_backend(p.parse_args([])) == "mxu"
    assert select_backend(p.parse_args(["--no-gpu"])) == "xla"
    assert select_backend(p.parse_args(["--no-cpu-tracing"])) == "mxu"
    assert select_backend(p.parse_args(["--backend", "xla",
                                        "--no-cpu-tracing"])) == "xla"


def test_checkpoint_rejects_camera_move(tmp_path):
    """Same viewport, different viewpoint: the fingerprint must refuse to
    blend accumulation (the reference resets accumulation on camera moves,
    main.cpp:248-251)."""
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ctx = racc.create_context(racc.Configuration(wave_size=4096))
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov, 64, 64)
    r = racc.PathTracingRenderer(ctx, cam, s)
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, r)
    cam2 = racc.Camera.look_at(np.asarray(s.cam_origin) + 1.0, s.cam_dir,
                               s.cam_up, s.cam_fov, 64, 64)
    r2 = racc.PathTracingRenderer(ctx, cam2, s)
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(ckpt + ".npz", r2)


def test_cli_resume_uses_stored_key(tmp_path):
    """Resuming with a DIFFERENT --seed must continue the checkpointed RNG
    stream: two more spp after resume equal two more spp without a resume."""
    from rayaccel_tpu.scene.loader import save_scene
    s = make_test_scene(viewport=(64, 64))
    path = str(tmp_path / "scene.bin")
    save_scene(path, s)
    common = ["--scene", path, "--quiet", "--wave-size", "4096",
              "--max-depth", "1", "--backend", "mxu"]
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    assert cli_main(common + ["--spp", "3", "--seed", "5", "--out", a]) == 0
    ck = str(tmp_path / "ck")
    assert cli_main(common + ["--spp", "1", "--seed", "5", "--out",
                              str(tmp_path / "x.pfm"), "--checkpoint", ck]) == 0
    assert cli_main(common + ["--spp", "3", "--seed", "999", "--out", b,
                              "--checkpoint", ck]) == 0
    ia = np.fromfile(a, np.float32)
    ib = np.fromfile(b, np.float32)
    np.testing.assert_array_equal(ia, ib)


def test_cli_preview_every_presents_progressively(tmp_path):
    """--preview-every re-writes the output during accumulation (the
    reference's per-frame present, DisplayBuffer.cpp:106-132): the
    preview written at 1 spp must differ from the final 3-spp image."""
    import os
    from rayaccel_tpu.scene.loader import save_scene
    s = make_test_scene(viewport=(64, 64))
    path = str(tmp_path / "scene.bin")
    save_scene(path, s)
    out = str(tmp_path / "p.pfm")
    common = ["--scene", path, "--quiet", "--wave-size", "4096",
              "--max-depth", "1", "--backend", "mxu", "--out", out]
    assert cli_main(common + ["--spp", "1"]) == 0
    one_spp = np.fromfile(out, np.float32)
    os.remove(out)
    assert cli_main(common + ["--spp", "3", "--preview-every", "1"]) == 0
    final = np.fromfile(out, np.float32)
    assert final.shape == one_spp.shape
    assert not np.array_equal(final, one_spp)


def test_cli_orbit_animation(tmp_path):
    """Scripted camera path: N frames, accumulation reset per move, the
    file-sequence analog of the reference's interactive loop
    (main.cpp:193-282)."""
    out = str(tmp_path / "a.png")
    rc = cli_main(["--synthetic", "test", "--spp", "1", "--quiet",
                   "--width", "64", "--height", "64", "--max-depth", "1",
                   "--wave-size", "4096", "--anim-frames", "3",
                   "--orbit", "15", "--out", out])
    assert rc == 0
    frames = [tmp_path / f"a_{i:04d}.png" for i in range(3)]
    assert all(f.exists() for f in frames)
    data = [f.read_bytes() for f in frames]
    assert data[0] != data[1] and data[1] != data[2], \
        "orbiting camera must change the image"


def test_set_camera_resets_and_reuses_compiled_frame():
    """set_camera must reset accumulation AND render correctly through the
    already-compiled frame fn (camera is a traced argument)."""
    import jax
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ctx = racc.create_context(racc.Configuration(wave_size=4096))
    cam0 = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up,
                               s.cam_fov, 64, 64)
    cam1 = cam0.rotate(0.3, s.cam_up, pivot=np.asarray(s.cam_dir))
    r = racc.PathTracingRenderer(ctx, cam0, s)
    r.render_frame(jax.random.PRNGKey(0))
    r.set_camera(cam1)
    assert r.spp == 0
    assert np.all(np.asarray(r.frame_buffer) == 0)
    r.render_frame(jax.random.PRNGKey(5))

    fresh = racc.PathTracingRenderer(ctx, cam1, s)
    fresh.render_frame(jax.random.PRNGKey(5))
    np.testing.assert_array_equal(np.asarray(r.frame_buffer),
                                  np.asarray(fresh.frame_buffer))


@pytest.mark.parametrize("name", ["pallas", "sparse"])
def test_removed_backend_names_raise(name):
    """The former cluster-kernel engines are gone: naming one is an error
    that lists the engines that exist, in the configuration, the trace
    dispatcher and the CLI."""
    from rayaccel_tpu.ops.trace import trace
    with pytest.raises(ValueError, match="mxu, xla, bruteforce"):
        racc.Configuration(backend=name)
    with pytest.raises(ValueError, match="engines are"):
        trace(None, None, backend=name)
    with pytest.raises(SystemExit):
        cli_main(["--backend", name])


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and the
    code sets no directory of its own; unset, it goes to the checkout's
    .jax_cache. Checked in a fresh interpreter, where the variable is
    read at JAX's start as it is in a deployment."""
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(_REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax\n"
            "from rayaccel_tpu.utils.compile_cache import "
            "enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, want]


def test_measurements_refuse_a_cpu_device():
    """chip_smoke.py and bench.py measure only on a GPU: on a CPU device
    they exit nonzero and print no result line."""
    import subprocess
    import sys
    from rayaccel_tpu.utils.device import require_gpu
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for script in ("chip_smoke.py", "bench.py"):
        out = subprocess.run([sys.executable, script], cwd=_REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, script
        assert '"ok"' not in out.stdout and "Mrays/s" not in out.stdout


def test_bench_exits_nonzero_when_a_config_fails(capsys):
    """A config that raises prints its error line, the later configs still
    run, the headline is printed again last, and the exit code is 1."""
    import json
    import sys
    sys.path.insert(0, _REPO)
    import bench

    def boom():
        raise MemoryError("out of device memory")

    label = {"device": {"platform": "gpu", "kind": "test", "count": 1},
             "card": "test card, 1 W"}
    rc = bench.run_configs(
        [(bench.HEADLINE, lambda: {"value": 3.0, "unit": "Mrays/s"}),
         ("broken", boom),
         ("after", lambda: {"value": 1.0, "unit": "Mrays/s"})], label)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert [x["metric"] for x in lines] == [bench.HEADLINE, "broken",
                                            "after", bench.HEADLINE]
    assert lines[1]["unit"] == "error" and "MemoryError" in lines[1]["error"]
    assert all(x["card"] == "test card, 1 W" for x in lines)
    assert bench.run_configs([("after", lambda: {"value": 1.0})], label) == 0

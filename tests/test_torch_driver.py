"""Port parity: the runtime driver, config, CLI and render statistics
(``mrt_torch.runtime.{config,driver}``, ``mrt_torch.__main__``,
``mrt_torch.utils.profiling``) against ``mrt``'s, on the CPU
(``device="cpu"``).

The reference's own tests (tests/test_runtime.py TestConfig, TestDriver,
TestElasticRecovery) run on the port.  Then both packages' drivers on
the same config: their films hold C2's rule (ROADMAP C2: at most 1% of
pixels flip their path, every other pixel's sum within 5e-4), and
checkpoints and JSON configs pass between the packages.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mrt.runtime import config as JC
from mrt.runtime import driver as JDRV
from mrt.runtime.film import Film as JFilm
from mrt.utils import profiling as JP
from mrt_torch.__main__ import build_parser, main
from mrt_torch.runtime import driver as drv
from mrt_torch.runtime.config import RenderConfig
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.input import InputReplay
from mrt_torch.runtime.io import load_png
from mrt_torch.utils import profiling as TP

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a: None)


def _run(config):
    return drv.run(config, device="cpu", **QUIET)


class TestConfig:
    def test_json_roundtrip(self, tmp_path):
        c = RenderConfig(scene="cornell", width=64, height=64, spp=4)
        p = str(tmp_path / "c.json")
        c.to_json(p)
        c2 = RenderConfig.from_json(p)
        assert c2 == c

    def test_defaults_match_reference(self):
        c = RenderConfig()
        assert (c.width, c.height) == (1920, 1080)
        assert c.max_depth == 50
        assert c.seed == 1
        assert dataclasses.asdict(c) == dataclasses.asdict(JC.RenderConfig())
        assert c.aspect_ratio == JC.RenderConfig().aspect_ratio
        assert c.total_frames == JC.RenderConfig().total_frames

    def test_json_passes_between_packages(self, tmp_path):
        kw = dict(scene="eve", width=48, height=27, spp=3, denoise=True,
                  display_mode="albedo", checkpoint="c.npz", rr_depth=2,
                  sort_rays=False, nee=True, fps=12.5, port=7001)
        a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
        JC.RenderConfig(**kw).to_json(a)
        ported = RenderConfig.from_json(a)
        assert ported == RenderConfig(**kw)
        ported.to_json(b)
        assert JC.RenderConfig.from_json(b) == JC.RenderConfig(**kw)
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)


class TestDriver:
    def test_single_frame_cli(self, tmp_path):
        out = str(tmp_path / "frame.png")
        config = RenderConfig(scene="rtiow", width=32, height=18, spp=2,
                              max_depth=4, samples_per_pass=2, output=out)
        logs = []
        drv.run(config, log=logs.append, device="cpu")
        assert os.path.exists(out)
        img = Image.open(out)
        assert img.size == (32, 18)
        assert load_png(out).shape == (18, 32, 4)
        assert any("wrote" in line for line in logs)

    def test_checkpoint_resume_via_driver(self, tmp_path):
        out = str(tmp_path / "frame.png")
        ckpt = str(tmp_path / "state.npz")
        config = RenderConfig(scene="rtiow", width=16, height=9, spp=2,
                              max_depth=4, samples_per_pass=2, output=out,
                              checkpoint=ckpt)
        film1 = _run(config)
        assert film1.samples == 2
        config2 = RenderConfig(scene="rtiow", width=16, height=9, spp=4,
                               max_depth=4, samples_per_pass=2,
                               output=out, checkpoint=ckpt)
        film2 = _run(config2)
        assert film2.samples == 4

    def test_animation_frames(self, tmp_path):
        rec = str(tmp_path / "in.bin")
        config = RenderConfig(
            scene="rtiow", width=16, height=9, max_depth=3,
            samples_per_frame=1, animate=True, fps=2.0,
            animation_seconds=1.0, write_input=rec,
            animation_dir=str(tmp_path / "anim"))
        film = _run(config)
        assert film.samples == 1
        for k in range(2):
            assert os.path.exists(str(tmp_path / "anim" /
                                      f"frame_{k:05d}.png"))
        assert len(InputReplay(rec).frames) == 2
        # Replaying the recording renders the same frames.
        again = _run(dataclasses.replace(config, write_input=None,
                                         read_input=rec))
        assert torch.equal(again.sum, film.sum)

    def test_cli_parser(self):
        args = build_parser().parse_args(
            ["--scene", "cornell", "--spp", "16", "-o", "x.png",
             "--mesh-tile", "4", "--device", "cpu"])
        assert args.scene == "cornell"
        assert args.spp == 16
        assert args.mesh_tile == 4
        assert args.device == "cpu"

    def test_parser_matches_reference(self):
        from mrt.__main__ import build_parser as jparser

        want = vars(jparser().parse_args([]))
        got = vars(build_parser().parse_args([]))
        assert got.pop("device") is None
        assert got == want
        argv = ["--scene", "lucy", "--width", "8", "--height", "4", "--spp",
                "2", "--max-depth", "3", "--samples-per-pass", "1",
                "--seed", "7", "-o", "o.png", "--display-mode", "normal",
                "--denoise", "--checkpoint", "c.npz", "--animate", "--fps",
                "3", "--seconds", "2", "--samples-per-frame", "5",
                "--animation-dir", "a", "--read-input", "r", "--write-input",
                "w", "--mesh-spp", "1", "--rr-depth", "4", "--nee",
                "--no-sort-rays", "--batched", "--preview", "--serve",
                "--host", "0.0.0.0", "--port", "9", "--play",
                "--profile-dir", "p"]
        got = vars(build_parser().parse_args(argv))
        got.pop("device")
        assert got == vars(jparser().parse_args(argv))


class TestElasticRecovery:
    def test_retry_resumes_from_checkpoint(self, tmp_path, monkeypatch):
        """A fault mid-render resumes from the last checkpointed pass
        instead of starting over."""
        out = str(tmp_path / "f.png")
        ckpt = str(tmp_path / "s.npz")
        config = RenderConfig(scene="rtiow", width=16, height=9, spp=4,
                              max_depth=3, samples_per_pass=2,
                              output=out, checkpoint=ckpt)
        calls = {"n": 0}
        real = drv.render_frame

        def flaky(scene, camera, cfg, film=None, progress=None):
            calls["n"] += 1
            if calls["n"] == 1:
                # A device fault after the first pass: render 2 spp,
                # checkpoint them through progress, then fail.
                f = real(scene, camera, dataclasses.replace(cfg, spp=2),
                         film=film, progress=progress)
                if progress:
                    progress(f)
                raise RuntimeError("CUDA error (simulated)")
            return real(scene, camera, cfg, film=film, progress=progress)

        monkeypatch.setattr(drv, "render_frame", flaky)
        logs = []
        film = drv.run(config, log=logs.append, device="cpu")
        assert film.samples == 4
        assert calls["n"] == 2
        assert any("resuming from checkpoint" in line for line in logs)

    def test_retry_reraises_on_the_last_attempt(self, tmp_path, monkeypatch):
        calls = {"n": 0}

        def broken(*a, **k):
            calls["n"] += 1
            raise RuntimeError("CUDA error (simulated)")

        monkeypatch.setattr(drv, "render_frame", broken)
        config = RenderConfig(scene="rtiow", width=8, height=4, spp=2,
                              checkpoint=str(tmp_path / "s.npz"))
        with pytest.raises(RuntimeError, match="simulated"):
            _run(config)
        assert calls["n"] == 3
        calls["n"] = 0
        with pytest.raises(RuntimeError, match="simulated"):
            _run(dataclasses.replace(config, checkpoint=None))
        assert calls["n"] == 1


def _c2(film, want_sum, want_depth):
    """C2's rule: at most 1% of pixels flip their path, every other
    pixel's sum within 5e-4.  A flipped path shows as another bounce
    count or, where the new path has as many bounces, as a sum further
    than 5e-4 away: both count."""
    flipped = film.depth_sum.numpy() != want_depth
    off = ~np.isclose(film.sum.numpy(), want_sum, rtol=5e-4,
                      atol=5e-4).all(-1)
    assert (flipped | off).sum() <= flipped.size // 100, (flipped.sum(),
                                                          off.sum())


def _config(tmp_path, tag, **kw):
    base = dict(scene="rtiow", width=32, height=18, spp=2, max_depth=4,
                samples_per_pass=2, output=str(tmp_path / f"{tag}.png"))
    base.update(kw)
    return base


def test_driver_film_matches_reference(tmp_path):
    kw = _config(tmp_path, "j", denoise=True, display_mode="denoise")
    want = JDRV.run(JC.RenderConfig(**kw), **QUIET)
    kw["output"] = str(tmp_path / "t.png")
    got = _run(RenderConfig(**kw))
    assert got.samples == int(want.samples) == 2
    _c2(got, np.asarray(want.sum), np.asarray(want.depth_sum))
    # The guides, against op-by-op JAX: compiled JAX's FMA contraction
    # moves the radius-1000 ground's normals by up to 1.7e-3 on 17 of
    # these 576 pixels (ROADMAP C19).
    from mrt.integrator.aov import albedo_normal_frame
    from mrt.scenes import get as jget

    js, jc = jget("rtiow")(aspect_ratio=32 / 18).generate()
    with jax.disable_jit():
        guides = albedo_normal_frame(js, jc, 32, 18, seed=1)
    for a, b in zip((got.albedo, got.normal), guides):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    assert load_png(kw["output"]).shape == (18, 32, 4)


def test_checkpoints_resume_across_packages(tmp_path):
    """JAX's driver writes 2 spp and the port's resumes to 4, and the
    reverse: the resumed film is exactly the resuming package's own
    render continued from the loaded checkpoint at the checkpoint's
    seed, and the final archive loads alike in both packages."""
    from mrt.runtime.render import render as jrender
    from mrt.scenes import get as jget
    from mrt_torch.runtime.render import render as trender
    from mrt_torch.scenes import get as tget

    for first, second in (("jax", "port"), ("port", "jax")):
        ckpt = str(tmp_path / f"{first}.npz")
        kw = _config(tmp_path, first, checkpoint=ckpt, seed=5)
        if first == "jax":
            JDRV.run(JC.RenderConfig(**kw), **QUIET)
        else:
            _run(RenderConfig(**kw))
        kw.update(spp=4, seed=1)    # the checkpoint's seed wins
        args = dict(spp=4, seed=5, max_depth=4, samples_per_pass=2,
                    persistent=True)
        if second == "port":
            loaded, _ = Film.load_state(ckpt, device="cpu")
            scene, camera = tget("rtiow")(aspect_ratio=32 / 18).generate(
                device="cpu")
            want = trender(scene, camera, 32, 18, film=loaded, **args)
            got = _run(RenderConfig(**kw))
            assert got.samples == 4
            assert torch.equal(got.sum, want.sum)
            assert torch.equal(got.depth_sum, want.depth_sum)
        else:
            loaded, _ = JFilm.load_state(ckpt)
            scene, camera = jget("rtiow")(aspect_ratio=32 / 18).generate()
            want = jrender(scene, camera, 32, 18, film=loaded, **args)
            got = JDRV.run(JC.RenderConfig(**kw), **QUIET)
            assert int(got.samples) == 4
            assert np.asarray(got.sum).tobytes() == np.asarray(
                want.sum).tobytes()
        jf, jseed = JFilm.load_state(ckpt)
        tf, tseed = Film.load_state(ckpt, device="cpu")
        assert jseed == tseed == 5 and tf.samples == int(jf.samples) == 4
        assert tf.sum.numpy().tobytes() == np.asarray(jf.sum).tobytes()
        assert (tf.depth_sum.numpy().tobytes()
                == np.asarray(jf.depth_sum).tobytes())


def test_config_file_and_flags(tmp_path):
    path = str(tmp_path / "c.json")
    RenderConfig(scene="cornell", width=12, height=8, spp=3, max_depth=3,
                 samples_per_pass=2, output=str(tmp_path / "c.png")).to_json(
        path)
    film = main(["--config", path, "--spp", "1", "--device", "cpu"])
    assert film.samples == 1 and (film.width, film.height) == (12, 8)
    film = main(["--config", path, "--device", "cpu", "--batched"])
    assert film.samples == 3
    assert load_png(str(tmp_path / "c.png")).shape == (8, 12, 4)


def test_profile_preview_and_nee(tmp_path, monkeypatch):
    exported = []
    real = drv.export
    monkeypatch.setattr(drv, "export",
                        lambda f, p, c: exported.append(f.samples)
                        or real(f, p, c))
    prof = str(tmp_path / "prof")
    film = _run(RenderConfig(**_config(
        tmp_path, "p", scene="cornell", width=12, height=8, spp=2,
        samples_per_pass=1, preview=True, nee=True, profile_dir=prof)))
    assert exported == [1, 2, 2]      # each pass, then the final export
    assert torch.isfinite(film.sum).all()
    with open(os.path.join(prof, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_unported_options_and_a_missing_card_raise(tmp_path, monkeypatch):
    # The mesh options render over torch.distributed ranks now: on one
    # process a 1x1 mesh renders the unsharded film, and a mesh that does
    # not fit the world raises, as JAX's make_mesh does with too few
    # devices.  A missing card still raises.  (The lane sorter is ported:
    # tests/test_torch_sort_entry.py renders with --sort-rays.)
    base = ["--width", "8", "--height", "4", "--spp", "2",
            "--samples-per-pass", "1", "--device", "cpu"]
    for flags in ([], ["--batched"]):
        films = [main(base + flags + extra + ["-o", str(tmp_path / name)])
                 for extra, name in (([], "plain.png"),
                                     (["--mesh-tile", "1"], "mesh.png"))]
        np.testing.assert_array_equal(films[1].depth_sum.numpy(),
                                      films[0].depth_sum.numpy())
        np.testing.assert_allclose(films[1].sum.numpy(),
                                   films[0].sum.numpy(), rtol=1e-6,
                                   atol=1e-7)
        assert films[1].samples == 2
    base = ["--width", "8", "--height", "4", "--spp", "1", "-o",
            str(tmp_path / "x.png")]
    for extra, shape in ((["--mesh-tile", "2"], "2x1"),
                         (["--mesh-spp", "2"], "0x2")):
        with pytest.raises(ValueError, match=f"mesh {shape} != 1 devices"):
            main(base + extra + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(base)
    from mrt_torch.runtime.viewer import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(RenderConfig(port=0), **QUIET)
    assert not os.path.exists(str(tmp_path / "x.png"))


def test_stats_match_reference():
    rs = np.random.default_rng(2)
    total = rs.random((6, 5, 3)).astype(np.float32)
    depth = rs.integers(0, 9, (6, 5)).astype(np.int32)
    import jax.numpy as jnp

    want = JP.stats_from_film(JFilm(sum=jnp.asarray(total),
                                    depth_sum=jnp.asarray(depth),
                                    samples=jnp.asarray(4, jnp.int32)), 0.5)
    got = TP.stats_from_film(Film(sum=torch.from_numpy(total),
                                  depth_sum=torch.from_numpy(depth),
                                  samples=4), 0.5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)
    timer = TP.Timer()
    assert timer.lap("a") >= 0 and "a" in timer.laps


def test_module_entry_point_in_a_subprocess(tmp_path):
    """``python -m mrt_torch --device cpu`` writes the PNG and imports no
    JAX, no mrt and no PIL."""
    out = str(tmp_path / "cli.png")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['mrt_torch', '--device', 'cpu', '--width', '20',\n"
        f"            '--height', '12', '--spp', '2', '--max-depth', '3',\n"
        f"            '--denoise', '-o', {out!r}]\n"
        "runpy.run_module('mrt_torch', run_name='__main__', alter_sys=True)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mrt', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert "wrote" in res.stdout
    assert Image.open(out).size == (20, 12)

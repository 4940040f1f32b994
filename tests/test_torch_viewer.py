"""The port's live viewer (``mrt_torch.runtime.viewer``) on the CPU: the
page, the frame stream, the display-mode keys, export, the quick-pass
abort and play mode's record and bit-identical replay, as
tests/test_viewer.py holds mrt's.  Each server takes a free port of its
own (tests run in parallel with mrt's, which binds fixed ports)."""

import dataclasses
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mrt_torch import scenes
from mrt_torch.runtime.config import RenderConfig
from mrt_torch.runtime.driver import render_frame
from mrt_torch.runtime.film import DisplayMode
from mrt_torch.runtime.input import InputReplay
from mrt_torch.runtime.io import decode_png, load_png
from mrt_torch.runtime.viewer import serve

torch.set_num_threads(2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read()


def _start(config):
    stop = threading.Event()
    t = threading.Thread(target=serve, args=(config,),
                         kwargs=dict(log=lambda *a: None, stop=stop,
                                     device="cpu"),
                         daemon=True)
    t.start()
    return stop, t


@pytest.fixture(scope="module")
def viewer(tmp_path_factory):
    out = tmp_path_factory.mktemp("viewer") / "live.png"
    config = RenderConfig(scene="rtiow", width=32, height=24, spp=8,
                          samples_per_pass=1, max_depth=4, seed=2,
                          serve=True, port=_free_port(), output=str(out))
    stop, t = _start(config)
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            if _get(config.port, "/status"):
                break
        except Exception:
            time.sleep(0.2)
    yield config
    # Stop the render loop between passes instead of killing it.
    stop.set()
    t.join(timeout=60)
    assert not t.is_alive()


def test_page_and_status(viewer):
    page = _get(viewer.port, "/").decode()
    assert "mrt" in page and "keydown" in page
    st = json.loads(_get(viewer.port, "/status"))
    assert st["mode"] == "default"


def test_frame_png_streams(viewer):
    deadline = time.time() + 120
    png = b""
    while time.time() < deadline:
        try:
            png = _get(viewer.port, "/frame.png")
            break
        except urllib.error.HTTPError:
            time.sleep(0.2)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert decode_png(png).shape == (24, 32, 4)


def test_runtime_display_mode_keys(viewer):
    _get(viewer.port, "/key?k=3")    # depth
    deadline = time.time() + 30
    while time.time() < deadline:
        st = json.loads(_get(viewer.port, "/status"))
        if st["mode"] == "depth":
            break
        time.sleep(0.2)
    assert st["mode"] == "depth"
    _get(viewer.port, "/key?k=1")


def test_export_key_writes_png(viewer):
    _get(viewer.port, "/key?k=e")
    deadline = time.time() + 60
    while time.time() < deadline:
        if os.path.exists(viewer.output):
            break
        time.sleep(0.2)
    assert os.path.exists(viewer.output)


def test_quick_pass_toggle(viewer):
    _get(viewer.port, "/key?k=%60")  # backtick
    deadline = time.time() + 120
    ok = False
    while time.time() < deadline:
        st = json.loads(_get(viewer.port, "/status"))
        if st["quick_pass"]:
            ok = True
            break
        time.sleep(0.2)
    assert ok
    _get(viewer.port, "/key?k=%60")  # toggle back; the render restarts
    deadline = time.time() + 120
    while time.time() < deadline:
        st = json.loads(_get(viewer.port, "/status"))
        if not st["quick_pass"]:
            break
        time.sleep(0.2)
    assert not st["quick_pass"]


def test_play_mode_records_and_replays_bit_identically(tmp_path):
    """A served play session responds to live keys, and its recording
    replays bit-identically."""
    rec = tmp_path / "played.bin"
    config = RenderConfig(scene="playground", width=48, height=27,
                          samples_per_frame=2, max_depth=3, seed=3,
                          serve=True, play=True, port=_free_port(),
                          write_input=str(rec),
                          output=str(tmp_path / "play.png"))
    stop, t = _start(config)

    def wait_frame(n, deadline_s=240):
        deadline = time.time() + deadline_s
        while time.time() < deadline:
            try:
                st = json.loads(_get(config.port, "/status"))
                if st.get("frame", -1) >= n:
                    return st
            except Exception:
                pass
            time.sleep(0.1)
        raise AssertionError(f"frame {n} never reached")

    wait_frame(1)
    _get(config.port, "/input?held=w")          # run forward
    wait_frame(4)
    _get(config.port, "/input?held=w,%20")      # and jump (space)
    wait_frame(7)
    _get(config.port, "/input?held=")           # release
    wait_frame(9)
    stop.set()
    t.join(timeout=120)
    assert not t.is_alive()

    assert rec.exists()
    replay = InputReplay(str(rec))
    frames = len(replay.frames)
    assert frames >= 10
    assert any(f.stick_y > 0 for f in replay.frames), "w never recorded"
    assert any(f.button_a for f in replay.frames), "jump never recorded"

    # The recording replayed through a fresh scene: its last frame equals
    # the last live frame (exported on shutdown) byte for byte.
    live = load_png(config.output)[..., :3]
    sc = scenes.get("playground")(aspect_ratio=config.aspect_ratio)
    fcfg = dataclasses.replace(config, spp=config.samples_per_frame)
    total = max(config.total_frames, 1)
    for frame in range(frames):
        scene, camera = sc.generate(frame / total, frame,
                                    replay.frame(frame), device="cpu")
    film = render_frame(scene, camera, fcfg)
    rgb = film.to_rgb_bytes(DisplayMode.DEFAULT)[::-1]
    np.testing.assert_array_equal(
        rgb, (live * 255.0).round().astype(np.uint8),
        err_msg="replayed final frame differs from the live one")

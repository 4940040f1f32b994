"""Multi-process rendering with the port: 2 CPU processes joined over TCP
by ``mrt_torch.parallel.init_distributed`` (gloo), meshes spanning both
processes, the gathered film equal to the single-process render (exact
depth counts; radiance to float accumulation order) — the counterpart
of tests/test_distributed.py."""

import socket

from test_torch_parallel import run_workers


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path):
    logs = run_workers(2, f"localhost:{_free_port()}", tmp_path, "dist")
    assert "DISTRIBUTED_OK" in logs[0], logs[0][-3000:]


def test_launcher_ranks_render_the_cli_film(tmp_path):
    # Two ranks as torchrun starts them (WORLD_SIZE, RANK, LOCAL_RANK,
    # MASTER_ADDR, MASTER_PORT): `python -m mrt_torch` joins their group
    # and renders over a (2, 1) mesh; rank 0 alone writes the PNG and the
    # checkpoint, which equal the single-process CLI's.
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [sys.executable, "-m", "mrt_torch", "--device", "cpu", "--width",
            "16", "--height", "8", "--spp", "2", "--samples-per-pass", "1",
            "--max-depth", "4", "--batched"]
    port = str(_free_port())
    procs = []
    for rank in range(2):
        out = tmp_path / f"rank{rank}"
        out.mkdir()
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            args + ["--mesh-tile", "2", "-o", str(out / "x.png"),
                    "--checkpoint", str(out / "x.npz")], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    single = tmp_path / "single.png"
    res = subprocess.run(args + ["-o", str(single)], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (tmp_path / "rank0" / "x.png").read_bytes() == single.read_bytes()
    assert (tmp_path / "rank0" / "x.npz").exists()
    assert not list((tmp_path / "rank1").iterdir())

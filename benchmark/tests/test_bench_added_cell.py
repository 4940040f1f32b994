"""A cell, a configuration with a scene new to the reference, a traffic
mix, a job kind and a per-layer metric added as new files and
BENCHMARK.json entries only, in a test's temporary folder, and run by
the harness unchanged."""

import json
import time

import torch

from benchmark.harness import runner

RECIPE = '''
"""Recipe ``two_spheres``: a glass ball over a ground sphere."""
from benchmark.reference import scenes, tracer


def scene(aspect, radius=0.5):
    mat = scenes.Materials()
    ground = mat.lambertian((0.5, 0.5, 0.5))
    glass = mat.dielectric(1.5)
    return dict(
        spheres=scenes.spheres([(0.0, -100.5, -1.0), (0.0, 0.0, -1.0)],
                               [100.0, radius], [ground, glass]),
        materials=mat.tables(), background=("sky", None),
        camera=scenes.camera(90.0, (0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                             (0.0, 1.0, 0.0), aspect, 0.0, 1.0),
        root="expanded")


def film_at(*args, **kwargs):
    """The plain tracer's: a scene that needed more would trace it here."""
    return tracer.film_at(*args, **kwargs)
'''

JOB = '''
"""A job kind that renders nothing on the program's side: it counts its
own jobs, and its check traces a few pixels of the configuration's scene
with the reference's recipe."""
import time

import torch

from benchmark.harness import window
from benchmark.reference import scenes, tracer


class State:
    seed = 0


def setup(cell, seed, dev):
    state = State()
    state.seed, state.pause = seed, cell.traffic["pause_s"]
    state.config, state.folders = cell.config, cell.spec.folders
    return state


def window(state, seconds, loop=window):
    done, secs, times = loop.closed_loop(lambda i: time.sleep(state.pause),
                                         seconds)
    return dict(values=dict(jobs_per_s=loop.rate(done, secs)),
                attempted=done, failed=0, job_seconds=times)


def traced(state):
    return dict(record=dict(jobs=3, launches=0, unplaced=0), busy_s=1.0, window_s=2.0,
                breakdown=dict(device_ops=[], idle_gaps=[]), attempted=3,
                failed=0)


def release(state):
    pass


def check(state):
    c = state.config
    scene = scenes.build(c, "cpu", folders=state.folders)
    film_at = scenes.own(c, "film_at", tracer.film_at, state.folders)
    rad, bounces = film_at(scene, torch.arange(6), 0, 2, state.seed,
                           c["width"], c["height"], c["max_depth"])
    sound = bool(torch.isfinite(rad).all()) and int(bounces.sum()) > 0
    return dict(error=0.0 if sound and len(scene["spheres"]["radius"]) == 2
                else 1.0)
'''


def test_a_cell_added_as_files_only(tiny):
    root = tiny.root
    bench = tiny.folders[0]
    data = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / data["configs"][0]["file"]).read_text())
    conf.update(name="rtiow_small", scene="two_spheres",
                scene_args=dict(radius=0.5), width=8, height=6, max_depth=4)
    (bench / "reference" / "recipes").mkdir(parents=True)
    (bench / "reference" / "recipes" / "two_spheres.py").write_text(RECIPE)
    (bench / "configs" / "rtiow_small.json").write_text(json.dumps(conf))
    (bench / "jobs").mkdir()
    (bench / "jobs" / "idle.py").write_text(JOB)
    (bench / "metrics").mkdir()
    (bench / "metrics" / "jobs_seen.idle.py").write_text(
        "def read(record):\n    return record['jobs']\n")
    (bench / "traffic" / "idle_loop.json").write_text(json.dumps(
        dict(kind="idle", pause_s=0.05)))
    (bench / "workloads" / "rtiow_small.idle_loop.json").write_text(
        json.dumps(dict(checks=dict(error=dict(limit=0.5)))))
    data["configs"].append(dict(
        name="rtiow_small", source="a test", reduced=[],
        file="benchmark/configs/rtiow_small.json", why="a test"))
    data["workloads"].append(dict(
        name="rtiow_small.idle_loop", config="rtiow_small",
        traffic="idle_loop", chips=1, why="a test"))
    data["end_to_end"].append(dict(
        name="jobs_per_s", unit="jobs/s", better="higher", bound=0.1,
        source="host_clock", workloads=["rtiow_small.idle_loop"]))
    data["per_layer"].append(dict(
        name="jobs_seen.idle", unit="jobs", better="higher",
        source="program_counter", layer="driver loop", moves="jobs_per_s",
        workloads=["rtiow_small.idle_loop"]))
    for m in data["end_to_end"]:
        if m["name"] == "camera_rays_per_s":
            m["workloads"] = [w["name"] for w in data["workloads"][:-1]]
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    spec = type(tiny)(root, tiny.folders)
    cell = spec.cell("rtiow_small.idle_loop")
    assert cell.config["name"] == "rtiow_small"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "jobs_per_s"]
    dev = torch.device("cpu")
    plain = runner.run_cell(cell, 7, 0.2, False, dev, time.time(), time.time)
    assert plain["correct"] and plain["attempted"] >= 4
    assert plain["checks"]["error"]["value"] == 0.0
    assert set(plain["metrics"]) == {"jobs_per_s", "setup_s"}
    traced = runner.run_cell(cell, 7, 0.2, True, dev, time.time(), time.time)
    assert traced["metrics"] == {"jobs_seen.idle": dict(value=3,
                                                        unit="jobs")}
    assert traced["device"]["busy_s"] == 1.0
    # The recipe is found in the test's folder, with its own film_at.
    from benchmark.reference import scenes, tracer

    film_at = scenes.own(cell.config, "film_at", tracer.film_at,
                         spec.folders)
    assert film_at.__module__ == "bench_reference_recipes_two_spheres"

"""The port's sharded-render cases, and the worker process that renders
them as one rank of a gloo group on the CPU.

    python tests/torch_parallel_worker.py RANK WORLD INIT OUT CASES

joins the group at INIT (``file://`` store or host:port), renders each
case of the named set (``CASES``) over its (tile, spp) mesh through
``mrt_torch.parallel``, and writes OUT/rank<RANK>.npz: per case the
gathered film and this rank's row-tile shape.  CASES ``dist`` is the
counterpart of tests/distributed_worker.py instead: ``render_sharded``
over meshes spanning both processes, held on rank 0 against the
single-process render, which then prints DISTRIBUTED_OK.  The scene
builders are the port's counterparts of tests/test_parallel.py's; the
tests import them to render the same scenes in one process.  Imports no
JAX.
"""

import os
import sys

import numpy as np

# (name, scene, integrator, tile, spp, samples, depth, seed): the
# 3-sphere scene at 16x16, spp 8, depth 6, seed 7 through both passes;
# the hard paths (TLAS, menger level 2 voxels, alpha cut-out quads) at
# spp 8 (persistent: 4), depth 5, seed 3 (tests/test_parallel.py).
SPHERES = dict(scene="spheres", samples=8, depth=6, seed=7)


def _hard(scene, integrator):
    return dict(scene=scene, samples=8 if integrator == "wavefront" else 4,
                depth=5, seed=3)


def _cases(meshes, hard_wavefront, hard_persistent):
    out = []
    for tile, spp in meshes:
        for integrator in ("wavefront", "persistent"):
            out.append(dict(SPHERES, integrator=integrator, tile=tile,
                            spp=spp))
    for integrator, meshes_hard in (("wavefront", hard_wavefront),
                                    ("persistent", hard_persistent)):
        for tile, spp in meshes_hard:
            for scene in ("tlas", "voxel", "alpha"):
                out.append(dict(_hard(scene, integrator),
                                integrator=integrator, tile=tile, spp=spp))
    for c in out:
        c["name"] = (f"{c['scene']}-{c['integrator']}-{c['tile']}x"
                     f"{c['spp']}")
    return out


CASES = {
    4: _cases([(4, 1), (2, 2), (1, 4)], [(4, 1), (1, 4)], [(2, 2)]),
    2: _cases([(2, 1), (1, 2)], [(2, 1)], [(1, 2)]),
}
SIZE = 16


def sphere_scene(device="cpu"):
    from mrt_torch.core.camera import Camera
    from mrt_torch.geometry.scene import SceneBuilder
    from mrt_torch.materials.background import SkyBackground
    from mrt_torch.materials.table import MaterialBuilder

    b = MaterialBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    metal = b.metal(0.1, (0.8, 0.7, 0.6))
    glass = b.dielectric(1.5)
    sb = SceneBuilder(b, SkyBackground.create())
    sb.add_sphere((0, -100.5, -1), 100.0, ground)
    sb.add_sphere((-0.6, 0, -1.5), 0.5, metal)
    sb.add_sphere((0.6, 0, -1.5), 0.5, glass)
    camera = Camera.create(60.0, (0, 0.3, 1), (0, 0, -1.5), (0, 1, 0),
                           aspect_ratio=1.0)
    return sb.build(device), camera.to(device)


def _tlas_scene(device):
    from mrt_torch.geometry.scene import SceneBuilder
    from mrt_torch.geometry.shapes import cube, sphere_mesh
    from mrt_torch.materials.background import SkyBackground
    from mrt_torch.materials.table import MaterialBuilder

    b = MaterialBuilder()
    red = b.lambertian((0.7, 0.2, 0.2))
    metal = b.metal(0.05, (0.8, 0.8, 0.9))
    sb = SceneBuilder(b, SkyBackground.create())
    mc = sb.add_mesh(cube(size=1.0, material=red))
    ms = sb.add_mesh(sphere_mesh(radius=0.55, lat=6, lon=8, material=metal))
    for i in range(3):
        sb.add_instance(mc, translation=(i * 1.5 - 1.5, 0.0, -2.0),
                        rotation=(0.0, 0.08 * i, 0.0))
        sb.add_instance(ms, translation=(i * 1.5 - 1.5, 1.2, -2.0),
                        scale=1.0 + 0.2 * i)
    return sb.build(device)


def _alpha_scene(device):
    from mrt_torch.geometry.scene import SceneBuilder
    from mrt_torch.geometry.shapes import quad
    from mrt_torch.materials.background import SkyBackground
    from mrt_torch.materials.table import MaterialBuilder
    from mrt_torch.textures.atlas import CLAMP, AtlasBuilder

    atlas = AtlasBuilder()
    px = np.zeros((4, 4, 4), np.float32)
    px[..., 0] = 0.8
    px[..., 1] = 0.4
    px[:, 2:, 3] = 1.0
    tex = atlas.add_raw(np.moveaxis(px, -1, 0), wrap=CLAMP)
    b = MaterialBuilder()
    front = b.lambertian(tex=tex)
    back = b.lambertian((0.1, 0.2, 0.8))
    sb = SceneBuilder(b, SkyBackground.create(), atlas=atlas.build())
    sb.add_triangles(quad((-2.0, -2.0, -3.0), (4.0, 0.0, 0.0),
                          (0.0, 4.0, 0.0), material=front))
    sb.add_triangles(quad((-2.0, -2.0, -5.0), (4.0, 0.0, 0.0),
                          (0.0, 4.0, 0.0), material=back))
    scene = sb.build(device)
    assert scene.needs_alpha
    return scene


def build(name, device="cpu"):
    """(scene, camera) of a case's scene, on `device`."""
    from mrt_torch.core.camera import Camera
    from mrt_torch.scenes import get

    if name == "spheres":
        return sphere_scene(device)
    if name == "voxel":
        scene, camera = get("menger")(aspect_ratio=1.0, level=2).generate(
            device=device)
        assert scene.voxels
        return scene, camera
    if name == "alpha":
        camera = Camera.create(60.0, (0, 0, 1.5), (0, 0, -3), (0, 1, 0),
                               aspect_ratio=1.0)
        return _alpha_scene(device), camera.to(device)
    camera = Camera.create(60.0, (0, 0.6, 2.5), (0, 0.3, -2), (0, 1, 0),
                           aspect_ratio=1.0)
    return _tlas_scene(device), camera.to(device)


def render_case(case, mesh):
    """The case's sharded pass on `mesh`: (the gathered film, this rank's
    row tile)."""
    from mrt_torch.parallel import (gather_film, render_pass_sharded,
                                    render_pass_sharded_persistent,
                                    shard_film)
    from mrt_torch.runtime.film import Film

    scene, camera = build(case["scene"], mesh.device)
    fn = (render_pass_sharded_persistent
          if case["integrator"] == "persistent" else render_pass_sharded)
    shard = shard_film(Film.create(SIZE, SIZE, device=mesh.device), mesh)
    shard = fn(scene, camera, shard, case["seed"], 0, width=SIZE,
               height=SIZE, samples=case["samples"],
               max_depth=case["depth"], mesh=mesh)
    return gather_film(shard, mesh), shard


def distributed(rank):
    """tests/distributed_worker.py's scene at 32x32, spp 4 in passes of
    2, depth 6, seed 3, over meshes (2, 1) and (1, 2) of the 2 ranks,
    both integrators: the gathered film on rank 0 equal to the
    single-process render (depth exact, radiance 1e-5)."""
    from mrt_torch.core.camera import Camera
    from mrt_torch.geometry.scene import SceneBuilder
    from mrt_torch.materials.background import SkyBackground
    from mrt_torch.materials.table import MaterialBuilder
    from mrt_torch.parallel import make_mesh, render_sharded
    from mrt_torch.runtime.render import render

    mat = MaterialBuilder()
    ground = mat.lambertian((0.5, 0.5, 0.5))
    metal = mat.metal(0.2, (0.8, 0.7, 0.6))
    glass = mat.dielectric(1.5)
    sb = SceneBuilder(mat, SkyBackground.create())
    sb.add_sphere((0, -100.5, -1), 100.0, ground)
    sb.add_sphere((0, 0, -1), 0.5, metal)
    sb.add_sphere((-1.1, 0, -1), 0.5, glass)
    scene = sb.build("cpu")
    camera = Camera.create(60.0, (0, 0.5, 2), (0, 0, -1), (0, 1, 0), 1.0,
                           focus_distance=3.0)
    kw = dict(spp=4, seed=3, max_depth=6, samples_per_pass=2)
    for persistent in (False, True):
        single = render(scene, camera, 32, 32, persistent=persistent, **kw)
        for tile, spp in ((2, 1), (1, 2)):
            mesh = make_mesh(tile=tile, spp=spp, device="cpu")
            film = render_sharded(scene, camera, 32, 32, mesh,
                                  persistent=persistent, **kw)
            if rank == 0:
                np.testing.assert_array_equal(film.depth_sum.numpy(),
                                              single.depth_sum.numpy())
                np.testing.assert_allclose(film.sum.numpy(),
                                           single.sum.numpy(), rtol=1e-5,
                                           atol=1e-5)
                assert film.samples == 4
    if rank == 0:
        print("DISTRIBUTED_OK", flush=True)


def main(rank, world, init, out, cases):
    import torch

    torch.set_num_threads(1)
    from mrt_torch.parallel import init_distributed, make_mesh

    init_distributed(init, num_processes=world, process_id=rank,
                     backend="gloo", device="cpu", timeout=120)
    if cases == "dist":
        distributed(rank)
        torch.distributed.destroy_process_group()
        return
    arrays = {}
    for case in CASES[int(cases)]:
        mesh = make_mesh(tile=case["tile"], spp=case["spp"], device="cpu")
        film, shard = render_case(case, mesh)
        arrays[case["name"] + "/sum"] = film.sum.numpy()
        arrays[case["name"] + "/depth"] = film.depth_sum.numpy()
        arrays[case["name"] + "/samples"] = np.asarray(film.samples)
        arrays[case["name"] + "/shard"] = np.asarray(shard.sum.shape)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])

"""Recipe ``rtiow``: Shirley's final scene with the port's seeded layout
(a frozen copy of ``mrt_torch/scenes/rtiow.py``)."""

import numpy as np

from benchmark.reference.scenes import Materials, camera, spheres


def scene(aspect, seed=1, grid=11):
    rng = np.random.default_rng(seed)
    mat = Materials()
    centers, radii, mats = [], [], []

    def add(c, r, m):
        centers.append(c)
        radii.append(r)
        mats.append(m)

    add((0.0, -1000.0, 0.0), 1000.0, mat.lambertian((0.5, 0.5, 0.5)))
    for a in range(-grid, grid):
        for b in range(-grid, grid):
            c = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.subtract(c, (4, 0.2, 0))) <= 0.9:
                continue
            choose = rng.random()
            if choose < 0.8:
                add(c, 0.2, mat.lambertian(tuple(rng.random(3)
                                                 * rng.random(3))))
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                add(c, 0.2, mat.metal(0.5 * rng.random(), tuple(albedo)))
            else:
                add(c, 0.2, mat.dielectric(1.5))
    add((0.0, 1.0, 0.0), 1.0, mat.dielectric(1.5))
    add((-4.0, 1.0, 0.0), 1.0, mat.lambertian((0.4, 0.2, 0.1)))
    add((4.0, 1.0, 0.0), 1.0, mat.metal(0.0, (0.7, 0.6, 0.5)))
    return dict(
        spheres=spheres(centers, radii, mats), materials=mat.tables(),
        background=("sky", None),
        camera=camera(20.0, (13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                      (0.0, 1.0, 0.0), aspect, 0.1, 10.0),
        # The port builds this scene without a BVH, whatever its size.
        root="expanded")

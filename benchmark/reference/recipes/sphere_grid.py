"""Recipe ``sphere_grid``: upstream's hex-packed grid on a white cube
ground, black sky (a frozen copy of ``mrt_torch/scenes/sphere_grid.py``)."""

import numpy as np
import torch

from benchmark.reference.scenes import (SPHERE_BVH_THRESHOLD, Materials,
                                        camera, cube_instance, spheres)


def scene(aspect, dim=50, seed=1):
    rng = np.random.default_rng(seed)
    mat = Materials()
    white = mat.lambertian((1.0, 1.0, 1.0))
    light = mat.diffuse_light((3.0, 3.0, 3.0))
    glass = mat.dielectric(1.8)
    r, d = 1.0, 2.0
    a = np.sqrt(d * d - r * r)
    ring = {(-1, 0), (1, 0), (1, -1), (0, -1), (1, 1), (0, 1)}
    centers, radii, mats = [], [], []
    for i in range(-dim, dim):
        for j in range(-dim, dim):
            off = r if j % 2 == 0 else 0.0
            centers.append((i * d + off, r, j * a))
            radii.append(r - 0.05)
            if (i, j) == (0, 0):
                mats.append(light)
            elif (i, j) in ring:
                mats.append(glass)
            else:
                mats.append(mat.metal(0.0, tuple(rng.random(3))))
    eye = (6.0, 8.0, 5.0)
    return dict(
        spheres=spheres(centers, radii, mats), materials=mat.tables(),
        ground=cube_instance((0.0, -1000.0, 0.0), 1000.0, 2.0, white),
        background=("solid", torch.zeros(3)),
        camera=camera(40.0, eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), aspect,
                      0.0, float(np.linalg.norm(eye))),
        root="offset" if len(radii) >= SPHERE_BVH_THRESHOLD else "expanded")

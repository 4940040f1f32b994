"""The JAX side of tests/test_torch_mesh_scenes.py and
tests/test_torch_lucy.py, run in a fresh process:

    python tests/torch_mesh_jax.py <scene> <out.npz> [<part> ...]

For scene "lucy" or "playground" (aspect 1) it writes these parts (all
three if none is named):
  - "two_level": the compiled JAX render at the golden settings (24x24,
    spp 8, depth 6, seed 5) on the two-level route ("two_level_sum",
    "two_level_depth");
  - "flat": the same with MRT_TLAS_KERNEL=flat ("flat_sum",
    "flat_depth": the single flat set on playground, the flat parts on
    lucy);
  - "hits": RAYS camera rays of the flat scene ("o", "d") and, through
    the compiled flat route, their winners ("t", "tri", "u", "v"; flat
    parts give the (instance, triangle) pair as "inst", "tri") and Hits
    ("hit", "point", "normal", "material", "front_face").

A fresh process because two routes of one scene pytree would share one
jit-cache entry (the route is read while tracing), and because a long
test process holding hundreds of compiled programs has aborted XLA's CPU
compiler on the flat-parts render (tests/test_tlas_flat.py).
"""

import os
import sys

import numpy as np

RAYS = 1024
SIZE, SPP, DEPTH, SEED = 24, 8, 6, 5


def _render(scene, camera):
    from mrt.runtime.render import render

    film = render(scene, camera, SIZE, SIZE, spp=SPP, max_depth=DEPTH,
                  seed=SEED)
    return np.asarray(film.sum), np.asarray(film.depth_sum)


def main(name, out, parts=("two_level", "flat", "hits")):
    import jax
    import jax.numpy as jnp

    from mrt.geometry import bvh as JB
    from mrt.geometry import instance as JI
    from mrt.scenes import get

    os.environ.pop("MRT_TLAS_KERNEL", None)
    os.environ.pop("MRT_FLAT_SPLIT", None)
    res = {}
    if "two_level" in parts:
        scene, camera = get(name)(aspect_ratio=1.0).generate()
        # Without its flat tables (two-level either way, the variable
        # unset), so that the flat scene below is another pytree and
        # traces anew.
        scene = scene.replace(tlas=scene.tlas.replace(flat_tris=None,
                                                      flat_bvh=None))
        res["two_level_sum"], res["two_level_depth"] = _render(scene, camera)

    os.environ["MRT_TLAS_KERNEL"] = "flat"
    scene, camera = get(name)(aspect_ratio=1.0).generate()
    tlas = scene.tlas
    if "flat" in parts:
        res["flat_sum"], res["flat_depth"] = _render(scene, camera)
    if "hits" not in parts:
        np.savez(out, **res)
        return

    rs = np.random.default_rng(7)
    s, t = jnp.asarray(rs.uniform(0, 1, (2, RAYS)).astype(np.float32))
    z = jnp.zeros(RAYS)
    o, d = camera.rays(s, t, z, z)
    if tlas.flat_tris is None:
        def route(tlas, o, d):
            got = {}
            expand = JI.expand_winner

            def spy(tlas, o, d, *winners):
                got["w"] = winners
                return expand(tlas, o, d, *winners)

            JI.expand_winner = spy
            try:
                hits = JI.intersect_tlas_flat_parts(tlas, o, d, 1e-3, jnp.inf,
                                                    use_pallas=False)
            finally:
                JI.expand_winner = expand
            return hits, got["w"]

        hits, (bt, inst, tri, u, v) = jax.jit(route)(tlas, o, d)
        res["inst"] = inst
    else:
        def route(tris, bvh, o, d):
            winners = JB.intersect_bvh_tris(tris, bvh, o, d, 1e-3, jnp.inf)
            from mrt.geometry.triangles import make_hits
            return make_hits(tris, o, d, *winners), winners

        hits, (bt, tri, u, v) = jax.jit(route)(tlas.flat_tris, tlas.flat_bvh,
                                               o, d)
    res.update(o=o, d=d, t=bt, tri=tri, u=u, v=v, hit=hits.hit,
               point=hits.point, normal=hits.normal,
               material=hits.material, front_face=hits.front_face)
    np.savez(out, **{k: np.asarray(x) for k, x in res.items()})


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], sys.argv[2], *([sys.argv[3:]] if sys.argv[3:] else []))

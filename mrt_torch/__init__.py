"""mrt_torch — the mrt path tracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``mrt``'s layout and names; ``mrt`` (JAX) is the
reference it is tested against.  Nothing here imports JAX or ``mrt``.

Layout:
    mrt_torch.math        counter-based RNG, vector math, sampling, m4
    mrt_torch.core        camera, the entry points' default device,
                          replace() and the gradient path's checks
    mrt_torch.geometry    hit records, spheres, triangles, BVHs,
                          instances (TLAS and its world-flattened
                          tables), voxel grids, volumes, the scene and
                          its builder
    mrt_torch.loaders     OBJ + MTL, PLY and STL mesh loaders
    mrt_torch.materials   material table, shading, backgrounds, lights
    mrt_torch.scenes      scene registry (rtiow, cornell, sphere_grid,
                          lucy, playground, eve, menger)
    mrt_torch.integrator  wavefront and persistent integrators, the AOV
                          (albedo/normal) pre-pass (integrator.aov)
    mrt_torch.inverse     differentiable renders, losses, optimize
    mrt_torch.runtime     film and display modes, render, asset lookup,
                          input record/replay, character physics;
                          runtime.io (PNG codec without PIL),
                          runtime.config, runtime.driver, runtime.viewer
                          (the live HTTP viewer), runtime.denoise (the
                          à-trous filter)
    mrt_torch.parallel    (tile, spp) meshes over torch.distributed
                          ranks, sharded rendering
    mrt_torch.utils       profiling: the tracer (counters, reads from the
                          device by site and one record a pass, gradient
                          step, scene build or library load, always on;
                          spans inside tracing(), which --profile-dir
                          writes beside its torch.profiler trace),
                          render stats, timers
    mrt_torch.__main__    ``python -m mrt_torch``: mrt's CLI and --device
    mrt_torch.ops         kernel wrappers and their plain versions
    mrt_torch.csrc        CUDA sources, built with nvcc at first use
    mrt_torch.convert     numpy parameters -> port modules
    mrt_torch.profile     step profile of one pass on the card
    mrt_torch.tools       hardware probes (probe_stream: P1-P3)

Scene, materials and camera are ``nn.Module``s holding buffers, so
``.to(device)`` moves them.  Scene factories, ``Film.create`` and the
entry points (``run``, ``serve``, ``main``) build on the CUDA card
unless given ``device="cpu"``.  Every random number is the counter-based
PCG4D of ``mrt_torch.math.rng``; there is no global RNG state.
"""

__version__ = "0.1.0"

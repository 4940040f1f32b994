"""Kernel wrappers and their plain PyTorch versions.

B1 ``spheres.nearest_t`` (csrc/spheres.cu), B2 ``deposit.deposit`` and
B4 ``deposit.deposit_pending`` (csrc/deposit.cu), B3 ``gather.gather``
(csrc/gather.cu), B5 ``bvh.sphere_bvh_hit``, B6 ``bvh.tri_bvh_hit`` and
B7 ``bvh.tlas_hit`` (csrc/bvh.cu); the lane sorter's S1
``sort.sort_keys`` and S2 ``sort.permute_lanes`` (csrc/sort.cu); the
sampler's draw R1 ``rng.pcg4d_draw`` (csrc/rng.cu); L3 shading's M1
``shade.shade_lanes`` (csrc/shade.cu); L2's hit record H1
``hits.hit_record`` (csrc/hits.cu).  ``compact`` packs masked lanes
through B2 and B3.  ``budget`` is the JAX package's table budget, kept
as a routing rule.

One rule for all twelve: after its argument checks, a wrapper runs its
plain version on CPU tensors, launches its kernel on CUDA tensors (no
fallback) and raises on any other device.  ``_build`` declares every
kernel in one table (``KERNELS``: C entry, argument types, device name),
builds the library at first use, launches and counts each launch by id
in the tracer (``utils.profiling.launch_counts``).  Adding a kernel
takes a ``csrc`` file, a row of that table and a wrapper.
"""

from . import (bvh, compact, deposit, gather, hits, rng,  # noqa: F401
               shade, sort, spheres)

"""Kernel wrappers and their plain PyTorch versions.

B1 ``spheres.nearest_t`` (csrc/spheres.cu), B2 ``deposit.deposit`` and
B4 ``deposit.deposit_pending`` (csrc/deposit.cu), B3 ``gather.gather``
(csrc/gather.cu), B5
``bvh.sphere_bvh_hit``, B6 ``bvh.tri_bvh_hit`` and B7 ``bvh.tlas_hit``
(csrc/bvh.cu); the lane sorter's S1 ``sort.sort_keys`` and S2
``sort.permute_lanes`` (csrc/sort.cu); the sampler's draw R1
``rng.pcg4d_draw`` (csrc/rng.cu), which takes CUDA tensors only (the
CPU draws through ``math/rng.py``); L3 shading's M1
``shade.shade_lanes`` (csrc/shade.cu), CUDA tensors only too (elsewhere
``materials.shade.shade_hit`` runs its eager composition).  ``compact``
packs masked lanes through B2 and B3.  ``budget`` is the JAX package's table budget, kept
as a routing rule.
On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches its kernel, built by ``_build`` at first use.
"""

from . import (bvh, compact, deposit, gather, rng, shade, sort,  # noqa: F401
               spheres)

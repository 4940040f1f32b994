"""The JAX package's table budget, kept as a routing rule (mirrors
``mrt.ops.budget``).

The TPU kernels held their tables in 448 KB of SMEM, and the reference
builds the world-flattened tables of a TLAS only where they fit
(``instance.MeshRegistry._build_flat`` / ``_build_flat_parts``), and
sorts the lanes of every pass through a TLAS past it
(``geometry.scene.Scene.prefers_sorted_rays``).  On the card the tables
sit in global memory at any size, so this budget bounds nothing here.
It still decides whether those tables exist, and so which route a ray
takes, and whether the auto rule sorts: without it the two packages
would render the same scene differently.  The byte costs are the TPU
kernels' table layouts.
"""

from __future__ import annotations

SMEM_TABLE_BUDGET = 448 * 1024

SPHERE_NODE_BYTES = 48  # nodes (8, M) f32 + meta (4, M) i32
SPHERE_BYTES = 16       # spheres (4, S) f32
TRI_NODE_BYTES = 48     # as the sphere kernel's nodes
TRI_BYTES = 36          # tris (9, T) f32
TLAS_NODE_BYTES = 44    # tnodes (8, Mt) f32 + tmeta (3, Mt) i32
INSTANCE_BYTES = 56     # inst (12, I) f32 + imeta (2, I) i32


def tri_tables_bytes(n_nodes: int, n_tris: int) -> int:
    return n_nodes * TRI_NODE_BYTES + n_tris * TRI_BYTES


def tlas_group_bytes(tlas) -> dict:
    """The table bytes of each group of a TLAS (``geometry.instance.TLAS``):
    its nodes, instances, BLAS nodes and triangles."""
    return dict(
        tlas=tlas.n_tlas_nodes * TLAS_NODE_BYTES,
        inst=tlas.transform.shape[0] * INSTANCE_BYTES,
        blas=tlas.bnodes.shape[0] * TRI_NODE_BYTES,
        tri=tlas.tris.shape[0] * TRI_BYTES,
    )


def tlas_tables_bytes(tlas) -> int:
    return sum(tlas_group_bytes(tlas).values())


def fits(total_bytes: int) -> bool:
    return total_bytes < SMEM_TABLE_BUDGET

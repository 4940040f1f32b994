"""The JAX package's table budget, kept as a routing rule (mirrors
``tri_tables_bytes`` and ``fits`` of ``mrt.ops.budget``).

The TPU kernels held their tables in 448 KB of SMEM, and the reference
builds the world-flattened tables of a TLAS only where they fit
(``instance.MeshRegistry._build_flat`` / ``_build_flat_parts``).  On the
card the tables sit in global memory at any size, so this budget bounds
nothing here.  It still decides whether those tables exist, and so which
route a ray takes: without it the two packages would route the same
scene differently.
"""

from __future__ import annotations

SMEM_TABLE_BUDGET = 448 * 1024

TRI_NODE_BYTES = 48   # nodes (8, M) f32 + meta (4, M) i32
TRI_BYTES = 36        # tris (9, T) f32


def tri_tables_bytes(n_nodes: int, n_tris: int) -> int:
    return n_nodes * TRI_NODE_BYTES + n_tris * TRI_BYTES


def fits(total_bytes: int) -> bool:
    return total_bytes < SMEM_TABLE_BUDGET

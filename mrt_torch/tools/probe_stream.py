"""Probes P1-P3 of on-chip table residency on the card (mirrors
``tools/probe_stream.py``, whose TPU probes asked the same of SMEM).

    python -m mrt_torch.tools.probe_stream

P1 (``probe_a``) pages four 256-column slices of an (8, 1024) f32 and a
(2, 1024) i32 table into shared memory, all four in flight at once as
bulk asynchronous copies, each page behind its own mbarrier, and sums
one element of each; its four timings are the pages' arrival times;
P2 (``probe_b``) walks a 1,024-entry chain through a 2-slot shared-memory
page cache filled by Hopper's bulk asynchronous copy behind an mbarrier,
and also through L2 and through a shared-memory copy of the whole chain,
timing each dependent step; P3 (``probe_c``) asks for a
dynamic shared buffer of `kb` KB, writes its first and last word and
returns 3x, or reports the refusal past the card's opt-in limit (the
kernel's shared-memory attribute is raised once a device and process,
to that limit, so a call is one launch).  The
kernels are ``csrc/probe_stream.cu``; each wrapper runs its plain
PyTorch version on CPU tensors.

``main`` checks every probe against its plain version and prints one
line a probe and a JSON line; it needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops import _build
from ..utils import profiling

PAGE = 256
# Chain length of P2 (four pages).
CHAIN = 4 * PAGE
# P3's sizes: the card's own, up to the H100's 227 KB opt-in limit, and
# one past it.
P3_KB = (48, 100, 164, 227, 228)


def tables(device):
    """P1's inputs, as the TPU probe makes them: f (8, 1024) f32 and i
    (2, 1024) i32, each arange."""
    f = torch.arange(8 * 4 * PAGE, dtype=torch.float32).reshape(8, 4 * PAGE)
    i = torch.arange(2 * 4 * PAGE, dtype=torch.int32).reshape(2, 4 * PAGE)
    return f.to(device), i.to(device)


def closed_form():
    """P1's expected sum (``tools/probe_stream.py:49``)."""
    f, i = tables("cpu")
    return float(sum(f[1, k * PAGE + 7] + i[0, k * PAGE + 3]
                     for k in range(4)))


def probe_a_plain(f, i):
    """The indexed sum: (acc + f[1, 256k + 7]) + i[0, 256k + 3] over k,
    in float32, as (1,)."""
    acc = torch.zeros((1,), dtype=torch.float32, device=f.device)
    for k in range(4):
        acc = acc + f[1, k * PAGE + 7] + i[0, k * PAGE + 3].to(torch.float32)
    return acc


def probe_a(f, i):
    """(sum (1,) f32, arrival of each page (4,) int64 or None on the
    CPU): the SM cycles from one start, just before the first copy, to
    page k's barrier completing, with all four pages in flight.  f is
    float32 and i int32 on any device; on the card both contiguous with
    16-byte aligned data (every row of a page moves as one bulk copy,
    which takes 16-byte aligned ends)."""
    if f.dtype != torch.float32 or i.dtype != torch.int32:
        raise TypeError(f"probe_a: f {f.dtype}, i {i.dtype}, not float32 "
                        "and int32")
    if f.shape != (8, 4 * PAGE) or i.shape != (2, 4 * PAGE):
        raise ValueError(f"probe_a: f {tuple(f.shape)}, i {tuple(i.shape)}")
    if f.device.type == "cpu":
        return probe_a_plain(f, i), None
    if f.device.type != "cuda" or i.device != f.device:
        raise ValueError(f"probe_a: no kernel for f on {f.device}, i on "
                         f"{i.device}")
    for name, x in (("f", f), ("i", i)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"probe_a: {name} is not contiguous and 16-byte "
                             "aligned (a page's rows move as bulk copies)")
    out = torch.empty((1,), dtype=torch.float32, device=f.device)
    cycles = torch.empty((4,), dtype=torch.int64, device=f.device)
    _build.launch("mrt_probe_a", f.device, f, i, out, cycles)
    return out, cycles


def chain(n=CHAIN, seed=0):
    """P2's input as the TPU probe makes it: a random permutation of n
    entries as a linked chain from entry 0, the last pointing to -1."""
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    perm = np.roll(perm, -int(np.where(perm == 0)[0][0]))
    nxt = np.full((n,), -1, np.int32)
    nxt[perm[:-1]] = perm[1:]
    return nxt


def probe_b_plain(chain_t):
    """A Python walk of the chain: the entries visited, as (1,) int32."""
    c = chain_t.tolist()
    e = visited = 0
    while e >= 0:
        e = c[e]
        visited += 1
    return torch.tensor([visited], dtype=torch.int32)


def paged_misses(chain_t):
    """The page fills of P2's paged walk, the plain version of the count
    its kernel returns: its 2-slot cache of PAGE-entry pages (tags,
    round-robin victim) run in Python over the chain."""
    c = chain_t.tolist()
    tags, victim, misses, e = [-1, -1], 0, 0, 0
    while e >= 0:
        if e // PAGE not in tags:
            tags[victim] = e // PAGE
            victim ^= 1
            misses += 1
        e = c[e]
    return misses


# P2's variants: the paged 2-slot cache, L2 directly, shared memory.
VARIANTS = ("paged", "l2", "shared")


def probe_b(chain_t, variant="paged"):
    """(visited (1,) int32, SM cycles of the walk (1,) int64, None on
    the CPU; page fills (1,) int32, 0 but for the paged walk).  The chain
    is whole pages of PAGE entries; on the card its data must be 16-byte
    aligned (the paged walk copies a page with one bulk copy, which takes
    16-byte aligned ends)."""
    if chain_t.dtype != torch.int32 or chain_t.dim() != 1:
        raise TypeError(f"probe_b: chain {chain_t.dtype} "
                        f"{tuple(chain_t.shape)}, not int32 (n,)")
    if chain_t.shape[0] % PAGE:
        raise ValueError(f"probe_b: a chain of {chain_t.shape[0]} entries "
                         f"is not whole pages of {PAGE}")
    if chain_t.device.type == "cpu":
        fills = paged_misses(chain_t) if variant == "paged" else 0
        return (probe_b_plain(chain_t), None,
                torch.tensor([fills], dtype=torch.int32))
    if chain_t.device.type != "cuda":
        raise ValueError(f"probe_b: no kernel for device {chain_t.device}")
    chain_t = chain_t.contiguous()
    if chain_t.data_ptr() % 16:
        raise ValueError("probe_b: chain is not 16-byte aligned (a page "
                         "moves as one bulk copy)")
    visited = torch.empty((1,), dtype=torch.int32, device=chain_t.device)
    fills = torch.empty((1,), dtype=torch.int32, device=chain_t.device)
    cycles = torch.empty((1,), dtype=torch.int64, device=chain_t.device)
    _build.launch("mrt_probe_b", chain_t.device, chain_t, chain_t.shape[0],
                  VARIANTS.index(variant), visited, fills, cycles)
    return visited, cycles, fills


def probe_c_plain(x):
    return 3.0 * x


def probe_c(x, kb):
    """(3x (1,), None) with a dynamic shared buffer of `kb` KB, or
    (None, (attribute code, launch code)) where the card refused it: the
    answer to raising the kernel's attribute to the opt-in limit (once a
    device and process, at the first call) and this launch's.  On the
    CPU, the plain version."""
    if x.device.type == "cpu":
        return probe_c_plain(x), None
    out = torch.zeros((1,), dtype=torch.float32, device=x.device)
    codes = torch.zeros((2,), dtype=torch.int32)
    _build.launch("mrt_probe_c", x.device, x.contiguous(), out, kb * 1024,
                  codes)
    if codes.any():
        profiling.launch_counts["P3"] -= 1  # refused: no kernel ran
        return None, tuple(codes.tolist())
    return out, None


def attributes(device):
    """(the opt-in shared memory a block may have in bytes, the SM clock
    rate in kHz), as the CUDA runtime reports them."""
    smem, khz = torch.zeros((1,), dtype=torch.int32), torch.zeros(
        (1,), dtype=torch.int32)
    _build.launch("mrt_probe_attributes", device, smem, khz)
    return int(smem), int(khz)


def error_name(code):
    return _build.library().mrt_error_string(code).decode()


def run(device):
    """Every probe on the card against its plain version; returns a dict
    of results.  Raises where a result is wrong: P1 off its closed form
    or its page arrivals not positive and in page order, P2 not visiting
    every entry or its page fills off the cache's plain model, P3 refused
    at or below the opt-in limit or accepted past it, its sizes asked
    largest first, then smallest first."""
    smem_optin, khz = attributes(device)
    ns = lambda cycles: cycles / khz * 1e6  # SM cycles -> ns

    f, i = tables(device)
    got, cycles = probe_a(f, i)
    want = closed_form()
    if got.item() != want or probe_a_plain(f, i).item() != want:
        raise RuntimeError(f"P1: {got.item()}, closed form {want}")
    arrivals = cycles.tolist()
    if arrivals[0] <= 0 or arrivals != sorted(arrivals):
        raise RuntimeError(f"P1: page arrivals {arrivals} cycles, not "
                           "positive and in page order")

    c = torch.from_numpy(chain()).to(device)
    walks = {}
    for variant in VARIANTS:
        visited, cyc, fills = probe_b(c, variant)
        if visited.item() != CHAIN or probe_b_plain(c).item() != CHAIN:
            raise RuntimeError(f"P2 {variant}: visited {visited.item()}, "
                               f"not {CHAIN}")
        model = paged_misses(c) if variant == "paged" else 0
        if fills.item() != model:
            raise RuntimeError(f"P2 {variant}: {fills.item()} page fills, "
                               f"the cache's plain model {model}")
        walks[variant] = dict(cycles_per_step=cyc.item() / CHAIN,
                              ns_per_step=ns(cyc.item() / CHAIN),
                              fills=fills.item())

    x = torch.ones((1,), device=device)
    sizes = {}
    for kb in (*reversed(P3_KB), *P3_KB):
        out, codes = probe_c(x, kb)
        fits = kb * 1024 <= smem_optin
        if fits and (codes is not None or out.item() != 3.0):
            raise RuntimeError(f"P3 {kb} KB within the {smem_optin} B "
                               f"limit: {codes or out.item()}")
        if not fits and codes is None:
            raise RuntimeError(f"P3 {kb} KB past the {smem_optin} B limit "
                               "was accepted")
        what = ("3.0" if codes is None else
                f"refused ({', '.join(error_name(k) for k in codes)})")
        if sizes.setdefault(kb, what) != what:
            raise RuntimeError(f"P3 {kb} KB: {sizes[kb]}, then {what}")
    return dict(p1=dict(value=got.item(), closed_form=want,
                        page_arrival_cycles=arrivals,
                        page_arrival_ns=[ns(x) for x in arrivals]),
                p2=walks, p3=sizes, smem_optin_bytes=smem_optin,
                clock_khz=khz)


def main():
    if not torch.cuda.is_available():
        print("probe_stream: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = run(dev)
    p1 = res["p1"]
    print(f"P1: {p1['value']} (closed form {p1['closed_form']}); pages "
          "arrive, all four in flight, after "
          + ", ".join(f"{c} cycles" for c in p1["page_arrival_cycles"]))
    for variant, w in res["p2"].items():
        fills = f", {w['fills']} page fills" if variant == "paged" else ""
        print(f"P2 {variant}: {CHAIN} visited, {w['cycles_per_step']:.1f} "
              f"cycles ({w['ns_per_step']:.1f} ns) a dependent step{fills}")
    for kb, what in res["p3"].items():
        print(f"P3 {kb} KB: {what}")
    print(f"opt-in shared memory a block {res['smem_optin_bytes']} B, SM "
          f"clock {res['clock_khz']} kHz ({torch.cuda.get_device_name(0)})")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

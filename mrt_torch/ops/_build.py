"""Build the CUDA kernels of ``mrt_torch/csrc`` at first use, bind
them with ctypes, launch them and count their launches.

``KERNELS`` declares every hand kernel once, by id: its C entry, the
entry's argument types and the kernel's device name.  ``launch`` calls
an entry and counts the launch under the kernel's id in
``utils.profiling.launch_counts``, which the tracer's snapshot and the
pass record read; ``profile.py`` names the kernels in a trace by the
table's patterns.

Each ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         --fmad=false -Xcompiler -fPIC -c -o <obj> csrc/<file>.cu
    nvcc -shared -o <lib> <objs>

``--fmad=false`` keeps nvcc from contracting a*b+c into one rounding,
so a kernel's arithmetic rounds exactly like its plain PyTorch version.
The library lands in ``mrt_torch/_build/`` under a name that carries a
hash of the sources, their headers and the flags, so an edited source
rebuilds.  There is no fallback: a missing nvcc or a failed build
raises.  The module also holds what the wrappers of the row kernels B2
and B3 share: their column range and the checks of a mask and of row
alignment.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils import profiling

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_uint
Kernel = collections.namedtuple("Kernel", "entry argtypes pattern")
# The hand kernels by id: each one's C entry, which returns a cudaError_t
# as int, the entry's argument types (the stream last), and the kernel's
# device name as a regular expression.  B2 and B4 are instances of one
# template, deposit_kernel<C, drop, pend>, told apart by pend (demangled
# as the profiler shows it, or mangled).  Adding a kernel takes a
# ``csrc`` file, a row here and a wrapper that calls ``launch``.
KERNELS = {
    "B1": Kernel("mrt_nearest_t", (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                   _F, _P, _F, _I, _P, _P, _I, _P),
                 "nearest_t_kernel"),
    "B2": Kernel("mrt_deposit", (_P, _I, _I, _P, _P, _P, _I, _I, _P),
                 r"deposit_kernel(<\d+, \w+, false>|ILi\d+ELb[01]ELb0E)"),
    "B3": Kernel("mrt_gather", (_P, _I, _I, _P, _P, _I, _P, _P),
                 "row_gather_kernel"),
    "B4": Kernel("mrt_deposit_pending", (_P, _I, _P, _P, _P, _I, _P),
                 r"deposit_kernel(<4, false, true>|ILi4ELb0ELb1E)"),
    "B5": Kernel("mrt_sphere_bvh", (_P, _P, _I, _P, _I, _P, _P, _P, _F, _P,
                                    _F, _I, _P, _P, _P, _P),
                 "sphere_bvh_kernel"),
    "B6": Kernel("mrt_tri_bvh", (_P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P,
                                 _P, _P, _P, _P, _P),
                 "tri_bvh_kernel"),
    "B7": Kernel("mrt_tlas", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                              _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                              _P),
                 "tlas_kernel"),
    "S1": Kernel("mrt_sort_keys", (_P, _P, _P, _P, _L, _I, _P, _P),
                 "sort_key_kernel"),
    "S2": Kernel("mrt_permute_lanes", (_P, _I) + (_P,) * 17,
                 "permute_lanes_kernel"),
    "R1": Kernel("mrt_pcg4d", (_P, _I, _P, _U, _P, _I, _U, _U, _P, _P),
                 "pcg4d_kernel"),
    "M1": Kernel("mrt_shade", (_P,) * 5 + (_I,) + (_P,) * 9 + (_I,)
                 + (_P,) * 6, "shade_kernel"),
    "H1": Kernel("mrt_hit_record", (_P, _P, _I) + (_P,) * 5 + (_I,)
                 + (_P,) * 6 + (_I, _P, _P, _I) + (_P,) * 11,
                 "hit_record_kernel"),
    "P1": Kernel("mrt_probe_a", (_P, _P, _P, _P, _P), "probe_a_kernel"),
    "P2": Kernel("mrt_probe_b", (_P, _I, _I, _P, _P, _P, _P),
                 "probe_b_kernel"),
    "P3": Kernel("mrt_probe_c", (_P, _P, _I, _P, _P), "probe_c_kernel"),
}
# Every C entry: (its kernel's id, its argument types); a helper, which
# launches no kernel, has no id.
ENTRIES = {k.entry: (kid, k.argtypes) for kid, k in KERNELS.items()}
ENTRIES["mrt_probe_attributes"] = (None, (_P, _P, _P))
profiling.launch_counts.update(dict.fromkeys(KERNELS, 0))

_lib = None
_lock = threading.Lock()
# nvcc's report of the build this process made, if it made one.
build_report = ""


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the mrt_torch CUDA kernels are "
                           "built at first use and need the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path():
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmrt_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise if any fails.  Returns their
    merged stdout and stderr, one string a command."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _compile(out):
    """Build the library at `out`; returns nvcc's report (ptxas -v:
    registers, shared memory and spills of every kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_name(f"{out.stem}.{os.getpid()}")
    nvcc = _nvcc()
    objs = [Path(f"{stem}.{src.stem}.o") for src in _sources()]
    report = _run_all([[nvcc, *FLAGS, "-c", "-o", str(obj), str(src)]
                       for src, obj in zip(_sources(), objs)])
    tmp = Path(f"{stem}.so.tmp")
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return "".join(report)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, build_report
    with _lock:
        if _lib is None:
            with profiling.unit("library") as rec:
                out = library_path()
                rec["built"] = not out.exists()
                if rec["built"]:
                    build_report = _compile(out)
                lib = ctypes.CDLL(str(out))
                for name, (_, argtypes) in ENTRIES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.mrt_error_string.argtypes = (ctypes.c_int,)
                lib.mrt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def kernel_resources(report=None):
    """Each kernel's resources from ptxas's report (default: this
    process's build): a list of dicts with name (the kernel and its
    template flags, e.g. ``tlas_kernel<1,0>``), registers, stack (bytes
    of stack frame), spill_stores, spill_loads and smem (static shared
    bytes)."""
    out, cur = [], None
    for line in (build_report if report is None else report).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(name=_pretty(m.group(1)), registers=0, stack=0,
                       spill_stores=0, spill_loads=0, smem=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return out


def _pretty(mangled):
    """``tlas_kernel<1,0>`` or ``deposit_kernel<4,0>`` for a mangled
    kernel name with int or bool template arguments (its length-prefixed
    name parts read in order, the last one kept); the mangled name where
    it does not parse."""
    m = re.match(r"_ZN?", mangled)
    pos, name = (m.end(), None) if m else (0, None)
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        size = int(m.group(0))
        name = mangled[pos + m.end():pos + m.end() + size]
        pos += m.end() + size
    if not name:
        return mangled
    m = re.match(r"I((?:L[bi]\d+E)+)E", mangled[pos:])
    flags = re.findall(r"L[bi](\d+)E", m.group(1)) if m else []
    return name + (f"<{','.join(flags)}>" if flags else "")


# The row kernels B2 and B3 (csrc/rows.cuh): the column counts they are
# compiled for (the TPU gather's limit, mrt/ops/pallas_onehot.py::
# gather_usable), and the alignment of their vector accesses by column
# count: a row of 4 floats moves as a float4, of 2 as a float2.
MAX_COLS = 10
ROW_ALIGN = {4: 16, 2: 8}


def check_mask(fn, mask, lanes, device):
    """Raise unless mask is None or a contiguous bool tensor of shape
    `lanes` on `device` (one byte a lane, as the row kernels read it)."""
    if mask is None:
        return
    if mask.dtype != torch.bool:
        raise TypeError(f"{fn}: mask is {mask.dtype}, not bool")
    if mask.shape != lanes or mask.device != device:
        raise ValueError(f"{fn}: mask {tuple(mask.shape)} on {mask.device}, "
                         f"expected {tuple(lanes)} on {device}")
    if not mask.is_contiguous():
        raise ValueError(f"{fn}: mask is not contiguous")


def check_aligned(fn, cols, **tensors):
    """Raise ValueError unless each tensor's data is aligned for rows of
    `cols` floats read or written as one vector (16 bytes at 4 columns,
    8 at 2; any float pointer otherwise)."""
    align = ROW_ALIGN.get(cols)
    if align is None:
        return
    for name, x in tensors.items():
        if x.data_ptr() % align:
            raise ValueError(f"{fn}: {name} is not {align}-byte aligned (rows "
                             f"of {cols} floats move as one vector)")


_entries = {}
_raw_stream = None
_launches = profiling.launch_counts


def _entry(name):
    """(the C entry `name`, its kernel's id), with the stream getter,
    looked up once."""
    global _raw_stream
    if _raw_stream is None:
        # The current stream's handle as an int, without building a
        # torch.cuda.Stream (torch's private getter where it has one).
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda index: torch.cuda.current_stream(index).cuda_stream)
    kid, _ = ENTRIES[name]
    entry = _entries[name] = (getattr(library(), name), kid)
    return entry


def launch(name, device, *args):
    """Call C entry `name` on `device`'s current stream; raise on a
    CUDA error, else count the launch under its kernel's id in
    ``profiling.launch_counts``.  Tensor arguments pass as their data
    pointers, None as a null pointer."""
    fn, kid = _entries.get(name) or _entry(name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    index = torch.cuda.current_device()
    if device.index is None or device.index == index:
        err = fn(*cargs, _raw_stream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*cargs, _raw_stream(device.index))
    if err != 0:
        msg = library().mrt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    if kid is not None:
        _launches[kid] += 1

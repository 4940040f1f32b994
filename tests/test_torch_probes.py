"""Port parity for the probes P1-P3 (``mrt_torch.tools.probe_stream`` vs
``tools/probe_stream.py``): their plain versions, which the card's
kernels are held to, give the values the TPU probes check, and P1's and
P2's equal the outputs of the TPU probes run in interpret mode on the
CPU.  All values are small integers or 3.0: exact."""

import importlib.util
import os
import re

import pytest
import torch

from mrt_torch.tools import probe_stream as P
from mrt_torch.utils import profiling

# The TPU probes: a script of the repository's tools/, loaded by path.
_SPEC = importlib.util.spec_from_file_location(
    "tpu_probe_stream", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "tools", "probe_stream.py"))
JP = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(JP)


def _printed(capsys, key):
    return float(re.search(rf"{key}=([-0-9.]+)", capsys.readouterr().out)[1])


def test_p1_indexed_sum(capsys):
    f, i = P.tables("cpu")
    got, cycles = P.probe_a(f, i)  # the plain version on the CPU
    assert cycles is None
    assert got.item() == P.closed_form() == 7208.0
    assert JP.probe_a(True)
    assert got.item() == _printed(capsys, "out")


def test_p2_chain_walk(capsys):
    c = torch.from_numpy(P.chain())
    assert sorted(c.tolist()) == [-1] + list(range(1, P.CHAIN))
    got, cycles, fills = P.probe_b(c)
    assert cycles is None and got.item() == P.CHAIN == 1024
    assert fills.item() == P.paged_misses(c)
    for variant in ("l2", "shared"):
        assert P.probe_b(c, variant)[2].item() == 0
    assert JP.probe_b(True)
    assert got.item() == _printed(capsys, "visited")
    with pytest.raises(TypeError):
        P.probe_b(c.long())


def test_p2_chain_must_be_whole_pages():
    # The kernel's paged walk copies whole pages: the wrapper refuses a
    # chain that is not, on any device.
    c = torch.from_numpy(P.chain())
    with pytest.raises(ValueError, match="whole pages"):
        P.probe_b(c[:P.CHAIN - 24])
    assert P.probe_b(torch.from_numpy(P.chain(2 * P.CHAIN)))[0].item() == (
        2 * P.CHAIN)
    with pytest.raises(ValueError, match="no kernel"):
        P.probe_b(c.to("meta"))


def test_p2_page_fills_model():
    # The paged walk's cache in Python: a chain in entry order fills each
    # of its 4 pages once; the random chain's next page is one of the 2
    # cached about half the time.
    order = torch.cat([torch.arange(1, P.CHAIN, dtype=torch.int32),
                       torch.tensor([-1], dtype=torch.int32)])
    assert P.paged_misses(order) == 4
    fills = P.paged_misses(torch.from_numpy(P.chain()))
    assert 0.4 * P.CHAIN < fills < 0.6 * P.CHAIN


def test_p3_three_x():
    x = torch.ones((1,))
    got, refused = P.probe_c(x, 227)
    assert refused is None and got.item() == 3.0
    assert P.probe_c_plain(torch.tensor([2.5])).item() == 7.5
    assert [profiling.launch_counts[k] for k in ("P1", "P2", "P3")] == [0] * 3


@pytest.mark.parametrize("f_type, i_type", [(torch.float64, torch.int32),
                                            (torch.float32, torch.int64)])
def test_p1_wrapper_refuses_other_types(f_type, i_type):
    # The kernel reads f as float32 and i as int32: the wrapper refuses
    # any other type on every device, before it looks at the device.
    f, i = P.tables("cpu")
    with pytest.raises(TypeError, match="not float32 and int32"):
        P.probe_a(f.to(f_type), i.to(i_type))
    with pytest.raises(TypeError, match="not float32 and int32"):
        P.probe_a(f.to("meta", f_type), i.to("meta", i_type))
    assert profiling.launch_counts["P1"] == 0


@pytest.mark.parametrize("codes", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_p3_refusal_bookkeeping(codes, monkeypatch):
    # The entry's two codes (the one-time attribute answer and this
    # launch's), faked: any non-zero one is a refusal, reported as
    # (None, codes) and not counted as a launch; (0, 0) is a launch.  The
    # fake counts each call as ``_build.launch`` counts an entry's.
    calls = []

    def fake_launch(name, device, x, out, nbytes, got):
        calls.append((name, nbytes))
        got.copy_(torch.tensor(codes, dtype=torch.int32))
        profiling.launch_counts["P3"] += 1

    monkeypatch.setattr(P._build, "launch", fake_launch)
    monkeypatch.setitem(profiling.launch_counts, "P3", 0)
    out, refused = P.probe_c(torch.ones((1,), device="meta"), 228)
    assert calls == [("mrt_probe_c", 228 * 1024)]
    if any(codes):
        assert out is None and refused == codes
        assert profiling.launch_counts["P3"] == 0
    else:
        assert refused is None and out.shape == (1,)
        assert profiling.launch_counts["P3"] == 1

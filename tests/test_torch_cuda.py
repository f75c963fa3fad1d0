"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (the kernels are built from
``src/repro_torch/csrc`` at first use) and skips elsewhere.  The file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, with their reasons: fedavg float32 within 1e-6 of
sum_b |w_b x_bn| (another summation order of B products), bfloat16 one
bfloat16 ulp more (the f32 sum may round to the neighbouring bfloat16);
fedavg's wire and pod routes bit-identical (both sum in agent order with
the same roundings: the products rounded to the wire type, or one fused
multiply-add each, which the plain version emulates exactly in float64)
at every residue of N mod 8, at B = 33 and on a (2, 9) grid, and on views
whose storage offset leaves every row off 16-byte alignment (the kernel
realigns its 16-byte loads row by row);
qsync bit-identical in every output (kernel and plain version both sum
the rounded products in agent order and round every step alike); the fused
Adam + quantize kernel bit-identical to its plain version and to
``Adam.update`` then the qpack quantize (the same operations, each rounded
on its own, dividing by the same device-computed bias corrections); the four
qpack kernels, every route, bit-identical (elementwise, the block max-abs
is exact in any order); the composed coded sync bit-identical to the fused one (both
reduce in agent order with the same roundings).  Flash attention and the
SSD scan compute in float32 with fused multiply-adds in another order than
the plain versions' library products: float32 outputs within 1e-5 of the
output's largest magnitude; bfloat16 outputs that much plus two bfloat16
ulps of the element (both round a float32 result once, which may land on
the neighbouring value).  Against a float64 scan, the float32 SSD
kernel's largest error is held within 1.5x the plain version's (both sum
in float32, in other orders).  The backbones on the card against the CPU
within 2e-4, as the port is held to the reference.  One round of each
paper experiment on the card against the CPU port within the bounds the
CPU round is held to against the reference (``torch_shared``): its
module imports JAX only inside the helpers that run it.  The serving
engine's captured decode tick bit-identical to its eager tick (the same
kernels on the same static buffers); its ring layout within 2e-4 of the
full layout in float32, as the backbones are held to the CPU.  The LM
GAN (slice 12): one round of each new arch's ``.smoke()`` config on the
card against the CPU port within ``torch_shared``'s round bounds; every
sync kernel launch of its rounds held in place to its plain version
(``torch_shared.held_sync_kernels``: fedavg within 1e-6 of sum_b |w_b
x_bn|, qsync and qpack bit for bit) with exact launch counts; the MoE's
routing on the card equal to the CPU's token for token.  Privacy and
robustness (slice 14): the tensor Threefry on the card bit for bit the
numpy one; ``masked_sync`` bit for bit ``average_agents`` (the kernel
rounds each product before it adds in agent order, and the unmasked
products are already rounded); the robust reduces bit for bit the CPU's
(a stable sort, then an order statistic, or adds in sorted order); every
per-example joint norm at most C (1 + 1e-6), and C within 1e-5 where it
was clipped; captured secure, DP and robust rounds bit for bit the eager
ones.  The virtual-client fleet: the identity fleet on the card
bit for bit the dense stream run (the same rounds; ``cudnn.deterministic``
set); a deferred-straggler round (K = 1) on the card against the CPU port
within ``torch_shared``'s round bounds; the deferred merge's and the
async flush's fedavg launches held in place as the sync's are, the async
demo's journal equal to the CPU's apart from the params digests, and two
card runs byte-identical.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch_shared import CARD_K, ROUND_TASKS, port_round_mismatches

from repro_torch.comm import IntQuant, get_codec
from repro_torch.core import FedAvgSync
from repro_torch.dist import collectives
from repro_torch.kernels.fedavg import kernel as avgkernel
from repro_torch.kernels.fedavg.kernel import fedavg_flat, fedavg_pod_flat, fedavg_wire_flat
from repro_torch.kernels.fedavg.ref import (fedavg_flat_ref, fedavg_pod_low_ref, fedavg_pod_ref,
                                            fedavg_wire_ref)
from repro_torch.kernels.qpack import kernel as pkernel
from repro_torch.kernels.qpack import ref as pref
from repro_torch.kernels.qsync import kernel as qkernel
from repro_torch.kernels.qsync import ops as qops
from repro_torch.kernels.qsync.ref import adam_sync_flat_ref, qsync_flat_ref
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.launch.train import experiment_spec
from repro_torch.models import Backbone
from repro_torch.optim import Adam
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU form")
    return torch.device("cuda")


def _weights(gen, dev):
    w = torch.rand((1, 5), generator=gen, device=dev) + 0.1
    return w / w.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = _weights(g, cuda)
    x = torch.randn((5, 100_003), generator=g, device=cuda).to(dtype)
    before = fedavg_flat.launches
    got = fedavg_flat(w, x).float()
    torch.cuda.synchronize()
    assert fedavg_flat.launches == before + 1
    want = fedavg_flat_ref(w, x).float()
    bound = 1e-6 * (w.reshape(-1, 1) * x.float()).abs().sum(0)
    if dtype == torch.bfloat16:
        bound = bound + torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
    assert bool(((got - want).abs() <= bound).all())
    with pytest.raises(ValueError, match="contiguous"):
        fedavg_flat(w, x.t().contiguous().t())
    with pytest.raises(ValueError, match="CUDA device"):
        fedavg_flat(w.cpu(), x)


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[a.dtype]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


# N at every residue mod 8, small and large, and the ACGAN generator bucket
FEDAVG_NS = [1, 2, 7, 1027, *range(100_000, 100_008), 2_314_435]


def _route_input(g, cuda, shape, dtype, offset=0):
    """Mixed magnitudes of ``dtype``; with ``offset``, a contiguous view
    that many elements into its storage (an unaligned base)."""
    n = math.prod(shape)
    scale = torch.tensor([1e-3, 1.0, 30.0], device=cuda)[
        torch.randint(0, 3, (n + offset,), generator=g, device=cuda)]
    buf = (torch.randn((n + offset,), generator=g, device=cuda) * scale).to(dtype)
    return buf[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("N", FEDAVG_NS)
@pytest.mark.parametrize("B", [5, 8, 16, 33])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fedavg_wire_kernel_matches_plain(cuda, dtype, B, N):
    g = torch.Generator(device=cuda).manual_seed(B + N)
    w = torch.rand((1, B), generator=g, device=cuda) + 0.1
    w = w / w.sum()
    x = _route_input(g, cuda, (B, N), dtype)
    before = fedavg_wire_flat.launches
    got = fedavg_wire_flat(w, x)
    torch.cuda.synchronize()
    assert fedavg_wire_flat.launches == before + 1
    assert _same_bits(got, fedavg_wire_ref(w, x))
    with pytest.raises(TypeError, match="bfloat16 or"):
        fedavg_wire_flat(w, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        fedavg_wire_flat(w, torch.cat([x, x], dim=1)[:, ::2])


def _pod_ref(w, x):
    return (fedavg_pod_ref if x.dtype == torch.float32 else fedavg_pod_low_ref)(w, x)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [513, *FEDAVG_NS])
@pytest.mark.parametrize("grid", [(1, 5), (2, 4), (4, 4), (3, 5), (2, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fedavg_pod_kernel_matches_plain(cuda, dtype, grid, N):
    """The pod route in float32 and, with the weights rounded to the leaf's
    type, in bfloat16 and float16: bit for bit its plain version, one
    launch counted in all and one on its dtype's route."""
    g = torch.Generator(device=cuda).manual_seed(sum(grid) + N)
    w = torch.rand(grid, generator=g, device=cuda) + 0.1
    w = w / w.sum()
    x = _route_input(g, cuda, grid + (N,), dtype)
    before, route = fedavg_pod_flat.launches, fedavg_pod_flat.by_dtype[dtype]
    got = fedavg_pod_flat(w, x)
    torch.cuda.synchronize()
    assert fedavg_pod_flat.launches == before + 1
    assert fedavg_pod_flat.by_dtype[dtype] == route + 1
    assert got.dtype == dtype and _same_bits(got, _pod_ref(w, x))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fedavg_pod_flat(w, x.double())
    with pytest.raises(TypeError, match="float32 weights"):
        fedavg_pod_flat(w.double(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("N", [1, 1027, 100_003])
def test_fedavg_routes_take_unaligned_views(cuda, offset, N):
    """A contiguous view ``offset`` elements into its storage: every row of
    the wire and pod routes starts off 16-byte alignment, the first row's
    first word before the tensor; every route still equals its plain
    version bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(offset * N)
    w = torch.rand((1, 5), generator=g, device=cuda) + 0.1
    w = w / w.sum()
    for dtype in (torch.bfloat16, torch.float16):
        x = _route_input(g, cuda, (5, N), dtype, offset)
        assert x.is_contiguous() and x.data_ptr() % 16
        assert _same_bits(fedavg_wire_flat(w, x), fedavg_wire_ref(w, x))
    wp = torch.rand((2, 9), generator=g, device=cuda) + 0.1
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = _route_input(g, cuda, (2, 9, N), dtype, offset)
        assert x.is_contiguous() and x.data_ptr() % 16
        got = fedavg_pod_flat(wp, x)
        torch.cuda.synchronize()
        assert _same_bits(got, _pod_ref(wp, x))


@pytest.mark.cuda
def test_fedavg_kernels_do_not_spill(cuda):
    """Every instantiation of the wire and pod routes (bfloat16 and float16
    wire, float32, bfloat16 and float16 pod): no local bytes, and at least
    three blocks resident an SM (their launch bounds)."""
    assert len(avgkernel.KERNELS) == 45
    for name in avgkernel.KERNELS:
        a = avgkernel.kernel_attrs(name)
        assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 3, (name, a)


@pytest.mark.cuda
def test_collectives_on_card_run_through_the_routes(cuda):
    """``average_agents(sync_dtype=bfloat16)`` launches the wire route once
    for a tree, ``average_intra_pod`` the pod route once, each result the
    CPU's bit for bit."""
    g = torch.Generator().manual_seed(0)
    w = torch.rand((2, 4), generator=g) + 0.1
    w = w / w.sum()
    tree = {"a": torch.randn((2, 4, 3, 5), generator=g), "b": torch.randn((2, 4, 1001), generator=g),
            "n": torch.ones((2, 4), dtype=torch.int32)}
    on = lambda t: tree_map(lambda x: x.to(cuda), t)  # noqa: E731
    for fn, counter in ((lambda t, w: collectives.average_agents(t, w, sync_dtype=torch.bfloat16),
                         fedavg_wire_flat),
                        (collectives.average_intra_pod, fedavg_pod_flat)):
        before = counter.launches
        got = fn(on(tree), w.to(cuda))
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        want = fn(tree, w)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a.cpu(), b) and a.dtype == b.dtype


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ef", [False, True])
def test_qsync_kernel_matches_plain(cuda, bits, ef):
    g = torch.Generator(device=cuda).manual_seed(bits)
    n = 128 * 997
    w = _weights(g, cuda)
    scale = torch.tensor([1e-3, 1.0, 30.0], device=cuda)[
        torch.randint(0, 3, (5, n), generator=g, device=cuda)]
    x = torch.randn((5, n), generator=g, device=cuda) * scale
    x[:, :128] = 0.0   # an all-zero block: scale 0, divisor 1
    e = 0.01 * torch.randn((5, n), generator=g, device=cuda) if ef else None
    ed = 0.01 * torch.randn(n, generator=g, device=cuda) if ef else None
    qmax = 2 ** (bits - 1) - 1
    before = qkernel.qsync_flat.launches
    got = qkernel.qsync_flat(w, x, e, ed, qmax=qmax)
    want = qsync_flat_ref(w, x, e, ed, qmax=qmax, block=128)
    torch.cuda.synchronize()
    assert qkernel.qsync_flat.launches == before + 1
    assert (got[1] is None) == (not ef) and (got[2] is None) == (not ef)
    for g, wnt in zip(got, want):
        assert (g is None) or torch.equal(g, wnt)
    with pytest.raises(ValueError, match="contiguous"):
        qkernel.qsync_flat(w, x.t().contiguous().t(), qmax=qmax)
    with pytest.raises(ValueError, match="multiple of 32"):
        qkernel.qsync_flat(w, x[:, :100 * 10].contiguous(), qmax=qmax, block=100)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("count", [0, 7])
def test_adam_sync_kernel_matches_plain_and_adam_update(cuda, bits, count):
    """The fused Adam + quantize kernel against its plain version and
    against ``Adam.update`` followed by ``quantize_blocks`` of the bucketed
    new params, on the card, bit for bit (the same operations, each
    rounded alike, dividing by the same device-computed bias corrections).
    Leaves of several shapes, one 0-d per agent; an all-zero leaf."""
    g = torch.Generator(device=cuda).manual_seed(bits + count)
    B = 5
    params = {"wa": torch.randn((B, 333), generator=g, device=cuda),
              "wb": torch.randn((B, 64, 130), generator=g, device=cuda),
              "theta": torch.randn((B,), generator=g, device=cuda),
              "zero": torch.zeros((B, 256), device=cuda)}
    grads = tree_map(lambda v: 0.1 * v + 0.03 * v.sign(), params)
    state = {"count": torch.tensor(count, dtype=torch.int32, device=cuda),
             "mu": tree_map(lambda v: 0.2 * v, params),
             "nu": tree_map(lambda v: 0.1 * v.abs(), params)}
    before = qkernel.adam_sync_flat.launches
    p2, s2, q, s = qops.adam_sync_tree(params, grads, state, lr=2e-4, bits=bits)
    torch.cuda.synchronize()
    assert qkernel.adam_sync_flat.launches == before + 1
    # the plain version on the same bucket, on the card
    leaves = [params[k] for k in sorted(params)]
    bucket = lambda t: qops._bucket([t[k] for k in sorted(t)], B, 128)[0]
    c = (state["count"] + 1).to(torch.float32)
    hyper = torch.stack([torch.tensor(2e-4, device=cuda), 1.0 - 0.5 ** c,
                         1.0 - 0.999 ** c]).reshape(1, 3)
    want = adam_sync_flat_ref(hyper, bucket(params), bucket(grads), bucket(state["mu"]),
                              bucket(state["nu"]), b1=0.5, b2=0.999, eps=1e-8,
                              qmax=2 ** (bits - 1) - 1, block=128)
    got = (bucket(p2), bucket(s2["mu"]), bucket(s2["nu"]), q, s)
    for a, b in zip(got, want):
        assert _bits(a).equal(_bits(b))
    # and Adam.update then the qpack quantize, as the unfused path runs them
    p_ref, s_ref = Adam(b1=0.5, b2=0.999).update(params, grads, state, 2e-4)
    for k in params:
        assert _bits(p2[k]).equal(_bits(p_ref[k]))
        assert _bits(s2["mu"][k]).equal(_bits(s_ref["mu"][k]))
        assert _bits(s2["nu"][k]).equal(_bits(s_ref["nu"][k]))
    assert int(s2["count"]) == count + 1
    qq, qs = pkernel.quant_flat(bucket(p_ref), qmax=2 ** (bits - 1) - 1)
    assert _bits(q).equal(_bits(qq)) and _bits(s).equal(_bits(qs))
    assert not q[:, -256:].any() and not p2["zero"].any()
    x = bucket(params)
    with pytest.raises(ValueError, match="contiguous"):
        qkernel.adam_sync_flat(hyper, x.t().contiguous().t(), x, x, x, b1=0.5, b2=0.999,
                               eps=1e-8, qmax=127)
    with pytest.raises(ValueError, match="CUDA device"):
        qkernel.adam_sync_flat(hyper.cpu(), x, x, x, x, b1=0.5, b2=0.999, eps=1e-8,
                               qmax=127)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [False, True], ids=["plain", "int8"])
def test_round_on_card_runs_through_the_kernels(cuda, codec):
    """One ACGAN round at full width on the card: every sync of a subtree
    is one kernel launch, and every agent holds the synced values."""
    strategy = FedAvgSync(codec=IntQuant(8)) if codec else None
    spec, _ = experiment_spec("image_acgan", K=2, steps=2, strategy=strategy,
                              log_every=0, device=cuda)
    counter = qkernel.qsync_flat if codec else fedavg_flat
    before = counter.launches
    result = spec.run_result()
    torch.cuda.synchronize()
    assert counter.launches - before == 2   # one per subtree (gen, disc)
    for x in tree_leaves(result.state["params"]):
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, x[:1, :1].expand_as(x))


def _bits(t):
    """The tensor's bytes, for comparisons that see the sign of zero."""
    return t.contiguous().view(torch.uint8)


def _planted(gen, dev, rows, n, qmax, block=128):
    """(rows, n) float32 of mixed magnitudes with an all-zero block, an
    overflowing block (the scale clamps to 65504) and a block of exact .5
    ties (max-abs qmax / 2 gives the scale 0.5) in every row."""
    scale = torch.tensor([1e-3, 1.0, 30.0], device=dev)[
        torch.randint(0, 3, (rows, n), generator=gen, device=dev)]
    x = torch.randn((rows, n), generator=gen, device=dev) * scale
    x[:, :block] = 0.0
    x[:, block:2 * block] *= 1e7
    odd = 2 * torch.randint(-qmax, qmax, (rows, block), generator=gen, device=dev) + 1
    x[:, 2 * block:3 * block] = 0.25 * odd.float()
    x[:, 2 * block] = qmax / 2
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block", [128, 6])
def test_qpack_kernels_match_plain(cuda, bits, block):
    g = torch.Generator(device=cuda).manual_seed(bits + block)
    qmax = 2 ** (bits - 1) - 1
    x = _planted(g, cuda, 3, block * 401, qmax, block)
    counters = (pkernel.quant_flat, pkernel.dequant_flat, pkernel.pack4_flat,
                pkernel.unpack4_flat)
    before = [f.launches for f in counters]
    q, s = pkernel.quant_flat(x, qmax=qmax, block=block)
    out = pkernel.dequant_flat(q, s, block=block)
    q4 = q if bits == 4 else q.clamp(-7, 7)   # nibbles hold codes in [-7, 7]
    p = pkernel.pack4_flat(q4)
    back = pkernel.unpack4_flat(p)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
    wq, ws = pref.quant_blocks_ref(x, qmax=qmax, block=block)
    assert torch.equal(_bits(q), _bits(wq)) and torch.equal(_bits(s), _bits(ws))
    assert torch.equal(_bits(out), _bits(pref.dequant_blocks_ref(q, s, block=block)))
    assert torch.equal(_bits(p), _bits(pref.pack4_ref(q4)))
    assert torch.equal(back, q4) and torch.equal(back, pref.unpack4_ref(p))
    with pytest.raises(ValueError, match="contiguous"):
        pkernel.quant_flat(x.t().contiguous().t(), qmax=qmax, block=block)
    with pytest.raises(ValueError, match="CUDA device"):
        pkernel.dequant_flat(q, s.cpu(), block=block)


def _at_offset(t, offset):
    """A copy of ``t`` that starts ``offset`` bytes past a 16-byte boundary
    of a larger buffer: contiguous, so the wrappers take it."""
    n = t.numel() * t.element_size()
    buf = torch.zeros(n + 32, dtype=torch.uint8, device=t.device)
    start = (offset - buf.data_ptr()) % 16
    v = buf[start:start + n].view(t.dtype).view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == offset
    return v


QPACK_DEQUANT_CASES = (
    [(3, 128 * 5, 128, off) for off in range(1, 16)]    # misaligned codes
    + [(3, 42, 6, 0), (2, 10, 2, 0), (3, 130 * 3, 130, 5)]  # length % 16 != 0
    + [(3, 60, 12, 0), (2, 100, 20, 4)]                 # tiles of 3 and 5 words
    + [(1, 128, 128, 0), (1, 6, 6, 0), (1, 2, 2, 3)]    # one row, one block
    + [(5, 2_097_152, 128, 0), (5, 524_288, 128, 0)])   # the main path's


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,block,offset", QPACK_DEQUANT_CASES)
def test_qpack_dequant_routes_match_plain(cuda, rows, n, block, offset):
    """Both routes of the dequant kernel bit for bit against the plain
    version, one launch a call; scales include zeros and 65504."""
    g = torch.Generator(device=cuda).manual_seed(rows * n + offset)
    q = torch.randint(-127, 128, (rows, n), generator=g, device=cuda).to(torch.int8)
    s = torch.rand((rows, n // block), generator=g, device=cuda) * 30
    s[0, 0], s[-1, -1] = 0.0, 65504.0
    s = s.half()
    q = _at_offset(q, offset)
    before = pkernel.dequant_flat.launches
    out = pkernel.dequant_flat(q, s, block=block)
    torch.cuda.synchronize()
    assert pkernel.dequant_flat.launches - before == 1
    assert torch.equal(_bits(out), _bits(pref.dequant_blocks_ref(q, s, block=block)))


QPACK_PACK4_CASES = (
    [(3, 2000, off) for off in range(1, 16)]            # misaligned codes
    + [(1, 2, 0), (1, 14, 0), (1, 18, 0), (3, 66, 0), (2, 62, 0), (2, 82, 7)]  # odd bytes
    + [(1, 128, 0), (5, 4096, 0), (5, 524_288, 0)])     # the main path's


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,offset", QPACK_PACK4_CASES)
def test_qpack_pack4_routes_match_plain(cuda, rows, n, offset):
    """Both routes of the pack4 kernel, and the byte-wise tail of the
    vector route, bit for bit against the plain version on codes over all
    256 int8 values (both mask with 0xF), one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(rows * n + offset)
    q = torch.randint(-128, 128, (rows, n), generator=g, device=cuda).to(torch.int8)
    if q.numel() >= 256:
        q.view(-1)[:256] = torch.arange(-128, 128, device=cuda).to(torch.int8)
    q = _at_offset(q, offset)
    before = pkernel.pack4_flat.launches
    p = pkernel.pack4_flat(q)
    torch.cuda.synchronize()
    assert pkernel.pack4_flat.launches - before == 1
    assert torch.equal(_bits(p), _bits(pref.pack4_ref(q)))


QPACK_UNPACK4_CASES = (
    [(3, 1000, off) for off in range(1, 16)]            # misaligned packed bytes
    + [(1, 1, 0), (1, 15, 0), (1, 17, 0), (3, 33, 0), (2, 31, 0), (2, 40, 7)]  # m % 16 != 0
    + [(5, 262_144, 0)])                                # the main path's


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m,offset", QPACK_UNPACK4_CASES)
def test_qpack_unpack4_routes_match_plain(cuda, rows, m, offset):
    """Both routes of the unpack4 kernel, and the byte-wise tail of the
    vector route, bit for bit against the plain version, one launch a
    call."""
    g = torch.Generator(device=cuda).manual_seed(rows * m + offset)
    p = torch.randint(0, 256, (rows, m), generator=g, device=cuda).to(torch.uint8)
    p = _at_offset(p, offset)
    before = pkernel.unpack4_flat.launches
    back = pkernel.unpack4_flat(p)
    torch.cuda.synchronize()
    assert pkernel.unpack4_flat.launches - before == 1
    assert torch.equal(back, pref.unpack4_ref(p))


@pytest.mark.cuda
def test_qpack_kernels_do_not_spill(cuda):
    """Every route of every qpack kernel, pack4_general included."""
    assert "pack4_general" in pkernel.KERNELS
    for name in pkernel.KERNELS:
        assert pkernel.kernel_attrs(name)["local_bytes"] == 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_composed_sync_matches_fused_bit_for_bit(cuda, bits):
    """Both paths reduce in agent order with the same roundings and decode
    a code of 0 to +0, so every output agrees in every bit."""
    g = torch.Generator(device=cuda).manual_seed(10 + bits)
    w = _weights(g, cuda)
    shapes = [(3, 50), (129,), (4, 4, 2, 8), (1,), (1000,)]
    tree = {str(i): 0.05 * torch.randn((1, 5) + s, generator=g, device=cuda)
            for i, s in enumerate(shapes)}
    ef = {k: 1e-3 * torch.randn(v.shape, generator=g, device=cuda) for k, v in tree.items()}
    ed = {k: 1e-3 * torch.randn(v.shape[2:], generator=g, device=cuda)
          for k, v in tree.items()}
    codec = IntQuant(bits)
    fused = collectives.coded_sync(tree, w, codec, ef=ef, ef_down=ed, fused=True)
    before = (pkernel.quant_flat.launches, fedavg_flat.launches)
    composed = collectives.coded_sync(tree, w, codec, ef=ef, ef_down=ed, fused=False)
    torch.cuda.synchronize()
    assert (pkernel.quant_flat.launches - before[0],
            fedavg_flat.launches - before[1]) == (2 * len(shapes), len(shapes))
    for f, c in zip(fused, composed):
        for k in tree:
            assert torch.equal(_bits(f[k]), _bits(c[k])), k


@pytest.mark.cuda
def test_composed_round_on_card_runs_through_the_qpack_kernels(cuda):
    """One ACGAN round at full width under top-k then int4: per f32 leaf
    and direction one quant, pack4, unpack4 and dequant, and one fedavg per
    leaf; no fused sync."""
    strategy = FedAvgSync(codec=get_codec("topk+int4", fraction=0.25))
    spec, _ = experiment_spec("image_acgan", K=2, steps=2, strategy=strategy,
                              log_every=0, device=cuda)
    counters = (pkernel.quant_flat, pkernel.pack4_flat, pkernel.unpack4_flat,
                pkernel.dequant_flat, fedavg_flat, qkernel.qsync_flat)
    before = [f.launches for f in counters]
    result = spec.run_result()
    torch.cuda.synchronize()
    leaves = [x for x in tree_leaves(result.state["params"]) if x.dtype == torch.float32]
    L = len(leaves)
    assert [f.launches - b for f, b in zip(counters, before)] == [2 * L] * 4 + [L, 0]
    for x in leaves:
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, x[:1, :1].expand_as(x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ROUND_TASKS))
def test_round_on_card_matches_cpu(cuda, name):
    """One round (K = 1, ``torch_shared.CARD_K``) of each paper experiment
    at test size (ACGAN nets at 8x8, celeba_acgan's 16 classes and two
    rates) on the card against the same round on the CPU port, from one
    start state and the same numpy batches, within the bounds the CPU round
    is held to against the reference (``torch_shared.round_mismatches``)."""
    bad, (ratio, path) = port_round_mismatches(name, cuda, K=CARD_K)
    print(f"{name}: largest |card - CPU| / limit {ratio:.4g} at {path}")
    assert bad == []


def _close(got, want, dtype):
    """float32: within 1e-5 of max |want|; bfloat16: that plus two bf16
    ulps (2^-6 of the larger magnitude) of the element."""
    g, w = got.float(), want.float()
    bound = 1e-5 * float(w.abs().max()) + torch.zeros_like(w)
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -6 * torch.maximum(g.abs(), w.abs())
    err = (g - w).abs()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("nh,nkv,hd", [(8, 4, 256), (4, 4, 64), (8, 2, 32), (4, 4, 112)])
def test_flash_kernel_matches_plain(cuda, dtype, window, nh, nkv, hd):
    """T = 300 is a multiple of no tile; GQA 2:1 and 4:1 and none; head_dim
    112 (zamba2-7b), whose 14 16-byte chunks a row do not divide the
    block; non-causal (whisper's encoder) at 64 and 112."""
    g = torch.Generator(device=cuda).manual_seed(hd + window)
    q = torch.randn((2, nh, 300, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, nkv, 300, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = fkernel.flash_attention_bhsd.launches
    got = fkernel.flash_attention_bhsd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fkernel.flash_attention_bhsd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, attention_ref(q, k, v, causal=True, window=window), dtype)
    if hd in (64, 112):
        got = fkernel.flash_attention_bhsd(q, k, v, causal=False)
        _close(got, attention_ref(q, k, v, causal=False), dtype)


@pytest.mark.cuda
def test_flash_kernel_refusals(cuda):
    q = torch.randn((1, 4, 70, 64), device=cuda)
    k = torch.randn((1, 2, 70, 64), device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        fkernel.flash_attention_bhsd(q.clone().requires_grad_(), k, k)
    with pytest.raises(TypeError, match="float32 or all"):
        fkernel.flash_attention_bhsd(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="float32 or all"):
        fkernel.flash_attention_bhsd(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="contiguous"):
        fkernel.flash_attention_bhsd(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="head_dim"):
        fkernel.flash_attention_bhsd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                     k[..., :48].contiguous())


@pytest.mark.cuda
def test_flash_bf16_kernel_attrs_and_alignment(cuda):
    """The tensor-core kernel builds for every head_dim within the card's
    registers, spills nothing at hd 256, and the wrapper refuses data that
    its 16-byte copies cannot read."""
    for hd in fkernel.HEAD_DIMS:
        a = fkernel.bf16_kernel_attrs(hd)
        assert a["num_regs"] <= 255 and a["blocks_per_sm"] >= 1, (hd, a)
    assert fkernel.bf16_kernel_attrs(256)["local_bytes"] == 0
    k = torch.randn((1, 2, 65, 64), device=cuda).bfloat16()
    flat = torch.randn(2 * k.numel() + 1, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="16-byte boundary"):
        fkernel.flash_attention_bhsd(flat[1:].view(1, 4, 65, 64), k, k)


def _ssd_inputs(g, dev, Bsz, T, nh, hd, ds, dtype):
    x = (0.5 * torch.randn((Bsz, T, nh, hd), generator=g, device=dev)).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((Bsz, T, nh), generator=g, device=dev))
    A = -torch.exp(torch.randn((nh,), generator=g, device=dev))
    B, C = ((0.5 * torch.randn((Bsz, T, ds), generator=g, device=dev)).to(dtype)
            for _ in range(2))
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,nh,hd,ds,chunk", [(512, 6, 64, 128, 128),   # mamba2's sizes
                                              (96, 3, 32, 16, 32),
                                              (40, 2, 128, 16, 8),
                                              (4096, 4, 64, 128, 128),  # 32 chunks
                                              (256, 80, 64, 128, 128),  # mamba2's heads
                                              (128, 3, 64, 128, 128),   # one chunk
                                              (48, 5, 32, 16, 48),
                                              (256, 112, 64, 64, 128)])  # zamba2-7b's
def test_ssd_kernel_matches_plain(cuda, dtype, T, nh, hd, ds, chunk):
    """mamba2's and zamba2-7b's (chunk, head_dim, state) take the kernel's
    own instantiations, the rest the generic one; head counts that leave a
    partial block of four heads; one chunk (no state to pass) and 32."""
    g = torch.Generator(device=cuda).manual_seed(T + hd)
    xs = _ssd_inputs(g, cuda, 2, T, nh, hd, ds, dtype)
    before = skernel.ssd_bthd.launches
    got = skernel.ssd_bthd(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert skernel.ssd_bthd.launches == before + 1
    assert got.dtype == dtype and got.shape == xs[0].shape
    _close(got, ssd_ref(*xs, chunk=chunk), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,nh,hd,ds,chunk", [(512, 6, 64, 128, 128),   # mamba2's sizes
                                              (256, 112, 64, 64, 128),  # zamba2-7b's
                                              (128, 3, 64, 128, 128),   # one chunk
                                              (96, 5, 32, 16, 32)])
def test_ssd_kernel_final_state_matches_plain(cuda, dtype, T, nh, hd, ds, chunk):
    """``return_final_state=True``: the (Bsz, nh, hd, ds) float32 state the
    state pass writes out against the plain version's (float32 bound, 1e-5
    of max |state|), the output bit for bit the scan's without the state,
    one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(T + hd + 1)
    xs = _ssd_inputs(g, cuda, 2, T, nh, hd, ds, dtype)
    before = skernel.ssd_bthd.launches
    y, state = skernel.ssd_bthd(*xs, chunk=chunk, return_final_state=True)
    torch.cuda.synchronize()
    assert skernel.ssd_bthd.launches == before + 1
    assert state.shape == (2, nh, hd, ds) and state.dtype == torch.float32
    _, want = ssd_ref(*xs, chunk=chunk, return_final_state=True)
    _close(state, want, torch.float32)
    assert torch.equal(y, skernel.ssd_bthd(*xs, chunk=chunk))


@pytest.mark.cuda
def test_ssd_kernel_refusals(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, B, C = _ssd_inputs(g, cuda, 1, 64, 2, 16, 8, torch.bfloat16)
    with pytest.raises(RuntimeError, match="forward only"):
        skernel.ssd_bthd(x.float().requires_grad_(), dt, A, B.float(), C.float(), chunk=16)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        skernel.ssd_bthd(x, dt, A, B.float(), C, chunk=16)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        skernel.ssd_bthd(x, dt.bfloat16(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="up to 128"):
        skernel.ssd_bthd(*_ssd_inputs(g, cuda, 1, 256, 2, 16, 8, torch.bfloat16), chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        skernel.ssd_bthd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C,
                         chunk=16)


def _ssd_float64(x, dt, A, B, C, chunk):
    """The plain version's chunked scan in float64: an exact yardstick."""
    Bsz, T, nh, hd = x.shape
    ds, Q = B.shape[-1], min(chunk, T)
    NC = T // Q
    xf = x.double().reshape(Bsz, NC, Q, nh, hd)
    dtf = dt.double().reshape(Bsz, NC, Q, nh)
    Bf, Cf = (t.double().reshape(Bsz, NC, Q, ds) for t in (B, C))
    L = torch.cumsum(A.double() * dtf, dim=2)
    Llast = L[:, :, -1:, :]
    decay = torch.exp(torch.clamp(L[:, :, :, None, :] - L[:, :, None, :, :], max=0.0))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = torch.where(mask[None, None, :, :, None],
                    torch.einsum("bnqs,bnps->bnqp", Cf, Bf)[..., None] * decay, 0.0)
    y = torch.einsum("bnqph,bnphd->bnqhd", M, dtf[..., None] * xf)
    S_loc = torch.einsum("bnqhd,bnqs->bnhds",
                         (torch.exp(Llast - L) * dtf)[..., None] * xf, Bf)
    S, prev = torch.zeros_like(S_loc[:, 0]), []
    for c in range(NC):
        prev.append(S)
        S = torch.exp(Llast[:, c, 0, :, None, None]) * S + S_loc[:, c]
    y = y + torch.einsum("bnqs,bnqh,bnhds->bnqhd", Cf, torch.exp(L), torch.stack(prev, 1))
    return y.reshape(Bsz, T, nh, hd)


@pytest.mark.cuda
def test_ssd_kernel_as_accurate_as_plain(cuda):
    """Against a float64 scan, the float32 kernel's largest error is within
    1.5x the plain version's, over 32 chunks with a fast-decaying head (A =
    -11.6, |L| near 1,000 at a chunk's end).  The cumsum L must be summed
    in order: a lane-parallel scan rounds neighbouring L's apart, and
    exp(L_q - L_p) of close steps carries that rounding."""
    g = torch.Generator(device=cuda).manual_seed(4096 + 64)
    xs = _ssd_inputs(g, cuda, 2, 4096, 4, 64, 128, torch.float32)
    assert float(xs[2].min()) < -10
    want = _ssd_float64(*xs, 128)
    top = float(want.abs().max())
    kern = float((skernel.ssd_bthd(*xs, chunk=128).double() - want).abs().max()) / top
    plain = float((ssd_ref(*xs, chunk=128).double() - want).abs().max()) / top
    assert kern <= 1.5 * plain, (kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_attrs(cuda, dtype):
    """At mamba2's and zamba2-7b's instantiations no phase spills, and the
    chunk-states and chunk-outputs phases fit two blocks (16 warps) on an
    SM; any other shape takes the generic instantiation."""
    for shape in ((128, 64, 128), (128, 64, 64)):
        for phase in (1, 2, 3):
            a = skernel.kernel_attrs(phase, dtype, shape)
            assert a["instantiation"] == shape, (shape, phase, a)
            assert a["num_regs"] <= 255 and a["local_bytes"] == 0, (shape, phase, a)
            assert a["blocks_per_sm"] >= (1 if phase == 2 else 2), (shape, phase, a)
    assert skernel.kernel_attrs(1, dtype, (64, 64, 128))["instantiation"] == "generic"


@pytest.mark.cuda
def test_ssd_kernel_refuses_unaligned(cuda):
    """The kernel reads x, B and C 16 bytes at a time."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x, dt, A, B, C = _ssd_inputs(g, cuda, 1, 256, 2, 64, 128, torch.bfloat16)
    flat = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)
    with pytest.raises(ValueError, match="16-byte boundary"):
        skernel.ssd_bthd(flat[1:].view(x.shape), dt, A, B, C, chunk=128)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,flag", [("gemma3-4b", "use_flash"),
                                       ("mamba2-2.7b", "use_ssd_kernel")])
def test_backbone_on_card_runs_through_the_kernels(cuda, arch, flag):
    """The smoke backbones on the card, from the same weights as on the
    CPU: one kernel launch per layer, logits within 2e-4 of the CPU's."""
    cfg = get_config(arch).smoke()
    bb = Backbone(cfg, **{flag: True})
    params = bb.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    counter = fkernel.flash_attention_bhsd if flag == "use_flash" else skernel.ssd_bthd
    want = bb.apply(params, toks)["logits"]
    before = counter.launches
    got = bb.apply(tree_map(lambda x: x.to(cuda), params), toks.to(cuda))["logits"]
    torch.cuda.synchronize()
    assert counter.launches - before == cfg.num_layers
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-medium", "chameleon-34b"])
def test_family_backbones_on_card_run_through_the_kernels(cuda, arch):
    """The hybrid, audio and vlm smoke backbones with their kernel flags on
    the card, from the same weights as on the CPU: ``apply`` and
    ``prefill`` launch flash once per attention layer (zamba2: once per
    group, the shared block; whisper: encoder and decoder) and the SSD scan
    once per Mamba2 layer (the prefill's with its final state); logits
    and the prefill cache within 2e-4 of the CPU's."""
    cfg = get_config(arch).smoke()
    bb = Backbone(cfg, use_flash=True, use_ssd_kernel=True)
    params = bb.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    kw = {}
    if cfg.family == "audio":
        kw["encoder_frames"] = 0.1 * torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                                 generator=torch.Generator().manual_seed(2))
    flash = {"hybrid": bb.n_groups, "audio": cfg.encoder_layers + cfg.num_layers,
             "vlm": cfg.num_layers}[cfg.family]
    ssd = cfg.num_layers - bb.n_groups if cfg.family == "hybrid" else 0
    dev = lambda t: tree_map(lambda x: x.to(cuda), t)  # noqa: E731
    for fn in ("apply", "prefill"):
        want = getattr(bb, fn)(params, toks, **kw)
        before = (fkernel.flash_attention_bhsd.launches, skernel.ssd_bthd.launches)
        got = getattr(bb, fn)(dev(params), toks.to(cuda), **dev(kw))
        torch.cuda.synchronize()
        assert (fkernel.flash_attention_bhsd.launches - before[0],
                skernel.ssd_bthd.launches - before[1]) == (flash, ssd), fn
        assert bool(torch.isfinite(got["logits"]).all())
        torch.testing.assert_close(got["logits"].cpu(), want["logits"], rtol=0, atol=2e-4)
        if fn == "prefill":
            for a, b in zip(tree_leaves(got["cache"]), tree_leaves(want["cache"])):
                torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# captured rounds and the pinned stream
# ---------------------------------------------------------------------------


def _same_state(a, b):
    """Two states equal leaf by leaf in every byte."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x.reshape(-1)), _bits(y.reshape(-1))) for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["toy_2d", "mixed_gaussian"])
def test_captured_rounds_match_eager(cuda, name):
    """Rounds in chunks of 4 and 8 through the captured graph give the
    eager rounds' histories and states bit for bit, and every fedavg
    launch is counted once per round (2 a round: gen and disc)."""
    from repro_torch.kernels import launch_counters
    spec, _ = experiment_spec(name, K=5, steps=40, log_every=0, device=cuda,
                              samples_per_agent=512)
    counters = launch_counters()
    runs = {}
    for c in (1, 4, 8):
        before = {n: f.launches for n, f in counters.items()}
        runs[c] = dataclasses.replace(spec, rounds_per_chunk=c).run_result()
        torch.cuda.synchronize()
        got = {n: f.launches - before[n] for n, f in counters.items()}
        assert got == {n: 16 if n == "fedavg" else 0 for n in counters}, (c, got)
        assert runs[c].timings["captured"] == (c > 1)
    for c in (4, 8):
        assert runs[c].history == runs[1].history
        assert _same_state(runs[c].state, runs[1].state)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["distributed", "partial_sharing", "bf16", "int8",
                                      "topk+int4", "int8-composed", "hierarchical"])
def test_captured_sync_schedules_match_eager(cuda, strategy):
    """Every sync schedule that captures runs its rounds through the
    graph bit for bit as eagerly, with the same launches: none copies to
    or reads from the host inside the round."""
    from repro_torch.core import Hierarchical, PartialSharing, PerStepGradAvg
    from repro_torch.kernels import launch_counters
    strat = {"distributed": PerStepGradAvg(), "partial_sharing": PartialSharing(),
             "bf16": FedAvgSync(sync_dtype=torch.bfloat16),
             "int8": FedAvgSync(codec=IntQuant(8)),
             "topk+int4": FedAvgSync(codec=get_codec("topk+int4", fraction=0.25)),
             "int8-composed": FedAvgSync(codec=IntQuant(8), fused_sync=False),
             "hierarchical": Hierarchical(intra_interval=2)}[strategy]
    spec, _ = experiment_spec("mixed_gaussian", K=4, steps=24, strategy=strat, log_every=0,
                              device=cuda, samples_per_agent=256,
                              agents=8 if strategy == "hierarchical" else None)
    if strategy == "hierarchical":
        spec = dataclasses.replace(spec, agent_grid=(2, 4))
    counters = launch_counters()
    runs, counts = {}, {}
    for c in (1, 6):
        before = {n: f.launches for n, f in counters.items()}
        runs[c] = dataclasses.replace(spec, rounds_per_chunk=c).run_result()
        torch.cuda.synchronize()
        counts[c] = {n: f.launches - before[n] for n, f in counters.items()}
    assert runs[6].timings["captured"] and any(counts[1].values())
    assert counts[6] == counts[1]
    assert runs[6].history == runs[1].history and _same_state(runs[6].state, runs[1].state)


@pytest.mark.cuda
def test_pinned_prefetch_matches_blocking_batches(cuda):
    """The pinned, side-stream upload yields on the card exactly the
    rounds the blocking assembler gives, at every prefetch depth."""
    from repro_torch import prng
    from repro_torch.data import (FederatedRounds, StreamingFederatedData,
                                  stream_key_schedule)
    agent_data = [{"x": torch.arange(40.0) + 100 * i,
                   "y": torch.arange(40) % 7 + i} for i in range(4)]
    extra = lambda g, s: {"z": torch.randn(s + (3,), generator=g)}  # noqa: E731
    fr = FederatedRounds(agent_data, (2, 2), batch_size=8, sync_interval=3,
                         sample_extra=extra)
    key = prng.key(9)
    want = [fr.round_batches(rb) for rb in stream_key_schedule(key, 6)]
    for prefetch in (1, 2, 4, 8):
        got = list(StreamingFederatedData(fr, prefetch=prefetch, device=cuda)
                   .iter_rounds(key, 6))
        torch.cuda.synchronize()
        assert len(got) == 6
        for (gb, gs), (wb, ws) in zip(got, want):
            assert sorted(gb) == sorted(wb)
            assert all(gb[k].is_cuda and torch.equal(gb[k].cpu(), wb[k]) for k in wb)
            assert gs.dtype == torch.uint32 and torch.equal(gs.cpu(), ws)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["adaptive_k", "subsampled"])
def test_host_reading_strategies_run_eager_in_chunks(cuda, strategy):
    """AdaptiveK and SubsampledFedAvg read the round on the host: in
    chunks they run eagerly, report ``captured: False`` and give the
    rounds of ``rounds_per_chunk=1`` bit for bit."""
    from repro_torch.core import get_strategy
    spec, _ = experiment_spec("toy_2d", K=5, steps=40, strategy=get_strategy(strategy),
                              log_every=0, device=cuda, samples_per_agent=512)
    one = spec.run_result()
    chunked = dataclasses.replace(spec, rounds_per_chunk=4).run_result()
    assert chunked.timings["captured"] is False and one.timings["captured"] is False
    assert chunked.history == one.history and _same_state(chunked.state, one.state)


# ---------------------------------------------------------------------------
# serving: the captured decode tick
# ---------------------------------------------------------------------------

SERVE_WORK = [(20, 6), (5, 6), (33, 5), (9, 7), (12, 4)]   # (prompt, new tokens)


def _serve(cfg, params, cuda, **kw):
    """Serve SERVE_WORK (prompts from a fixed seed) through a 2-slot
    engine with ``max_seq`` 48; returns the engine, each request's tokens
    and the logits rows they were sampled from, and the launch counts."""
    from repro_torch.kernels import launch_counters
    from repro_torch.serve import ServeEngine

    class Recording(ServeEngine):
        def _sample(self, row, req):
            self.rows.setdefault(req.rid, []).append(row.copy())
            return super()._sample(row, req)

    eng = Recording(cfg, max_batch=2, max_seq=48, min_bucket=8, params=params, device=cuda,
                    **kw)
    eng.rows = {}
    g = torch.Generator().manual_seed(4)
    rids = []
    for T, n in SERVE_WORK:
        frames = None
        if cfg.family == "audio":   # each request its own encoder frames
            frames = 0.1 * torch.randn((cfg.encoder_seq, cfg.d_model), generator=g)
        rids.append(eng.submit(torch.randint(0, cfg.vocab_size, (T,), generator=g).tolist(),
                               max_new_tokens=n, temperature=0.7, frames=frames))
    counters = launch_counters()
    before = {n: f.launches for n, f in counters.items()}
    done = eng.run()
    torch.cuda.synchronize()
    launches = {n: f.launches - before[n] for n, f in counters.items()}
    return eng, [done[r].generated for r in rids], [eng.rows[r] for r in rids], launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch,ring", [("gemma3-4b", False), ("gemma3-4b", True),
                                       ("mamba2-2.7b", False),
                                       ("granite-moe-3b-a800m", False),
                                       ("zamba2-7b", False), ("whisper-medium", False)])
def test_serve_captured_tick_matches_eager(cuda, arch, ring):
    """The engine's decode tick replayed from its captured graph gives the
    eager tick's logits, tokens (sampled at temperature 0.7 from the same
    host stream) and final cache bit for bit, and neither runs a kernel of
    the port (all launch counters stay)."""
    cfg = get_config(arch).smoke()
    params = Backbone(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    eager = _serve(cfg, params, cuda, ring=ring, capture=False)
    capt = _serve(cfg, params, cuda, ring=ring, capture=True)
    assert capt[0].captured and not eager[0].captured
    assert capt[1] == eager[1]
    assert all(len(a) == len(b) and all((x.view("u4") == y.view("u4")).all()
                                        for x, y in zip(a, b))
               for a, b in zip(capt[2], eager[2]))
    assert _same_state(capt[0].cache, eager[0].cache)
    assert all(v == 0 for v in capt[3].values()) and capt[3] == eager[3]
    assert capt[0].stats.decode_ticks == eager[0].stats.decode_ticks


@pytest.mark.cuda
def test_serve_ring_engine_matches_full_engine(cuda):
    """gemma3-4b's smoke config served with ring caches against the full
    layout: the same tokens, logits within 2e-4 (float32; the ring reads
    the window in another order)."""
    cfg = get_config("gemma3-4b").smoke()
    params = Backbone(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    full = _serve(cfg, params, cuda, ring=False)
    ring = _serve(cfg, params, cuda, ring=True)
    assert ring[1] == full[1]
    for a, b in zip(ring[2], full[2]):
        torch.testing.assert_close(torch.from_numpy(np.stack(a)), torch.from_numpy(np.stack(b)),
                                   rtol=0, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-moe-3b-a800m", "mamba2-2.7b"])
def test_serve_on_one_card_mesh_matches_unsharded(cuda, arch):
    """The engine on the one-card serving mesh (DTensor params and cache,
    every spec replicated) against the unsharded engine: the same tokens,
    logits rows and final cache bit for bit, its tick captured."""
    from repro_torch.dist.sharding import full_tree, is_sharded
    from repro_torch.launch.mesh import make_serving_mesh
    cfg = get_config(arch).smoke()
    params = Backbone(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    plain = _serve(cfg, params, cuda)
    meshed = _serve(cfg, params, cuda, mesh=make_serving_mesh())
    assert meshed[0].captured and all(is_sharded(x) for x in tree_leaves(meshed[0].params))
    assert meshed[1] == plain[1]
    assert all(len(a) == len(b) and all((x.view("u4") == y.view("u4")).all()
                                        for x, y in zip(a, b))
               for a, b in zip(meshed[2], plain[2]))
    assert _same_state(full_tree(meshed[0].cache), plain[0].cache)
    assert meshed[3] == plain[3]


# ---------------------------------------------------------------------------
# the LM GAN (slice 12)
# ---------------------------------------------------------------------------

LM_GAN_ARCHS = ["mixtral-8x22b", "qwen3-8b", "phi4-mini-3.8b", "glm4-9b",
                "granite-moe-3b-a800m", "zamba2-7b", "whisper-medium", "chameleon-34b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_GAN_ARCHS)
def test_lm_gan_round_on_card_matches_cpu(cuda, arch):
    """One LM GAN round (K = 1, SGD) of the arch's ``.smoke()`` config on
    the card against the CPU port, within the CPU-vs-JAX bounds."""
    from torch_shared import lm_gan_round_mismatches
    bad, (ratio, path) = lm_gan_round_mismatches(arch, cuda)
    print(f"{arch}: largest ratio {ratio:.4f} at {path}")
    assert bad == []


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "fused", "composed"])
def test_lm_gan_sync_launches_held_on_card(cuda, case):
    """Two LM GAN rounds of granite's ``.smoke()`` config on the card under
    each sync: every sync kernel launch held in place to its plain version,
    the launch counts those the path implies, agents synced."""
    from torch_shared import held_sync_kernels, sync_cases
    from repro_torch.kernels import launch_counters
    from repro_torch.launch.steps import make_lm_gan_task
    from repro_torch.launch.train import run_arch_smoke
    arch = "granite-moe-3b-a800m"
    L = len(tree_leaves(make_lm_gan_task(get_config(arch).smoke()).init(
        torch.Generator().manual_seed(0))))
    strategy, per_round = sync_cases(L)[case]
    counters = launch_counters()
    before = {n: f.launches for n, f in counters.items()}
    with held_sync_kernels() as held:
        result = run_arch_smoke(arch, steps=2, K=1, seed=0, strategy=strategy, device=cuda,
                                log_every=0)
        torch.cuda.synchronize()
    launches = {n: f.launches - before[n] for n, f in counters.items()}
    assert launches == {n: 2 * per_round.get(n, 0) for n in counters}
    assert {k: v["calls"] for k, v in held.items()} == {k: 2 * v for k, v in per_round.items()}
    for x in tree_leaves(result.state["params"]):
        assert (x == x[:1, :1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen3-8b"])
def test_lm_gan_round_with_remat_on_card_is_the_round_without(cuda, arch):
    """One LM GAN round (K = 2, Adam, FedAvg) of a small ssm and a small
    dense config (``.smoke()`` at d_model 256, 4 layers, T = 64) on a (1, 2)
    grid on the card, from one state and one set of batches: with
    ``cfg.remat`` the new state and the metrics equal those without, bit
    for bit (the recompute runs the same kernels on the same inputs)."""
    from repro_torch.core import FedGAN, FedGANConfig
    from repro_torch.launch.steps import make_lm_gan_task
    from repro_torch.models import remat as remat_op
    from repro_torch.optim import Adam
    from torch_shared import lm_gan_batch
    base = get_config(arch).smoke().scaled(d_model=256, num_layers=4)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        fed = FedGAN(make_lm_gan_task(cfg), FedGANConfig(agent_grid=(1, 2), sync_interval=2),
                     opt_g=Adam(), opt_d=Adam())
        state = fed.init_state(torch.Generator(device=cuda).manual_seed(0), device=cuda)
        batches = tree_map(lambda x: torch.from_numpy(x).to(cuda),
                           lm_gan_batch(cfg, 2, (1, 2), 2, 64))
        remat_op.reset_calls()
        out[remat] = fed.round(state, batches)
        assert bool(remat_op.CALLS) == remat
    for a, b in zip(tree_leaves(out[False]), tree_leaves(out[True])):
        # contiguous bytes: a synced leaf is a stride-0 view over the agents
        assert a.dtype == b.dtype and torch.equal(_bits(a.reshape(-1)), _bits(b.reshape(-1)))


@pytest.mark.cuda
@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_routing_on_card_matches_cpu(cuda, zero_router):
    """The MoE's routing (expert choices, slots, drops) of granite's
    ``.smoke()`` config on the card equal to the CPU's on every token, a
    zero router (every probability tied) included; the output within 1e-5
    of its largest magnitude (float32)."""
    from repro_torch.models.moe import MoE
    cfg = get_config("granite-moe-3b-a800m").smoke().scaled(capacity_factor=0.5)
    moe = MoE(cfg)
    params = moe.init(torch.Generator().manual_seed(0))
    if zero_router:
        params["router"]["w"].zero_()
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    on_card = tree_map(lambda t: t.to(cuda), params)
    for a, b in zip(moe.route(params, x)[2:], moe.route(on_card, x.to(cuda))[2:]):
        assert torch.equal(a, b.cpu())
    y, aux = moe.apply(params, x)
    yc, auxc = moe.apply(on_card, x.to(cuda))
    assert (yc.cpu() - y).abs().max() <= 1e-5 * max(1.0, float(y.abs().max()))
    assert abs(float(auxc) - float(aux)) <= 1e-5 * max(1.0, abs(float(aux)))


# ---------------------------------------------------------------------------
# slice 14: privacy and robustness on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5,), (3, 4), (1_000_003,)])
def test_tensor_threefry_on_card_matches_numpy(cuda, shape):
    """The tensor Threefry on the card, folding in a device step counter,
    bit for bit ``prng``'s numpy Threefry (which the CPU tests hold to
    ``jax.random``)."""
    from repro_torch import prng
    k = prng.key(11)
    for step in (0, 7, 2 ** 31 - 1):
        kt = prng.fold_in_t(prng.key_t(k, cuda), torch.tensor(step, dtype=torch.int32,
                                                              device=cuda))
        assert kt.is_cuda
        got = prng.random_bits_t(kt, shape).cpu().numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, prng.random_bits(prng.fold_in(k, step), shape))


def _acgan_tree(gen, dev, grid=(1, 5)):
    """A (P, A)-stacked tree of the image experiment's generator leaves."""
    from repro_torch.launch.train import acgan_task
    task, _ = acgan_task(hw=16)
    params = task.init(torch.Generator().manual_seed(0))["gen"]
    return tree_map(lambda x: torch.randn(grid + tuple(x.shape), generator=gen, device=dev),
                    params)


@pytest.mark.cuda
def test_masked_sync_on_card_bit_identical_to_average_agents(cuda):
    """The secure sum at the ACGAN generator's leaves: masks drawn on the
    card equal the CPU's, the output is the plain average bit for bit,
    and each call launches one fedavg."""
    from repro_torch import prng
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = _acgan_tree(g, cuda)
    w = _weights(g, cuda)
    key = collectives.mask_pair_key(prng.key_t(prng.key(3), cuda),
                                    torch.tensor(40, dtype=torch.int32, device=cuda))
    before = fedavg_flat.launches
    got = collectives.masked_sync(tree, w, key)
    plain = collectives.average_agents(tree, w)
    torch.cuda.synchronize()
    assert fedavg_flat.launches == before + 2
    for a, b in zip(tree_leaves(got), tree_leaves(plain)):
        assert torch.equal(_bits(a.reshape(-1)), _bits(b.reshape(-1)))
    small = {k: v for k, v in list(tree.items())[:2]}
    wire = collectives.masked_wire(small, w, key)
    cpu_wire = collectives.masked_wire(tree_map(lambda x: x.cpu(), small), w.cpu(), key.cpu())
    for a, b in zip(tree_leaves(wire), tree_leaves(cpu_wire)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(1, 5), (2, 4)])
def test_robust_reduces_on_card_match_cpu(cuda, grid):
    """The median and the trimmed mean on the card bit for bit the CPU's
    (a stable sort, then an order statistic, or adds in sorted order and a
    division by a tensor), with a NaN agent and -0/+0 ties."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(grid + (3, 1000), generator=g, device=cuda)
    x[0, 0, 0, :10] = -0.0
    x[0, 1, 0, :10] = 0.0
    x[0, 2, 1] = float("nan")
    w = torch.full(grid, 1.0 / (grid[0] * grid[1]), device=cuda)
    for kind in ("median", "trimmed_mean"):
        r = collectives.make_robust_reduce(kind)
        got, want = r(x, w).cpu(), r(x.cpu(), w.cpu())
        assert torch.equal(_bits(got.reshape(-1)), _bits(want.reshape(-1))), kind
        assert torch.isfinite(got).all(), kind


@pytest.mark.cuda
def test_dp_per_example_joint_norm_on_card(cuda):
    """Per-example gradients of the image experiment's nets on the card,
    clipped jointly: every example's (G, D) norm is at most C, and C where
    it was above."""
    from repro_torch.launch.train import acgan_task
    from repro_torch.optim import global_norm
    from repro_torch.privacy import per_example_grads
    from repro_torch.core import FedGAN, FedGANConfig
    task, _ = acgan_task(hw=16)
    fed = FedGAN(task, FedGANConfig(agent_grid=(1, 1), sync_interval=1))
    params = tree_map(lambda x: x.to(cuda), task.init(torch.Generator().manual_seed(0)))
    g = torch.Generator(device=cuda).manual_seed(2)
    batch = {"x": torch.rand((8, 16, 16, 3), generator=g, device=cuda) * 2 - 1,
             "y": torch.randint(0, 10, (8,), generator=g, device=cuda),
             "z": torch.randn((8, 62), generator=g, device=cuda)}
    C = 0.5
    gd, gg, nd, ng, _ = per_example_grads(fed._agent_grads, params, batch, C)
    for i in range(8):
        jn = float(global_norm((tree_map(lambda v: v[i], gd), tree_map(lambda v: v[i], gg))))
        assert jn <= C * (1 + 1e-6), (i, jn)
        if float(torch.hypot(nd[i], ng[i])) > C:
            assert abs(jn - C) <= 1e-5 * C, (i, jn)


@pytest.mark.cuda
@pytest.mark.parametrize("privacy", ["secure", "dp", "trimmed_mean"])
def test_captured_privacy_rounds_match_eager(cuda, privacy):
    """The secure sum (its round key folded from the device's step
    counter), DP-SGD (its noise drawn before each replay into static
    buffers) and a robust reduce capture: rounds through the graph equal
    the eager rounds bit for bit, with the same launches."""
    from repro_torch.core import TrimmedMeanSync
    from repro_torch.kernels import launch_counters
    from repro_torch.privacy import DPSGD, SecureAgg
    strat = {"secure": FedAvgSync(secure_agg=SecureAgg(1)), "dp": None,
             "trimmed_mean": TrimmedMeanSync()}[privacy]
    dp = DPSGD(clip=1.0, noise_multiplier=1.0) if privacy == "dp" else None
    spec, _ = experiment_spec("mixed_gaussian", K=4, steps=24, strategy=strat, dp=dp,
                              log_every=0, device=cuda, samples_per_agent=256)
    counters = launch_counters()
    runs, counts = {}, {}
    for c in (1, 6):
        before = {n: f.launches for n, f in counters.items()}
        runs[c] = dataclasses.replace(spec, rounds_per_chunk=c).run_result()
        torch.cuda.synchronize()
        counts[c] = {n: f.launches - before[n] for n, f in counters.items()}
    assert runs[6].timings["captured"] and counts[6] == counts[1]
    assert counts[1]["fedavg"] == (0 if privacy == "trimmed_mean" else 2 * 6)
    assert runs[6].history == runs[1].history and _same_state(runs[6].state, runs[1].state)


# ---------------------------------------------------------------------------
# the virtual-client fleet and the async buffered aggregation
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_fleet_identity_on_card_matches_dense(cuda):
    """With A_total == A_active and the identity schedule the fleet on the
    card is the dense stream run on the card bit for bit (image_acgan's
    nets at a small batch, int8 + EF under Adam), its rows and
    batches paged through pinned buffers; ``cudnn.deterministic`` set,
    since cuDNN's weight gradient is not deterministic otherwise."""
    from repro_torch.data import FederatedRounds, StreamingFederatedData
    from repro_torch.run import RoundDriver
    from repro_torch.run.virtual import init_generators
    strat = FedAvgSync(codec=IntQuant(bits=8))
    fleet_spec, _ = experiment_spec("image_acgan", K=2, steps=6, a_total=5, a_active=5,
                                    batch_size=8, samples_per_agent=64, log_every=0,
                                    strategy=strat, device=cuda)
    fed = fleet_spec.build()
    data = StreamingFederatedData(FederatedRounds(fleet_spec.agent_data, (1, 5), 8, 2,
                                                  sample_extra=fleet_spec.sample_extra),
                                  device=cuda)
    data_rng, init_gen = init_generators(fleet_spec.seed + 1)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        virt = fleet_spec.run_result()
        dense = RoundDriver(fed, data, 3, log_every=0, verbose=False).run(
            data_rng, state=fed.init_state(init_gen(), device=cuda))
    finally:
        torch.backends.cudnn.deterministic = old
    assert virt.timings["swapped_rows"] == 0 and virt.history == dense.history
    assert _same_state(virt.state, dense.state)


@pytest.mark.cuda
def test_fleet_round_on_card_matches_cpu(cuda):
    """One deferred-straggler fleet round (K = 1, a planted late and drop,
    the merge through the fedavg kernel) on the card against the CPU port
    within ``torch_shared``'s round bounds; the dropped slot reverted bit
    for bit on both."""
    from torch_shared import port_fleet_round_mismatches
    (bad, _), dropped = port_fleet_round_mismatches(cuda)
    assert bad == [] and dropped


@pytest.mark.cuda
def test_fleet_merge_and_flush_launch_fedavg(cuda):
    """The deferred merge and the async flush run the fedavg kernel, each
    launch held in place to its plain version: one launch per synced leaf
    per merged round and per flush.  The async demo's journal on the card
    equals the CPU's apart from the params digests, and two card runs are
    byte-identical, digests included."""
    from torch_shared import held_sync_kernels
    from repro_torch.core import FedGAN, FedGANConfig, ParticipationSchedule
    from repro_torch.data import FleetRounds
    from repro_torch.optim import SGD, constant, equal_timescale
    from repro_torch.run.simclock import demo_data, demo_driver, demo_task
    from repro_torch.run.virtual import StragglerPolicy, VirtualClientDriver
    fed = FedGAN(demo_task(1), FedGANConfig(agent_grid=(1, 4), sync_interval=3),
                 opt_g=SGD(), opt_d=SGD(), scales=equal_timescale(constant(0.05)))
    fleet = FleetRounds(demo_data(1, 8), (1, 4), 8, 3)
    faults = lambda r, slots: {slots[0]: "late:1", slots[2]: "drop"} if r == 0 else {}  # noqa: E731
    before = fedavg_flat.launches
    with held_sync_kernels() as held:
        res = VirtualClientDriver(fed, fleet, 3, straggler=StragglerPolicy(mode="defer"),
                                  faults=faults, log_every=0, device=cuda,
                                  schedule=ParticipationSchedule(seed=2)).run(1)
        torch.cuda.synchronize()
        assert fedavg_flat.launches - before == 2 * 3 == held["fedavg"]["calls"]
        assert res.timings["merged_deltas"] == 1
        before = fedavg_flat.launches
        runs = [demo_driver(seed=7, device=cuda) for _ in range(2)]
        for d in runs:
            d.run(7)
        torch.cuda.synchronize()
        flushes = sum(d.journal.counts()["flush"] for d in runs)
        assert fedavg_flat.launches - before == 2 * flushes
    assert runs[0].journal.canonical_bytes() == runs[1].journal.canonical_bytes()
    cpu = demo_driver(seed=7, device="cpu")
    cpu.run(7)
    strip = lambda j: [{k: v for k, v in r.items() if k != "params_digest"}  # noqa: E731
                       for r in j.records]
    assert strip(cpu.journal) == strip(runs[0].journal)

"""A CPU model of the index arithmetic of fedavg's wire and pod routes
(``rows_kernel`` in ``src/repro_torch/csrc/fedavg.cu``: the wire route on
2-byte elements, the pod route on 4-byte float32 and 2-byte bfloat16 or
float16 elements), which run only on the card.

The model follows the kernel lane by lane, in numpy: the launcher's grid
and the blocks given to each pod, each output row's head, whole 16-byte
chunks and tail, the aligned 16-byte word each lane of each warp loads
(bounded to the tensor's own bytes), the next word taken from lane + 1
(lanes 0 to 30 sum a chunk each, lane 31 only loads the word lane 30
needs), the per-row select and funnel shift, and the agent rows in
unrolled groups of 8.  It asserts that every (row, column)
element reaches exactly the lane and slot that sum it, in agent order,
and that no byte outside the tensor is read; four planted faults must
break it.  The intra-pod weights, computed as each block computes them,
must equal the plain version's and the reference's bit for bit, and the
model's gathered rows summed by the plain versions must equal the JAX
reference.  The low-precision pod route's arithmetic (the block's weights
rounded to the leaf's type, the fused chain, one rounding at the end) on
the gathered rows must equal the reference's einsum in that type, and
fail with the weights left unrounded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as jcoll

from repro_torch.kernels.fedavg import kernel as tkernel
from repro_torch.kernels.fedavg import ref as tref

WARPS, GROUP, SPAN = 8, 8, 31  # kWarps, kGroup, kSpan of fedavg.cu
CARD_BLOCKS = 132 * 3         # an H100's SMs x three resident blocks
PAD = 48                      # canary bytes around the tensor in the model's memory
FAULTS = ("shift_left", "no_neighbour", "tail_off_by_one", "row0_shift")


def _launch(P, A, N, esz, blocks=CARD_BLOCKS):
    """``launch_rows``: (grid, per_pod)."""
    spans = (N // (16 // esz) + SPAN - 1) // SPAN
    need = (spans + WARPS - 1) // WARPS if spans > WARPS else 1
    if blocks >= P:
        per_pod = min(blocks // P, need)
        return per_pod * P, per_pod
    return blocks, 1


def _spans_visited(p, grid, per_pod, spans):
    """How often each span (31 chunks) of pod p is taken by a warp of the
    grid: block b starts on pod b // per_pod, strides pods by grid //
    per_pod, and its warps take spans local * 8 + warp, step per_pod * 8.
    Also how many blocks take the pod's scalar head and tail (local 0)."""
    count, scalar = np.zeros(spans, np.int64), 0
    for b in range(grid):
        if p not in range(b // per_pod, 10 ** 9, grid // per_pod):
            continue
        local = b % per_pod
        scalar += local == 0
        for warp in range(WARPS):
            count[local * WARPS + warp::per_pod * WARPS] += 1
    return count, scalar


def _load_words(mem, al, lo, hi, reads):
    """``load_word`` at each 16-byte aligned address of ``al``: (L, 16)
    bytes, the 2-byte halves outside [lo, hi) read as zeros and not read.
    Every byte read is recorded in ``reads``."""
    idx = al[:, None] + np.arange(16)
    inside = (idx >= lo) & (idx < hi)
    reads.append((idx[inside].min(), idx[inside].max()) if inside.any() else None)
    return np.where(inside, mem[np.where(inside, idx, 0)], 0).astype(np.uint8)


def _realign(own, up, s, fault=None):
    """``realign``: bytes [s, s + 16) of the 32 bytes own:up, by two word
    selects and ``__funnelshift_r`` (``shift_left``: ``__funnelshift_l``,
    the shift the wrong way)."""
    c = np.concatenate([own, up], axis=1).view("<u4")       # (L, 8) words
    d = c[:, 2:8] if s & 8 else c[:, 0:6]
    e = d[:, 1:6] if s & 4 else d[:, 0:5]
    bits = np.uint64((s & 3) * 8)
    cat = (e[:, 1:5].astype(np.uint64) << np.uint64(32)) | e[:, 0:4].astype(np.uint64)
    out = (cat << bits) >> np.uint64(32) if fault == "shift_left" else cat >> bits
    return (out & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8)  # (L, 16) bytes


def _kernel_model(x, base, P, fault=None, blocks=CARD_BLOCKS):
    """Run the model on ``x`` (P * A, N) of 2- or 4-byte elements whose
    first byte sits ``base`` bytes past a 16-byte boundary; the output
    (P, N) starts on one (the wrapper allocates it).  Returns the rows as
    the lanes gathered them (uint, zeros where nothing arrived), how many
    times each element arrived, the agent order of the sums, and the
    lowest and highest byte read, relative to the tensor."""
    R, N = x.shape
    A, esz = R // P, x.dtype.itemsize
    V = 16 // esz
    lo = PAD + base
    mem = np.random.default_rng(R * N + base).integers(0, 256, lo + x.nbytes + PAD,
                                                       dtype=np.uint8)
    mem[lo:lo + x.nbytes] = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
    hi = lo + x.nbytes
    got, cover, reads = np.zeros_like(x), np.zeros(x.shape, np.int64), []
    order = []
    grid, per_pod = _launch(P, A, N, esz, blocks)
    for p in range(P):
        out_row = esz * p * N                      # offset of the output row
        head = min(N, ((16 - out_row % 16) % 16) // esz)
        chunks = (N - head) // V
        tail = head + chunks * V
        spans = (chunks + SPAN - 1) // SPAN
        visited, scalar_blocks = _spans_visited(p, grid, per_pod, spans)
        assert (visited == 1).all() and scalar_blocks == 1
        scalar_cols = np.r_[0:head, tail + (fault == "tail_off_by_one"):N]
        lane = np.tile(np.arange(32), spans)
        c = np.repeat(np.arange(spans), 32) * SPAN + lane   # every lane's chunk
        valid = (lane < SPAN) & (c < chunks)
        n0 = head + c * V
        G = A if A <= GROUP else GROUP
        pod_order = []
        s_row0 = None
        for g0 in range(0, A, G):
            for i in range(min(G, A - g0)):        # loads, then adds, in agent order
                r = p * A + g0 + i
                pod_order.append(g0 + i)
                got[r, scalar_cols] = x[r, scalar_cols]
                cover[r, scalar_cols] += 1
                if not spans:
                    continue
                at = lo + esz * (r * N + n0)
                s = at % 16
                assert (s == s[0]).all()           # uniform over the warp (the row)
                s = int(s[0])
                s_row0 = s if s_row0 is None else s_row0
                al = at - s
                own = _load_words(mem, al, lo, hi, reads)
                if fault == "no_neighbour":
                    own[lane == 31] = 0            # lane 31 skips its load
                up = np.roll(own, -1, axis=0)      # __shfl_down_sync(.., 1)
                up[lane == 31] = own[lane == 31]   # lane 31 reads itself back
                vals = _realign(own, up, s_row0 if fault == "row0_shift" else s, fault)
                elems = vals.view(x.dtype)[valid]   # (chunks, V)
                cols = n0[valid, None] + np.arange(V)
                got[r, cols] = elems
                cover[r, cols] += 1
        order.append(pod_order)
    spans_read = [r for r in reads if r is not None]
    first = min(r[0] for r in spans_read) if spans_read else lo
    last = max(r[1] for r in spans_read) if spans_read else hi - 1
    return got, cover, order, (first - lo, last - lo)


def _case(esz, R, N, seed):
    rng = np.random.default_rng(seed)
    dtype = np.uint16 if esz == 2 else np.uint32
    return rng.integers(0, np.iinfo(dtype).max, (R, N), dtype=dtype, endpoint=True)


def _check(x, base, P):
    got, cover, order, (first, last) = _kernel_model(x, base, P)
    assert (cover == 1).all()
    np.testing.assert_array_equal(got, x)
    assert all(o == list(range(x.shape[0] // P)) for o in order)
    assert 0 <= first and last < x.nbytes


ROUTES = {"wire": (2, 1), "pod": (4, 2), "pod_low": (2, 2)}


@pytest.mark.parametrize("rows", [1, 5, 8, 9, 16, 33])
@pytest.mark.parametrize("esz,P", list(ROUTES.values()), ids=list(ROUTES))
def test_every_element_reaches_its_lane_and_slot(esz, P, rows):
    """Both element sizes (the wire route's 2 bytes on one output row, the
    pod route's 4 on two, the low-precision pod route's 2 on two, whose
    second output row starts off alignment at odd N), N at every residue
    mod 8 and at N = 1 and 100,003, base offsets of 0 to 7 elements, 1 to
    33 agent rows a pod."""
    for N in [1, *range(1000, 1008), 100_003]:
        x = _case(esz, P * rows, N, seed=rows * N)
        for k in range(8):
            _check(x, esz * k, P)


@pytest.mark.parametrize("esz,P,A,k", [(2, 1, 5, 0), (2, 1, 5, 3), (4, 2, 4, 0), (4, 2, 4, 1),
                                       (2, 2, 4, 0), (2, 2, 4, 1)])
def test_every_element_reaches_its_lane_at_the_production_bucket(esz, P, A, k):
    """The ACGAN generator bucket, N = 2,314,435 (odd: the bf16 rows sit at
    byte offsets 0, 6, 12, 2, 8 mod 16), on its own allocation and at a
    view k elements past it; three pods on a small grid of blocks."""
    _check(_case(esz, P * A, 2_314_435, seed=k), esz * k, P)
    if P == 2:
        _check(_case(esz, 3 * A, 5003, seed=k), esz * k, 3)


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_a_grid_smaller_than_the_pods_covers_them(blocks):
    """Fewer blocks than pods: each block strides over the pods, and still
    every element arrives once."""
    x = _case(4, 5 * 9, 1003, seed=blocks)
    got, cover, order, _ = _kernel_model(x, 4, 5, blocks=blocks)
    assert (cover == 1).all() and all(o == list(range(9)) for o in order)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("esz,P", list(ROUTES.values()), ids=list(ROUTES))
def test_planted_faults_fail(esz, P, fault):
    """The shift the wrong way, the neighbour word lane 31 loads for lane
    30 dropped, the tail
    off by one element, and row 0's shift for every row: each misplaces
    elements."""
    x = _case(esz, P * 5, 100_003, seed=7)
    got, cover, _, _ = _kernel_model(x, esz, P, fault=fault)
    assert not ((cover == 1).all() and np.array_equal(got, x))


def _block_weights(w):
    """The pod route's prologue as one block runs it: thread 0 sums the
    row in order (__fadd_rn), then each w[p, a] / s_p (__fdiv_rn)."""
    out = np.empty_like(w)
    for p in range(w.shape[0]):
        s = w[p, 0]
        for a in range(1, w.shape[1]):
            s = np.float32(s + w[p, a])
        out[p] = np.divide(w[p], s, dtype=np.float32)
    return out


@pytest.mark.parametrize("A", [1, 3, 4, 9])
def test_hoisted_pod_weights_are_the_reference_bits(A):
    rng = np.random.default_rng(A)
    w = (rng.random((3, A)) * rng.choice([1e-3, 1.0, 30.0], (3, A))).astype(np.float32) + 0.01
    got = _block_weights(w)
    plain = tref.intra_pod_weights(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    want = jnp.asarray(w) / jnp.sum(jnp.asarray(w), axis=1, keepdims=True)
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gathered_wire_rows_sum_to_the_reference(dtype):
    """The rows as the model's lanes gathered them (a view 3 elements past
    alignment, N = 1,003), summed by the wire route's plain version, equal
    the reference's ``weighted_mean`` in that type, run op by op."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((5, 1003)) * 30).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.random((1, 5)).astype(np.float32) + 0.1)
    w = w / w.sum()
    got, _, _, _ = _kernel_model(x.view(torch.int16).numpy().view(np.uint16), 6, 1)
    gathered = torch.from_numpy(got.view(np.int16)).view(dtype)
    mine = tref.fedavg_wire_ref(w, gathered)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = jcoll.weighted_mean(jnp.asarray(x.float().numpy()).astype(jdt).reshape(1, 5, -1),
                               jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(mine.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_gathered_pod_rows_sum_to_the_reference():
    """The pod route's rows as the model's lanes gathered them ((2, 4, 1,003)
    at a view one element past alignment), through the plain version's
    fused multiply-add chain, equal the reference's ``average_intra_pod``."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 4, 1003)) * 30).astype(np.float32)
    w = rng.random((2, 4)).astype(np.float32) + 0.1
    got, _, _, _ = _kernel_model(x.reshape(8, -1).view(np.uint32), 4, 2)
    gathered = torch.from_numpy(got.view(np.float32).reshape(2, 4, -1))
    mine = tref.fedavg_pod_ref(torch.from_numpy(w), gathered)
    want = jcoll.average_intra_pod({"x": jnp.asarray(x)}, jnp.asarray(w))["x"][:, 0]
    np.testing.assert_array_equal(mine.numpy().view(np.int32), np.asarray(want).view(np.int32))


_LOW = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _low_pod_chain(w, gathered, dtype, round_weights=True):
    """The low-precision pod route's arithmetic on the gathered rows (P, A,
    N) of ``dtype``: the block's weights (``_block_weights``) rounded to
    ``dtype`` (the planted fault: left unrounded), both operands widened
    to float32, the fused multiply-add chain from +0 in agent order
    (``__fmaf_rn``), the sum rounded to ``dtype`` once."""
    wb = torch.from_numpy(_block_weights(w))
    if round_weights:
        wb = wb.to(dtype).float()
    acc = torch.zeros((gathered.shape[0], gathered.shape[2]))
    for a in range(gathered.shape[1]):
        acc = tref.fma_f32(wb[:, a:a + 1].expand_as(acc), gathered[:, a].float(), acc)
    return acc.to(dtype)


def _low_pod_case(dtype, seed):
    """Rows gathered by the model ((2, 4, 1,003) at a view one element past
    alignment), their weights and the reference's einsum in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((2, 4, 1003)) * 30).astype(np.float32)).to(dtype)
    w = (rng.random((2, 4)) * rng.choice([1e-3, 1.0, 30.0], (2, 4))).astype(np.float32) + 0.01
    got, _, _, _ = _kernel_model(x.view(torch.int16).reshape(8, -1).numpy().view(np.uint16), 2, 2)
    gathered = torch.from_numpy(got.view(np.int16)).view(dtype).reshape(2, 4, -1)
    jx = jnp.asarray(x.float().numpy()).astype(_LOW[dtype])
    want = jcoll.average_intra_pod({"x": jx}, jnp.asarray(w))["x"][:, 0]
    return w, gathered, np.asarray(want).view(np.int16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gathered_low_pod_rows_sum_to_the_reference(dtype):
    """The low-precision pod route's arithmetic on the model's gathered
    rows equals the reference's einsum in that type bit for bit, and so
    does the plain version; with the block's weights left unrounded to the
    type (a planted fault) it departs."""
    w, gathered, want = _low_pod_case(dtype, seed=3)
    mine = _low_pod_chain(w, gathered, dtype)
    np.testing.assert_array_equal(mine.view(torch.int16).numpy(), want)
    plain = tref.fedavg_pod_low_ref(torch.from_numpy(w), gathered)
    np.testing.assert_array_equal(plain.view(torch.int16).numpy(), want)
    fault = _low_pod_chain(w, gathered, dtype, round_weights=False)
    assert (fault.view(torch.int16).numpy() != want).any()


def test_kernel_attrs_names_every_instantiation():
    """``KERNELS`` follows ``fedavg_attrs``' order: per route (wire bf16,
    wire f16, pod f32, pod bf16, pod f16) 1 to 8 rows, then groups of 8;
    an unknown name is refused before anything is built."""
    assert len(tkernel.KERNELS) == 45 == len(set(tkernel.KERNELS))
    for r, route in enumerate(("wire_bf16", "wire_f16", "pod", "pod_bf16", "pod_f16")):
        assert tkernel.KERNELS[9 * r:9 * r + 9] == tuple(
            f"{route}_{k}" for k in (*range(1, 9), "g8"))
    with pytest.raises(ValueError, match="one of"):
        tkernel.kernel_attrs("wire_bf16_9")

"""The port's qpack ops and wrappers against the JAX reference, on the
CPU (the CUDA kernels against their plain versions on the card are in
``test_torch_cuda.py``).

Every output here is elementwise (a block's max-abs is exact in any
order), so everything must be bit-identical: codes, f16 scales, packed
nibbles and decoded values.  The reference runs both through its Pallas
kernels in interpret mode and through its jnp oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_shared import one_torch_thread  # noqa: F401

from repro.kernels.qpack import kernel as jkernel
from repro.kernels.qpack import ops as jops
from repro.kernels.qpack import ref as jref

from repro_torch.kernels.qpack import kernel as tkernel
from repro_torch.kernels.qpack import ops as tops
from repro_torch.kernels.qpack import ref as tref


def qpack_stream(rng, lead, n, block, bits):
    """float32 (*lead, n) of mixed magnitudes with, in every row, an
    all-zero block, an overflowing block (max-abs / qmax beyond float16's
    range: the scale clamps to 65504 and the codes clip) and a block of
    exact .5 ties (max-abs qmax / 2 gives the scale 0.5, and entries at
    odd multiples of 0.25 sit halfway between two codes)."""
    qmax = 2 ** (bits - 1) - 1
    x = (rng.standard_normal(lead + (n,))
         * rng.choice([1e-3, 1.0, 30.0], lead + (n,))).astype(np.float32)
    if n >= 3 * block:
        x[..., :block] = 0.0
        x[..., block:2 * block] *= 1e7
        ties = 0.25 * (2 * rng.integers(-qmax, qmax, lead + (block,)) + 1)
        ties[..., 0] = qmax / 2
        x[..., 2 * block:3 * block] = ties
    return x


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_bits_equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(want).view(np.uint8))


CASES = [(8, 128, 1000), (4, 128, 1000), (8, 6, 100), (4, 6, 100), (4, 2, 33)]


@pytest.mark.parametrize("bits,block,n", CASES)
@pytest.mark.parametrize("jax_kernel", [False, True], ids=["jnp-ref", "pallas-interpret"])
def test_qpack_ops_match_jax_bit_for_bit(bits, block, n, jax_kernel):
    """quantize, dequantize and roundtrip through the port's ops (pad to
    the block multiple, kernel or plain version, trim) against the
    reference's, on a (2, 3) batch of streams whose length is not a block
    multiple."""
    x = qpack_stream(np.random.default_rng(bits + n), (2, 3), n, block, bits)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jp, js = jops.quantize_blocks(jx, bits=bits, block=block, use_kernel=jax_kernel)
    tp, ts = tops.quantize_blocks(tx, bits=bits, block=block)
    _assert_bits_equal(tp, jp)
    _assert_bits_equal(ts, js)
    _assert_bits_equal(
        tops.dequantize_blocks(tp, ts, n=n, bits=bits, block=block),
        jops.dequantize_blocks(jp, js, n=n, bits=bits, block=block,
                               use_kernel=jax_kernel))
    _assert_bits_equal(
        tops.roundtrip_blocks(tx, bits=bits, block=block),
        jops.roundtrip_blocks(jx, bits=bits, block=block, use_kernel=jax_kernel))


def test_planted_blocks_decode_as_the_reference_says():
    """The planted cases do what they are for: the zero block decodes to
    exact zeros, the overflowing block clips at 65504 * qmax, and the tie
    block rounds half to even."""
    for bits in (4, 8):
        qmax = 2 ** (bits - 1) - 1
        x = qpack_stream(np.random.default_rng(bits), (1,), 512, 128, bits)
        q, s = tref.quant_blocks_ref(torch.from_numpy(x), qmax=qmax, block=128)
        out = tref.dequant_blocks_ref(q, s, block=128).numpy()[0]
        assert float(s[0, 0]) == 0.0 and np.all(out[:128] == 0.0)
        assert float(s[0, 1]) == 65504.0 and np.abs(out[128:256]).max() == 65504.0 * qmax
        assert float(s[0, 2]) == 0.5
        want = np.round(x[0, 256:384] / 0.5)   # numpy rounds half to even
        np.testing.assert_array_equal(q.numpy()[0, 256:384], want)
        assert np.any(want % 2 == 0) and np.all(np.abs(x[0, 257:384] / 0.5) % 1 == 0.5)


def test_pack4_and_unpack4_match_jax_on_every_code():
    """All sixteen 4-bit codes, in both nibble positions."""
    codes = np.arange(-8, 8, dtype=np.int8)
    q = np.stack([np.repeat(codes, 16), np.tile(codes, 16)], -1).reshape(2, -1)
    p = tkernel.pack4_flat(torch.from_numpy(q))
    _assert_bits_equal(p, jref.pack4_ref(jnp.asarray(q)))
    _assert_bits_equal(tkernel.unpack4_flat(p), jref.unpack4_ref(jnp.asarray(_np(p))))
    _assert_bits_equal(tkernel.unpack4_flat(p), q)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 700), rows=st.integers(1, 5), bits=st.sampled_from([4, 8]),
       block=st.sampled_from([2, 4, 64, 128]), seed=st.integers(0, 99))
def test_qpack_property_matches_jax_oracle(n, rows, bits, block, seed):
    x = qpack_stream(np.random.default_rng(seed), (rows,), n, block, bits)
    jp, js = jops.quantize_blocks(jnp.asarray(x), bits=bits, block=block,
                                  use_kernel=False)
    tp, ts = tops.quantize_blocks(torch.from_numpy(x), bits=bits, block=block)
    _assert_bits_equal(tp, jp)
    _assert_bits_equal(ts, js)
    _assert_bits_equal(tops.dequantize_blocks(tp, ts, n=n, bits=bits, block=block),
                       jops.dequantize_blocks(jp, js, n=n, bits=bits, block=block,
                                              use_kernel=False))


@pytest.mark.parametrize("bits", [4, 8])
def test_roundtrip_ref_is_quant_then_dequant(bits):
    """The fused sync's one-pass roundtrip (kernels/qsync) equals the
    codec's two-step one bit for bit."""
    qmax = 2 ** (bits - 1) - 1
    x = torch.from_numpy(qpack_stream(np.random.default_rng(7), (3,), 640, 128, bits))
    q, s = tref.quant_blocks_ref(x, qmax=qmax, block=128)
    _assert_bits_equal(tref.roundtrip_blocks_ref(x, qmax=qmax, block=128),
                       tref.dequant_blocks_ref(q, s, block=128))


def test_qpack_wrappers_check_and_count():
    """CPU tensors take the plain version and launch nothing; anything
    else goes to the kernel's checks and is refused there; dtypes and
    shapes are checked on every device."""
    x = torch.zeros((2, 256))
    counters = (tkernel.quant_flat, tkernel.dequant_flat, tkernel.pack4_flat,
                tkernel.unpack4_flat)
    before = [f.launches for f in counters]
    q, s = tkernel.quant_flat(x, qmax=7)
    tkernel.unpack4_flat(tkernel.pack4_flat(q))
    tkernel.dequant_flat(q, s)
    assert [f.launches for f in counters] == before
    meta = torch.empty((2, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.quant_flat(meta, qmax=127)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.dequant_flat(q.to("meta"), s)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.pack4_flat(q.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.unpack4_flat(torch.empty((2, 8), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="multiple of 128"):
        tkernel.quant_flat(x[:, :200], qmax=127)
    with pytest.raises(ValueError, match="even"):
        tkernel.quant_flat(x, qmax=127, block=7)
    with pytest.raises(TypeError, match="float32"):
        tkernel.quant_flat(x.double(), qmax=127)
    with pytest.raises(ValueError, match="scales"):
        tkernel.dequant_flat(q, s[:, :1])
    with pytest.raises(TypeError, match="int8"):
        tkernel.pack4_flat(q.to(torch.int16))
    with pytest.raises(ValueError, match="multiple of 2"):
        tkernel.pack4_flat(q[:, :3])
    with pytest.raises(TypeError, match="uint8"):
        tkernel.unpack4_flat(q)
    with pytest.raises(ValueError, match="bits"):
        tops.quantize_blocks(x, bits=6)


# Models of the CUDA kernels' arithmetic and thread tiling (csrc/qpack.cu),
# held here against the reference since the kernels run only on the card.

def _byte(w, k):
    return (w >> np.uint32(8 * k)) & np.uint32(0xFF)


def _word(bytes4):
    return sum(b.astype(np.uint32) << np.uint32(8 * k) for k, b in enumerate(bytes4))


def _vsub4(a, b):
    """CUDA's __vsub4: bytewise a - b mod 256, no borrow across bytes."""
    return _word([(_byte(a, k) - _byte(b, k)) & np.uint32(0xFF) for k in range(4)])


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte n of the result is byte sel[4n+2:4n] of
    the eight bytes y:x."""
    pool = [_byte(x, k) for k in range(4)] + [_byte(y, k) for k in range(4)]
    return _word([pool[(sel >> (4 * n)) & 7] for n in range(4)])


def _unpack_words(w, fault=None):
    """The kernel's ``unpack_word`` on uint32 words: two code words each."""
    m, eight = np.uint32(0x0F0F0F0F), np.uint32(0x08080808)
    sext = (lambda x: _vsub4(x, eight)) if fault == "no_xor" else \
        (lambda x: _vsub4(x ^ eight, eight))
    lo, hi = sext(w & m), sext((w >> np.uint32(4)) & m)
    first, second = (0x7362, 0x5140) if fault == "swapped" else (0x5140, 0x7362)
    return _byte_perm(lo, hi, first), _byte_perm(lo, hi, second)


@pytest.mark.parametrize("fault", [None, "swapped", "no_xor"])
@pytest.mark.parametrize("pos", [0, 1, 2, 3])
def test_unpack4_word_arithmetic_matches_jax(pos, fault):
    """unpack4's word arithmetic (masks, __vsub4 sign extension,
    __byte_perm interleave) on all 256 byte values at byte ``pos`` of a
    word, bit for bit against the JAX kernel in interpret mode and the
    plain version; the two planted faults must not match."""
    rng = np.random.default_rng(pos)
    w = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    w = (w & ~np.uint32(0xFF << (8 * pos))) | (np.arange(256, dtype=np.uint32) << np.uint32(8 * pos))
    p = np.stack([_byte(w, k) for k in range(4)], -1).astype(np.uint8).reshape(1, -1)
    a, b = _unpack_words(w, fault)
    got = np.stack([_byte(x, k) for x in (a, b) for k in range(4)], -1)
    got = got.astype(np.uint8).view(np.int8).reshape(1, -1)
    want = np.asarray(jkernel.unpack4_flat(jnp.asarray(p)))
    _assert_bits_equal(tref.unpack4_ref(torch.from_numpy(p)), want)
    if fault is None:
        _assert_bits_equal(got, want)
    else:
        assert not np.array_equal(got, want)


def _dequant_model(buf, offset, scales, block, fault=None):
    """qpack_dequant as the C entry and its kernels run it, thread by
    thread.  The vector route where 4 divides the block and the codes
    start 4-byte aligned: one word of 4 codes a thread, word w in tile
    w // (block // 4).  Else the general route: 16 consecutive codes a
    thread, the tile index stepped at each tile boundary; a length that is
    not a multiple of 16 ends in a short group.  Returns (out, vector)."""
    R, T = scales.shape
    n = R * T * block
    q, s = buf[offset:offset + n], scales.reshape(-1)
    dec = lambda t: s[t].astype(np.float32) if s[t] > 0 else np.float32(1)  # noqa: E731
    vector = block % 4 == 0 and offset % 4 == 0
    out = np.empty(n, np.float32)
    if vector:
        wpt = block if fault == "codes_per_tile" else block // 4
        for w in range(n // 4):
            out[4 * w:4 * w + 4] = q[4 * w:4 * w + 4].astype(np.float32) * dec(w // wpt)
        return out.reshape(R, T * block), vector
    for i0 in range(0, n, 16):
        t = i0 // block
        nxt, sd = (t + 1) * block, dec(t)
        for i in range(i0, min(i0 + 16, n)):
            if i == nxt and fault != "no_step":
                t, nxt = t + 1, nxt + block
                sd = dec(t)
            out[i] = np.float32(q[i]) * sd
    return out.reshape(R, T * block), vector


@pytest.mark.parametrize("offset", [0, 1, 8, 15])
@pytest.mark.parametrize("block,tiles", [(2, 7), (6, 5), (12, 5), (16, 3), (128, 2),
                                         (130, 3)])
def test_dequant_thread_tiling_matches_jax(block, tiles, offset):
    """The model of dequant's routes and tiling on codes that start
    ``offset`` bytes into a buffer, bit for bit against the JAX kernel in
    interpret mode; scales include zeros (decode with 1) and 65504."""
    rng = np.random.default_rng(block * 16 + offset)
    R = 3
    codes = rng.integers(-127, 128, (R, tiles * block)).astype(np.int8)
    scales = rng.uniform(1e-3, 30.0, (R, tiles)).astype(np.float16)
    scales[0, 0], scales[-1, -1] = 0.0, 65504.0
    buf = np.zeros(offset + codes.size + 16, np.int8)
    buf[offset:offset + codes.size] = codes.reshape(-1)
    got, vector = _dequant_model(buf, offset, scales, block)
    assert vector == (offset in (0, 8) and block in (12, 16, 128))
    want = np.asarray(jkernel.dequant_flat(jnp.asarray(codes), jnp.asarray(scales),
                                           block=block))
    _assert_bits_equal(got, want)
    _assert_bits_equal(tref.dequant_blocks_ref(torch.from_numpy(codes),
                                               torch.from_numpy(scales), block=block), want)


@pytest.mark.parametrize("block,offset,fault", [
    (2, 0, "no_step"), (6, 1, "no_step"), (130, 15, "no_step"), (10, 8, "no_step"),
    (12, 0, "codes_per_tile"), (128, 8, "codes_per_tile")])
def test_dequant_model_planted_tile_faults_fail(block, offset, fault):
    """Planted faults in the model decode with the wrong scale: the general
    route that never steps its tile index (wrong wherever a group of 16
    crosses a tile boundary), and the vector route that counts a tile's
    codes where it should count its words."""
    rng = np.random.default_rng(block)
    codes = rng.integers(1, 128, (2, 16 * block)).astype(np.int8)
    scales = rng.uniform(1.0, 30.0, (2, 16)).astype(np.float16)
    buf = np.zeros(offset + codes.size, np.int8)
    buf[offset:] = codes.reshape(-1)
    got, vector = _dequant_model(buf, offset, scales, block, fault=fault)
    assert vector == (fault == "codes_per_tile")
    want = np.asarray(jkernel.dequant_flat(jnp.asarray(codes), jnp.asarray(scales),
                                           block=block))
    assert not np.array_equal(got, want)


def _pack_words(a, b, fault=None):
    """The kernel's ``pack_words`` on uint32 words of 4 codes each: one word
    of 4 packed bytes, the first code of each pair in the low nibble."""
    m = np.uint32(0xFFFFFFFF if fault == "no_mask" else 0x0F0F0F0F)
    pair = lambda w: (w & m) | ((w & m) >> np.uint32(4))  # noqa: E731
    return _byte_perm(pair(a), pair(b), 0x7531 if fault == "odd_bytes" else 0x6420)


def _pack_unit(codes, fault=None):
    """16 int8 codes a row -> their 8 packed bytes, as one thread of the
    vector route makes them: one 16-byte load, two ``pack_words``."""
    w = [_word([codes[:, 4 * i + k].view(np.uint8) for k in range(4)]) for i in range(4)]
    out = [_pack_words(w[0], w[1], fault), _pack_words(w[2], w[3], fault)]
    return np.stack([_byte(x, k) for x in out for k in range(4)], -1).astype(np.uint8)


@pytest.mark.parametrize("fault", [None, "odd_bytes", "no_mask"])
@pytest.mark.parametrize("pair", range(8))
def test_pack4_word_arithmetic_matches_jax(pair, fault):
    """pack4's word arithmetic (the 0x0F0F0F0F mask, the shift-or, the
    0x6420 __byte_perm gather) on every (c_lo, c_hi) pair of int8 values,
    values outside [-7, 7] included, at pair ``pair`` of a 16-code unit,
    bit for bit against the JAX kernel in interpret mode and the plain
    version; the planted faults (the 0x7531 selector, no mask) must not
    match."""
    rng = np.random.default_rng(pair)
    codes = rng.integers(-128, 128, (65536, 16)).astype(np.int8)
    lo, hi = np.meshgrid(np.arange(-128, 128), np.arange(-128, 128), indexing="ij")
    codes[:, 2 * pair], codes[:, 2 * pair + 1] = lo.reshape(-1), hi.reshape(-1)
    want = np.asarray(jkernel.pack4_flat(jnp.asarray(codes), block=16))
    _assert_bits_equal(tref.pack4_ref(torch.from_numpy(codes)), want)
    got = _pack_unit(codes, fault)
    if fault is None:
        _assert_bits_equal(got, want)
    else:
        assert not np.array_equal(got, want)


def _pack4_model(buf, offset, n_bytes, threads=None, fault=None):
    """qpack_pack4 as the C entry and its kernel run it, thread by thread,
    on the codes that start ``offset`` bytes into a 16-byte aligned buffer
    (the output is aligned: the wrapper allocates it).  The vector route
    where the codes are 16-byte aligned: unit u (16 codes, 8 packed bytes)
    at threads u, u + T, ...; then the bytes past the last whole 8 (all of
    them on the general route) one a thread.  T is the C entry's grid of
    256-thread blocks unless given.  Returns (bytes, writes a byte,
    vector)."""
    q = buf[offset:offset + 2 * n_bytes]
    vector = offset % 16 == 0
    work = n_bytes // 8 + 1 if vector else n_bytes
    T = threads or min(-(-work // 256), 1 << 20) * 256
    out, writes = np.zeros(n_bytes, np.uint8), np.zeros(n_bytes, np.int64)
    units = n_bytes // 8 if vector else 0
    for tid in range(min(T, max(units, n_bytes))):
        for u in range(tid, units, T):
            out[8 * u:8 * u + 8] = _pack_unit(q[16 * u:16 * u + 16].reshape(1, 16))[0]
            writes[8 * u:8 * u + 8] += 1
        tail = units * (16 if fault == "tail_from_codes" else 8)
        for j in range(tail + tid, n_bytes, T):
            pad = np.zeros((1, 16), np.int8)
            pad[0, :2] = q[2 * j:2 * j + 2]
            out[j] = _pack_unit(pad)[0, 0]
            writes[j] += 1
    return out.reshape(1, -1), writes, vector


@pytest.mark.parametrize("threads", [None, 5])
@pytest.mark.parametrize("offset", range(16))
def test_pack4_thread_tiling_matches_jax(offset, threads):
    """The model of pack4's routes and tiling, at every offset of the
    codes from 16-byte alignment and at odd lengths, with the C entry's
    grid and with 5 threads striding: every output byte written exactly
    once, bit for bit against the JAX kernel in interpret mode and the
    plain version."""
    for n_bytes in (1, 7, 8, 9, 31, 33, 101):
        rng = np.random.default_rng(offset * 1000 + n_bytes)
        codes = rng.integers(-128, 128, (1, 2 * n_bytes)).astype(np.int8)
        buf = np.zeros(offset + codes.size + 16, np.int8)
        buf[offset:offset + codes.size] = codes[0]
        got, writes, vector = _pack4_model(buf, offset, n_bytes, threads)
        assert vector == (offset == 0)
        assert (writes == 1).all(), n_bytes
        want = np.asarray(jkernel.pack4_flat(jnp.asarray(codes), block=codes.shape[1]))
        _assert_bits_equal(got, want)
        _assert_bits_equal(tref.pack4_ref(torch.from_numpy(codes)), want)


def test_pack4_model_planted_tail_fault_fails():
    """A planted fault in the model's tiling, the tail starting at the
    vector units' code count instead of their byte count, leaves bytes
    unwritten."""
    codes = np.random.default_rng(0).integers(-128, 128, 2 * 33).astype(np.int8)
    _, writes, vector = _pack4_model(codes, 0, 33, fault="tail_from_codes")
    assert vector and (writes == 0).any()

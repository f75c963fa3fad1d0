"""Attention split by query rows ([attn-split]): on a mesh dim whose ranks
divide neither q's heads nor the batch, each rank takes its cut of the
query rows with their positions and the keys and values whole
(``repro_torch.models.layers._attend_on_shards``).

Two holds against the JAX package:

* its compiled FLOPs a device (``jax.jit(...).lower().compile()`` on 8
  forced host devices, read by ``repro.launch.hlo_analysis.
  program_costs``) against the port's FLOPs a rank (``launch.dryrun.
  run_pair`` on a fake group of 8), each in a subprocess of its own, at a
  dense 2-layer config on a (4, 2) mesh, one example an agent;
* ``Attention._sdpa`` on the same numpy inputs against the per-rank row
  function concatenated over 2, 3 and 16 ranks, forward and backward
  (the ranks' k and v gradients summed), with no process group.

The (2, 2) gloo-rank round of the split is in
``tests/test_torch_mesh_ranks.py``.

Decode attention ([attn-decode]): on such a dim a decode keeps its cache
where ``launch.steps.cache_specs`` put it, split by the cache's keys (the
batch-1 long decode) or by head_dim (``_decode_on_shards``).  Held: the
decode step's FLOPs and collective bytes a rank by mesh axis against the
JAX package's compiled step at 3/1 heads on (4, 2), batch 4 (head_dim on
"model") and batch 1 (keys on "data", head_dim on "model"); and the
port's per-slice steps over 2, 3 and 16 key and head_dim slices
(``torch_shared.decode_by_slices``) against the reference's
``_decode_attend``, with three planted faults."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_shared import attend_by_rows, decode_by_slices, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the config: dense, 2 layers, d_model 96, head_dim 32, float32, remat
# off; (heads, kv heads) 3/1 (the heads do not divide "model", the row
# split) and 4/2 (they do); the train round ShapeConfig("x", 512, 4,
# "train"), K = 1, agents-data on ("data", "model") = (4, 2), one example
# an agent; or the decode step ShapeConfig("d", 512, 4, "decode")
_CFG = """
import sys
KIND = sys.argv[1]
def cfg(heads, kv, dtype):
    return ArchConfig(name="t", family="dense", num_layers=2, d_model=96, num_heads=heads,
                      num_kv_heads=kv, head_dim=32, d_ff=128, vocab_size=256, dtype=dtype,
                      remat=False, disc_layers=2, disc_d_model=32, disc_heads=2)
SHAPE = ShapeConfig("x", 512, 4, "train") if KIND == "train" else ShapeConfig("d", 512, 4, "decode")
HEADS = ((3, 1), (4, 2))
"""

_REFERENCE = r"""
import json
import jax, jax.numpy as jnp
import repro  # noqa: F401  (the reference's compat shims)
from repro.launch.hlo_analysis import program_costs
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import AGENTS_DATA, build_step, round_donation
from repro.models.config import ArchConfig, ShapeConfig
""" + _CFG + r"""
mesh = make_test_mesh((4, 2), ("data", "model"))
kw = dict(K=1, plan=AGENTS_DATA) if KIND == "train" else {}
out = {}
for h, kv in HEADS:
    built = build_step(cfg(h, kv, jnp.float32), SHAPE, mesh, **kw)
    with jax.set_mesh(mesh):
        compiled = jax.jit(built.fn, in_shardings=built.in_shardings,
                           out_shardings=built.out_shardings,
                           donate_argnums=round_donation(built)).lower(*built.input_sds).compile()
    out[f"{h}/{kv}"] = program_costs(compiled.as_text())["flops"]
print("FLOPS " + json.dumps(out))
"""

_PORT = r"""
import json, torch
from repro_torch.launch.dryrun import run_pair
from repro_torch.models.config import ArchConfig, ShapeConfig
""" + _CFG + r"""
mesh = tuple(map(int, sys.argv[2:]))
out = {f"{h}/{kv}": run_pair("t", SHAPE.name, cfg=cfg(h, kv, torch.float32), shape=SHAPE,
                             mesh_shape=mesh, K=1)["flops"]
       for h, kv in (HEADS if mesh == (4, 2) else HEADS[:1])}
print("FLOPS " + json.dumps(out))
"""


def _start(code, *argv, **env):
    return subprocess.Popen(
        [sys.executable, "-c", code, *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                            OMP_NUM_THREADS="1", **env))


def _flops(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads([ln for ln in out.splitlines() if ln.startswith("FLOPS ")][-1][6:])


def measure(kind: str) -> dict:
    """{"reference" | "port" | "port (4, 1)": {"heads/kv": FLOPs a device or
    rank}} of the ``kind`` ("train" or "decode") step: the three processes
    run side by side (a fake group and the forced host devices each need a
    process of their own)."""
    procs = {"reference": _start(_REFERENCE, kind, JAX_PLATFORMS="cpu",
                                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
             "port": _start(_PORT, kind, "4", "2"),
             "port (4, 1)": _start(_PORT, kind, "4", "1")}
    try:
        return {k: _flops(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def flops():
    return measure("train")


@pytest.mark.parametrize("heads", ["3/1", "4/2"])
def test_flops_a_rank_within_1_percent_of_the_reference(flops, heads):
    """3/1: the row split (the parent did 1.322x the reference's work, the
    attention whole on both "model" ranks); 4/2: the heads split."""
    port, ref = flops["port"][heads], flops["reference"][heads]
    assert abs(port - ref) <= 0.01 * ref, (heads, port, ref, port / ref)


def test_row_split_halves_the_work_of_one_model_rank(flops):
    """On (4, 2) each "model" rank does half of (4, 1)'s work."""
    half, whole = flops["port"]["3/1"], flops["port (4, 1)"]["3/1"]
    assert half <= 0.505 * whole, (half, whole, half / whole)


# ---------------------------------------------------------------------------
# the row function against the reference's _sdpa
# ---------------------------------------------------------------------------

# name: (B, T, S, heads, kv heads, head_dim, causal, window, first query
# position); keys at positions 0..S-1 (the plain route's)
CASES = {
    "causal": (2, 16, 16, 4, 2, 8, True, None, 0),
    "window": (2, 16, 16, 4, 2, 8, True, 5, 0),
    "cross": (2, 12, 20, 4, 2, 8, False, None, 0),
    "gqa_3_1": (2, 16, 16, 3, 1, 8, True, None, 0),
    "uneven_15": (1, 15, 15, 3, 1, 8, True, 4, 0),
    "frames_1500": (1, 1500, 1500, 2, 1, 4, False, None, 0),
    "offset": (2, 10, 17, 4, 2, 8, True, 6, 7),
}


def _inputs(case):
    B, T, S, nh, nkv, hd, _, _, first = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, g = (rng.standard_normal((B, T, nh, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, nkv, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, g, np.arange(first, first + T, dtype=np.int32)[None]


def _reference(case, q, k, v, g, pos):
    import jax
    import jax.numpy as jnp

    from repro.models.config import ArchConfig as JArchConfig
    from repro.models.layers import Attention as JAttention
    _, _, _, nh, nkv, hd, causal, window, _ = CASES[case]
    attn = JAttention(JArchConfig(name="t", family="dense", num_layers=1, d_model=nh * hd,
                                  num_heads=nh, num_kv_heads=nkv, head_dim=hd, d_ff=8,
                                  vocab_size=8, dtype=jnp.float32), causal=causal)

    @jax.jit
    def value_and_pull(q_, k_, v_, g_):
        y, pull = jax.vjp(lambda *a: attn._sdpa(*a, window=window, causal=causal,
                                                q_positions=jnp.asarray(pos)), q_, k_, v_)
        return (y, *pull(g_))

    return [np.asarray(t) for t in value_and_pull(q, k, v, g)]


@pytest.mark.parametrize("n", [2, 3, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_rows_over_ranks_match_the_reference(case, n):
    """y and q's gradient concatenated over the ranks' rows, k's and v's
    gradients summed over the ranks, each within 1e-5 of max |want| of
    the reference's whole ``_sdpa`` and its ``jax.vjp``."""
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.layers import Attention
    _, _, _, nh, nkv, hd, causal, window, _ = CASES[case]
    q, k, v, g, pos = _inputs(case)
    want = _reference(case, q, k, v, g, pos)
    attn = Attention(ArchConfig(name="t", family="dense", num_layers=1, d_model=nh * hd,
                                num_heads=nh, num_kv_heads=nkv, head_dim=hd, d_ff=8,
                                vocab_size=8, dtype=torch.float32), causal=causal)
    y, dq, dks, dvs = attend_by_rows(
        lambda q_, k_, v_, p_: attn._sdpa(q_, k_, v_, window=window, causal=causal,
                                          q_positions=p_),
        *map(torch.from_numpy, (q, k, v, pos.astype(np.int64), g)), n)
    got = (y, dq, sum(dks), sum(dvs))
    for name, a, b in zip(("y", "dq", "dk", "dv"), got, want):
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-5 * float(np.abs(b).max()), (case, n, name, err)


# ---------------------------------------------------------------------------
# decode: the FLOPs and collective bytes a rank against the reference's
# ---------------------------------------------------------------------------

# 3/1 heads at batch 4 (the batch splits "data", head_dim "model") and at
# batch 1 (the cache's keys split "data", head_dim "model"); 4/2 heads at
# batch 4 split heads and batch, no new split
_DECODE_CASES = """
CASES = {"3/1 B4": (3, 1, ShapeConfig("d", 512, 4, "decode")),
         "3/1 B1": (3, 1, ShapeConfig("l", 512, 1, "decode")),
         "4/2 B4": (4, 2, ShapeConfig("d", 512, 4, "decode"))}
"""

_REFERENCE_DECODE = _REFERENCE.split("mesh = make_test_mesh")[0].replace(
    "from repro.launch.hlo_analysis import program_costs",
    "from repro.launch.hlo_analysis import collective_bytes, program_costs\n"
    "from repro.launch.mesh import mesh_dims") + _DECODE_CASES + r"""
mesh = make_test_mesh((4, 2), ("data", "model"))
out = {}
for name, (h, kv, shape) in CASES.items():
    built = build_step(cfg(h, kv, jnp.float32), shape, mesh)
    with jax.set_mesh(mesh):
        text = jax.jit(built.fn, in_shardings=built.in_shardings,
                       out_shardings=built.out_shardings).lower(*built.input_sds).compile().as_text()
    out[name] = {"flops": program_costs(text)["flops"],
                 "by_axis": collective_bytes(text).bytes_by_axis(mesh_dims(mesh))}
print("FLOPS " + json.dumps(out))
"""

_PORT_DECODE = _PORT.split("mesh = tuple")[0] + _DECODE_CASES + r"""
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from repro_torch.launch.hlo_analysis import DispatchCount
from repro_torch.models import layers
attention = [0]
whole = layers.Attention._decode_attend

def counted(self, *a):
    # the FLOPs the decode attention itself dispatches
    mode = next(m for m in _get_current_dispatch_mode_stack() if isinstance(m, DispatchCount))
    before = mode.flops
    y = whole(self, *a)
    attention[0] += mode.flops - before
    return y

layers.Attention._decode_attend = counted
out = {}
for name, (h, kv, shape) in CASES.items():
    attention[0] = 0
    splits = dict(layers.DECODE_SPLITS)
    rec = run_pair("t", shape.name, cfg=cfg(h, kv, torch.float32), shape=shape,
                   mesh_shape=(4, 2), K=1)
    out[name] = {"flops": rec["flops"], "by_axis": rec["collective_by_axis"],
                 "attention": attention[0],
                 "splits": {k: v - splits[k] for k, v in layers.DECODE_SPLITS.items()}}
print("FLOPS " + json.dumps(out))
"""


def measure_decode() -> dict:
    """{"reference" | "port": {case: {"flops", "by_axis"}}} of the decode
    step's cases; the port's also hold "attention", the FLOPs its decode
    attention dispatches, and "splits", the decode splits it took."""
    procs = {"reference": _start(_REFERENCE_DECODE, "decode", JAX_PLATFORMS="cpu",
                                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
             "port": _start(_PORT_DECODE, "decode")}
    try:
        return {k: _flops(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def decode_costs():
    return measure_decode()


def _attention_whole(h, batch, seq=512, hd=32, layers=2):
    """The FLOPs of the test config's decode attention on one rank
    unsplit: q.k and probs.v, 2 FLOPs a multiply-add each."""
    return layers * 2 * 2 * batch * h * seq * hd


@pytest.mark.parametrize("case", ["3/1 B4", "4/2 B4"])
def test_decode_flops_a_rank_within_5_percent_of_the_reference(decode_costs, case):
    """3/1 at batch 4: head_dim split on "model" (the parent did 1.5714x
    the reference's work, the attention whole on both ranks); 4/2: the
    heads split, unchanged."""
    port, ref = decode_costs["port"][case]["flops"], decode_costs["reference"][case]["flops"]
    assert abs(port - ref) <= 0.05 * ref, (case, port, ref, port / ref)


@pytest.mark.parametrize("case", ["3/1 B4", "3/1 B1", "4/2 B4"])
def test_decode_collective_bytes_a_rank_at_most_the_reference_on_each_axis(decode_costs, case):
    port, ref = decode_costs["port"][case]["by_axis"], decode_costs["reference"][case]["by_axis"]
    for axis in ("model", "agent", "other"):
        assert port[axis] <= 1.1 * ref[axis], (case, axis, port, ref)


@pytest.mark.parametrize("case,over,splits", [
    ("3/1 B4", 2, {"keys": 0, "head_dim": 2}),
    ("3/1 B1", 8, {"keys": 2, "head_dim": 2}),
    ("4/2 B4", 2, {"keys": 0, "head_dim": 0})])
def test_decode_attention_flops_split_over_the_ranks(decode_costs, case, over, splits):
    """The decode attention's own FLOPs a rank: the unsplit attention's
    over the ranks that split it (batch 4: 4 "data" ranks of the batch,
    then 2 of head_dim or heads; batch 1: 4 ranks of the keys times 2 of
    head_dim), and the new splits taken once a layer where they apply,
    never where the heads and the batch split.  At batch 1 the step's
    other FLOPs stay above the reference's, which contracts a quarter of
    d_model a rank in its projections (XLA shards the activations over the
    idle "data" axis): PERF.md names them."""
    h, batch = (3, 4) if case == "3/1 B4" else (3, 1) if case == "3/1 B1" else (4, 4)
    got = decode_costs["port"][case]
    local = batch // 4 if batch % 4 == 0 else batch
    assert got["attention"] * over == _attention_whole(h, local), (case, got)
    assert got["splits"] == splits, (case, got)


# ---------------------------------------------------------------------------
# decode: the key and head_dim slices against the reference's _decode_attend
# ---------------------------------------------------------------------------

# name: (B, S, heads, kv heads, head_dim, index: int (lockstep, an (S,)
# mask) or one a row, window, ring width (0: a full cache))
DECODE_CASES = {
    "scalar": (2, 48, 4, 2, 16, 40, None, 0),
    "per_row": (3, 48, 4, 2, 16, (5, 30, 47), None, 0),
    "window": (2, 48, 4, 2, 16, 37, 9, 0),
    "ring": (2, 24, 4, 2, 16, (9, 53), None, 24),
    "gqa_3_1": (2, 40, 3, 1, 32, (17, 39), None, 0),
    "masked_slices": (1, 48, 4, 2, 16, 2, None, 0),
}


def _decode_inputs(case):
    """q, k, v and the mask of a decode: the lockstep (S,) mask or the
    per-row (B, S) one, windowed where given; a ring cache's slots hold
    the positions written so far (slot s position p = s mod W, -1 empty:
    row 0 is still filling, row 1 has wrapped)."""
    B, S, nh, nkv, hd, index, window, ring = DECODE_CASES[case]
    rng = np.random.default_rng(100 + sorted(DECODE_CASES).index(case))
    q = rng.standard_normal((B, 1, nh, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, nkv, hd)).astype(np.float32) for _ in range(2))
    kpos = np.arange(S)
    if ring:
        idx = np.asarray(index)[:, None]
        pos = np.where(kpos[None] <= idx % S, idx - idx % S + kpos[None],
                       idx - idx % S - S + kpos[None])
        valid = (pos >= 0) & (pos <= idx)
    elif isinstance(index, int):
        valid = kpos <= index
        if window is not None:
            valid &= kpos > index - window
    else:
        valid = kpos[None] <= np.asarray(index)[:, None]
    return q, k, v, valid


def _reference_decode(case, q, k, v, valid):
    import jax.numpy as jnp

    from repro.models.config import ArchConfig as JArchConfig
    from repro.models.layers import Attention as JAttention
    _, _, nh, nkv, hd, _, _, _ = DECODE_CASES[case]
    attn = JAttention(JArchConfig(name="t", family="dense", num_layers=1, d_model=nh * hd,
                                  num_heads=nh, num_kv_heads=nkv, head_dim=hd, d_ff=8,
                                  vocab_size=8, dtype=jnp.float32))
    return np.asarray(attn._decode_attend(q, k, v, jnp.asarray(valid)))


SLICES = {"keys": (1, 0), "head_dim": (0, 1), "both": (1, 1)}


@pytest.mark.parametrize("n", [2, 3, 16])
@pytest.mark.parametrize("split", list(SLICES))
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_slices_match_the_reference(case, split, n):
    """y from the slices within 1e-5 of max |want| of the reference's
    whole ``_decode_attend``: slices whose keys are all masked (empty
    ring slots, keys past the index or outside the window) add nothing
    and no NaN."""
    q, k, v, valid = _decode_inputs(case)
    want = _reference_decode(case, q, k, v, valid)
    on_keys, on_hd = SLICES[split]
    got = decode_by_slices(*map(torch.from_numpy, (q, k, v, valid)), n ** on_keys, n ** on_hd)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (case, split, n, err)


def _drop_first_sum(t, op):
    return t.amax(0) if op == "max" else t[1:].sum(0)


FAULTS = {
    # the parts summed without rescaling each to the slices' max
    "unrescaled": dict(merge=lambda top, part, reduce: reduce(part, "sum")),
    # the first key slice's partial sum dropped
    "dropped": dict(reduce=_drop_first_sum),
    # valid left split by the batch alone: each key slice masks its keys
    # by the first columns of the mask, its local key positions
    "valid_by_batch": dict(valid_cut=lambda r, cut: slice(0, cut.stop - cut.start)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_decode_faults_fail(fault):
    """Each planted fault misses the bound that the slices meet (NaN, from
    a row whose every key was in the dropped slice, misses it too)."""
    case = "per_row"
    q, k, v, valid = _decode_inputs(case)
    want = _reference_decode(case, q, k, v, valid)
    got = decode_by_slices(*map(torch.from_numpy, (q, k, v, valid)), 3, 2, **FAULTS[fault])
    err = float(np.abs(got.numpy() - want).max())
    assert not err <= 1e-5 * float(np.abs(want).max()), (fault, err)


if __name__ == "__main__":
    # the FLOPs table of the train round and the decode step, then the
    # decode cases' FLOPs and collective bytes a rank by axis:
    # PYTHONPATH=src python tests/test_torch_attn_split.py
    for kind in ("train", "decode"):
        got = measure(kind)
        for heads, ref in got["reference"].items():
            port = got["port"][heads]
            print(f"{kind} (4, 2) {heads}: reference {ref}, port {port}, port / reference "
                  f"{port / ref:.4f}; port (4, 1) {got['port (4, 1)'].get(heads)}")
    got = measure_decode()
    for name, ref in got["reference"].items():
        port = got["port"][name]
        print(f"decode (4, 2) {name}: reference {ref['flops']} FLOPs, {ref['by_axis']}; port "
              f"{port['flops']} FLOPs ({port['flops'] / ref['flops']:.4f}), {port['by_axis']}, "
              f"attention {port['attention']}, splits {port['splits']}")

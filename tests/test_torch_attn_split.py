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
``tests/test_torch_mesh_ranks.py``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_shared import attend_by_rows, one_torch_thread  # noqa: F401

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


if __name__ == "__main__":
    # the FLOPs table of the train round and the decode step:
    # PYTHONPATH=src python tests/test_torch_attn_split.py
    for kind in ("train", "decode"):
        got = measure(kind)
        for heads, ref in got["reference"].items():
            port = got["port"][heads]
            print(f"{kind} (4, 2) {heads}: reference {ref}, port {port}, port / reference "
                  f"{port / ref:.4f}; port (4, 1) {got['port (4, 1)'].get(heads)}")

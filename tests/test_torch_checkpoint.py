"""The port's checkpoints against the reference's, on the CPU: the same
on-disk layout, so a checkpoint written by either package restores in the
other bit for bit, bfloat16 (raw bytes, no ``ml_dtypes`` on the port's
side), int32, bool and 0-d leaves and tuples included.  A FedGAN state
written by the reference resumes in the port, whose next round is held to
the reference's within ``torch_shared.assert_round_close``'s bounds.  The
round driver checkpoints every ``ckpt_every`` rounds and resumes from one.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import (K, _batches, _pair, assert_round_close,  # noqa: F401
                          one_torch_thread)

from repro.checkpoint import restore_checkpoint as jrestore, save_checkpoint as jsave

from repro_torch.checkpoint import (list_checkpoints, read_latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves


def _jax_tree(rng):
    f = rng.standard_normal((2, 3, 5)).astype(np.float32)
    return {"w": jnp.asarray(f).astype(jnp.bfloat16),
            "b": jnp.asarray(rng.standard_normal(7).astype(np.float32)),
            "pair": (jnp.asarray(rng.integers(-9, 9, (4,)).astype(np.int32)),
                     jnp.asarray(rng.random(6) > 0.5)),
            "seq": [jnp.zeros((), jnp.int32) + 3, jnp.asarray(np.float16(1.5))],
            "step": jnp.zeros((), jnp.int32) + 40,
            "a_first": {"z": jnp.ones((1,), jnp.float32)}}


def _bits(x):
    """Raw bytes of a leaf of either package, with its shape and dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        name = str(t.dtype).rsplit(".", 1)[-1]
        return t.shape, name, t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.asarray(x)
    return a.shape, a.dtype.name, np.ascontiguousarray(a).tobytes()


def _same(port, ref):
    tl, rl = tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(tl) == len(rl)
    for t, r in zip(tl, rl):
        ts, tn, tb = _bits(t)
        rs, rn, rb = _bits(r)
        assert (tuple(ts), tn.replace("bool", "bool_"), tb) == \
            (tuple(rs), rn.replace("bool", "bool_"), rb)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _jax_tree(np.random.default_rng(0))
    jsave(str(tmp_path), tree, step=20, metadata={"round": 0, "K": 20})
    got, manifest = restore_checkpoint(str(tmp_path), device="cpu")
    _same(got, tree)
    assert isinstance(got["pair"], tuple) and isinstance(got["seq"], list)
    assert got["step"].dim() == 0 and got["w"].dtype == torch.bfloat16
    assert list(got) == list(tree)          # the structure's insertion order
    assert manifest["metadata"] == {"round": 0, "K": 20} and manifest["step"] == 20


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _jax_tree(np.random.default_rng(1))
    port = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                                              else x)), tree)
    port["w"] = port["w"].to(torch.bfloat16)
    save_checkpoint(str(tmp_path), port, step=7, metadata={"note": "port"})
    want, manifest = jrestore(str(tmp_path))
    _same(port, want)
    assert isinstance(want["pair"], tuple) and want["step"].shape == ()
    # the same bytes as the reference writes for the same tree
    other = tmp_path / "ref"
    jsave(str(other), tree, step=7, metadata={"note": "port"})
    for name in ("manifest.json",):
        a = json.loads((tmp_path / "step_00000007" / name).read_text())
        b = json.loads((other / "step_00000007" / name).read_text())
        assert a == b
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as a, \
            np.load(other / "step_00000007" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_latest_list_and_host_restore(tmp_path):
    d = str(tmp_path)
    assert read_latest_step(d) is None and list_checkpoints(d) == []
    t = {"w": torch.arange(6, dtype=torch.float32).to(torch.bfloat16), "n": torch.tensor(3)}
    for step in (2, 10, 4):
        save_checkpoint(d, t, step=step)
    assert read_latest_step(d) == 4 and list_checkpoints(d) == [2, 4, 10]
    assert not [n for n in os.listdir(d) if n.startswith(".LATEST")]
    host, _ = restore_checkpoint(d, step=10, to_device=False)
    assert isinstance(host["n"], np.ndarray) and host["n"].shape == ()
    assert isinstance(host["w"], torch.Tensor) and host["w"].device.type == "cpu"
    assert torch.equal(host["w"], t["w"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_checkpoint(d)


def test_reference_fedgan_state_resumes_in_the_port(tmp_path):
    """A reference FedGAN state after one round (int8 sync with error
    feedback, Adam), written by the reference and restored by the port:
    the port's next round matches the reference's."""
    jfed, tfed, lr = _pair("adam", True)
    rng = np.random.default_rng(0)
    jround = jax.jit(jfed.round)
    seeds = jnp.zeros((K, 1, 5), jnp.uint32)
    jstate, _ = jround(jfed.init_state(jax.random.key(0)),
                       jax.tree_util.tree_map(jnp.asarray, _batches(rng)), seeds)
    jsave(str(tmp_path), jstate, step=K, metadata={"round": 0, "K": K})
    start, _ = restore_checkpoint(str(tmp_path), device="cpu")
    _same(start, jax.device_get(jstate))
    batches = _batches(rng)
    tbatches = jax.tree_util.tree_map(torch.from_numpy, batches)
    tstate, _ = tfed.round(start, tbatches)
    jstate, _ = jround(jstate, jax.tree_util.tree_map(jnp.asarray, batches), seeds)
    assert_round_close(tfed, start, tbatches, tstate, jax.device_get(jstate), "adam", lr,
                       True)


def test_driver_checkpoints_and_resumes(tmp_path):
    """``experiment_spec(ckpt_dir=)``: 8 rounds of K = 2 save every
    ``n_rounds // 4`` = 2 rounds, at steps 4, 8, 12 and 16, with the
    reference's metadata.  LATEST restores to the final state bit for bit;
    a run resumed from step 8 (``run(seed, state=restored)``, as in the
    reference) continues the step count and is reproducible."""
    d = str(tmp_path / "ckpt")
    spec, _ = ttrain.experiment_spec("toy_2d", K=2, steps=16, log_every=0, device="cpu",
                                     ckpt_dir=d)
    result = spec.run_result()
    assert list_checkpoints(d) == [4, 8, 12, 16] and read_latest_step(d) == 16
    last, manifest = restore_checkpoint(d, device="cpu")
    assert manifest["metadata"] == {"round": 7, "K": 2}
    for a, b in zip(tree_leaves(last), tree_leaves(result.state)):
        assert a.dtype == b.dtype and torch.equal(a, b.expand_as(a))
    from repro_torch.run import RoundDriver
    mid, _ = restore_checkpoint(d, step=8, device="cpu")
    fed, data = spec.build(), spec.build_data()
    again = RoundDriver(fed, data, 2, log_every=0, verbose=False).run(5, state=mid)
    assert int(again.state["step"]) == 12
    twice = RoundDriver(fed, data, 2, log_every=0, verbose=False).run(5, state=mid)
    for a, b in zip(tree_leaves(again.state), tree_leaves(twice.state)):
        assert torch.equal(a, b)


def test_train_cli_takes_a_checkpoint_dir(tmp_path):
    d = str(tmp_path / "c")
    result = ttrain.main(["--experiment", "toy_2d", "--device", "cpu", "--K", "1",
                          "--steps", "4", "--log-every", "0", "--ckpt-dir", d,
                          "--seed", "3", "--agents", "3", "--samples-per-agent", "64"])
    assert list_checkpoints(d) == [1, 2, 3, 4]
    assert tuple(result.state["params"]["gen"]["theta"].shape[:2]) == (1, 3)

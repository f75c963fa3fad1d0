"""The port's sharding rules against the reference's, entry for entry, on
the CPU with no ranks: ``filter_spec``, the batch-axes context,
``param_specs`` and ``dp_param_specs`` of every arch's full-width param
and optimizer trees, ``cache_specs`` of every family's cache, the mesh
plans' specs and ``build_train_round``'s state specs, on the meshes
(1, 1), (4, 2), (16, 16) and (2, 16, 16).

Both sides read only axis names and sizes: the reference gets a stand-in
mesh (``axis_names`` and ``devices.shape``), the port an
``AbstractMesh``.  Shapes only: ``jax.eval_shape`` on the reference's
side, meta tensors (``repro_torch.launch.steps.eval_shape``) on the
port's, so chameleon-34b's float32 params are never allocated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.launch.steps as jsteps
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import list_archs
from repro.dist import sharding as jsh
from repro.models.transformer import Backbone as JBackbone
from repro.optim import Adam as JAdam

from repro_torch.configs.registry import get_config
from repro_torch.dist import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Backbone
from repro_torch.optim import Adam
from repro_torch.tree import tree_leaves, tree_map

ARCHS = list_archs()
MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


class FakeMesh:
    """The reference's stand-in mesh (as in tests/test_dist_sharding.py)."""

    def __init__(self, dims: dict):
        self.axis_names = tuple(dims)
        self.devices = np.empty(tuple(dims.values()), dtype=object)


def meshes(dims):
    return FakeMesh(dims), tsh.AbstractMesh(tuple(dims.values()), tuple(dims))


def _jflat(tree) -> dict:
    """{path: entries} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in flat}


def _tflat(tree, path=()) -> dict:
    """{path: entries} of a port spec tree."""
    if isinstance(tree, dict):
        return {p: e for k, v in tree.items() for p, e in _tflat(v, path + (str(k),)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: e for i, v in enumerate(tree) for p, e in _tflat(v, path + (str(i),)).items()}
    assert isinstance(tree, tsh.PartitionSpec), type(tree)
    return {path: tuple(tree)}


def assert_same_specs(jtree, ttree):
    want, got = _jflat(jtree), _tflat(ttree)
    assert got.keys() == want.keys()
    bad = {p: (want[p], got[p]) for p in want if want[p] != got[p]}
    assert not bad, list(bad.items())[:5]


# ---------------------------------------------------------------------------
# the batch-axes context and filter_spec (twins of test_dist_sharding.py)
# ---------------------------------------------------------------------------


def test_batch_axes_context_matches_reference():
    for mod in (jsh, tsh):
        assert mod.current_batch_axes() == ("pod", "data")
    with jsh.batch_axes("model"), tsh.batch_axes("model"):
        assert tsh.current_batch_axes() == jsh.current_batch_axes() == ("model",)
        with jsh.batch_axes(), tsh.batch_axes():
            assert tsh.batch_spec(None) == jsh.batch_spec(None) == (None, None)
        assert tsh.batch_spec(None, "model") == jsh.batch_spec(None, "model")
    assert tsh.batch_spec(None, "model") == jsh.batch_spec(None, "model")
    with pytest.raises(RuntimeError):
        with tsh.batch_axes("data"):
            raise RuntimeError("boom")
    assert tsh.current_batch_axes() == tsh.DEFAULT_BATCH_AXES == jsh.DEFAULT_BATCH_AXES


@pytest.mark.parametrize("entries,shape", [
    ((("pod", "data"), None), (8, 16)),
    (("data", None), (6, 16)),
    ((("pod", "data"), None), (16, 3)),
    ((("pod", "data"), None), (12, 3)),
    ((("model",), None, "model"), (8, 4, 16)),
    (("model", "data"), (4, 8)),
    ((None, ("data", "model")), (3, 64)),
    (("pod", "model", None), (2, 2, 5)),
])
def test_filter_spec_matches_reference(entries, shape):
    for dims in MESHES + [{"data": 4, "model": 2}, {"pod": 2, "data": 4, "model": 2}]:
        jm, tm = meshes(dims)
        assert tuple(tsh.filter_spec(tm, entries, shape)) == \
            tuple(jsh.filter_spec(jm, entries, shape)), dims
    with pytest.raises(ValueError):
        tsh.filter_spec(meshes(MESHES[1])[1], (None, None, None), (4, 4))


def test_shard_is_identity_without_a_mesh_and_on_plain_tensors():
    x = torch.ones(4, 8)
    assert tsh.shard(x, "data", "model") is x
    q = torch.ones(2, 4, 4, 8)
    assert all(a is q for a in tsh.shard_attn_qkv(q, q, q))
    with tsh.use_mesh(meshes(MESHES[1])[1]):
        assert tsh.current_mesh() is not None
        assert tsh.shard(x, "data", "model") is x
    assert tsh.current_mesh() is None


def test_to_placements_maps_entries_to_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    _, tm = meshes({"pod": 2, "data": 4, "model": 2})
    assert tsh.to_placements(tm, tsh.P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.to_placements(tm, tsh.P(None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.to_placements(tm, tsh.P(("data", "pod")))


# ---------------------------------------------------------------------------
# parameter and optimizer specs of every arch at full width
# ---------------------------------------------------------------------------


def _trees(arch):
    """(reference, port) param and optimizer shape trees of the arch."""
    jbb = JBackbone(jget_config(arch))
    jp = jax.eval_shape(jbb.init, jax.random.key(0))
    jopt = jax.eval_shape(JAdam().init, jp)
    tbb = Backbone(get_config(arch))
    def init():
        p = tbb.init(torch.Generator())
        return p, Adam().init(p)

    tp, topt = tsteps.eval_shape(init)
    return (jp, jopt), (tp, topt)


def _stacked(jtree, ttree, lead):
    return (jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(lead + s.shape, s.dtype), jtree),
        tree_map(lambda x: torch.empty(lead + tuple(x.shape), dtype=x.dtype, device="meta"),
                 ttree))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_dp_specs_match_reference(arch):
    (jp, jopt), (tp, topt) = _trees(arch)
    for dims in MESHES:
        jm, tm = meshes(dims)
        for jt, tt in ((jp, tp), (jopt, topt)):
            assert_same_specs(jsh.param_specs(jt, jm), tsh.param_specs(tt, tm))
            assert_same_specs(jsh.param_specs(jt, jm, fsdp_axis="data"),
                              tsh.param_specs(tt, tm, fsdp_axis="data"))
            assert_same_specs(jsh.dp_param_specs(jt, jm), tsh.dp_param_specs(tt, tm))
        # the agent-stacked state: (P, A) lead over ("pod", "data")
        P = dims.get("pod", 1)
        js, ts = _stacked(jp, tp, (P, dims["data"]))
        for plan in ("agents-data", "agents-data-dp", "agents-pod-fsdp"):
            assert_same_specs(jsteps.PLANS[plan].specs(js, jm),
                              tsteps.PLANS[plan].specs(ts, tm))
        assert_same_specs(jsh.param_specs(js, jm, lead=("pod", "data")),
                          tsh.param_specs(ts, tm, lead=("pod", "data")))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    ring = tcfg.sliding_window > 0
    for batch, seq in ((32, 64), (1, 64)):
        jc = jax.eval_shape(lambda: JBackbone(jcfg, ring_cache=ring).init_cache(batch, seq))
        tc = tsteps.eval_shape(lambda: Backbone(tcfg, ring_cache=ring).init_cache(
            batch, seq, device="cpu"))
        for dims in MESHES:
            jm, tm = meshes(dims)
            assert_same_specs(jsteps.cache_specs(jc, jm, batch=batch),
                              tsteps.cache_specs(tc, tm, batch=batch))


def test_plans_match_reference():
    assert tsteps.PLANS.keys() == jsteps.PLANS.keys()
    for name, plan in tsteps.PLANS.items():
        ref = jsteps.PLANS[name]
        assert (plan.agent_lead, plan.fsdp_axis, plan.act_batch_axes, plan.dp_over_model) == \
            (ref.agent_lead, ref.fsdp_axis, ref.act_batch_axes, ref.dp_over_model)
        for dims in MESHES:
            jm, tm = meshes(dims)
            if "data" in dims:
                assert plan.agent_grid(tm) == ref.agent_grid(jm)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_round_state_specs_match_reference(arch, monkeypatch):
    """``build_train_round``'s state specs (params, both optimizers, the
    step) and batch inputs, per plan and mesh.  The reference's builder
    wraps its specs in NamedShardings, which need real devices: here its
    ``named_shardings`` passes the specs through."""
    monkeypatch.setattr(jsteps, "named_shardings", lambda mesh, tree: tree)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    shape = ShapeConfig("train", 64, 64, "train")
    for dims in MESHES:
        jm, tm = meshes(dims)
        for plan in ("agents-data", "agents-data-dp", "agents-pod-fsdp"):
            jb = jsteps.build_train_round(jcfg, shape, jm, plan=jsteps.PLANS[plan], K=2)
            tb = tsteps.build_train_round(tcfg, shape, tm, plan=tsteps.PLANS[plan], K=2)
            assert_same_specs(jb.meta["state_specs"], tb.meta["state_specs"])
            assert_same_specs(jb.in_shardings[1], {k: s.spec for k, s in
                                                   tb.in_shardings[1].items()})
            assert jb.input_sds[1]["tokens"].shape == tb.input_sds[1]["tokens"].shape
            assert {k: v for k, v in jb.meta.items() if k != "state_specs"} == \
                {k: v for k, v in tb.meta.items() if k != "state_specs"}
            assert tsteps.round_donation(tb) == jsteps.round_donation(jb) == (0,)


def test_serving_builders_match_reference(monkeypatch):
    """``build_prefill`` and ``build_decode``'s input specs and shapes."""
    monkeypatch.setattr(jsteps, "named_shardings", lambda mesh, tree: tree)
    for arch in ("gemma3-4b", "whisper-medium"):
        jcfg, tcfg = jget_config(arch), get_config(arch)
        for kind in ("prefill", "decode"):
            shape = ShapeConfig(kind, 128, 32, kind)
            for dims in MESHES:
                jm, tm = meshes(dims)
                jb = jsteps.build_step(jcfg, shape, jm)
                tb = tsteps.build_step(tcfg, shape, tm)
                for js, ts in zip(jb.in_shardings, tb.in_shardings):
                    if js is None:
                        assert ts is None
                        continue
                    ts = tree_map(lambda s: s.spec, ts)
                    if isinstance(js, JP):
                        assert tuple(js) == tuple(ts)
                    else:
                        assert_same_specs(js, ts)
                assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jb.input_sds)] == \
                    [tuple(x.shape) for x in tree_leaves(tb.input_sds)]
                assert jb.meta == tb.meta


def test_meshes_on_one_cpu_rank():
    """Without a launcher a mesh starts a one-rank group: the serving mesh
    is (1, 1); the production meshes need their 256 or 512 ranks; tensor
    parallelism must divide the ranks; a mesh on the card needs one."""
    from repro_torch.launch import mesh as tmesh
    m = tmesh.make_serving_mesh(device="cpu")
    assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")
    assert tsh.mesh_dims(m) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        tmesh.make_serving_mesh(model_parallel=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_serving_mesh()

"""Step builders (a port of ``repro.launch.steps``): (arch x shape x mesh x
plan) -> a step function, its shardings and meta-tensor input specs; and
the LM adversarial task those builders train.

Three step kinds map to the assigned input shapes:
  train   FedGAN round: K local adversarial steps + sync (train_4k)
  prefill generator forward + decode-cache build, last-token logits
  decode  ONE new token against a seq_len KV/SSM cache

Mesh plans for training:
  agents-data      (baseline, the paper's mapping): one agent per
                   (pod, data) index; tensor parallel over "model" within
                   each agent; sync = the agent reduce over ("pod","data").
  agents-data-dp   intra-agent data parallelism over "model": the agent's
                   batch sharded, every leaf stored sharded over "model".
  agents-pod-fsdp  agents = pods only, weights additionally sharded over
                   "data" (FSDP) inside each agent, for the archs whose
                   float32 state does not fit one device.

A built step's ``fn`` takes tensors placed by its ``in_shardings`` (trees
of :class:`~repro_torch.dist.sharding.NamedSharding`: ``place`` puts a
tree there) and binds its mesh itself (``use_mesh``); ``input_sds`` are
meta tensors.  DTensor's sharding propagation inserts the collectives
GSPMD inserts in the reference.  The port's rounds draw no per-agent keys
(its losses take no random state), so a built round takes (state,
batches), without the reference's seeds.

The LM task's fused gradients run the generator forward once, through
``torch.func.vjp``: the discriminator's gradients come from the detached
real and fake features, then the generator's objective is differentiated
in the forward's outputs (hidden states and logits) and pulled back
through the forward, with the cotangent ``router_aux_weight`` on the MoE
router's aux loss (a float32 0 in the other families, which still takes
its cotangent).  An audio-family batch carries the encoder's ``frames``
beside its ``tokens``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vjp

from repro_torch.core.fedgan import FedGAN, FedGANConfig, GANTask
from repro_torch.core.strategies import strategy_from_mode
from repro_torch.dist.sharding import (PartitionSpec, batch_axes, dp_param_specs, filter_spec,
                                       mesh_dims, named_shardings, param_specs, place,
                                       use_mesh)
from repro_torch.models.adversarial import AdversarialLM
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.transformer import Backbone
from repro_torch.optim import Adam, constant, equal_timescale
from repro_torch.tree import tree_leaves, tree_map

P = PartitionSpec


# ---------------------------------------------------------------------------
# Mesh plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    name: str
    agent_lead: tuple          # mesh axes carrying the (P, A) agent grid
    fsdp_axis: str | None      # extra weight-sharding axis inside an agent
    act_batch_axes: tuple      # axes for per-agent activation batch dims
    dp_over_model: bool = False  # intra-agent DP: batch over "model", FSDP weights

    def agent_grid(self, mesh) -> tuple[int, int]:
        dims = mesh_dims(mesh)
        if self.name == "agents-pod-fsdp":
            return (dims.get("pod", 1), 1)
        return (dims.get("pod", 1), dims["data"])

    def specs(self, tree, mesh):
        if self.dp_over_model:
            return dp_param_specs(tree, mesh, lead=self.agent_lead)
        return param_specs(tree, mesh, lead=self.agent_lead, fsdp_axis=self.fsdp_axis)


AGENTS_DATA = MeshPlan("agents-data", ("pod", "data"), None, ())
AGENTS_DATA_DP = MeshPlan("agents-data-dp", ("pod", "data"), None, ("model",),
                          dp_over_model=True)
AGENTS_POD_FSDP = MeshPlan("agents-pod-fsdp", ("pod",), "data", ("data",))
SERVING = MeshPlan("serving", (), None, ("pod", "data"))

PLANS = {p.name: p for p in (AGENTS_DATA, AGENTS_DATA_DP, AGENTS_POD_FSDP, SERVING)}


def eval_shape(fn, *args):
    """The tree ``fn(*args)`` returns, as meta tensors (the twin of
    ``jax.eval_shape``): ``fn`` runs under ``FakeTensorMode``, so a
    full-width init allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*args)
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), out)


def make_lm_gan_task(cfg: ArchConfig, *, adv_weight: float = 0.1) -> GANTask:
    model = AdversarialLM(cfg, adv_weight=adv_weight)
    disc_model = model.discriminator

    def fused(params, batch):
        tokens, frames = batch["tokens"], batch.get("frames")
        gen, disc = params["gen"], params["disc"]

        def gfwd(gp):
            out = model.generator.apply(gp, tokens, encoder_frames=frames)
            return out["hidden"], out["logits"], out["aux"]

        (h, logits, aux), g_vjp = vjp(gfwd, gen)
        real = model.real_features(gen, tokens).detach()
        h_sg = h.detach()

        def dloss(dp):
            lr_ = disc_model.apply(dp, real)
            lf_ = disc_model.apply(dp, h_sg)
            return torch.mean(F.softplus(-lr_)) + torch.mean(F.softplus(lf_))

        gd, ld = grad_and_value(dloss)(disc)

        def gobj(h_, logits_):
            adv = torch.mean(F.softplus(-disc_model.apply(disc, h_)))
            lm = model.lm_loss(logits_, tokens)
            return lm + model.adv_weight * adv, (lm, adv)

        (dh, dlogits), (lg, (lm, adv)) = grad_and_value(
            gobj, argnums=(0, 1), has_aux=True)(h, logits)
        aux_weight = torch.full_like(aux, cfg.router_aux_weight)
        # one pull-back: the forward's saved tensors are freed as it goes
        (gg,) = g_vjp((dh, dlogits, aux_weight), retain_graph=False)
        return gd, gg, {"d_loss": ld, "g_loss": lg, "lm": lm, "adv": adv, "aux": aux}

    def disc_loss(params, batch):
        fake, _, _ = model.fake_features(params["gen"], batch["tokens"], batch.get("frames"))
        real = model.real_features(params["gen"], batch["tokens"])
        return model.disc_loss(params["disc"], real, fake)

    def gen_loss(params, batch):
        total, _ = model.gen_loss(params["gen"], params["disc"], batch["tokens"],
                                  batch.get("frames"))
        return total

    return GANTask(init=model.init, disc_loss=disc_loss, gen_loss=gen_loss,
                   fused_grads=fused)


# ---------------------------------------------------------------------------
# Cache sharding
# ---------------------------------------------------------------------------


def cache_specs(cache_sds, mesh, *, batch: int):
    """PartitionSpec tree for a decode cache.

    k/v: (...stack, B, S, nkv, hd): B over ("pod","data") when divisible,
    otherwise S over "data" (context parallelism for the batch-1 long
    decode); heads over "model" when divisible, else head_dim.
    ssm: (...stack, B, nh, hd, ds): heads over "model".
    conv: (...stack, B, k, ch): channels over "model"."""
    dims = mesh_dims(mesh)
    bdiv = dims.get("pod", 1) * dims["data"]
    batch_ok = batch % bdiv == 0

    def leaf_spec(path_key, leaf):
        nd = leaf.ndim
        ent = [None] * nd
        if path_key in ("k", "v"):
            b_dim, s_dim, h_dim, d_dim = nd - 4, nd - 3, nd - 2, nd - 1
            if batch_ok:
                ent[b_dim] = ("pod", "data")
            else:
                ent[s_dim] = "data"
            if leaf.shape[h_dim] % dims["model"] == 0:
                ent[h_dim] = "model"
            elif leaf.shape[d_dim] % dims["model"] == 0:
                ent[d_dim] = "model"
        elif path_key == "ssm":
            b_dim, h_dim = nd - 4, nd - 3
            if batch_ok:
                ent[b_dim] = ("pod", "data")
            if leaf.shape[h_dim] % dims["model"] == 0:
                ent[h_dim] = "model"
        elif path_key.startswith("conv"):
            b_dim, c_dim = nd - 3, nd - 1
            if batch_ok:
                ent[b_dim] = ("pod", "data")
            if path_key == "conv_x" and leaf.shape[c_dim] % dims["model"] == 0:
                ent[c_dim] = "model"
        # pos and anything else: replicated
        return filter_spec(mesh, tuple(ent), leaf.shape)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, key) for v in tree)
        return leaf_spec(key, tree)

    return walk(cache_sds)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                  # positional args, placed by in_shardings
    input_sds: tuple              # meta-tensor tree per arg
    in_shardings: tuple
    out_shardings: Any
    meta: dict
    fed: Any = None               # the FedGAN a train round runs (its init_state)


def round_donation(built: BuiltStep) -> tuple:
    """The args a step may write into: a train round returns the new state
    as output 0, so arg 0 (the old state) is donatable; serving steps
    donate nothing."""
    return (0,) if built.meta.get("kind") == "train" else ()


def build_train_round(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                      plan: MeshPlan = AGENTS_DATA, K: int = 20, strategy=None,
                      mode: str = "fedgan", sync_dtype=None, intra_interval: int = 0,
                      adv_weight: float = 0.1) -> BuiltStep:
    """The FedGAN round for the LM adversarial task on this mesh.  Pass a
    ``repro_torch.core.strategies.SyncStrategy`` as ``strategy``; the
    legacy ``mode``/``sync_dtype``/``intra_interval`` trio resolves to
    one.  ``fn(state, batches)`` returns (new state placed by the state
    specs, metrics)."""
    Pn, A = plan.agent_grid(mesh)
    B_agents = Pn * A
    if shape.global_batch % B_agents:
        raise ValueError(f"global_batch {shape.global_batch} % {B_agents} agents")
    per_agent = shape.global_batch // B_agents
    if strategy is None:
        strategy = strategy_from_mode(mode, intra_interval=intra_interval,
                                      sync_dtype=sync_dtype)
    fed = FedGAN(make_lm_gan_task(cfg, adv_weight=adv_weight),
                 FedGANConfig(agent_grid=(Pn, A), sync_interval=K, strategy=strategy),
                 opt_g=Adam(), opt_d=Adam(), scales=equal_timescale(constant(1e-4)))

    state_sds = eval_shape(lambda: fed.init_state(torch.Generator(), device="cpu"))
    state_specs = {
        "params": plan.specs(state_sds["params"], mesh),
        "opt_g": plan.specs(state_sds["opt_g"], mesh),
        "opt_d": plan.specs(state_sds["opt_d"], mesh),
        "step": P(),
    }
    # strategy-carried entries (error feedback): the agent-stacked ones
    # (every leaf leading with the (P, A) grid) shard like the params, the
    # shared ones (the downlink residual) are replicated
    for k, sds in state_sds.items():
        if k in state_specs:
            continue
        leaves = tree_leaves(sds)
        stacked = bool(leaves) and all(tuple(x.shape[:2]) == (Pn, A) for x in leaves)
        state_specs[k] = (plan.specs(sds, mesh) if stacked
                          else tree_map(lambda _: P(), sds))

    batch = {"tokens": torch.empty((K, Pn, A, per_agent, shape.seq_len), dtype=torch.int64,
                                   device="meta")}
    batch_specs = {"tokens": filter_spec(
        mesh, (None, "pod", "data", plan.act_batch_axes or None, None), batch["tokens"].shape)}
    if cfg.family == "audio":
        batch["frames"] = torch.empty((K, Pn, A, per_agent, cfg.encoder_seq, cfg.d_model),
                                      dtype=cfg.dtype, device="meta")
        batch_specs["frames"] = filter_spec(
            mesh, (None, "pod", "data", plan.act_batch_axes or None, None, None),
            batch["frames"].shape)

    state_sh = named_shardings(mesh, state_specs)

    def round_fn(state, batches):
        with use_mesh(mesh), batch_axes(*plan.act_batch_axes):
            new, metrics = fed.round(state, batches)
            return place(new, state_sh), metrics

    return BuiltStep(
        fn=round_fn,
        input_sds=(state_sds, batch),
        in_shardings=(state_sh, named_shardings(mesh, batch_specs)),
        out_shardings=(state_sh, None),
        meta={"kind": "train", "plan": plan.name, "K": K, "mode": strategy.name,
              "agents": B_agents, "per_agent_batch": per_agent,
              "state_specs": state_specs},
        fed=fed)


def _param_sds(bb: Backbone):
    return eval_shape(lambda: bb.init(torch.Generator()))


def build_prefill(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                  fsdp: bool = False) -> BuiltStep:
    """The generator's prefill on this mesh: ``fn(params, tokens[, frames])``
    -> {"logits": last-token logits, "cache"}."""
    bb = Backbone(cfg)
    B = shape.global_batch
    params_sds = _param_sds(bb)
    pspecs = param_specs(params_sds, mesh, fsdp_axis="data" if fsdp else None)
    tokens = torch.empty((B, shape.seq_len), dtype=torch.int64, device="meta")
    args_sds = [params_sds, tokens]
    arg_specs = [pspecs, filter_spec(mesh, (("pod", "data"), None), tokens.shape)]
    if cfg.family == "audio":
        frames = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=cfg.dtype, device="meta")
        args_sds.append(frames)
        arg_specs.append(filter_spec(mesh, (("pod", "data"), None, None), frames.shape))

    def prefill_fn(params, tokens, frames=None):
        with use_mesh(mesh):
            out = bb.prefill(params, tokens, encoder_frames=frames, logits_mode="last")
            return {"logits": out["logits"], "cache": out["cache"]}

    return BuiltStep(
        fn=prefill_fn, input_sds=tuple(args_sds),
        in_shardings=tuple(named_shardings(mesh, s) for s in arg_specs),
        out_shardings=None, meta={"kind": "prefill", "plan": "serving", "fsdp": fsdp})


def build_decode(cfg: ArchConfig, shape: ShapeConfig, mesh, *, ring_cache: bool = False,
                 fsdp: bool = False) -> BuiltStep:
    """One decode step on this mesh: ``fn(params, token, cache, index)`` ->
    (logits, new cache); the cache given is not written."""
    bb = Backbone(cfg, ring_cache=ring_cache)
    B, S = shape.global_batch, shape.seq_len
    params_sds = _param_sds(bb)
    pspecs = param_specs(params_sds, mesh, fsdp_axis="data" if fsdp else None)
    cache_sds = eval_shape(lambda: bb.init_cache(B, S, device="cpu"))
    cspecs = cache_specs(cache_sds, mesh, batch=B)
    token = torch.empty((B, 1), dtype=torch.int64, device="meta")
    index = torch.empty((), dtype=torch.int64, device="meta")

    def decode_fn(params, token, cache, index):
        with use_mesh(mesh):
            return bb.decode(params, token, cache, index)

    return BuiltStep(
        fn=decode_fn, input_sds=(params_sds, token, cache_sds, index),
        in_shardings=(named_shardings(mesh, pspecs),
                      named_shardings(mesh, filter_spec(mesh, (("pod", "data"), None),
                                                        token.shape)),
                      named_shardings(mesh, cspecs), None),
        out_shardings=None,
        meta={"kind": "decode", "plan": "serving", "ring": ring_cache, "fsdp": fsdp,
              "cache_seq": S})


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_round(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, **kw)
    if shape.kind == "decode":
        ring = kw.pop("ring_cache", cfg.sliding_window > 0 and shape.name == "long_500k")
        return build_decode(cfg, shape, mesh, ring_cache=ring, **kw)
    raise ValueError(shape.kind)


def input_specs(arch_cfg: ArchConfig, shape: ShapeConfig, mesh, **kw):
    """Meta-tensor stand-ins for every model input of the (arch x shape)
    step on this mesh."""
    return build_step(arch_cfg, shape, mesh, **kw).input_sds

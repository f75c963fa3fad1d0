"""Rematerialisation: the port's twin of the reference's ``jax.checkpoint``
over a layer scan's body.

``remat(fn)`` returns ``fn`` recomputed in the backward: its forward runs
the body without recording its intermediates and saves only the body's
tensor inputs (the carry, the layer's parameters, which are views of their
stack, and the audio decoder's encoder memory); its backward runs the body
again and pulls the cotangents back to every tensor input.  The numbers
are those of ``fn`` itself: the recompute is the same ops on the same
inputs.

One ``torch.autograd.Function`` serves every route of the port's
gradients:

* under ``torch.func`` transforms (the agents' ``vmap(grad_and_value)``,
  the per-example ``vmap`` of DP-SGD inside it, the generator's ``vjp`` of
  the LM GAN), ``generate_vmap_rule`` batches it and the backward
  recomputes through ``torch.func.vjp``;
* under plain ``torch.autograd`` (the agents' gradients on a submesh of
  several ranks, ``dist.sharding.grad_and_value``, whose DTensors carry the
  layout constraints that ``torch.func`` would wrap away), the backward
  recomputes under ``enable_grad`` and pulls back with
  ``torch.autograd.grad``.

With grad disabled (serving, prefill, the captured decode tick) ``fn`` runs
as it is.  A route the op does not support raises; nothing falls back to
keeping the intermediates.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_unflatten

# calls of the op by the site that wrapped the body, as the forward makes
# them; ``reset_calls`` empties it
CALLS: dict = {}


def reset_calls():
    CALLS.clear()


class _Body:
    """The body over its flat tensor inputs, with the inputs' tree and
    (once the forward has run) the outputs' tree."""

    __slots__ = ("fn", "in_def", "out_def")

    def __init__(self, fn, in_def):
        self.fn, self.in_def, self.out_def = fn, in_def, None

    def __call__(self, *leaves):
        flat, self.out_def = tree_flatten(self.fn(*tree_unflatten(self.in_def, list(leaves))))
        return tuple(flat)


def _live(x):
    """``x`` without the wrappers of ``torch.func`` levels that have ended:
    a ``vjp``'s pull-back runs after its level is gone, and its saved
    tensors and cotangents come wrapped for that dead level, which a new
    transform cannot wrap again."""
    fn = torch._C._functorch
    while fn.is_gradtrackingtensor(x) and fn.maybe_get_level(x) < 0:
        x = fn.get_unwrapped(x)
    return x


class Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(body, *leaves):
        return body(*leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        leaves = [_live(x) for x in ctx.saved_tensors]
        cotangents = tuple(_live(c) for c in cotangents)
        if torch._C._functorch.peek_interpreter_stack() is not None:
            _, pull = torch.func.vjp(ctx.body, *leaves)
            return (None, *pull(cotangents, retain_graph=False))
        # the pull-back runs as the engine that called it does: with a
        # graph of the backward when grad is on (a ``torch.func.vjp``'s
        # pull-back), whose gradients are summed as without remat
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(x.is_floating_point()) for x in leaves]
            outs = ctx.body(*xs)
            live = [(o, c) for o, c in zip(outs, cotangents) if o.requires_grad]
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                                           retain_graph=False, create_graph=create,
                                           allow_unused=True))
        return (None, *(next(got) if x.requires_grad else None for x in xs))


def remat(fn, site: str):
    """``fn`` over trees of tensors, recomputed in the backward while grad
    is enabled (the module docstring says how); each such call counts one
    in ``CALLS[site]``."""

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        CALLS[site] = CALLS.get(site, 0) + 1
        leaves, in_def = tree_flatten(args)
        body = _Body(fn, in_def)
        out = Remat.apply(body, *leaves)
        return tree_unflatten(body.out_def, list(out))

    return run

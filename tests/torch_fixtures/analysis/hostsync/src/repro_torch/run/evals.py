"""Documented host-side module (in LintContext.host_side_modules): syncs
here are skipped wholesale."""


def evaluate(state):
    return state["params"].cpu()   # exempt: the whole module is host-side

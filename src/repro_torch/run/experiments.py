"""K-sweep experiment runner (a port of ``repro.run.experiments``): the
paper's robustness-to-reduced-communication curves (metric vs sync
interval K), extended along the wire-codec axis, on the device-resident
round driver, on the card unless told otherwise:

    PYTHONPATH=src python -m repro_torch.run.experiments \\
        --experiment toy_2d --sweep K=5,20,50 --codecs none,int8

Each cell runs ``--rounds-per-chunk`` rounds a chunk (8 by default, as in
the reference), captured in a CUDA graph on the card.

Every cell streams a structured JSONL history (one line per round, one per
mid-run eval, and one ``"final"`` line with the ``repro_torch.evals``
scores, the billed wire bytes per round and the steps per second) into
``<out_dir>/sweep_<experiment>.jsonl``, with the rows' keys of the
reference; the command ends with a summary table of the final metrics vs
K.  The paper's claim is that the FedGAN column barely moves as K grows
while the wire bytes per step drop by K.

``--privacy none,dp,secure,trimmed_mean,median`` adds the privacy axis
(``repro_torch.privacy``) on the same base: per-agent DP-SGD (the final
row then carries the accountant's ``dp_epsilon``), the pairwise-masked
secure sum (bit-identical to the plain sync) and the Byzantine-robust
reduces, which compose with a codec; the secure sum refuses one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Sequence

from repro_torch.core import strategies as sync_strategies
from repro_torch.run.evals import final_fd

PRIVACY_AXES = ("none", "dp", "secure", "trimmed_mean", "median")


@dataclasses.dataclass
class SweepCell:
    """One (K, strategy, codec, privacy) run of the sweep."""

    experiment: str
    K: int
    strategy: str
    history: list
    evals: list
    final: dict
    timings: dict
    codec: str = "none"
    privacy: str = "none"
    bytes_per_round: int = 0

    @property
    def label(self) -> str:
        parts = [self.strategy]
        if self.codec != "none":
            parts.append(self.codec)
        if self.privacy != "none":
            parts.append(self.privacy)
        return "+".join(parts)

    def rows(self):
        base = {"experiment": self.experiment, "K": self.K,
                "strategy": self.strategy, "codec": self.codec,
                "privacy": self.privacy}
        for r, m in enumerate(self.history):
            yield {**base, "round": r, "step": (r + 1) * self.K,
                   **{k: v for k, v in m.items()
                      if isinstance(v, (int, float))}}
        for e in self.evals:
            yield {**base, "eval": True, **e}
        extra = {}
        if "dp_epsilon" in self.timings:
            extra["dp_epsilon"] = self.timings["dp_epsilon"]
        yield {**base, "final": True, **self.final,
               "bytes_per_round": self.bytes_per_round,
               "steps_per_s": round(self.timings["steps_per_s"], 2), **extra}


def _strategy_for(name: str, codec: str = "none", privacy: str = "none"):
    """The sweep cell's (strategy, dp) pair: ``"fedgan"`` keeps the library
    default (``FedAvgSync()``), anything else resolves through the
    registry; a codec spec wraps the fedgan base in a compressed-sync
    ``FedAvgSync`` (error feedback on).  The privacy axis rides the fedgan
    base too: ``"dp"`` turns on per-agent DP-SGD (returned as the dp
    config, not a strategy), ``"secure"`` the pairwise-masked sum,
    ``"trimmed_mean"`` and ``"median"`` the robust reduces (these compose
    with a codec; the secure sum refuses one)."""
    if privacy not in PRIVACY_AXES:
        raise ValueError(f"unknown privacy axis {privacy!r}; "
                         f"known: {list(PRIVACY_AXES)}")
    dp = None
    kwargs = {}
    if codec != "none":
        from repro_torch.comm import get_codec
        kwargs["codec"] = get_codec(codec)
    if privacy == "dp":
        from repro_torch.privacy import DPSGD
        dp = DPSGD(clip=1.0, noise_multiplier=0.8)
    elif privacy == "secure":
        if codec != "none":
            raise ValueError(
                "privacy='secure' cannot ride a lossy codec wire (per-agent "
                "decode at the server reveals the updates the masking "
                "hides); drop the codec or the secure axis")
        from repro_torch.privacy import SecureAgg
        kwargs["secure_agg"] = SecureAgg()
    if privacy == "trimmed_mean":
        return sync_strategies.TrimmedMeanSync(**kwargs), dp
    if privacy == "median":
        return sync_strategies.CoordinateMedianSync(**kwargs), dp
    if kwargs:
        return sync_strategies.FedAvgSync(**kwargs), dp
    return (None if name == "fedgan" else sync_strategies.get_strategy(name)), dp


def run_sweep(experiment: str, Ks: Sequence[int], *,
              strategy_names: Sequence[str] = ("fedgan",),
              codec_names: Sequence[str] = ("none",),
              privacy_names: Sequence[str] = ("none",),
              steps: int | None = None, seed: int = 0, out_dir: str = ".",
              eval_every: int = 0, eval_n: int = 2048, rounds_per_chunk: int = 8,
              verbose: bool = True, device="cuda") -> list:
    """Run the (K x strategy x codec x privacy) grid on ``device``, each
    cell ``rounds_per_chunk`` rounds a chunk, and persist the JSONL
    histories.  Codecs and privacy axes apply to the ``fedgan`` base
    strategy only (the comparison strategies run uncompressed and
    unprotected).  Returns the grid's ``SweepCell``s."""
    from repro_torch.launch.train import experiment_spec
    cells = []
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"sweep_{experiment}.jsonl")
    with open(path, "w") as f:
        for K in Ks:
            for sname in strategy_names:
                specs_c = codec_names if sname == "fedgan" else ("none",)
                specs_p = privacy_names if sname == "fedgan" else ("none",)
                for cname in specs_c:
                    for pname in specs_p:
                        strat, dp = _strategy_for(sname, cname, pname)
                        spec, suite = experiment_spec(
                            experiment, K=K, steps=steps, seed=seed,
                            strategy=strat, dp=dp, log_every=0, eval_every=eval_every,
                            device=device, rounds_per_chunk=rounds_per_chunk)
                        if verbose:
                            print(f"[sweep] {experiment} K={K} strategy={sname} "
                                  f"codec={cname} privacy={pname} "
                                  f"({spec.n_rounds} rounds x {K} steps)", flush=True)
                        res = spec.run_result()
                        final = final_fd(suite, res.fed, res.state, seed=seed, n=eval_n)
                        acct = res.fed.comm_bytes_per_round(res.state)
                        cell = SweepCell(experiment, K, sname, res.history,
                                         res.evals, final, res.timings,
                                         codec=cname, privacy=pname,
                                         bytes_per_round=int(
                                             acct["strategy_bytes_per_round"]))
                        for row in cell.rows():
                            f.write(json.dumps(row) + "\n")
                        f.flush()
                        cells.append(cell)
    if verbose:
        print(f"[sweep] wrote {path}")
        print(summary_table(cells))
    return cells


def summary_table(cells: Sequence[SweepCell]) -> str:
    """Fixed-width (K x strategy x codec) table of the final metrics plus
    bytes/round: the robustness-to-reduced-communication surface in text."""
    labels = list(dict.fromkeys(c.label for c in cells))
    metrics = list(dict.fromkeys(k for c in cells for k in c.final))
    metrics.append("B/round")
    by = {(c.K, c.label): c for c in cells}
    cols = [f"{s}:{m}" for s in labels for m in metrics]
    lines = ["  ".join(["K".rjust(6)] + [c.rjust(18) for c in cols])]
    for K in sorted(dict.fromkeys(c.K for c in cells)):
        row = [str(K).rjust(6)]
        for s in labels:
            cell = by.get((K, s))
            for m in metrics:
                if cell is None:
                    v = None
                elif m == "B/round":
                    v = cell.bytes_per_round
                else:
                    v = cell.final.get(m)
                row.append(("-" if v is None else f"{v:.4g}").rjust(18))
        lines.append("  ".join(row))
    return "\n".join(lines)


def parse_sweep(arg: str) -> list:
    """'K=10,20,100' (or bare '10,20,100') -> [10, 20, 100]."""
    body = arg.split("=", 1)[1] if "=" in arg else arg
    try:
        Ks = [int(x) for x in body.split(",") if x]
    except ValueError:
        raise ValueError(f"bad --sweep {arg!r}; expected K=10,20,100") from None
    if not Ks or any(k < 1 for k in Ks):
        raise ValueError(f"bad --sweep {arg!r}; need positive K values")
    return Ks


def main(argv: Any = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.run.experiments",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--experiment", default="toy_2d")
    ap.add_argument("--sweep", default="K=1,5,20,50",
                    help="sync intervals, e.g. K=10,20,100,500")
    ap.add_argument("--compare", default="",
                    help="comma-separated extra strategies to run beside "
                         "fedgan at every K (e.g. 'partial_sharing')")
    ap.add_argument("--codecs", default="",
                    help="comma-separated wire codec specs to run on the "
                         "fedgan base at every K (e.g. 'none,int8,int4')")
    ap.add_argument("--privacy", default="",
                    help="comma-separated privacy axes to run on the fedgan "
                         "base at every K: none | dp | secure | "
                         "trimmed_mean | median")
    ap.add_argument("--steps", type=int, default=0,
                    help="local steps per run (0 = experiment default)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="rounds between mid-run evals (0 = final only)")
    ap.add_argument("--eval-n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--rounds-per-chunk", type=int, default=8,
                    help="rounds per captured chunk (1 = one eager round at a time)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) needs a GPU")
    args = ap.parse_args(argv)

    names = ["fedgan"] + [s for s in args.compare.split(",") if s]
    for s in names[1:]:
        if s not in sync_strategies.STRATEGIES:
            ap.error(f"unknown --compare strategy {s!r}; known: "
                     f"{sorted(sync_strategies.STRATEGIES)}")
    codecs = [c for c in args.codecs.split(",") if c] or ["none"]
    from repro_torch.comm import get_codec
    for c in codecs:
        if c != "none":
            try:
                get_codec(c)
            except ValueError as e:
                ap.error(str(e))
    privacy = [p for p in args.privacy.split(",") if p] or ["none"]
    for p in privacy:
        if p not in PRIVACY_AXES:
            ap.error(f"unknown --privacy axis {p!r}; known: {list(PRIVACY_AXES)}")
        if p == "secure" and any(c != "none" for c in codecs):
            ap.error("--privacy secure cannot ride a lossy --codecs wire "
                     "(per-agent decode reveals the updates the masking "
                     "hides); drop one")
    return run_sweep(args.experiment, parse_sweep(args.sweep), strategy_names=names,
                     codec_names=codecs, privacy_names=privacy,
                     steps=args.steps or None, seed=args.seed,
                     out_dir=args.out_dir, eval_every=args.eval_every,
                     eval_n=args.eval_n, rounds_per_chunk=args.rounds_per_chunk,
                     device=args.device)


if __name__ == "__main__":
    main()

"""Layer 1: the trace auditor over the port's built rounds (the twin of
``repro.analysis.trace``).

The reference walks the jaxpr of a round.  A PyTorch round has no jaxpr:
a :class:`TracedFn` names one round function, its example arguments and
its donation contract, and :func:`audit_traced` runs it once under a
:class:`TraceAudit`, which watches what the call does (a
``TorchDispatchMode`` for the ops, ``sys.monitoring`` for the key
helpers of ``repro_torch.prng``).  The arguments may be real tensors or
fake ones (``FakeTensorMode``).  The reference's four rule ids, and what
each means in the port:

* ``host-callback-in-scan``: an op that waits on the device, issued
  inside the round's K-step loop (``FedGAN._step``, its gradient hooks,
  a segment sync): ``aten._local_scalar_dense`` (``.item()``,
  ``float(t)``), a copy from the card to the CPU, an op whose output
  shape depends on the data (``nonzero``, ``masked_select``, ``unique``)
  or ``torch.cuda.synchronize()``.  Each one stalls every later launch of
  the round on a host round-trip.  ``DeviceMesh``'s lookups in its host
  table of ranks (slicing a submesh) are host arithmetic and skipped.
* ``raw-fold-in``: a key made from a raw seed inside the loop body:
  ``prng.key``, ``prng.as_key`` or ``torch.Generator().manual_seed``.
  Keys are derived outside the round and threaded through it; a per-step
  raw seed repeats streams across the fleet.
* ``pad-reuse``: two ``prng.fold_in_t`` calls on the same key with the
  same literal salt in one audited call.  In the secure sum's masks
  (``dist.collectives.masked_sync``) that is one-time-pad reuse.
* ``donation-miss``: declared round-state args that the donation
  contract (``launch.steps.round_donation``: the caller hands the old
  state over, so the round can free it as it goes) does not cover.
  Checked on metadata, as in the reference.

Findings anchor at the innermost frame of the call under the audited
root (for a key helper: its caller's), so ``# analysis: allow(rule)``
comments work.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding, filter_suppressed
from repro_torch.analysis.lint import repo_root_from_package
from repro_torch.launch.hlo_analysis import source_anchor

HOST_CALLBACK_RULE = "host-callback-in-scan"
RAW_FOLD_IN_RULE = "raw-fold-in"
PAD_REUSE_RULE = "pad-reuse"
DONATION_RULE = "donation-miss"

_aten = torch.ops.aten
# ops that wait for the device: a value read on the host, or an output
# shape that depends on the data
WAIT_OPS = frozenset(p for p in (
    getattr(_aten, n, None) for n in ("_local_scalar_dense", "item", "nonzero",
                                      "masked_select", "unique", "_unique", "_unique2",
                                      "unique_consecutive", "unique_dim"))
    if p is not None)


@dataclasses.dataclass
class TracedFn:
    """One audit target: a round function, example (real or fake) args,
    and the donation contract of its production call site."""

    name: str
    fn: Callable
    args: tuple
    donate_argnums: tuple = ()
    state_argnums: tuple = ()     # args that are round state (donation candidates)
    origin: tuple = ("", 0)       # (file, line) anchoring metadata-level findings

    def resolved_origin(self, root: str) -> tuple:
        if self.origin[0]:
            return self.origin
        code = getattr(self.fn, "__code__", None) or getattr(
            getattr(self.fn, "__func__", None), "__code__", None)
        if code is not None:
            return _relpath_in(code.co_filename, root), code.co_firstlineno
        return "", 0


def _relpath_in(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), root)
    return "" if rel.startswith("..") else rel.replace(os.sep, "/")


class _WaitMode(TorchDispatchMode):
    def __init__(self, audit):
        super().__init__()
        self.audit = audit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        what = None
        if func._overloadpacket in WAIT_OPS:
            what = f"'{func._overloadpacket.__name__}'"
        elif func._overloadpacket in (_aten._to_copy, _aten.copy_):
            src = args[1] if func._overloadpacket is _aten.copy_ else args[0]
            dst = (args[0].device if func._overloadpacket is _aten.copy_
                   else kwargs.get("device"))
            if isinstance(src, torch.Tensor) and src.device.type != "cpu" and \
                    dst is not None and torch.device(dst).type == "cpu":
                what = "a copy to the CPU"
        if what is not None and not _mesh_bookkeeping(sys._getframe(1)):
            self.audit._host_wait(what, sys._getframe(1))
        return func(*args, **kwargs)


_DEVICE_MESH = os.path.join("torch", "distributed", "device_mesh.py")


def _mesh_bookkeeping(frame) -> bool:
    """Whether the op comes from ``DeviceMesh``'s own rank-table lookups
    (slicing a submesh finds this rank with ``nonzero`` on the mesh's host
    tensor of ranks): host arithmetic, no wait on the device."""
    while frame is not None:
        if frame.f_code.co_filename.endswith(_DEVICE_MESH):
            return True
        frame = frame.f_back
    return False


def _monitor_tool() -> int:
    for tid in (5, 4, 3):
        try:
            sys.monitoring.use_tool_id(tid, "repro_torch.analysis")
            return tid
        except ValueError:
            continue
    raise RuntimeError("no free sys.monitoring tool id for the trace audit")


class TraceAudit:
    """Watches everything run inside it and collects raw findings
    (suppressions not applied) in ``findings``: the host waits inside the
    loop, raw keys inside the loop, and ``fold_in_t`` salts reused on one
    key (module docstring)."""

    def __init__(self, name: str, root: str | None = None):
        from repro_torch.launch.hlo_analysis import _loop_codes
        self.name = name
        self.root = root or repo_root_from_package()
        self.findings: list = []
        self._codes = _loop_codes()
        self._fold_ins: dict = {}
        self._keys: list = []     # keeps audited keys alive: ids stay unique
        self._undo: list = []
        self._seen: set = set()   # one finding a site, however many steps reach it

    def _add(self, finding: Finding) -> None:
        key = (finding.rule, finding.file, finding.line, finding.message)
        if key not in self._seen:
            self._seen.add(key)
            self.findings.append(finding)

    # -- what the hooks report -------------------------------------------
    def _in_loop(self, frame) -> bool:
        while frame is not None:
            if frame.f_code in self._codes:
                return True
            frame = frame.f_back
        return False

    def _host_wait(self, what: str, frame) -> None:
        if self._in_loop(frame):
            f, line = source_anchor(self.root, frame)
            self._add(Finding(
                rule=HOST_CALLBACK_RULE, file=f, line=line,
                message=f"[{self.name}] {what} waits on the device inside the K-step "
                        "loop: every step blocks the round on a host round-trip"))

    def _raw_key(self, what: str, frame) -> None:
        if self._in_loop(frame):
            f, line = source_anchor(self.root, frame)
            self._add(Finding(
                rule=RAW_FOLD_IN_RULE, file=f, line=line,
                message=f"[{self.name}] key made from a raw seed ({what}) inside the "
                        "loop body: derive keys outside the round and thread them "
                        "through it"))

    def _fold_in(self, frame) -> None:
        key, salt = frame.f_locals.get("k"), frame.f_locals.get("data")
        if not isinstance(salt, int) or isinstance(salt, bool):
            return                       # literal salts only, as the reference
        self._keys.append(key)
        sig = (id(key), salt)
        here = source_anchor(self.root, frame.f_back)
        first = self._fold_ins.get(sig)
        if first is None:
            self._fold_ins[sig] = here
            return
        self._add(Finding(
            rule=PAD_REUSE_RULE, file=here[0], line=here[1],
            message=f"[{self.name}] fold_in_t on the same key with the same literal "
                    f"salt ({salt!r}) twice in one call: pad/key reuse (first use at "
                    f"{first[0]}:{first[1]})"))

    # -- entering and leaving --------------------------------------------
    def __enter__(self):
        from repro_torch import prng
        mon = sys.monitoring
        tool = _monitor_tool()
        watched = {prng.key.__code__: lambda fr: self._raw_key("prng.key", fr.f_back),
                   prng.as_key.__code__: lambda fr: self._raw_key("prng.as_key", fr.f_back),
                   prng.fold_in_t.__code__: self._fold_in}

        def on_start(code, _offset):
            hook = watched.get(code)
            if hook is not None:
                hook(sys._getframe(1))

        mon.register_callback(tool, mon.events.PY_START, on_start)
        for code in watched:
            mon.set_local_events(tool, code, mon.events.PY_START)

        def unmonitor():
            for code in watched:
                mon.set_local_events(tool, code, 0)
            mon.register_callback(tool, mon.events.PY_START, None)
            mon.free_tool_id(tool)

        self._undo.append(unmonitor)
        audit = self
        gen_cls, sync = torch.Generator, torch.cuda.synchronize

        class _SeedWatch(gen_cls):
            def manual_seed(self, seed):
                audit._raw_key("torch.Generator().manual_seed", sys._getframe(1))
                return super().manual_seed(seed)

        def watched_sync(*a, **kw):
            audit._host_wait("torch.cuda.synchronize()", sys._getframe(1))
            return sync(*a, **kw)

        torch.Generator, torch.cuda.synchronize = _SeedWatch, watched_sync

        def unpatch():
            torch.Generator, torch.cuda.synchronize = gen_cls, sync

        self._undo.append(unpatch)
        mode = _WaitMode(self)
        mode.__enter__()
        self._undo.append(lambda: mode.__exit__(None, None, None))
        return self

    def __exit__(self, *exc):
        while self._undo:
            self._undo.pop()()
        self._keys.clear()
        return False


def donation_findings(target, donate_argnums, root: str | None = None) -> list:
    """``donation-miss`` findings of a :class:`TracedFn` or a built step:
    the round-state args that ``donate_argnums`` leaves out."""
    root = root or repo_root_from_package()
    if not isinstance(target, TracedFn):
        kind = target.meta.get("kind", "step")
        target = TracedFn(f"built.{kind}", target.fn, tuple(target.input_sds),
                          state_argnums=(0,) if kind == "train" else ())
    from repro_torch.launch.hlo_analysis import tree_bytes
    ofile, oline = target.resolved_origin(root)
    out = []
    for i in target.state_argnums:
        if i in tuple(donate_argnums):
            continue
        size = tree_bytes(target.args[i]) if i < len(target.args) else 0
        out.append(Finding(
            rule=DONATION_RULE, file=ofile, line=oline,
            message=f"[{target.name}] round-state arg {i} ({size} bytes here, O(model) at "
                    f"scale) is not in donate_argnums={tuple(donate_argnums)}: the round "
                    "keeps two copies of the state live"))
    return out


def audit_traced(target: TracedFn, root: str | None = None) -> list:
    """Run ``target`` once under a :class:`TraceAudit` and return its raw
    findings (suppressions NOT applied: callers go through
    :func:`run_trace` or ``filter_suppressed``)."""
    root = root or repo_root_from_package()
    findings = donation_findings(target, target.donate_argnums, root)
    with TraceAudit(target.name, root) as audit:
        target.fn(*target.args)
    return findings + audit.findings


def audit_built(built, *, donate_argnums: tuple = (), root: str | None = None,
                name: str | None = None, args: tuple | None = None) -> list:
    """Audit a ``repro_torch.launch.steps.BuiltStep``: run ``built.fn`` once
    on ``args`` (placed by its ``in_shardings``), or, without them, on fake
    inputs of its ``input_sds`` shapes under ``FakeTensorMode`` (its mesh's
    process group must be up; a fake one serves)."""
    kind = built.meta.get("kind", "step")
    name = name or f"built.{kind}"
    state = (0,) if kind == "train" else ()
    if args is not None:
        return audit_traced(TracedFn(name, built.fn, tuple(args),
                                     donate_argnums=tuple(donate_argnums),
                                     state_argnums=state), root)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import fake_inputs
    with FakeTensorMode():
        fake = fake_inputs(built)
        return audit_traced(TracedFn(name, built.fn, fake, donate_argnums=tuple(donate_argnums),
                                     state_argnums=state), root)


# ---------------------------------------------------------------------------
# Default targets: the toy rounds the CLI audits on every run
# ---------------------------------------------------------------------------


def default_targets() -> list:
    """Three round targets on the CPU: the streamed round (batches given),
    the device-resident sampling round, and the secure-sum sync round.
    Their donation contract is ``RoundDriver``'s: it hands the state over
    (argument 0)."""
    import numpy as np

    from repro_torch.core import FedGAN, FedGANConfig, make_gan_task
    from repro_torch.core.strategies import FedAvgSync
    from repro_torch.data import DeviceFederatedData
    from repro_torch.models.gan_nets import Toy2DDiscriminator, Toy2DGenerator
    from repro_torch.optim import Adam, constant, equal_timescale
    from repro_torch.privacy import SecureAgg

    K, A, b = 4, 3, 8
    task = make_gan_task(Toy2DGenerator(theta0=0.5), Toy2DDiscriminator(psi0=0.5))

    def build(strategy=None):
        return FedGAN(task, FedGANConfig(agent_grid=(1, A), sync_interval=K,
                                         strategy=strategy),
                      opt_g=Adam(), opt_d=Adam(), scales=equal_timescale(constant(1e-3)))

    fed = build()
    state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    batches = {"x": torch.zeros((K, 1, A, b)), "z": torch.zeros((K, 1, A, b))}
    targets = [TracedFn("round.stream", fed.round, (state, batches),
                        donate_argnums=(0,), state_argnums=(0,))]
    fed_secure = build(FedAvgSync(secure_agg=SecureAgg(seed=0)))
    targets.append(TracedFn("round.secure", fed_secure.round, (state, batches),
                            donate_argnums=(0,), state_argnums=(0,)))
    agent_data = [{"x": torch.from_numpy(np.zeros((32,), np.float32))} for _ in range(A)]
    data = DeviceFederatedData.from_agent_data(
        agent_data, (1, A), b,
        sample_extra=lambda g, s: {"z": torch.rand(s, generator=g) * 2 - 1}, device="cpu")
    targets.append(TracedFn(
        "round.device", lambda st, gen: fed.round_from_data(st, data, gen),
        (state, torch.Generator().manual_seed(1)), donate_argnums=(0,), state_argnums=(0,)))
    return targets


def run_trace(root: str | None = None, targets=None) -> list:
    """Audit the default (or given) targets; suppressions applied."""
    root = root or repo_root_from_package()
    targets = default_targets() if targets is None else targets
    findings: list = []
    for t in targets:
        findings.extend(audit_traced(t, root))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return filter_suppressed(findings, root)

"""The port's entry points on the CPU: the round driver on device-resident
data, the training CLI, the refusals of what is not ported yet, the
weight converter, byte accounting against the JAX reference, and the
import isolation of the port."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_shared import BATCH, GRID, HW, _pair, one_torch_thread  # noqa: F401

from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import FedAvgSync
from repro_torch.data import DeviceFederatedData
from repro_torch.kernels.fedavg.kernel import fedavg_flat
from repro_torch.kernels.qsync.kernel import qsync_flat
from repro_torch.launch import train
from repro_torch.run import RoundDriver, profile
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_comm_bytes_per_round_match_jax():
    """The §3.2 accounting, uncompressed and int8-coded, bills what the
    reference bills for the same state."""
    for codec in (False, True):
        jfed, tfed, _ = _pair("adam", codec)
        jstate = jfed.init_state(jax.random.key(0))
        tstate = from_jax_params(jax.device_get(jstate), device="cpu")
        assert tfed.comm_bytes_per_round(tstate) == jfed.comm_bytes_per_round(jstate)


def test_driver_runs_device_data_and_keeps_agents_synced():
    """The round driver on the device-resident pipeline (here the CPU):
    minibatches come from each agent's own shard, metrics are fetched at
    the end, every agent holds the synced parameters after each round, and
    the CPU path launches no kernel."""
    g = torch.Generator().manual_seed(0)
    shards = [{"x": torch.full((n, HW, HW, 3), float(i)), "y": torch.full((n,), i)}
              for i, n in enumerate((7, 9, 11, 5, 8))]
    data = DeviceFederatedData.from_agent_data(
        shards, GRID, BATCH, device="cpu",
        sample_extra=lambda gen, s: {"z": torch.randn(s + (62,), generator=gen)})
    batch = data.sample_step(g)
    assert batch["x"].shape == GRID + (BATCH, HW, HW, 3)
    assert batch["z"].shape == GRID + (BATCH, 62)
    for a in range(5):   # agent a only ever sees its own shard
        assert (batch["y"][0, a] == a).all() and (batch["x"][0, a] == a).all()
    _, tfed, _ = _pair("adam", True)
    seen = []

    def check_synced(fed, state, r):
        for x in tree_leaves(state["params"]):
            assert torch.equal(x, x[:1, :1].expand_as(x))
        seen.append(r)
        return {"synced": 1.0}

    launches = (fedavg_flat.launches, qsync_flat.launches)
    result = RoundDriver(tfed, data, 2, log_every=0, eval_every=1,
                         eval_hooks=(check_synced,)).run(seed=3)
    assert seen == [0, 1] and [e["round"] for e in result.evals] == [0, 1]
    assert len(result.history) == 2
    assert all(np.isfinite(v) for m in result.history for v in m.values())
    assert set(result.timings) == {"total_s", "steps_per_s", "round_gap_s",
                                   "data_kind", "captured"}
    assert result.timings["data_kind"] == "device" and result.timings["captured"] is False
    # the intermediary's average of synced agents is what each agent holds
    for m, x in zip(tree_leaves(tfed.averaged_params(result.state)),
                    tree_leaves(result.state["params"])):
        torch.testing.assert_close(m, x[0, 0], rtol=1e-6, atol=1e-7)
    assert (fedavg_flat.launches, qsync_flat.launches) == launches


def test_unported_paths_refuse_instead_of_falling_back():
    """The virtual-client fleet, once refused, builds and runs on the CPU
    (``a_total=16``: 16 clients paged through the experiment's 5 slots);
    secure aggregation and DP-SGD validate as the reference's do (a secure
    sum refuses a codec wire, a DP config its bad clip)."""
    from repro_torch.privacy import DPSGD, SecureAgg
    _, tfed, _ = _pair("adam", True)
    spec, _ = train.experiment_spec("toy_2d", device="cpu", a_total=16, K=2, steps=6,
                                    samples_per_agent=32, batch_size=4, log_every=0)
    assert spec.virtual and spec.agent_grid == (1, 5) and len(spec.agent_data) == 16
    result = spec.run_result()
    assert result.timings["data_kind"] == "virtual" and len(result.history) == 3
    assert result.timings["a_total"] == 16 and result.timings["swapped_rows"] > 0
    assert all(np.isfinite(v) for m in result.history for v in m.values())
    with pytest.raises(ValueError, match="codec"):
        dataclasses.replace(tfed.cfg, strategy=FedAvgSync(secure_agg=SecureAgg(),
                                                          codec=tfed.cfg.strategy.codec)
                            ).validate()
    with pytest.raises(ValueError, match="clip"):
        dataclasses.replace(tfed.cfg, dp=DPSGD(clip=0.0)).validate()
    dataclasses.replace(tfed.cfg, strategy=FedAvgSync(secure_agg=SecureAgg()),
                        dp=DPSGD(noise_multiplier=1.0)).validate()


def test_train_cli_needs_a_gpu_unless_told_cpu():
    """The entry point runs on the card by default and refuses to fall
    back to the CPU; ``--device cpu`` runs there on purpose."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--experiment", "image_acgan", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.experiment_spec("image_acgan")
    result = train.main(["--experiment", "image_acgan", "--device", "cpu",
                         "--K", "1", "--steps", "1", "--batch-size", "2",
                         "--codec", "int8", "--log-every", "0"])
    assert result.timings["data_kind"] == "device"
    assert np.isfinite(result.history[0]["d_loss"])


@pytest.mark.parametrize("flags", [["--codec", "int4", "--topk", "0.25"],
                                   ["--strategy", "partial_sharing", "--codec", "int8"]],
                         ids=["topk_int4", "partial_sharing"])
def test_train_cli_runs_the_slice_two_syncs(flags):
    """The composed coded sync and generator-only sharing through the
    training CLI: on the card by default, refused without one, run on the
    CPU when asked."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--experiment", "image_acgan", "--steps", "1", *flags])
    result = train.main(["--experiment", "image_acgan", "--device", "cpu", "--K", "1",
                         "--steps", "1", "--batch-size", "2", "--log-every", "0", *flags])
    assert np.isfinite(result.history[0]["d_loss"])
    for x in tree_leaves(result.state["params"]["gen"]):
        assert torch.equal(x, x[:1, :1].expand_as(x))
    assert sorted(result.state["ef"]) == sorted(result.fed.cfg.strategy.subtrees)


_CLI_CPU = ["--experiment", "toy_2d", "--device", "cpu", "--K", "2", "--steps", "4",
            "--samples-per-agent", "64", "--log-every", "0"]


@pytest.mark.parametrize("flags,strategy", [
    (["--dp-noise", "0.5", "--eval-every", "1"], "fedgan"),
    (["--dp-clip", "0.3"], "fedgan"),
    (["--secure-agg", "--seed", "3"], "fedgan"),
    (["--robust", "trimmed_mean", "--trim", "1"], "trimmed_mean"),
    (["--robust", "median", "--codec", "int8"], "median")],
    ids=["dp_noise", "dp_clip", "secure_agg", "robust_trim", "robust_median_int8"])
def test_train_cli_privacy_flags_run_on_the_cpu(flags, strategy, capsys):
    """The privacy flags through the training CLI on the CPU: DP-SGD
    reports ``dp_epsilon`` in the timings line and every eval, the secure
    sum equals the plain run bit for bit, the robust reduces run their
    strategy; every agent holds the synced params."""
    result = train.main(_CLI_CPU + flags)
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    cfg = result.fed.cfg
    assert (cfg.strategy.name if cfg.strategy is not None else "fedgan") == strategy
    assert all(np.isfinite(v) for m in result.history for v in m.values())
    for x in tree_leaves(result.state["params"]):
        assert torch.equal(x, x[:1, :1].expand_as(x))
    if cfg.dp is not None:
        assert out[-1]["dp_epsilon"] == cfg.dp.epsilon(4)
        assert all("dp_epsilon" in e for e in result.evals)
        assert {"dp_grad_norm_d", "dp_grad_norm_g"} <= set(result.history[0])
    else:
        assert "dp_epsilon" not in out[-1]
    if "--secure-agg" in flags:
        assert cfg.strategy.secure_agg.seed == 3
        plain = train.main(_CLI_CPU + ["--seed", "3"])
        for a, b in zip(tree_leaves(result.state), tree_leaves(plain.state)):
            assert torch.equal(a, b)


def test_train_cli_privacy_refusals():
    """The reference's refusals, through ``main``."""
    for flags, match in ((["--secure-agg", "--codec", "int8"], "codec"),
                         (["--robust", "median", "--strategy", "fedgan"], "conflicts"),
                         (["--robust", "median", "--trim", "2"], "does not accept"),
                         (["--mode", "fedgan", "--secure-agg"], "requires --strategy"),
                         (["--robust", "trimmed_mean", "--trim", "3"], "2\\*trim"),
                         (["--dp-noise", "-1"], "noise_multiplier")):
        with pytest.raises(ValueError, match=match):
            train.main(_CLI_CPU + flags)


def test_privacy_sweep_cli_end_to_end(tmp_path, capsys):
    """``run.experiments``' CLI with the whole privacy axis on the CPU: one
    JSONL cell per axis, ``dp_epsilon`` on the dp cell's final row, the
    secure cell's state the plain cell's; a secure axis beside a codec is
    refused."""
    from repro_torch.run import experiments
    cells = experiments.main(["--experiment", "toy_2d", "--sweep", "K=2", "--steps", "4",
                              "--privacy", "none,dp,secure,trimmed_mean,median",
                              "--eval-n", "64", "--device", "cpu",
                              "--out-dir", str(tmp_path)])
    assert [c.privacy for c in cells] == ["none", "dp", "secure", "trimmed_mean", "median"]
    rows = [json.loads(line) for line in open(tmp_path / "sweep_toy_2d.jsonl")]
    finals = {r["privacy"]: r for r in rows if r.get("final")}
    assert finals["dp"]["dp_epsilon"] > 0 and "dp_epsilon" not in finals["none"]
    assert finals["secure"]["fd"] == finals["none"]["fd"]
    assert "fedgan+secure" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        experiments.main(["--privacy", "secure", "--codecs", "int8", "--device", "cpu"])


def test_profile_runs_rounds_and_reports_no_device_numbers_on_the_cpu():
    """The profiling entry point drives real rounds; on the CPU it states
    no device number."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.main(["--rounds", "1"])
    out = profile.profile_rounds(codec="int8", rounds=1, device="cpu", K=1,
                                 steps=1, batch_size=2)
    assert out["device"] == "cpu" and out["rounds"] == 1 and out["K"] == 1
    assert out["codec"] == "int8" and out["fused_sync"] is True
    out = profile.profile_rounds(codec="int4", topk=0.25, rounds=1, device="cpu",
                                 K=1, steps=1, batch_size=2)
    assert out["codec"] == "topk+int4" and out["fused_sync"] is False
    assert out["device_busy_share"] is None and out["device_ms_per_round"] is None
    assert out["sync_kernels"] is None
    assert out["top_kernels"] == [] and out["ms_per_round"] > 0


def test_from_jax_params_defaults_to_the_card():
    """The converter puts the reference's weights on the card unless told
    the CPU, and refuses to fall back to the CPU without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"w": np.zeros(3, np.float32)})
    assert from_jax_params({"w": np.zeros(3, np.float32)},
                           device="cpu")["w"].device.type == "cpu"


def test_convert_round_trips_the_reference_state():
    jfed, _, _ = _pair("adam", True)
    jstate = jax.device_get(jfed.init_state(jax.random.key(1)))
    back = to_jax_params(from_jax_params(jstate, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_port_imports_no_jax_and_nothing_of_repro():
    """Importing every module of the port pulls in neither JAX nor the
    reference package.  Run in a fresh interpreter: this process has both
    loaded already."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 25
    assert {"repro_torch.evals.fd", "repro_torch.evals.modes", "repro_torch.evals.kmeans",
            "repro_torch.run.evals", "repro_torch.run.experiments",
            "repro_torch.quickstart"} <= loaded


def test_run_experiment_hierarchical_end_to_end():
    """The twin of the reference's test: a hierarchical toy_2d run through
    ``run_experiment`` trains, and returns the legacy (fed, state,
    history) triple."""
    from repro_torch.core import Hierarchical
    fed, state, hist = train.run_experiment("toy_2d", K=2, steps=4, seed=0,
                                            strategy=Hierarchical(intra_interval=1),
                                            device="cpu")
    assert len(hist) == 2
    assert fed.cfg.resolve_strategy().name == "hierarchical"
    assert all(np.isfinite(v) for m in hist for v in m.values())


def test_run_experiment_with_overrides_and_evals():
    """The twin of the reference's test: overrides and evals reach the
    spec; the history is ``experiment_spec(...).run()``'s, and
    ``train_fedgan`` over the same spec's pieces gives it too."""
    kw = dict(K=2, steps=8, seed=0, batch_size=8, agents=2, log_every=0, eval_every=2,
              data_mode="device", device="cpu")
    fed, state, hist = train.run_experiment("toy_2d", **kw)
    assert fed.cfg.agent_grid == (1, 2)
    assert len(hist) == 4
    spec, _ = train.experiment_spec("toy_2d", **kw)
    assert spec.run()[2] == hist
    _, _, again = train.train_fedgan(
        spec.task, agent_data=spec.agent_data, agent_grid=spec.agent_grid, K=spec.K,
        steps=spec.steps, batch_size=spec.batch_size, scales=spec.scales, opt_d=spec.opt_d,
        opt_g=spec.opt_g, sample_extra=spec.sample_extra, seed=spec.seed, log_every=0,
        device="cpu")
    assert again == hist

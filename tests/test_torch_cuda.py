"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (the kernels are built from
``src/repro_torch/csrc`` at first use) and skips elsewhere.  The file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, with their reasons: fedavg float32 within 1e-6 of
sum_b |w_b x_bn| (another summation order of B products), bfloat16 one
bfloat16 ulp more (the f32 sum may round to the neighbouring bfloat16);
qsync bit-identical in every output (kernel and plain version both sum
the rounded products in agent order and round every step alike).
"""
import pytest
import torch

from repro_torch.comm import IntQuant
from repro_torch.core import FedAvgSync
from repro_torch.kernels.fedavg.kernel import fedavg_flat
from repro_torch.kernels.fedavg.ref import fedavg_flat_ref
from repro_torch.kernels.qsync import kernel as qkernel
from repro_torch.kernels.qsync.ref import qsync_flat_ref
from repro_torch.launch.train import experiment_spec
from repro_torch.tree import tree_leaves


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU form")
    return torch.device("cuda")


def _weights(gen, dev):
    w = torch.rand((1, 5), generator=gen, device=dev) + 0.1
    return w / w.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = _weights(g, cuda)
    x = torch.randn((5, 100_003), generator=g, device=cuda).to(dtype)
    before = fedavg_flat.launches
    got = fedavg_flat(w, x).float()
    torch.cuda.synchronize()
    assert fedavg_flat.launches == before + 1
    want = fedavg_flat_ref(w, x).float()
    bound = 1e-6 * (w.reshape(-1, 1) * x.float()).abs().sum(0)
    if dtype == torch.bfloat16:
        bound = bound + torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
    assert bool(((got - want).abs() <= bound).all())
    with pytest.raises(ValueError, match="contiguous"):
        fedavg_flat(w, x.t().contiguous().t())
    with pytest.raises(ValueError, match="CUDA device"):
        fedavg_flat(w.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ef", [False, True])
def test_qsync_kernel_matches_plain(cuda, bits, ef):
    g = torch.Generator(device=cuda).manual_seed(bits)
    n = 128 * 997
    w = _weights(g, cuda)
    scale = torch.tensor([1e-3, 1.0, 30.0], device=cuda)[
        torch.randint(0, 3, (5, n), generator=g, device=cuda)]
    x = torch.randn((5, n), generator=g, device=cuda) * scale
    x[:, :128] = 0.0   # an all-zero block: scale 0, divisor 1
    e = 0.01 * torch.randn((5, n), generator=g, device=cuda) if ef else None
    ed = 0.01 * torch.randn(n, generator=g, device=cuda) if ef else None
    qmax = 2 ** (bits - 1) - 1
    before = qkernel.qsync_flat.launches
    got = qkernel.qsync_flat(w, x, e, ed, qmax=qmax)
    want = qsync_flat_ref(w, x, e, ed, qmax=qmax, block=128)
    torch.cuda.synchronize()
    assert qkernel.qsync_flat.launches == before + 1
    assert (got[1] is None) == (not ef) and (got[2] is None) == (not ef)
    for g, wnt in zip(got, want):
        assert (g is None) or torch.equal(g, wnt)
    with pytest.raises(ValueError, match="contiguous"):
        qkernel.qsync_flat(w, x.t().contiguous().t(), qmax=qmax)
    with pytest.raises(ValueError, match="multiple of 32"):
        qkernel.qsync_flat(w, x[:, :100 * 10].contiguous(), qmax=qmax, block=100)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [False, True], ids=["plain", "int8"])
def test_round_on_card_runs_through_the_kernels(cuda, codec):
    """One ACGAN round at full width on the card: every sync of a subtree
    is one kernel launch, and every agent holds the synced values."""
    strategy = FedAvgSync(codec=IntQuant(8)) if codec else None
    spec = experiment_spec("image_acgan", K=2, steps=2, strategy=strategy,
                           log_every=0, device=cuda)
    counter = qkernel.qsync_flat if codec else fedavg_flat
    before = counter.launches
    result = spec.run_result()
    torch.cuda.synchronize()
    assert counter.launches - before == 2   # one per subtree (gen, disc)
    for x in tree_leaves(result.state["params"]):
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, x[:1, :1].expand_as(x))

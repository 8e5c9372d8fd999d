"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: they skip without a CUDA device. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from bigkrls_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (M, N, P, symmetric): the fit's shapes, ragged edges, a wide P and a
# predict-shaped cross kernel
SHAPES = [(3106, 3106, 67, True), (1000, 1000, 5, True), (4097, 4097, 3, True),
          (130, 130, 200, True), (517, 3106, 67, False), (1, 70, 2, False)]


@pytest.mark.parametrize("m,n,p,sym", SHAPES)
def test_gauss_tile_matches_plain(cuda, m, n, p, sym):
    """f32 kernel vs the plain rank-P version on the same card within
    1e-5: both carry the rank-P cancellation at r ≈ P in f32, which the
    exp() damps to well under that."""
    rng = np.random.default_rng(m + n + p)
    A = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32,
                        device=cuda)
    B = A if sym else torch.as_tensor(rng.normal(size=(n, p)),
                                      dtype=torch.float32, device=cuda)
    sigma = float(p)
    before = kernels.gauss_tile_launches
    K = kernels.gauss_tile(A, B, sigma, sym)
    torch.cuda.synchronize()
    assert kernels.gauss_tile_launches == before + 1
    ref = kernels.gauss_tile_plain(A, B, sigma, sym)
    assert K.shape == (m, n) and K.dtype == torch.float32
    assert torch.max(torch.abs(K - ref)).item() <= 1e-5
    if sym:
        assert torch.equal(K, K.T)                       # bit-symmetric
        assert torch.all(torch.diagonal(K) == 1.0)


def test_gauss_tile_64bit_offsets(cuda):
    """N = 46400: N² > 2³¹, so the last rows' outputs sit past any 32-bit
    offset; they must match the plain version computed for those rows."""
    n, p = 46400, 3
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    X = torch.randn((n, p), generator=gen, device=cuda)
    K = kernels.gauss_tile(X, X, float(p), True)
    tail = kernels.gauss_tile_plain(X[-64:], X, float(p), False)
    torch.cuda.synchronize()
    assert torch.max(torch.abs(K[-64:] - tail)).item() <= 1e-5
    assert torch.all(torch.diagonal(K[-64:, -64:]) == 1.0)
    del K


def test_gauss_tile_rejects_bad_input(cuda):
    X = torch.zeros((8, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        kernels.gauss_tile(X, X, 3.0, True)
    Xt = torch.zeros((3, 8), dtype=torch.float32, device=cuda).T
    with pytest.raises(ValueError):
        kernels.gauss_tile(Xt, Xt, 3.0, True)


def test_fit_on_card_matches_cpu(cuda):
    """The default fit on the card (f32, K1 for the kernel and predict's
    cross kernel) vs the port's float64 fit on the CPU, at the adaptive
    route's smallest default size, with chip_smoke.py's tolerances."""
    import bigkrls_tpu_torch as bt
    rng = np.random.default_rng(2018)
    n, p = 2048, 4
    X = rng.normal(size=(n, p))
    X[:, p - 1] = (X[:, p - 1] > 0.12345).astype(float)
    y = X @ rng.uniform(size=p) + rng.normal(size=n)
    before = kernels.gauss_tile_launches
    m = bt.fit(y, X, eigtrunc=0.01, noisy=False, device="cuda")
    pred = bt.predict(m, X[:10], se_pred=True)
    assert kernels.gauss_tile_launches == before + 2
    m64 = bt.fit(y, X, eigtrunc=0.01, noisy=False, device="cpu",
                 dtype=torch.float64)
    pred64 = bt.predict(m64, X[:10], se_pred=True)
    assert m.eig_path == m64.eig_path and m.lastkeeper == m64.lastkeeper
    assert m.lambda_ == pytest.approx(m64.lambda_, rel=2e-2)
    assert m.looe == pytest.approx(m64.looe, rel=1e-3)
    assert m.neffective == pytest.approx(m64.neffective, rel=1e-3)
    amax = np.max(np.abs(m64.avgderivatives))
    assert np.max(np.abs(m.avgderivatives - m64.avgderivatives)) <= 1e-2 * amax
    assert (np.max(np.abs(pred.predicted - pred64.predicted))
            <= 1e-3 * np.std(y, ddof=1))
    assert np.all(np.isfinite(pred.se_pred)) and np.all(pred.se_pred > 0)

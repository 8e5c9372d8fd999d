"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: they skip without a CUDA device. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from bigkrls_tpu_torch.ops import kernels, matvec
from _port_threads import one_blas_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (M, N, P, symmetric): the fit's shapes, ragged edges, a wide P and a
# predict-shaped cross kernel; then N one below, at and one above an edge
# of each tile (64, 128), P on both sides of the 16-byte pitch (1, 3, 4, 5,
# 67, 68) and of the whole-P staging (72, 73, 200, 513: slices of 32), and
# one-row and one-column cross calls
SHAPES = [(3106, 3106, 67, True), (1000, 1000, 5, True), (4097, 4097, 3, True),
          (130, 130, 200, True), (517, 3106, 67, False), (1, 70, 2, False),
          (63, 63, 1, True), (64, 64, 3, True), (65, 65, 4, True),
          (127, 127, 5, True), (128, 128, 67, True), (129, 129, 68, True),
          (257, 257, 513, True), (300, 300, 72, True), (300, 300, 73, True),
          (70, 1, 2, False), (1, 1, 1, True), (129, 65, 200, False)]


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


@pytest.mark.parametrize("m,n,p,sym", SHAPES)
def test_gauss_tile_result_does_not_depend_on_the_tile(cuda, m, n, p, sym):
    """The host picks the tile (64 or 128) and, for the same rows, mirrors
    the tiles above the diagonal; every entry sees the same operations in
    the same order either way, so forcing each tile, and computing every
    tile of a symmetric call, gives the same bits."""
    rng = np.random.default_rng(m + 3 * n + p)
    A = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32,
                        device=cuda)
    B = A if sym else torch.as_tensor(rng.normal(size=(n, p)),
                                      dtype=torch.float32, device=cuda)
    K = kernels.gauss_tile(A, B, float(p), sym)
    for tile in kernels._TILES:
        for mirror in ((None, False) if sym else (None,)):
            Kt = kernels._gauss_tile_cuda(A, B, float(p), sym, tile=tile,
                                          mirror=mirror)
            assert torch.equal(Kt, K), (tile, mirror)


def test_gauss_tile_same_rows_without_the_exact_diagonal(cuda):
    """A and B the same rows with ``symmetric_diag=False`` (the product
    kernel's tile identity is checked against this call): the tiles are
    mirrored all the same, K is bit-symmetric, and the diagonal holds the
    computed value (the run that computes every tile gives the same bits;
    within rounding of 1), where ``symmetric_diag=True`` writes exactly 1;
    off the diagonal the two calls agree bit for bit."""
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(700, 20)), dtype=torch.float32,
                        device=cuda)
    K = kernels.gauss_tile(X, X, 20.0, False)
    K1 = kernels.gauss_tile(X, X, 20.0, True)
    whole = kernels._gauss_tile_cuda(X, X, 20.0, False, mirror=False)
    assert torch.equal(K, K.T) and torch.equal(K, whole)
    d = torch.diagonal(K)
    assert torch.all((d - 1.0).abs() <= 1e-5)
    assert torch.all(torch.diagonal(K1) == 1.0)
    off = ~torch.eye(700, dtype=torch.bool, device=cuda)
    assert torch.equal(K[off], K1[off])


def test_gauss_tile_padded_copy_does_not_read_stale_memory(cuda):
    """P = 67 is staged through a copy with a pitch of 68. Its pad column
    must be written as zeros: with the allocator's free blocks full of
    NaN, a pad left as it was found would put NaN into every chain."""
    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.normal(size=(900, 67)), dtype=torch.float32,
                        device=cuda)
    Y = torch.as_tensor(rng.normal(size=(300, 67)), dtype=torch.float32,
                        device=cuda)
    want = kernels.gauss_tile(X, X, 67.0, True)
    want_c = kernels.gauss_tile(Y, X, 67.0, False)
    for rows in (900, 1200):
        junk = torch.full((rows, 68), float("nan"), device=cuda)
        del junk                      # back to the allocator, NaN inside
        assert torch.equal(kernels.gauss_tile(X, X, 67.0, True), want)
        junk = torch.full((rows, 68), float("nan"), device=cuda)
        del junk
        assert torch.equal(kernels.gauss_tile(Y, X, 67.0, False), want_c)
    assert bool(torch.isfinite(want).all() and torch.isfinite(want_c).all())
    # a misaligned view (P a multiple of 4, pointer 4 bytes off) is copied too
    flat = torch.as_tensor(rng.normal(size=(1 + 200 * 68,)),
                           dtype=torch.float32, device=cuda)
    V = flat[1:].view(200, 68)
    assert V.data_ptr() % 16 != 0 and V.is_contiguous()
    assert torch.equal(kernels.gauss_tile(V, V, 68.0, True),
                       kernels.gauss_tile(V.clone(), V.clone(), 68.0,
                                          False).fill_diagonal_(1.0))


@pytest.mark.parametrize("p", [5, 8])
def test_gauss_tile_operands_that_share_a_pointer(cuda, p):
    """A leading block of X against X itself, both ways: one pointer, two
    row counts. No mirror (M != N), and the padded copy (P = 5) must hold
    the longer operand's rows."""
    rng = np.random.default_rng(p)
    X = torch.as_tensor(rng.normal(size=(300, p)), dtype=torch.float32,
                        device=cuda)
    head = X[:10]
    assert head.data_ptr() == X.data_ptr()
    for A, B in ((head, X), (X, head)):
        K = kernels.gauss_tile(A, B, float(p), False)
        ref = kernels.gauss_tile_plain(A, B, float(p), False)
        assert K.shape == ref.shape
        assert torch.max(torch.abs(K - ref)).item() <= 1e-5
    assert torch.equal(kernels.gauss_tile(head, X, float(p), False),
                       kernels.gauss_tile(X, X, float(p), False)[:10])


def test_gauss_tile_64bit_offsets(cuda):
    """N = 46400: N² > 2³¹, so the last rows' outputs sit past any 32-bit
    offset; they must match the plain version computed for those rows.
    The last 64 columns are written by the mirrored store (the tiles below
    the diagonal are not computed): they must hold the same rows
    transposed."""
    n, p = 46400, 3
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    X = torch.randn((n, p), generator=gen, device=cuda)
    K = kernels.gauss_tile(X, X, float(p), True)
    tail = kernels.gauss_tile_plain(X[-64:], X, float(p), False)
    torch.cuda.synchronize()
    assert torch.max(torch.abs(K[-64:] - tail)).item() <= 1e-5
    assert torch.all(torch.diagonal(K[-64:, -64:]) == 1.0)
    assert torch.max(torch.abs(K[:-64, -64:] - tail[:, :-64].T)).item() <= 1e-5
    assert torch.equal(K[:, -64:], K[-64:].T)
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


# ---- K2, the kernel-free product ------------------------------------------

def _k2_tol(n):
    """Of max|Y|: f32 rounding of the tile (about 1e-6) plus a length-N f32
    sum taken in another order, which grows like sqrt(N)·2⁻²⁴."""
    return 1e-5 * max(1.0, (n / 8192) ** 0.5)


# (N, P, m): ragged N, P and m, a single column, the fit's width in a pair
# of 320-wide blocks and in narrower ones, P past one 32-wide chunk at that
# width, an m that is no multiple of 4 (the wrapper pads V's pitch) and the
# derivatives stack's width
K2_SHAPES = [(1000, 67, 130), (4097, 3, 5), (517, 20, 1), (2048, 20, 540),
             (63, 2, 64), (65, 17, 65), (4096, 67, 540), (4096, 20, 541),
             (4096, 20, 22)]


@pytest.mark.parametrize("n,p,m", K2_SHAPES)
def test_kernel_matmul_matches_plain(cuda, n, p, m):
    """Precise mode (the split-TF32 product) vs the plain version, bare and
    with the epilogue; out aliasing init gives the unaliased run's bits
    (sums are in a fixed order, so runs repeat bit for bit). Against the
    plain version in float64 the split is no further off than twice the
    kernel's own IEEE fp32 FMA pass."""
    rng = np.random.default_rng(n + p + m)
    X, V, init = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                  device=cuda)
                  for s in ((n, p), (n, m), (n, m)))
    sigma = float(p)
    before = (matvec.kernel_matmul_launches,
              matvec.kernel_matmul_fast_launches)
    Y = matvec.kernel_matmul(X, V, sigma)
    torch.cuda.synchronize()
    assert (matvec.kernel_matmul_launches,
            matvec.kernel_matmul_fast_launches) == (before[0] + 1, before[1])
    ref = matvec.kernel_matmul_plain(X, V, sigma)
    assert Y.shape == (n, m) and Y.dtype == torch.float32
    assert (Y - ref).abs().max().item() <= _k2_tol(n) * ref.abs().max().item()
    assert torch.equal(Y, matvec.kernel_matmul(X, V, sigma))
    ref64 = matvec.kernel_matmul_plain(X.double(), V.double(), sigma)
    Yfma = matvec._kernel_matmul_cuda(X, V, sigma, None, None, False, None,
                                      mode="fma")
    assert ((Y - ref64).abs().max().item()
            <= 2 * (Yfma - ref64).abs().max().item())
    assert ((Yfma - ref).abs().max().item()
            <= _k2_tol(n) * ref.abs().max().item())
    Ye = matvec.kernel_matmul(X, V, sigma, init=init, out_scale=-2.5)
    ref_e = matvec.kernel_matmul_plain(X, V, sigma, init=init, out_scale=-2.5)
    assert ((Ye - ref_e).abs().max().item()
            <= _k2_tol(n) * ref_e.abs().max().item())
    buf = init.clone()
    Ya = matvec.kernel_matmul(X, V, sigma, init=buf, out_scale=-2.5, out=buf)
    assert Ya.data_ptr() == buf.data_ptr() and torch.equal(Ya, Ye)


@pytest.mark.parametrize("n,p,m", [(2048, 20, 540), (1000, 67, 130),
                                   (517, 20, 1)])
def test_kernel_matmul_fast_mode(cuda, n, p, m):
    """Fast mode (TF32 on tile·V only) vs the plain version under TF32:
    5e-3 of max|Y| (TF32 keeps 10 mantissa bits of the tile and of V, and
    the kernel and cuBLAS round to it differently)."""
    rng = np.random.default_rng(n + m)
    X, V = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=cuda) for s in ((n, p), (n, m)))
    before = matvec.kernel_matmul_fast_launches
    Y = matvec.kernel_matmul(X, V, float(p), fast_accum=True)
    torch.cuda.synchronize()
    assert matvec.kernel_matmul_fast_launches == before + 1
    ref = matvec.kernel_matmul_plain(X, V, float(p), fast_accum=True)
    assert torch.backends.cuda.matmul.allow_tf32 is False    # restored
    assert (Y - ref).abs().max().item() <= 5e-3 * ref.abs().max().item()


def test_kernel_matmul_fast_mode_sums_like_ieee(cuda):
    """Fast mode over a sum of 1,000,000 products (the cross entry, 256
    rows) is no further from float64 than twice the same TF32 rounding
    with IEEE sums (``kernel_matmul_split_plain(fast=True)``): the tensor
    cores add into their accumulator by truncation, so the kernel takes
    their 8-deep partial sums only (added directly, the error was 7× the
    IEEE sums' at this length)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    Xa = torch.randn((256, 20), generator=gen, device=cuda)
    Xb = torch.randn((1_000_000, 20), generator=gen, device=cuda)
    V = torch.randn((1_000_000, 64), generator=gen, device=cuda)
    Y = matvec.kernel_matmul_cross(Xa, Xb, V, 20.0, fast_accum=True)
    ref = matvec.kernel_matmul_plain(Xa.double(), V.double(), 20.0,
                                     Xb=Xb.double())
    emu = matvec.kernel_matmul_split_plain(Xa, V, 20.0, Xb=Xb, fast=True)
    top = ref.abs().max().item()
    err = (Y.double() - ref).abs().max().item() / top
    err_emu = (emu.double() - ref).abs().max().item() / top
    assert err <= 2 * err_emu


# (Na, Nb, P, m): a ring step of the N=50,000 fit on 4 shards (scaled
# down), ragged row counts on both sides, fewer rows than one tile, P past
# one chunk, and the derivatives stack's width
K2_CROSS_SHAPES = [(3125, 3125, 20, 540), (3106, 1553, 67, 22),
                   (1553, 3106, 67, 22), (63, 130, 5, 64), (700, 65, 40, 1),
                   (1000, 1000, 20, 541)]


@pytest.mark.parametrize("na,nb,p,m", K2_CROSS_SHAPES)
def test_kernel_matmul_cross_matches_plain(cuda, na, nb, p, m):
    """The cross entry K(Xa, Xb)·V against the plain version with Xb, in
    precise and fast mode and with the epilogue (out aliasing init); its
    launches count in the cross count and the K2 count; and the square
    entry is the cross entry with Xa = Xb, bit for bit."""
    rng = np.random.default_rng(na + nb + p + m)
    Xa, Xb, V, init = (torch.as_tensor(rng.normal(size=s),
                                       dtype=torch.float32, device=cuda)
                       for s in ((na, p), (nb, p), (nb, m), (na, m)))
    sigma = float(p)
    before = (matvec.kernel_matmul_launches,
              matvec.kernel_matmul_cross_launches)
    Y = matvec.kernel_matmul_cross(Xa, Xb, V, sigma)
    torch.cuda.synchronize()
    assert (matvec.kernel_matmul_launches,
            matvec.kernel_matmul_cross_launches) == (before[0] + 1,
                                                     before[1] + 1)
    ref = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb)
    scale = ref.abs().max().item()
    assert Y.shape == (na, m)
    assert (Y - ref).abs().max().item() <= _k2_tol(nb) * scale
    Yf = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, fast_accum=True)
    ref_f = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb, fast_accum=True)
    assert (Yf - ref_f).abs().max().item() <= 5e-3 * scale
    Ye = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, init=init,
                                    out_scale=-2.5)
    ref_e = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb, init=init,
                                       out_scale=-2.5)
    assert ((Ye - ref_e).abs().max().item()
            <= _k2_tol(nb) * ref_e.abs().max().item())
    buf = init.clone()
    Ya = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, init=buf,
                                    out_scale=-2.5, out=buf)
    assert Ya.data_ptr() == buf.data_ptr() and torch.equal(Ya, Ye)
    Vs = torch.as_tensor(rng.normal(size=(na, m)), dtype=torch.float32,
                         device=cuda)
    for fast in (False, True):
        assert torch.equal(matvec.kernel_matmul(Xa, Vs, sigma,
                                                fast_accum=fast),
                           matvec.kernel_matmul_cross(Xa, Xa, Vs, sigma,
                                                      fast_accum=fast))


@pytest.mark.parametrize("n", [4096, 4093])
def test_ring_matmul_on_card(cuda, n):
    """The ring product over 4 shards of the card: D² = 16 cross launches
    a product, within the K2 tolerance of the one-device product, the
    epilogue folded in; fast_accum reaches every step (16 fast launches)
    and agrees with the plain version under TF32."""
    from bigkrls_tpu_torch.parallel.ring_kernel import (make_ring_matmul,
                                                        make_ring_mesh)
    rng = np.random.default_rng(n)
    X, V, init = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                  device=cuda)
                  for s in ((n, 20), (n, 96), (n, 96)))
    mm = make_ring_matmul(make_ring_mesh([cuda] * 4))
    before = (matvec.kernel_matmul_cross_launches,
              matvec.kernel_matmul_fast_launches)
    Y = mm(X, V, 20.0, init=init, out_scale=0.5)
    Yf = mm(X, V, 20.0, fast_accum=True)
    torch.cuda.synchronize()
    assert (matvec.kernel_matmul_cross_launches,
            matvec.kernel_matmul_fast_launches) == (before[0] + 32,
                                                    before[1] + 16)
    ref = matvec.kernel_matmul(X, V, 20.0, init=init, out_scale=0.5)
    assert (Y - ref).abs().max().item() <= _k2_tol(n) * ref.abs().max().item()
    ref_f = matvec.kernel_matmul_plain(X, V, 20.0, fast_accum=True)
    assert (Yf - ref_f).abs().max().item() <= 5e-3 * ref_f.abs().max().item()


@pytest.mark.parametrize("mode", ["split", "fast", "fma"])
def test_kernel_matmul_result_does_not_depend_on_tile_width(cuda, mode):
    """The host picks the width of a block's output tile (64 or 256
    columns, or a pair of blocks with 320 each) from the shape and the SM
    count; every output element sees
    the same operations in the same order whatever the width, so forcing
    each width gives the same bits, and so does running twice."""
    rng = np.random.default_rng(11)
    n, p, m = 1500, 40, 300         # P > 32: two chunks of the rank-P chain
    X, V = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=cuda) for s in ((n, p), (n, m)))
    outs = [matvec._kernel_matmul_cuda(X, V, float(p), None, None, False,
                                       None, n_tiles=nt, mode=mode)
            for nt in (0, 1, 4, 5, 0)]
    for Y in outs[1:]:
        assert torch.equal(Y, outs[0])


def test_kernel_matmul_split_matches_its_plain_emulation(cuda):
    """The kernel's precise mode vs ``kernel_matmul_split_plain`` (the same
    hi/lo split by integer masking, three f32 ``addmm``s): both round each
    product alike and differ only in the order of their f32 sums."""
    rng = np.random.default_rng(5)
    n, p, m = 3000, 20, 100
    X, V = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=cuda) for s in ((n, p), (n, m)))
    Y = matvec.kernel_matmul(X, V, float(p))
    emu = matvec.kernel_matmul_split_plain(X, V, float(p))
    assert (Y - emu).abs().max().item() <= _k2_tol(n) * emu.abs().max().item()


def test_kernel_matmul_tile_is_the_dense_kernels(cuda):
    """Unit columns of V pick entries of K out unchanged. On the IEEE fp32
    FMA pass K2's on-chip tile equals ``gauss_tile(X, X)`` bit for bit, its
    inexact diagonal included (K2, like the JAX product, writes no exact-1
    diagonal). In precise mode the tile passes through hi + lo, two TF32
    values, which keep 21 of its 24 mantissa bits: 2^-21 relative per
    entry."""
    n = 700
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 20)),
                        dtype=torch.float32, device=cuda)
    K = kernels.gauss_tile(X, X, 20.0, False)
    E = torch.eye(n, device=cuda)[:, :130].contiguous()
    assert torch.equal(matvec._kernel_matmul_cuda(X, E, 20.0, None, None,
                                                  False, None, mode="fma"),
                       K[:, :130])
    split = matvec.kernel_matmul(X, E, 20.0)
    assert ((split - K[:, :130]).abs() / K[:, :130]).max().item() <= 2.0 ** -21


def test_kernel_matmul_64bit_offsets(cuda):
    """N·m = 33000·66000 > 2³¹ on a narrow P: the last rows of V, init and
    out sit past any 32-bit offset. Fast mode (the offsets are shared by
    both modes); the last 64 rows against the dense cross kernel."""
    n, p, m = 33000, 2, 66000
    assert n * m > 2 ** 31
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    X = torch.randn((n, p), generator=gen, device=cuda)
    V = torch.randn((n, m), generator=gen, device=cuda)
    Y = matvec.kernel_matmul(X, V, float(p), fast_accum=True)
    torch.cuda.synchronize()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tail = kernels.gauss_tile_plain(X[-64:], X, float(p), False) @ V
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert ((Y[-64:] - tail).abs().max().item()
            <= 5e-3 * tail.abs().max().item())
    del Y, V


def test_kernel_matmul_rejects_bad_input(cuda):
    X = torch.zeros((8, 3), dtype=torch.float32, device=cuda)
    V = torch.zeros((8, 4), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):                     # f64 asked of the kernel
        matvec.kernel_matmul(X.double(), V.double(), 3.0, impl="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        matvec.kernel_matmul(X, torch.zeros((4, 8), device=cuda).T, 3.0)
    with pytest.raises(ValueError, match="alias"):
        matvec.kernel_matmul(X, V, 3.0, out=V)
    with pytest.raises(TypeError):                     # V on another device
        matvec.kernel_matmul(X, V.cpu(), 3.0)
    # a float64 CUDA tensor under "auto" is the caller asking for f64: plain
    before = matvec.kernel_matmul_launches
    Y = matvec.kernel_matmul(X.double(), V.double(), 3.0)
    assert Y.dtype == torch.float64
    assert matvec.kernel_matmul_launches == before


def test_streaming_fit_on_card_matches_cpu(cuda):
    """A small streaming fit on the card (f32, every product through K2)
    vs the port's float64 streaming fit on the CPU, chip_smoke.py's
    tolerances. At N=600 with neig=60 the Krylov basis spans 7·100 > N
    columns (stacked flow), so both sides are converged."""
    import bigkrls_tpu_torch as bt
    rng = np.random.default_rng(2016)
    n, p = 600, 5
    X = rng.normal(size=(n, p))
    X[:, 4] = (X[:, 4] > 0).astype(float)
    y = np.sin(X[:, 0]) + X @ (0.2 * np.ones(p)) + 0.5 * rng.normal(size=n)
    kw = dict(neig=60, streaming=True, noisy=False)
    before = matvec.kernel_matmul_launches
    m = bt.fit(y, X, device="cuda", **kw)
    assert m.K is None and m.eig_path == "streaming-krylov"
    assert matvec.kernel_matmul_launches == before + 6 + 1 + 1
    d = m.vcov_fitted_diag()
    assert matvec.kernel_matmul_launches == before + 9
    m64 = bt.fit(y, X, device="cpu", dtype=torch.float64, **kw)
    assert m.lastkeeper == m64.lastkeeper
    assert m.lambda_ == pytest.approx(m64.lambda_, rel=2e-2)
    assert m.looe == pytest.approx(m64.looe, rel=1e-3)
    assert m.neffective == pytest.approx(m64.neffective, rel=1e-3)
    assert abs(m.R2 - m64.R2) <= 1e-4
    amax = np.max(np.abs(m64.avgderivatives))
    assert np.max(np.abs(m.avgderivatives - m64.avgderivatives)) <= 1e-2 * amax
    assert np.allclose(d.cpu().numpy(), m64.vcov_fitted_diag().numpy(),
                       rtol=5e-2)
    pred = bt.predict(m, X[:10], se_pred=True)
    pred64 = bt.predict(m64, X[:10], se_pred=True)
    assert (np.max(np.abs(pred.predicted - pred64.predicted))
            <= 1e-3 * np.std(y, ddof=1))


# ---- the workflows on the card ---------------------------------------------

def _lowrank(n, p=5, seed=2016):
    """A low-rank design (decaying kernel spectrum) with one binary column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2)) @ rng.normal(size=(2, p)) \
        + 0.3 * rng.normal(size=(n, p))
    X[:, p - 1] = (X[:, 0] > 0).astype(float)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.5 * rng.normal(size=n)
    return y, X


def test_crossvalidate_on_card_matches_cpu(cuda):
    """ptesting and K-fold CV on the card: the CPU run's partitions, and
    metrics within the limits chip_smoke.py derives from its end-to-end
    ones (MSE 1e-2 rel, pseudo-R² 5e-3 abs, AME-only 2e-2 rel). At this
    size the f32 folds keep every eigenpair (eigtrunc 0), and the f32
    error of the smallest moves the metrics by up to 2e-3 (CPU f32 vs f64),
    so the tighter limits chip_smoke.py holds at N=3106 do not apply."""
    import bigkrls_tpu_torch as bt
    y, X = _lowrank(600)
    for kw in (dict(ptesting=20, neig=50), dict(kfolds=3)):
        before = kernels.gauss_tile_launches
        cv = bt.crossvalidate(y, X, seed=1, noisy=False, device="cuda", **kw)
        folds = kw.get("kfolds", 1)
        assert kernels.gauss_tile_launches == before + 2 * folds
        cpu = bt.crossvalidate(y, X, seed=1, noisy=False, device="cpu",
                               dtype=torch.float64, **kw)
        if folds == 1:
            assert np.array_equal(cv.indices["test_set"],
                                  cpu.indices["test_set"])
        else:
            assert np.array_equal(cv.folds, cpu.folds)
        for key, val in cv.metrics.items():
            got, want = np.asarray(val), np.asarray(cpu.metrics[key])
            if "AME" in key:
                ok = np.abs(got - want) <= 2e-2 * np.abs(want)
            elif key.startswith("MSE"):
                ok = np.abs(got - want) <= 1e-2 * np.abs(want)
            else:
                ok = np.abs(got - want) <= 5e-3
            assert np.all(ok), key


def test_save_load_predict_bit_equal_on_card(cuda, tmp_path):
    import bigkrls_tpu_torch as bt
    y, X = _lowrank(800)
    m = bt.fit(y, X, noisy=False, device="cuda")
    back = bt.load_model(bt.save_model(m, str(tmp_path / "m")),
                         device="cuda")
    assert back.K.is_cuda and back.K.dtype == torch.float32
    a = bt.predict(m, X[:77], se_pred=True)
    b = bt.predict(back, X[:77], se_pred=True)
    assert np.array_equal(a.predicted, b.predicted)
    assert np.array_equal(a.se_pred, b.se_pred)


# ---- predict's results to the host ----------------------------------------

@pytest.fixture(scope="module")
def card_model():
    """The dense benchmark cells' model: N=3106, P=67, float32 on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch import bench
    y, X = bench.smoke_data()
    return bt.fit(y, X, noisy=False, device="cuda"), X


def _predict_spans():
    from bigkrls_tpu_torch.utils import progress
    log = progress.spans()
    root = [s for s in log if s.parent is None and s.name == "predict"][-1]
    return [s for s in log if s.call == root.call]


@pytest.mark.parametrize("u,block_size,vcov", [
    (1, None, False), (517, None, False), (3106, None, False),
    (517, 200, False), (300, None, True)])
def test_predict_lands_in_pinned_memory_bit_equal(cuda, card_model,
                                                  monkeypatch, u, block_size,
                                                  vcov):
    """On one card every result is widened to float64 on the card and
    copied into pinned memory with one wait a ``to_host`` span: bit-equal
    to the float32 results read to pageable memory and widened on the
    host (the CPU's path, forced here), every byte counted as pinned."""
    import importlib

    import bigkrls_tpu_torch as bt
    tpredict = importlib.import_module("bigkrls_tpu_torch.predict")
    m, X = card_model
    rng = np.random.default_rng(u)
    new = X[rng.integers(0, X.shape[0], size=u)] + 0.1
    kw = dict(se_pred=True, block_size=block_size, materialize_vcov=vcov)
    got = bt.predict(m, new, **kw)
    spans = _predict_spans()
    to_host = [s for s in spans if s.name == "to_host"]
    assert len(to_host) == (-(-u // block_size) if block_size else 1)
    assert [s.counters["host_reads"] for s in to_host] == [1] * len(to_host)
    copied = u * (2 if block_size else 1 + (u if vcov else 1) + X.shape[0])
    for key in ("bytes_to_host", "bytes_to_host_pinned"):
        assert sum(s.counters.get(key, 0) for s in spans) == 8 * copied
    real = tpredict._ToHost
    with monkeypatch.context() as mp:
        mp.setattr(tpredict, "_ToHost", lambda _: real(False))
        want = bt.predict(m, new, **kw)
    assert sum(s.counters.get("bytes_to_host_pinned", 0)
               for s in _predict_spans()) == 0
    for name in ("predicted", "se_pred", "newdataK", "vcov_est_pred"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == np.float64 and a.flags.c_contiguous, name
        assert a.flags.writeable, name
        assert np.array_equal(a, b), name
    assert got.newdataK is None if block_size else \
        got.newdataK.shape == (u, X.shape[0])


def test_pinned_results_outlive_the_next_call(cuda, card_model):
    """A result is a view of its pinned block, which the allocator hands
    out again only once nothing holds the array: a second call of the
    same size leaves the first call's arrays as they were."""
    import bigkrls_tpu_torch as bt
    m, X = card_model
    a = bt.predict(m, X[:517], se_pred=True)
    kept = {k: getattr(a, k).copy() for k in ("predicted", "se_pred",
                                              "newdataK")}
    b = bt.predict(m, X[517:1034], se_pred=True)
    for k, v in kept.items():
        assert np.array_equal(getattr(a, k), v), k
        assert not np.shares_memory(getattr(a, k), getattr(b, k)), k
    assert not np.array_equal(a.newdataK, b.newdataK)


def test_pinned_prediction_round_trips_through_persistence(cuda, card_model,
                                                           tmp_path):
    import bigkrls_tpu_torch as bt
    m, X = card_model
    p = bt.predict(m, X[100:400] * 0.9, se_pred=True)
    back = bt.load_model(bt.save_model(p, str(tmp_path / "p")),
                         device="cuda")
    for k in ("predicted", "se_pred", "newdata", "newdataK"):
        assert np.array_equal(getattr(back, k), getattr(p, k)), k


def test_adaptive_resume_bit_equal_on_card(cuda, tmp_path):
    import bigkrls_tpu_torch as bt
    y, X = _lowrank(1024)
    kw = dict(noisy=False, device="cuda", eigtrunc=0.001,
              eig_method="adaptive", checkpoint_dir=str(tmp_path / "ck"))
    m1 = bt.fit(y, X, **kw)
    m2 = bt.fit(y, X, **kw)
    assert m1.eig_path.startswith("adaptive-krylov")
    assert m2.eig_path == "checkpoint"
    assert (m1.lambda_, m1.looe, m1.neffective) == \
        (m2.lambda_, m2.looe, m2.neffective)
    assert np.array_equal(m1.coeffs, m2.coeffs)


def test_kernels_launch_on_every_card(cuda):
    """K1 (symmetric and cross) and K2 (precise, fast and the cross entry)
    on each visible card in turn, cuda:0 first: each within its plain
    version's tolerance on that card, bit-equal to cuda:0's result, and
    counted on that card. Each kernel instantiation allows its dynamic
    shared memory (over 48 KiB) per device; allowed once per process, it
    could not launch on a second card. With one card, cuda:0 alone."""
    from bigkrls_tpu_torch.bench import K2_FAST_TOL, k2_tol
    rng = np.random.default_rng(11)
    host = [rng.normal(size=s) for s in ((3106, 67), (517, 67), (8192, 20),
                                         (8192, 540), (4096, 20),
                                         (4096, 540))]
    tols = {"k1 sym": (1e-5, False), "k1 cross": (1e-5, False),
            "k2": (k2_tol(8192), True), "k2 fast": (K2_FAST_TOL, True),
            "k2 cross": (k2_tol(4096), True)}
    first = None
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        a, b, x, v, xb, vb = (torch.as_tensor(h, dtype=torch.float32,
                                              device=dev) for h in host)
        k1_before = kernels.gauss_tile_launches_by_device[i]
        k2_before = matvec.kernel_matmul_launches_by_device[i]
        got = {"k1 sym": kernels.gauss_tile(a, a, 67.0, True),
               "k1 cross": kernels.gauss_tile(b, a, 67.0, False),
               "k2": matvec.kernel_matmul(x, v, 20.0),
               "k2 fast": matvec.kernel_matmul(x, v, 20.0, fast_accum=True),
               "k2 cross": matvec.kernel_matmul_cross(x, xb, vb, 20.0)}
        want = {"k1 sym": kernels.gauss_tile_plain(a, a, 67.0, True),
                "k1 cross": kernels.gauss_tile_plain(b, a, 67.0, False),
                "k2": matvec.kernel_matmul_plain(x, v, 20.0),
                "k2 fast": matvec.kernel_matmul_plain(x, v, 20.0,
                                                      fast_accum=True),
                "k2 cross": matvec.kernel_matmul_plain(x, vb, 20.0, Xb=xb)}
        torch.cuda.synchronize(dev)
        assert kernels.gauss_tile_launches_by_device[i] == k1_before + 2
        assert matvec.kernel_matmul_launches_by_device[i] == k2_before + 3
        for name, (tol, relative) in tols.items():
            g, w = got[name], want[name]
            assert g.device == dev, name
            scale = w.abs().max().item() if relative else 1.0
            assert (g - w).abs().max().item() <= tol * scale, (name, dev)
        if first is None:
            first = {k: g.cpu() for k, g in got.items()}
        else:
            for k, g in got.items():
                assert torch.equal(g.cpu(), first[k]), (k, dev)


# ---- the golden-section λ search as a device loop --------------------------

def _golden_basis(dev, dtype, n=2000, k=200, seed=5):
    """A seeded orthonormal basis with a decaying spectrum, y, and the
    host bounds of the λ search over it."""
    from bigkrls_tpu_torch.lambda_search import _resolve_bounds
    from bigkrls_tpu_torch.types import Eigensystem
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, k)))
    vals = n * 0.9 ** np.arange(k)
    y = Q @ (rng.normal(size=k) * np.sqrt(vals) / np.sqrt(n)) \
        + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    eig = Eigensystem(torch.as_tensor(vals, dtype=dtype, device=dev),
                      torch.as_tensor(Q, dtype=dtype, device=dev), k)
    L, U, tol = _resolve_bounds(eig, n, None, None, None)
    return eig, torch.as_tensor(y, dtype=dtype, device=dev), (L, U, tol)


def test_golden_chunk_reads_nothing_on_card(cuda, monkeypatch):
    """Every chunk of the device loop runs under
    ``set_sync_debug_mode("error")``: no host read inside one; the loop on
    the card gives the CPU's λ* and iteration count in float64."""
    from bigkrls_tpu_torch.ops import solve
    real = solve.golden_chunk
    calls = []

    def strict(*a, **kw):
        if a[0][0].device.type != "cuda":
            return real(*a, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            calls.append(1)

    monkeypatch.setattr(solve, "golden_chunk", strict)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        eig, y, (L, U, tol) = _golden_basis(dev, torch.float64)
        lam, Le, coeffs, it = solve.golden_solve(eig.vectors, eig.values, y,
                                                 L, U, tol)
        out[dev.type] = (float(lam), it)
    assert calls and out["cuda"][1] == out["cpu"][1] > 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-12)
    eig, y, (L, U, tol) = _golden_basis(cuda, torch.float32)
    lam, _, _, _ = solve.golden_solve(eig.vectors, eig.values, y, L, U, tol)
    assert lam.dtype == torch.float32 and lam.device.type == "cuda"


def test_one_card_fit_times_phases_without_synchronize(cuda, monkeypatch):
    """A fit on one card calls ``torch.cuda.synchronize`` nowhere: its
    phases are device intervals between CUDA events, read at the fit's
    end, and every span under the call's root has its device interval."""
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.utils.progress import PHASES
    from bigkrls_tpu_torch.utils import progress
    rng = np.random.default_rng(17)
    X = rng.normal(size=(2100, 5))
    y = np.sin(X[:, 0]) + X[:, 1] + 0.1 * rng.normal(size=2100)
    bt.fit(y, X, device="cuda", noisy=False, eigtrunc=0.01)
    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d) or real(d))
    m = bt.fit(y, X, device="cuda", noisy=False, eigtrunc=0.01)
    assert synced == []
    monkeypatch.undo()
    assert m.eig_path.startswith("adaptive-krylov")
    assert [t["phase"] for t in m.timings] == list(PHASES)
    log = progress.spans()
    root = [s for s in log if s.parent is None and s.name == "fit"][-1]
    mine = [s for s in log if s.call == root.call]
    assert all((s.device_s is None) == (s is root or s.name == "library")
               for s in mine)
    phases = [s for s in mine if s.parent == root.id]
    assert [round(s.device_s, 4) for s in phases] == \
        [t["seconds"] for t in m.timings]

"""Port vs JAX: kernel construction, the K1 wrapper's CPU path, the
kernel build's bookkeeping, and the small statistics helpers.

Inputs are numpy draws handed to both packages in float64. The JAX side of
K1 is its plain reference (XLA ``gauss_kernel``/``cross_kernel``): the
Pallas kernel has no CPU mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigkrls_tpu.ops import kernels as jk
from bigkrls_tpu.ops import stats as jstats
from bigkrls_tpu_torch.ops import _build
from bigkrls_tpu_torch.ops import kernels as tk
from bigkrls_tpu_torch.ops import stats as tstats
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-12   # f64: both sides evaluate the same rank-P formula


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _std_rows(rng, n, p):
    X = rng.normal(size=(n, p))
    return (X - X.mean(0)) / X.std(0, ddof=1)


@pytest.mark.parametrize("n,p,explicit", [(50, 3, False), (120, 7, False),
                                          (40, 5, True)])
def test_gauss_kernel_matches_jax(n, p, explicit):
    X = _std_rows(np.random.default_rng(n + p), n, p)
    sigma = float(p)
    Kt = tk.gauss_kernel(_t(X), sigma, explicit=explicit).numpy()
    Kj = np.asarray(jk.gauss_kernel(jnp.asarray(X), sigma, explicit=explicit))
    assert np.max(np.abs(Kt - Kj)) <= TOL
    assert np.array_equal(Kt, Kt.T)                  # symmetrized
    assert np.all(np.diag(Kt) == 1.0)                # exact diagonal


def test_rank_p_matches_explicit_form():
    """The dot form reproduces the difference-sum form on standardized
    inputs (r ≈ P) to 1e-12 in f64."""
    X = _t(_std_rows(np.random.default_rng(3), 90, 6))
    K = tk.gauss_kernel(X, 6.0)
    Ke = tk.gauss_kernel(X, 6.0, explicit=True)
    assert torch.max(torch.abs(K - Ke)).item() <= TOL


def test_cross_kernel_matches_jax():
    rng = np.random.default_rng(5)
    Xo = _std_rows(rng, 80, 4)
    Xn = rng.normal(size=(13, 4))
    Kt = tk.cross_kernel(_t(Xn), _t(Xo), 4.0).numpy()
    Kj = np.asarray(jk.cross_kernel(jnp.asarray(Xn), jnp.asarray(Xo), 4.0))
    assert Kt.shape == (13, 80)
    assert np.max(np.abs(Kt - Kj)) <= TOL


@pytest.mark.parametrize("sym", [True, False])
def test_gauss_tile_cpu_takes_plain_path(sym):
    """On CPU tensors the wrapper runs the plain rank-P version and never
    counts a launch; the result agrees with the JAX reference to 1e-12
    (before the XLA path's symmetrizing step, which moves entries by
    rounding only)."""
    rng = np.random.default_rng(9)
    A = _std_rows(rng, 64, 5)
    B = A if sym else rng.normal(size=(31, 5))
    before = tk.gauss_tile_launches
    K = tk.gauss_tile(_t(A), _t(B), 5.0, sym)
    assert tk.gauss_tile_launches == before == 0
    ref = (jk.gauss_kernel(jnp.asarray(A), 5.0) if sym
           else jk.cross_kernel(jnp.asarray(B), jnp.asarray(A), 5.0).T)
    assert np.max(np.abs(K.numpy() - np.asarray(ref))) <= TOL
    if sym:
        assert np.all(np.diag(K.numpy()) == 1.0)
    plain = tk.gauss_tile_plain(_t(A), _t(B), 5.0, sym)
    assert torch.equal(K, plain)


def test_gauss_tile_rejects_bad_shapes():
    A = torch.zeros((5, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        tk.gauss_tile(A, torch.zeros((5, 4), dtype=torch.float64), 1.0, False)
    with pytest.raises(ValueError):
        tk.gauss_tile(A, torch.zeros((6, 3), dtype=torch.float64), 1.0, True)


@pytest.mark.parametrize("impl", ["auto", "plain", "cuda"])
def test_kernel_matrix_on_cpu(impl):
    """Every impl runs the plain version on a CPU tensor (the CUDA kernel
    is only reached on a CUDA tensor), with no launch counted."""
    X = _t(_std_rows(np.random.default_rng(2), 70, 4))
    K = tk.kernel_matrix(X, 4.0, impl)
    assert tk.gauss_tile_launches == 0
    ref = tk.gauss_kernel(X, 4.0)
    assert torch.max(torch.abs(K - ref)).item() <= TOL
    Kc = tk.cross_kernel_matrix(X[:9], X, 4.0, impl)
    assert torch.max(torch.abs(Kc - tk.cross_kernel(X[:9], X, 4.0))) <= TOL


def test_kernel_matrix_rejects_unknown_impl():
    X = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="kernel_impl"):
        tk.kernel_matrix(X, 2.0, "triton")


def test_build_digest_tracks_sources(tmp_path):
    """The library name is keyed by the sources' content: the same bytes
    give the same key, an edit gives a new one."""
    a = tmp_path / "a.cu"
    a.write_text("// one\n")
    d1 = _build._digest([a])
    assert _build._digest([a]) == d1
    a.write_text("// two\n")
    assert _build._digest([a]) != d1
    assert _build._sources()[0].name == "gauss_kernel.cu"


def test_standardize_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(40, 3)) * [1.0, 5.0, 0.1] + [0.0, 2.0, -1.0]
    y = rng.normal(size=40) * 3.0 + 1.0
    out_t = tstats.standardize(_t(X), _t(y))
    out_j = jstats.standardize(jnp.asarray(X), jnp.asarray(y))
    for a, b in zip(out_t, out_j):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= TOL


@pytest.mark.parametrize("block", [0, 16])
def test_neffective_acf_matches_jax(block):
    X = _std_rows(np.random.default_rng(6), 50, 4)
    got = tstats.neffective_acf(_t(X), block=block)
    want = float(jstats.neffective_acf(jnp.asarray(X), block=block))
    assert got == pytest.approx(want, rel=1e-12)


def test_neffective_spectral_matches_jax():
    vals = np.sort(np.random.default_rng(7).uniform(size=30))[::-1]
    got = tstats.neffective_spectral(_t(vals), 0.3, 30)
    want = jstats.neffective_spectral(jnp.asarray(vals), 0.3, 30)
    assert got == pytest.approx(want, rel=1e-12)


def test_t_tail_matches_jax():
    """scipy's betainc on the host vs jax.scipy's: 1e-10 relative (two
    independent implementations of the same special function)."""
    t = np.array([-3.0, -0.5, 0.0, 0.7, 2.0, 5.0])
    for df in (3.0, 30.0, 2500.0):
        assert np.allclose(tstats.t_sf(t, df),
                           np.asarray(jstats.t_sf(jnp.asarray(t), df)),
                           rtol=1e-10, atol=0)
        assert np.allclose(tstats.two_sided_p(t, df),
                           np.asarray(jstats.two_sided_p(jnp.asarray(t), df)),
                           rtol=1e-10, atol=0)


# ---- K1's host side: the tile plan, the block -> tile map, the staging ----

SMS = 132   # an H100's SM count; the plan is a pure function of it
MAX_SHARED = 232448   # bytes of shared memory one block may use on it

# (M, N, P, same rows): chip_smoke.py's K1 shapes, one entry, the 64-bit
# offset test's N, and predict's 10 rows against 50,000
PLAN_SHAPES = [(3106, 3106, 67, True), (1000, 1000, 5, True),
               (4097, 4097, 3, True), (16384, 16384, 20, True),
               (517, 3106, 67, False), (1, 1, 1, True),
               (46400, 46400, 3, True), (10, 50000, 20, False)]


@pytest.mark.parametrize("m,n,p,same", PLAN_SHAPES)
def test_tile_plan_is_legal_and_covers_every_tile_once(m, n, p, same):
    """The planned tile exists, its grid and shared memory are inside
    CUDA's limits, and the blocks' tiles (each mirrored one counted at
    (I, J) and (J, I)) cover the output's tiles exactly once."""
    tile, kc = tk._launch_plan(m, n, p, same, SMS, None)
    assert tile in tk._TILES and tile == tk._tile_plan(m, n, p, same, SMS)
    assert kc % 4 == 0 and 4 <= kc <= 72
    assert tk._shared_bytes(tile, p) <= MAX_SHARED
    blocks = tk._blocks(m, n, tile, same)
    assert 1 <= blocks <= tk._MAX_BLOCKS
    rows, cols = -(-m // tile), -(-n // tile)
    seen = np.zeros((rows, cols), dtype=np.int32)
    for t in range(blocks):
        if same:
            j, i = tk._tri_decode(t)
            assert 0 <= i <= j < rows
            seen[i, j] += 1
            if i != j:
                seen[j, i] += 1
        else:
            seen[t // cols, t % cols] += 1
    assert np.all(seen == 1)


def test_tile_plan_follows_the_waves():
    """64 where 128 would leave most of the last wave empty or cover rows
    that do not exist; 128 once there are many waves either way."""
    assert tk._tile_plan(3106, 3106, 67, True, SMS) == 64
    assert tk._tile_plan(10, 50000, 20, False, SMS) == 64
    assert tk._tile_plan(1000, 1000, 5, True, SMS) == 64
    assert tk._tile_plan(16384, 16384, 20, True, SMS) == 128
    assert tk._tile_plan(32768, 32768, 67, True, SMS) == 128


def test_launch_plan_refuses_what_the_kernel_lacks():
    with pytest.raises(ValueError, match="tile"):
        tk._launch_plan(100, 100, 3, False, SMS, 32)
    big = 64 * 70000                    # 4.9e9 tiles of 64 > 2^31 - 1
    with pytest.raises(ValueError, match="grid"):
        tk._launch_plan(big, big, 3, False, SMS, 64)
    # mirrored, the same rows need half as many blocks, and 128 a quarter
    assert tk._launch_plan(big, big, 3, True, SMS, 128)[0] == 128


@pytest.mark.parametrize("lo,hi", [(0, 500), (500, 1000), (1000, 1500),
                                   (1500, 2000)])
def test_tri_decode_exhaustive(lo, hi):
    """The block -> (row, column) map of the mirrored grid, for every
    block of every grid of up to 2,000 tile rows: block t = r(r+1)/2 + c
    decodes to (r, c), row by row."""
    t = tk._tri_count(lo)
    for r in range(lo, hi):
        for c in range(r + 1):
            assert tk._tri_decode(t) == (r, c)
            t += 1
    assert t == tk._tri_count(hi)


@pytest.mark.parametrize("rows", [725, 65535])
def test_tri_decode_at_large_grids(rows):
    """725 tile rows is N = 46400 at 64; 65,535 is the largest count whose
    triangle still fits CUDA's grid. The ends of the last rows, where a
    rounded square root would be off by one."""
    assert tk._tri_count(rows) <= tk._MAX_BLOCKS
    for r in (rows - 2, rows - 1):
        first = tk._tri_count(r)
        assert tk._tri_decode(first) == (r, 0)
        assert tk._tri_decode(first + r) == (r, r)
        assert tk._tri_decode(first - 1) == (r - 1, r - 1)
    assert tk._tri_decode(tk._tri_count(rows) - 1) == (rows - 1, rows - 1)


@pytest.mark.parametrize("p", [1, 3, 4, 5, 20, 67, 68, 72, 73, 200, 513])
def test_slices_and_shared_memory(p):
    """P up to 72 is staged whole (one slice, rounded up to a multiple of
    4: 67 runs 68 steps, not 80); wider P in slices of 32 through two
    buffers. Either way a block's shared memory fits, for both tiles."""
    kc = tk._slice_width(p)
    p4 = -(-p // 4) * 4
    assert kc == (p4 if p4 <= 72 else 32)
    for tile in tk._TILES:
        assert tile * (tile + 1) * 4 <= tk._shared_bytes(tile, p)
        assert tk._shared_bytes(tile, p) <= 80 * 1024


@pytest.mark.parametrize("p,ptrs,pitch", [
    (68, (1024, 2048), 0),       # a multiple of 4, aligned: X as it is
    (20, (512, 512), 0),
    (67, (1024, 1024), 68),      # the fit's width: one copy, pitch 68
    (5, (1024, 4096), 8),
    (1, (256, 256), 4),
    (68, (1024, 2052), 68),      # a misaligned view: copied at its own pitch
])
def test_padded_pitch(p, ptrs, pitch):
    """The kernel copies 16 bytes at a time: X is copied (once, into a
    pitch that is the next multiple of 4, zeros in the pad) only where P
    is no multiple of 4 or a pointer is not 16-byte aligned."""
    got = tk._padded_pitch(p, *ptrs)
    assert got == pitch and got % 4 == 0 and (got == 0 or 0 <= got - p < 4)


def test_gauss_tile_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's own wrapper never runs the plain version: a CPU tensor
    raises there (``gauss_tile`` routes CPU tensors before it)."""
    A = torch.zeros((4, 3), dtype=torch.float32)
    before = tk.gauss_tile_launches
    with pytest.raises(ValueError, match="CUDA device"):
        tk._gauss_tile_cuda(A, A, 3.0, True)
    assert tk.gauss_tile_launches == before

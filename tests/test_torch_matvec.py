"""The host side of the port's K(X)·V kernel, on the CPU.

What surrounds the CUDA kernel is Python, and is tested here: the plain
version of the kernel's precise mode (the split-TF32 product,
``kernel_matmul_split_plain``) against a float64 product and against the
JAX package's ``kernel_matmul`` on the same numpy inputs; the rule that
picks the width of a block's output tile, a pure function of the shape and
the SM count; and the staging of V into the pitch the kernel takes. The
kernel itself is held against these on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigkrls_tpu.ops import matvec as jmv
from bigkrls_tpu_torch.ops import matvec as tmv
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)


def _t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


# ---- TF32 rounding and the split ----------------------------------------

@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -12, 1.0),                      # below half a unit: down
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),         # a tie goes away from zero
    (-1.0 - 2.0 ** -11, -1.0 - 2.0 ** -10),
    (1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10),         # representable: unchanged
    (0.0, 0.0),
    (3.0 * 2.0 ** -136, 3.0 * 2.0 ** -136),       # a coarse subnormal
])
def test_tf32_round_is_nearest_with_ties_away(x, want):
    got = tmv._tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == np.float32(want)


def test_tf32_split_keeps_21_bits():
    """hi has 10 stored mantissa bits and lo, the rounded remainder, 10
    more below a gap of at most one bit: hi + lo is x to 2^-21 relative
    (2^-23 for most values), and both parts are TF32 values."""
    rng = np.random.default_rng(0)
    x = _t32(rng.normal(size=4096) * np.exp(rng.normal(size=4096) * 8))
    hi, lo = tmv._tf32_split(x)
    for part in (hi, lo):
        assert torch.all(part.view(torch.int32) & 0x1FFF == 0)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert rel.max().item() <= 2.0 ** -21


# ---- the split product --------------------------------------------------

SPLIT_SHAPES = [(53, 3, 2, 16, False), (200, 5, 7, 64, False),
                (517, 20, 22, 128, True), (1024, 20, 65, 1024, True)]


@pytest.mark.parametrize("n,p,m,block,epilogue", SPLIT_SHAPES)
def test_split_product_matches_f64(n, p, m, block, epilogue):
    """The split emulation in f32 against the same product in float64:
    4·2^-21 of max|Y|. Per product the split drops lo·lo and rounds the lo
    parts (2^-22 relative each side), the tile itself is an f32 value
    (2^-24 of entries at most 1, after a rank-P cancellation that exp()
    damps) and the N products are summed in f32; at N <= 1024 all of that
    stays under four units of 2^-21 of the largest output."""
    rng = np.random.default_rng(n + m)
    X, V, init = (rng.normal(size=s) for s in ((n, p), (n, m), (n, m)))
    kw = dict(init=_t32(init), out_scale=-2.5) if epilogue else {}
    got = tmv.kernel_matmul_split_plain(_t32(X), _t32(V), float(p),
                                        block=block, **kw)
    kw64 = {k: (v.double() if k == "init" else v) for k, v in kw.items()}
    want = tmv.kernel_matmul_plain(_t32(X).double(), _t32(V).double(),
                                   float(p), **kw64)
    assert got.dtype == torch.float32 and got.shape == (n, m)
    err = (got.double() - want).abs().max().item()
    assert err <= 4 * 2.0 ** -21 * want.abs().max().item()


@pytest.mark.parametrize("n,p,m,block,epilogue", SPLIT_SHAPES)
def test_split_product_matches_jax(n, p, m, block, epilogue):
    """The split emulation against the JAX package's ``kernel_matmul`` in
    f32 on the same numpy inputs: 1e-5 of max|Y|, the f32 rounding of two
    length-N sums taken in different orders (the split's own error is a
    fifth of that, see above)."""
    rng = np.random.default_rng(n + m)
    X, V, init = (rng.normal(size=s).astype(np.float32)
                  for s in ((n, p), (n, m), (n, m)))
    jkw = dict(init=jnp.asarray(init), out_scale=-2.5) if epilogue else {}
    want = np.asarray(jmv.kernel_matmul(jnp.asarray(X), jnp.asarray(V),
                                        float(p), **jkw))
    tkw = dict(init=_t32(init), out_scale=-2.5) if epilogue else {}
    got = tmv.kernel_matmul_split_plain(_t32(X), _t32(V), float(p),
                                        block=block, **tkw).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_split_product_checks_and_aliasing():
    """The emulation takes the kernel's arguments: ``out`` may be ``init``
    itself, float64 is refused, and the kernel's argument checks apply."""
    rng = np.random.default_rng(1)
    X, V, init = (_t32(rng.normal(size=s)) for s in ((40, 3), (40, 6),
                                                     (40, 6)))
    want = tmv.kernel_matmul_split_plain(X, V, 3.0, init=init, out_scale=0.5)
    buf = init.clone()
    got = tmv.kernel_matmul_split_plain(X, V, 3.0, init=buf, out_scale=0.5,
                                        out=buf)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(got, want)
    with pytest.raises(TypeError):
        tmv.kernel_matmul_split_plain(X.double(), V.double(), 3.0)
    with pytest.raises(ValueError, match="alias"):
        tmv.kernel_matmul_split_plain(X, V, 3.0, out=V)


@pytest.mark.parametrize("n,p,m,block,epilogue", SPLIT_SHAPES)
def test_fast_emulation_is_the_tf32_rounded_product(n, p, m, block,
                                                    epilogue):
    """``fast=True``: the tile and V rounded to TF32 (as the kernel's fast
    mode rounds them) and one f32 product, against float64 sums of the
    same rounded operands within 2^-21 of max|Y| (f32 sums of at most 1024
    terms); and TF32-level (above 2^-14 of max|Y|, under 2^-9) from the
    precise emulation."""
    rng = np.random.default_rng(n + m + 1)
    X, V, init = (_t32(rng.normal(size=s)) for s in ((n, p), (n, m), (n, m)))
    kw = dict(init=init, out_scale=-2.5) if epilogue else {}
    got = tmv.kernel_matmul_split_plain(X, V, float(p), block=block,
                                        fast=True, **kw)
    from bigkrls_tpu_torch.ops.kernels import _sqdist
    tile = tmv._tf32_round(torch.exp(-_sqdist(X, X) / float(p)))
    want = tile.double() @ tmv._tf32_round(V).double()
    if epilogue:
        want = (want + init.double()) * -2.5
    top = want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= 2.0 ** -21 * top
    precise = tmv.kernel_matmul_split_plain(X, V, float(p), block=block,
                                            **kw)
    gap = (got - precise).abs().max().item() / top
    assert 2.0 ** -14 < gap < 2.0 ** -9


@pytest.mark.parametrize("fast", [False, True])
def test_split_emulation_cross_entry(fast):
    """With ``Xb`` the emulation is the cross entry's: K(X, Xb)·V for V
    with Xb's rows; with ``Xb = X`` it is the square product bit for bit,
    and each output row is the square product's row of the stacked rows."""
    rng = np.random.default_rng(3)
    Xa, Xb = _t32(rng.normal(size=(37, 4))), _t32(rng.normal(size=(300, 4)))
    V = _t32(rng.normal(size=(300, 9)))
    got = tmv.kernel_matmul_split_plain(Xa, V, 4.0, Xb=Xb, fast=fast,
                                        block=128)
    assert got.shape == (37, 9)
    same = tmv.kernel_matmul_split_plain(Xb, V, 4.0, Xb=Xb, fast=fast,
                                         block=128)
    assert torch.equal(same, tmv.kernel_matmul_split_plain(
        Xb, V, 4.0, fast=fast, block=128))
    both = torch.cat([Xa, Xb])
    Vz = torch.cat([torch.zeros((37, 9)), V])
    full = tmv.kernel_matmul_split_plain(both, Vz, 4.0, fast=fast,
                                         block=337)
    assert torch.allclose(got, full[:37], rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tmv.kernel_matmul_split_plain(Xa, V[:100], 4.0, Xb=Xb)


# ---- the width rule -----------------------------------------------------

# (N, P, m) -> 64-column units on a 132-SM card: the smoke's and the card
# tests' shapes. The fit's power block gets the pair of 320-wide blocks (5:
# one tile build per (i, j)); the derivatives stack and single columns the
# narrowest; vcov_fitted_diag's 230 columns the 256-wide tile; a grid too
# small to fill the card with wide tiles gets narrower ones
PLAN_132 = [((50_000, 20, 540), 5), ((50_000, 20, 22), 1),
            ((50_000, 20, 1), 1), ((4097, 3, 5), 1), ((1000, 67, 130), 1),
            ((8192, 20, 1100), 5), ((50_000, 20, 230), 4),
            ((2048, 20, 540), 4), ((4096, 67, 540), 5),
            ((4096, 20, 541), 5), ((4096, 20, 22), 1)]


@pytest.mark.parametrize("shape,want", PLAN_132)
def test_tile_plan_on_132_sms(shape, want):
    assert tmv._tile_plan(*shape, 132) == want


@pytest.mark.parametrize("sms", [1, 16, 108, 132, 144])
def test_tile_plan_is_a_pure_function_with_valid_widths(sms):
    """Whatever the SM count, the rule returns one of the kernel's widths,
    the same one when asked again, and never a tile wider than needed by
    more than one step of the ladder."""
    for shape, _ in PLAN_132:
        nt = tmv._tile_plan(*shape, sms)
        assert nt in tmv._N_TILES and nt == tmv._tile_plan(*shape, sms)
        m = shape[2]
        narrower = [t for t in tmv._N_TILES if t < nt]
        assert not narrower or 64 * max(narrower) < m


def test_tile_plan_on_one_sm_takes_the_fewest_builds():
    """With one SM every block is a wave of its own, so the widest tile
    that the columns fill wins."""
    assert tmv._tile_plan(50_000, 20, 540, 1) == 5
    assert tmv._tile_plan(50_000, 20, 22, 1) == 1


# ---- staging V ----------------------------------------------------------

@pytest.mark.parametrize("n,m", [(5, 1), (63, 22), (64, 541), (130, 7),
                                 (17, 3)])
def test_stage_v_pads_ragged_widths(n, m):
    """A width that is no multiple of 4 is copied into a buffer whose pitch
    is the next multiple of 4, 16-byte aligned; the first m columns are V."""
    V = _t32(np.random.default_rng(n + m).normal(size=(n, m)))
    buf, pitch = tmv._stage_v(V)
    assert pitch == -(-m // 4) * 4 and pitch - m < 4
    assert buf.shape == (n, pitch) and buf.is_contiguous()
    assert buf.data_ptr() % 16 == 0 and buf.data_ptr() != V.data_ptr()
    assert torch.equal(buf[:, :m], V)


@pytest.mark.parametrize("n,m", [(5, 4), (63, 540), (1000, 64)])
def test_stage_v_passes_aligned_widths_through(n, m):
    V = _t32(np.random.default_rng(n + m).normal(size=(n, m)))
    buf, pitch = tmv._stage_v(V)
    assert pitch == m and buf.data_ptr() == V.data_ptr()


def test_stage_v_copies_a_misaligned_view():
    """A contiguous V that starts 4 bytes into an allocation is not 16-byte
    aligned, whatever its width: it is copied."""
    base = _t32(np.arange(8 * 8 + 1, dtype=np.float32))
    V = base[1:].view(8, 8)
    assert V.is_contiguous() and V.data_ptr() % 16 != 0
    buf, pitch = tmv._stage_v(V)
    assert pitch == 8 and buf.data_ptr() % 16 == 0 and torch.equal(buf, V)

"""``fit(acf=True)`` and the acf effective N of the port against the JAX
package (after ``tests/test_eig_stats.py``'s acf tests): the fit's
statistic on one device and over a 2×2 mesh (X row-sharded, read whole
for the statistic), ``auto_acf_block``'s slab widths, and the blocked
slab accumulation over a row-sharded X. Float64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu.ops.stats import neffective_acf as jax_neffective_acf
from bigkrls_tpu_torch.ops.stats import neffective_acf

torch.set_num_threads(1)


@pytest.mark.parametrize("on_mesh", [False, True])
def test_fit_acf_matches_jax(on_mesh):
    """``fit(acf=True)``: the acf effective N against the JAX package's,
    on one device and over a 2×2 mesh (X row-sharded, read whole for the
    statistic), and summary's acf degrees of freedom with it."""
    import jax
    from bigkrls_tpu.parallel import sharded as jsh
    from bigkrls_tpu_torch.parallel import sharded as tsh
    r = np.random.default_rng(11)
    n, p = 60, 4
    X = r.normal(size=(n, p))
    y = X @ np.ones(p) + 0.2 * r.normal(size=n)
    jm = jsh.make_mesh(devices=jax.devices()[:4]) if on_mesh else None
    tm = tsh.make_mesh(devices=["cpu"] * 4) if on_mesh else None
    mj = bk.fit(y, X, acf=True, noisy=False, mesh=jm)
    mt = bt.fit(y, X, acf=True, mesh=tm, device="cpu",
                dtype=torch.float64, noisy=False)
    assert abs(mt.neffective_acf - mj.neffective_acf) <= 1e-10
    assert abs(bt.summary(mt, degrees="acf").n_dof
               - bk.summary(mj, degrees="acf").n_dof) <= 1e-10


@pytest.mark.parametrize("n,itemsize,budget", [
    (500_000, 4, 8 << 30), (50_000, 4, 8 << 30), (500_000, 8, 8 << 30),
    (1_000_000, 4, 1 << 30), (10_000, 4, 64 << 30), (9000, 8, 40 << 20)])
def test_auto_acf_block_matches_jax(n, itemsize, budget):
    from bigkrls_tpu.ops.stats import auto_acf_block as jax_block
    from bigkrls_tpu_torch.ops.stats import auto_acf_block
    assert auto_acf_block(n, itemsize, budget) == jax_block(n, itemsize,
                                                            budget=budget)


def test_blocked_acf_of_row_sharded_x_matches_jax():
    """The blocked slab accumulation over a row-sharded X_std against the
    JAX package's blocked statistic."""
    from bigkrls_tpu_torch.parallel import sharded as tsh
    Xs = np.random.default_rng(13).normal(size=(600, 4))
    Xs = (Xs - Xs.mean(0)) / Xs.std(0, ddof=1)
    want = float(jax_neffective_acf(jnp.asarray(Xs), block=256))
    mesh = tsh.make_mesh(devices=["cpu"] * 4)
    got = neffective_acf(tsh.place(torch.as_tensor(Xs), mesh, "row"),
                         block=256)
    assert abs(got - want) <= 1e-10

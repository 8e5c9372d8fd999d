"""Port vs JAX at the streaming route's large-N rules, on the CPU.

From N = 200,000 the JAX ``eigensystem_streaming`` reports progress after
every product (``chunk`` clamped to 1). Both packages here get a cheap
caller-supplied ``matmul`` (a diagonal operator on V), so no N×N work runs,
and their ``progress(done, total)`` calls must be the same sequence on
every flow, on either side of the threshold."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigkrls_tpu.ops import eig as jeig
from bigkrls_tpu_torch.ops import eig as teig

torch.set_num_threads(1)

NEIG, ITERS = 2, 3      # q = 12: a basis of (ITERS + 1)·12 columns


def _diag(n):
    """Eigenvalues 1, 1/2, 1/3, ... of a diagonal operator."""
    return 1.0 / np.arange(1, n + 1)


@pytest.mark.parametrize("krylov", [True, False])
@pytest.mark.parametrize("n", [199_999, 200_000])
def test_progress_calls_match_jax(n, krylov):
    d = _diag(n)
    dj = jnp.asarray(d, jnp.float32)
    dt = torch.as_tensor(d, dtype=torch.float32)
    X = np.zeros((n, 1), np.float32)
    calls_j, calls_t = [], []
    ej = jeig.eigensystem_streaming(
        jnp.asarray(X), 1.0, neig=NEIG, iters=ITERS, krylov=krylov,
        matmul=lambda X_, V, s: dj[:, None] * V,
        progress=lambda done, total: calls_j.append((done, total)))
    et = teig.eigensystem_streaming(
        torch.as_tensor(X), 1.0, neig=NEIG, iters=ITERS, krylov=krylov,
        matmul=lambda X_, V, s: dt[:, None] * V,
        progress=lambda done, total: calls_t.append((done, total)))
    assert calls_t == calls_j
    per_product = n >= 200_000 or not krylov
    assert len(calls_t) == (ITERS if per_product else 1)
    # the operator's top eigenvalues, on both sides
    assert np.allclose(et.values_full.numpy()[:NEIG], d[:NEIG], rtol=1e-4)
    assert np.allclose(np.asarray(ej.values_full)[:NEIG], d[:NEIG],
                       rtol=1e-4)

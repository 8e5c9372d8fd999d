"""One BLAS thread while a module of the port's tests runs.

Each ``tests/test_torch_*.py`` imports :func:`one_blas_thread`, an autouse
fixture of module scope. Under ``pytest -n`` every worker's OpenBLAS
(numpy's, and scipy's, which jaxlib calls for LAPACK on the CPU) runs one
thread a core, and the workers' threads spin against each other: a test
that takes seconds alone takes minutes beside five copies of itself. The
fixture limits the BLAS libraries loaded in the worker to one thread and
sets ``OPENBLAS_NUM_THREADS=1`` for the processes a test starts, and puts
both back when the module ends, so that the JAX package's own test
modules run as they would without it.
"""
import contextlib

import pytest
import scipy.linalg  # noqa: F401  (scipy's BLAS is loaded before the limit)


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limit = contextlib.nullcontext()
    else:
        limit = threadpool_limits(1, user_api="blas")
    with limit, pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENBLAS_NUM_THREADS", "1")
        yield

"""One BLAS thread for the port's CPU tests.

The hashing embedders of both packages project every text with a small
numpy product ((n, 4096) @ (4096, d)).  OpenBLAS splits it over every
core; in a test process whose torch and XLA thread pools hold those
cores, a product of a few rows then takes tens of milliseconds instead
of a tenth of one, and a growth round's thousands of summaries take
tens of seconds.  Test modules import ``one_blas_thread``, an autouse
module fixture that holds OpenBLAS to one thread while they run and
restores it after.  Both packages run under the same limit, so their
results are compared as they were.
"""
import pytest
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(1, user_api="blas"):
        yield

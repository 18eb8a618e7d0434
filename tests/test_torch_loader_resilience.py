"""The port's data loader under faults, held against the JAX package's
(``tests/test_resilience.py`` :556-640): a read that fails twice at step 1
(``data.batch``) is retried and gives the same (seed, step) batch bitwise,
with the same deliveries as the JAX loader's under the same plan; a worker
that dies re-raises as ``RuntimeError("... prefetch thread died ...")``
with the original exception, traceback intact, as ``__cause__``; a read
that hangs raises ``StallError`` naming the step within 5 s; and the
native token-bin loader goes through the same retry."""

import threading
import time

import numpy as np
import pytest
import torch

from orion_tpu.resilience import inject as jax_inject
from orion_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from orion_tpu.training.data import DataLoader as JaxDataLoader
from orion_tpu.training.data import SyntheticDataset as JaxSyntheticDataset
from orion_tpu_torch import runtime
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.resilience.watchdog import StallError
from orion_tpu_torch.training.data import DataLoader, SyntheticDataset, write_token_bin

pytestmark = pytest.mark.chaos
torch.set_num_threads(2)
FAST_RETRY = RetryPolicy(attempts=4, base_delay=0.01, max_delay=0.05)


def _two(loader):
    try:
        return next(loader), next(loader)
    finally:
        loader.close()


def test_dataloader_retries_transient_io_bitwise_and_as_the_jax_loader():
    ds = SyntheticDataset(32, 8)
    plan = inject.FaultPlan().fail_io("data.batch", step=1, times=2)
    with inject.inject(plan):
        b0, b1 = _two(DataLoader(ds, batch_size=2, seed=1, retry=FAST_RETRY))
    # the retried batch is the same (seed, step) batch: the fault changed
    # timing, never data
    np.testing.assert_array_equal(b1.numpy(), ds.batch(1, 1, 2))
    assert b1.dtype == torch.int64
    jplan = jax_inject.FaultPlan().fail_io("data.batch", step=1, times=2)
    with jax_inject.inject(jplan):
        j0, j1 = _two(JaxDataLoader(JaxSyntheticDataset(32, 8), batch_size=2, seed=1,
                                    retry=JaxRetryPolicy(attempts=4, base_delay=0.01,
                                                         max_delay=0.05)))
    assert plan.delivered == jplan.delivered == ["data.batch@1", "data.batch@1"]
    np.testing.assert_array_equal(b0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(j1))


def test_native_loader_retries_bitwise(tmp_path):
    path = str(tmp_path / "t.bin")
    write_token_bin(path, (np.arange(4000) * 7919) % 50000, vocab_size=50000)
    ds = runtime.make_fastest_dataset(path, 16)
    plan = inject.FaultPlan().fail_io("data.batch", step=0, times=1)
    with inject.inject(plan):
        b0, b1 = _two(DataLoader(ds, batch_size=4, seed=3, retry=FAST_RETRY))
    np.testing.assert_array_equal(b0.numpy(), ds.batch(3, 0, 4))
    np.testing.assert_array_equal(b1.numpy(), ds.batch(3, 1, 4))
    assert plan.delivered == ["data.batch@0"]


def test_retries_spent_the_worker_dies_with_its_cause():
    ds = SyntheticDataset(32, 8)
    plan = inject.FaultPlan().fail_io("data.batch", step=1, times=-1)
    with inject.inject(plan):
        loader = DataLoader(ds, batch_size=2, seed=0, retry=FAST_RETRY)
        try:
            next(loader)
            with pytest.raises(RuntimeError, match="prefetch thread died at step 1") as ei:
                next(loader)
        finally:
            loader.close()
    assert isinstance(ei.value.__cause__, OSError)
    assert len(plan.delivered) == FAST_RETRY.attempts


def test_dataloader_reraises_worker_exception_with_cause():
    ds = SyntheticDataset(32, 8)

    class Dies:
        vocab_size = 32

        def batch(self, seed, step, b):
            if step >= 1:
                raise ValueError("shard 7 unreadable")  # not retryable
            return ds.batch(seed, step, b)

    loader = DataLoader(Dies(), batch_size=2, seed=0)
    try:
        next(loader)
        with pytest.raises(RuntimeError, match="prefetch thread died") as ei:
            while True:
                next(loader)
        assert isinstance(ei.value.__cause__, ValueError)
        assert "shard 7 unreadable" in str(ei.value.__cause__)
        assert ei.value.__cause__.__traceback__ is not None
    finally:
        loader.close()


def test_dataloader_stall_raises_diagnosable_error():
    ds = SyntheticDataset(32, 8)
    release = threading.Event()

    class Hangs:
        vocab_size = 32

        def batch(self, seed, step, b):
            if step >= 1:
                release.wait()  # a dead network mount
            return ds.batch(seed, step, b)

    loader = DataLoader(Hangs(), batch_size=2, seed=0, stall_timeout=0.5)
    try:
        next(loader)
        t0 = time.monotonic()
        with pytest.raises(StallError, match="stuck fetching step 1"):
            next(loader)
        assert time.monotonic() - t0 < 5.0  # raised promptly, not hung
    finally:
        release.set()
        loader.close()


def test_no_stall_budget_waits_out_a_slow_read():
    ds = SyntheticDataset(32, 8)

    class Slow:
        vocab_size = 32

        def batch(self, seed, step, b):
            if step == 1:
                time.sleep(1.2)  # longer than one wait of __next__
            return ds.batch(seed, step, b)

    _, b1 = _two(DataLoader(Slow(), batch_size=2, seed=0))
    np.testing.assert_array_equal(b1.numpy(), ds.batch(0, 1, 2))

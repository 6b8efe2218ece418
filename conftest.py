"""Settings for the whole test run.

pytest loads this file before ``tests/conftest.py``, and so before jax or
torch is imported.

- Each pytest-xdist worker gets an equal share of the cores: torch's
  intra-op pool would otherwise start a thread per core in every worker, and
  XLA's CPU client runs its Eigen work on one.  Outside xdist nothing changes.
- ``SLOW`` lists the tests of the JAX package alone that still take over
  120 s under the tier-1 command (``-m 'not slow'``); each one is marked
  ``slow`` here, so the JAX package's test files keep their own markers (all
  of these are also ``heavy``, which ``pytest.ini``'s default run leaves out).
- Every test under ``tests/`` other than a ``slow`` one runs each phase (its
  setup, call and teardown) under ``LIMIT_S``.  When ``SIGALRM`` fires, the
  handler writes every thread's stack to stderr and fails that phase with the
  test's name and the limit; the run then goes on to the next test.  A
  module-scoped fixture is set up inside the setup of the first test that
  uses it, so its time counts there.  The handler runs only between Python
  bytecodes, so it cannot stop a test stuck inside one native call (an XLA
  compile, a wait with no deadline): ``faulthandler`` then dumps the stacks
  30 s later and ends the process, which xdist reports as a crashed worker
  naming the test, and replaces.  Where ``SIGALRM`` does not exist, or off
  the main thread, no limit is armed.
"""

import contextlib
import faulthandler
import io
import os
import signal
import sys
import threading

import pytest

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    THREADS = max(1, (cores or 1) // WORKERS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_multi_thread_eigen" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_multi_thread_eigen=false").strip()

    import torch

    # only where it changes the count: setting the count torch already has
    # made the port's small-tensor twins several times slower on 8 cores
    if THREADS != torch.get_num_threads():
        torch.set_num_threads(THREADS)

SLOW = frozenset(
    [f"tests/test_parallel.py::{name}" for name in (
        "test_gaussian_sharded_render_matches_single",
        "test_gaussian_sharded_gradients_match_single",
        "test_gshard_exchange_overflow_detected_and_cured_by_growth",
        "test_dp_train_step_runs_and_matches_mean_gradient",
        "test_dp_loss_matches_single_camera_mean",
        "test_gshard_train_step_matches_single_device",
        "test_dp_train_step_full_semantics",
        "test_train_loop_parallel_gshard_matches_single",
        "test_train_loop_parallel_dp_runs",
    )]
    # the module's dataset fixture (about 130-200 s) is charged to whichever
    # of its tests runs first, so none of them is under 120 s when first
    + [f"tests/test_pipeline_e2e.py::{name}" for name in (
        "test_scene_loads",
        "test_short_training_improves",
        "test_checkpoint_roundtrip",
        "test_observability_events",
        "test_overflow_steps_are_noops_and_growth_recovers",
        "test_overflow_persistent_exhaustion_aborts",
    )]
)

LIMIT_S = 300.0


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # before the ``-m`` expression deselects
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


def _stderr():
    try:
        sys.stderr.fileno()
        return sys.stderr
    except (AttributeError, ValueError, io.UnsupportedOperation):
        # a stderr capture with no file descriptor behind it
        return sys.__stderr__


@contextlib.contextmanager
def _limited(item, phase):
    if (not item.nodeid.startswith("tests/") or item.get_closest_marker("slow")
            or not hasattr(signal, "setitimer")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    limit = LIMIT_S

    def expired(signum, frame):
        faulthandler.dump_traceback(file=_stderr(), all_threads=True)
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s in its {phase}")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + 30.0, exit=True, file=sys.__stderr__)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _limited(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _limited(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _limited(item, "teardown"):
        yield

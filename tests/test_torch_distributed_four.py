"""Twins of the four-process tests of ``tests/test_distributed.py`` on FOUR
ranks: the corners two ranks cannot reach (the group minimum against
"all agree", several survivors of an abort, a line ending mid-sweep in a
bigger group), in a pool of 4 gloo ranks (``tests/torch_mesh_worker.py``;
every job has its own time limit). The scenarios and what shrank are in
``tests/torch_dcn_twins.py``.
"""

import pytest

import pipe_tpu_torch
from tests import torch_dcn_twins as twins
from tests.torch_mesh_worker import Pool

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

N = 4


@pytest.fixture(scope="module")
def pool():
    p = Pool(world=N)
    yield p
    p.close()


def test_four_host_width_changing_insert(pool):
    """``width_insert`` on 4 ranks: 24 blocks of 1176 (rounds every 8)
    instead of 400."""
    twins.check_width_insert(pool, N)


def test_four_host_stream_time_axis_spans_processes(pool):
    """``stream`` on 4 ranks: 96 blocks instead of 400."""
    twins.check_stream(pool, N)


def test_four_host_untargeted_push_agreement_staggered(pool):
    """Rank r pushes 0.08 r s after the stream passed block 32: the pending
    counts pass through asymmetric states, nothing lands until every rank
    holds the batch, then it lands on the same block everywhere. 96 blocks
    instead of 400."""
    twins.check_untargeted(pool, N, stagger=0.08)


def test_four_host_unmatched_untargeted_push_fails_loudly(pool):
    """``untargeted_stale``: 160 blocks instead of 400, a stale budget of 4
    rounds instead of 64."""
    twins.check_untargeted_stale(pool, N)


def test_four_host_untargeted_pending_at_eof_fails_loudly(pool):
    """``untargeted_eof``: 40 blocks instead of 400; rank 0 pushes after
    block 33."""
    twins.check_untargeted_eof(pool, N)


def test_four_host_abort_three_survivors(pool):
    """``abort`` on 4 ranks: 96 blocks instead of 400, rank 1 fails at
    block 40."""
    twins.check_abort(pool, N)


def test_four_host_heavy_collectives_ols_delay_stft(pool):
    """``ols_delay`` on 4 ranks: 64 blocks instead of 400."""
    twins.check_ols_delay(pool, N)


def test_four_host_checkpoint_resume(pool):
    """``ckpt`` on 4 ranks: 64 blocks instead of 400."""
    twins.check_ckpt(pool, N)


def test_four_host_multiline_staggered_eof_with_surgery(pool):
    """``multiline`` on 4 ranks: 96 and 48 blocks instead of 400 and 200."""
    twins.check_multiline(pool, N)

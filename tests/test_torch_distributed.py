"""Twins of ``tests/test_distributed.py`` on TWO ranks: the port's mesh
``Pipe`` with its health rounds over a real process group, one process per
shard, in a pool of 2 gloo ranks (``tests/torch_mesh_worker.py``; every job
has its own time limit). The scenarios and what shrank are in
``tests/torch_dcn_twins.py``; the twins on four ranks are in
``tests/test_torch_distributed_four.py``. The JAX file's
``test_two_process_group_sharded_chain`` (``tests/dcn_worker.py``: a
``ShardedChain`` over two processes) has its twin in
``tests/test_torch_parallel.py``, which runs the sharded chains on gloo
ranks already.

Also here, new with the port: a rank that is stopped, whose sink fails or
whose start fails ends every rank's run within 15 s, with the group
timeout left at 60 s.
"""

import pytest

import pipe_tpu_torch
from tests import torch_dcn_twins as twins
from tests.torch_mesh_worker import Pool

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

N = 2


@pytest.fixture(scope="module")
def pool():
    p = Pool(world=N)
    yield p
    p.close()


def test_two_host_streaming_pipe_1000_chunks(pool):
    """``stream``: 96 blocks of 512 instead of 1000 (6 rounds and the
    closing one)."""
    twins.check_stream(pool, N)


def test_two_host_untargeted_push_agreement(pool):
    """``stream_untargeted``: 96 blocks instead of 1000; both ranks push
    after block 32."""
    twins.check_untargeted(pool, N, stagger=0.0)


def test_two_host_streaming_pipe_batched_dispatch(pool):
    """``stream_batched``: 96 blocks instead of 1000, ``batch_blocks=8``."""
    twins.check_stream_batched(pool, N)


def test_two_host_batched_dispatch_abort(pool):
    """``abort_batched``: 96 blocks instead of 1000, rank 1 fails at block
    40."""
    twins.check_abort(pool, N, batch_blocks=8)


def test_two_host_distributed_fdl_and_delay_ladder(pool):
    """``ols_delay``: 64 blocks instead of 1000 (4 rounds)."""
    twins.check_ols_delay(pool, N)


def test_two_host_merged_mixer_psum(pool):
    """``mix_psum``: 64 blocks instead of 1000, on a 2x1 mesh."""
    twins.check_mix_psum(pool, N)


def test_two_host_undelivered_target_fails_loudly(pool):
    """``late_target``: 40 blocks instead of 1000, the target at 10,000."""
    twins.check_late_target(pool, N)


def test_two_host_first_error_wins_abort(pool):
    """``abort``: 96 blocks instead of 1000, rank 1 fails at block 40."""
    twins.check_abort(pool, N)


def test_two_host_multiline_pipe_with_targeted_surgery(pool):
    """``multiline``: 96 and 48 blocks instead of 1000 and 500."""
    twins.check_multiline(pool, N)


def test_two_host_short_read_rechunking(pool):
    """``stream_chunky``: 80 blocks and a 333-frame tail instead of 1000
    blocks."""
    twins.check_stream_chunky(pool, N)


def test_two_host_width_changing_insert(pool):
    """``width_insert``: 24 blocks of 1176 (rounds every 8) instead of
    1000."""
    twins.check_width_insert(pool, N)


def test_two_host_checkpoint_resume(pool):
    """``ckpt``: 64 blocks (two halves of 32) instead of 1000."""
    twins.check_ckpt(pool, N)


@pytest.mark.parametrize("group", [False, True], ids=["line", "sync_group"])
def test_two_host_abort_in_final_window(pool, group):
    """Rank 1 fails at block 58 of 60, inside the last window (rounds at
    48 and 64): rank 0's stream ends first, and its padding to the final
    round completes rank 1's padded blocks and hears its flag. Also when
    the line runs in a sync group, whose lines leave the group as they
    end: the group pads with the lines of its last sweep."""
    twins.check_abort(pool, N, n_chunks=60, fail_at=58, group=group)


@pytest.mark.parametrize("where", ["sink", "start", "stop"])
def test_a_rank_that_fails_or_stops_alone_ends_every_rank(pool, where):
    """Rank 1's sink raises at its block 2, or a processor's start hook
    raises there, or rank 1 alone is stopped once it dispatched 20 blocks:
    rank 1 pads to the next round and flags it, and rank 0 raises
    ``RunError`` from ``PeerAbortError`` there, in under 15 s. A stopped
    rank itself reports no error."""
    if where != "stop":
        twins.check_abort(pool, N, fail_at=2, where=where)
        return
    res = twins.run(pool, "abort_job", (1, N), n_chunks=96, fail_rank=1,
                    fail_at=20, where="stop")
    assert res[1]["error"] is None and res[1]["wait_s"] < twins.ABORT_S
    assert res[0]["error"][0] == "RunError"
    assert res[0]["error"][2] == "PeerAbortError"
    assert res[0]["wait_s"] < twins.ABORT_S

"""The port's health rounds (``pipe_tpu_torch.parallel.hostsync``) against the
JAX package's (``pipe_tpu.parallel.hostsync``).

``HostSync`` is held to the JAX class on seeded sequences of dispatch
frontiers and of per-rank ``(flag, pending)`` rows: ``next_round``, ``due``,
``pad_target``, the returned minimum and every ``PeerAbortError`` must agree
exactly. The JAX side's ``process_allgather`` is replaced in this test by a
function that returns the seeded rows (the JAX package is not changed); the
port's side gets the same rows from a stand-in for the mesh's
``health_allgather``. Then real rounds over a gloo group of four ranks (a
pool of ``tests/torch_mesh_worker.py``, every job with its own time limit):
the exchange, the group it runs on, and the number of rounds a stream makes
under ``host_sync_every``, exactly as the protocol's arithmetic predicts.
"""

import numpy as np
import pytest

import pipe_tpu_torch
from pipe_tpu.parallel import hostsync as jhostsync
from pipe_tpu_torch import mock, parallel
from pipe_tpu_torch.parallel import hostsync
from tests.torch_mesh_worker import Pool

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

JOB_LIMIT = 60.0  # seconds a job may take before the pool is killed
JOBS = "tests.torch_hostsync_jobs:"


@pytest.fixture(scope="module")
def pool():
    p = Pool(world=4)
    yield p
    p.close()


class _Rows:
    """The rows of the next round, as both packages' exchange returns them."""

    def __init__(self):
        self.table = None

    def health_allgather(self, row):  # the port's mesh method
        assert self.table[self.rank].tolist() == list(row)
        return self.table.copy()

    def process_allgather(self, row):  # jax.experimental.multihost_utils
        assert self.table[self.rank].tolist() == list(row)
        return self.table.copy()


def _outcome(fn):
    """``("ok", value)``, or the exception's type name (the two packages
    word their messages apart: "host" against "rank")."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, None)


@pytest.mark.parametrize("seed", range(8))
def test_hostsync_agrees_with_jax(monkeypatch, seed):
    """The same frontiers and rows through both classes: every query and
    every round gives the same answer, every ``PeerAbortError`` included."""
    from jax.experimental import multihost_utils

    r = np.random.default_rng(seed)
    rows = _Rows()
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        rows.process_allgather)
    every = int(r.integers(0, 9))  # 0: both clamp to 1
    n = int(r.integers(2, 6))
    rows.rank = int(r.integers(0, n))
    port, ref = hostsync.HostSync(rows, every), jhostsync.HostSync(every)
    assert port.every == ref.every
    frontier, aborts = 0, 0
    for _ in range(60):
        frontier += int(r.integers(0, 2 * port.every + 1))
        assert port.next_round == ref.next_round
        assert port.due(frontier) == ref.due(frontier)
        assert port.pad_target(frontier) == ref.pad_target(frontier)
        if r.random() < 0.5:
            flags = (r.random(n) < 0.15).astype(np.int32)
            rows.table = np.stack([flags, r.integers(0, 4, n)], 1).astype(np.int32)
            me = rows.table[rows.rank]
            got = _outcome(lambda: port.check(int(me[0]), int(me[1])))
            want = _outcome(lambda: ref.check(int(me[0]), int(me[1])))
            assert got == want, (got, want, rows.table.tolist())
            aborts += got[0] == "PeerAbortError"
            if got[0] == "ok":
                assert got[1] == int(rows.table[:, 1].min())
    assert port.next_round == ref.next_round
    assert issubclass(hostsync.PeerAbortError, RuntimeError)
    assert aborts > 0 or seed % 2  # most seeds see a peer's flag


def test_a_rank_that_flags_itself_is_not_aborted(monkeypatch):
    """Only another rank's flag raises: the flagging rank's own round
    returns (it is leaving anyway), in both packages."""
    from jax.experimental import multihost_utils

    rows = _Rows()
    rows.rank, rows.table = 1, np.asarray([[0, 2], [1, 0], [0, 1]], np.int32)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        rows.process_allgather)
    assert hostsync.HostSync(rows, 4).check(1, 0) == 0
    assert jhostsync.HostSync(4).check(1, 0) == 0
    rows.rank = 0
    with pytest.raises(hostsync.PeerAbortError):
        hostsync.HostSync(rows, 4).check(0, 2)
    with pytest.raises(jhostsync.PeerAbortError):
        jhostsync.HostSync(4).check(0, 2)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_a_real_round_over_a_gloo_group_of_the_mesh(pool, mesh):
    """Four ranks exchange their rows over the mesh's own gloo group: every
    rank gets every row in rank order, a flag raises on the other ranks
    only, and each exchange is counted as ``health`` (never as a data
    collective)."""
    rows = [[0, 3], [0, 1], [0, 2], [0, 5]]
    res = pool.run(JOBS + "health_round_job", timeout=JOB_LIMIT, mesh=mesh,
                   rows=rows)
    for r in res:
        np.testing.assert_array_equal(r["rows"], rows)
        assert r["check"] == ("ok", 1)
        assert r["next_round"] == 8
        assert r["stats"] == {"health": [2, 2 * 4 * 2 * 4]}
        assert r["backend"] == "gloo"
    rows[2][0] = 1
    res = pool.run(JOBS + "health_round_job", timeout=JOB_LIMIT, mesh=mesh,
                   rows=rows)
    for rank, r in enumerate(res):
        if rank == 2:
            assert r["check"] == ("ok", 1)
        else:
            assert r["check"][0] == "PeerAbortError"


def _predicted(n_blocks, every):
    """Rounds a stream of ``n_blocks`` makes, and its last frontier: one
    at every multiple of ``every`` it dispatches, then the stream pads to
    the next round and joins it once more."""
    rounds = n_blocks // every
    last = rounds * every + every if n_blocks % every == 0 else -(-n_blocks // every) * every
    return rounds + 1, last


@pytest.mark.parametrize("every, n_blocks", [(1, 12), (4, 12), (5, 12),
                                             (16, 12)])
def test_rounds_are_paced_by_host_sync_every(pool, every, n_blocks):
    """``host_sync_every`` sets the rounds: the count and the frontier the
    stream ends at are the protocol's arithmetic, exactly, on every rank,
    and the output is the same whatever the period."""
    res = pool.run(JOBS + "stream_job", timeout=JOB_LIMIT, mesh=(1, 4),
                   n_chunks=n_blocks, every=every)
    rounds, last = _predicted(n_blocks, every)
    plain = pool.run(JOBS + "stream_job", timeout=JOB_LIMIT, mesh=(1, 4),
                     n_chunks=n_blocks, every=1)[0]["out"]
    for r in res:
        assert r["error"] is None
        assert r["health"][0] == rounds, (r["health"], rounds)
        assert r["blocks"] == last
        np.testing.assert_array_equal(r["out"], plain)


def test_a_one_by_one_mesh_takes_no_rounds():
    """A 1x1 mesh has no process group and no health group, and its pipe
    makes no round, whatever ``host_sync_every`` says."""
    m = parallel.make_mesh(1, 1)
    assert m._health is None
    m.reset_stats()
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(256, pipe_tpu_torch.Line(
        source=mock.Source(channels=2, value=1.0, limit=8 * 256).source(),
        sink=sink.sink()), mesh=m, host_sync_every=1)
    p.start()
    p.wait(60)
    assert "health" not in m.stats
    assert p.block_index() == 8 and sink.values.shape == (2, 8 * 256)

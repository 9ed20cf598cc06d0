"""The scenarios of ``tests/test_distributed.py`` for the port, as checks
that take a rank pool and a rank count: ``tests/test_torch_distributed.py``
runs them on 2 ranks and ``tests/test_torch_distributed_four.py`` on 4.

The JAX tests start N processes of two virtual devices each
(``tests/dcn_stream_worker.py``) on a 1 x 2N mesh; here a process is one
shard, so N ranks stream on a 1 x N mesh (the mixer's on 2 x N/2), and the
cross-process edges are the same ones: the FIR halo and the output gather
cross a process boundary every block, and the health rounds run between
processes. What shrank, for every scenario: the streams are 40 to 160
blocks instead of 400 to 1000, enough to cross at least 3 health rounds
(every 16 dispatches, 8 for the width-changing insert). Pushes that the
JAX workers make right after ``start`` with hundreds of blocks of headroom
are delivered here behind a gate in the feed, so the short streams cannot
outrun them. Every check compares the ranks' outputs bit for bit and holds
them to the float64 oracle at the original bar (> 100 dB), and every
failing scenario ends every rank with the original's message well inside
15 s, with the group timeout left at 60 s.
"""

import numpy as np
import scipy.signal

from pipe_tpu_torch.ops.resample import polyphase_design
from pipe_tpu_torch.signal import snr_db
from tests.torch_hostsync_jobs import CHUNK, lowpass, stream_data

JOB_LIMIT = 90.0
JOBS = "tests.torch_hostsync_jobs:"
ABORT_S = 15.0  # every rank of a failing run ends within this


def run(pool, job, mesh, same=True, **kw):
    """The mesh's ranks' results; with ``same`` their outputs are equal bit
    for bit (a run that aborts ends each rank at its own block)."""
    res = [r for r in pool.run(JOBS + job, timeout=JOB_LIMIT, mesh=mesh, **kw)
           if r is not None]
    assert len(res) == mesh[0] * mesh[1]
    for i, r in enumerate(res[1:] if same else [], 1):
        if "out" in r and r["out"] is not None:
            a, b = res[0]["out"], r["out"]
            for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
                np.testing.assert_array_equal(x, y, err_msg=f"rank {i}")
    return res


def _switch_oracle(data, switch):
    h1 = lowpass()
    x64 = data.astype(np.float64)
    y1 = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
    y2 = scipy.signal.lfilter(h1 * 0.5, [1.0], x64, axis=1)
    s = switch * CHUNK
    return np.concatenate([y1[:, :s], y2[:, s:]], axis=1)


def check_stream(pool, n):
    """``stream``: the FIR halo crosses every rank boundary each block, a
    targeted retune lands on the same sample everywhere, > 100 dB."""
    N = 96
    for r in run(pool, "stream_job", (1, n), n_chunks=N, switch=N // 2):
        assert r["error"] is None, r["error"]
        oracle = _switch_oracle(stream_data(N), N // 2)
        assert r["out"].shape == oracle.shape
        assert snr_db(oracle, r["out"]) > 100
        assert r["health"][0] == N // 16 + 1  # the rounds, and the last one


def check_stream_chunky(pool, n):
    """``stream_chunky``: random-length reads (the same seeded lengths on
    every rank) re-chunked into full blocks, a targeted retune, a partial
    final block, > 100 dB."""
    N, TAIL = 80, 333
    res = run(pool, "stream_job", (1, n), n_chunks=N, switch=N // 2,
              chunky=78, tail=TAIL, seed=77)
    oracle = _switch_oracle(stream_data(N, 77, tail=TAIL), N // 2)
    for r in res:
        assert r["error"] is None, r["error"]
        assert r["out"].shape == oracle.shape
        assert snr_db(oracle, r["out"]) > 100


def check_stream_batched(pool, n):
    """``stream_batched``: batch_blocks=8 with a targeted retune and a
    targeted insert splitting batches at the same block on every rank."""
    N, SWITCH, SPLICE = 96, 48, 70
    res = run(pool, "stream_job", (1, n), n_chunks=N, switch=SWITCH,
              splice=SPLICE, batch_blocks=8)
    oracle = _switch_oracle(stream_data(N), SWITCH)
    oracle[:, SPLICE * CHUNK:] *= np.float64(np.float32(0.5))
    for r in res:
        assert r["error"] is None, r["error"]
        assert r["handle"] == (True, "None")
        assert snr_db(oracle, r["out"]) > 100


def check_untargeted(pool, n, stagger):
    """``stream_untargeted``: every rank pushes the same retune without
    ``at_block`` (``stagger * rank`` seconds apart): it lands on the same
    round-aligned block everywhere, > 100 dB, and the output equals a
    targeted push at that block bit for bit."""
    N = 96
    res = run(pool, "untargeted_job", (1, n), n_chunks=N, stagger=stagger)
    plain = run(pool, "stream_job", (1, n), n_chunks=N)[0]["out"]
    out = res[0]["out"]
    for r in res:
        assert r["error"] is None, r["error"]
    changed = np.flatnonzero(np.any(out != plain, axis=0))
    assert changed.size and changed[0] % CHUNK == 0
    landed = int(changed[0] // CHUNK)
    assert landed % 16 == 0 and 32 < landed < N, landed
    assert snr_db(_switch_oracle(stream_data(N), landed), out) > 100
    targeted = run(pool, "stream_job", (1, n), n_chunks=N, switch=landed)
    np.testing.assert_array_equal(targeted[0]["out"], out)
    return landed


def _assert_aborted(res, failing, what, peers="peer"):
    for rank, r in enumerate(res):
        assert r["error"] is not None, rank
        assert r["wait_s"] < ABORT_S, (rank, r["wait_s"])
        if rank in failing:
            assert what in r["error"][1].lower(), r["error"]
        else:
            assert r["error"][0] == "RunError", r["error"]
            assert r["error"][2] == "PeerAbortError", r["error"]
            assert peers in r["error"][1].lower(), r["error"]


def check_untargeted_stale(pool, n):
    """``untargeted_stale``: rank 0 pushes a batch its peers never match;
    nothing is delivered, rank 0 fails loudly after the stale budget (4
    rounds here) and its flag aborts every peer."""
    res = run(pool, "untargeted_job", (1, n), same=False, n_chunks=160,
              pushers=[0], stale_rounds=4)
    _assert_aborted(res, [0], "without a matching push")


def check_untargeted_eof(pool, n):
    """``untargeted_eof``: rank 0 pushes after the last round of a 40-block
    stream: the end-of-stream audit fails it loudly, saying that the batch
    may not have reached an agreement round and what to do, and its flag
    aborts the peers."""
    res = run(pool, "untargeted_job", (1, n), same=False, n_chunks=40,
              pushers=[0], push_after=33, hold_at=35)
    _assert_aborted(res, [0], "pending at end of stream")
    msg = res[0]["error"][1]
    assert "may not have reached an agreement round" in msg
    assert "push it earlier" in msg and "at_block=" in msg


def check_abort(pool, n, batch_blocks=1, n_chunks=96, fail_at=40,
                where="feed", group=False):
    """``abort``, ``abort_batched`` and ``abort_late``: rank 1 fails; its
    exit padding completes the peers' blocks in flight, and every peer
    raises ``RunError`` from ``PeerAbortError`` at the round."""
    res = run(pool, "abort_job", (1, n), n_chunks=n_chunks, fail_rank=1,
              fail_at=fail_at, batch_blocks=batch_blocks, where=where,
              group=group)
    _assert_aborted(res, [1], {"feed": "injected failure",
                               "start": "start failed",
                               "sink": "sink failed"}[where])
    return res


def check_ols_delay(pool, n):
    """``ols_delay``: the bin-sharded OLS (both transposes), the feedback
    delay and the dual-halo STFT across every rank boundary, > 100 dB."""
    N = 64
    for r in run(pool, "ols_delay_job", (1, n), n_chunks=N):
        assert r["error"] is None, r["error"]
        rng2 = np.random.default_rng(13)
        ir = rng2.standard_normal(300) * np.exp(-np.arange(300) / 60.0)
        x64 = rng2.standard_normal((2, CHUNK * N)).astype(np.float32).astype(
            np.float64)
        conv = scipy.signal.fftconvolve(x64, ir[None, :], axes=1)[:, :x64.shape[1]]
        a = np.zeros(101)
        a[0], a[100] = 1.0, -0.4
        s = scipy.signal.lfilter([1.0], a, conv, axis=1)
        oracle = conv + 0.3 * np.concatenate([np.zeros((2, 100)), s[:, :-100]], 1)
        oracle = np.concatenate([np.zeros((2, 48)), oracle[:, :-48]], axis=1)
        assert r["out"].shape == x64.shape
        assert snr_db(oracle, r["out"]) > 100


def check_mix_psum(pool, n):
    """``mix_psum``: the channel axis spans the ranks, so the merged mixer's
    reduction crosses between processes every block, > 100 dB."""
    N = 64
    for r in run(pool, "mix_psum_job", (2, n // 2), n_chunks=N):
        assert r["error"] is None, r["error"]
        rng4 = np.random.default_rng(17)
        d4 = rng4.standard_normal((4, CHUNK * N)).astype(np.float32)
        mixm = rng4.standard_normal((2, 4)).astype(np.float32)
        oracle = mixm.astype(np.float64) @ scipy.signal.lfilter(
            lowpass(), [1.0], d4.astype(np.float64), axis=1)
        assert r["out"].shape == oracle.shape
        assert snr_db(oracle, r["out"]) > 100


def check_late_target(pool, n):
    """``late_target``: a target the stream never reaches fails every rank
    (undelivered, or a peer's abort)."""
    for r in run(pool, "late_target_job", (1, n), n_chunks=40, target=10_000):
        assert r["error"] is not None and r["wait_s"] < ABORT_S
        msg = r["error"][1].lower()
        assert "undelivered" in msg or "peer" in msg, r["error"]


def check_multiline(pool, n):
    """``multiline``: two lines in one sync group, line A ending at half the
    stream (on the same dispatch everywhere), a gain inserted into line A at
    a target on every rank; both lines > 100 dB against their oracles."""
    N, SPLICE = 96, 36
    h1 = lowpass()
    for r in run(pool, "multiline_job", (1, n), n_chunks=N, splice=SPLICE):
        assert r["error"] is None, r["error"]
        assert r["handle"] == (True, "None")
        da, db = stream_data(N // 2, 7), stream_data(N, 8)
        o1 = scipy.signal.lfilter(h1, [1.0], da.astype(np.float64), axis=1)
        o1[:, SPLICE * CHUNK:] *= np.float64(np.float32(0.5))
        o2 = scipy.signal.lfilter(h1 * 0.5, [1.0], db.astype(np.float64), axis=1)
        a, b = r["out"]
        assert a.shape == da.shape and b.shape == db.shape
        assert snr_db(o1, a) > 100 and snr_db(o2, b) > 100


def check_ckpt(pool, n):
    """``ckpt``: a snapshot of FIR -> bin-sharded OLS -> Biquad after the
    first half, restored into a fresh mesh pipe: the resumed stream holds
    100 dB against the uninterrupted oracle."""
    from pipe_tpu_torch import ops

    N = 64
    sos = ops.design_peaking_eq(44100, freq=600, q=1.5, gain_db=3.0)
    rng3 = np.random.default_rng(9)
    ir = rng3.standard_normal(300) * np.exp(-np.arange(300) / 60.0)
    d = rng3.standard_normal((2, CHUNK * N)).astype(np.float32)
    fx = scipy.signal.lfilter(lowpass(), [1.0], d.astype(np.float64), axis=1)
    cx = scipy.signal.fftconvolve(fx, ir[None, :], axes=1)[:, :d.shape[1]]
    oracle = scipy.signal.sosfilt(sos[None, :], cx, axis=1)
    for r in run(pool, "ckpt_job", (1, n), n_chunks=N):
        assert r["error"] is None, r["error"]
        assert r["out"].shape == d.shape
        assert snr_db(oracle, r["out"]) > 100


def check_width_insert(pool, n):
    """``width_insert``: a resampler inserted at block 4 on every rank; the
    downstream FIR is re-allocated at the new width with its halo carried,
    > 100 dB against the float64 oracle."""
    BLOCK, N, AT = 1176, 24, 4
    data = stream_data(N, 23, block=BLOCK)
    cut = AT * BLOCK
    hp64 = polyphase_design(160, 147, 32)
    K = hp64.shape[1]
    tail = data.astype(np.float64)[:, cut:]
    j = np.arange(-(-tail.shape[1] * 160 // 147))
    ph, n0 = (j * 147) % 160, (j * 147) // 160
    nidx = n0[:, None] - np.arange(K)[None, :]
    valid = (nidx >= 0) & (nidx < tail.shape[1])
    xg = np.where(valid[None], tail[:, np.clip(nidx, 0, tail.shape[1] - 1)], 0.0)
    s = np.concatenate([data.astype(np.float64)[:, :cut],
                        np.einsum("cok,ok->co", xg, hp64[ph])], axis=1)
    oracle = scipy.signal.lfilter(lowpass(), [1.0], s, axis=1)
    for r in run(pool, "width_insert_job", (1, n), n_chunks=N, at=AT,
                 block=BLOCK, every=8):
        assert r["error"] is None, r["error"]
        assert r["handle"][:2] == (True, None)
        assert r["out"].shape == oracle.shape
        assert snr_db(oracle, r["out"]) > 100


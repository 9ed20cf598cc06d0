"""The port's mock kit — twins of ``tests/test_mock.py``: drive the mock
step functions directly, without a pipe, with the reference's buffer-count
oracles (``mock/mock_test.go:19-210``), and check that the Source's
counters, frame counts and EOF are host values (no device sync per
block)."""

import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu import mock as jmock
from pipe_tpu import mutable as jmutable
from pipe_tpu_torch import mock, mutable
from pipe_tpu_torch.signal import Signal, SignalProperties

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU


def drive_source(src: mock.Source, block_size: int, max_steps=10_000):
    """Run the source step until EOF; returns the per-block frame counts."""
    comp = src.source()(mutable.mutable(), block_size)
    frames = []
    for _ in range(max_steps):
        state, sig, eof = comp.step(comp.state, comp.params)
        assert isinstance(eof, bool) and isinstance(sig.frames, int)
        if eof:
            return frames, comp
        comp.state = state
        frames.append(sig.frames)
    raise AssertionError("source never EOF'd")


@pytest.mark.parametrize(
    "limit,block,expected_calls,expected_frames",
    [
        (11, 5, 3, [5, 5, 1]),  # mock_test.go:71-83
        (2500, 5, 500, [5] * 500),  # mock_test.go:84-95
        (10, 5, 2, [5, 5]),
        (0, 5, 0, []),
    ],
)
def test_source_buffer_count_math(limit, block, expected_calls, expected_frames):
    src = mock.Source(value=1.0, channels=2, limit=limit)
    frames, comp = drive_source(src, block)
    assert len(frames) == expected_calls
    assert frames == expected_frames
    assert src.messages == expected_calls
    assert src.samples == limit


def test_source_counts_match_jax():
    """The same limit and block through both kits: equal frame sequences
    and counters."""
    import jax

    jsrc = jmock.Source(value=1.0, channels=2, limit=23)
    jcomp = jsrc.source()(jmutable.mutable(), 5)
    step = jax.jit(jcomp.step)
    jframes = []
    while True:
        state, sig, eof = step(jcomp.state, jcomp.params)
        if bool(eof):
            break
        jcomp.state = state
        jframes.append(int(sig.frames))
    frames, _ = drive_source(mock.Source(value=1.0, channels=2, limit=23), 5)
    assert frames == jframes == [5, 5, 5, 5, 3]


def test_source_value_injection():
    src = mock.Source(value=0.75, channels=2, limit=4)
    comp = src.source()(mutable.mutable(), 4)
    state, sig, eof = comp.step(comp.state, comp.params)
    assert not eof
    assert sig.data.dtype == torch.float32 and sig.data.is_contiguous()
    np.testing.assert_allclose(sig.data.numpy(), 0.75)


def test_source_unlimited_never_eofs():
    src = mock.Source(value=1.0, channels=1)
    comp = src.source()(mutable.mutable(), 8)
    for _ in range(5):
        comp.state, sig, eof = comp.step(comp.state, comp.params)
        assert not eof
        assert sig.frames == 8
    assert src.samples == 40


def test_processor_passthrough_and_counts():
    """mock_test.go:103-157: pass-through counting frames."""
    proc = mock.Processor()
    comp = proc.processor()(mutable.mutable(), 4,
                            SignalProperties(sample_rate=44100, channels=2))
    x = Signal(torch.arange(8, dtype=torch.float32).reshape(2, 4), 4)
    comp.state, out = comp.step(comp.state, comp.params, x)
    assert torch.equal(out.data, x.data)
    comp.state, out = comp.step(comp.state, comp.params, out.with_frames(3))
    assert proc.messages == 2
    assert proc.samples == 7


def test_sink_capture():
    """mock_test.go:159-198: capture-or-discard."""
    snk = mock.Sink()
    comp = snk.sink()(mutable.mutable(), 4,
                      SignalProperties(sample_rate=44100, channels=2))
    comp.receive(np.ones((2, 4), np.float32))
    comp.receive(np.full((2, 2), 2.0, np.float32))
    assert snk.messages == 2
    assert snk.samples == 6
    np.testing.assert_array_equal(
        snk.values,
        np.concatenate([np.ones((2, 4)), np.full((2, 2), 2.0)], axis=1))


def test_sink_discard():
    snk = mock.Sink(discard=True)
    comp = snk.sink()(mutable.mutable(), 4,
                      SignalProperties(sample_rate=44100, channels=1))
    comp.receive(np.ones((1, 4), np.float32))
    assert snk.messages == 1
    assert snk.values.size == 0


@pytest.mark.parametrize("kind", ["source", "processor", "sink"])
def test_error_injection_on_make(kind):
    boom = RuntimeError("make failed")
    ctx = mutable.mutable()
    props = SignalProperties(sample_rate=44100, channels=1)
    with pytest.raises(RuntimeError, match="make failed"):
        if kind == "source":
            mock.Source(value=1.0, limit=4, error_on_make=boom).source()(ctx, 4)
        elif kind == "processor":
            mock.Processor(error_on_make=boom).processor()(ctx, 4, props)
        else:
            mock.Sink(error_on_make=boom).sink()(ctx, 4, props)


def test_error_injection_on_call_sink():
    snk = mock.Sink(error_on_call=RuntimeError("call failed"))
    comp = snk.sink()(mutable.mutable(), 4,
                      SignalProperties(sample_rate=44100, channels=1))
    with pytest.raises(RuntimeError):
        comp.receive(np.ones((1, 4), np.float32))


def test_error_injection_on_call_runs_before_the_block():
    """``error_on_call`` on a source or processor fires from ``host_pre``,
    on the executor thread before each block."""
    boom = RuntimeError("call failed")
    src = mock.Source(limit=4, error_on_call=boom).source()(mutable.mutable(), 4)
    proc = mock.Processor(error_on_call=boom).processor()(
        mutable.mutable(), 4, SignalProperties(44100.0, 1))
    for comp in (src, proc):
        with pytest.raises(RuntimeError, match="call failed"):
            comp.host_pre()


def test_hooks_spies():
    """mock_test.go:200-210."""
    src = mock.Source(value=1.0, limit=4)
    comp = src.source()(mutable.mutable(), 4)
    assert not src.started and not src.flushed
    comp.start()
    assert src.started
    comp.flush()
    assert src.flushed


def test_hook_error_injection():
    src = mock.Source(value=1.0, limit=4,
                      error_on_start=RuntimeError("start failed"),
                      error_on_flush=RuntimeError("flush failed"))
    comp = src.source()(mutable.mutable(), 4)
    with pytest.raises(RuntimeError, match="start failed"):
        comp.start()
    assert src.started  # the spy flips before raising, like the reference
    with pytest.raises(RuntimeError, match="flush failed"):
        comp.flush()
    assert src.flushed


def test_source_reset_mutation():
    src = mock.Source(value=1.0, channels=1, limit=8)
    drive_source(src, 4)
    assert src.samples == 8
    src.reset().apply()
    assert src.samples == 0
    assert src.messages == 0


def test_source_set_value_mutation():
    src = mock.Source(value=1.0, channels=1, limit=8)
    comp = src.source()(mutable.mutable(), 4)
    src.set_value(3.0).apply()
    _, sig, _ = comp.step(comp.state, comp.params)
    np.testing.assert_array_equal(sig.data.numpy(), 3.0)


def test_mock_mutation_spy():
    src = mock.Source(value=1.0, limit=4)
    src.source()(mutable.mutable(), 4)
    assert not src.mutated
    src.mock_mutation().apply()
    assert src.mutated

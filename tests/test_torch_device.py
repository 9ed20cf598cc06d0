"""Where the port's entry points run when they are given no ``device``: on
the card, and never on the CPU unless the caller asked for it. ``run``,
``Pipe``, ``process`` and ``make_flagship`` raise where there is no card and
no default was set, and run on the CPU after ``set_default_device("cpu")``
or with ``device="cpu"``."""

import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu_torch import config, mock, ops
from pipe_tpu_torch.flagship import make_flagship

BLOCK = 256


def _line(sink):
    return pipe_tpu_torch.Line(
        source=mock.Source(value=1.0, channels=2, limit=3 * BLOCK).source(),
        processors=[ops.Gain(0.5).processor()],
        sink=sink.sink())


def _run():
    sink = mock.Sink()
    pipe_tpu_torch.run(BLOCK, _line(sink))
    return sink.values


def _pipe():
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, _line(sink))
    p.start()
    p.wait(60)
    return sink.values


def _process():
    return pipe_tpu_torch.process(np.ones((2, 3 * BLOCK), np.float32),
                                  [ops.Gain(0.5).processor()], block_size=BLOCK)


def _flagship():
    fn, state, x = make_flagship(channels=2, chunk=147)
    return fn(state, x)[1].cpu().numpy()


ENTRY_POINTS = {"run": _run, "Pipe": _pipe, "process": _process,
                "make_flagship": _flagship}


@pytest.fixture
def no_card(monkeypatch):
    """No card, and no default device set."""
    monkeypatch.setattr(config, "_default_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_without_device_raises_without_a_card(no_card, name):
    with pytest.raises(RuntimeError, match=r'set_default_device\("cpu"\)'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_the_cpu_when_asked(no_card, name):
    pipe_tpu_torch.set_default_device("cpu")
    assert pipe_tpu_torch.default_device() == torch.device("cpu")
    y = ENTRY_POINTS[name]()
    assert np.isfinite(y).all() and y.shape[0] == 2
    if name != "make_flagship":
        np.testing.assert_array_equal(y, np.full((2, 3 * BLOCK), 0.5, np.float32))


def test_device_argument_wins_over_the_default(no_card):
    """An explicit ``device`` never consults the default."""
    sink = mock.Sink()
    pipe_tpu_torch.run(BLOCK, _line(sink), device="cpu")
    assert sink.values.shape == (2, 3 * BLOCK)
    y = pipe_tpu_torch.process(np.ones((1, BLOCK), np.float32), [],
                               block_size=BLOCK, device="cpu")
    assert y.shape == (1, BLOCK)
    fn, state, x = make_flagship(channels=2, chunk=147, device="cpu")
    assert x.device.type == "cpu" and state[0].device.type == "cpu"


def test_source_device_wins_over_the_default(no_card):
    """A source that declares its device places the line without a default."""
    sink = mock.Sink()

    def source(mctx, block):
        src = mock.Source(value=1.0, channels=2, limit=BLOCK).source()(mctx, block)
        src.output = pipe_tpu_torch.SignalProperties(
            src.output.sample_rate, src.output.channels, torch.device("cpu"))
        return src

    line = pipe_tpu_torch.Line(source=source, processors=[], sink=sink.sink())
    pipe_tpu_torch.run(BLOCK, line)
    assert sink.values.shape == (2, BLOCK)


def test_set_default_device_none_clears_it(no_card):
    pipe_tpu_torch.set_default_device("cpu")
    pipe_tpu_torch.set_default_device(None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pipe_tpu_torch.default_device()


def test_default_is_the_current_card(monkeypatch):
    monkeypatch.setattr(config, "_default_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert pipe_tpu_torch.default_device() == torch.device("cuda", 0)

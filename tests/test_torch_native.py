"""The port's native runtime layer (``pipe_tpu_torch.native`` and
``pipe_tpu_torch.io``): twins of ``tests/test_native.py`` on the same seeded
inputs, plus files crossing between the two packages in both directions."""

import pathlib
import threading

import numpy as np
import pytest

import pipe_tpu.native as jnative
import pipe_tpu_torch
from pipe_tpu_torch import mock, native, ops
from pipe_tpu_torch.io import WavSink, WavSource
from pipe_tpu_torch.signal import snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU


def test_native_builds():
    """The C++ library must build in this environment (g++ is available),
    into ``build/pipe_tpu_torch/`` and nowhere else; the pure-Python
    fallback is for toolchain-less installs only."""
    assert native.available(), native.build_error()
    assert native.build_error() is None
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "pipe_tpu_torch")
    pkg = pathlib.Path(pipe_tpu_torch.__file__).parent
    assert not list(pkg.rglob("*.so")) and not list(native.SRC_DIR.glob("*.so"))


def test_ringbuf_push_pop_wrap():
    rb = native.RingBuffer(capacity_frames=16, channels=2)
    a = np.arange(24, dtype=np.float32).reshape(12, 2)
    assert rb.push(a) == 12
    assert len(rb) == 12
    got = rb.pop(8)
    np.testing.assert_array_equal(got, a[:8])
    # wrap-around: push 10 more into the freed space
    b = np.arange(100, 120, dtype=np.float32).reshape(10, 2)
    assert rb.push(b) == 10
    got2 = rb.pop(14)
    np.testing.assert_array_equal(got2, np.concatenate([a[8:], b], axis=0))
    assert len(rb) == 0


def test_ringbuf_backpressure_and_close():
    rb = native.RingBuffer(capacity_frames=4, channels=1)
    x = np.ones((6, 1), np.float32)
    assert rb.push(x) == 4  # only capacity accepted
    assert rb.push(x) == 0
    rb.close()
    assert rb.closed
    assert rb.pop(10).shape[0] == 4


def test_ringbuf_threaded_stream():
    """Producer/consumer on separate threads move 100k frames intact."""
    rb = native.RingBuffer(capacity_frames=256, channels=2)
    n_total = 100_000
    data = np.random.default_rng(0).standard_normal((n_total, 2)).astype(np.float32)

    def produce():
        pos = 0
        while pos < n_total:
            pos += rb.push(data[pos : pos + 128])
        rb.close()

    out = []
    t = threading.Thread(target=produce)
    t.start()
    got = 0
    while got < n_total:
        chunk = rb.pop(128)
        if chunk.shape[0] == 0:
            if rb.closed and len(rb) == 0:
                break
            continue
        out.append(chunk)
        got += chunk.shape[0]
    t.join()
    result = np.concatenate(out, axis=0)
    np.testing.assert_array_equal(result, data)


@pytest.mark.parametrize("bits", [16, 32])
def test_wav_roundtrip(tmp_path, bits):
    path = tmp_path / "t.wav"
    rng = np.random.default_rng(1)
    frames = rng.uniform(-0.9, 0.9, size=(1000, 2)).astype(np.float32)
    w = native.WavWriter(str(path), channels=2, sample_rate=48000, bits=bits)
    w.write(frames[:400])
    w.write(frames[400:])
    w.close()

    r = native.WavReader(str(path))
    assert r.channels == 2
    assert r.sample_rate == 48000
    assert r.total_frames == 1000
    got = np.concatenate([r.read(256) for _ in range(5)], axis=0)
    r.close()
    assert got.shape == (1000, 2)
    tol = 1e-4 if bits == 16 else 1e-7
    assert np.max(np.abs(got - frames)) < tol


def test_wav_reader_rejects_garbage(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"this is not a wav file at all........")
    with pytest.raises(IOError):
        native.WavReader(str(p))


def test_wav_source_sink_pipeline(tmp_path):
    """File -> gain -> file through the streaming runtime; contents scale
    exactly, prefetch/writer threads start and flush cleanly."""
    src_path = tmp_path / "in.wav"
    dst_path = tmp_path / "out.wav"
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, size=(2, 4096)).astype(np.float32)
    w = native.WavWriter(str(src_path), channels=2, sample_rate=44100, bits=32)
    w.write(np.ascontiguousarray(x.T))
    w.close()

    src = WavSource(str(src_path))
    assert src.channels == 2 and src.total_frames == 4096
    dst = WavSink(str(dst_path), bits=32)
    g = ops.Gain(0.5)
    pipe_tpu_torch.run(
        512,
        pipe_tpu_torch.Line(
            source=src.source(), sink=dst.sink(), processors=[g.processor()]
        ),
    )
    r = native.WavReader(str(dst_path))
    got = r.read(5000)
    r.close()
    assert got.shape == (4096, 2)
    assert snr_db((0.5 * x).astype(np.float64), got.T) > 120


def test_wav_source_partial_final_block(tmp_path):
    """total_frames % block_size != 0 -> final partial message then EOF."""
    src_path = tmp_path / "p.wav"
    x = np.linspace(-0.5, 0.5, 1000, dtype=np.float32)[None, :]
    w = native.WavWriter(str(src_path), channels=1, sample_rate=8000, bits=32)
    w.write(np.ascontiguousarray(x.T))
    w.close()
    sink = mock.Sink()
    pipe_tpu_torch.run(
        256,
        pipe_tpu_torch.Line(source=WavSource(str(src_path)).source(), sink=sink.sink()),
    )
    assert sink.samples == 1000
    np.testing.assert_allclose(sink.values, x, atol=1e-7)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_py_wav_fallback_honors_bits(tmp_path, bits):
    """The toolchain-less Python writer must honor the requested bit depth
    (it used to clip everything to PCM16, silently losing 80+ dB)."""
    from pipe_tpu_torch.native import _PyWavReader, _PyWavWriter

    rng = np.random.default_rng(7)
    x = rng.uniform(-0.9, 0.9, (1000, 2)).astype(np.float32)
    path = tmp_path / f"py{bits}.wav"
    w = _PyWavWriter(str(path), channels=2, sample_rate=48000, bits=bits)
    w.write(x)
    w.close()
    r = _PyWavReader(str(path))
    got = r.read(2000)
    r.close()
    assert got.shape == x.shape
    floor = {16: 80, 24: 120, 32: 150}[bits]
    assert snr_db(x, got) > floor


def test_py_wav_fallback_rejects_bad_bits(tmp_path):
    from pipe_tpu_torch.native import _PyWavWriter

    with pytest.raises(ValueError):
        _PyWavWriter(str(tmp_path / "x.wav"), 1, 8000, bits=8)


def _write(writer_cls, path, frames, bits, step=400):
    w = writer_cls(str(path), frames.shape[1], 48000, bits)
    for i in range(0, frames.shape[0], step):
        w.write(frames[i:i + step])
    w.close()


def _read(reader_cls, path, n=256):
    r = reader_cls(str(path))
    meta = (r.channels, r.sample_rate, r.total_frames)
    parts = []
    while True:
        got = r.read(n)
        if got.shape[0] == 0:
            break
        parts.append(got)
    r.close()
    return meta, np.concatenate(parts, axis=0)


# (writer attribute, bits): the native writer knows PCM16 and float32, the
# pure-Python one PCM16, PCM24 and PCM32
FORMATS = [("WavWriter", 16), ("WavWriter", 32), ("_PyWavWriter", 16),
           ("_PyWavWriter", 24), ("_PyWavWriter", 32)]


@pytest.mark.parametrize("writer,bits", FORMATS)
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_wav_files_cross_packages_exactly(tmp_path, writer, bits, direction):
    """A file written by one package's writer decodes to the same float32
    samples through both packages' readers (exact), and both packages'
    writers produce the same bytes."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.9, 0.9, size=(1000, 3)).astype(np.float32)
    src, dst = ((jnative, native) if direction == "jax_to_torch"
                else (native, jnative))
    path = tmp_path / "a.wav"
    _write(getattr(src, writer), path, x, bits)
    meta_s, got_s = _read(src.WavReader, path)
    meta_d, got_d = _read(dst.WavReader, path)
    assert meta_s == meta_d == (3, 48000, 1000)
    np.testing.assert_array_equal(got_d, got_s)
    if writer == "WavWriter" and bits == 32:
        np.testing.assert_array_equal(got_d, x)  # float32 is lossless
    # the pure-Python reader of the other package agrees on PCM files
    if not (writer == "WavWriter" and bits == 32):
        _, got_py = _read(dst._PyWavReader, path)
        np.testing.assert_array_equal(got_py, got_s)
    # and back: the other package writes the decoded samples to the same bytes
    back = tmp_path / "b.wav"
    _write(getattr(dst, writer), back, x, bits)
    assert back.read_bytes() == path.read_bytes()


def test_ring_and_codecs_fall_back_without_a_toolchain(tmp_path, monkeypatch):
    """Where the build failed, the public classes run on the pure-Python
    equivalents and ``available()`` says so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "no toolchain")
    assert not native.available() and native.build_error() == "no toolchain"
    rb = native.RingBuffer(4, 1)
    assert rb.push(np.ones((6, 1), np.float32)) == 4 and len(rb) == 4
    rb.close()
    assert rb.closed and rb.pop(10).shape == (4, 1)
    x = np.linspace(-0.5, 0.5, 300, dtype=np.float32)[:, None]
    w = native.WavWriter(str(tmp_path / "f.wav"), 1, 8000, 16)
    assert w.write(x) == 300
    w.close()
    r = native.WavReader(str(tmp_path / "f.wav"))
    assert (r.channels, r.sample_rate, r.total_frames) == (1, 8000, 300)
    assert np.max(np.abs(r.read(400) - x)) < 1e-4
    r.close()


def test_wav_source_blocks_are_whole_until_the_file_ends(tmp_path):
    """``feed`` hands out whole blocks whatever the reader's lead, so block
    boundaries are deterministic; only the last block is short."""
    path = tmp_path / "w.wav"
    x = np.random.default_rng(3).uniform(-1, 1, (2500, 2)).astype(np.float32)
    _write(native.WavWriter, path, x, 32, step=2500)
    comp = WavSource(str(path), prefetch_blocks=2).source()(None, 256)
    comp.start()
    sizes, parts = [], []
    while (blk := comp.feed(256)) is not None:
        sizes.append(blk.shape[1])
        parts.append(blk)
    comp.flush()
    assert sizes == [256] * 9 + [2500 - 9 * 256]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), x.T)


def test_wav_source_flush_stops_a_reader_blocked_on_a_full_ring(tmp_path):
    """A cancelled run flushes while the prefetch thread waits on a full
    ring: the thread must end, not spin."""
    path = tmp_path / "long.wav"
    _write(native.WavWriter, path, np.zeros((20000, 1), np.float32), 32,
           step=20000)
    ws = WavSource(str(path), prefetch_blocks=2)
    comp = ws.source()(None, 128)
    comp.start()
    thread = ws._thread
    assert comp.feed(128).shape == (1, 128)
    comp.flush()
    assert not thread.is_alive()


def test_wav_sink_surfaces_a_dead_writer(tmp_path):
    """A writer thread that cannot create its file must not leave
    ``receive`` spinning on a ring nobody drains."""
    sink = WavSink(str(tmp_path / "no_such_dir" / "x.wav"))
    comp = sink.sink()(None, 64, pipe_tpu_torch.SignalProperties(8000.0, 1))
    comp.start()
    with pytest.raises(IOError):
        for _ in range(100):
            comp.receive(np.zeros((1, 64), np.float32))
    with pytest.raises(IOError):
        comp.flush()

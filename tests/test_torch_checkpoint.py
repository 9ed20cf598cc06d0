"""Checkpoints carry stream state between the JAX package and the port.

The slice's line (FIR -> 44.1k->48k resampler -> two-section biquad EQ ->
mix) at 8 channels, block 2352: a pipe of one package streams 3 blocks, is
snapshotted into an ``.npz``, and a pipe of the other package built from
the same lines restores it and continues the stream. The continuation
agrees with the first package's own continuation at >= 100 dB, in both
directions — which also pins the leaf order (dict keys sorted, as
``jax.tree.flatten`` gives: the biquad's ``s`` before ``x_tail``)."""

import numpy as np
import pytest
import torch

import pipe_tpu
import pipe_tpu.checkpoint
import pipe_tpu.ops
import pipe_tpu_torch
import pipe_tpu_torch.ops
from pipe_tpu_torch import checkpoint
from pipe_tpu_torch.signal import snr_db
from pipe_tpu_torch.tree import tree_flatten, tree_unflatten

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

C, BLOCK = 8, 2352
N = 7 * BLOCK + 500


def _slice_pipe(pkg, x, start, stop, out):
    """A Pipe of the slice's line fed ``x[:, start:stop]``; ``stop`` is a
    one-element list so a test can extend the stream before a restart."""
    ops = pkg.ops
    pos = [start]

    def feed(n):
        if pos[0] >= stop[0]:
            return None
        c = x[:, pos[0]: min(pos[0] + n, stop[0])]
        pos[0] += c.shape[1]
        return c

    line = pkg.Line(
        source=lambda m, b: pkg.Source(
            output=pkg.SignalProperties(sample_rate=44100.0, channels=C),
            feed=feed),
        processors=[
            ops.FIR(ops.design_lowpass(255, 4000, 44100)).processor(),
            ops.Resampler(48000, 44100).processor(),
            ops.Biquad(np.stack([ops.design_peaking_eq(48000, 1000, 1.0, 3.0),
                                 ops.design_highshelf(48000, 8000, -2.0)])
                       ).processor(),
            ops.ChannelMix(np.ones((2, C)) / C).processor(),
        ],
        sink=lambda m, b, p: pkg.Sink(receive=lambda a: out.append(np.array(a))),
    )
    return pkg.Pipe(BLOCK, line)


def _handover(first, second, ckpt_mod_first, ckpt_mod_second, tmp_path):
    """``first`` streams 3 blocks and is snapshotted; it continues on its
    own, and ``second`` continues from the restored snapshot."""
    x = np.random.default_rng(50).standard_normal((C, N)).astype(np.float32)
    out_a = []
    stop = [3 * BLOCK]
    pa = _slice_pipe(first, x, 0, stop, out_a)
    pa.start()
    pa.wait(120)
    path = tmp_path / "stream.ckpt.npz"
    ckpt_mod_first.snapshot(pa).save(str(path))
    n_head = len(out_a)
    stop[0] = N
    pa.start()
    pa.wait(120)
    ref = np.concatenate(out_a[n_head:], 1)

    out_b = []
    pb = _slice_pipe(second, x, 3 * BLOCK, [N], out_b)
    ckpt_mod_second.restore(pb, ckpt_mod_second.load(str(path)))
    pb.start()
    pb.wait(120)
    got = np.concatenate(out_b, 1)
    assert got.shape == ref.shape == (2, -(-N * 160 // 147) - 3 * 2560)
    return ref, got


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    ref, got = _handover(pipe_tpu, pipe_tpu_torch, pipe_tpu.checkpoint,
                         checkpoint, tmp_path)
    assert snr_db(ref, got) >= 100


def test_port_checkpoint_continues_in_jax(tmp_path):
    ref, got = _handover(pipe_tpu_torch, pipe_tpu, checkpoint,
                         pipe_tpu.checkpoint, tmp_path)
    assert snr_db(ref, got) >= 100


def test_port_round_trip_is_exact(tmp_path):
    ref, got = _handover(pipe_tpu_torch, pipe_tpu_torch, checkpoint,
                         checkpoint, tmp_path)
    np.testing.assert_array_equal(got, ref)


def test_keys_and_leaf_order_match_jax():
    """Same keys, same leaf shapes and dtypes in the same order: the
    resampler's host-int ``off`` is stored as 0-d int32, the JAX dtype."""
    x = np.zeros((C, BLOCK), np.float32)
    jp = _slice_pipe(pipe_tpu, x, 0, [0], [])
    tp = _slice_pipe(pipe_tpu_torch, x, 0, [0], [])
    jl = pipe_tpu.checkpoint.snapshot(jp).leaves
    tl = checkpoint.snapshot(tp).leaves
    assert list(jl) == list(tl)
    for k in jl:
        assert tl[k].shape == jl[k].shape and tl[k].dtype == jl[k].dtype, k
    assert isinstance(tp.routes[0].processors[1].state["off"], int)
    assert tl["r0/c2/state/1"].dtype == np.int32  # resampler: hist, off


KIT_BLOCK = 512
KIT_N = 9 * KIT_BLOCK + 300
KIT_IR = (np.random.default_rng(8).standard_normal(1500)
          * np.exp(-np.arange(1500) / 200.0))


def _kit_pipe(pkg, x, start, stop, out):
    """A Pipe of OLSConvolve -> Delay (ring, feedback) -> Compressor ->
    SpectralGain, 2 channels, fed ``x[:, start:stop[0]]``."""
    ops = pkg.ops
    pos = [start]

    def feed(n):
        if pos[0] >= stop[0]:
            return None
        c = x[:, pos[0]: min(pos[0] + n, stop[0])]
        pos[0] += c.shape[1]
        return c

    gains = np.linspace(1.0, 0.5, 129)
    line = pkg.Line(
        source=lambda m, b: pkg.Source(
            output=pkg.SignalProperties(sample_rate=44100.0, channels=2),
            feed=feed),
        processors=[
            ops.OLSConvolve(KIT_IR).processor(),
            ops.Delay(700, feedback=0.4, wet=0.6, dry=0.8).processor(),
            ops.Compressor(-12.0, 3.0, attack_ms=5.0, release_ms=60.0).processor(),
            ops.SpectralGain(256, 64, gains).processor(),
        ],
        sink=lambda m, b, p: pkg.Sink(receive=lambda a: out.append(np.array(a))),
    )
    return pkg.Pipe(KIT_BLOCK, line)


def _int_leaves(pipe, ckpt_mod):
    return {k: v for k, v in ckpt_mod.snapshot(pipe).leaves.items()
            if np.issubdtype(v.dtype, np.integer)}


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_op_kit_checkpoint_crosses_packages(tmp_path, direction):
    """The new ops' state (OLS ``prev/fdl/pos``, the Delay ring and its
    ``pos``, the envelope and its dd low word, spectral ``hist/nres/tail``)
    saved mid-stream, after a partial block, by one package continues in
    the other: >= 100 dB against the first package's unbroken run, and the
    integer state at the end equal."""
    pkgs = {"jax": (pipe_tpu, pipe_tpu.checkpoint),
            "port": (pipe_tpu_torch, checkpoint)}
    first, second = (pkgs[k] for k in direction.split("-to-"))
    x = np.random.default_rng(51).standard_normal((2, KIT_N)).astype(np.float32)
    cut = 4 * KIT_BLOCK + 200  # a partial block before the snapshot
    out_a, stop = [], [cut]
    pa = _kit_pipe(first[0], x, 0, stop, out_a)
    pa.start()
    pa.wait(120)
    path = tmp_path / "kit.ckpt.npz"
    first[1].snapshot(pa).save(str(path))
    ints = _int_leaves(pa, first[1])
    assert len(ints) == 3  # OLS pos, Delay pos, spectral nres
    n_head = len(out_a)
    stop[0] = KIT_N
    pa.start()
    pa.wait(120)
    ref = np.concatenate(out_a[n_head:], 1)

    out_b = []
    pb = _kit_pipe(second[0], x, cut, [KIT_N], out_b)
    ckpt = second[1].load(str(path))
    second[1].restore(pb, ckpt)
    assert _int_leaves(pb, second[1]) == ints
    pb.start()
    pb.wait(120)
    got = np.concatenate(out_b, 1)
    assert got.shape == ref.shape
    assert snr_db(ref, got) >= 100
    ends = _int_leaves(pa, first[1]), _int_leaves(pb, second[1])
    assert ends[0].keys() == ends[1].keys()
    for k in ends[0]:
        np.testing.assert_array_equal(ends[0][k], ends[1][k])


def _gain_pipe(channels=1, n_gains=1, block=BLOCK):
    line = pipe_tpu_torch.Line(
        source=pipe_tpu_torch.mock.Source(channels=channels, limit=4).source(),
        processors=[pipe_tpu_torch.ops.FIR(np.ones(5) / 5).processor()
                    for _ in range(n_gains)],
        sink=pipe_tpu_torch.mock.Sink().sink())
    return pipe_tpu_torch.Pipe(block, line)


@pytest.mark.parametrize(
    "target, match",
    [(lambda: _gain_pipe(block=BLOCK + 1), "block_size"),
     (lambda: _gain_pipe(n_gains=2), "missing"),
     (lambda: _gain_pipe(n_gains=0), "extra"),
     (lambda: _gain_pipe(channels=2), "shape")],
    ids=["block_size", "missing", "extra", "shape"],
)
def test_restore_refuses_whole(target, match):
    """A mismatched checkpoint changes nothing in the target pipe."""
    src = _gain_pipe()
    src.routes[0].processors[0].state["tail"] += 1.0
    ckpt = checkpoint.snapshot(src)
    p = target()
    before = [tree_flatten((c.state, c.params))[0]
              for c in p.routes[0].components()]
    with pytest.raises(ValueError, match=match):
        checkpoint.restore(p, ckpt)
    after = [tree_flatten((c.state, c.params))[0]
             for c in p.routes[0].components()]
    for b, a in zip(before, after):
        for lb, la in zip(b, a):
            assert lb is la


def test_snapshot_and_restore_refuse_a_running_pipe():
    p = pipe_tpu_torch.Pipe(4, pipe_tpu_torch.Line(
        source=pipe_tpu_torch.mock.Source(interval=0.002).source(),
        sink=pipe_tpu_torch.mock.Sink().sink()))
    p.start()
    try:
        with pytest.raises(RuntimeError):
            checkpoint.snapshot(p)
    finally:
        p.stop(60)
    ckpt = checkpoint.snapshot(p)
    assert ckpt.leaves["r0/c0/state/0"].dtype == np.int32  # mock counters
    p._running = True
    with pytest.raises(RuntimeError):
        checkpoint.restore(p, ckpt)
    p._running = False


def test_tree_flatten_matches_jax_order():
    import jax

    tree = {"x_tail": 1, "s": [2, (3, None)], "a": {"z": 4, "b": 5}}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [5, 4, 2, 3, 1]
    assert tree_unflatten(treedef, leaves) == tree
    t = torch.zeros(2)
    assert tree_flatten([t, None])[0][0] is t

"""The port's ``'high'`` precision (3xTF32) on the CPU: every site that
consults ``config.matmul_precision()`` in the JAX package goes through the
port's helpers, which under ``'high'`` split each float32 operand into a
TF32-exact head and the remainder and sum three products.

On the CPU all three products are IEEE FP32, so ``'high'`` differs from
``'highest'`` only by the dropped ``a_lo * b_lo`` term (about 2^-22 of the
operands' magnitudes) and by rounding. Tolerances: ``'high'`` within 115 dB
(``snr_db``) of ``'highest'`` and above 100 dB against float64 at every
site; ``'default'`` equals ``'highest'`` to the bit on the CPU. The JAX
functions run the same inputs as the reference for each site (on the CPU
the JAX package's three names are identical).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu import config as jconfig
from pipe_tpu.ops import channelizer as jchan, fir as jfir, fused as jfused
from pipe_tpu.ops import mix as jmix, resample as jres
from pipe_tpu_torch import config, parallel
from pipe_tpu_torch.flagship import make_flagship
from pipe_tpu_torch.ops import biquad, channelizer, fir, fused, mix, resample
from pipe_tpu_torch.signal import snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

HIGH_VS_HIGHEST_DB = 115.0
VS_FLOAT64_DB = 100.0


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    C, B = 4, 147 * 8
    d = {
        "x": rng.standard_normal((C, B)).astype(np.float32),
        "tail": rng.standard_normal((C, 254)).astype(np.float32),
        "h": fir.design_lowpass(255, 4000.0, 44100.0).astype(np.float32),
        "h_short": rng.standard_normal(9).astype(np.float32),
        "h_pc": rng.standard_normal((C, 33)).astype(np.float32),
        "hp": resample.polyphase_design(160, 147, 32).astype(np.float32),
        "m": rng.standard_normal((2, C)).astype(np.float32),
    }
    d["hist"] = d["tail"][:, :31]
    d["gp"] = channelizer.polyphase_branches(
        channelizer.design_prototype(8, 5), 8).astype(np.float32)
    return d


D = _inputs()


def _resample_gather(t):
    """A partial block at a phase offset: the einsum of the gather path (its
    JAX twin is held by the resampler's own cross-package tests)."""
    y, n_out, _, _ = resample.resample_gather(
        t(D["hist"]), 7, 1000, t(D["x"]), t(D["hp"]), 160, 147,
        -(-D["x"].shape[1] * 160 // 147))
    return y[:, :n_out]


def j(name):
    return jnp.asarray(D[name])


# site -> (port function of the cast ``t`` that makes its tensors, JAX
# function of no arguments or None)
SITES = {
    "mix.channel_mix_block": (
        lambda t: mix.channel_mix_block(t(D["x"]), t(D["m"])),
        lambda: jmix.channel_mix_block(j("x"), j("m"))),
    "fir.shared_short": (
        lambda t: fir.fir_apply(t(D["tail"][:, :8]), t(D["x"]), t(D["h_short"])),
        lambda: jfir.fir_apply(j("tail")[:, :8], j("x"), j("h_short"))),
    "fir.per_channel": (
        lambda t: fir.fir_apply(t(D["tail"][:, :32]), t(D["x"]), t(D["h_pc"])),
        lambda: jfir.fir_apply(j("tail")[:, :32], j("x"), j("h_pc"))),
    "fir.toeplitz": (
        lambda t: fir.fir_apply(t(D["tail"]), t(D["x"]), t(D["h"])),
        lambda: jfir.fir_apply(j("tail"), j("x"), j("h"))),
    "resample.apply": (
        lambda t: resample.resample_apply(t(D["hist"]), t(D["x"]), t(D["hp"]),
                                          160, 147),
        lambda: jres.resample_apply(j("hist"), j("x"), j("hp"), 160, 147)),
    "resample.gather": (_resample_gather, None),
    "fused.combine_bank": (
        lambda t: fused.combine_bank(t(D["h"]), t(D["hp"])),
        lambda: jfused.combine_bank(j("h"), j("hp"))),
    "fused.cascade_taps.shared": (
        lambda t: fused.cascade_taps([t(D["h"]), t(D["h_short"])]),
        lambda: jfused.cascade_taps([j("h"), j("h_short")])),
    "fused.cascade_taps.per_channel": (
        lambda t: fused.cascade_taps([t(D["h_pc"]), t(D["h_short"])]),
        lambda: jfused.cascade_taps([j("h_pc"), j("h_short")])),
    "channelizer.channelize_block": (
        lambda t: torch.cat(channelizer.channelize_block(
            t(D["tail"][:, :40]), t(D["x"][:, :1024]), t(D["gp"]), 8), dim=1),
        lambda: jnp.concatenate(jchan.channelize_block(
            j("tail")[:, :40], j("x")[:, :1024], j("gp"), 8), axis=1)),
}


def t64(a):
    """float64 operands pass through the helpers as one product."""
    return torch.tensor(np.asarray(a, np.float64))


def _under(name, fn):
    with config.matmul_precision_scope(name):
        assert config.matmul_precision() == name
        return fn().numpy()


@pytest.mark.parametrize("site", SITES)
def test_high_agrees_with_highest_at_every_routed_site(site):
    port_fn, jax_fn = SITES[site]
    highest, high, default = (_under(name, lambda: port_fn(t32))
                              for name in ("highest", "high", "default"))
    ref = port_fn(t64).numpy()
    assert ref.dtype == np.float64
    np.testing.assert_array_equal(default, highest)  # the CPU has no TF32
    assert not np.array_equal(high, highest)  # the split path really ran
    assert snr_db(highest, high) > HIGH_VS_HIGHEST_DB, snr_db(highest, high)
    assert snr_db(ref, high) > VS_FLOAT64_DB, snr_db(ref, high)
    assert snr_db(ref, highest) > VS_FLOAT64_DB
    if jax_fn is not None:
        with jconfig.matmul_precision_scope("high"):
            jout = np.asarray(jax_fn())
        assert snr_db(jout.astype(np.float64), high) > VS_FLOAT64_DB


def _jax_resample_gather():
    """The JAX Resampler's gather path on the block and phase offset of
    ``_resample_gather``: a partial block of 1000 frames at offset 7."""
    from pipe_tpu.signal import Signal as JSignal, SignalProperties as JProps

    C, B = D["x"].shape
    comp = jres.Resampler(160, 147).processor()(None, B, JProps(44100.0, C))
    state = {"hist": j("hist"), "off": jnp.asarray(7, jnp.int32)}
    _, out = comp.step(state, {"hp": j("hp")},
                       JSignal(j("x"), jnp.asarray(1000, jnp.int32)))
    return out.data[:, : int(out.frames)]


MIXED_VS_JAX_DB = 110.0


@pytest.mark.parametrize("site", SITES)
def test_mixed_agrees_with_jax_mixed_at_every_routed_site(site):
    """``'mixed'`` splits the first operand into three TF32 terms and the
    second into two, as the JAX pair ``(HIGHEST, HIGH)`` treats the lhs and
    the rhs: at every routed site the port under ``'mixed'`` agrees with
    the JAX package under ``'mixed'``, and the five products really ran
    (on the CPU they differ from the one product by rounding only)."""
    port_fn, jax_fn = SITES[site]
    mixed = _under("mixed", lambda: port_fn(t32))
    highest = _under("highest", lambda: port_fn(t32))
    ref = port_fn(t64).numpy()
    assert not np.array_equal(mixed, highest)  # the split path really ran
    assert snr_db(highest, mixed) > HIGH_VS_HIGHEST_DB, snr_db(highest, mixed)
    assert snr_db(ref, mixed) > VS_FLOAT64_DB, snr_db(ref, mixed)
    with jconfig.matmul_precision_scope("mixed"):
        jout = np.asarray((jax_fn or _jax_resample_gather)())
    db = snr_db(jout.astype(np.float64), mixed)
    assert db >= MIXED_VS_JAX_DB, db


def test_mixed_split_is_exact(rng):
    """The first operand's three terms sum to it exactly, each of the first
    two fits TF32, and the third is below 2^-21 of the value."""
    a = torch.tensor((rng.standard_normal(4096)
                      * 10.0 ** rng.integers(-20, 20, 4096)).astype(np.float32))
    a1, r = config._split_tf32(a)
    a2, a3 = config._split_tf32(r)
    assert torch.equal((a1 + a2) + a3, a) and torch.equal(a2 + a3, r)
    for term in (a1, a2):
        assert not (term.view(torch.int32) & 0x1FFF).any()
    assert (a3.abs() <= a.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("fused_path", [True, False], ids=["fused", "two-stage"])
def test_flagship_under_mixed(fused_path):
    """The flagship's mix (and its FIR and resampler) under ``'mixed'``
    against the JAX flagship under ``'mixed'`` on the same input."""
    from pipe_tpu.flagship import make_flagship as jmake

    with config.matmul_precision_scope("mixed"):
        fn, state, x = make_flagship(channels=4, chunk=147 * 8, fused=fused_path)
        state, y1 = fn(state, x)
        _, y2 = fn(state, x)
    got = torch.cat([y1, y2], dim=1).numpy()
    with jconfig.matmul_precision_scope("mixed"):
        jfn, jstate, _ = jmake(channels=4, chunk=147 * 8, fused=fused_path)
        jstate, j1 = jfn(jstate, jnp.asarray(x.numpy()))
        _, j2 = jfn(jstate, jnp.asarray(x.numpy()))
    jout = np.concatenate([np.asarray(j1), np.asarray(j2)], axis=1)
    assert snr_db(jout.astype(np.float64), got) >= MIXED_VS_JAX_DB


@pytest.mark.parametrize("fused_path", [True, False], ids=["fused", "two-stage"])
def test_flagship_under_high(fused_path):
    """The slice's chunk function (FIR -> resample -> mix): 'high' against
    'highest' and against the JAX flagship on the same input."""
    from pipe_tpu.flagship import make_flagship as jmake

    outs = {}
    for name in ("highest", "high"):
        with config.matmul_precision_scope(name):
            fn, state, x = make_flagship(channels=4, chunk=147 * 8,
                                         fused=fused_path)
            state, y1 = fn(state, x)
            _, y2 = fn(state, x)
            outs[name] = torch.cat([y1, y2], dim=1).numpy()
    assert snr_db(outs["highest"], outs["high"]) > HIGH_VS_HIGHEST_DB
    jfn, jstate, _ = jmake(channels=4, chunk=147 * 8, fused=fused_path)
    jstate, j1 = jfn(jstate, jnp.asarray(x.numpy()))
    _, j2 = jfn(jstate, jnp.asarray(x.numpy()))
    jout = np.concatenate([np.asarray(j1), np.asarray(j2)], axis=1)
    assert snr_db(jout.astype(np.float64), outs["high"]) > VS_FLOAT64_DB


def test_sharded_mix_stage_consults_the_knob(rng):
    m = rng.standard_normal((2, 4)).astype(np.float32)
    x = rng.standard_normal((4, 512)).astype(np.float32)
    outs = {}
    for name in ("highest", "high", "mixed"):
        with config.matmul_precision_scope(name):
            chain = parallel.ShardedChain(parallel.make_mesh(1, 1),
                                          [parallel.MixStage(m)], 4, 512)
            outs[name] = chain.step(x).numpy()
    for name in ("high", "mixed"):
        assert not np.array_equal(outs[name], outs["highest"])
        assert snr_db(outs["highest"], outs[name]) > HIGH_VS_HIGHEST_DB


def test_split_is_exact_and_the_head_fits_tf32(rng):
    a = torch.tensor(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
        [0.0, -0.0, 1.0, np.float32(1) + np.float32(2) ** -11,
         np.finfo(np.float32).tiny, 3.0e38]]).astype(np.float32))
    hi, lo = config._split_tf32(a)
    assert torch.equal(hi + lo, a)
    assert not (hi.view(torch.int32) & 0x1FFF).any()  # 13 low mantissa bits
    # nearest: the remainder is at most half a TF32 ulp of the head
    nz = hi != 0
    assert (lo[nz].abs() <= hi[nz].abs() * 2.0 ** -11).all()
    # the remainder fits TF32 too, bar its last bit or two
    lo_hi, lo_lo = config._split_tf32(lo)
    assert (lo_lo.abs() <= lo.abs() * 2.0 ** -10 + 1e-45).all()


def test_split_at_the_top_of_the_range_and_beyond(rng):
    """A value whose head would round to infinity is its own head, so
    products of finite values stay finite under 'high'. A non-finite sample
    gives NaN in the outputs it enters and leaves the others alone."""
    big = np.finfo(np.float32).max
    a = torch.tensor([big, -big, np.nextafter(np.float32(big), np.float32(0))])
    hi, lo = config._split_tf32(a)
    assert torch.equal(hi, a) and not lo.any()
    x = rng.standard_normal((3, 64)).astype(np.float32)
    x[0, 5], x[1, 7], x[2, 9] = big, np.inf, np.nan
    m = torch.tensor(rng.standard_normal((2, 3)).astype(np.float32))
    m[:, 0] = torch.tensor([0.5, -0.25])  # the product with `big` stays finite
    with config.matmul_precision_scope("highest"):
        want = config.matmul(m, torch.tensor(x))
    with config.matmul_precision_scope("high"):
        got = config.matmul(m, torch.tensor(x))
    clean = np.ones(64, bool)
    clean[[7, 9]] = False
    assert torch.isfinite(got[:, clean]).all()
    assert snr_db(want[:, clean].numpy(), got[:, clean].numpy()) > HIGH_VS_HIGHEST_DB
    assert torch.isnan(got[:, [7, 9]]).all()
    assert not torch.isfinite(want[:, [7, 9]]).any()


def test_precision_names_and_scope():
    assert config.matmul_precision() == "highest" and config.fp32_pinned()
    config.set_matmul_precision("HIGH")
    try:
        assert config.matmul_precision() == "high" and not config.fp32_pinned()
        with config.matmul_precision_scope("default"):
            assert config.matmul_precision() == "default"
        assert config.matmul_precision() == "high"
    finally:
        config.set_matmul_precision("highest")
    assert config.fp32_pinned()
    with config.matmul_precision_scope("mixed"):  # the JAX package's name
        assert config.matmul_precision() == "mixed" and not config.fp32_pinned()
    assert config.fp32_pinned()
    with pytest.raises(ValueError, match="bogus"):
        config.set_matmul_precision("bogus")
    with pytest.raises(TypeError):
        config.set_matmul_precision(3)
    # float64 operands pass through one product under every name
    a = torch.ones((2, 3), dtype=torch.float64)
    with config.matmul_precision_scope("high"):
        assert config.matmul(a, a.T).dtype == torch.float64


def test_the_path_is_chosen_once_per_call(monkeypatch):
    """The knob is process-wide for a thread that bound no name (an
    executor binds its run's name, ``test_a_running_pipe_keeps_its_
    precision``): a scope entered in one thread changes what other threads'
    later calls do. Within one call the helper reads the name once, so a
    flip in mid-call cannot mix one product with three."""
    calls = []
    a = torch.randn(8, 8)

    def spy(p, q):
        calls.append(config.matmul_precision())
        if len(calls) == 1:
            config.set_matmul_precision("highest")  # another thread's flip
        return torch.matmul(p, q)

    config.set_matmul_precision("high")
    try:
        config._bilinear(spy, a, a)
    finally:
        config.set_matmul_precision("highest")
    assert len(calls) == 3  # all three products of the path chosen at entry

    seen = {}

    def other():
        seen["name"] = config.matmul_precision()

    with config.matmul_precision_scope("high"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen["name"] == "high"  # the documented process-wide effect


@pytest.mark.parametrize("path", ["tiles", "assoc", "section", "extended",
                                  "sharded"])
def test_recursive_paths_do_not_consult_the_knob(rng, path):
    """The biquad's recurrence gives the same bits under every name (on the
    CPU trivially so for the flags; the helpers' split must not be on its
    path either)."""
    sos = biquad.design_peaking_eq(48000, 1000.0, 1.0, 3.0)
    coefs = t32(sos)
    x = t32(rng.standard_normal((8, 2560)))
    s = t32(rng.standard_normal((8, 2)))

    def run():
        if path in ("tiles", "assoc"):
            plain = {"tiles": biquad._iir_tiles, "assoc": biquad._iir_assoc}
            return plain[path](x, s, coefs[4], coefs[5])
        if path == "section":
            st = {"x_tail": s.clone(), "s": s.clone()}
            return biquad.biquad_section_block(st, x, 2560, coefs)[1]
        if path == "extended":
            hi, lo = (t32(a) for a in biquad.split_f32_pair(sos))
            st = {"x_tail": s.clone(), "s": s.clone(), "s_lo": torch.zeros_like(s)}
            return biquad.biquad_section_block_extended(st, x, 2560, hi, lo)[1]
        chain = parallel.ShardedChain(parallel.make_mesh(1, 1),
                                      [parallel.BiquadStage(sos)], 8, 2560)
        return chain.step(x)

    outs = [_under(name, run) for name in ("highest", "high", "mixed", "default")]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


def _pipe_under_flip(pkg, x, flip_to=None, start_as="highest"):
    """``x`` through ``Pipe(FIR -> 4->2 mix)`` of ``pkg`` started under
    ``start_as``; with ``flip_to`` the main thread sets that precision once
    the feed reached block 3 (the feed waits for it), and the name is
    restored after the run."""
    cfg = pkg.config
    block, hold, reached = 256, threading.Event(), threading.Event()
    pos, out = [0], []
    h = np.asarray(fir.design_lowpass(63, 4000.0, 44100.0))
    m = np.random.default_rng(1).standard_normal((2, x.shape[0])).astype(np.float32)

    def feed(n):
        if pos[0] == 3 * block and flip_to is not None:
            reached.set()
            hold.wait(30)
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n:pos[0]]

    cfg.set_matmul_precision(start_as)
    try:
        p = pkg.Pipe(block, pkg.Line(
            source=lambda c, b: pkg.Source(
                output=pkg.SignalProperties(44100.0, x.shape[0]), feed=feed),
            processors=[pkg.ops.FIR(h).processor(),
                        pkg.ops.ChannelMix(m).processor()],
            sink=lambda c, b, pr: pkg.Sink(receive=lambda a: out.append(np.array(a)))))
        p.start()
        if flip_to is not None:
            assert reached.wait(30)
            cfg.set_matmul_precision(flip_to)
            hold.set()
        p.wait(60)
    finally:
        cfg.set_matmul_precision("highest")
    return np.concatenate(out, axis=1)


def test_a_running_pipe_keeps_its_precision(rng):
    """A pipe started under ``'highest'`` keeps it when the main thread sets
    ``'high'`` after block 3, as a JAX pipe keeps the precision its step
    was traced with: the output equals the untouched run bit for bit, in
    both packages. The port's 3-pass path makes the difference observable
    on the CPU (a run started under ``'high'`` differs), which the JAX
    package's CPU backend does not."""
    import pipe_tpu

    x = rng.standard_normal((4, 256 * 8)).astype(np.float32)
    jax_plain = _pipe_under_flip(pipe_tpu, x)
    np.testing.assert_array_equal(_pipe_under_flip(pipe_tpu, x, "high"), jax_plain)
    plain = _pipe_under_flip(pipe_tpu_torch, x)
    np.testing.assert_array_equal(_pipe_under_flip(pipe_tpu_torch, x, "high"), plain)
    high = _pipe_under_flip(pipe_tpu_torch, x, start_as="high")
    assert not np.array_equal(high, plain)
    assert snr_db(plain, high) > HIGH_VS_HIGHEST_DB
    # the packages agree on the stream the pipe kept
    assert snr_db(jax_plain.astype(np.float64), plain) > 100

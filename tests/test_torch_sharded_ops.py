"""The 22 op classes of ``pipe_tpu_torch.parallel.sharded`` against those of
``pipe_tpu.parallel.sharded``, on a 1x1 mesh (no ranks needed): the same
seeded numpy input through a mesh ``Pipe`` of each package, with every
``set_*`` pushed at a block target. Bars: the port's output is >= 100 dB
from the JAX pipe's (``atol`` 2e-5 where the original test compares with
``assert_allclose``), equal shapes, equal ``out_capacity`` and output
properties. Also the unit tests of ``_pad_param`` / ``_pad_ir_rows`` on a
channel-padded allocation, and ``make_routes_aggregated`` choosing the
aggregation factor the JAX package chooses.
"""

import inspect

import numpy as np
import pytest

import pipe_tpu
import pipe_tpu.parallel  # noqa: F401
import pipe_tpu_torch
from pipe_tpu_torch import mock, mutable, ops, parallel
from pipe_tpu_torch.errors import AllocationError, ShapeConstraintError
from pipe_tpu_torch.graph import make_routes_aggregated
from pipe_tpu_torch.parallel import components as sharded
from pipe_tpu_torch.signal import SignalProperties, snr_db
from tests.torch_mesh_worker import drive_pipe

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

RNG = np.random.default_rng(42)
H63 = np.asarray(ops.design_lowpass(63, 4000, 44100))
H63B = np.asarray(ops.design_lowpass(63, 1000, 44100))
H31 = np.asarray(ops.design_lowpass(31, 6000, 44100))
SOS = ops.design_peaking_eq(44100, freq=1000, q=1.0, gain_db=6.0)
SOS2 = ops.design_peaking_eq(44100, freq=2500, q=2.0, gain_db=-4.0)
IR = RNG.standard_normal(700) * np.exp(-np.arange(700) / 150.0)
IR2 = RNG.standard_normal(700) * np.exp(-np.arange(700) / 90.0)
MIX = (np.ones((2, 4)) / 4).astype(np.float32)
MIX2 = np.asarray([[1, 0, 0, 0], [0, 0.5, 0.5, 0]], np.float32)
PROTO = np.hanning(64) / 32.0


def bank(up, down, k):
    from pipe_tpu_torch.ops.resample import polyphase_design

    return 0.5 * np.asarray(polyphase_design(up, down, k), np.float32)


# (id, ops, pushes [(op index, method, args, kwargs)], channels, block, scale)
CASES = [
    ("Gain", [("Gain", (0.5,), {})], [(0, "set_gain", (0.25,), {})], 4, 1024, 1),
    ("Gain-vector", [("Gain", (np.arange(1, 5, dtype=np.float32),), {})],
     [(0, "set_gain", (np.full(4, 2.0, np.float32),), {})], 4, 1024, 1),
    ("FIR", [("FIR", (H63,), {})], [(0, "set_taps", (H63B,), {})], 4, 1024, 1),
    ("FIR-per-channel", [("FIR", (np.stack([H63, H63B, H63, H63B]),), {})],
     [(0, "set_taps", (np.stack([H63B] * 4),), {})], 4, 1024, 1),
    ("Resample", [("Resample", (48000, 44100), {"taps_per_phase": 16})], [],
     4, 147 * 8, 1),
    ("FIRResample", [("FIRResample", (H31, 48000, 44100), {"taps_per_phase": 16})],
     [(0, "set_taps", (0.5 * H31,), {}),
      (0, "set_bank", (bank(160, 147, 16),), {})], 4, 147 * 8, 1),
    ("OLS", [("OLS", (IR,), {})], [(0, "set_ir", (IR2,), {})], 2, 2048, 1),
    ("OLSGain", [("OLSGain", (IR, 0.5), {})],
     [(0, "set_ir", (IR2,), {}), (0, "set_gain", (1.5,), {})], 2, 2048, 1),
    ("FIRCascade", [("FIRCascade", ([H63, H31],), {})],
     [(0, "set_part_taps", (1, 0.5 * H31), {})], 4, 1024, 1),
    ("Biquad", [("Biquad", (SOS,), {})], [(0, "set_sos", (SOS2,), {})],
     2, 2048, 0.5),
    ("Biquad-extended", [("Biquad", (SOS,), {"precision": "extended"})],
     [(0, "set_sos", (SOS2,), {})], 2, 2048, 0.5),
    ("Compressor", [("Compressor", (), dict(threshold_db=-12.0, ratio=3.0,
                                            attack_ms=5.0, release_ms=80.0))],
     [(0, "set", (), dict(threshold_db=-20.0, makeup_db=2.0))], 2, 2048, 0.5),
    ("SpectralGain", [("SpectralGain", (256, 64), {})],
     [(0, "set_gains", (np.linspace(1.0, 0.0, 129),), {})], 2, 2048, 1),
    ("SpectralGate", [("SpectralGate", (256, 64, 3.0), {"reduction_db": -40.0})],
     [(0, "set", (), dict(threshold=1.0, reduction_db=-20.0))], 2, 2048, 1),
    ("Mix", [("Mix", (MIX,), {})], [(0, "set_matrix", (MIX2,), {})], 4, 1024, 1),
    ("FIRGain", [("FIRGain", (H63, 0.5), {})],
     [(0, "set_taps", (H63B,), {}), (0, "set_gain", (2.0,), {})], 4, 1024, 1),
    ("MixGain-in", [("MixGain", (MIX, 0.5, "in"), {})],
     [(0, "set_matrix", (MIX2,), {}), (0, "set_gain", (2.0,), {})], 4, 1024, 1),
    ("MixGain-out", [("MixGain", (MIX, np.asarray([0.5, 2.0], np.float32), "out"), {})],
     [(0, "set_gain", (np.asarray([1.0, 3.0], np.float32),), {})], 4, 1024, 1),
    ("BiquadCascade", [("BiquadCascade", ([SOS, SOS2],), {})],
     [(0, "set_part_sos", (1, SOS), {})], 2, 2048, 0.5),
    ("Delay-feedback", [("Delay", (256,), dict(feedback=0.5, wet=0.5, dry=1.0))],
     [(0, "set_feedback", (0.3,), {}), (0, "set_mix", (0.25, 0.75), {})],
     2, 2048, 0.5),
    ("Delay-pure-long", [("Delay", (5000,), dict(wet=1.0, dry=0.5))],
     [(0, "set_mix", (0.5, 0.5), {})], 2, 2048, 0.5),
    ("Gate", [("Gate", (), dict(threshold_db=6.0, range_db=40.0))],
     [(0, "set", (), dict(threshold_db=-20.0))], 2, 2048, 0.5),
    ("Limiter", [("Limiter", (), dict(threshold_db=-6.0))],
     [(0, "set", (), dict(threshold_db=-3.0, makeup_db=1.0))], 2, 2048, 0.5),
    ("Channelizer", [("Channelizer", (8,), {"taps_per_branch": 8})],
     [(0, "set_prototype", (PROTO,), {})], 2, 2048, 1),
    ("IQMix-EnvelopeDetector", [("IQMix", (3000.0,), {}),
                                ("EnvelopeDetector", (), {})], [], 2, 2048, 1),
    ("IQMix-FMDiscriminator", [("IQMix", (3000.0,), {}),
                               ("FMDiscriminator", (), {})], [], 2, 2048, 1),
]


def test_every_op_class_has_a_case():
    """The 22 op classes of the JAX module, by name, each in a case."""
    jnames = {n for n, c in vars(pipe_tpu.parallel.sharded).items()
              if inspect.isclass(c)
              and issubclass(c, pipe_tpu.parallel.sharded.ShardedOp)
              and c is not pipe_tpu.parallel.sharded.ShardedOp}
    assert len(jnames) == 22
    assert {op[0] for case in CASES for op in case[1]} == jnames
    for n in jnames:
        jc, tc = getattr(pipe_tpu.parallel.sharded, n), getattr(sharded, n)
        assert (list(inspect.signature(jc.__init__).parameters)
                == list(inspect.signature(tc.__init__).parameters)), n
        jsets = {m for m in vars(jc) if m.startswith("set")}
        for m in jsets:
            assert (list(inspect.signature(getattr(jc, m)).parameters)
                    == list(inspect.signature(getattr(tc, m)).parameters)), (n, m)
        assert jc.fusion_kind == tc.fusion_kind, n


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax_on_a_1x1_mesh(case):
    """Six blocks (the last one partial) through a mesh Pipe of each
    package, every ``set_*`` pushed at block 3."""
    _, op_specs, pushes, C, block, scale = case
    x = (np.random.default_rng(7).standard_normal((C, block * 5 + block // 3))
         * scale).astype(np.float32)
    line = {"source": ("feed", x, 48000.0), "ops": op_specs}
    pu = [(0, oi, m, a, k, 3) for oi, m, a, k in pushes]
    got = drive_pipe(pipe_tpu_torch, parallel.make_mesh, (1, 1), block, [line],
                     pushes=pu)
    ref = drive_pipe(pipe_tpu, pipe_tpu.parallel.make_mesh, (1, 1), block,
                     [line], pushes=pu)
    assert got["error"] is None and ref["error"] is None
    y, yj = got["out"][0], ref["out"][0]
    assert y.shape == yj.shape and y.shape[1] > 0
    assert np.isfinite(y).all()
    assert got["out_capacity"] == ref["out_capacity"]
    assert got["out_props"] == ref["out_props"]
    assert got["agg"] == ref["agg"] == 1
    if pushes:  # the retune changed the stream, and only from its block on
        plain = drive_pipe(pipe_tpu_torch, parallel.make_mesh, (1, 1), block,
                           [line])["out"][0]
        w = y.shape[1] * 3 * block // x.shape[1]  # first output of block 3
        np.testing.assert_array_equal(plain[:, :w - 64], y[:, :w - 64])
        assert not np.array_equal(plain[:, w:], y[:, w:])
    assert snr_db(yj, y) >= 100, f"{snr_db(yj, y):.1f} dB"
    np.testing.assert_allclose(y, yj, atol=2e-5 * max(1.0, np.abs(yj).max()))


def _allocate(op, channels, block, ch=1, t=1):
    """Allocate ``op`` as position (0, 0) of a ``ch x t`` mesh: allocation
    reads the mesh's shape and this rank's position and calls no
    collective, so no process group is needed."""
    mesh = parallel.Mesh(ch, t, 0, None, {})
    with parallel.mesh_scope(mesh):
        return op.processor()(mutable.mutable(), block,
                              SignalProperties(44100.0, channels))


def test_set_refusals_carry_the_jax_messages():
    js = pipe_tpu.parallel.sharded
    for mk, call, exc in [
        (lambda s: s.FIR(H63), lambda o: o.set_taps(H31), ValueError),
        (lambda s: s.FIRResample(H31, 2, 1), lambda o: o.set_taps(H63), ValueError),
        (lambda s: s.OLS(IR), lambda o: o.set_ir(IR[:100]), ValueError),
        (lambda s: s.OLSGain(IR), lambda o: o.set_ir(IR[:100]), ValueError),
        (lambda s: s.Mix(MIX), lambda o: o.set_matrix(MIX[:1]), ValueError),
        (lambda s: s.Biquad(SOS), lambda o: o.set_sos(SOS[:5]), ValueError),
        (lambda s: s.Compressor(), lambda o: o.set(knee=1.0), KeyError),
        (lambda s: s.Gate(), lambda o: o.set(ratio=1.0), KeyError),
        (lambda s: s.Limiter(), lambda o: o.set(ratio=1.0), KeyError),
    ]:
        msgs = []
        for s, ctx in ((js, pipe_tpu.mutable.mutable()),
                       (sharded, mutable.mutable())):
            o = mk(s)
            o.context = ctx
            with pytest.raises(exc) as e:
                call(o)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], msgs
    # FIRCascade.set_part_taps and Delay.set_feedback on a pure delay
    parts = [sharded.FIR(H63), sharded.FIR(H31)]
    with pytest.raises(ValueError, match="live retunes must keep shapes"):
        sharded.FIRCascade(parts).set_part_taps(parts[1], H63)
    pure = sharded.Delay(100, wet=1.0)
    _allocate(pure, 2, 1024)
    with pytest.raises(ValueError, match="cannot do feedback"):
        pure.set_feedback(0.3)
    echo = sharded.Delay(100, allow_feedback=True)
    _allocate(echo, 2, 1024)
    echo.set_feedback(0.3).apply()
    assert float(echo._component.params["feedback"]) == np.float32(0.3)


def test_pad_param_pads_against_the_global_built_shape():
    """6 channels on a 4-way channel axis build 8 rows; a (6, T) retune is
    padded to (8, T) and position 0 keeps rows 0-1. A value that already has
    the built shape, a replicated one and a mismatched one pass through."""
    taps = np.stack([H31 * (c + 1) for c in range(6)]).astype(np.float32)
    fir = sharded.FIR(taps)
    comp = _allocate(fir, 6, 1024, ch=4, t=2)
    assert tuple(comp.params["taps"].shape) == (2, 31)
    assert tuple(fir._stage.params["taps"].shape) == (8, 31)
    padded = fir._pad_param("taps", 2 * taps)
    assert padded.shape == (8, 31) and not padded[6:].any()
    np.testing.assert_array_equal(padded[:6], 2 * taps)
    full = np.ones((8, 31), np.float32)
    assert fir._pad_param("taps", full) is full
    odd = np.ones((6, 30), np.float32)
    assert fir._pad_param("taps", odd) is odd
    fir.set_taps(2 * taps).apply()
    np.testing.assert_array_equal(comp.params["taps"].numpy(), 2 * taps[:2])
    g = sharded.Gain(np.ones(6, np.float32))
    gc = _allocate(g, 6, 1024, ch=4, t=2)
    g.set_gain(np.arange(6, dtype=np.float32)).apply()
    np.testing.assert_array_equal(gc.params["gain"].numpy(), [0.0, 1.0])
    # no padding on a line whose channels divide the axis
    fir4 = sharded.FIR(taps[:4])
    _allocate(fir4, 4, 1024, ch=4, t=2)
    assert fir4._pad_param("taps", odd) is odd


def test_pad_ir_rows():
    ir = np.stack([IR * (c + 1) for c in range(3)])
    ols = sharded.OLS(ir)
    assert sharded._pad_ir_rows(ols, ir) is ir  # not allocated yet
    comp = _allocate(ols, 3, 4096, ch=2, t=1)
    padded = sharded._pad_ir_rows(ols, ir)
    assert padded.shape == (4, 700) and not padded[3:].any()
    assert sharded._pad_ir_rows(ols, IR) is IR  # a shared IR has no rows
    before = comp.params["ir_f"]
    ols.set_ir(2 * ir).apply()
    after = comp.params["ir_f"]
    assert after.shape == before.shape and after is not before
    np.testing.assert_allclose(after.numpy(), 2 * before.numpy(), rtol=1e-6)


def test_width_contract_and_build_refusals():
    rs = _allocate(sharded.Resample(48000, 44100), 2, 147 * 8, t=4)
    assert rs.out_capacity == 160 * 8 and rs.output.sample_rate == 48000.0
    assert _allocate(sharded.FIR(H31), 2, 1024, t=4).out_capacity is None
    chz = _allocate(sharded.Channelizer(8, 8), 2, 2048, t=4)
    assert chz.out_capacity == 256 and chz.output.channels == 2 * 2 * 5
    mix = _allocate(sharded.Mix(MIX), 4, 1024, ch=2)
    assert mix.reduces_channels and mix.output.channels == 2
    with pytest.raises(ShapeConstraintError, match="not divisible by time shards"):
        _allocate(sharded.Gain(1.0), 2, 1001, t=4)
    with pytest.raises(ValueError, match="changes the channel count"):
        _allocate(sharded.Channelizer(4), 6, 1024, ch=4, t=2)
    with pytest.raises(ValueError, match="positional channel layout"):
        _allocate(sharded.EnvelopeDetector(), 6, 1024, ch=4)
    with pytest.raises(RuntimeError, match="requires a mesh"):
        sharded.Gain(1.0).processor()(mutable.mutable(), 64,
                                      SignalProperties(44100.0, 1))


def _jax_agg(mesh, block, channels, make_ops):
    sh = pipe_tpu.parallel.sharded
    src = pipe_tpu.mock.Source(channels=channels, limit=block)
    p = pipe_tpu.Pipe(
        block,
        pipe_tpu.Line(source=src.source(),
                      processors=[o.processor() for o in make_ops(sh)],
                      sink=pipe_tpu.mock.Sink().sink()),
        mesh=pipe_tpu.parallel.make_mesh(*mesh))
    return p._agg


@pytest.mark.parametrize("mesh, block, channels, make_ops, expect", [
    ((1, 4), 1001, 2, lambda sh: [sh.Gain(0.5)], 4),
    ((2, 4), 1000, 6, lambda sh: [sh.FIR(H63), sh.Resample(48000, 44100)], 147),
    ((1, 2), 1000, 2, lambda sh: [sh.SpectralGain(1024, 256)], 64),
    ((1, 4), 256, 2, lambda sh: [sh.FIR(np.ones(255) / 255)], 4),
    ((1, 4), 500, 2, lambda sh: [sh.Channelizer(8, 8)], 8),
], ids=["any-block", "weird-shape-matrix", "spectral-weird-block",
        "fir-halo", "channelizer"])
def test_make_routes_aggregated_picks_the_jax_factor(mesh, block, channels,
                                                     make_ops, expect):
    lines = [pipe_tpu_torch.Line(
        source=mock.Source(channels=channels, limit=block).source(),
        processors=[o.processor() for o in make_ops(sharded)],
        sink=mock.Sink().sink())]
    fake = parallel.Mesh(mesh[0], mesh[1], 0, None, {})
    with parallel.mesh_scope(fake):
        routes, a = make_routes_aggregated(lines, block, fake)
    assert a == expect == _jax_agg(mesh, block, channels, make_ops)
    assert len(routes) == 1
    p = pipe_tpu_torch.Pipe(block, *lines, mesh=fake)
    assert p._agg == a and p._block_internal == a * block
    assert p._to_internal_block(3 * a, "push") == 3
    if a > 1:
        with pytest.raises(ValueError, match="dispatch grid"):
            p._to_internal_block(a + 1, "push")


def test_make_routes_aggregated_raises_what_is_not_a_shape_rule():
    """A plain ``ValueError`` of an allocator ends the search at once; a
    shape rule that no factor satisfies ends it at ``max_agg``."""
    fake = parallel.Mesh(1, 4, 0, None, {})
    calls = []

    def bad(mctx, block, props):
        calls.append(block)
        raise ValueError("per-channel gain for 3 channels")

    def never(mctx, block, props):
        calls.append(block)
        raise ShapeConstraintError("never fits")

    def line(proc):
        return pipe_tpu_torch.Line(
            source=mock.Source(channels=2, limit=64).source(),
            processors=[proc], sink=mock.Sink().sink())

    with parallel.mesh_scope(fake):
        with pytest.raises(AllocationError, match="per-channel gain") as e:
            make_routes_aggregated([line(bad)], 1001, fake)
        assert not isinstance(e.value.__cause__, ShapeConstraintError)
        assert calls == [4004]
        calls.clear()
        with pytest.raises(AllocationError, match="no block aggregation factor up to 6"):
            make_routes_aggregated([line(never)], 1001, fake, max_agg=6)
        assert calls == [4004]  # 1..6: only a=4 divides over the time axis


def test_mesh_stateful_component_needs_spec():
    """A stateful streaming component is refused on a time-sharded mesh,
    with the JAX package's message."""
    from pipe_tpu_torch.graph import make_route
    from pipe_tpu_torch.runtime.executor import LineExecutor

    fake = parallel.Mesh(1, 4, 0, None, {})
    line = pipe_tpu_torch.Line(
        source=mock.Source(channels=2, value=1.0, limit=4096).source(),
        processors=[ops.FIR(H63).processor()], sink=mock.Sink(discard=True).sink())
    with parallel.mesh_scope(fake):
        le = LineExecutor(make_route(line, 2048), 2048, mesh=fake)
    with pytest.raises(ValueError, match="has no state_spec: on a time-sharded mesh"):
        le.start_hook()
    with pytest.raises(ValueError, match="not divisible by the mesh time axis"):
        LineExecutor(le.route, 2050, mesh=fake).start_hook()

"""Package-level checks of the port: it imports no JAX, it pins IEEE FP32,
and ``convert`` carries a JAX component's state into the port."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu import ops as jops
from pipe_tpu.signal import Signal as JSignal, SignalProperties as JProps
from pipe_tpu_torch import config, convert, mutable, ops as tops
from pipe_tpu_torch.signal import (
    Signal,
    SignalProperties,
    from_array,
    silence,
    snr_db,
    to_numpy,
)

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

PKG = pathlib.Path(pipe_tpu_torch.__file__).parent
REPO = PKG.parent


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    + sorted((REPO / "examples" / "torch").glob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import(path):
    """Neither the package, nor the card's smoke script, nor the port's
    examples import JAX or the JAX package (the card machine has no JAX)."""
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "pipe_tpu"}, roots


def test_op_kit_exports_every_jax_name():
    """Every name of ``pipe_tpu.ops.__all__`` exists in the port's op kit,
    and the port exports the optimizer."""
    import pipe_tpu.ops

    assert set(pipe_tpu.ops.__all__) <= set(tops.__all__)
    for name in pipe_tpu.ops.__all__:
        assert hasattr(tops, name), name
    assert callable(pipe_tpu_torch.optimize.fuse)


def test_sharded_kit_exports_every_jax_name():
    """``pipe_tpu_torch.parallel.sharded`` defines every public name that
    ``pipe_tpu.parallel.sharded`` defines (the base and the 22 op classes),
    each op class a subclass of the port's base, and the import check above
    covers its file."""
    import pipe_tpu.parallel
    from pipe_tpu_torch import parallel

    jmod, tmod = pipe_tpu.parallel.sharded, parallel.sharded
    assert tmod is parallel.components
    names = [n for n, v in vars(jmod).items() if not n.startswith("_")
             and getattr(v, "__module__", None) == jmod.__name__]
    assert len(names) == 23 and "ShardedOp" in names
    for n in names:
        assert getattr(tmod, n).__module__ == tmod.__name__, n
        assert issubclass(getattr(tmod, n), tmod.ShardedOp), n
    for private in ("_local_shape", "_pad_ir_rows"):
        assert callable(getattr(tmod, private))
    assert PKG / "parallel" / "components.py" in set(PKG.rglob("*.py"))
    assert "sharded" in parallel.__all__


def test_hostsync_is_a_submodule_with_the_jax_names():
    """``pipe_tpu_torch.parallel.hostsync`` is importable as
    ``pipe_tpu.parallel.hostsync`` is, with its public names
    (``HostSync``, ``PeerAbortError``), and the import check above covers
    its file."""
    import importlib

    import pipe_tpu.parallel.hostsync as jmod

    tmod = importlib.import_module("pipe_tpu_torch.parallel.hostsync")
    names = [n for n, v in vars(jmod).items() if not n.startswith("_")
             and getattr(v, "__module__", None) == jmod.__name__]
    assert sorted(names) == ["HostSync", "PeerAbortError"]
    for n in names:
        assert getattr(tmod, n).__module__ == tmod.__name__, n
    assert issubclass(tmod.PeerAbortError, RuntimeError)
    assert PKG / "parallel" / "hostsync.py" in set(PKG.rglob("*.py"))


def test_fp32_pinned_for_cublas_and_cudnn():
    assert config.matmul_precision() == "highest"
    assert config.fp32_pinned()
    with config.matmul_precision_scope("default"):
        assert not config.fp32_pinned()
    assert config.fp32_pinned()
    with config.matmul_precision_scope("high"):  # 3xTF32: the flags allow
        assert config.matmul_precision() == "high"  # TF32, the helpers split
        assert not config.fp32_pinned()
    assert config.fp32_pinned()
    with config.matmul_precision_scope("mixed"):  # five TF32 products
        assert config.matmul_precision() == "mixed"
        assert not config.fp32_pinned()
    assert config.fp32_pinned()
    with pytest.raises(ValueError):
        config.set_matmul_precision("bogus")


def test_resampler_state_continues_across_packages():
    """A JAX Resampler mid-stream at a nonzero phase offset (gather path),
    its state carried into the port with ``tree_from_numpy`` and back with
    ``tree_to_numpy``: the port continues the stream the JAX package would
    have produced, and the round trip keeps keys, dtypes and values."""
    C, B = 2, 100
    jcomp = jops.Resampler(48000, 44100).processor()(None, B, JProps(44100.0, C))
    tcomp = tops.Resampler(48000, 44100).processor()(
        None, B, SignalProperties(44100.0, C))
    rng = np.random.default_rng(40)
    blocks = [rng.standard_normal((C, B)).astype(np.float32) for _ in range(4)]
    jstate, jout = jcomp.state, []
    for x in blocks:
        jstate, sig = jcomp.step(jstate, jcomp.params,
                                 JSignal(jnp.asarray(x), jnp.int32(B)))
        jout.append(np.asarray(sig.data)[:, : int(sig.frames)])
        if len(jout) == 2:
            mid = {k: np.asarray(v) for k, v in jstate.items()}
    assert int(mid["off"]) != 0

    tstate = convert.tree_from_numpy(mid)
    assert isinstance(tstate["off"], int) and tstate["hist"].dtype == torch.float32
    back = convert.tree_to_numpy(tstate)
    assert back.keys() == mid.keys()
    for k in mid:
        assert back[k].dtype == mid[k].dtype
        np.testing.assert_array_equal(back[k], mid[k])

    tout = []
    for x in blocks[2:]:
        tstate, sig = tcomp.step(tstate, tcomp.params,
                                 Signal(torch.from_numpy(x), B))
        tout.append(sig.data.numpy()[:, : sig.frames])
    assert [a.shape for a in tout] == [a.shape for a in jout[2:]]
    assert snr_db(np.concatenate(jout[2:], 1), np.concatenate(tout, 1)) > 110


def test_signal_helpers():
    sig = from_array(np.arange(12.0).reshape(3, 4), frames=3)
    assert sig.data.dtype == torch.float32 and sig.frames == 3
    np.testing.assert_array_equal(to_numpy(sig), np.arange(12.0).reshape(3, 4)[:, :3])
    np.testing.assert_array_equal(sig.masked().data[:, 3].numpy(), 0.0)
    assert from_array(np.ones(5)).data.shape == (1, 5)
    quiet = silence(2, 8)
    assert quiet.frames == 8 and not quiet.data.any()
    with pytest.raises(ValueError):
        SignalProperties(44100.0, 0)


@pytest.mark.parametrize("frames", [8, 5, 0], ids=["full", "partial", "none"])
def test_signal_mask_matches_jax(frames):
    """``Signal.mask`` is the JAX package's ``(1, B)`` mask in the data's
    dtype, on the data's device, and ``masked`` zeroes what it zeroes."""
    x = np.arange(24.0, dtype=np.float32).reshape(3, 8) + 1.0
    sig = from_array(x, frames=frames)
    jsig = JSignal(jnp.asarray(x), jnp.asarray(frames, jnp.int32))
    mask = sig.mask()
    assert mask.shape == (1, 8) and mask.dtype == torch.float32
    assert mask.device == sig.data.device
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jsig.mask()))
    np.testing.assert_array_equal(sig.masked().data.numpy(),
                                  np.asarray(jsig.masked().data))
    f64 = Signal(torch.ones((2, 4), dtype=torch.float64), 3)
    assert f64.mask().dtype == torch.float64


@pytest.mark.parametrize("channels, block", [(1, 1), (2, 8), (3, 512)])
def test_empty_matches_jax(channels, block):
    """``signal.empty``: the JAX package's EOF placeholder, a zero block
    with no valid frame, on the device given (as ``silence``)."""
    from pipe_tpu import signal as jsignal
    from pipe_tpu_torch import signal as tsignal

    got, want = tsignal.empty(channels, block), jsignal.empty(channels, block)
    assert got.frames == int(want.frames) == 0
    assert got.data.shape == want.data.shape == (channels, block)
    assert got.data.dtype == torch.float32 and not got.data.any()
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert not got.mask().any()
    assert tsignal.empty(2, 4, device="cpu", dtype=torch.float64).data.dtype == torch.float64
    assert tsignal.silence(2, 4).data.device == got.data.device


@pytest.mark.parametrize(
    "make, setter, key, value",
    [
        (lambda: tops.FIR(np.ones(5) / 5), "set_taps", "taps", np.arange(5.0)),
        (lambda: tops.Resampler(3, 2, taps_per_phase=4), "set_bank", "hp",
         np.ones((3, 4))),
        (lambda: tops.FIRResampler(np.ones(5) / 5, 3, 2, taps_per_phase=4),
         "set_taps", "taps", np.arange(5.0)),
        (lambda: tops.FIRResampler(np.ones(5) / 5, 3, 2, taps_per_phase=4),
         "set_bank", "hp_base", np.ones((3, 4))),
        (lambda: tops.Biquad(tops.design_notch(48000, 50, 5.0)), "set_sos",
         "sos", 2 * tops.design_notch(48000, 60, 5.0)),
        (lambda: tops.ChannelMix(np.ones((1, 2))), "set_matrix", "matrix",
         np.full((1, 2), 0.5)),
        (lambda: tops.Gain(1.0), "set_gain", "gain", 0.25),
    ],
    ids=["fir", "resampler", "fused-taps", "fused-bank", "biquad", "mix", "gain"],
)
def test_setters_replace_params_at_apply(make, setter, key, value):
    """A setter returns a mutation; applying it replaces the live param
    (float32, normalized for SOS) on the param's device."""
    op = make()
    comp = op.processor()(mutable.mutable(), 12, SignalProperties(48000.0, 2))
    before = comp.params[key].clone()
    m = getattr(op, setter)(value)
    assert torch.equal(comp.params[key], before)  # nothing lands before apply
    m.apply()
    want = np.asarray(value, np.float64)
    if key == "sos":
        want = want / want[3]
    got = comp.params[key]
    assert got.dtype == torch.float32 and got.device == before.device
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, got.shape), rtol=1e-6)

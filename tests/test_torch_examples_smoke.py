"""The port's examples must keep running: the twin of
``tests/test_examples_smoke.py`` for ``examples/torch/``. Each script runs
with ``--cpu`` as a subprocess (the mesh ones launch their own gloo ranks)
and must print its JAX twin's checked line and, per process, no launch of
the biquad kernels (the examples' biquads run at 1 or 2 channels, off the
tile gate). Also: the ranks' launcher ends every rank, with a non-zero
exit, when one rank fails mid-stream in a mesh ``Pipe``."""

import importlib.util
import os
import re
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")
LAUNCHES = re.compile(r"kernel launches: iir_tiles (\d+), biquad_section (\d+)")


@pytest.mark.parametrize(
    "script,expect,processes",
    [
        ("reverb_file.py", "wrote", 1),
        ("live_mixing_desk.py", "added live", 1),
        ("mastering_chain.py", "peak after limiter", 1),
        ("sharded_flagship.py", "retuned threshold", 8),
        ("fm_receiver.py", "message correlation", 1),
        ("multihost_stream.py", "host 1: 200 chunks", 4),
        ("odd_shapes_and_fusion.py", "SNR vs oracle", 8),
        ("bursty_network_stream.py", "SNR vs float64 oracle", 4),
    ],
)
def test_example_runs(script, expect, processes, tmp_path):
    args = [sys.executable, os.path.join(EXAMPLES, script), "--cpu"]
    if script == "reverb_file.py":
        args += [str(tmp_path / "in.wav"), str(tmp_path / "out.wav")]
    if script == "sharded_flagship.py":
        args += ["--ranks", "8"]  # the JAX test's 8 virtual devices
    out = subprocess.run(args, capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert expect in out.stdout
    if processes > 1:
        assert "transport: gloo" in out.stdout.splitlines()[0]
    launches = LAUNCHES.findall(out.stdout)
    assert launches == [("0", "0")] * processes, out.stdout


def failing_rank(rank, n_ranks, fail_rank, fail_at):
    """A rank of a 1x4 mesh ``Pipe`` (FIR, health rounds every 4
    dispatches) whose sink fails on ``fail_rank`` at block ``fail_at`` of
    64; every rank prints how its run ended."""
    import numpy as np

    import pipe_tpu_torch
    from pipe_tpu_torch import ops, parallel
    from pipe_tpu_torch.components import Sink, Source
    from pipe_tpu_torch.signal import SignalProperties

    x = np.random.default_rng(0).standard_normal((2, 512 * 64)).astype(np.float32)
    pos, blocks = [0], [0]

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n: pos[0]]

    def receive(block):
        blocks[0] += 1
        if rank == fail_rank and blocks[0] == fail_at:
            raise IOError(f"rank {rank}'s sink failed")

    p = pipe_tpu_torch.Pipe(
        512,
        pipe_tpu_torch.Line(
            source=lambda c, b: Source(output=SignalProperties(44100.0, 2),
                                       feed=feed),
            processors=[parallel.sharded.FIR(
                ops.design_lowpass(63, 4000, 44100)).processor()],
            sink=lambda c, b, props: Sink(receive=receive)),
        mesh=parallel.make_mesh(1, 4), host_sync_every=4)
    p.start()
    try:
        p.wait(60)
    except Exception as e:
        # one write: with unbuffered output print() writes the line and its
        # newline apart, and the ranks' lines interleave in the shared file
        sys.stdout.write(f"rank {rank} ended: {type(e).__name__} from "
                         f"{type(e.__cause__).__name__}\n")
        sys.stdout.flush()
        raise
    print(f"rank {rank} ended: no error", flush=True)


def test_a_failing_rank_ends_every_rank_quickly(tmp_path, capsys):
    """Rank 1's sink raises at block 5: the launcher returns a non-zero
    code with every rank gone well inside 30 s (the group timeout is 60 s),
    each rank having ended by itself at a health round, none killed."""
    spec = importlib.util.spec_from_file_location(
        "_ranks", os.path.join(EXAMPLES, "_ranks.py"))
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    log = tmp_path / "ranks.log"
    t0 = time.monotonic()
    with open(log, "a") as f:  # appends: the ranks' lines never overwrite
        rc = ranks.launch(failing_rank, 4, "gloo", timeout=60, args=(1, 5),
                          stdout=f)
    elapsed = time.monotonic() - t0
    text = log.read_text()
    assert rc != 0, text
    assert elapsed < 30, (elapsed, text)
    assert "killing ranks" not in capsys.readouterr().err
    ended = dict(re.findall(r"rank (\d) ended: (.*)", text))
    assert sorted(ended) == ["0", "1", "2", "3"], text
    assert ended["1"] == "RunError from OSError", text
    for r in ("0", "2", "3"):
        assert ended[r] == "RunError from PeerAbortError", text

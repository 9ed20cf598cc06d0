"""Any-shape mesh placement + whole-line fusion in the PyTorch port.

A 7-channel pipeline at block 501 on a (2 x 4) mesh: neither the channel
count nor the block size fits the mesh, and the pipe handles both —
channels ride zero pad rows (sliced off at the sink), and the block
aggregates to the smallest multiple every stage accepts. optimize=True
collapses the two FIRs into one cascade (the gain stays a cheap standalone
stage); the retune through the ORIGINAL object still lands, on the same
sample on every rank.

The mesh is one process per shard: the script launches its 8 ranks itself
(``_ranks.launch``). The transport is named, never guessed by the library:
``--transport`` overrides the rule ``gloo`` under ``--cpu``, ``nccl`` when
there is a card for every rank, else ``gloo+host`` (ranks sharing a card).

    python examples/torch/odd_shapes_and_fusion.py [--cpu] [--transport T]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

import _ranks

MESH = (2, 4)


def odd_shapes(rank, n_ranks):
    import scipy.signal

    import pipe_tpu_torch
    from pipe_tpu_torch import kernels, mock, ops, parallel
    from pipe_tpu_torch.components import Source
    from pipe_tpu_torch.signal import SignalProperties, snr_db

    mesh = parallel.make_mesh(*MESH)
    C, BLOCK = 7, 501  # 7 channels on 2 shards, block 501 on 4 shards
    rng = np.random.default_rng(0)  # the same stream on every rank
    data = rng.standard_normal((C, BLOCK * 64)).astype(np.float32)
    pos = [0]

    def feed(n):
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0] : pos[0] + n]
        pos[0] += n
        return c

    def src(ctx, block):
        return Source(output=SignalProperties(44100.0, C), feed=feed)

    h1 = ops.design_lowpass(63, 8000.0, 44100.0)
    h2 = ops.design_lowpass(31, 4000.0, 44100.0)
    f1 = parallel.sharded.FIR(h1)
    f2 = parallel.sharded.FIR(h2)
    g = parallel.sharded.Gain(0.5)
    sink = mock.Sink()

    p = pipe_tpu_torch.Pipe(
        BLOCK,
        pipe_tpu_torch.Line(
            source=src,
            processors=[f1.processor(), f2.processor(), g.processor()],
            sink=sink.sink(),
        ),
        mesh=mesh,
        optimize=True,  # FIR+FIR -> one cascade at build
    )
    if rank == 0:
        print(f"block aggregation: {p._agg} user blocks per dispatch")
        print(f"stages after fusion: {len(p.routes[0].processors)}")
    p.start()
    # retune the SECOND FIR through its original handle: routes to its
    # slot of the fused cascade, lands at a dispatch boundary (every rank
    # pushes the same target)
    p.push(f2.set_taps(ops.design_lowpass(31, 2000.0, 44100.0)),
           at_block=8 * p._agg)
    p.wait(300)

    out = sink.values  # every rank's sink receives the whole output
    o = data.astype(np.float64)
    o = scipy.signal.lfilter(np.asarray(h1), [1.0], o, axis=1)
    a = scipy.signal.lfilter(np.asarray(h2), [1.0], o, axis=1)
    b = scipy.signal.lfilter(
        np.asarray(ops.design_lowpass(31, 2000.0, 44100.0)), [1.0], o, axis=1
    )
    s = 8 * p._agg * BLOCK
    oracle = 0.5 * np.concatenate([a[:, :s], b[:, s:]], axis=1)
    snr = snr_db(oracle, out)
    if rank == 0:
        print(f"out {out.shape}, SNR vs oracle: {snr:.1f} dB")
    assert snr > 100, (rank, snr)
    n = kernels.launch_counts()
    # one write, newline included: the ranks share one unbuffered stdout
    print(f"rank {rank} kernel launches: iir_tiles {n['iir_tiles']}, "
          f"biquad_section {n['biquad_section']}\n", end="", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    ap.add_argument("--transport", choices=("nccl", "gloo", "gloo+host"))
    a = ap.parse_args()
    n = MESH[0] * MESH[1]
    transport = a.transport or _ranks.default_transport(a.cpu, n)
    print(f"transport: {transport}  mesh: {MESH[0]}x{MESH[1]}  ranks: {n} "
          f"(one process per shard)", flush=True)
    raise SystemExit(_ranks.launch(odd_shapes, n, transport, timeout=300))


if __name__ == "__main__":
    main()

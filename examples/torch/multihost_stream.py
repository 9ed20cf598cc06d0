"""Multi-process streaming — the full Pipe runtime of the PyTorch port
across a process group.

Run with no arguments and the script launches itself as the 4 ranks of a
global (1 x 4) mesh (``_ranks.launch``, one process per shard, a card
each where there are four, else sharing one; ``--cpu`` for the CPU). The
same program runs unchanged across hosts: give every process its rank,
the world size and the rendezvous address in
``parallel.initialize(address, num_processes, process_id, transport=)``.
The transport is named: ``--transport`` overrides the rule ``gloo`` under
``--cpu``, ``nccl`` when there is a card for every rank, else ``gloo+host``.

Every rank runs the IDENTICAL program: the FIR filter tail crosses every
rank boundary as a halo send/recv on every chunk. The stream carries state
chunk-to-chunk, a ``set_taps`` mutation is pushed with ``at_block=`` so it
lands on the same sample everywhere, and each rank's sink receives the
WHOLE stream (outputs are gathered across ranks). The ranks print as the
two hosts of two devices each that the same mesh would span on a
two-host machine: ranks 0-1 are host 0, ranks 2-3 host 1. First-error-wins
crosses the group via the aligned health rounds of
``pipe_tpu_torch.parallel.hostsync``: a rank that fails ends every rank's
run at the next round.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _ranks

N_RANKS = 4
RANKS_PER_HOST = 2


def stream(rank, n_ranks):
    import numpy as np
    import scipy.signal

    import pipe_tpu_torch
    from pipe_tpu_torch import kernels, mock, ops, parallel
    from pipe_tpu_torch.components import Source
    from pipe_tpu_torch.signal import SignalProperties, snr_db

    mesh = parallel.make_global_mesh(channel_shards=1, time_shards=4)

    C, CHUNK, N_CHUNKS, SWITCH = 2, 512, 200, 100
    h1 = np.asarray(ops.design_lowpass(63, 4000, 44100))
    h2 = h1 * 0.25

    # identical stream on every rank (same seed) — the multi-process contract
    rng = np.random.default_rng(42)
    data = rng.standard_normal((C, CHUNK * N_CHUNKS)).astype(np.float32)
    pos = [0]

    def feed(n):
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0] : pos[0] + n]
        pos[0] += n
        return c

    fir = parallel.sharded.FIR(h1)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        CHUNK,
        pipe_tpu_torch.Line(
            source=lambda ctx, b: Source(
                output=SignalProperties(44100.0, C), feed=feed
            ),
            processors=[fir.processor()],
            sink=sink.sink(),
        ),
        mesh=mesh,
    )
    p.start()
    p.push(fir.set_taps(h2), at_block=SWITCH)  # same sample on every rank
    p.wait(300.0)

    x64 = data.astype(np.float64)
    y1 = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
    y2 = scipy.signal.lfilter(h2, [1.0], x64, axis=1)
    s = SWITCH * CHUNK
    oracle = np.concatenate([y1[:, :s], y2[:, s:]], axis=1)
    snr = snr_db(oracle, sink.values)
    n = kernels.launch_counts()
    # one write, newline included: the ranks share one unbuffered stdout
    print(f"host {rank // RANKS_PER_HOST}: {N_CHUNKS} chunks streamed, SNR "
          f"{snr:.1f} dB (rank {rank})\n"
          f"rank {rank} kernel launches: iir_tiles {n['iir_tiles']}, "
          f"biquad_section {n['biquad_section']}\n", end="", flush=True)
    assert snr > 100, (rank, snr)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    ap.add_argument("--transport", choices=("nccl", "gloo", "gloo+host"))
    a = ap.parse_args()
    transport = a.transport or _ranks.default_transport(a.cpu, N_RANKS)
    print(f"transport: {transport}  mesh: 1x{N_RANKS} (global)  ranks: "
          f"{N_RANKS}, as {N_RANKS // RANKS_PER_HOST} hosts of "
          f"{RANKS_PER_HOST}", flush=True)
    raise SystemExit(_ranks.launch(stream, N_RANKS, transport, timeout=300))


if __name__ == "__main__":
    main()

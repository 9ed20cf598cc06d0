"""Bursty network-style source + live sample-rate conversion, in the
PyTorch port.

A "network receiver" source hands the pipe packets of random size (1..400
frames) — any length a feed returns is accepted. On a (1 x 4) mesh the
executor re-chunks the packets host-side into full dispatch chunks (exact:
repacking changes no sample values). Mid-stream, a 44.1k->48k resampler is
LIVE-INSERTED at an exact chunk boundary on every rank; the downstream FIR
is re-allocated at the new block width with its filter tail carried, so
the stream never glitches.

The mesh is one process per shard: the script launches its 4 ranks itself
(``_ranks.launch``); every rank receives the same packets (the same seed).
The transport is named: ``--transport`` overrides the rule ``gloo`` under
``--cpu``, ``nccl`` when there is a card for every rank, else
``gloo+host`` (ranks sharing a card).

    python examples/torch/bursty_network_stream.py [--cpu] [--transport T]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

import _ranks

MESH = (1, 4)


def bursty(rank, n_ranks):
    import threading
    import time

    import scipy.signal

    import pipe_tpu_torch
    from pipe_tpu_torch import kernels, mock, ops, parallel
    from pipe_tpu_torch.components import Source
    from pipe_tpu_torch.ops.resample import polyphase_design
    from pipe_tpu_torch.signal import SignalProperties, snr_db

    C, CHUNK, N_CHUNKS = 2, 588, 12  # 588: n_local=147 fits 160/147
    N = CHUNK * N_CHUNKS
    rng = np.random.default_rng(5)
    data = rng.standard_normal((C, N)).astype(np.float32)

    # the "network": packets of 1..400 frames, whenever they arrive
    pos = [0]
    packets = [0]
    gate = threading.Event()

    def recv_packet(n):
        if pos[0] >= 2 * CHUNK:
            gate.wait(60)  # simulated stall while we retune the graph
        if pos[0] >= N:
            return None
        take = min(int(rng.integers(1, 401)), n, N - pos[0])
        pkt = data[:, pos[0] : pos[0] + take]
        pos[0] += take
        packets[0] += 1
        return pkt

    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    fir = parallel.sharded.FIR(h)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        CHUNK,
        pipe_tpu_torch.Line(
            source=lambda ctx, b: Source(
                output=SignalProperties(44100.0, C), feed=recv_packet
            ),
            processors=[fir.processor()],
            sink=sink.sink(),
        ),
        mesh=parallel.make_mesh(*MESH),
    )
    p.start()

    # live surgery: convert the stream to 48 kHz from chunk 4 onward
    AT = 4
    handle = p.insert_processor(
        0, 0, parallel.sharded.Resample(48000, 44100).processor(), at_block=AT
    )
    le = p._exec_of_route[0]
    deadline = time.time() + 60
    while le._next_target(0) != AT and time.time() < deadline:
        time.sleep(0.002)
    gate.set()
    assert handle.wait(60) and handle.error is None, handle.error
    p.wait(120)

    # oracle: raw to the cut, polyphase-resampled after, one continuous FIR
    cut = AT * CHUNK
    L, M = 160, 147
    hp64 = polyphase_design(L, M, 32)
    K = hp64.shape[1]
    tail = data.astype(np.float64)[:, cut:]
    n_out = -(-tail.shape[1] * L // M)
    j = np.arange(n_out)
    ph, n0 = (j * M) % L, (j * M) // L
    nidx = n0[:, None] - np.arange(K)[None, :]
    valid = (nidx >= 0) & (nidx < tail.shape[1])
    xg = np.where(
        valid[None], tail[:, np.clip(nidx, 0, tail.shape[1] - 1)], 0.0
    )
    res = np.einsum("cok,ok->co", xg, hp64[ph])
    stream = np.concatenate([data.astype(np.float64)[:, :cut], res], axis=1)
    oracle = scipy.signal.lfilter(h, [1.0], stream, axis=1)

    snr = snr_db(oracle, sink.values)  # every rank's sink has the whole stream
    if rank == 0:
        print(
            f"{packets[0]} packets re-chunked into {N // CHUNK} dispatch "
            f"chunks; 48k conversion landed at chunk {AT}"
        )
        print(f"out {sink.values.shape}, SNR vs float64 oracle: {snr:.1f} dB")
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
    raise SystemExit(_ranks.launch(bursty, n, transport, timeout=300))


if __name__ == "__main__":
    main()

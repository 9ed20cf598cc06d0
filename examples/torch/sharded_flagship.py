"""The flagship 64-channel chain on a mesh of ranks, in the PyTorch port —
the scaling story in ~40 lines.

The port runs a mesh as one process per shard over ``torch.distributed``.
``--ranks N`` (default: the number of cards; 1 under ``--cpu``) picks the
mesh: 2 channel-shards x N/2 time-shards for an even N >= 2, else 1 x N.
One rank is a 1x1 mesh in this process, with no process group; more ranks
are launched by this script, one process each (``_ranks.launch``), with a
named transport: ``--transport`` overrides the rule ``gloo`` under
``--cpu``, ``nccl`` when there is a card for every rank, else ``gloo+host``
(ranks sharing a card). On a laptop:

    python examples/torch/sharded_flagship.py --cpu --ranks 8

runs the same program over 8 ranks (channel and time sharding, halo
send/recv, the mixer's all_reduce).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

import _ranks


def mesh_shape(n):
    ch = 2 if n % 2 == 0 and n >= 2 else 1
    return ch, n // ch


def flagship(rank, n_ranks):
    import torch

    from pipe_tpu_torch import kernels, ops, parallel

    ch, t = mesh_shape(n_ranks)
    mesh = parallel.make_mesh(ch, t)
    C = 64
    chunk = 147 * 32 * t  # divisible by the time axis and the rate ratio
    h = ops.design_lowpass(255, 4000, 44100)
    chain = parallel.ShardedChain(
        mesh,
        [
            parallel.FIRResampleStage(h, 48000, 44100),  # fused bank
            # the compressor sits AFTER the resampler: envelope time
            # constants must use the post-resample rate
            parallel.CompressorStage(threshold_db=-18.0, ratio=4.0,
                                     sample_rate=48000.0),
            parallel.MixStage(np.ones((2, C), np.float32) / C),
        ],
        channels=C,
        chunk_frames=chunk,
    )

    def sync():
        if chain.device.type == "cuda":
            torch.cuda.synchronize(chain.device)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((C, chunk)).astype(np.float32)
    y = chain.step(x)  # warm-up: this rank's block of the output
    sync()
    t0 = time.perf_counter()
    steps = 20
    for _ in range(steps):
        y = chain.step(x)
    sync()  # the clock stops when the card is done
    dt = (time.perf_counter() - t0) / steps
    out = chain.gather(y)  # the global output, on every rank
    if rank == 0:
        print(f"out shape {tuple(out.shape)}  ~{C * chunk / dt / 1e6:.0f} "
              f"Msamples/s")

    # live retune between chunks: a host leaf compared by value, so the
    # next step reads it
    chain.stages[1].params["threshold_db"] = np.float32(-30.0)
    out2 = chain.gather(chain.step(x))
    if rank == 0:
        print("retuned threshold mid-stream; output delta:",
              float((out2 - out).abs().max()) > 0)
    n = kernels.launch_counts()
    # one write, newline included: the ranks share one unbuffered stdout
    print(f"rank {rank} kernel launches: iir_tiles {n['iir_tiles']}, "
          f"biquad_section {n['biquad_section']}\n", end="", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes, one per shard (default: the cards, 1 on the CPU)")
    ap.add_argument("--transport", choices=("nccl", "gloo", "gloo+host"))
    a = ap.parse_args()
    if a.ranks is None:
        import torch

        a.ranks = 1 if a.cpu else max(1, torch.cuda.device_count())
    ch, t = mesh_shape(a.ranks)
    if a.ranks == 1:
        print(f"devices: 1  mesh: {ch} channel-shards x {t} time-shards  "
              f"transport: none (one rank: no process group)", flush=True)
        import pipe_tpu_torch

        if a.cpu:
            pipe_tpu_torch.set_default_device("cpu")
        flagship(0, 1)
        return
    transport = a.transport or _ranks.default_transport(a.cpu, a.ranks)
    print(f"devices: {a.ranks}  mesh: {ch} channel-shards x {t} time-shards  "
          f"transport: {transport} (one process per shard)", flush=True)
    raise SystemExit(_ranks.launch(flagship, a.ranks, transport, timeout=300))


if __name__ == "__main__":
    main()

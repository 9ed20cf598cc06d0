"""Start the ranks of a mesh example: one process per shard.

The port runs a mesh larger than 1x1 as one process per shard over
``torch.distributed``, every rank running the same program. :func:`launch`
starts those processes on this machine and waits for them:

- it takes a free port on 127.0.0.1 for the group's rendezvous;
- it starts one process per rank, each of which selects its device, calls
  ``parallel.initialize(address, num_processes, process_id, transport=)``
  and then ``worker(rank, n_ranks, *args)``;
- it returns the worst of the ranks' exit codes;
- it kills every rank still running once ``timeout`` seconds have passed,
  or ``GRACE_S`` seconds after a rank failed, so that a dead rank never
  leaves the launcher waiting. A mesh ``Pipe``'s health rounds end the
  other ranks well before that; a ``ShardedChain`` has no rounds, and its
  peers would otherwise wait in a collective for the group's timeout.

The transport is always named (:func:`default_transport` gives the rule the
examples follow): ``gloo`` with ``--cpu``, ``nccl`` when there is a card
for every rank, else ``gloo+host`` (ranks that share a card). Rank ``r``
works on ``cuda:(r % device_count)``, or on the CPU under ``gloo``, with
an equal share of this host's cores.

As a program, this file is one rank::

    python _ranks.py <worker file> <worker name> <rank> <n_ranks> <address> <transport> <json args>
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
import traceback

GRACE_S = 10.0  # how long the other ranks may take to end after one failed


def default_transport(cpu: bool, n_ranks: int) -> str:
    """``gloo`` on the CPU, ``nccl`` when every rank has a card of its own,
    else ``gloo+host``; raises where there is no card and no ``cpu``."""
    if cpu:
        return "gloo"
    import torch

    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA card is available: pass --cpu to run on the CPU")
    return "nccl" if cards >= n_ranks else "gloo+host"


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _exit_code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc  # killed by signal n: 128 + n


def launch(worker, n_ranks: int, transport: str, timeout: float, args=(),
           stdout=None) -> int:
    """Run ``worker(rank, n_ranks, *args)`` in ``n_ranks`` processes joined
    over ``transport``; returns the worst exit code (0 when every rank
    succeeded). ``worker`` is a function at the top level of a file;
    ``args`` are JSON values; ``stdout`` (a file) takes the ranks' output
    in place of this process's."""
    path = os.path.abspath(worker.__code__.co_filename)
    address = free_address()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, worker.__name__,
             str(rank), str(n_ranks), address, transport, json.dumps(list(args))],
            stdout=stdout,
        )
        for rank in range(n_ranks)
    ]
    deadline = time.monotonic() + timeout
    failed_at = None
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + GRACE_S):
                late = [r for r, p in enumerate(procs) if p.poll() is None]
                print(f"killing ranks {late}: "
                      + ("time limit" if now > deadline else "a rank failed"),
                      file=sys.stderr, flush=True)
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return max(_exit_code(p.returncode) for p in procs)


def _rank_main(path, name, rank, n_ranks, address, transport, args) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch

    import pipe_tpu_torch
    from pipe_tpu_torch import parallel

    # the ranks share this host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    if transport == "gloo":
        pipe_tpu_torch.set_default_device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        pipe_tpu_torch.set_default_device(device)
    spec = importlib.util.spec_from_file_location("_rank_worker", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    parallel.initialize(address, num_processes=n_ranks, process_id=rank,
                        transport=transport)
    getattr(module, name)(rank, n_ranks, *args)
    parallel.shutdown()


if __name__ == "__main__":
    a = sys.argv[1:]
    try:
        _rank_main(a[0], a[1], int(a[2]), int(a[3]), a[4], a[5], json.loads(a[6]))
    except Exception:  # noqa: BLE001 - reported, then the rank exits
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # leave the group without waiting for peers that died
    sys.stdout.flush()

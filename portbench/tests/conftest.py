"""Shared helpers of the benchmark's own tests: the checkout on the path, and
each cell cut to a size the CPU holds in a second (channels 8, short blocks
and buffers, short filters) for rehearsals, faults and controls."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# per cell: config keys, traffic keys (block sizes keep each cell's path:
# console64's EQ blocks of 2560 pass the tile gate, the live cell's 640 fail it)
SMALL = {
    "console64-render": ({"channels": 8, "lead_frames": 4704},
                         {"block_frames": 2352, "warmup_blocks": 4}),
    "console64-live": ({"channels": 8}, {"warmup_blocks": 16}),
    "reverb16-render": ({"channels": 8, "lead_frames": 8192, "ir": {"taps": 4096, "decay_samples": 800}},
                        {"block_frames": 2048, "warmup_blocks": 4}),
}


def small_cell(name: str, trace: bool = False):
    from portbench import spec

    cell = spec.cell(name, trace)
    cfg, tr = SMALL[name]
    cell.config.update(cfg)
    cell.config["signal"] = dict(cell.config["signal"], buffer_seconds=0.5)
    cell.traffic.update(tr)
    closed = cell.traffic["loop"] == "closed"
    cell.traffic["check"] = {"stretch_blocks": 2 if closed else 8,
                             "period_blocks": 8 if closed else 24, "stretches": 2}
    cell.traffic["trace"] = {"skip_blocks": 2, "blocks": 4}
    return cell


@pytest.fixture
def cpu_port():
    import pipe_tpu_torch

    pipe_tpu_torch.set_default_device("cpu")
    yield
    pipe_tpu_torch.set_default_device(None)
    pipe_tpu_torch.config.set_matmul_precision("highest")

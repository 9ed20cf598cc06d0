"""Scaling layer: meshes, halo exchange, and the sharded chunk runner.

The counterpart of :mod:`pipe_tpu.parallel`:

- **channel axis** = data parallelism: channels sharded over ranks;
  per-channel ops need no communication; the merged mixer sink reduces with
  an ``all_reduce`` over the axis.
- **time axis** = sequence parallelism: a long chunk is split into
  contiguous time-blocks, one per rank; stateful ops receive their left
  neighbour's trailing samples (filter tails) as a *halo*, a send/receive
  pair inside the time row.
- IIR recurrences cross rank boundaries through an exclusive prefix over
  the mesh: per-rank affine totals (tiny 2x2 matrices) are all-gathered and
  combined, so even feedback filters shard over time.

**One process per shard.** JAX's mesh is one program over many devices
(``shard_map``). Here every shard is a process of its own over
``torch.distributed`` (NCCL between cards, gloo on the CPU), and every rank
runs the same program, as the JAX package's own multi-host mode does. One
process driving several cards would launch every shard's small ops from one
Python thread, and the port's dispatch is host-bound already. A stage's
``apply`` therefore sees its local block and calls collectives, a near
line-for-line counterpart of the JAX package's. What follows from it:

- a mesh larger than 1x1 needs ``initialize(address, num_processes,
  process_id, transport=...)`` in every process first; a 1x1 mesh needs no
  process group;
- ``ShardedChain.step`` takes the global chunk (or this rank's block through
  ``shard_host_chunk``) and returns this rank's block of the output;
  ``gather``/``process`` assemble the global output on every rank;
- every rank makes the same calls in the same order; shape errors depend on
  global shapes only, so all ranks raise alike; groups carry a timeout, so
  a rank whose peer died raises instead of hanging.

Every module of the JAX package's ``parallel`` is ported: ``mesh``,
``meshctx``, ``distributed``, ``halo``, all of ``chain`` (the
``ShardedChain`` with the 22 stages of the JAX package), ``components``,
exported as ``sharded`` (the 22 op classes that put those stages behind
``Line``/``Pipe(mesh=...)``/``run(mesh=...)``), and ``hostsync``: the
aligned health rounds of a mesh ``Pipe``, with which a rank that fails, is
stopped or pushes late ends every rank's run at the next round instead of
the group timeout, an untargeted push lands on the same block on every
rank, and live surgery on a mesh line adopts at the same block everywhere.
"""

from pipe_tpu_torch.parallel.mesh import make_mesh, Mesh, P, CH_AXIS, TIME_AXIS
from pipe_tpu_torch.parallel.halo import halo_from_left, last_shard
from pipe_tpu_torch.parallel.distributed import (
    initialize,
    shutdown,
    make_global_mesh,
    shard_host_chunk,
)
from pipe_tpu_torch.parallel.meshctx import mesh_scope, current_mesh
from pipe_tpu_torch.parallel import components as sharded
from pipe_tpu_torch.parallel import hostsync
from pipe_tpu_torch.parallel.chain import (
    ShardedChain,
    Stage,
    GainStage,
    FIRStage,
    FIRCascadeStage,
    FIRResampleStage,
    OLSStage,
    OLSGainStage,
    ResampleStage,
    BiquadStage,
    CompressorStage,
    SpectralGainStage,
    SpectralGateStage,
    MixStage,
    DelayStage,
    GateStage,
    LimiterStage,
    ChannelizerStage,
    IQMixStage,
    EnvelopeDetectorStage,
    FMDiscriminatorStage,
    FIRGainStage,
    MixGainStage,
    BiquadCascadeStage,
)

__all__ = [
    "make_mesh",
    "Mesh",
    "P",
    "initialize",
    "shutdown",
    "make_global_mesh",
    "shard_host_chunk",
    "CH_AXIS",
    "TIME_AXIS",
    "halo_from_left",
    "last_shard",
    "mesh_scope",
    "current_mesh",
    "sharded",
    "hostsync",
    "ShardedChain",
    "Stage",
    "GainStage",
    "FIRStage",
    "FIRCascadeStage",
    "FIRResampleStage",
    "OLSStage",
    "OLSGainStage",
    "ResampleStage",
    "BiquadStage",
    "CompressorStage",
    "SpectralGainStage",
    "SpectralGateStage",
    "MixStage",
    "DelayStage",
    "GateStage",
    "LimiterStage",
    "ChannelizerStage",
    "IQMixStage",
    "EnvelopeDetectorStage",
    "FMDiscriminatorStage",
    "FIRGainStage",
    "MixGainStage",
    "BiquadCascadeStage",
]

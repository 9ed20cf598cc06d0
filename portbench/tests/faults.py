"""Faults to plant under the timed path, for the check's own tests. Each
takes a ``patch(obj, name, value)``, as pytest's ``monkeypatch.setattr``."""

from pipe_tpu_torch.runtime.executor import LineExecutor
from pipe_tpu_torch.signal import Signal


def state_unchanged(patch):
    """Every processor's step returns its state unchanged."""
    sweep = LineExecutor._sweep_scoped

    def broken(self, fed, commit):
        before = [p.state for p in self.route.processors]
        blk = sweep(self, fed, commit)
        for p, s in zip(self.route.processors, before):
            p.state = s
        return blk

    patch(LineExecutor, "_sweep_scoped", broken)


def half_batch(patch):
    """Half of each block's channels left out, the rest counted twice."""
    to_device = LineExecutor._fed_to_device

    def broken(self, host):
        x = to_device(self, host).clone()
        h = x.shape[0] // 2
        x[h:] = 0.0
        x[:h] *= 2.0
        return x

    patch(LineExecutor, "_fed_to_device", broken)


def altered_answer(patch):
    """One sample of every output block altered where it is produced."""
    stage = LineExecutor._stage

    def broken(self, sig, eof):
        data = sig.data.clone()
        data[0, min(sig.frames, data.shape[1]) // 2] += 0.05
        return stage(self, Signal(data, sig.frames), eof)

    patch(LineExecutor, "_stage", broken)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, altered_answer)}

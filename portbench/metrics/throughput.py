"""Input channel-samples whose output reached the sink in the window, per
second of the window (host clock, closed after the device synchronized), in
millions."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.channels * run.block_frames * run.blocks_received / run.window_s / 1e6

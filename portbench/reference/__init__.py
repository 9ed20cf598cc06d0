"""The benchmark's plain reference: the chains' mathematics in NumPy float64.

It imports nothing of the program under test (``pipe_tpu_torch``) and nothing
of JAX. Whatever the program derives from its inputs (the polyphase bank, the
partition spectra of an impulse response) is worked out here again, from the
same inputs the harness hands to both sides.
"""

from portbench.reference.dsp import (  # noqa: F401
    biquad_cascade,
    convolve,
    mix,
    polyphase_bank,
    resample,
    tf32,
)

"""The rule that picks a switched step's body for a count, on the host.

``core`` (the compaction capacity of a dirty count,
:func:`repro_torch.core.sparse.bucket_capacity`) and ``engine`` (the
switched step's host pick, :meth:`repro_torch.engine.capture.Switched.
run_eager`) both call it; it imports neither.  ``pick_bucket_kernel``
(``kernels/csrc/graph_switch.cu``) applies the same rule on the device.
"""
from typing import Sequence


def pick(count: int, caps: Sequence[int]) -> int:
    """The index of the body a count picks: the first capacity at or above
    it, the last past the end."""
    return next((i for i, c in enumerate(caps) if c >= count),
                len(caps) - 1)

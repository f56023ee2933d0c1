"""What the sublayer metrics read: the model's marks inside the forward.

The program's model launches an empty kernel at the start of each of its
sublayers (`repro_torch.kernels.marks.SUBPHASES`: each attention
sublayer by its layer's kind, each MoE sublayer, the final norm and LM
head). Under remat a layer's forward runs again inside the backward, and
its marks with it, so only the marks between the forward's phase mark
and the backward's are read. A sublayer lasts from its mark's start to
the next mark's start, the last to the backward's mark.

A program without such marks (an older checkout) gives nothing to read:
the readers return None.
"""
from __future__ import annotations

from bench import phases


def forward_ms(trace, names) -> float | None:
    """The mean device milliseconds a traced step's forward spent in the
    sublayers of `names` (kinds of `SUBPHASES`), summed; None where the
    window holds no phase marks or no such sublayer."""
    marks = phases._marks()
    subphases = getattr(marks, "SUBPHASES", None)
    starts = phases.mark_starts(trace)
    if subphases is None or starts is None:
        return None
    kind = {marks.kernel_name(p): p for p in subphases}
    found = [(start, kind[name]) for name, start, _ in trace.ops
             if name in kind]
    total, seen = 0.0, False
    for s in starts:
        fwd, bwd = s[0], s[1]
        inside = sorted(m for m in found if fwd <= m[0] < bwd)
        ends = [m[0] for m in inside[1:]] + [bwd]
        for (start, p), end in zip(inside, ends):
            if p in names:
                total += end - start
                seen = True
    if not seen:
        return None
    return 1e-3 * total / len(starts)

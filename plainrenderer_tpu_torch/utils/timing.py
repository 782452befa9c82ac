"""CUDA-event marks at the frame's pass boundaries.

render_frame(..., timer=PassTimer()) records one event where each pass
starts and one at the end of the frame; intervals() then gives device
milliseconds per pass name (a name that occurs twice, like the sky LUT
bake and the sky composite, sums). With timer=None nothing is recorded.
"""

from __future__ import annotations

import torch


class PassTimer:
    def __init__(self):
        self.marks: list[tuple[str, torch.cuda.Event]] = []

    def mark(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def intervals(self) -> dict[str, float]:
        """Pass name -> ms between its mark and the next one; 'frame' is
        the first mark to the last. Synchronises on the last event."""
        if len(self.marks) < 2:
            return {}
        self.marks[-1][1].synchronize()
        out: dict[str, float] = {}
        for (name, ev), (_, nxt) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + ev.elapsed_time(nxt)
        out["frame"] = self.marks[0][1].elapsed_time(self.marks[-1][1])
        return out

"""What a window's sessions produced, in host memory: counts of frames,
and per session the answers the correctness check judges (trajectory and
ground truth, the map)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

MAP_KEYS = ("kf_pose", "kf_valid", "kf_frame_id", "kf_uv", "kf_obs_pt",
            "pt_pos", "pt_valid")


def map_arrays(m) -> Dict[str, np.ndarray]:
    """The map fields the reference reads, copied to the host."""
    return {k: getattr(m, k).detach().cpu().numpy() for k in MAP_KEYS}


@dataclass
class Outcome:
    attempted: int = 0
    posed: int = 0
    failed: int = 0
    sessions: List[dict] = field(default_factory=list)

    def add_session(self, finished: bool, attempted: int, posed: int,
                    failed: int, **answers) -> None:
        self.attempted += attempted
        self.posed += posed
        self.failed += failed
        self.sessions.append(dict(finished=finished, attempted=attempted,
                                  posed=posed, failed=failed, **answers))

    def counter(self, name: str) -> Optional[float]:
        vals = [s["counters"][name] for s in self.sessions
                if name in s.get("counters", {})]
        return float(sum(vals)) if vals else None

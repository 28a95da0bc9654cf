"""Train-state checkpoints: save / latest / restore over ``torch.save``.

A checkpoint is one file ``epoch_<N>.pt`` under the directory holding
whatever state dict the trainer gives (models, BatchNorm statistics,
optimizer moments, step, generator state); the newest ``max_to_keep`` are
kept.  Files are written to a temporary name and renamed, so a run cut
during a save leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"epoch_{step:06d}.pt")

    def steps(self) -> List[int]:
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> str:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default the latest), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

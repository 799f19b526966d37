"""Step-level training checkpoint/resume (counterpart of
``utils/checkpoint.py``'s ``TrainingCheckpointer``).

The GBDT trainer saves its booster every ``checkpoint_interval``
iterations under ``checkpoint_dir`` and resumes from the newest step.
The layout is the JAX package's, so either package resumes the other's
run: ``<dir>/step_<NNNNNNNN>/`` holding the payload files (the GBDT
trainer writes ``booster.txt`` and ``meta.json``) and ``<dir>/LATEST``
naming the newest step. A step is written to a temporary directory and
renamed into place, and ``LATEST`` is replaced last, so a crash in the
middle of a write never leaves a half-written step as the resumable one.
Only the newest ``keep`` steps stay on disk.

The JAX package's ``ShardedCheckpointer`` (orbax, a device mesh) waits
for the multi-device slice (ROADMAP.md slice 6).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple, Union

import numpy as np

__all__ = ["TrainingCheckpointer"]

Payload = Dict[str, Union[bytes, str, dict, np.ndarray]]


class TrainingCheckpointer:
    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, payload: Payload) -> None:
        """Write ``payload`` ({file name: bytes, text, array (.npy) or a
        JSON value}) as step ``step``, then point ``LATEST`` at it."""
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            for name, value in payload.items():
                path = os.path.join(tmp, name)
                if isinstance(value, bytes):
                    with open(path, "wb") as f:
                        f.write(value)
                elif isinstance(value, str):
                    with open(path, "w") as f:
                        f.write(value)
                elif isinstance(value, np.ndarray):
                    np.save(path if path.endswith(".npy") else path + ".npy",
                            value, allow_pickle=False)
                else:
                    with open(path, "w") as f:
                        json.dump(value, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        # LATEST is replaced last: readers never see a half-written step
        latest_tmp = os.path.join(self.directory, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))
        self._prune()

    def _steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _prune(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            step = int(f.read().strip())
        return step if os.path.isdir(self._step_dir(step)) else None

    def latest(self) -> Optional[Tuple[int, Dict[str, str]]]:
        """(step, {file name: absolute path}) of the newest step, or
        None."""
        step = self.latest_step()
        if step is None:
            return None
        d = self._step_dir(step)
        return step, {name: os.path.join(d, name) for name in os.listdir(d)}

    @staticmethod
    def read_text(path: str) -> str:
        with open(path) as f:
            return f.read()

    @staticmethod
    def read_json(path: str) -> dict:
        with open(path) as f:
            return json.load(f)

# The port's own copy of tst/aux/log.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Structured JSONL event logging (SURVEY.md §5 metrics/observability)."""

from __future__ import annotations

import json
import os
import time
from typing import Any


class JsonlLogger:
    """One JSON object per line in ``<out_dir>/events.jsonl``; stdout echo
    optional. Cheap enough to call from training loops (host side, async
    metric fetches only)."""

    def __init__(self, out_dir: str, echo: bool = False, filename: str = "events.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self.echo = echo
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, **fields: Any) -> None:
        fields.setdefault("t", round(time.time() - self._t0, 3))
        line = json.dumps(fields, default=float)
        self._f.write(line + "\n")
        if self.echo:
            print(line)

    def close(self) -> None:
        self._f.close()

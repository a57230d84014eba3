"""Run-directory logging: a flushed text log and JSONL metrics (port of
dpdist_tpu/train/logging.py).

A run directory holds the serialised config, a flushed log_<name>.txt and
metrics.jsonl with one JSON object of scalars per call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Optional


class RunLogger:
    def __init__(self, run_dir: str, *, config_json: Optional[str] = None,
                 echo: bool = True, name: str = "train"):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.echo = echo
        self._log = open(os.path.join(run_dir, f"log_{name}.txt"), "a")
        self._metrics = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if config_json is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                f.write(config_json)
            self.log(f"config written to {run_dir}/config.json")
        # Provenance: the code revision, where the package sits in a git checkout.
        try:
            rev = subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)), timeout=5,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            rev = ""
        if rev:
            self.log(f"code revision: {rev}")

    def log(self, msg: str):
        self._log.write(msg + "\n")
        self._log.flush()
        if self.echo:
            print(msg)
            sys.stdout.flush()

    def metrics(self, step: int, **scalars: Any):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()

    def close(self):
        self._log.close()
        self._metrics.close()

"""A remote env runner that also reports its process (import guard
tests): pickled by reference from this module, so its worker imports
the port's rllib and nothing of the test that made it."""
from __future__ import annotations

import os
import sys

from .algorithm import _RemoteRunner


class ProbedRunner(_RemoteRunner):
    """_RemoteRunner with a report of the process it runs in."""

    def probe(self):
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(self.runner.device),
                "modules": sorted(sys.modules)}

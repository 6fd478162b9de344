"""Small stand-ins of the benchmark's cells for the CPU, and the card fixture."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = dict(num_user=300, num_item=200, batch_size=64, eval_user_chunk=128)


def small_cell(name: str):
    """The manifest's cell at 300 users and 200 items, on the same graph path
    as at its full size (the segment graph where the catalog is past
    ``dense_prop_threshold``)."""
    import torch

    from benchmark.harness import manifest

    torch.set_num_threads(2)
    cell = manifest.load_cell(name)
    config = json.loads(json.dumps(cell.config))
    full = cell.traffic["num_user"] * cell.traffic["num_item"]
    if full > config["precision"]["dense_prop_threshold"]:
        config["precision"]["dense_prop_threshold"] = 0
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALL), config=config)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")

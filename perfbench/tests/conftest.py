"""Shared pieces of the benchmark's own tests: a tiny configuration of the
flagship's kind, and the ``gpu`` marker's skip, decided inside a fixture."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def load_config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def tiny_config(use_vit=True):
    """The flagship's file cut to a size the CPU runs in a second, in fp32."""
    cfg = load_config("hvs_flagship")
    cfg.update(dtype="fp32", base_channels=8, stage_blocks=[1, 2, 1, 1],
               stage_channels=[16, 32, 32, 64], use_vit=use_vit, vit_dim=32, vit_depth=1,
               vit_heads=2, fpn_channels=32, head_channels=32, feature_dim=32, num_classes=6,
               sinkhorn_iterations=5)
    return cfg


def load_traffic(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())


@pytest.fixture
def detections_check():
    """The check of the serve cells, loaded as the harness loads it."""
    sys.path.insert(0, str(ROOT / "perfbench"))
    import run

    return run.load_file(ROOT / "perfbench" / "checks" / "detections.py")

"""The benchmark's own tests (run by hand: `python -m pytest
portbench/tests -q`). Card-only tests carry the `card` marker and skip
where no CUDA device is present; they decide so inside the test."""

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small stand-ins of the cells' scenes: the bunny stand-in keeps more than
# 512 triangles, so render_surface still takes the BVH path
SMALL_SCENE = {"bunny_standin": {"seed": 0, "bands": 24}}
FILM = (32, 32)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def small_cell():
    """load_cell(name) with the configuration's scene cut to its test
    size and the traced window cut to two frames."""
    from portbench import harness

    def load(name):
        cell = harness.load_cell(name)
        cell.config = copy.deepcopy(cell.config)
        if cell.config_name in SMALL_SCENE:
            cell.config["scene_args"] = SMALL_SCENE[cell.config_name]
        cell.traffic = dict(cell.traffic, trace_frames=2, trace_steps=2,
                            warmup_frames=1,
                            warmup_seconds=0.0)
        return cell

    return load


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

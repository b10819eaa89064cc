"""A run of each cell, on the CPU at a small film, with the timed path
broken underneath: `correct` must come out false for each fault the cell
can have (one chip: no exchange between chips to leave out)."""

import pytest
import torch

from portbench import run as bench

RENDER = {"bunny_standin.resident_orbit": ("gravit_tpu_torch.render.tracer",
                                           "trace_image_fast"),
          "gvt_simple.api_orbit": ("gravit_tpu_torch.render.renderer",
                                   "render_surface"),
          "bunny_standin.api_orbit": ("gravit_tpu_torch.render.renderer",
                                      "render_surface")}


def _stale(orig):
    """Every frame after the first returns the first frame's answer."""
    first = []

    def fn(*a, **kw):
        if not first:
            first.append(orig(*a, **kw))
        return first[0].clone()
    return fn


def _brighter(orig):
    """The answer altered where it is produced: rgb 2% higher."""
    def fn(*a, **kw):
        fb = orig(*a, **kw)
        return torch.cat([fb[:, :3] * 1.02, fb[:, 3:]], dim=1)
    return fn


def _half_rays(monkeypatch):
    """Half of the batch left out: the second half of the camera rays
    never traced."""
    from gravit_tpu_torch.scene.camera import PerspectiveCamera

    orig = PerspectiveCamera.generate_rays

    def gen(self, *a, **kw):
        rays = orig(self, *a, **kw)
        keep = torch.arange(rays.capacity, device=rays.active.device) \
            < rays.capacity // 2
        return rays.replace(active=rays.active & keep)
    monkeypatch.setattr(PerspectiveCamera, "generate_rays", gen)


def _run(cell):
    res = bench.run_cell(cell, 2**31 + 3, 2.0, False, device="cpu",
                         film=(32, 32))
    assert res["attempted"] >= 2
    return res


@pytest.mark.parametrize("name", sorted(RENDER))
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_render_fault_is_not_correct(small_cell, monkeypatch, name, fault):
    import importlib

    cell = small_cell(name)
    module, attr = RENDER[name]
    mod = importlib.import_module(module)
    if fault == "half":
        _half_rays(monkeypatch)
    else:
        wrap = _stale if fault == "stale" else _brighter
        monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_fault_is_not_correct(small_cell, monkeypatch, fault):
    from gravit_tpu_torch.render import train

    cell = small_cell("gvt_simple.train")
    if fault == "unchanged":
        orig = train.make_train_step

        def make(*a, **kw):
            step, opt = orig(*a, **kw)

            def frozen(p, o, scene, arena, target):
                loss = train.loss_fn(p, scene, arena, target, 32, 32,
                                     cell.traffic["rounds"])
                loss.backward()      # the state is never updated
                o.zero_grad()
                return p, o, loss.detach()
            return frozen, opt
        monkeypatch.setattr(train, "make_train_step", make)
    else:
        orig_loss = train.loss_fn

        def loss_fn(p, scene, arena, target, w, h, rounds=4):
            if fault == "altered":
                return orig_loss(p, scene, arena, target, w, h, rounds) * 1.02
            fb = train.render_with_params(scene, p, arena, w, h, rounds)
            half = fb.shape[0] // 2
            return torch.mean((fb[:half, :3] - target[:half, :3]) ** 2)
        monkeypatch.setattr(train, "loss_fn", loss_fn)
    res = _run(cell)
    assert not res["correct"], res["checks"]

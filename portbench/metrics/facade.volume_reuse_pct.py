"""Share of the traced window's api volume renders that reused the facade's
kept volume build: 100 x `facade.volume_scene_reused` spans /
(`facade.volume_scene_reused` + `facade.volume_scene_build` spans), the
program's spans around the hit and the miss of render/renderer.py's volume
scene cache. None where neither is recorded (a program without the
cache)."""

from portbench.metrics._spans import recorded

NEEDS = ("profile",)


def read(trace):
    spans = recorded()
    if spans is None:
        return None
    reused = sum(s.name == "facade.volume_scene_reused" for s in spans)
    built = sum(s.name == "facade.volume_scene_build" for s in spans)
    if reused + built == 0:
        return None
    return 100.0 * reused / (reused + built)

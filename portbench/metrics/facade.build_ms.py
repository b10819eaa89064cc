"""Host ms per frame spent in the facade's per-render builds: the spans
around build_scene and build_scene_bvh where render/renderer.py's
render_surface calls them, each ended by a sync."""

NEEDS = ("spans",)
SPANS = {"facade.build_scene": ("gravit_tpu_torch.render.renderer",
                                "build_scene"),
         "facade.build_scene_bvh": ("gravit_tpu_torch.render.renderer",
                                    "build_scene_bvh")}


def read(trace):
    if not trace.spans:
        return None
    return 1e3 * sum(trace.spans.values())

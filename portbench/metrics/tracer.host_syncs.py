"""Host syncs per frame, by torch.cuda's sync debug mode."""

NEEDS = ("syncs",)


def read(trace):
    return trace.syncs_per_frame

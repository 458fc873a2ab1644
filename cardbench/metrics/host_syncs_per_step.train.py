"""Host syncs the program makes per training step (sync debug mode's
warnings in the program's own lines, over the traced window's steps)."""


def read(r):
    if r.runner != "train" or not r.window.units:
        return None
    return len(r.profile.syncs) / r.window.units

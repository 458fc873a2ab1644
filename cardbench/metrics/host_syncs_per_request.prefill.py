"""Host syncs the program makes per prefill request (sync debug mode's
warnings in the program's own lines; the benchmark's own read of the first
token is not counted)."""


def read(r):
    if r.runner != "prefill" or not r.window.units:
        return None
    return len(r.profile.syncs) / r.window.units

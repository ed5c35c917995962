"""Keys sorted in the window over the window's whole time (host clock)."""


def read(run):
    if run.window_s <= 0 or not run.call_ms:
        return None
    return run.keys_per_call * len(run.call_ms) / run.window_s

"""Users whose top-k list came back to the host, over the window's host-clock seconds."""
UNIT = "users/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    users = run.counts.get("users")
    return users / run.window_s if users else None

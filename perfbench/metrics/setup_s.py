"""Seconds from the process's start to the first timed sweep or call.

Imports, the card's start, the data or posterior made from the seed, the
program's build and upload, kernel builds on a checkout's first run, and
the warm-up of every shape the window uses.
"""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s

"""Seconds from the process's start to the first timed frame or step:
imports, the scene and its builds, kernel builds, the warm-up."""

NEEDS = ("window",)


def read(window):
    return window.setup_s

"""Frozen scene generators: each module's `scene(**args)` returns the
geometry of one deployment as plain numpy (see scenes/common.py). They are
copies, so that a change to the program cannot move the yardstick."""

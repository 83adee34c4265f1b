"""Frozen copies of the yardstick: what a later change to the program may
not move. Each module names the file and commit it was copied from."""

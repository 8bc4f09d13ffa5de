"""Roofline work counts and the card's peaks.

The counts are of the algorithm's work on the cell's inputs, never of a
kernel's own code, so a rewritten kernel is measured against the same
yardstick.  Imports nothing of the program."""

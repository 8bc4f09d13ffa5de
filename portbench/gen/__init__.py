"""Traffic generation from ``--seed``: the wire of a session and the
files of an import.  Imports nothing of the program."""

"""Controls: the plain reference put in the program's place with one
guarantee of the configuration broken.  A control's run has to come out
``correct: false``: ``python3 portbench/run.py --workload CELL --seed N
--seconds S --trace 0 --control NAME`` (``SYSTEMS`` of
``controls/<driver>.py`` names them)."""

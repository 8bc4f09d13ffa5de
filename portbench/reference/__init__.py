"""The plain reference that decides ``correct``.

Plain NumPy, PyTorch and ``hashlib``: it imports neither JAX, nor the
JAX package, nor anything of ``dat_replication_protocol_tpu_torch``, and
takes nothing the program made.  It works every answer out again from
the inputs the benchmark made (``gen/``) and handed to both sides, once
for each distinct input of a run.
"""

#!/usr/bin/env python3
"""The JAX package's content addressing of chip_smoke.py's phase-7 blob.

    JAX_PLATFORMS=cpu python3 cdc_reference_witness.py

Makes the 1.5 GiB blob that ``chip_smoke.py`` phase 7 makes from its seed,
and the same edited copy (three 100-byte inserts, one 1 KiB delete), runs
the JAX package's ``content_address`` on both and prints one JSON line:
the chunk counts, both roots and the length of ``delta``.  These are the
reference figures that ``chip_smoke.py`` holds the port to
(``REFERENCE``).  On a CPU backend the JAX package takes its native host
route; the run needs about 4 GiB of host memory.
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from dat_replication_protocol_tpu.runtime import content  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    blob = chip_smoke.make_blob(chip_smoke.CONTENT_BYTES)
    edited = chip_smoke.edit_blob(blob)
    sizes = (chip_smoke.CDC_AVG_BITS, chip_smoke.CDC_MIN, chip_smoke.CDC_MAX)
    old = content.content_address(blob, *sizes)
    new = content.content_address(edited, *sizes)
    print(json.dumps({
        "chunks": old.nchunks, "edited_chunks": new.nchunks,
        "delta": len(content.delta(old, new)), "root": old.root.hex(),
        "edited_root": new.root.hex(),
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()

"""chip_smoke.py's SASS walk, which gives kernels B3-B6 their operation
bound, on small hand-written listings in ``cuobjdump -sass`` format."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

HEAD = "\t\tFunction : _ZN12_GLOBAL__N_18k_kernelEPKj\n"


def _listing(lines):
    return HEAD + "".join(f"        /*{16 * i:04x}*/ {ins} ;"
                          f"   /* 0x000000000000 */\n"
                          for i, ins in enumerate(lines))


# 0x00-0x20: guard; 0x30: fast division path over a CALL; 0x60: warm-up
# skip over 0x70-0x80; 0x90-0xb0: a loop; 0xd0: the slow path's
# subroutine, never reached
STRAIGHT = ["ISETP.GE.AND P0, PT, R0, R1, PT", "@P0 EXIT",
            "IMAD R2, R0, R1, RZ", "@!P0 BRA 0x60", "MOV R0, 0x50",
            "CALL.REL.NOINC 0xd0", "@!P1 BRA 0x90",
            "LOP3.LUT R3, R2, R1, RZ, 0x3c, !PT", "SHF.L.U32 R4, R3, 0x1, RZ"]
LOOP = ["LEA R5, P0, R4, R3, 0x1", "IMAD.MOV.U32 R6, RZ, RZ, R5",
        "@!P2 BRA 0x90"]
TAIL = ["STG.E desc[UR4][R8.64], R5", "EXIT", "RET.REL.NODEC R0 0x0"]


def test_straight_line_kernel_counts_each_pipe():
    load = ["LDG.E R9, desc[UR4][R8.64]"]
    insts = chip_smoke.parse_sass(_listing(STRAIGHT + load + TAIL[1:]),
                                  "k_kernel")
    # the CALL path is skipped, the warm-up runs, the walk ends at EXIT
    assert chip_smoke.sass_path(insts) == {"alu": 3, "fma": 1, "issued": 9}
    assert chip_smoke.sass_path(insts, skip_warm=True) == {
        "alu": 1, "fma": 1, "issued": 7}


@pytest.mark.parametrize("trips", [1, 2, 8])
def test_loop_body_runs_trips_times(trips):
    insts = chip_smoke.parse_sass(_listing(STRAIGHT + LOOP + TAIL), "k_kernel")
    got = chip_smoke.sass_path(insts, trips)
    assert got == {"alu": 3 + trips, "fma": 1 + trips,
                   "issued": 7 + 3 * trips + 2}


def test_loop_and_trips_must_agree():
    looped = chip_smoke.parse_sass(_listing(STRAIGHT + LOOP + TAIL),
                                   "k_kernel")
    with pytest.raises(AssertionError, match="unexpected loop"):
        chip_smoke.sass_path(looped)
    straight = chip_smoke.parse_sass(_listing(STRAIGHT + TAIL[1:]), "k_kernel")
    with pytest.raises(AssertionError, match="loops where one"):
        chip_smoke.sass_path(straight, trips=4)
    with pytest.raises(AssertionError, match="SASS functions match"):
        chip_smoke.parse_sass(_listing(STRAIGHT), "other_kernel")

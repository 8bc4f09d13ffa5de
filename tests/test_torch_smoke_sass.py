"""chip_smoke.py's SASS walks, which give the kernels their operation
bounds and kernel B1 its chain bound, on small hand-written listings in
``cuobjdump -sass`` format."""

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


# 0x20-0xa0: a loop whose dependent path runs IADD3 -> IADD3.X (through
# the carry predicate) -> LOP3 -> SHF -> [SHFL, no step] -> SEL -> ISETP
CHAIN = ["S2R R0, SR_TID.X", "LDG.E R2, desc[UR4][R8.64]",
         "IADD3 R4, P0, R2, R3, RZ", "IADD3.X R5, R6, R7, RZ, P0, !PT",
         "LOP3.LUT R6, R4, R5, RZ, 0x3c, !PT", "SHF.R.W.U32 R7, R6, 0x18, R5",
         "IMAD.MOV.U32 R9, RZ, RZ, R3", "SHFL.IDX PT, R10, R7, 0x1, 0x1c1f",
         "@P0 SEL R11, R10, R9, P1", "ISETP.NE.AND P2, PT, R11, RZ, PT",
         "@P2 BRA 0x20"]


def test_chain_is_the_longest_dependent_path_of_the_loop_body():
    insts = chip_smoke.parse_sass(_listing(CHAIN + TAIL), "k_kernel")
    body = chip_smoke.sass_loop_body(insts)
    assert (body[0][0], body[-1][0]) == (0x20, 0xa0)
    assert chip_smoke.sass_chain(insts) == 6
    # a guard is read too: here only the guard carries the chain to SEL
    guarded = CHAIN[:6] + ["ISETP.GT.AND P3, PT, R7, RZ, PT",
                           "@P3 SEL R11, R9, R9, P1", "@P3 BRA 0x20"]
    insts = chip_smoke.parse_sass(_listing(guarded + TAIL), "k_kernel")
    assert chip_smoke.sass_chain(insts) == 6


def test_chain_takes_the_largest_innermost_loop_and_needs_one():
    small = ["IADD3 R1, R1, 0x1, RZ", "ISETP.NE.AND P0, PT, R1, R2, PT",
             "@P0 BRA 0x0"]
    big = ["LOP3.LUT R3, R3, R4, RZ, 0x3c, !PT",
           "LOP3.LUT R3, R3, R4, RZ, 0x3c, !PT",
           "LOP3.LUT R3, R3, R4, RZ, 0x3c, !PT",
           "LOP3.LUT R5, R3, R4, RZ, 0x3c, !PT", "@P0 BRA 0x30"]
    insts = chip_smoke.parse_sass(_listing(small + big + TAIL), "k_kernel")
    assert len(chip_smoke.sass_loop_body(insts)) == 5
    assert chip_smoke.sass_chain(insts) == 4
    # a loop around both is not innermost: the largest inner one counts
    outer = chip_smoke.parse_sass(
        _listing(small + big + ["@P1 BRA 0x0"] + TAIL), "k_kernel")
    assert len(chip_smoke.sass_loop_body(outer)) == 5
    straight = chip_smoke.parse_sass(_listing(STRAIGHT + TAIL[1:]), "k_kernel")
    with pytest.raises(AssertionError, match="no loop"):
        chip_smoke.sass_chain(straight)


def test_operands_split_written_from_read():
    ops = chip_smoke._sass_operands
    assert ops("IADD3", "R4, P0, P1, R2, R3, R4") == (
        ["R4", "P0", "P1"], ["R2", "R3", "R4"])
    assert ops("IADD3.X", "R5, R6, R7, RZ, P0, !PT") == (
        ["R5"], ["R6", "R7", "P0"])
    assert ops("ISETP.GE.AND", "P0, PT, R0, R1, PT") == (["P0"], ["R0", "R1"])
    assert ops("SHFL.IDX", "PT, R10, R7, 0x1, 0x1c1f") == (["R10"], ["R7"])
    assert ops("LDG.E", "R8, desc[UR4][R2.64]") == (["R8"],
                                                     ["UR4", "R2", "R3"])
    assert ops("STG.E", "desc[UR4][R8.64], R5") == ([], ["UR4", "R8", "R9",
                                                         "R5"])


# 0x00: entry; 0x10-0x60: an outer loop around an inner one (0x20-0x40)
# and an mbarrier wait (0x50-0x60) that spins until a copy lands, as a
# ring fed by bulk copies waits; 0x90: exit
NESTED = ["S2R R0, SR_TID.X", "MOV R1, 0x0", "IADD3 R1, R1, 0x1, RZ",
          "ISETP.NE.AND P0, PT, R1, R2, PT", "@P0 BRA 0x20",
          "SYNCS.PHASECHK.TRANS64.TRYWAIT P2, [R4+URZ], R5",
          "@!P2 BRA 0x50", "LOP3.LUT R3, R3, R1, RZ, 0x3c, !PT",
          "@P1 BRA 0x10", "EXIT"]


@pytest.mark.parametrize("inner,outer", [(1, 1), (3, 2), (4, 5)])
def test_nested_loops_run_their_trips_and_the_wait_once(inner, outer):
    insts = chip_smoke.parse_sass(_listing(NESTED + TAIL[2:]), "k_kernel")
    got = chip_smoke.sass_path(insts, [inner, outer])
    # per outer trip: MOV, the inner body (IADD3, ISETP, BRA) inner times,
    # the wait (SYNCS, BRA) once, LOP3, BRA
    assert got == {"alu": outer * (1 + 2 * inner + 1), "fma": 0,
                   "issued": 2 + outer * (1 + 3 * inner + 2 + 2)}


def test_trips_per_loop_must_match_the_loops():
    insts = chip_smoke.parse_sass(_listing(NESTED + TAIL[2:]), "k_kernel")
    with pytest.raises(AssertionError, match="2 loops where one was"):
        chip_smoke.sass_path(insts, 3)
    with pytest.raises(AssertionError, match="2 loops where 3 were"):
        chip_smoke.sass_path(insts, [2, 2, 2])
    with pytest.raises(AssertionError, match="unexpected loop"):
        chip_smoke.sass_path(insts)
    # a wait loop alone is no loop to give trips to
    wait = ["SYNCS.PHASECHK.TRANS64.TRYWAIT P2, [R4+URZ], R5",
            "@!P2 BRA 0x0", "EXIT"]
    insts = chip_smoke.parse_sass(_listing(wait), "k_kernel")
    assert chip_smoke.sass_path(insts) == {"alu": 0, "fma": 0, "issued": 3}


def test_kernel_instances_are_told_apart_by_their_template_arguments():
    text = ("\t\tFunction : _ZN12_GLOBAL__N_117k_kernelILi1ELi2EEEvPKh\n"
            "        /*0000*/ EXIT ;\n"
            "\t\tFunction : _ZN12_GLOBAL__N_117k_kernelILi2ELi2EEEvPKh\n"
            "        /*0000*/ MOV R1, 0x0 ;\n        /*0010*/ EXIT ;\n")
    with pytest.raises(AssertionError, match="2 SASS functions match"):
        chip_smoke.parse_sass(text, "k_kernel")
    assert len(chip_smoke.parse_sass(text, "k_kernelILi2ELi2E")) == 2

"""``tools/tick_kernel_sass.py``'s readings of the S = 3 tick kernel's
machine code, and ``chip_smoke.ion_sass_faults`` (phase 4c's gate), on a
recorded dump of the plain S = 3 form: ``tests/fixtures/s3_plain.sass``,
``cuobjdump -sass`` of the built ``csrc/fused_ticks.cu`` (sm_90a) with
the instruction encodings stripped, and on copies with one line changed.
Re-record the dump when the kernel changes (the tool and the gate then
read the new code; the pinned numbers move with it)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
import tick_kernel_sass as tks  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "s3_plain.sass")
#: cycles a dependent instruction of each class, as tools/sass_latency.cu
#: measured them on an H100
LAT = {"fma": 4.2509765625, "mnmx": 4.248046875, "sel": 4.124267578125,
       "mufu": 17.1357421875, "imad": 4.2470703125, "other": 4.124267578125}
FORM = "S=3 per_lane_e0=0 per_lane_om=0"


def _text() -> str:
    with open(FIXTURE) as f:
        return f.read()


def _ins(text: str) -> list:
    (ins,) = tks.functions(text).values()
    return ins


def _changed(text: str, old: str, new: str) -> str:
    assert text.count(old) == 1, old
    return text.replace(old, new)


def test_tick_loop_is_the_plain_loop():
    """The largest loop without sincosf: the plain tick loop, not the
    larger beat-note copy (nor the table walk nested in it)."""
    ins = _ins(_text())
    lo, hi = tks.tick_loop(ins)
    assert (ins[lo][0], ins[hi][0]) == (0x0B10, 0x2BE0)
    beat = [(tks._branch_target(t), a) for a, t in ins
            if tks._branch_target(t) is not None
            and tks._branch_target(t) < a]
    assert max(b - a for a, b in beat) > ins[hi][0] - ins[lo][0]


def test_main_path_is_one_tick_without_a_jump():
    ins = _ins(_text())
    path = tks.main_path(ins, tks.tick_loop(ins))
    assert len(path) == 414
    assert sum("MUFU.RSQ" in t for t in path) == 4      # four slopes
    assert path[-1].startswith("@!P1 BRA")               # the back edge


def test_recurrence_and_its_chain():
    ins = _ins(_text())
    path = tks.main_path(ins, tks.tick_loop(ins))
    rec = tks.recurrence(path, LAT)
    assert rec["cycles_per_pass"] == pytest.approx(276.690673828125, rel=1e-12)
    assert rec["carried_registers"] == 24
    chain = tks.chain_listing(path, LAT, rec["registers"][0])
    assert len(chain) == 53
    assert sum(x.startswith("MUFU.RSQ") for x in chain) == 4


def test_analyse_reads_the_recorded_form():
    (r,) = tks.analyse(tks.functions(_text()), LAT).values()
    assert list(tks.analyse(tks.functions(_text()), LAT)) == [FORM]
    assert r["instructions_per_tick"] == 414.0 and r["ticks_per_pass"] == 1
    assert r["roll_loads"] == [] and r["async_copies"] == 5
    assert r["ticks_ahead"] == [3] and r["shuffles_votes"] == 0


def test_roll_loads_sees_a_register_load_on_the_chain():
    """A roll read from device memory into a register inside the loop is
    reported with the slopes between its issue and its first use."""
    text = _changed(_text(), "/*16f0*/ LDS R57, [R22] ;",
                    "/*16f0*/ LDG.E R57, desc[UR12][R22.64] ;")
    ins = _ins(text)
    loads = tks.roll_loads(tks.main_path(ins, tks.tick_loop(ins)))
    assert len(loads) == 1 and loads[0]["slopes_between"] < 4


def test_recorded_dump_passes_the_gate():
    """No fault, though the beat-note loop holds sincosf's table walk (an
    LDG in a loop of its own, without copies)."""
    text = _text()
    assert "LDG.E.CONSTANT R6" in text.split("/*31f0*/")[1]
    assert list(chip_smoke.ion_sass_faults(text).values()) == [[]]


@pytest.mark.parametrize("old,new,fault", [
    ("/*1a20*/ LDS R60, [R22+0x80] ;",
     "/*1a20*/ SHFL.BFLY PT, R60, R22, 0x1, 0x1f ;", "SHFL"),
    ("/*1a20*/ LDS R60, [R22+0x80] ;",
     "/*1a20*/ VOTE.ANY R60, PT, P0 ;", "VOTE"),
    ("/*1a20*/ LDS R60, [R22+0x80] ;",
     "/*1a20*/ LDG.E R60, desc[UR12][R22.64] ;", "LDG in the tick loop"),
    ("/*0da0*/ DEPBAR.LE SB0, 0x3 ;", "/*0da0*/ DEPBAR.LE SB0, 0x0 ;",
     "no roll in flight"),
], ids=["shfl", "vote", "ldg", "depbar0"])
def test_gate_refuses(old, new, fault):
    faults = chip_smoke.ion_sass_faults(_changed(_text(), old, new))
    (f,) = faults.values()
    assert len(f) == 1 and fault in f[0]


def test_gate_refuses_a_loop_without_copies():
    text = "\n".join(line for line in _text().splitlines()
                     if "LDGSTS" not in line)
    (f,) = chip_smoke.ion_sass_faults(text).values()
    assert f == ["no tick loop with cp.async"]


def test_same_code_compares_group_kernels_only():
    name = ("_Z18fused_ticks_kernelILi5ELi8ELb0ELb0ELb0ELb0EEv10TickConsts")
    s3 = ("_Z18fused_ticks_kernelILi3ELi4ELb0ELb0ELb0ELb0EEv10TickConsts")

    def dump(code5, code3):
        return (f"Function : {name}\n/*0000*/ {code5} ;\n"
                f"Function : {s3}\n/*0000*/ {code3} ;\n")

    parent = tks.functions(dump("FADD R1, R2, R3", "MOV R1, R2"))
    assert tks.same_code(tks.functions(dump("FADD R1, R2, R3", "NOP")),
                         parent) == {"S=5 e0=0 om=0 rng=0 long_rows=0": True}
    assert tks.same_code(tks.functions(dump("FMUL R1, R2, R3", "MOV R1, R2")),
                         parent) == {"S=5 e0=0 om=0 rng=0 long_rows=0": False}

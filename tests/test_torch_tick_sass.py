"""``tools/tick_kernel_sass.py``'s readings of the ion tick kernel's
machine code, and ``chip_smoke.ion_sass_faults`` and
``chip_smoke.pattern_issue`` (phase 4c's gates), on recorded dumps:
``tests/fixtures/s3_plain.sass`` (the plain S = 3 form) and
``tests/fixtures/s7_quad_dense.sass`` (the plain S = 7 forms of the
tag408_quad pattern and of the dense one), ``cuobjdump -sass`` of the
built ``csrc/fused_ticks.cu`` (sm_90a) with the instruction encodings
stripped (``tools/tick_kernel_sass.py --fixture``), and on copies with
one line changed.  Re-record a dump when its forms change (the tool and
the gates then read the new code; the pinned numbers move with it)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
import tick_kernel_sass as tks  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "s3_plain.sass")
FIXTURE_S7 = os.path.join(ROOT, "tests", "fixtures", "s7_quad_dense.sass")
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
    """The S = 12 group kernels by name and the S = 3 ion forms by state
    count and flags (the new kernel's name carries its coupling pattern,
    the parent's none); the S = 5 / 7 group forms, which the ion kernel
    replaced, are read by ``analyse_group`` instead."""
    s12 = "_Z18fused_ticks_kernelILi12ELi16ELb0ELb0ELb0ELb0EEv10TickConsts"
    s5 = "_Z18fused_ticks_kernelILi5ELi8ELb0ELb0ELb0ELb0EEv10TickConsts"
    ion = "_Z22fused_ticks_ion_kernelILi3E{}Lb0ELb1EEv10TickConsts"

    def dump(code12, code3, mask=""):
        return (f"Function : {s12}\n/*0000*/ {code12} ;\n"
                f"Function : {s5}\n/*0000*/ MOV R1, R2 ;\n"
                f"Function : {ion.format(mask)}\n/*0000*/ {code3} ;\n")

    parent = tks.functions(dump("FADD R1, R2, R3", "MOV R1, R2"))
    keys = ("S=12 e0=0 om=0 rng=0 long_rows=0", "S=3 ion e0=0 om=1")
    for new, want in ((dump("FADD R1, R2, R3", "MOV R1, R2", "Lm511E"),
                       (True, True)),
                      (dump("FMUL R1, R2, R3", "MOV R1, R2", "Lm511E"),
                       (False, True)),
                      (dump("FADD R1, R2, R3", "NOP", "Lm511E"),
                       (True, False))):
        assert tks.same_code(tks.functions(new), parent) == dict(
            zip(keys, want))


# ---- the S = 7 forms: a compiled pattern and the dense one

QUAD = "S=7 tag408_quad per_lane_e0=0 per_lane_om=0"
DENSE = "S=7 dense per_lane_e0=0 per_lane_om=0"


def _text_s7() -> str:
    with open(FIXTURE_S7) as f:
        return f.read()


def test_s7_readings_of_both_forms():
    """The quad pump's form issues some 44 % fewer instructions a tick than
    the dense form on the same loop, over a shorter chain (four decaying
    states' dp terms where the dense form sums seven); neither shuffles,
    votes or loads a roll into a register; both keep three ticks of rolls
    in flight."""
    forms = tks.analyse(tks.functions(_text_s7()), LAT, tks.pattern_names())
    assert sorted(forms) == sorted([QUAD, DENSE])
    q, d = forms[QUAD], forms[DENSE]
    assert (q["instructions_per_tick"], d["instructions_per_tick"]) == (
        597.0, 1060.0)
    assert q["chain_cycles_per_tick"] == pytest.approx(297.945556640625,
                                                       rel=1e-12)
    assert d["chain_cycles_per_tick"] == pytest.approx(348.957275390625,
                                                       rel=1e-12)
    assert (q["chain_instructions_per_tick"],
            d["chain_instructions_per_tick"]) == (58.0, 70.0)
    assert sum(x.startswith("MUFU.RSQ") for x in q["chain"]) == 4
    for r in (q, d):
        assert r["roll_loads"] == [] and r["async_copies"] == 5
        assert r["ticks_ahead"] == [3] and r["shuffles_votes"] == 0
        assert r["ticks_per_pass"] == 1


def test_s7_dump_passes_both_gates():
    text = _text_s7()
    assert list(chip_smoke.ion_sass_faults(text).values()) == [[], []]
    counts, faults = chip_smoke.pattern_issue(text)
    assert counts == {"S=7 dense e0=0 om=0": 1060.0,
                      "S=7 tag408_quad e0=0 om=0": 597.0}
    assert faults == []


_QUAD_NAME = "ILi7ELm33777066193195024E"
_DENSE_NAME = "ILi7ELm72057594037927935E"


@pytest.mark.parametrize("case", ["swapped", "no_dense"])
def test_pattern_gate_refuses(case):
    """A pattern's form that issues no fewer instructions a tick than the
    dense form (the two names swapped), or one with no dense form to be
    held to, is a fault."""
    text = _text_s7()
    if case == "swapped":
        text = (text.replace(_QUAD_NAME, "@").replace(_DENSE_NAME, _QUAD_NAME)
                .replace("@", _DENSE_NAME))
    else:
        keep, out = True, []
        for line in text.splitlines():
            if line.startswith("Function :"):
                keep = _DENSE_NAME not in line
            if keep:
                out.append(line)
        text = "\n".join(out)
    _, faults = chip_smoke.pattern_issue(text)
    assert len(faults) == 1 and "tag408_quad" in faults[0], faults


def test_tick_loop_prefers_the_loop_without_sincosf():
    """Of the loops holding four MUFU.RSQ, the largest without sincosf's
    2/pi (the ion kernel's plain loop), else the largest with it (the
    group kernel's one loop, whose sincosf a branch skips); loops with
    fewer than four are not tick loops."""
    def fake(loops):
        lines, a = ["Function : f"], 0
        for body in loops:
            start = a
            for t in body:
                lines.append(f"/*{a:04x}*/ {t} ;")
                a += 0x10
            lines.append(f"/*{a:04x}*/ @P0 BRA {start:#x} ;")
            a += 0x10
        return tks.functions("\n".join(lines))["f"]
    rsq = ["MUFU.RSQ R1, R2"] * 4
    trig = [f"FMUL R3, R4, {tks.TWO_OVER_PI}"]
    ins = fake([rsq + trig + ["NOP"] * 5, rsq, ["NOP"] * 20])
    lo, hi = tks.tick_loop(ins)
    assert hi - lo == 4                        # the plain four-slope loop
    ins = fake([rsq + trig + ["NOP"] * 5, ["NOP"] * 20])
    lo, hi = tks.tick_loop(ins)
    assert hi - lo == 10                       # only the one with sincosf


def test_shuffles_and_votes_are_charged_their_latency():
    """SHFL and VOTE have probes of their own; a shuffle writes its second
    operand (the first is its predicate)."""
    assert tks.opcode_class("SHFL.BFLY") == "shfl"
    assert tks.opcode_class("SHFL.IDX") == "shfl"
    assert tks.opcode_class("VOTE.ANY") == "vote"
    assert {"shfl", "vote"} <= set(tks.PROBES)
    op, dests, srcs = tks.parse("SHFL.BFLY PT, R5, R4, 0x1, 0x1f")
    assert (op, dests, srcs) == ("SHFL.BFLY", ["R5"], ["R4"])
    op, dests, srcs = tks.parse("VOTE.ANY R3, PT, P0")
    assert (dests, srcs) == (["R3"], ["P0"])


def test_compact_writes_the_fixture_format():
    """``--fixture``'s compaction of a raw cuobjdump listing (tabs, runs of
    spaces, encodings, headers) gives the fixtures' lines, and keeps only
    the functions the pattern names."""
    lines = _text().splitlines()[:4]
    raw = (f"\t\t{lines[0]}\n\t.headerflags\t@\"EF_CUDA_SM90\"\n"
           + "".join(f"        {a}                   {t}"
                     f"        /* 0x000000000000ff00 */\n\n"
                     for a, t in (x.split(" ", 1) for x in lines[1:]))
           + "\t\tFunction : _Z5otherv\n        /*0000*/   NOP ;\n")
    assert tks.compact(raw, "fused_ticks_ion_kernel") == \
        "\n".join(lines) + "\n"


def test_tick_bound_counts_the_schemes_coupling_places():
    """The bound counts the work the scheme's data needs: the quad pump's
    4 coupling places where the linear one has 8 and a dense S = 7 scheme
    49, each 4 operations a stage (8 with a beat note)."""
    import dataclasses
    import numpy as np
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.levels import tag408

    def spec(sch):
        return tf.FusedTickSpec(
            scheme=sch, h=0.00985, qdt=8e-5, plas_to_quant_vel=1.3,
            gamma_to_einstein=123.1, ratio=1, L=1.0, apply_force=False)
    quad, lin = tag408(-1.0, 0.5, False), tag408(-1.0, 0.5, True)
    c = np.random.default_rng(7).normal(size=(7, 7)) + 1.0
    dense = dataclasses.replace(quad, coupling=c + c.T)
    ops = {k: chip_smoke.tick_ops(spec(s))
           for k, s in (("quad", quad), ("linear", lin), ("dense", dense))}
    assert ops["linear"] - ops["quad"] == 4 * 4 * 4
    assert ops["dense"] - ops["quad"] == 4 * 4 * 45
    b = chip_smoke.tick_bound(dataclasses.replace(spec(quad), ratio=62),
                              4096, 4096)
    assert b["bound_ms"] == pytest.approx(
        1e3 * 4096 * 62 * ops["quad"] / chip_smoke.H100_FP32_OPS)

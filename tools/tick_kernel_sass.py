#!/usr/bin/env python3
"""Read the tick kernel's machine code (cuobjdump -sass of the built
``csrc/fused_ticks.cu``) and say what bounds a tick of its small-scheme
forms.

    python tools/tick_kernel_sass.py [--parent OTHER_TREE] [--out f.json]
        [--fixture REGEX PATH]

For each form of ``fused_ticks_ion_kernel`` (one thread an ion: S = 3, 5
and 7, each compiled coupling pattern), and with ``--parent`` each S = 5
/ 7 form of the parent's group kernel ``fused_ticks_kernel`` (8 lanes an
ion, short rows: the design these state counts had before), it takes
the tick loop: of the loops that hold the four slopes' reciprocal square
roots, the largest without sincosf (whose range reduction multiplies by
2/pi: the ion kernel's beat-note copy), else the largest (the group
kernel's one loop, whose sincosf a branch skips).  It walks the loop on
the path most of the three-state job's and the pumps' ticks take: every
conditional branch that jumps forward inside the loop is taken (no jump
collapse, no renormalization, no expansion term, no beat note: the
blocks the ion's ``jumped`` and the spec's flags guard), and one that
leaves the loop falls through.  On that path it reports

  * ``instructions_per_tick``: what one warp issues a tick, at most one a
    cycle: the issue floor;
  * ``chain_cycles_per_tick``: the longest loop-carried dependence, the
    recurrence the ticks cannot overlap (the largest cycle mean of the
    register-to-register latency matrix of one pass of the loop, in
    cycles per tick), with the latency of each instruction class measured
    on the card (``tools/sass_latency.cu``);
    ``chain`` lists that recurrence's instructions once around;
  * ``roll_loads``: each global load into a register (LDG) of the loop,
    the slopes (MUFU.RSQ) between its issue and the first instruction that
    reads its register (a load read before a whole tick's four slopes have
    passed sits on the chain); ``async_copies`` (LDGSTS, cp.async into
    shared memory) and ``ticks_ahead``, the copy groups a tick's wait
    (DEPBAR) leaves in flight: the ticks by which the rolls are fetched
    ahead;
  * ``shuffles_votes``: SHFL / VOTE instructions on the path (none in
    the ion kernel; the group kernel's sums and neighbour fetches, each
    charged its latency measured on the card).

With ``--parent`` it also builds the other tree's library, reads those
group loops (``parent_group_forms``) and says, for every S = 12
group-kernel instantiation and every S = 3 ion-kernel form, whether the
machine code is the parent's instruction for instruction
(``same_code_as_parent``).  ``--fixture`` writes the functions whose
mangled names match REGEX, the instruction encodings stripped, to PATH
(the recorded dumps under ``tests/fixtures/``).  Run on the card
(cuobjdump and the probe need the CUDA toolkit and a GPU); the last line
is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: latency classes of tools/sass_latency.cu, by probe index
PROBES = {"fma": 0, "mnmx": 1, "sel": 2, "mufu": 3, "imad": 4, "shfl": 5,
          "vote": 6}


def opcode_class(op: str) -> str:
    """The measured latency class an opcode is charged: the FMA pipe's
    FP32 operations, FMNMX, the ALU pipe (compares, selects, integer and
    logic, moves: the FSETP + FSEL probe), IMAD, MUFU, SHFL, VOTE;
    anything else (loads, conversions, barriers) 'other'."""
    base = op.split(".")[0]
    if base in ("FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I"):
        return "fma"
    if base == "FMNMX":
        return "mnmx"
    if base in ("IMAD", "IMUL", "IMAD32I"):
        return "imad"
    if base == "MUFU":
        return "mufu"
    if base == "SHFL":
        return "shfl"
    if base in ("VOTE", "VOTEU"):
        return "vote"
    if base in ("FSETP", "FSEL", "SEL", "ISETP", "IADD3", "LOP3", "MOV",
                "SHF", "PRMT", "IMNMX", "FSET", "PLOP3", "P2R", "R2P",
                "IABS", "LEA", "FCHK", "IADD", "LOP"):
        return "sel"
    return "other"


def functions(sass: str) -> dict:
    """``{mangled name: [(address, instruction text)]}`` of a dump."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _branch_target(text: str):
    m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


#: sincosf's range reduction (x * 2/pi), the beat-note tick's signature
TWO_OVER_PI = "0.63661974668502807617"


def tick_loop(ins: list) -> tuple:
    """(first, last) indices of the tick loop: of the loops that hold the
    four slopes' MUFU.RSQ, the largest whose body does not compute sincosf
    (the ion kernel's plain loop; its beat-note copy does), else the
    largest (the group kernel's one loop, whose sincosf a branch
    skips)."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    best = {False: None, True: None}
    for i, (a, t) in enumerate(ins):
        tgt = _branch_target(t)
        if tgt is None or tgt >= a or tgt not in index:
            continue
        j = index[tgt]
        body = [x for _, x in ins[j:i + 1]]
        if sum("MUFU.RSQ" in x for x in body) < 4:
            continue
        trig = any(TWO_OVER_PI in x or "MUFU.SIN" in x for x in body)
        if best[trig] is None or i - j > best[trig][1] - best[trig][0]:
            best[trig] = (j, i)
    if best[False] is None and best[True] is None:
        raise SystemExit("no tick loop found")
    return best[False] or best[True]


def main_path(ins: list, loop: tuple) -> list:
    """The loop body's instructions on the path described in the module
    docstring (branches themselves included)."""
    first, last = loop
    index = {a: i for i, (a, _) in enumerate(ins)}
    lo, hi = ins[first][0], ins[last][0]
    path, i = [], first
    while i <= last:
        a, t = ins[i]
        path.append(t)
        tgt = _branch_target(t)
        if i == last:
            break
        if tgt is not None and lo < tgt <= hi and tgt > a:
            i = index[tgt]           # a forward branch inside the loop
            continue
        i += 1
    return path


_REG = re.compile(r"(?<![U\w])(R\d+|P[0-6])(\.64|\.128)?")


def _regs(operand: str) -> list:
    out = []
    for m in _REG.finditer(operand.replace(".reuse", "")):
        r, wide = m.group(1), m.group(2)
        if r.startswith("R"):
            n = int(r[1:])
            k = 2 if wide == ".64" else 4 if wide == ".128" else 1
            out += [f"R{n + j}" for j in range(k)]
        else:
            out.append(r)
    return out


def parse(text: str) -> tuple:
    """``(opcode, destination registers, source registers)``: guard
    predicates are sources; compares write their first two operands."""
    guard = []
    m = re.match(r"@(!?)(P\d|PT)\s+(.*)", text)
    if m:
        guard = [] if m.group(2) == "PT" else [m.group(2)]
        text = m.group(3)
    parts = text.split(None, 1)
    op = parts[0]
    operands = [x.strip() for x in parts[1].split(",")] if len(parts) > 1 \
        else []
    base = op.split(".")[0]
    if base in ("ST", "STG", "STS", "STL", "RED", "BRA", "BSSY", "BSYNC",
                "EXIT", "CALL", "RET", "NOP", "WARPSYNC", "BAR", "DEPBAR",
                "YIELD", "BPT", "LDGDEPBAR", "LDGSTS"):
        n_dest = 0
    elif base in ("FSETP", "ISETP", "DSETP", "HSETP2", "PLOP3", "VOTE",
                  "VOTEU", "SHFL"):
        n_dest = 2          # SHFL and VOTE: a predicate and a register
    else:
        n_dest = 1
    dests = [r for o in operands[:n_dest] for r in _regs(o)]
    srcs = guard + [r for o in operands[n_dest:] for r in _regs(o)]
    if guard and n_dest:          # a guarded write keeps the old value
        srcs += dests
    return op, dests, srcs


def recurrence(path: list, lat: dict) -> dict:
    """The loop's critical recurrence on ``path``: the largest cycle mean
    (cycles per pass) of the matrix of longest latency paths from each
    register read before it is written (its value from the last pass) to
    each register's value at the end of the pass, and one cycle that
    reaches it."""
    parsed = [parse(t) for t in path]
    live_in, written = [], set()
    for _, d, s in parsed:
        live_in += [r for r in s if r not in written and r not in live_in]
        written |= set(d)
    carried = [r for r in live_in if r in written]
    cost = [lat[opcode_class(op)] for op, _, _ in parsed]
    M = {}
    for r in carried:                  # longest paths from r's old value
        ready, via = {r: 0.0}, {r: None}
        for k, (op, d, s) in enumerate(parsed):
            t = [ready[x] for x in s if x in ready]
            if not t:
                for x in d:
                    ready.pop(x, None)
                continue
            start = max(t)
            for x in d:
                ready[x], via[x] = start + cost[k], k
        M[r] = {q: ready[q] for q in carried if q in ready}
    best, cycle = 0.0, []
    # max-plus powers (paths of 1..8 passes), each entry (length, the
    # register before the last step)
    paths = [{(r, q): (v, r) for r in M for q, v in M[r].items()}]
    for length in range(1, min(len(carried), 8) + 1):
        for (r, q), (v, _) in paths[-1].items():
            if r == q and v / length > best:
                best, cycle = v / length, (r, length)
        if length == 8:
            break
        nxt = {}
        for (r, q), (v, _) in paths[-1].items():
            for q2, w in M.get(q, {}).items():
                if (r, q2) not in nxt or v + w > nxt[(r, q2)][0]:
                    nxt[(r, q2)] = (v + w, q)
        paths.append(nxt)
    regs = []
    if cycle:
        r, length = cycle
        q = r
        for k in range(length - 1, -1, -1):       # walk the steps back
            regs.append(q)
            q = paths[k][(r, q)][1]
        regs = [r] + regs[::-1]
    return dict(cycles_per_pass=best, registers=regs,
                carried_registers=len(carried))


def chain_listing(path: list, lat: dict, start: str) -> list:
    """The instructions of the longest path from ``start``'s old value to
    its new value in one pass (opcode and class, in order)."""
    parsed = [parse(t) for t in path]
    ready, via = {start: (0.0, None)}, {}
    for k, (op, d, s) in enumerate(parsed):
        t = [(ready[x][0], x) for x in s if x in ready]
        if not t:
            for x in d:
                ready.pop(x, None)
            continue
        start_t, src = max(t)
        src_def = ready[src][1]
        for x in d:
            ready[x] = (start_t + lat[opcode_class(op)], k)
            via[(x, k)] = (src, src_def)
    if start not in ready or ready[start][1] is None:
        return []
    out, reg, k = [], start, ready[start][1]
    while k is not None:
        op = parsed[k][0]
        out.append(f"{op} ({opcode_class(op)})")
        reg, k = via[(reg, k)]
    return out[::-1]


def roll_loads(path: list) -> list:
    """For each LDG of the loop: the slopes (MUFU.RSQ) between its issue
    and the first read of its destination, over the pass and the next."""
    twice = path + path
    out = []
    for k, t in enumerate(path):
        op, d, _ = parse(t)
        if op.split(".")[0] != "LDG":
            continue
        use = next((j for j in range(k + 1, len(twice))
                    if set(parse(twice[j])[2]) & set(d)), None)
        if use is None:
            continue
        slopes = sum("MUFU.RSQ" in x for x in twice[k + 1:use])
        out.append(dict(load=t, first_use=twice[use],
                        next_pass=use >= len(path), slopes_between=slopes))
    return out


#: an ion-kernel form's mangled name: S, the coupling pattern's mask (a
#: template argument since the pattern was compiled in; none before),
#: per_lane_e0, per_lane_om
ION_NAME = re.compile(r"fused_ticks_ion_kernelILi(\d+)E(?:L[my](\d+)E)?"
                      r"Lb([01])ELb([01])")
#: a group-kernel form's: S, G, per_lane_e0, per_lane_om, rng, long rows
GROUP_NAME = re.compile(r"fused_ticks_kernelILi(\d+)ELi(\d+)ELb([01])"
                        r"ELb([01])ELb([01])ELb([01])")


def pattern_names() -> dict:
    """``{mask: name}`` of the compiled coupling patterns (the host's
    mirror of the kernel's list)."""
    sys.path.insert(0, ROOT)
    from mdqtplasmasims_torch.core.qt_fused import ION_PATTERNS
    return {mask: name for name, _, mask in ION_PATTERNS}


def ion_form(name: str):
    """``(S, pattern mask or None, e0, om)`` of an ion-kernel form."""
    m = ION_NAME.search(name)
    if not m:
        return None
    return (int(m.group(1)), None if m.group(2) is None else int(m.group(2)),
            m.group(3), m.group(4))


def read_loop(ins: list, lat: dict) -> dict:
    """The floors of one form's tick loop (see the module docstring)."""
    loop = tick_loop(ins)
    path = main_path(ins, loop)
    ticks = max(1, round(sum("MUFU.RSQ" in t for t in path) / 4))
    rec = recurrence(path, lat)
    chain = chain_listing(path, lat, rec["registers"][0]) \
        if rec["registers"] else []
    return dict(
        loop_instructions=loop[1] - loop[0] + 1, ticks_per_pass=ticks,
        instructions_per_tick=len(path) / ticks,
        chain_cycles_per_tick=rec["cycles_per_pass"] / ticks,
        chain_instructions_per_tick=len(chain) / ticks,
        chain=chain, carried_registers=rec["carried_registers"],
        roll_loads=roll_loads(path),
        async_copies=sum(t.split()[0].split(".")[0] == "LDGSTS"
                         for t in path),
        ticks_ahead=[int(m.group(1), 16) for t in path for m in
                     [re.search(r"DEPBAR\.LE SB\d, (0x[0-9a-f]+)", t)]
                     if m],
        shuffles_votes=sum(opcode_class(t.split()[0]) in ("shfl", "vote")
                           for t in path))


def analyse(fns: dict, lat: dict, names: dict = None) -> dict:
    """The floors of every ion-kernel form of a dump, by form; ``names``
    maps a pattern mask to its name (:func:`pattern_names`)."""
    out = {}
    for name, ins in sorted(fns.items()):
        form = ion_form(name)
        if not form:
            continue
        S, mask, e0, om = form
        pattern = "" if mask is None else " " + (names or {}).get(
            mask, f"mask={mask:#x}")
        out[f"S={S}{pattern} per_lane_e0={e0} per_lane_om={om}"] = \
            read_loop(ins, lat)
    return out


def analyse_group(fns: dict, lat: dict) -> dict:
    """The floors of every S = 5 / 7 group-kernel form (short rows, no
    RNG) of a dump, by form."""
    out = {}
    for name, ins in sorted(fns.items()):
        m = GROUP_NAME.search(name)
        if not m or m.group(1) not in ("5", "7") or m.group(6) == "1":
            continue
        out[f"S={m.group(1)} G={m.group(2)} per_lane_e0={m.group(3)} "
            f"per_lane_om={m.group(4)}"] = read_loop(ins, lat)
    return out


def same_code(new: dict, parent: dict) -> dict:
    """For each S = 12 group-kernel instantiation and each S = 3 ion-kernel
    form of the parent: is the new library's machine code the same,
    instruction for instruction?  (An S = 3 form is matched by its state
    count and flags: the new kernel's name also carries its pattern.)"""
    out = {}
    new_ion = {ion_form(n)[:1] + ion_form(n)[2:]: n for n in new
               if ion_form(n) and ion_form(n)[0] == 3}
    for name, ins in parent.items():
        m, ion = GROUP_NAME.search(name), ion_form(name)
        if m and m.group(1) == "12":
            key = "S={} e0={} om={} rng={} long_rows={}".format(
                m.group(1), *m.groups()[2:])
            twin = name
        elif ion and ion[0] == 3:
            key = "S=3 ion e0={} om={}".format(*ion[2:])
            twin = new_ion.get(ion[:1] + ion[2:])
        else:
            continue
        out[key] = (twin in new
                    and [t for _, t in new[twin]] == [t for _, t in ins])
    return out


def build(tree: str) -> str:
    """Build ``tree``'s tick-kernel library in a fresh process (its own
    sources); returns the library's path."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from mdqtplasmasims_torch import _build; "
            "_build.load('fused_ticks'); "
            "print(_build.library_path('fused_ticks'))")
    return subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                          capture_output=True, text=True
                          ).stdout.strip().splitlines()[-1]


def compact(sass: str, pattern: str) -> str:
    """The functions of a dump whose names match ``pattern``: their
    ``Function :`` lines and instructions, one space between fields."""
    out, keep = [], False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            keep = re.search(pattern, m.group(1)) is not None
            if keep:
                out.append(f"Function : {m.group(1)}")
            continue
        m = re.match(r"\s*(/\*[0-9a-f]{4,}\*/)\s+(.*?;)", line)
        if keep and m:
            out.append(f"{m.group(1)} {re.sub(r'  +', ' ', m.group(2))}")
    return "\n".join(out) + "\n"


def dump(lib: str) -> str:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout


def measure_latencies() -> dict:
    """Cycles per dependent instruction of each class, on the card (the
    shuffle probe's step less its and; the vote probe's over its 8
    votes)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    src = os.path.join(ROOT, "tools", "sass_latency.cu")
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "latency.so")
        subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                       check=True, capture_output=True)
        probe = ctypes.CDLL(lib).latency_probe
        probe.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        out = {}
        for name, op in PROBES.items():
            x = ctypes.c_double()
            if probe(op, ctypes.byref(x)):
                raise SystemExit(f"latency probe {name} failed")
            out[name] = x.value
    out["shfl"] -= out["sel"]
    out["vote"] /= 8
    out["other"] = out["sel"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree: its S = 5 / 7 group "
                    "loops are read, its S = 12 group forms and S = 3 ion "
                    "forms compared instruction for instruction")
    ap.add_argument("--out", help="also write the result to this file")
    ap.add_argument("--fixture", nargs=2, metavar=("REGEX", "PATH"),
                    help="write the functions matching REGEX to PATH")
    args = ap.parse_args()
    sass = dump(build(ROOT))
    if args.fixture:
        with open(args.fixture[1], "w") as f:
            f.write(compact(sass, args.fixture[0]))
    new = functions(sass)
    lat = measure_latencies()
    result = dict(latencies=lat, forms=analyse(new, lat, pattern_names()))
    if args.parent:
        parent = functions(dump(build(args.parent)))
        result["parent_group_forms"] = analyse_group(parent, lat)
        result["same_code_as_parent"] = same_code(new, parent)
    every = {**result["forms"],
             **{f"parent group {k}": v for k, v in
                result.get("parent_group_forms", {}).items()}}
    print(f"[sass] latencies (cycles): " + ", ".join(
        f"{k} {v:.2f}" for k, v in lat.items()))
    for form, r in every.items():
        least = min([x["slopes_between"] for x in r["roll_loads"]],
                    default=None)
        print(f"[sass] {form}: {r['instructions_per_tick']:.1f} instructions "
              f"a tick, chain {r['chain_cycles_per_tick']:.1f} cycles a tick "
              f"({r['chain_instructions_per_tick']:.1f} instructions), "
              f"{len(r['roll_loads'])} register loads (least slopes before "
              f"a use {least}), "
              f"{r['async_copies']} async copies, waits leaving "
              f"{r['ticks_ahead']} ticks in flight, "
              f"{r['shuffles_votes']} shuffles/votes")
    if "same_code_as_parent" in result:
        same = result["same_code_as_parent"]
        print(f"[sass] S = 12 group forms and S = 3 ion forms with the "
              f"parent's machine code: {sum(same.values())} of {len(same)}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

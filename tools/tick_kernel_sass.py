#!/usr/bin/env python3
"""Read the tick kernel's machine code (cuobjdump -sass of the built
``csrc/fused_ticks.cu``) and say what bounds the S = 3 kernel's tick.

    python tools/tick_kernel_sass.py [--parent OTHER_TREE] [--out f.json]

For each form of ``fused_ticks_ion_kernel`` (one thread an ion) it takes
the tick loop (the largest loop without the beat-note path's sincosf,
whose range reduction multiplies by 2/pi) and
walks it on the path most of the three-state job's ticks take: every
conditional branch that jumps forward inside the loop is taken (no jump
collapse, no renormalization, no expansion term: the blocks the ion's
``jumped`` and the spec's flags guard), and one that leaves the loop falls
through.  On that path it reports

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
  * ``shuffles_votes``: SHFL / VOTE instructions in the loop (none).

With ``--parent`` it also builds the other tree's library and says, for
every ``fused_ticks_kernel`` instantiation (S = 5, 7, 12), whether its
machine code is the same instruction for instruction.  Run on the card
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
PROBES = {"fma": 0, "mnmx": 1, "sel": 2, "mufu": 3, "imad": 4}


def opcode_class(op: str) -> str:
    """The measured latency class an opcode is charged: the FMA pipe's
    FP32 operations, FMNMX, the ALU pipe (compares, selects, integer and
    logic, moves: the FSETP + FSEL probe), IMAD, MUFU; anything else
    (loads, conversions, barriers) 'other'."""
    base = op.split(".")[0]
    if base in ("FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I"):
        return "fma"
    if base == "FMNMX":
        return "mnmx"
    if base in ("IMAD", "IMUL", "IMAD32I"):
        return "imad"
    if base == "MUFU":
        return "mufu"
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
    """(first, last) indices of the largest loop whose body does not
    compute sincosf (the plain tick loop; the beat-note path's copy
    does)."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    best = None
    for i, (a, t) in enumerate(ins):
        tgt = _branch_target(t)
        if tgt is None or tgt >= a or tgt not in index:
            continue
        j = index[tgt]
        body = [x for _, x in ins[j:i + 1]]
        if any(TWO_OVER_PI in x or "MUFU.SIN" in x for x in body):
            continue
        if best is None or i - j > best[1] - best[0]:
            best = (j, i)
    if best is None:
        raise SystemExit("no tick loop found")
    return best


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
    elif base in ("FSETP", "ISETP", "DSETP", "HSETP2", "PLOP3", "VOTE"):
        n_dest = 2 if base != "VOTE" else 1
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


def analyse(fns: dict, lat: dict) -> dict:
    out = {}
    for name, ins in sorted(fns.items()):
        m = re.search(r"fused_ticks_ion_kernelILi(\d+)ELb([01])ELb([01])",
                      name)
        if not m:
            continue
        loop = tick_loop(ins)
        path = main_path(ins, loop)
        ticks = max(1, round(sum("MUFU.RSQ" in t for t in path) / 4))
        rec = recurrence(path, lat)
        chain = chain_listing(path, lat, rec["registers"][0]) \
            if rec["registers"] else []
        form = f"S={m.group(1)} per_lane_e0={m.group(2)} " \
               f"per_lane_om={m.group(3)}"
        out[form] = dict(
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
            shuffles_votes=sum(t.split()[0].split(".")[0] in ("SHFL", "VOTE")
                               for t in path))
    return out


def same_code(new: dict, parent: dict) -> dict:
    """For each group-kernel instantiation of the parent: is the new
    library's machine code the same, instruction for instruction?"""
    out = {}
    for name, ins in parent.items():
        if "fused_ticks_kernel" not in name:
            continue
        m = re.search(r"fused_ticks_kernelILi(\d+)ELi\d+ELb([01])ELb([01])"
                      r"ELb([01])ELb([01])", name)
        if not m or m.group(1) == "3":
            continue
        key = "S={} e0={} om={} rng={} long_rows={}".format(*m.groups())
        out[key] = (name in new
                    and [t for _, t in new[name]] == [t for _, t in ins])
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


def dump(lib: str) -> str:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout


def measure_latencies() -> dict:
    """Cycles per dependent instruction of each class, on the card."""
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
    out["other"] = out["sel"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree whose group kernels "
                    "(S = 5, 7, 12) are compared instruction for instruction")
    ap.add_argument("--out", help="also write the result to this file")
    args = ap.parse_args()
    new = dump(build(ROOT))
    lat = measure_latencies()
    result = dict(latencies=lat, forms=analyse(functions(new), lat))
    if args.parent:
        result["same_code_as_parent"] = same_code(
            functions(new), functions(dump(build(args.parent))))
    for form, r in result["forms"].items():
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
        print(f"[sass] group kernels with the parent's machine code: "
              f"{sum(same.values())} of {len(same)}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Instruction counts of the port's kernels, read from their SASS.

Builds the kernel library (ops/kernels/_lib.py) if needed, disassembles
it with the CUDA toolkit's cuobjdump and, for each kernel whose mangled
name holds one of the given substrings, prints its instruction count
(NOPs left out), the count of each opcode class that sets a kernel's
issue rate (MUFU, shared loads, float arithmetic, votes, barriers,
branches) and its loops: every backward branch, with the instructions
between its target and itself. The per-record cost of a kernel's inner
loop is read from those lines. With --out DIR, each kernel's full SASS
goes to DIR/<name>.sass.

    python -m opensplat_tpu_torch.tools.sass_report kbench_fwd_kernelILi0E

Needs cuobjdump ($CUDA_HOME/bin or /usr/local/cuda/bin) and nvcc.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

from ..ops.kernels import _lib

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`?\((\.L_x_\d+)\)`?|\b(0x[0-9a-f]+)\b")
CLASSES = ("MUFU", "LDS", "FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX",
           "VOTE", "BAR", "BRA")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin)")


def parse(sass: str) -> dict:
    """{mangled name: [(address, instruction, label or None)]} of a
    cuobjdump -sass listing; `label` names a branch target that starts
    at that instruction."""
    funcs, cur, pending = {}, None, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            pending = None
            continue
        m = _LABEL.match(line)
        if m:
            pending = m.group(1)
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip(), pending))
            pending = None
    return funcs


def _opcode(insn: str) -> str:
    words = insn.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def summary(insns) -> dict:
    """Instruction count without NOPs, opcode classes, and loops."""
    body = [(a, i, lab) for a, i, lab in insns if _opcode(i) != "NOP"]
    labels = {lab: a for a, _, lab in body if lab}
    classes = Counter()
    for _, i, _ in body:
        op = _opcode(i).split(".")[0]
        if op in CLASSES:
            classes[op] += 1
    loops = []
    for a, i, _ in body:
        if _opcode(i).split(".")[0] != "BRA":
            continue
        m = _TARGET.search(i.split(None, 1)[-1])
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= a:
            inside = [x for x in body if target <= x[0] <= a]
            loops.append(dict(
                start=hex(target), end=hex(a), instructions=len(inside),
                mufu=sum(_opcode(x[1]).startswith("MUFU") for x in inside)))
    return dict(instructions=len(body), classes=dict(classes), loops=loops)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m opensplat_tpu_torch.tools.sass_report",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="+",
                    help="substrings of the mangled kernel names")
    ap.add_argument("--out", help="write each kernel's SASS into this dir")
    args = ap.parse_args(argv)
    lib = _lib.build()
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs = parse(sass)
    out = {}
    for name, insns in funcs.items():
        if not any(s in name for s in args.names):
            continue
        out[name] = summary(insns)
        print(f"{name}: {out[name]['instructions']} instructions; "
              f"{out[name]['classes']}", flush=True)
        for lp in out[name]["loops"]:
            print(f"  loop {lp['start']}-{lp['end']}: {lp['instructions']} "
                  f"instructions, {lp['mufu']} MUFU", flush=True)
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            lines = [f"/*{a:04x}*/ {'[' + lab + '] ' if lab else ''}{i}"
                     for a, i, lab in insns]
            (Path(args.out) / f"{name[:120]}.sass").write_text(
                "\n".join(lines) + "\n")
    if not out:
        raise SystemExit(f"no kernel matches {args.names}; kernels: "
                         f"{sorted(funcs)}")
    return out


if __name__ == "__main__":
    main()

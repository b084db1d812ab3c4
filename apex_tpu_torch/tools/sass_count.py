"""Instruction counts of a built kernel's SASS, by the pipes that can
run them: the counts a kernel's least time is bounded by.

``cuobjdump -sass`` of one library of ``_build.SOURCES`` (built first if
it is not), split into kernels; for the kernels whose (mangled) name holds
``--kernel``, each loop (a branch back to an earlier address) is counted
by opcode and by class:

- ``alu``: what only the integer and logic pipe runs (LOP3, SHF, the
  compares, SEL, PRMT and their kind), 64 lanes an SM on the H100;
- ``add``: integer adds, moves and shift-adds (IADD3, VIADD, MOV, LEA,
  and IMAD.IADD, IMAD.MOV, IMAD.SHL), which the ALU pipe and the FMA
  pipe both run: the compiler's choice of pipe is not the function's;
- ``imad``: integer multiplies (every other IMAD, IMUL), on the FMA pipe
  only, 64 lanes an SM (the CUDA C++ Programming Guide's throughput table,
  compute capability 9.0: 32-bit integer multiply-add 64 results a clock
  an SM);
- ``fp32``: FFMA, FADD, FMUL, on the FMA pipe at 128 lanes an SM (the same
  table: 32-bit floating-point add, multiply, multiply-add 128);
- ``uniform``: the uniform datapath (one per warp, no lanes);
- ``other``: memory, control, conversions and the rest;
- every instruction also takes one of the 4 x 32 issue slots an SM has
  each clock.

With ``--elements`` (the elements one pass of the chosen loop handles per
thread) it prints each class's instructions an element, the numbers
``chip_smoke.py`` holds for dropout's and the SR kernels' bounds
(``DROPOUT_SASS``, ``SR_SASS``)::

    python apex_tpu_torch/tools/sass_count.py dropout \\
        --kernel dropout_kernel --elements 4
    python apex_tpu_torch/tools/sass_count.py layer_norm --kernel ln_bwd \\
        --dump out.sass

``--root`` counts another checkout's build of the library.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

_ALU = ("LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL", "IMNMX",
        "VIMNMX", "FSEL", "FSETP", "FMNMX", "PRMT", "IABS", "PLOP3", "P2R",
        "R2P", "SGXT", "BMSK", "FLO", "POPC", "BREV", "CSETP", "HSETP2")
_ADD = ("IADD3", "IADD", "VIADD", "MOV", "LEA")
_IMAD_ADD = (".IADD", ".MOV", ".SHL")
_FP32 = ("FFMA", "FADD", "FMUL")
CLASSES = ("alu", "add", "imad", "fp32", "uniform", "other")

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def class_of(op: str, mods: str = "") -> str:
    """The class of an instruction (see the module note) from its opcode
    and modifiers."""
    if op.startswith("IMAD") or op == "IMUL":
        return "add" if mods.startswith(_IMAD_ADD) else "imad"
    if op in _FP32:
        return "fp32"
    if op in _ALU:
        return "alu"
    if op in _ADD:
        return "add"
    if op.startswith("U"):
        return "uniform"
    return "other"


def cuobjdump() -> str:
    from apex_tpu_torch import _build
    cand = Path(_build.nvcc_path()).parent / "cuobjdump"
    if cand.is_file():
        return str(cand)
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return found


def functions(text: str) -> Dict[str, List[tuple]]:
    """Kernel name -> [(address, opcode, modifiers, operands)]."""
    out: Dict[str, List[tuple]] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            out[cur] = []
            continue
        m = _LINE.search(line)
        if cur is not None and m:
            out[cur].append((int(m.group(1), 16), m.group(3), m.group(4),
                             m.group(5).strip()))
    return out


def loops(body: List[tuple]) -> List[tuple]:
    """(start, end) address ranges closed by a branch back to an earlier
    address."""
    found = []
    for addr, op, _, args in body:
        if op == "BRA":
            t = _TARGET.search(args)
            if t and int(t.group(1), 16) <= addr:
                found.append((int(t.group(1), 16), addr))
    return found


def count(body: List[tuple], lo: int = 0, hi: Optional[int] = None) -> dict:
    ops: Dict[str, int] = {}
    classes = dict.fromkeys(CLASSES, 0)
    total = 0
    for addr, op, mods, _ in body:
        if addr < lo or (hi is not None and addr > hi) or op == "NOP":
            continue
        ops[op] = ops.get(op, 0) + 1
        classes[class_of(op, mods)] += 1
        total += 1
    return {"instructions": total, "classes": classes,
            "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def kernel_counts(library: str, kernel: str, root: Optional[str] = None,
                  dump: Optional[str] = None) -> Dict[str, dict]:
    """Each matching kernel's counts: the whole function and each loop."""
    sys.path.insert(0, root or str(Path(__file__).resolve().parents[2]))
    from apex_tpu_torch import _build
    _build.build_all([library])
    text = subprocess.run([cuobjdump(), "-sass",
                           str(_build.library_path(library))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    dumped = []
    for name, body in functions(text).items():
        if kernel not in name:
            continue
        out[name] = {"function": count(body),
                     "loops": [{"start": a, "end": b, **count(body, a, b)}
                               for a, b in loops(body)]}
        dumped.append(f"Function : {name}\n" + "\n".join(
            f"/*{a:04x}*/ {op}{mods} {args};" for a, op, mods, args in body))
    if dump:
        Path(dump).write_text("\n\n".join(dumped) + "\n")
    return out


def per_element(loop: dict, elements: int) -> dict:
    return {"instructions": loop["instructions"] / elements,
            "classes": {k: v / elements
                        for k, v in loop["classes"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("library")
    ap.add_argument("--kernel", required=True,
                    help="a substring of the kernels' mangled names")
    ap.add_argument("--root", help="the checkout whose library is counted")
    ap.add_argument("--elements", type=int,
                    help="elements a thread handles in one pass of the "
                         "largest loop")
    ap.add_argument("--dump", help="write the kernels' SASS here")
    ap.add_argument("--json", help="write the counts here")
    args = ap.parse_args(argv)
    got = kernel_counts(args.library, args.kernel, args.root, args.dump)
    for name, c in got.items():
        print(f"{name}: {c['function']['instructions']} instructions, "
              f"classes {c['function']['classes']}")
        for lp in c["loops"]:
            print(f"  loop 0x{lp['start']:x}-0x{lp['end']:x}: "
                  f"{lp['instructions']} instructions, classes "
                  f"{lp['classes']}")
        if args.elements and c["loops"]:
            main_loop = max(c["loops"], key=lambda lp: lp["instructions"])
            pe = per_element(main_loop, args.elements)
            c["per_element"] = pe
            print(f"  an element (largest loop / {args.elements}): "
                  f"{pe['instructions']:.2f} instructions, classes "
                  + ", ".join(f"{k} {v:.2f}"
                              for k, v in pe["classes"].items()))
            print(f"  opcodes of that loop: {main_loop['opcodes']}")
    if args.json:
        Path(args.json).write_text(json.dumps(got, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare the machine code of two builds of the port's kernel library,
kernel by kernel.

    python3 tools/sass_diff.py OLD.so NEW.so

Disassembles both libraries with ``cuobjdump -sass`` (the CUDA toolkit's;
run it on the machine with the card, where ``vsc2022_torch/ops/_build.py``
builds the libraries), splits each listing by function, names each
function by its demangled name (``cu++filt``: an anonymous namespace is
"(anonymous namespace)", whatever hash the compiler gave it), and prints
for every function of OLD whether NEW holds the same instructions, then
the functions only NEW has. Exits 1 if a function of OLD differs or is
missing from NEW.
"""

from __future__ import annotations

import argparse
import collections
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = Path("/usr/local/cuda/bin") / name
    if path.is_file():
        return str(path)
    raise SystemExit(f"{name} not found (the CUDA toolkit's)")


def functions(lib: str) -> Dict[Tuple[str, int], List[str]]:
    """{(demangled name, occurrence): instruction lines} of a library."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    listing: Dict[str, List[str]] = {}
    order: List[str] = []
    name = None
    for line in out.splitlines():
        text = line.strip()
        if text.startswith("Function : "):
            name = text[len("Function : "):]
            order.append(name)
            listing[f"{name}#{len(order)}"] = []
        elif name is not None and text.startswith("/*"):
            listing[f"{name}#{len(order)}"].append(text)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(order),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    seen: Dict[str, int] = collections.Counter()
    result = {}
    for i, (mangled, pretty) in enumerate(zip(order, demangled)):
        key = (pretty, seen[pretty])
        seen[pretty] += 1
        result[key] = listing[f"{mangled}#{i + 1}"]
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    old, new = functions(args.old), functions(args.new)
    bad = 0
    for key, code in old.items():
        if key not in new:
            verdict = "MISSING"
        elif new[key] == code:
            verdict = "same"
        else:
            verdict = "DIFFERS"
        bad += verdict != "same"
        print(f"{verdict:8s} {len(code):6d} instructions  {key[0]}")
    for key in new.keys() - old.keys():
        print(f"{'new':8s} {len(new[key]):6d} instructions  {key[0]}")
    print(f"{len(old) - bad} of {len(old)} functions of {args.old} identical in "
          f"{args.new}; {len(new.keys() - old.keys())} new")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

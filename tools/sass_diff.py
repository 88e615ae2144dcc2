#!/usr/bin/env python3
"""Compare the SASS of every kernel in two builds of the kernel library,
function by function, on a machine with the CUDA toolkit:

    python3 tools/sass_diff.py --root PARENT_CHECKOUT [--change CHECKOUT]
                               [--show REGEX]

Builds (or finds) each checkout's library with its own
dynamont_tpu_torch/_build.py, disassembles both with cuobjdump (found
beside nvcc) and compares each function's SASS after taking the
anonymous-namespace hash, which differs between builds of a changed
source, out of the names. Prints the functions found only on one side,
how many are identical, the names of those that differ, and for the
functions matching --show (default: every function that is not
identical) their instruction, branch, barrier, MUFU and local-memory
counts on each side.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_")


def library(root: str) -> tuple[str, str]:
    """The checkout's built kernel library (built by its own _build) and nvcc."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from dynamont_tpu_torch import _build; _build.load(); "
            "print(_build.library_path()); print(_build.find_nvcc())")
    out = subprocess.run([sys.executable, "-c", code, root], capture_output=True,
                         text=True, check=True).stdout.split()
    return out[-2], out[-1]


def functions(lib: str, nvcc: str) -> dict:
    """{function name without the anonymous-namespace hash: its SASS}."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name, body = {}, None, []
    for line in out.splitlines():
        line = _HASH.sub("_GLOBAL__N__X_", line)
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                funcs[name] = "\n".join(body)
            name, body = m.group(1), []
        elif name:
            body.append(line)
    if name:
        funcs[name] = "\n".join(body)
    return funcs


def counts(sass: str) -> str:
    return (f"instructions {len(re.findall(r'/[*][0-9a-f]{4}[*]/', sass))} "
            f"BRA {sass.count(' BRA ')} BAR {sass.count('BAR.SYNC')} "
            f"MUFU {sass.count('MUFU')} LDL {sass.count('LDL')} STL {sass.count('STL')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the parent checkout")
    ap.add_argument("--change", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the changed checkout (default: this one)")
    ap.add_argument("--show", default=None)
    args = ap.parse_args(argv)
    lib_a, nvcc = library(os.path.abspath(args.root))
    lib_b, _ = library(os.path.abspath(args.change))
    a, b = functions(lib_a, nvcc), functions(lib_b, nvcc)
    same = [n for n in a if n in b and a[n] == b[n]]
    print(f"functions: parent {len(a)}, change {len(b)}; only parent "
          f"{sorted(set(a) - set(b))}; only change {sorted(set(b) - set(a))}")
    print(f"identical: {len(same)}; differ: {[n for n in a if n in b and a[n] != b[n]]}")
    for side, f in (("parent", a), ("change", b)):
        for n, sass in f.items():
            if (re.search(args.show, n) if args.show else n not in same):
                print(side, n, counts(sass))
    return 0


if __name__ == "__main__":
    sys.exit(main())

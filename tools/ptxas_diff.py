#!/usr/bin/env python3
"""Compare the ``nvcc -Xptxas -v`` resource lines of two kernel builds.

Each argument is a file that holds a build report as ``kernels/build.py``
writes it (``build/repro_torch/*.ptxas.txt``) or as ``chip_smoke.py``
prints it (its ``== source.cu`` sections).  For every source file present
in both, the script pairs the kernel instantiations in the order ptxas
compiled them and reports whether each one's registers, spills, stack,
barriers and constant memory are the same.  Names are compared with the
anonymous-namespace hash removed and without the template arguments a
change may have dropped, so a pure refactor shows as identical::

    python3 tools/ptxas_diff.py OLD_LOG NEW_LOG [--skip bitlinear_axes_stacked.cu]
"""
from __future__ import annotations

import argparse
import re
import sys


def parse(text: str) -> dict[str, list[tuple[str, str]]]:
    """{source: [(kernel, resource line), ...]} in compile order."""
    out: dict[str, list[tuple[str, str]]] = {}
    src = name = None
    props = ""
    for line in text.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
            continue
        if src is None:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1))
            continue
        if name and "spill stores" in line:
            props = line.split(" : ")[-1].strip()
        elif name and "Used" in line:
            out.setdefault(src, []).append(
                (name, props + "; " + line.split(" : ")[-1].strip()))
            name = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--skip", action="append", default=[])
    args = ap.parse_args()
    old = parse(open(args.old).read())
    new = parse(open(args.new).read())
    same_all = True
    for src in sorted(set(old) & set(new)):
        if src in args.skip:
            continue
        a, b = old[src], new[src]
        same = len(a) == len(b) and all(x[1] == y[1] for x, y in zip(a, b))
        same_all &= same
        print(f"{src}: {len(a)} / {len(b)} instantiations, resource lines "
              f"{'identical' if same else 'DIFFER'}")
        if not same:
            for (na, ra), (nb, rb) in zip(a, b):
                if ra != rb:
                    print(f"  {na[:80]}\n    old: {ra}\n    new: {rb}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())

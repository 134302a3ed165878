"""Count the SASS instructions of built kernels by mnemonic.

    python3 tools/sass_mix.py [--root ROOT] PATTERN [PATTERN ...]

Builds ROOT's tpufft_torch library (default: this checkout; one nvcc per
source, needs nvcc), disassembles it with ``cuobjdump -sass`` and, for
every kernel whose mangled name contains one of the PATTERNs (e.g.
``minor_lane_kernelIfLi32ELi32``), prints the static instruction count
(each instruction of the kernel's code once, loops not unrolled by the
count) and the most frequent mnemonics with their modifiers. Needs the
card's toolkit.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys


def _library(root: str) -> str:
    code = "from tpufft_torch import _build; print(_build.build())"
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, check=True,
                          timeout=1200).stdout.strip().splitlines()[-1]


def main() -> int:
    args = sys.argv[1:]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args[:1] == ["--root"]:
        root, args = os.path.abspath(args[1]), args[2:]
    if not args:
        raise SystemExit(__doc__)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _library(root)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            cur = name if any(p in name for p in args) else None
            if cur:
                counts[cur] = collections.Counter()
            continue
        m = cur and re.match(
            r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
            r"(\.[A-Z0-9_.]+)?", line)
        if m:
            counts[cur][m.group(1) + (m.group(2) or "")] += 1
    for name, c in counts.items():
        top = ", ".join(f"{k} {v}" for k, v in c.most_common(20))
        print(f"{name}: {sum(c.values())} instructions; {top}")
    return 0 if counts else 1


if __name__ == "__main__":
    sys.exit(main())

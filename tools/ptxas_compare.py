"""Compare the ptxas resource report (registers, spills, stack) of the CUDA
kernels of two checkouts of tpufft_torch, kernel by kernel.

    python3 tools/ptxas_compare.py OLD [NEW]

OLD and NEW are checkouts, or files holding a build's ptxas report (the
``.log`` beside a built library, or ``chip_smoke.py``'s output, which
prints it). A checkout's library is built with its own
``tpufft_torch._build.build()`` (into its own ``build/``; one nvcc per
source, needs nvcc). The tool reads the ptxas report (registers, spills,
stack and static shared memory per kernel), demangles each kernel's name with
``c++filt`` (or ``cu++filt``), and matches kernels by name and template
arguments. Prints every old kernel's numbers beside the new build's, then
the kernels only the new build has, and exits 1 if any matched kernel
differs or any old kernel has no match. NEW defaults to this checkout.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

def _build_log(root: str) -> str:
    code = ("from tpufft_torch import _build; "
            "print(_build.build().with_suffix('.log'))")
    env = dict(os.environ, PYTHONPATH=root)
    path = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, check=True,
                          timeout=1200).stdout.strip().splitlines()[-1]
    with open(path) as f:
        return f.read()


def _demangle(names: list[str]) -> list[str]:
    tool = (shutil.which("c++filt") or shutil.which("cu++filt")
            or "/usr/local/cuda/bin/cu++filt")
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()


def _report(log: str) -> dict[str, tuple[int, int, int, int, int]]:
    """Demangled kernel -> (registers, spill stores, spill loads, stack,
    static shared memory bytes)."""
    raw, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            raw[cur] = [0, 0, 0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            raw[cur][3], raw[cur][1], raw[cur][2] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            raw[cur][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            raw[cur][4] = int(m.group(1))
    names = list(raw)
    return {d: tuple(raw[n]) for n, d in zip(names, _demangle(names))}


def _key(name: str) -> str:
    """The kernel's name and template arguments, without its parameter list
    or return type, each argument without a cast (``(bool)0`` is
    ``false``)."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    if name.endswith(")"):   # drop the parameter list (balanced parens)
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if "<" not in name:
        return name
    head, args = name.split("<", 1)
    out = []
    for a in args.rstrip(">").split(","):
        a = a.strip()
        m = re.fullmatch(r"\((\w[\w ]*)\)(-?\d+)", a)
        if m:
            a = ({"0": "false", "1": "true"}[m.group(2)]
                 if m.group(1) == "bool" else m.group(2))
        out.append(a)
    return f"{head}<{', '.join(out)}>"


def _log(path: str) -> str:
    """A checkout's build log (built here), or a log file as it is."""
    if os.path.isfile(path):
        with open(path) as f:
            return f.read()
    return _build_log(os.path.abspath(path))


def main() -> int:
    new_path = sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    old = {_key(k): v for k, v in _report(_log(sys.argv[1])).items()}
    new = {_key(k): v for k, v in _report(_log(new_path)).items()}
    bad = 0
    print("kernel: registers, spill stores, spill loads, stack, static "
          "shared memory (old -> new; dynamic shared memory is set at the "
          "launch and not in ptxas's report)")
    for k in sorted(old):
        got = new.get(k)
        same = got == old[k]
        bad += not same
        print(f"  {'same' if same else 'DIFF'} {k}: {old[k]} -> {got}")
    print("kernels only in the new build:")
    for k in sorted(set(new) - set(old)):
        print(f"  {k}: {new[k]}")
    print(f"{len(old) - bad} of {len(old)} kernels unchanged")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

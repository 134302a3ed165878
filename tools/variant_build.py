"""Patched builds of the CUDA sources, for the A/B tools' ``--variants``
(``tools/long_line_ab.py``, ``tools/strided_long_ab.py``,
``tools/mixed_line_ab.py``).

A variant is a copy of ``tpufft_torch/csrc`` with one header's text
replaced. Each variant's chosen sources are compiled one nvcc a source
(with the library's own ``NVCC_FLAGS``, so ptxas reports every kernel),
all variants' sources started together or at most ``jobs`` at a time, and
linked into ``<out>/<name>/lib.so``, which the tool binds with ctypes.
Needs nvcc.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import subprocess
from typing import Callable

from tpufft_torch import _build

SRC_DIR = "tpufft_torch/csrc"


def build(out: str, header: str, texts: dict[str, str],
          picks: Callable[[str], bool], *,
          shared: Callable[[str], bool] | None = None,
          jobs: int | None = None) -> dict[str, tuple[str, str]]:
    """Each variant of ``texts`` (its name -> its text of ``header``):
    csrc's ``.cu`` and ``.cuh`` files copied into ``out/<name>/`` with
    ``header`` replaced, the sources that ``picks`` accepts compiled there,
    and those that ``shared`` accepts compiled once from csrc into
    ``out/common/`` and linked into every variant. Returns each name ->
    (its library's absolute path, ptxas's report of its own sources)."""
    nvcc = _build._nvcc()
    names = os.listdir(SRC_DIR)
    todo = []   # (variant, source directory, source file)
    if shared is not None:
        todo += [("common", SRC_DIR, f) for f in sorted(names) if shared(f)]
    for name, text in texts.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for f in names:
            if f.endswith((".cuh", ".cu")):
                with open(os.path.join(SRC_DIR, f)) as src, \
                        open(os.path.join(d, f), "w") as dst:
                    dst.write(text if f == header else src.read())
        todo += [(name, d, f) for f in sorted(names) if picks(f)]
    pool = concurrent.futures.ThreadPoolExecutor(jobs or len(todo))
    runs = []
    for name in {name for name, _, _ in todo}:
        shutil.rmtree(os.path.join(out, name, "objs"), ignore_errors=True)
        os.makedirs(os.path.join(out, name, "objs"))
    for name, src_dir, f in todo:
        obj = os.path.join(out, name, "objs", f[:-3] + ".o")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(src_dir, f),
               "-o", obj]
        runs.append((name, obj, pool.submit(
            subprocess.run, cmd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs = {name: "" for name in ("common", *texts)}
    for name, obj, run in runs:
        done = run.result()
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {obj}:\n"
                               f"{done.stdout[-3000:]}")
        logs[name] += done.stdout
    pool.shutdown()

    def objs(name: str) -> list[str]:
        d = os.path.join(out, name, "objs")
        if not os.path.isdir(d):
            return []
        return [os.path.join(d, f) for f in sorted(os.listdir(d))]

    libs = {}
    for name in texts:
        lib = os.path.abspath(os.path.join(out, name, "lib.so"))
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", lib,
                        *objs(name), *objs("common")], check=True,
                       capture_output=True)
        libs[name] = (lib, logs[name])
    return libs

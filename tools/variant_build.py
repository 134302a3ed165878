"""Patched builds of the CUDA sources, for the A/B tools' ``--variants``
(``tools/long_line_ab.py``, ``tools/strided_long_ab.py``,
``tools/mixed_line_ab.py``, ``tools/mid_mixed_ab.py``) and the phase
tools' copies (``tools/cluster_phases.py``).

A variant is a copy of ``tpufft_torch/csrc`` with one header's text
replaced, or with several files replaced or added. Each variant's chosen
sources are compiled one nvcc a source (with the library's own
``NVCC_FLAGS``, so ptxas reports every kernel), all variants' sources
started together or at most ``jobs`` at a time, and linked into
``<out>/<name>/lib.so``, which the tool binds with ctypes. Needs nvcc.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import subprocess
from typing import Callable

from tpufft_torch import _build

SRC_DIR = "tpufft_torch/csrc"


def build(out: str, header: str | None, texts: dict[str, str | dict],
          picks: Callable[[str], bool], *,
          shared: Callable[[str], bool] | None = None,
          jobs: int | None = None) -> dict[str, tuple[str, str]]:
    """Each variant of ``texts`` (its name -> its text of ``header``, or a
    dict of file names -> their texts, csrc's files replaced or new ones):
    csrc's ``.cu`` and ``.cuh`` files copied into ``out/<name>/`` with the
    variant's own written over them, the sources that ``picks`` accepts
    and the ``.cu`` files the variant replaces or adds compiled there, and
    those that ``shared`` accepts compiled once from csrc into
    ``out/common/`` and linked into every variant that does not compile its
    own copy. Returns
    each name -> (its library's absolute path, ptxas's report of its own
    sources, or of the common ones where it compiles none)."""
    nvcc = _build._nvcc()
    names = os.listdir(SRC_DIR)
    todo = []   # (variant, source directory, source file)
    if shared is not None:
        todo += [("common", SRC_DIR, f) for f in sorted(names) if shared(f)]
    for name, text in texts.items():
        own = text if isinstance(text, dict) else {header: text}
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for f in names:
            if f.endswith((".cuh", ".cu")) and f not in own:
                shutil.copyfile(os.path.join(SRC_DIR, f), os.path.join(d, f))
        for f, t in own.items():
            with open(os.path.join(d, f), "w") as dst:
                dst.write(t)
        todo += [(name, d, f) for f in sorted(set(names) | set(own))
                 if picks(f) or (f in own and f.endswith(".cu"))]
    pool = concurrent.futures.ThreadPoolExecutor(jobs or len(todo))
    runs = []
    for name in {*texts, *(name for name, _, _ in todo)}:
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
        mine = objs(name)
        held = {os.path.basename(o) for o in mine}
        lib = os.path.abspath(os.path.join(out, name, "lib.so"))
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", lib,
                        *mine, *(o for o in objs("common")
                                 if os.path.basename(o) not in held)],
                       check=True, capture_output=True)
        libs[name] = (lib, logs[name] if mine else logs["common"])
    return libs

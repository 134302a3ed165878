"""Build hook: copy the native CPU engine source into package data.

The single source of truth is ``native/tpufft_cpu.cpp``. Wheels and
installed packages ship a copy under ``tpufft/native_src/`` and one under
``tpufft_torch/native_src/`` so that ``tpufft/native.py`` and
``tpufft_torch/native.py`` can rebuild the engine on the target host; each
copy is produced HERE at build time — it is not committed (round-3 review:
the committed twin was 1,401 phantom lines).
"""
import os
import shutil

from setuptools import setup
from setuptools.command.build_py import build_py


class _BuildPy(build_py):
    def run(self):
        root = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(root, "native", "tpufft_cpu.cpp")
        if os.path.exists(src):
            for pkg in ("tpufft", "tpufft_torch"):
                dst_dir = os.path.join(root, pkg, "native_src")
                os.makedirs(dst_dir, exist_ok=True)
                shutil.copy2(src, os.path.join(dst_dir, "tpufft_cpu.cpp"))
        super().run()


setup(cmdclass={"build_py": _BuildPy})

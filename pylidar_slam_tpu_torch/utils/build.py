"""Builds the port's native code (host C++ and CUDA) at first use.

Every library lands in ``build/`` at the repository root (git-ignored),
under a name keyed by a hash of its sources and compiler command, so an
edited source rebuilds and a stale library is never loaded.  The compiler
writes to a per-process temporary file that is renamed into place, so
concurrent test workers never read a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Sequence

from pylidar_slam_tpu_torch.utils.timer import span

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build"


class BuildError(RuntimeError):
    """The compiler is missing or rejected a source."""


def build_shared_library(name: str, sources: Sequence[Path],
                         command: Sequence[str], subdir: str,
                         host_specific: bool = False) -> Path:
    """Compiles `sources` with `command` (everything but ``-o`` and the
    source list) into ``build/<subdir>/lib<name>-<hash>.so``; returns its
    path, reusing an existing build of the same sources and command.

    `host_specific` adds the host's name to the key, for code built for the
    host's own CPU (``-march=native``), so a build directory copied to
    another machine is not reused there."""
    digest = hashlib.sha256(" ".join(command).encode())
    if host_specific:
        digest.update(platform.node().encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    out = BUILD_DIR / subdir / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = list(command) + ["-o", str(tmp)] + [str(s) for s in sources]
    try:
        # a compiler run, not a cache hit: `kernels.build` for the CUDA
        # kernels, `native.build` for the host library
        with span(f"{subdir}.build"):
            proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise BuildError(f"compiler not found: {command[0]}") from e
    if proc.returncode != 0:
        raise BuildError(f"{' '.join(cmd)}\nfailed with code {proc.returncode}:\n"
                         f"{proc.stderr[-4000:]}")
    # the compiler's report (e.g. ptxas register and spill counts)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out

"""Build a shared library from the repository's native sources at first use.

The library lands in native/build/ (listed in .gitignore) under a name keyed
on a hash of the sources, the compiler's version and the full compile
command (which names the target), so a copied tree can never load a stale
build the way an mtime check could. The compiler writes to a temporary file
that is renamed into place under a file lock: several test workers may ask
for the same library at once, and exactly one builds it.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import pathlib
import subprocess

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = NATIVE_DIR / "build"


def library_path(name: str, sources: list[pathlib.Path], command: list[str]) -> pathlib.Path:
    """Where `build_library` puts (or finds) the build of `sources`."""
    version = subprocess.run(
        [command[0], "--version"], capture_output=True, text=True, check=True
    ).stdout
    key = hashlib.sha256()
    for src in sources:
        key.update(src.name.encode())
        key.update(src.read_bytes())
    key.update(version.encode())
    key.update("\0".join(command).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build_library(
    name: str, sources: list[pathlib.Path], units: list[pathlib.Path], command: list[str]
) -> pathlib.Path:
    """Compile `units` with `command` (compiler and flags, without inputs or
    output) into a shared library and return its path. `sources` lists every
    file the build reads, headers included; all of them enter the key."""
    out = library_path(name, sources, command)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(
                [*command, *map(str, units), "-o", str(tmp)],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {out.name} failed:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out

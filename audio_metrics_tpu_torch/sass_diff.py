"""Compare the kernel library's SASS with another checkout's by function.

    python -m audio_metrics_tpu_torch.sass_diff OTHER_CHECKOUT \
        [--rename OLD=NEW ...]

Builds this checkout's library (``kernels.build()``), compiles every ``.cu``
of OTHER_CHECKOUT's ``audio_metrics_tpu_torch/kernels/csrc`` with the same
``nvcc`` flags (one process per source, all started together), dumps both
with ``cuobjdump -sass`` and holds every function of the other checkout
against the function of the same name here: its instructions with the
addresses stripped, its name with the hash of the per-file anonymous
namespace removed.  ``--rename OLD=NEW`` maps a fragment of a mangled name
that changed between the two (a template that gained a parameter).  Prints
each function that differs or is missing, and a summary; exits 1 if any
does.  It shows that a change left a kernel's compiled code as it was.
Needs ``nvcc`` and ``cuobjdump`` (a machine with the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                              "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def functions(path: str) -> dict[str, list[str]]:
    """``cuobjdump -sass`` of a library or object: {normalised name: its
    instructions without addresses}."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", path], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = f.split("\n", 1)
        out[ANON.sub("ANON", name.strip())] = [
            re.sub(r"\s+", " ", ADDRESS.sub("", line)).strip()
            for line in body.splitlines() if ADDRESS.search(line)
        ]
    return out


def other_objects(checkout: Path, flags: list[str], out_dir: str) -> list[str]:
    """Every ``.cu`` of ``checkout``'s kernel sources compiled to an object."""
    srcs = sorted((checkout / "audio_metrics_tpu_torch" / "kernels" / "csrc").glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no kernel sources under {checkout}")
    objs, procs = [], []
    for src in srcs:
        obj = os.path.join(out_dir, src.stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen([_tool("nvcc"), *flags, "-c", "-o", obj, str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    for p, src in zip(procs, srcs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return objs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--rename", action="append", default=[], metavar="OLD=NEW",
                    help="a mangled-name fragment of the other checkout and its name here")
    args = ap.parse_args(argv)
    renames = [tuple(r.split("=", 1)) for r in args.rename]

    from . import kernels

    here = functions(kernels.build()._name)
    with tempfile.TemporaryDirectory() as tmp:
        there = {}
        for obj in other_objects(args.other, kernels._NVCC_FLAGS, tmp):
            there.update(functions(obj))
    same = differ = missing = 0
    for name, ins in there.items():
        mapped = name
        for old, new in renames:
            mapped = mapped.replace(old, new)
        if mapped not in here:
            missing += 1
            print(f"  missing here: {name}")
        elif here[mapped] != ins:
            differ += 1
            print(f"  differs ({len(ins)} -> {len(here[mapped])} instructions): {name}")
        else:
            same += 1
    print(f"{len(there)} functions of {args.other}: {same} identical here, {differ} differ, "
          f"{missing} missing; {len(here)} functions here")
    return 1 if differ or missing else 0


if __name__ == "__main__":
    sys.exit(main())

"""Compare the machine code of two versions of a kernel source, kernel by kernel.

Run on a machine with the CUDA toolkit (``nvcc``, ``cuobjdump``), from the
root of a checkout:

    git show <commit>:distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu > /tmp/old.cu
    python -m distmlip_tpu_torch.tools.sass_compare /tmp/old.cu \\
        distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu

Compiles each source to a cubin with the port's flags (``kernels/build.py``,
``-cubin`` in place of ``-shared``), disassembles it (``cuobjdump -sass``)
and, for every kernel of the first source, finds the kernel of the second
whose demangled name matches up to its template arguments (``float``
instantiations are matched to untemplated kernels, and a leading
``float`` storage type to the same kernel without it), then prints the
instruction counts and whether the instruction text is the same with
addresses and encodings stripped. A kernel whose code a change must not
move (a float32 instantiation beside a new bfloat16 one) shows
``identical: True``. Exits 1 when a matched kernel differs.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile


def sass(source: str, workdir: str) -> dict:
    """{demangled kernel name: [instruction text]} of ``source``."""
    from distmlip_tpu_torch.kernels.build import NVCC_FLAGS, nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    cubin = os.path.join(workdir, os.path.basename(source) + f".{len(os.listdir(workdir))}.cubin")
    subprocess.run([nvcc(), *flags, "-cubin", "-o", cubin, source], check=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    names = subprocess.run(["c++filt"], input="\n".join(
        re.findall(r"Function : (\S+)", text)), check=True, capture_output=True,
        text=True).stdout.splitlines()
    out, body = {}, None
    it = iter(names)
    for line in text.splitlines():
        if re.match(r"\s*Function : ", line):
            body = out.setdefault(next(it), [])
            continue
        ins = re.sub(r"/\*.*?\*/", "", line).split(";")[0].strip()
        if body is not None and ins:
            body.append(ins)
    return out


def base_name(name: str) -> tuple:
    """(kernel name without return type, namespace or arguments, its
    template arguments, ``float`` where it has none). A leading ``float``
    storage-type argument is dropped from a longer list, so
    ``k<float, true, 64>`` matches the untyped ``k<true, 64>``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    m = re.match(r"(?:void )?(?:\w+::)*(\w+)(?:<(.+)>)?$", head.strip())
    args = m.group(2) or "float"
    if args.startswith("float, "):
        args = args[len("float, "):]
    return m.group(1), args


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        old, new = (sass(path, tmp) for path in argv)
    new_by = {base_name(n): body for n, body in new.items()}
    differ = False
    for name, body in sorted(old.items()):
        key = base_name(name)
        match = new_by.get(key)
        if match is None:  # a kernel the change removed or renamed: listed, not compared
            print(f"{key[0]}<{key[1]}>: only in the first source, {len(body)} instructions")
            continue
        same = match == body
        differ |= not same
        print(f"{key[0]}<{key[1]}>: {len(body)} instructions, the second source "
              f"{len(match)}, identical: {same}")
    for key, body in sorted(new_by.items()):
        if key not in {base_name(n) for n in old}:
            print(f"{key[0]}<{key[1]}>: only in the second source, {len(body)} instructions")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

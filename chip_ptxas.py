"""Registers and spills of every kernel the port builds, as ``nvcc
-Xptxas -v`` reports them, for this checkout and, given another one
(e.g. its parent commit, unpacked with ``git archive``), side by side.

Each ``horovod_tpu_torch/csrc/*.cu`` of each checkout is compiled with
the port's own flags (``ops/cuda/_build.py``'s ``NVCC_FLAGS``) plus
``-Xptxas -v``, one ``nvcc`` a source, all started together.  Prints a
line a kernel (demangled; its registers, spill stores and loads, stack
frame) and, with another checkout, whether it is new or differs there.
Exits 1 if a kernel that both checkouts build spills more here.  Writes
the compiler's own output to ``chiprun_out/ptxas/<checkout>/``.

    python3 chip_ptxas.py [OTHER_DIR]
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
USAGE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def _demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            .replace("void ", "") for n in out.splitlines()]


def kernels(tree, tag):
    """{kernel: (registers, spill stores, spill loads, stack)} of every
    source of ``tree``; the compiler's output under
    ``chiprun_out/ptxas/<tag>/``."""
    sys.path.insert(0, HERE)
    from horovod_tpu_torch.ops.cuda import _build

    csrc = os.path.join(tree, "horovod_tpu_torch", "csrc")
    logs = os.path.join(HERE, "chiprun_out", "ptxas", tag)
    os.makedirs(logs, exist_ok=True)
    objs = tempfile.mkdtemp(prefix="ptxas_")
    procs = []
    for name in sorted(f for f in os.listdir(csrc) if f.endswith(".cu")):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               csrc, "-c", os.path.join(csrc, name), "-o",
               os.path.join(objs, name + ".o")]
        log = open(os.path.join(logs, name + ".txt"), "w")
        procs.append((name, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    found = {}
    for name, log, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}: see {log.name}")
        log.close()
        mangled, cur = [], None
        with open(log.name) as f:
            for line in f:
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    cur = [m.group(1), None, None]
                    mangled.append(cur)
                elif cur is not None and USAGE.search(line):
                    cur[1] = tuple(int(x)
                                   for x in USAGE.search(line).groups())
                elif cur is not None and REGS.search(line):
                    cur[2] = int(REGS.search(line).group(1))
        for (_, spill, regs), kernel in zip(
                mangled, _demangle([m[0] for m in mangled])):
            stack, stores, loads = spill
            found[kernel] = (regs, stores, loads, stack)
    shutil.rmtree(objs, ignore_errors=True)
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="another checkout to compare")
    args = ap.parse_args(argv)
    mine = kernels(HERE, "this")
    other = kernels(os.path.abspath(args.other), "other") \
        if args.other else None
    worse = []
    for kernel in sorted(mine):
        regs, stores, loads, stack = mine[kernel]
        note = ""
        if other is not None:
            if kernel not in other:
                note = " (new)"
            elif other[kernel] == mine[kernel]:
                note = " (same as the other checkout)"
            else:
                note = f" (the other checkout: {other[kernel]})"
                if stores > other[kernel][1]:
                    worse.append(kernel)
        print(f"{kernel}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads, {stack} bytes stack{note}",
              flush=True)
    if worse:
        print(f"spill more than the other checkout: {worse}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

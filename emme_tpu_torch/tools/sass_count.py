"""Instruction counts of the CUDA kernels, from their machine code.

    python3 emme_tpu_torch/tools/sass_count.py

Builds the package's kernels (nvcc, as at first use), disassembles each
library with ``cuobjdump -sass`` and prints one JSON line per kernel
function: instructions in all, float32 arithmetic by opcode (FFMA, FMUL,
FADD, MUFU and the other F* opcodes), float64 arithmetic, and the float32
operations they stand for (an FMA counts as two).  The count is static:
every instruction of the function once.  For a body without loops over its
arithmetic (one node of K1's integrand, one marker-stage of K2 or K3) that
is what one pass through the body runs, if it takes every branch.

A node or a marker takes one side of each Bessel function's split (the
Taylor sums or the asymptotic forms), never both.  So ``kappa.cu`` and
``pic.cu`` are also compiled with ``-DEMME_BESSEL_BRANCH=1`` (Taylor alone)
and ``=2`` (asymptotic alone) into a scratch directory, only to be counted:
lines with ``"branch": "taylor"`` or ``"asymptotic"`` give what a node or
marker on that path executes, ``"branch": "both"`` the libraries the package
loads.  For K3 the counted function is one stage's marker loop of
``pic_mega_kernel`` on its own (``k3_stage<s>``: J0 and the phase factor
carried in, not computed), which the scratch builds of ``pic.cu`` (one of
them with both branches) wrap in a kernel.
"""

import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[2]
KERNELS = ("kappa", "pic", "spmv")
BRANCHES = {0: "both", 1: "taylor", 2: "asymptotic"}
INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)")
# One stage's marker loop of K3, drift-center on, as a kernel of its own
# (the small-grid form: field and histogram in shared memory).
K3_STAGES = """
#define K3_STAGE(name, STAGE, FIRST)                                       \\
  __global__ void __launch_bounds__(kThreads)                              \\
  name(Params P, Markers mk, MegaState st, int m, int nf) {                \\
    extern __shared__ float smem[];                                        \\
    mega_markers<STAGE, FIRST, true, kFormShared>(                         \\
        P, planes<kFormShared>(smem, nullptr, nullptr, nullptr, nf), mk,   \\
        st, m, nf, true);                                                  \\
  }
K3_STAGE(k3_stage0_first, 0, true)
K3_STAGE(k3_stage0, 0, false)
K3_STAGE(k3_stage1, 1, false)
K3_STAGE(k3_stage2, 2, false)
"""


def count(sass):
    """{function: Counter(opcode base -> n)} of a cuobjdump -sass dump."""
    out, cur = {}, None
    for line in sass.splitlines():
        fn = re.match(r"\s*Function : (\S+)", line)
        if fn:
            cur = out.setdefault(fn.group(1), collections.Counter())
            continue
        m = INSTR.match(line)
        if m and cur is not None:
            cur[m.group(1).split(".")[0]] += 1
    return out


def kernel_name(demangled):
    """``pic_stage_kernel<1, false, true>`` out of a demangled signature."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", demangled.replace(
        "(anonymous namespace)::", ""))
    return (m.group(1) + (m.group(2) or "")) if m else demangled


def report(library, branch, binary):
    """One JSON line per kernel function of ``binary``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    filt = shutil.which("c++filt")
    sass = subprocess.run([tool, "-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout
    for fn, ops in count(sass).items():
        pretty = fn
        if filt:
            pretty = subprocess.run([filt, fn], capture_output=True,
                                    text=True).stdout.strip() or fn
        f32 = {k: v for k, v in ops.items()
               if k.startswith("F") and k not in ("FLO", "F2I", "F2F",
                                                  "FRND", "F2FP")}
        f64 = {k: v for k, v in ops.items() if k.startswith("D")
               and k != "DEPBAR"}
        mufu = ops.get("MUFU", 0)
        flops = sum(v * (2 if k == "FFMA" else 1) for k, v in f32.items()
                    if k in ("FFMA", "FMUL", "FADD")) + mufu
        print(json.dumps({
            "library": library, "branch": branch,
            "function": kernel_name(pretty),
            "instructions": sum(ops.values()), "float32": f32,
            "mufu": mufu, "float64": f64, "float32_operations": flops,
            "other_top": dict(collections.Counter({
                k: v for k, v in ops.items()
                if k not in f32 and k not in f64}).most_common(8)),
        }), flush=True)


def one_branch_cubin(nvcc, name, branch, scratch):
    """``csrc/<name>.cu`` with one Bessel branch compiled, as a cubin in
    ``scratch`` (device code only; never loaded)."""
    src = ROOT / "emme_tpu_torch" / "csrc" / f"{name}.cu"
    unit = scratch / f"{name}_{branch}.cu"
    unit.write_text(f'#include "{src}"\n' + (K3_STAGES if name == "pic" else ""))
    out = scratch / f"{name}_{branch}.cubin"
    proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-cubin",
                           f"-DEMME_BESSEL_BRANCH={branch}", "-o", str(out),
                           str(unit)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {unit.name}:\n{proc.stderr}")
    return out


def main():
    sys.path.insert(0, str(ROOT))
    from emme_tpu_torch import _build
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(7) as pool:
        built = {name: pool.submit(_build.build, name) for name in KERNELS}
        cubins = {(name, b): pool.submit(one_branch_cubin, _build.nvcc_path(),
                                         name, b, pathlib.Path(tmp))
                  for name, b in (("kappa", 1), ("kappa", 2), ("pic", 0),
                                  ("pic", 1), ("pic", 2))}
        for name in KERNELS:
            report(name, "both", built[name].result()["path"])
        for (name, b), cubin in cubins.items():
            report(f"{name} (scratch build)", BRANCHES[b], cubin.result())


if __name__ == "__main__":
    main()

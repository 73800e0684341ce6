"""Command-line driver: ``python -m emme_tpu_torch.cli [input.json]``.

Unlike the reference's hard-coded ``input.json`` in the cwd (main.cpp:183),
the input path, output directory, compute device, and dtype are selectable.
Counterpart of ``emme_tpu/cli.py``; the job runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="emme_tpu_torch",
        description="Gyrokinetic eigensolver on a CUDA card "
                    "(EMME-compatible inputs)")
    ap.add_argument("input", nargs="?", default="input.json",
                    help="input JSON file (default: input.json)")
    ap.add_argument("-o", "--output-dir", default=".",
                    help="directory for output.json and eigenMatrics/")
    ap.add_argument("--device", choices=["auto", "cuda", "cpu"],
                    default="auto",
                    help="compute device: auto and cuda are the CUDA card "
                         "(an error where there is none), cpu the host "
                         "(default: auto)")
    ap.add_argument("--f32", action="store_true",
                    help="single precision (complex64) -- the fast path "
                         "through the CUDA kernels; an input with "
                         "\"eigen_backend\": \"exact\" (the float64 "
                         "adaptive engine) refuses it")
    ap.add_argument("--host64", action="store_true",
                    help="hybrid polish: assembly in the working precision "
                         "+ complex128 linear algebra on the same device "
                         "(reference tolerance from --f32)")
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="disable scan checkpoint/resume")
    ap.add_argument("--chunk", type=int, default=2048,
                    help="assembly pair-chunk size")
    ap.add_argument("--scan-mode", choices=["wavefront", "independent"],
                    default="wavefront",
                    help="parallel-scan seeding: wavefront keeps eigenvalue "
                         "continuation in batches; independent seeds every "
                         "point from the user guess")
    ap.add_argument("--scan-workers", type=int, default=1,
                    help="solve this many scan points (or shifts) "
                         "concurrently in threads that share the device; "
                         "the continuation seed then lags up to that many "
                         "points")
    ap.add_argument("--mesh-rows", type=int, default=None,
                    help="distribute every solve over this many ranks "
                         "(one card a rank over NCCL; gloo processes with "
                         "--device cpu)")
    ap.add_argument("--mesh-scan", type=int, default=None,
                    help="rows x scan topology: this many groups of "
                         "--mesh-rows ranks solve scan points or shifts "
                         "concurrently")
    ap.add_argument("--debug", action="store_true",
                    help="EMME_DEBUG analogue: input dimension/positivity "
                         "validation + finiteness checks of every result")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cpu":
        device = "cpu"
    elif not torch.cuda.is_available():
        # never carry on on the CPU unasked: a run that was meant for the
        # card would silently take hours
        ap.exit(2, f"{ap.prog}: error: --device {args.device} needs a CUDA "
                   "card and torch.cuda.is_available() is False; pass "
                   "--device cpu to run on the CPU\n")
    else:
        device = "cuda"

    from . import driver
    dtype = torch.float32 if args.f32 else torch.float64
    driver.run(args.input, output_dir=args.output_dir, dtype=dtype,
               device=device, checkpoint=not args.no_checkpoint,
               verbose=not args.quiet, chunk=args.chunk, host64=args.host64,
               scan_workers=args.scan_workers, scan_mode=args.scan_mode,
               mesh_rows=args.mesh_rows, mesh_scan=args.mesh_scan,
               debug=args.debug)
    return 0


if __name__ == "__main__":
    sys.exit(main())

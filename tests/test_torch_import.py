"""emme_tpu_torch stands alone: it imports torch and numpy, never jax."""
import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "emme_tpu_torch"

MODULES = [
    "emme_tpu_torch", "emme_tpu_torch.params", "emme_tpu_torch.geometry",
    "emme_tpu_torch.grid", "emme_tpu_torch.convert", "emme_tpu_torch._build",
    "emme_tpu_torch.native",
    "emme_tpu_torch.driver", "emme_tpu_torch.cli", "emme_tpu_torch.utils",
    "emme_tpu_torch.utils.timer", "emme_tpu_torch.utils.provenance",
    "emme_tpu_torch.utils.debug",
    "emme_tpu_torch.ops", "emme_tpu_torch.solvers",
    "emme_tpu_torch.ops.singularity", "emme_tpu_torch.ops.quadrature",
    "emme_tpu_torch.ops.bessel", "emme_tpu_torch.ops.kernels",
    "emme_tpu_torch.ops.cuda_kappa", "emme_tpu_torch.ops.cuda_assembly",
    "emme_tpu_torch.ops.cuda_guard",
    "emme_tpu_torch.ops.linalg",
    "emme_tpu_torch.ops.sparse", "emme_tpu_torch.ops.cuda_spmv",
    "emme_tpu_torch.ops.banded",
    "emme_tpu_torch.ops.adaptive", "emme_tpu_torch.ops.cuda_adaptive",
    "emme_tpu_torch.solvers.eigen", "emme_tpu_torch.solvers.pic",
    "emme_tpu_torch.solvers.cuda_pic", "emme_tpu_torch.solvers.arnoldi",
    "emme_tpu_torch.solvers.sparse_eigen",
    "emme_tpu_torch.solvers.eigen_native", "emme_tpu_torch.solvers.newton",
    "emme_tpu_torch.parallel", "emme_tpu_torch.parallel.mesh",
    "emme_tpu_torch.parallel.sharded", "emme_tpu_torch.parallel.spike",
    "emme_tpu_torch.tools", "emme_tpu_torch.tools.pic_bench",
    "emme_tpu_torch.tools.sass_count", "emme_tpu_torch.tools.spmv_bench",
    "emme_tpu_torch.tools.div_const_check",
    "emme_tpu_torch.tools.native_bench",
]


def test_modules_list_covers_package():
    found = {".".join(("emme_tpu_torch",) + p.relative_to(PKG).with_suffix("").parts)
             .removesuffix(".__init__") for p in PKG.rglob("*.py")}
    assert found == set(MODULES)


def test_import_leaves_jax_unloaded():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_statement():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert offenders == []


# the public functions each slice added, by module
ENTRY_POINTS = {
    "emme_tpu_torch.solvers.arnoldi": (
        "arnoldi_factorization", "ritz_from_hessenberg",
        "shift_invert_factorization", "solve_one_shift", "solve",
        "solve_shifts_batched"),
    "emme_tpu_torch.ops.bessel": ("bessel_i01_scaled",
                                  "bessel_i01_scaled_miller"),
    "emme_tpu_torch.ops.quadrature": ("panel_points", "panel_reduce",
                                      "integrate_fixed"),
    "emme_tpu_torch.solvers.cuda_pic": ("form", "run", "stage", "mega"),
    "emme_tpu_torch.driver": ("fused_pic_ok", "solve_once_pic"),
    "emme_tpu_torch.parallel.mesh": (
        "make_mesh", "distributed_init", "launch", "axis_index", "all_gather",
        "psum", "broadcast", "ppermute", "all_gather_object"),
    "emme_tpu_torch.parallel.sharded": (
        "sharded_assemble", "sharded_newton_step", "sharded_init_state",
        "solve", "shard_bdia", "bdia_matvec_local", "sharded_bdia_matvec",
        "pic_sharded_step", "pic_sharded_run", "pic_sharded_run_timed",
        "pic_sharded_run_streaming"),
    "emme_tpu_torch.parallel.spike": (
        "sharded_assemble_bdia", "sharded_trace_d_omega", "sharded_solve_vec",
        "sharded_bordered_d_omega", "sharded_nullspace", "solve"),
    "emme_tpu_torch.solvers.sparse_eigen": ("assemble_bdia_window",
                                            "solve_shifts"),
    "emme_tpu_torch.native": ("phys_from_params", "g_bi", "kappa_batch",
                              "assemble", "assembly_plan", "available",
                              "build"),
    "emme_tpu_torch.solvers.eigen_native": ("solve",),
    "emme_tpu_torch.solvers.newton": ("seed", "advance", "step", "run",
                                      "polish", "item", "items"),
    "emme_tpu_torch.solvers.eigen": ("discretization", "assembler",
                                     "secant"),
    "emme_tpu_torch.ops.cuda_adaptive": ("integrate", "build", "flop_count"),
    "emme_tpu_torch.ops.adaptive": ("integrate_ref", "bessel_i01", "g_eta",
                                    "bi_eta", "pair_rows", "kappa_electron",
                                    "electron_pairs"),
}


def test_entry_points_import_without_jax():
    """Every listed function is there, callable, with jax never loaded."""
    code = ("import importlib, sys\n"
            f"for m, names in {ENTRY_POINTS!r}.items():\n"
            "    mod = importlib.import_module(m)\n"
            "    assert all(callable(getattr(mod, n)) for n in names), m\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

"""The port's contract with the rest of the repository, on the CPU.

* ``repro_torch`` imports neither JAX nor the reference package, checked in
  a fresh interpreter and in the source text.
* Its entry points run on the GPU by default and raise without one; the
  CPU runs only when the caller names it.
* CUDA kernels build only at first use, never at import.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import band_reduction, cholesky, gauss_jordan, ldlt, \
    lookahead, lu
from repro_torch.kernels import _build
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, convert
from repro_torch import tune
from repro_torch.solve import (CholeskyFactors, HessenbergFactors,
                               LDLTFactors, LUFactors, QRCPFactors,
                               QRFactors, cholesky_factor, gecon, gehrd,
                               geqp3, gels, gesv, getri, ldlt_factor,
                               lu_factor, posv, qr_factor)

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"

_CHILD = """
import sys
import repro_torch.solve, repro_torch.kernels.ops, repro_torch.obs
import repro_torch.core.ldlt, repro_torch.core.gauss_jordan
import repro_torch.core.band_reduction
import repro_torch.configs, repro_torch.models.api, repro_torch.models.convert
import repro_torch.serve.engine, repro_torch.serve.metrics
import repro_torch.launch.serve
import repro_torch.core.tiles, repro_torch.tune, repro_torch.tune.sweep
import repro_torch.obs.report, repro_torch.obs.export
import repro_torch.core.distributed, repro_torch.launch.mesh
import repro_torch.parallel
from repro_torch.kernels import _build
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) + "|" + ",".join(_build._LIBS))
"""


def test_import_leaves_no_jax_or_reference_module_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    assert proc.stdout.strip() == "|"


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_no_source_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    assert {PORT / "core" / "hessenberg.py",
            PORT / "kernels" / "panel_hessenberg.py",
            PORT / "kernels" / "attention.py",
            PORT / "configs" / "base.py", PORT / "configs" / "registry.py",
            PORT / "models" / "layers.py", PORT / "models" / "transformer.py",
            PORT / "models" / "api.py", PORT / "models" / "convert.py",
            PORT / "models" / "rwkv6.py", PORT / "kernels" / "wkv6.py",
            PORT / "configs" / "rwkv6_7b.py",
            PORT / "obs" / "metrics.py", PORT / "serve" / "engine.py",
            PORT / "serve" / "metrics.py",
            PORT / "launch" / "serve.py", PORT / "core" / "ldlt.py",
            PORT / "core" / "gauss_jordan.py",
            PORT / "core" / "band_reduction.py", PORT / "core" / "tiles.py",
            PORT / "obs" / "report.py", PORT / "obs" / "export.py",
            PORT / "tune" / "__init__.py", PORT / "tune" / "cache.py",
            PORT / "tune" / "model.py", PORT / "tune" / "schedule.py",
            PORT / "tune" / "sweep.py", PORT / "core" / "distributed.py",
            PORT / "launch" / "mesh.py",
            PORT / "parallel" / "sharding.py"} <= set(files)
    offenders = [str(f.relative_to(SRC)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_chip_smoke_and_tools_import_no_jax_or_the_reference():
    scripts = [SRC.parent / "chip_smoke.py",
               *sorted((SRC.parent / "tools").glob("*.py"))]
    assert len(scripts) > 1
    assert [str(f.name) for f in scripts
            if _FORBIDDEN.search(f.read_text())] == []


@pytest.mark.parametrize("entry", ["lu_factor", "gesv", "variant",
                                   "from_numpy", "lu_blocked",
                                   "cholesky_factor", "posv", "la_mb",
                                   "chol_from_numpy", "cholesky_blocked",
                                   "qr_factor", "gels", "gels_pivot",
                                   "geqp3", "qr_from_numpy",
                                   "qrcp_from_numpy", "gehrd", "gecon",
                                   "getri", "hessenberg_from_numpy",
                                   "ldlt_factor", "getri_gj",
                                   "ldlt_from_numpy", "ldlt_blocked",
                                   "gj_inverse_blocked", "band_reduction",
                                   "band_variant", "tiled", "tuned",
                                   "search",
                                   "init_params", "init_decode_cache",
                                   "params_from_numpy", "serve_main",
                                   "serve_rwkv"])
def test_entry_points_default_to_the_gpu_and_raise_without_one(
        monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = np.eye(4), np.ones((4, 1))
    small = reduced_config(get_config("phi3-medium-14b"))
    calls = {
        "lu_factor": lambda: lu_factor(a, 2),
        "gesv": lambda: gesv(a, b, 2),
        "variant": lambda: lookahead.get_variant("lu", "la2")(a, 2),
        "from_numpy": lambda: LUFactors.from_numpy(a, np.arange(4), block=2),
        "lu_blocked": lambda: lu.lu_blocked(a, 2, backend="torch"),
        "cholesky_factor": lambda: cholesky_factor(a, 2),
        "posv": lambda: posv(a, b, 2),
        "la_mb": lambda: lookahead.get_variant("cholesky", "la_mb")(a, 2),
        "chol_from_numpy": lambda: CholeskyFactors.from_numpy(a, block=2),
        "cholesky_blocked": lambda: cholesky.cholesky_blocked(
            a, 2, backend="torch"),
        "qr_factor": lambda: qr_factor(a, 2),
        "gels": lambda: gels(a, b, 2),
        "gels_pivot": lambda: gels(a, b, 2, pivot=True, local=True),
        "geqp3": lambda: geqp3(a, 2),
        "qr_from_numpy": lambda: QRFactors.from_numpy(a, np.ones(4), block=2),
        "qrcp_from_numpy": lambda: QRCPFactors.from_numpy(
            a, np.ones(4), np.arange(4), block=2),
        "gehrd": lambda: gehrd(a, 2),
        "gecon": lambda: gecon(a, 2),
        "getri": lambda: getri(a, 2),
        "hessenberg_from_numpy": lambda: HessenbergFactors.from_numpy(
            a, np.ones(4), block=2),
        "ldlt_factor": lambda: ldlt_factor(a, 2),
        "getri_gj": lambda: getri(a, 2, method="gj"),
        "ldlt_from_numpy": lambda: LDLTFactors.from_numpy(a, block=2),
        "ldlt_blocked": lambda: ldlt.ldlt_blocked(a, 2, backend="torch"),
        "gj_inverse_blocked": lambda: gauss_jordan.gj_inverse_blocked(
            a, 2, backend="torch"),
        "band_reduction": lambda: band_reduction.band_reduction_blocked(
            a, 2, backend="torch"),
        "band_variant": lambda: lookahead.get_variant(
            "band_reduction", "la")(a, 2),
        "tiled": lambda: lookahead.get_variant("cholesky", "tiled")(a, 2),
        "tuned": lambda: lookahead.get_variant("lu", "tuned")(a, 2),
        "search": lambda: tune.search("lu", 4, blocks=(2,)),
        "init_params": lambda: api.init_params(small, 0),
        "init_decode_cache": lambda: api.init_decode_cache(small, 1, 8),
        "params_from_numpy": lambda: convert.params_from_numpy(
            small, convert.params_to_numpy(
                api.init_params(small, 0, device="cpu"))),
        "serve_main": lambda: launch_serve.main(["--smoke"]),
        "serve_rwkv": lambda: launch_serve.main(["--arch", "rwkv6-7b",
                                                 "--smoke"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("driver", [
    gesv, posv, gels,
    lambda a, b, blk, **kw: ldlt_factor(a, blk, **kw).solve(b),
    lambda a, b, blk, **kw: getri(a, blk, method="gj", **kw)
    @ torch.from_numpy(b)])
def test_explicit_cpu_runs_and_returns_cpu_tensors(driver):
    x = driver(np.eye(4) * 4.0, np.ones((4, 1)), 2, device="cpu")
    assert x.device.type == "cpu"
    np.testing.assert_allclose(x.numpy(), np.full((4, 1), 0.25))


def test_every_kernel_source_is_built_and_counted():
    assert set(_build.sources()) == {"gemm", "trsm", "panel_lu", "fused_pu",
                                     "panel_qr", "panel_qrcp",
                                     "panel_hessenberg", "flash_attention",
                                     "wkv6"}
    from repro_torch.kernels import ops
    assert set(ops.KERNELS) == {"gemm_accum", "trsm", "lu_panel",
                                "lu_solve_small", "trsm_right_lower_t",
                                "fused_lu_panel_update",
                                "fused_cholesky_panel_update",
                                "cholesky_panel", "qr_panel",
                                "larft", "qrcp_panel", "hessenberg_panel",
                                "flash_attention", "wkv6_fused"}


def test_ptxas_summary_parses_a_verbose_log():
    log = ("ptxas info    : Compiling entry function '_Z4gemmv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z4gemmv\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers, 8256 bytes "
           "smem, 400 bytes cmem[0]\n")
    assert _build.ptxas_summary(log) == [{
        "kernel": "_Z4gemmv", "spill_stores": 8, "spill_loads": 4,
        "registers": 80, "smem_bytes": 8256}]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu_and_prints_no_result(tmp_path, where):
    script = SRC.parent / "chip_smoke.py"
    if where == "alone":   # a directory holding the script and nothing else
        (tmp_path / script.name).write_text(script.read_text())
        script = tmp_path / script.name
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""

"""Run ``chip_smoke.py``'s training phases (15e–15h) alone on the card.

    python3 tools/train_phases.py        # from the repository root; one GPU

Builds the kernels, then executes the phases' source as it stands in
``chip_smoke.py`` (from its ``# ---- 15e.`` marker to ``# ---- 16.``) with
the helpers they use from its ``main`` (``sync``, ``time_ms``,
``queued_ms``, ``wall_ms``, ``device_busy``, ``attn_err``,
``wkv_within``) and its constants: the same JSON lines and gates as in
the whole smoke run, in about a tenth of its time.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.core.backend import no_tf32  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, attention, ops  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("train_phases: no CUDA device")
dev = torch.device("cuda")
no_tf32()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(torch.__version__, torch.version.cuda, smi, flush=True)
t0 = time.perf_counter()
_build.build_all()
print("build", time.perf_counter() - t0, flush=True)

src = (ROOT / "chip_smoke.py").read_text()
a = src.index("    def device_busy(")
b = src.index("    def serve(cfg, phase, kernel):")
helpers = textwrap.dedent(src[a:b])
a = src.index("    def sync():", src.index("    dev = torch.device(\"cuda\")"))
b = src.index("    def tolerance(dtype, k)")
helpers = textwrap.dedent(src[a:b]) + helpers
a = src.index("    def attn_err(")
b = src.index("    # ---- 1. device")
helpers += textwrap.dedent(src[a:b])
a = src.index("    def wkv_within(")
b = src.index("    def wkv_bound(")
helpers += textwrap.dedent(src[a:b])
a = src.index("    # ---- 15e.")
b = src.index("    # ---- 16. report")
block = textwrap.dedent(src[a:b])
ns = {k: getattr(C, k) for k in dir(C) if k.isupper()}
ns.update(dict(torch=torch, np=np, dev=dev, smi=smi, time=time, statistics=statistics,
               dataclasses=dataclasses, tempfile=tempfile, json=json,
               attention=attention, wkv=wkv, ops=ops, get_config=get_config,
               check=C.check, emit=C.emit, _as_tuple=C._as_tuple))
t0 = time.perf_counter()
exec(compile(helpers + block, "train_phases", "exec"), ns)
print("phases", time.perf_counter() - t0, flush=True)

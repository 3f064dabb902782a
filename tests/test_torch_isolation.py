"""repro_torch stands alone: it imports neither JAX nor the JAX package.

A subprocess imports the port and every one of its modules and then
checks ``sys.modules``; a source scan catches imports on code paths the
import does not execute (function-local imports).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[1]
_PORT = _REPO / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))", re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), ",".join(names), bad)
"""

# Modules each slice added; the walk above must reach them.
_SLICE_MODULES = {"repro_torch.core.lanczos", "repro_torch.core.flexcg",
                  "repro_torch.core.inverse_iteration", "repro_torch.core.amg",
                  "repro_torch.kernels.ell_spmv.cuda",
                  "repro_torch.kernels._build", "repro_torch.core.kway",
                  "repro_torch.kernels.segment_sum.cuda",
                  "repro_torch.kernels.segment_sum.ops",
                  "repro_torch.kernels.segment_sum.ref",
                  "repro_torch.dist.partition_aware",
                  "repro_torch.dist.refine_sharded",
                  "repro_torch.kernels.flash_attention.cuda",
                  "repro_torch.kernels.flash_attention.ops",
                  "repro_torch.kernels.flash_attention.ref",
                  "repro_torch.models.common", "repro_torch.models.transformer",
                  "repro_torch.configs.tinyllama_1_1b",
                  "repro_torch.configs.shapes", "repro_torch.configs.base",
                  "repro_torch.guard.errors", "repro_torch.guard.validate",
                  "repro_torch.launch.serve",
                  "repro_torch.kernels.embedding_bag.cuda",
                  "repro_torch.kernels.embedding_bag.ops",
                  "repro_torch.kernels.embedding_bag.ref",
                  "repro_torch.models.recsys.embedding",
                  "repro_torch.models.recsys.sasrec",
                  "repro_torch.configs.sasrec", "repro_torch.data.synthetic",
                  "repro_torch.launch.cells", "repro_torch.guard.chaos",
                  "repro_torch.guard.policy", "repro_torch.core.multilevel",
                  "repro_torch.core.gather_scatter", "repro_torch.obs",
                  "repro_torch.obs.trace", "repro_torch.obs.registry",
                  "repro_torch.obs.export", "repro_torch.obs.profiler"}


def test_import_pulls_in_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, cwd=_REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    count, names, bad = out.stdout.strip().split(" ", 2)
    assert int(count) >= 67
    assert _SLICE_MODULES <= set(names.split(","))
    assert bad == "[]", bad


def test_sources_name_no_jax_and_no_repro():
    files = sorted(_PORT.rglob("*.py")) + [_REPO / "chip_smoke.py"]
    assert len(files) >= 69
    hits = [f"{f.relative_to(_REPO)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []

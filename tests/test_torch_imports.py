"""The port stands alone: importing it pulls in no JAX, nothing of the
JAX package and nothing of ``scripts/``, no source file of it (nor
``chip_smoke.py``) imports any of them, and ``chip_smoke.py`` refuses to
run without a CUDA device.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pytorch_distributed_template_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax",
                   "pytorch_distributed_template_tpu", "scripts"}
ENTRY_MODULES = [
    "pytorch_distributed_template_tpu_torch",
    "pytorch_distributed_template_tpu_torch.generate",
    "pytorch_distributed_template_tpu_torch.engine.serving",
    "pytorch_distributed_template_tpu_torch.engine.generate",
    "pytorch_distributed_template_tpu_torch.tools.make_serving_artifact",
    "pytorch_distributed_template_tpu_torch.ops.flash",
    "pytorch_distributed_template_tpu_torch.models.convert",
    "pytorch_distributed_template_tpu_torch.models.quant",
    "pytorch_distributed_template_tpu_torch.engine.kvcache",
    "pytorch_distributed_template_tpu_torch.engine.continuous",
    "pytorch_distributed_template_tpu_torch.serve",
    "pytorch_distributed_template_tpu_torch.utils.promtext",
    "pytorch_distributed_template_tpu_torch.train",
    "pytorch_distributed_template_tpu_torch.engine.trainer",
    "pytorch_distributed_template_tpu_torch.engine.steps",
    "pytorch_distributed_template_tpu_torch.engine.losses",
    "pytorch_distributed_template_tpu_torch.engine.metrics",
    "pytorch_distributed_template_tpu_torch.engine.optim",
    "pytorch_distributed_template_tpu_torch.checkpoint.manager",
    "pytorch_distributed_template_tpu_torch.data.datasets",
    "pytorch_distributed_template_tpu_torch.data.loader",
    "pytorch_distributed_template_tpu_torch.data.sampler",
    "pytorch_distributed_template_tpu_torch.models.transformer",
    "pytorch_distributed_template_tpu_torch.models.layers",
    "pytorch_distributed_template_tpu_torch.models.moe",
    "pytorch_distributed_template_tpu_torch.ops.expert_ffn",
    "pytorch_distributed_template_tpu_torch.tools.make_text_corpus",
    "pytorch_distributed_template_tpu_torch.test",
    "pytorch_distributed_template_tpu_torch.engine.evaluator",
    "pytorch_distributed_template_tpu_torch.parallel.dist",
    "pytorch_distributed_template_tpu_torch.parallel.mesh",
    "pytorch_distributed_template_tpu_torch.models.base",
    "pytorch_distributed_template_tpu_torch.models.lenet",
    "pytorch_distributed_template_tpu_torch.observability.trace",
    "pytorch_distributed_template_tpu_torch.observability.tracker",
    "pytorch_distributed_template_tpu_torch.observability.tb",
    "pytorch_distributed_template_tpu_torch.observability.telemetry",
    "pytorch_distributed_template_tpu_torch.observability.health",
    "pytorch_distributed_template_tpu_torch.observability.profiler",
    "pytorch_distributed_template_tpu_torch.observability.crosshost",
    "pytorch_distributed_template_tpu_torch.resilience.faults",
    "pytorch_distributed_template_tpu_torch.utils.compile_cache",
    "pytorch_distributed_template_tpu_torch.utils.preemption",
    "pytorch_distributed_template_tpu_torch.utils.watchdog",
    "pytorch_distributed_template_tpu_torch.resilience.supervisor",
    "pytorch_distributed_template_tpu_torch.supervise",
    "pytorch_distributed_template_tpu_torch.config.parser",
]


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_entry_modules_import_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {ENTRY_MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules "
        f"if k.split('.')[0] in {sorted(FORBIDDEN_ROOTS)!r})\n"
        "print(json.dumps(bad))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN_ROOTS, \
                f"{path.name}:{node.lineno} imports {name}"


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

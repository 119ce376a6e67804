"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the JAX package, and neither the package nor
``chip_smoke.py`` has a line importing them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib)\b"
    r"|from\s+repro(\.|\s))")

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for name in ("core.scheduler", "core.transforms", "core.recurrent",
                 "compile.keys", "compile.features", "search.model",
                 "compile.driver", "compile.cache", "verify",
                 "verify.diagnostics", "verify.program", "verify.selection",
                 "verify.schedule", "verify.artifact", "verify.fabric",
                 "verify.graph", "kernels.gemm", "kernels.gru", "kernels.ops",
                 "kernels.cuda", "fabric.topology", "fabric.collectives",
                 "fabric.partition", "fabric.simulate", "graph.ir",
                 "graph.trace", "graph.fuse", "graph.compile", "graph.execute",
                 "models.config", "models.traceable", "configs.registry",
                 "configs.whisper_medium", "dist", "dist.ctx",
                 "models.layers", "models.attention", "models.moe",
                 "models.transformer", "models.whisper", "models.xlstm",
                 "models.xlstm_lm", "models.mamba", "models.hybrid",
                 "models.api", "models.whisper_block_reference",
                 "models.resnet50_1x1_reference",
                 "models.convert", "launch", "launch.steps",
                 "launch.caches", "launch.serve", "launch.train",
                 "launch.mesh", "optim", "optim.adamw", "data",
                 "data.pipeline", "checkpoint", "checkpoint.ckpt", "runtime",
                 "runtime.fault_tolerance", "dist.compat", "dist.sharding",
                 "launch.dryrun", "launch.hlo_analysis", "launch.op_flops",
                 "serve", "serve.workload", "serve.scheduler", "serve.bucket",
                 "serve.simulate", "serve.__main__", "verify.serve",
                 "verify.mutate", "verify.cli", "verify.__main__",
                 "compile.__main__", "graph.__main__", "cli", "telemetry"):
        assert f"repro_torch.{name}" in res["modules"]


def test_no_source_line_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if FORBIDDEN.match(line)]
    assert hits == []
    assert FORBIDDEN.match("from repro.core import ir")
    assert FORBIDDEN.match("import jax.numpy as jnp")
    assert not FORBIDDEN.match("from repro_torch.core import ir")


def test_chip_smoke_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""

"""The port stands alone: importing it pulls in neither jax nor triton, and
no module of it (nor chip_smoke.py, nor the port's examples) imports jax or
the JAX package."""
import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def test_import_leaves_jax_and_triton_out():
    code = ("import sys, repro_torch, repro_torch.ft, repro_torch.serve, "
            "repro_torch.convert, repro_torch.launch.serve, "
            "repro_torch.serve.scheduler, "
            "repro_torch.kernels.fused_decode.kernel, "
            "repro_torch.kernels.qmatmul.ops, "
            "repro_torch.kernels.fault_inject.ops, "
            "repro_torch.kernels.protected_mm.ops, "
            "repro_torch.core.area, repro_torch.core.perfmodel, "
            "repro_torch.core.bayesopt, repro_torch.core.bit_importance, "
            "repro_torch.core.strategies, repro_torch.core.pipeline, "
            "repro_torch.core.flexhyca, repro_torch.core.importance, "
            "repro_torch.core.evaluate, repro_torch.data.pipeline, "
            "repro_torch.models.cnn, repro_torch.tree, repro_torch.optim, "
            "repro_torch.optim.adamw, repro_torch.train, "
            "repro_torch.train.train_step, repro_torch.train.checkpoint, "
            "repro_torch.train.trainer, repro_torch.launch.train, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.rglru, "
            "repro_torch.configs.qwen3_moe_235b_a22b, "
            "repro_torch.configs.mamba2_2_7b, "
            "repro_torch.configs.recurrentgemma_9b, "
            "repro_torch.configs.qwen2_7b, repro_torch.configs.glm4_9b, "
            "repro_torch.configs.gemma2_27b, repro_torch.configs.dbrx_132b, "
            "repro_torch.configs.seamless_m4t_medium, "
            "repro_torch.configs.paligemma_3b, "
            "repro_torch.parallel.ctx, repro_torch.parallel.sharding, "
            "repro_torch.parallel.compression, repro_torch.launch.mesh, "
            "repro_torch.train.elastic, repro_torch.launch.dryrun; "
            "bad = [m for m in ('jax', 'jaxlib', 'triton', 'repro') "
            "if m in sys.modules]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "examples").glob("torch_*.py")))
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "triton"), (f, mod)

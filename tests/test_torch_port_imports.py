"""The port stands alone: ``tpudepth_torch`` and ``chip_smoke.py`` import no
JAX, no flax, no optax, no orbax and nothing of ``tpudepth``."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpudepth")
# modules the walk must reach: the serving paths' models and kernel wrappers
REQUIRED = ("tpudepth_torch.models.sam", "tpudepth_torch.models.newcrf",
            "tpudepth_torch.ops.kernels.window_attn_infer",
            "tpudepth_torch.ops.kernels.epilogue_infer",
            "tpudepth_torch.ops.kernels.rowblock_infer",
            "tpudepth_torch.ops.kernels.block_infer",
            "tpudepth_torch.ops.kernels.window_attn",
            "tpudepth_torch.ops.kernels.mlp_train",
            "tpudepth_torch.ops.kernels.fused_root_loss",
            "tpudepth_torch.eval.evaluator",
            # the data feed and the command lines
            "tpudepth_torch.data.nyu", "tpudepth_torch.data.datasets",
            "tpudepth_torch.data.diskcache", "tpudepth_torch.data.synthetic",
            "tpudepth_torch.data.native", "tpudepth_torch.utils.viz",
            "tpudepth_torch.cli.guidedepth_main", "tpudepth_torch.cli.train",
            "tpudepth_torch.cli.test", "tpudepth_torch.cli.demo",
            "tpudepth_torch.inference",
            # the zoo, the serving ops and the engine's serialization
            "tpudepth_torch.models.decoders", "tpudepth_torch.models.registry",
            "tpudepth_torch.models.jax_weights", "tpudepth_torch.ops.kernels._op",
            "tpudepth_torch.ops.kernels.gub_conv",
            "tpudepth_torch.ops.kernels.mlp_infer",
            "tpudepth_torch.infer.engine",
            # packed stages, rematerialization, debug and trace helpers
            "tpudepth_torch.ops.packed", "tpudepth_torch.utils.debug",
            "tpudepth_torch.utils.profiling")
# (module, name): what those modules must define
REQUIRED_NAMES = (("tpudepth_torch.eval.evaluator", "RootEvaluator"),
                  ("tpudepth_torch.data", "get_dataloader"),
                  ("tpudepth_torch.data.native", "decode_batch_raw"),
                  ("tpudepth_torch.models.decoders", "MobileV3DenseDepth"),
                  ("tpudepth_torch.models.decoders", "MobileV3UNet"),
                  ("tpudepth_torch.models.decoders", "MobileV3UNetInterp"),
                  ("tpudepth_torch.models.jax_weights",
                   "zoo_state_dict_from_flax"),
                  ("tpudepth_torch.infer.engine", "ExportedEngine"),
                  ("tpudepth_torch.ops.kernels.gub_conv", "FWD_OP"),
                  ("tpudepth_torch.ops.packed", "upsample2x_pack"),
                  ("tpudepth_torch.models.layers", "rematerialize"),
                  ("tpudepth_torch.utils.debug", "checkify_nan_step"),
                  ("tpudepth_torch.utils.profiling", "trace"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_importing_every_module_loads_no_jax_flax_or_tpudepth():
    code = (
        "import pkgutil, sys, tpudepth_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tpudepth_torch.__path__, 'tpudepth_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        f"missing = sorted(set({REQUIRED!r}) - set(names))\n"
        f"missing += [m + '.' + c for m, c in {REQUIRED_NAMES!r}\n"
        "            if not hasattr(sys.modules.get(m), c)]\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 30 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_flax_or_tpudepth():
    files = sorted((ROOT / "tpudepth_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad

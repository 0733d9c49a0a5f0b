"""The port stands alone: no module of isegprobe_torch, and not
chip_smoke.py, imports JAX, flax, msgpack, OpenCV, PIL, PyYAML,
tensorboardX, TensorBoard or the JAX package (the GPU machine has none of
them; tests may use PIL to write files). Checked on the source text
(AST), so lazy imports inside functions count too."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cv2", "msgpack", "PIL",
             "yaml", "tensorboardX", "tensorboard", "isegprobe_tpu"}
SOURCES = sorted((REPO / "isegprobe_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"

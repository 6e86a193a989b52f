"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "demfi_tpu", "msgpack")
# the modules of the last slice: checkpoint tools, the native augment and
# the harnesses
LAST_MODULES = ("tools.py", "checkpoint/msgpack.py", "data/native/__init__.py",
                "scripts/__init__.py", "scripts/repro_table2.py",
                "scripts/synthetic_sanity.py", "utils/profiling.py",
                "data/pipeline.py")


def _port_files():
    files = sorted((ROOT / "demfi_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_port():
    files = _port_files()
    assert len(files) > 20
    assert ROOT / "demfi_torch" / "main.py" in files
    assert {ROOT / "demfi_torch" / "parallel" / f
            for f in ("__init__.py", "distributed.py")} <= set(files)
    assert {ROOT / "demfi_torch" / f for f in LAST_MODULES} <= set(files)
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_imports_with_jax_absent():
    """Every module of the port imports with jax, flax and demfi_tpu
    blocked."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "demfi_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {"demfi_torch.tools", "demfi_torch.checkpoint.msgpack",
            "demfi_torch.data.native", "demfi_torch.scripts.repro_table2",
            "demfi_torch.scripts.synthetic_sanity"} <= set(mods)
    code = ("import sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "import importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "print('ok')\n" % (FORBIDDEN, mods))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_cli_imports_and_png_route_without_cv2(tmp_path):
    """``demfi_torch.main`` and all it reaches import with jax, flax and
    cv2 blocked, and PNG files then go through the numpy route."""
    code = ("import sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "import numpy as np\n"
            "import demfi_torch.main, demfi_torch.infer.driver\n"
            "import demfi_torch.utils.viz, demfi_torch.utils.meters\n"
            "from demfi_torch.data import imageio\n"
            "from demfi_torch import metrics\n"
            "img = np.arange(24 * 32 * 3, dtype=np.uint8).reshape(24, 32, 3)\n"
            "imageio.imwrite(sys.argv[1], img)\n"
            "assert (imageio.imread(sys.argv[1]) == img).all()\n"
            "assert metrics.ssim(img, img) == 1.0\n"
            "try:\n"
            "    metrics.tof_pair(img, img, img, img)\n"
            "except RuntimeError as e:\n"
            "    assert 'cv2' in str(e)\n"
            "else:\n"
            "    raise SystemExit('tof_pair ran without cv2')\n"
            "print('ok')\n" % (FORBIDDEN + ("cv2",),))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    png = tmp_path / "a.png"
    res = subprocess.run([sys.executable, "-c", code, str(png)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    import cv2
    assert cv2.imread(str(png)).shape == (24, 32, 3)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from demfi_torch import resolve_device
    from demfi_torch.config import config_bs
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.models import make_model

    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        make_model(config_bs())
    model = make_model(config_bs(), device="cpu")
    with pytest.raises(RuntimeError):
        InferenceEngine(model, 0)
    assert InferenceEngine(model, 0, device="cpu").device.type == "cpu"

"""No module that the benchmark loads is JAX's or the JAX package's (top-level
names compared whole: seevcn_torch begins with seevcn_t), and the plain
reference loads nothing of seevcn_torch."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'optax', 'seevcn_tpu'}"


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_benchmark_loads_no_jax(tmp_path):
    code = f"""
import sys, torch
sys.path.insert(0, '.')
from pathlib import Path
from benchmark.tests.tiny import make_tiny_copy
from benchmark.harness.main import cell_spec, run_cell
import benchmark.calibrate, benchmark.harness.devtrace
for r in ('setup', 'window_rate', 'span_ms', 'device_idle', 'mfu', 'k1_roofline'):
    __import__('benchmark.readers.' + r)
bench = make_tiny_copy(Path({str(tmp_path)!r}))
run_cell(cell_spec('second_iou_f32.train', bench), 1, 0.0, False, device='cpu')
print(sorted({{m.split('.')[0] for m in sys.modules}} & {FORBIDDEN}))
"""
    assert _run(code) == "[]"


def test_reference_loads_nothing_of_the_program():
    code = """
import sys
sys.path.insert(0, '.')
import importlib, pkgutil
import benchmark.reference.seeref as R
for m in pkgutil.walk_packages(R.__path__, R.__name__ + '.'):
    importlib.import_module(m.name)
print(sorted({m.split('.')[0] for m in sys.modules} & {'seevcn_torch', 'jax', 'flax', 'seevcn_tpu'}))
"""
    assert _run(code) == "[]"
